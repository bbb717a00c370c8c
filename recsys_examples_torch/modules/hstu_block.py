"""HSTU block: preprocessor -> N x HSTULayer -> postprocessor (counterpart of
recsys_examples_tpu/modules/hstu_block.py).

The layers run on the packed jagged layout: the JAX block's relayout into
the Pallas kernel's block-aligned layout has no counterpart here. Under
sequence parallelism the block pads the tokens to a multiple of TP and
splits them over "model" before the first layer, and gathers them after the
last one (its consumers are the same on every rank, so that gather's
backward keeps this rank's block).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from recsys_examples_torch.data.hstu_batch import HSTUBatch
from recsys_examples_torch.jagged.jagged_tensor import JaggedData
from recsys_examples_torch.modules.config import HSTUConfig
from recsys_examples_torch.modules.hstu_layer import HSTULayer, dropout
from recsys_examples_torch.modules.mlp import MLP
from recsys_examples_torch.modules.position_encoder import HSTUPositionalEncoder
from recsys_examples_torch.ops.jagged import (
    concat_2D_jagged,
    concat_multi_2D_jagged,
    interleave_jagged,
    lengths_to_offsets,
    split_2D_jagged,
)
from recsys_examples_torch.parallel.collective_ops import (
    gather_along_first_dim,
    split_along_first_dim,
)


class HSTUBlockPreprocessor(nn.Module):
    """Interleave item/action, concat contextual, position-encode, dropout."""

    def __init__(self, config: HSTUConfig, device=None):
        super().__init__()
        cfg = self.config = config
        D = cfg.hidden_size
        if cfg.item_embedding_dim > 0:
            self.item_mlp = MLP(cfg.item_embedding_dim, (D, D), cfg.dtype, device)
        if cfg.contextual_embedding_dim > 0:
            self.contextual_mlp = MLP(cfg.contextual_embedding_dim, (D, D), cfg.dtype,
                                      device)
        pec = cfg.position_encoding_config
        if pec is not None:
            self.positional_encoder = HSTUPositionalEncoder(
                pec.num_position_buckets, pec.num_time_buckets, D,
                pec.use_time_encoding, device)

    def forward(self, embeddings: Dict[str, torch.Tensor], batch: HSTUBatch,
                train: bool = True, generator: Optional[torch.Generator] = None
                ) -> JaggedData:
        cfg = self.config
        item = batch.features[batch.item_feature_name]
        seq_values = embeddings[batch.item_feature_name].to(cfg.dtype)
        seq_lengths = item.lengths
        seq_max = batch.feature_to_max_seqlen[batch.item_feature_name]

        has_action = batch.action_feature_name is not None
        if has_action:
            # interleave item/action for the history only: candidates enter
            # without their actions (the action is the label)
            action_values = embeddings[batch.action_feature_name].to(cfg.dtype)
            if batch.num_candidates is not None and batch.max_num_candidates:
                offs = lengths_to_offsets(seq_lengths)
                nc = batch.num_candidates
                hist_len = seq_lengths - nc
                cand_cap = len(seq_lengths) * batch.max_num_candidates
                T = seq_values.shape[0]
                hv, ho, cv, co = split_2D_jagged(seq_values, offs, hist_len, T, cand_cap)
                av, _, _, _ = split_2D_jagged(action_values, offs, hist_len, T, cand_cap)
                seq_values, _ = concat_2D_jagged(interleave_jagged(hv, av), ho * 2, cv, co)
                seq_lengths = 2 * hist_len + nc
            else:
                seq_values = interleave_jagged(seq_values, action_values)
                seq_lengths = seq_lengths * 2
            seq_max = seq_max * 2   # bound: 2 * hist + cand <= 2 * item_max
        if cfg.item_embedding_dim > 0:
            seq_values = self.item_mlp(seq_values)
        seq_offsets = lengths_to_offsets(seq_lengths)

        contextual_max = 0
        contextual_lengths = None
        if batch.contextual_feature_names:
            names = batch.contextual_feature_names
            cv, co = concat_multi_2D_jagged(
                [embeddings[n].to(cfg.dtype) for n in names],
                [batch.features[n].offsets for n in names])
            if cfg.contextual_embedding_dim > 0:
                cv = self.contextual_mlp(cv)
            contextual_max = sum(batch.feature_to_max_seqlen[n] for n in names)
            contextual_lengths = co[1:] - co[:-1]
            seq_values, seq_offsets = concat_2D_jagged(cv, co, seq_values, seq_offsets)
            seq_lengths = seq_offsets[1:] - seq_offsets[:-1]
            seq_max = seq_max + contextual_max

        num_candidates = batch.num_candidates
        jd = JaggedData(
            values=seq_values,
            seqlen=seq_lengths,
            seqlen_offsets=seq_offsets,
            max_seqlen=seq_max,
            max_num_candidates=batch.max_num_candidates,
            num_candidates=num_candidates,
            num_candidates_offsets=None if num_candidates is None
            else lengths_to_offsets(num_candidates),
            contextual_max_seqlen=contextual_max,
            contextual_seqlen=contextual_lengths,
            contextual_seqlen_offsets=None if contextual_lengths is None
            else lengths_to_offsets(contextual_lengths),
            has_interleaved_action=has_action,
            scaling_seqlen=cfg.scaling_seqlen,
        )
        if cfg.position_encoding_config is not None:
            jd = jd.replace(values=self.positional_encoder(
                jd.values, jd.seqlen, jd.seqlen_offsets,
                num_targets=jd.num_candidates, seq_timestamps=batch.timestamps))
        if train and cfg.hidden_dropout > 0.0:
            jd = jd.replace(values=dropout(jd.values, cfg.hidden_dropout, generator))
        return jd


class HSTUBlockPostprocessor(nn.Module):
    """Select the candidate (or post-contextual) rows, de-interleave,
    L2-normalize."""

    def __init__(self, l2_norm_eps: float = 1e-6):
        super().__init__()
        self.l2_norm_eps = l2_norm_eps

    def forward(self, jd: JaggedData) -> JaggedData:
        values = jd.values
        T = values.shape[0]
        B = jd.seqlen.shape[0]
        if jd.max_num_candidates > 0:
            _, _, values, offsets = split_2D_jagged(
                values, jd.seqlen_offsets, jd.seqlen - jd.num_candidates,
                T, B * jd.max_num_candidates)
            max_seqlen = jd.max_num_candidates
        elif jd.contextual_max_seqlen > 0:
            ctx_cap = B * jd.contextual_max_seqlen
            _, _, values, offsets = split_2D_jagged(
                values, jd.seqlen_offsets, jd.contextual_seqlen, ctx_cap, T - ctx_cap)
            max_seqlen = jd.max_seqlen - jd.contextual_max_seqlen
        else:
            offsets = jd.seqlen_offsets
            max_seqlen = jd.max_seqlen

        if jd.has_interleaved_action and jd.max_num_candidates == 0:
            # no candidates: the outputs are the interleaved sequence; keep
            # the item rows
            values = values.reshape(values.shape[0] // 2, 2, -1)[:, 0, :]
            offsets = torch.div(offsets, 2, rounding_mode="floor")
            max_seqlen = max_seqlen // 2

        # smooth L2 norm: sqrt(sum + eps^2) keeps the gradient finite on
        # all-zero padding rows
        v32 = values.float()
        norm = torch.sqrt((v32 * v32).sum(-1, keepdim=True) + self.l2_norm_eps ** 2)
        values = (v32 / norm).to(values.dtype)
        return JaggedData(
            values=values,
            seqlen=offsets[1:] - offsets[:-1],
            seqlen_offsets=offsets,
            max_seqlen=max_seqlen,
            scaling_seqlen=jd.scaling_seqlen,
        )


class HSTUBlock(nn.Module):
    """Preprocessor -> num_layers x HSTULayer -> postprocessor."""

    def __init__(self, config: HSTUConfig, device=None, mesh=None):
        super().__init__()
        self.config = config
        self.preprocessor = HSTUBlockPreprocessor(config, device)
        self.layers = nn.ModuleList(
            HSTULayer(config, device, mesh) for _ in range(config.num_layers))
        self.postprocessor = HSTUBlockPostprocessor()
        first = self.layers[0] if len(self.layers) else None
        self.sp_group = first.tp_group if first is not None and first.sequence_parallel \
            else None

    def forward(self, embeddings: Dict[str, torch.Tensor], batch: HSTUBatch,
                train: bool = True, generator: Optional[torch.Generator] = None
                ) -> JaggedData:
        cfg = self.config
        jd = self.preprocessor(embeddings, batch, train, generator)
        T = jd.values.shape[0]
        if self.sp_group is not None:
            tp = cfg.tensor_model_parallel_size
            x = jd.values
            x = torch.cat([x, x.new_zeros(((-T) % tp, x.shape[1]))])
            jd = jd.replace(values=split_along_first_dim(x, self.sp_group))
        remat = cfg.recompute_layer and train and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                jd = jd.replace(values=checkpoint(
                    _replaying(layer, jd, train, generator), jd.values,
                    use_reentrant=False))
            else:
                jd = layer(jd, train, generator)
        if self.sp_group is not None:
            jd = jd.replace(values=gather_along_first_dim(
                jd.values, self.sp_group, replicated_output=True)[:T])
        return self.postprocessor(jd)


def _replaying(layer: HSTULayer, jd: JaggedData, train: bool,
               generator: Optional[torch.Generator]):
    """The checkpointed function of one layer: values -> values.

    `torch.utils.checkpoint` restores the default generators before the
    recompute, not `generator`. So the forward draws its dropout bits from
    `generator` itself (advancing it as an unrecomputed layer would), and
    the recompute from a new generator set to the state `generator` had
    before that forward: the same bits, so the same activations."""
    state = None if generator is None else generator.get_state()
    calls = 0

    def run(values: torch.Tensor) -> torch.Tensor:
        nonlocal calls
        gen = generator
        if calls and generator is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(state)
        calls += 1
        return layer(jd.replace(values=values), train, gen).values

    return run
