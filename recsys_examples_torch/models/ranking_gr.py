"""RankingGR: embedding collection -> HSTU block -> MLP head -> multi-task
loss (counterpart of recsys_examples_tpu/models/ranking_gr.py)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from recsys_examples_torch.data.hstu_batch import HSTUBatch
from recsys_examples_torch.jagged.jagged_tensor import JaggedData
from recsys_examples_torch.modules.config import HSTUConfig, RankingConfig
from recsys_examples_torch.modules.embedding import EmbeddingCollection
from recsys_examples_torch.modules.hstu_block import HSTUBlock
from recsys_examples_torch.modules.losses import (
    cross_entropy_loss,
    data_total,
    multi_task_bce_loss,
)
from recsys_examples_torch.modules.mlp import MLP
from recsys_examples_torch.ops.jagged import row_to_batch


class RankingGR(nn.Module):
    """Submodules `embeddings`, `hstu_block` and `head`, as the flax model
    names them (`convert.dense_state_dict` maps the params across). Under a
    mesh the HSTU layers are split over "model" and the loss is this rank's
    share of the global batch's (see `modules/losses.py`)."""

    def __init__(self, hstu_config: HSTUConfig, task_config: RankingConfig, device=None,
                 mesh=None):
        super().__init__()
        self.hstu_config = hstu_config
        self.task_config = task_config
        self.embeddings = EmbeddingCollection(task_config.embedding_configs, device)
        self.hstu_block = HSTUBlock(hstu_config, device, mesh)
        self.data_group = None if mesh is None else mesh.group(mesh.data_axis)
        self.head = MLP(hstu_config.hidden_size, task_config.prediction_head_arch,
                        hstu_config.dtype, device,
                        activation=task_config.prediction_head_act_type,
                        use_bias=task_config.prediction_head_bias)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "RankingGR":
        """Random params with flax's init rules, drawn from `generator` (on
        its device)."""
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)
        return self

    def get_logits(self, batch: HSTUBatch, train: bool = True,
                   embeddings: Optional[Dict[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, JaggedData]:
        """`embeddings` overrides or extends the static tables' lookups."""
        emb = dict(self.embeddings(batch))
        if embeddings:
            emb.update(embeddings)
        jd = self.hstu_block(emb, batch, train, generator)
        return self.head(jd.values).float(), jd

    def forward(self, batch: HSTUBatch, train: bool = True,
                embeddings: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (scalar mean loss, aux dict with logits/labels/valid)."""
        logits, jd = self.get_logits(batch, train, embeddings, generator)
        N = logits.shape[0]
        offs = jd.seqlen_offsets
        valid = torch.arange(N, device=logits.device) < offs[-1]
        # logits are candidate-jagged-packed (row r = sample b's j-th
        # candidate); batch.labels is b-major strided [b * max_nc + j]
        if batch.max_num_candidates > 0:
            b = row_to_batch(offs, N)
            j = torch.arange(N, device=logits.device) - offs[b]
            src = (b * batch.max_num_candidates + j).clamp(0, batch.labels.shape[0] - 1)
            labels = batch.labels[src]
        else:
            labels = batch.labels[:N]
        nt = self.task_config.num_tasks
        if self.task_config.prediction_head_arch[-1] == nt:
            loss_sum, count = multi_task_bce_loss(logits, labels, valid, nt)
            loss = loss_sum.sum() / torch.clamp_min(data_total(count, self.data_group) * nt,
                                                    1.0)
        else:
            loss_sum, count = cross_entropy_loss(logits, labels, valid)
            loss = loss_sum / torch.clamp_min(data_total(count, self.data_group), 1.0)
        return loss, {"logits": logits, "labels": labels, "valid": valid, "loss": loss}
