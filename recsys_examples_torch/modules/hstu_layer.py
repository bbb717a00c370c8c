"""HSTU layer: LN -> uvqk projection -> SiLU -> attention -> LN * u
-> dropout -> output projection -> residual (counterpart of
recsys_examples_tpu/modules/hstu_layer.py `HSTULayer`).

Params keep flax's names and shapes (the uvqk kernel stays chunked
[D, 4, H*dh]), so converting them is a plain copy. They are fp32 and are
cast to `config.dtype` inside the forward, as flax's `dtype=` does; no
autocast. With `use_relative_attention_bias` the layer owns a
`relative_bias` submodule and passes its dense bias to the attention (K4).

Tensor parallelism (`tensor_model_parallel_size` > 1, a mesh with a "model"
axis of that size): each rank holds H/TP heads, as `parallel.mesh.
TP_PARTITIONS` splits the params. The JAX package lets GSPMD place the
collectives; here they are explicit (Megatron's layout):
  - the uvqk GEMM is column-parallel (`copy_to_group` before it: its input's
    gradient is summed over "model"); K1-K4 run on [T, H/TP, dh];
  - the output LayerNorm normalises over the full H*dh width: each rank
    all-reduces its rows' fp32 sum and sum of squares;
  - dropout draws the full-width mask on every rank from the same generator
    and applies this rank's columns, so the bits are the single device's;
  - `linear_proj` is row-parallel, followed by an all-reduce.
With `sequence_parallel` the residual stream holds this rank's block of
tokens (the block pads T to a multiple of TP and splits it): the input
LayerNorm runs on the block, an all-gather feeds the uvqk GEMM and a
reduce-scatter follows `linear_proj`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from recsys_examples_torch.jagged.jagged_tensor import JaggedData
from recsys_examples_torch.modules.config import HSTUConfig
from recsys_examples_torch.modules.hstu_attention import create_hstu_attention
from recsys_examples_torch.modules.mlp import lecun_normal_
from recsys_examples_torch.modules.position_encoder import RelativeAttentionBias
from recsys_examples_torch.parallel.collective_ops import (
    all_reduce,
    copy_to_group,
    gather_along_first_dim,
    reduce_scatter_first_dim,
)
from recsys_examples_torch.parallel.mesh import MODEL_AXIS, local_heads, shard_tensor


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm`: statistics in at least fp32 with the fast
    variance E[x^2] - E[x]^2 (clamped at 0), output in `dtype`. With
    `learnable=False` it has no params.

    With `group`, each rank holds `dim` of the `full_dim` features: the rows'
    sums and sums of squares are all-reduced over the group (forward and
    backward), so the statistics are the full width's."""

    def __init__(self, dim: int, eps: float, learnable: bool, dtype, device=None,
                 group=None, full_dim: Optional[int] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.group = group
        self.full_dim = dim if full_dim is None else full_dim
        if learnable:
            self.scale = nn.Parameter(torch.ones(dim, device=device))
            self.bias = nn.Parameter(torch.zeros(dim, device=device))
        else:
            self.scale = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.group is None:
            mean = x32.mean(-1, keepdim=True)
            mean2 = (x32 * x32).mean(-1, keepdim=True)
        else:
            sums = torch.stack([x32.sum(-1), (x32 * x32).sum(-1)], -1)
            sums = copy_to_group(all_reduce(sums, self.group), self.group) / self.full_dim
            mean, mean2 = sums[:, :1], sums[:, 1:]
        var = (mean2 - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps)
        if self.scale is not None:
            mul = mul * self.scale
        y = (x32 - mean) * mul
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            full_cols: Optional[int] = None, col0: int = 0):
    """flax `nn.Dropout`: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). The bits come from `generator`.
    With `full_cols`, x holds columns [col0, col0 + x.shape[1]) of a
    full_cols-wide activation: the full-width mask is drawn and its columns
    applied."""
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    shape = x.shape if full_cols is None else (x.shape[0], full_cols)
    keep = torch.rand(shape, generator=generator, device=x.device) >= rate
    if full_cols is not None:
        keep = keep[:, col0:col0 + x.shape[1]]
    return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))


class HSTULayer(nn.Module):
    """One HSTU block unit. Input/output: JaggedData with values [T, D] (this
    rank's block of the tokens under sequence parallelism)."""

    def __init__(self, config: HSTUConfig, device=None, mesh=None):
        super().__init__()
        cfg = self.config = config
        tp = cfg.tensor_model_parallel_size
        self.tp, self.tp_rank, self.tp_group = tp, 0, None
        if tp > 1:
            if mesh is None or mesh.size(MODEL_AXIS) != tp:
                raise ValueError(f"tensor_model_parallel_size {tp} needs a mesh whose "
                                 f"'model' axis has {tp} ranks")
            self.tp_group, self.tp_rank = mesh.group(MODEL_AXIS), mesh.index(MODEL_AXIS)
        self.sequence_parallel = cfg.sequence_parallel and tp > 1
        self.num_heads = local_heads(cfg.num_attention_heads, tp)
        D = cfg.hidden_size
        HD = cfg.num_attention_heads * cfg.kv_channels
        HDl = self.num_heads * cfg.kv_channels
        self.input_layernorm = LayerNorm(
            D, cfg.layernorm_epsilon, cfg.learnable_input_layernorm, cfg.dtype, device)
        self.uvqk_kernel = nn.Parameter(torch.empty(D, 4, HDl, device=device))
        self.uvqk_bias = (nn.Parameter(torch.zeros(4, HDl, device=device))
                          if cfg.add_uvqk_bias else None)
        self.output_layernorm = LayerNorm(
            HDl, cfg.layernorm_epsilon, cfg.learnable_output_layernorm, cfg.dtype, device,
            group=self.tp_group, full_dim=HD)
        self.linear_proj = nn.Linear(HDl, D, bias=False, device=device)
        if cfg.use_relative_attention_bias:
            self.relative_bias = RelativeAttentionBias(
                cfg.num_attention_heads, cfg.relative_bias_num_buckets,
                cfg.relative_bias_max_distance, cfg.is_causal, device,
                tp=tp, tp_rank=self.tp_rank)
        else:
            self.relative_bias = None
        self.attn = create_hstu_attention(cfg)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's inits: uvqk and linear_proj truncated normal with variance
        1/fan_in, uvqk bias 0 (the LayerNorms keep 1 and 0). Under tensor
        parallelism the full tensors are drawn and this rank's shard kept,
        so every TP size starts from the single device's params."""
        cfg = self.config
        D, HD = cfg.hidden_size, cfg.num_attention_heads * cfg.kv_channels
        full = torch.empty(D, 4, HD, device=self.uvqk_kernel.device)
        lecun_normal_(full, D, generator)
        self.uvqk_kernel.copy_(shard_tensor(full, 2, self.tp, self.tp_rank))
        full = torch.empty(D, HD, device=self.linear_proj.weight.device)
        lecun_normal_(full, HD, generator)
        self.linear_proj.weight.copy_(shard_tensor(full, 1, self.tp, self.tp_rank))
        if self.uvqk_bias is not None:
            self.uvqk_bias.zero_()

    def forward(self, jd: JaggedData, train: bool = True,
                generator: Optional[torch.Generator] = None) -> JaggedData:
        cfg = self.config
        H, dh = self.num_heads, cfg.kv_channels
        g = self.tp_group
        x = jd.values
        normed = self.input_layernorm(x)
        if self.sequence_parallel:
            normed = gather_along_first_dim(normed, g)
        elif g is not None:
            normed = copy_to_group(normed, g)
        # one GEMM per chunk [u | v | q | k], each writing a contiguous
        # [T, H*dh] output, as the flax layer does
        chunks = []
        for c in range(4):
            y = normed @ self.uvqk_kernel[:, c].to(cfg.dtype)
            if self.uvqk_bias is not None:
                y = y + self.uvqk_bias[c].to(cfg.dtype)
            chunks.append(F.silu(y))
        u, v, q, k = chunks
        attn = self.attn(
            q.reshape(-1, H, dh), k.reshape(-1, H, dh), v.reshape(-1, H, dh),
            jd.seqlen_offsets, jd.max_seqlen,
            num_contextuals=None if cfg.disable_contextual_mask else jd.contextual_seqlen,
            num_targets=jd.num_candidates,
            scaling_seqlen=jd.scaling_seqlen if jd.scaling_seqlen > 0 else jd.max_seqlen,
            rab=None if self.relative_bias is None else self.relative_bias(jd.max_seqlen),
        ).reshape(-1, H * dh)
        y = self.output_layernorm(attn) * u
        if train and cfg.hidden_dropout > 0.0:
            y = dropout(y, cfg.hidden_dropout, generator,
                        full_cols=None if g is None else H * dh * self.tp,
                        col0=self.tp_rank * H * dh)
        out = F.linear(y, self.linear_proj.weight.to(cfg.dtype))
        if self.sequence_parallel:
            out = reduce_scatter_first_dim(out, g)
        elif g is not None:
            out = all_reduce(out, g)
        if cfg.residual:
            out = out + x
        return jd.replace(values=out)
