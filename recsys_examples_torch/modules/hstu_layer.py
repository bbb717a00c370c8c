"""HSTU layer: LN -> uvqk projection -> SiLU -> attention -> LN * u
-> dropout -> output projection -> residual (counterpart of
recsys_examples_tpu/modules/hstu_layer.py `HSTULayer`).

Params keep flax's names and shapes (the uvqk kernel stays chunked
[D, 4, H*dh]), so converting them is a plain copy. They are fp32 and are
cast to `config.dtype` inside the forward, as flax's `dtype=` does; no
autocast. With `use_relative_attention_bias` the layer owns a
`relative_bias` submodule and passes its dense bias to the attention (K4).
Tensor parallelism is not ported yet.
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


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm`: statistics in at least fp32 with the fast
    variance E[x^2] - E[x]^2 (clamped at 0), output in `dtype`. With
    `learnable=False` it has no params."""

    def __init__(self, dim: int, eps: float, learnable: bool, dtype, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        if learnable:
            self.scale = nn.Parameter(torch.ones(dim, device=device))
            self.bias = nn.Parameter(torch.zeros(dim, device=device))
        else:
            self.scale = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        mean2 = (x32 * x32).mean(-1, keepdim=True)
        var = (mean2 - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps)
        if self.scale is not None:
            mul = mul * self.scale
        y = (x32 - mean) * mul
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]):
    """flax `nn.Dropout`: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). The bits come from `generator`."""
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))


class HSTULayer(nn.Module):
    """One HSTU block unit. Input/output: JaggedData with values [T, D]."""

    def __init__(self, config: HSTUConfig, device=None):
        super().__init__()
        if config.tensor_model_parallel_size > 1:
            raise NotImplementedError("tensor parallelism is not ported yet")
        cfg = self.config = config
        D, HD = cfg.hidden_size, cfg.num_attention_heads * cfg.kv_channels
        self.input_layernorm = LayerNorm(
            D, cfg.layernorm_epsilon, cfg.learnable_input_layernorm, cfg.dtype, device)
        self.uvqk_kernel = nn.Parameter(torch.empty(D, 4, HD, device=device))
        self.uvqk_bias = (nn.Parameter(torch.zeros(4, HD, device=device))
                          if cfg.add_uvqk_bias else None)
        self.output_layernorm = LayerNorm(
            HD, cfg.layernorm_epsilon, cfg.learnable_output_layernorm, cfg.dtype, device)
        self.linear_proj = nn.Linear(HD, D, bias=False, device=device)
        if cfg.use_relative_attention_bias:
            self.relative_bias = RelativeAttentionBias(
                cfg.num_attention_heads, cfg.relative_bias_num_buckets,
                cfg.relative_bias_max_distance, cfg.is_causal, device)
        else:
            self.relative_bias = None
        self.attn = create_hstu_attention(cfg)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's inits: uvqk and linear_proj truncated normal with variance
        1/fan_in, uvqk bias 0 (the LayerNorms keep 1 and 0)."""
        lecun_normal_(self.uvqk_kernel, self.uvqk_kernel.shape[0], generator)
        lecun_normal_(self.linear_proj.weight, self.linear_proj.weight.shape[1], generator)
        if self.uvqk_bias is not None:
            self.uvqk_bias.zero_()

    def forward(self, jd: JaggedData, train: bool = True,
                generator: Optional[torch.Generator] = None) -> JaggedData:
        cfg = self.config
        H, dh = cfg.num_attention_heads, cfg.kv_channels
        x = jd.values
        normed = self.input_layernorm(x)
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
            y = dropout(y, cfg.hidden_dropout, generator)
        out = F.linear(y, self.linear_proj.weight.to(cfg.dtype))
        if cfg.residual:
            out = out + x
        return jd.replace(values=out)
