"""HSTU attention for a layer (counterpart of
recsys_examples_tpu/modules/hstu_attention.py `create_hstu_attention`).

The returned function calls `ops.hstu_attention.hstu_attn_varlen`: the CUDA
kernels K1-K3 (with `rab`: K4) for CUDA tensors, their plain versions for
CPU tensors. Like the JAX factory it passes no `min_full_attn_seq_len`.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from recsys_examples_torch.modules.config import HSTUConfig
from recsys_examples_torch.ops.hstu_attention import hstu_attn_varlen

AttentionFn = Callable[..., torch.Tensor]


def create_hstu_attention(config: HSTUConfig) -> AttentionFn:
    def attn(
        q: torch.Tensor,           # [T, H, D]
        k: torch.Tensor,
        v: torch.Tensor,
        seq_offsets: torch.Tensor,
        max_seqlen: int,
        *,
        num_contextuals: Optional[torch.Tensor] = None,
        num_targets: Optional[torch.Tensor] = None,
        scaling_seqlen: int = -1,
        rab: Optional[torch.Tensor] = None,   # [B|1, H|1, N, N]
    ) -> torch.Tensor:
        out = hstu_attn_varlen(
            q, k, v, seq_offsets, max_seqlen,
            num_contextuals=num_contextuals,
            num_targets=num_targets,
            alpha=1.0 / (config.kv_channels ** 0.5),
            scaling_seqlen=scaling_seqlen,
            causal=config.is_causal,
            target_group_size=config.target_group_size,
            max_attn_len=config.max_attn_len,
            rab=rab,
        )
        return out.to(v.dtype)

    return attn
