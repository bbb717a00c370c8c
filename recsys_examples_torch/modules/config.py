"""Model configuration (counterpart of recsys_examples_tpu/modules/config.py).

Only the fields the KV-cached inference path reads are carried over; the
dtype is a torch dtype. The kernel choice needs no field: a kernel wrapper
launches its CUDA kernel for CUDA tensors and runs its plain PyTorch version
for CPU tensors (`KernelBackend` names the two).
"""
from __future__ import annotations

import dataclasses
import enum

import torch


class KernelBackend(enum.Enum):
    CUDA = "cuda"     # hand-written Hopper kernel (production path)
    TORCH = "torch"   # plain PyTorch version (CPU path and reference)


@dataclasses.dataclass(frozen=True)
class HSTUConfig:
    hidden_size: int = 1024
    num_layers: int = 8
    num_attention_heads: int = 4
    kv_channels: int = 256          # per-head attention/linear dim
    layernorm_epsilon: float = 1e-5
    learnable_input_layernorm: bool = True
    learnable_output_layernorm: bool = False
    residual: bool = True
    add_uvqk_bias: bool = True
    scaling_seqlen: int = -1
    dtype: torch.dtype = torch.bfloat16
