"""Head dims the kernels are built for, and the zero padding that takes any
other head dim to one of them (the part of the JAX package's
`_pad_head_dim` that is semantics, not TPU mechanics).

Zero columns of q and k add zero to every score, and zero columns of v,
of dO and of the gradients are sliced off, so alpha and the scaling pass
through unchanged and a padded call equals the unpadded one. int8 operands
pad with int8 zeros; their per-token or per-tensor scales stay as they are.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def instance_head_dim(dh: int, instances: Sequence[int]) -> int:
    """The smallest built head dim >= dh (16 -> 32, 48 -> 64, 96 -> 128,
    160-224 -> 256 for K1-K6)."""
    for d in sorted(instances):
        if dh <= d:
            return d
    raise ValueError(f"head dim {dh} is above the largest kernel instance, {max(instances)}")


def pad_head_dim(x: torch.Tensor, d: int) -> torch.Tensor:
    """x [..., dh] zero-padded to [..., d] (x itself when dh == d)."""
    return x if x.shape[-1] == d else F.pad(x, (0, d - x.shape[-1])).contiguous()


def unpad_head_dim(x: torch.Tensor, dh: int) -> torch.Tensor:
    """x [..., d] cut back to its first dh columns (x itself when d == dh)."""
    return x if x.shape[-1] == dh else x[..., :dh].contiguous()
