"""The jagged activation container (counterpart of
recsys_examples_tpu/jagged/jagged_tensor.py).

`values` is a flattened [T, D] buffer, `seqlen`/`seqlen_offsets` describe
the sequences, and rows past `seqlen_offsets[-1]` are zero padding. The
bounds (`max_seqlen`, ...) are plain ints. The block-aligned layout fields of
the JAX container are not carried over: the port's kernels read the packed
layout directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from recsys_examples_torch.ops.jagged import lengths_to_offsets

__all__ = ["JaggedData", "lengths_to_offsets"]


@dataclasses.dataclass
class JaggedData:
    """values:            [T, D] flattened tokens.
    seqlen:            [B] per-sample length (tokens in `values`).
    seqlen_offsets:    [B+1].
    max_seqlen:        static upper bound of a sample's length.
    num_candidates:    [B] or None, trailing candidate items per sample.
    contextual_seqlen: [B] or None, leading contextual tokens per sample.
    scaling_seqlen:    attention denominator (-1 means max_seqlen).
    """

    values: torch.Tensor
    seqlen: torch.Tensor
    seqlen_offsets: torch.Tensor
    max_seqlen: int
    max_num_candidates: int = 0
    num_candidates: Optional[torch.Tensor] = None
    num_candidates_offsets: Optional[torch.Tensor] = None
    contextual_max_seqlen: int = 0
    contextual_seqlen: Optional[torch.Tensor] = None
    contextual_seqlen_offsets: Optional[torch.Tensor] = None
    has_interleaved_action: bool = False
    scaling_seqlen: int = -1

    def replace(self, **changes) -> "JaggedData":
        return dataclasses.replace(self, **changes)
