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

__all__ = ["JaggedData", "lengths_to_offsets", "make_jagged_data", "random_jagged_data"]


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

    @property
    def batch_size(self) -> int:
        return self.seqlen.shape[0]

    @property
    def total_len(self) -> int:
        """Rows of the values buffer, padding included."""
        return self.values.shape[0]

    @property
    def hidden_dim(self) -> int:
        return self.values.shape[-1]

    def replace_values(self, values: torch.Tensor) -> "JaggedData":
        """Shallow copy with new values (metadata shared)."""
        return self.replace(values=values)

    def token_mask(self) -> torch.Tensor:
        """[T] bool: True on the valid (non-padding) rows of `values`."""
        return torch.arange(self.values.shape[0], device=self.values.device) < self.seqlen_offsets[-1]


def _offsets(lengths: Optional[torch.Tensor]):
    return None if lengths is None else lengths_to_offsets(lengths.to(torch.int64))


def make_jagged_data(
    values: torch.Tensor,
    seqlen: torch.Tensor,
    max_seqlen: int,
    *,
    num_candidates: Optional[torch.Tensor] = None,
    max_num_candidates: int = 0,
    contextual_seqlen: Optional[torch.Tensor] = None,
    contextual_max_seqlen: int = 0,
    has_interleaved_action: bool = False,
    scaling_seqlen: int = -1,
) -> JaggedData:
    """A JaggedData with its offsets computed from the lengths (int64)."""
    as_len = lambda x: None if x is None else x.to(torch.int64)
    return JaggedData(
        values=values,
        seqlen=seqlen.to(torch.int64),
        seqlen_offsets=_offsets(seqlen),
        max_seqlen=max_seqlen,
        max_num_candidates=max_num_candidates,
        num_candidates=as_len(num_candidates),
        num_candidates_offsets=_offsets(num_candidates),
        contextual_max_seqlen=contextual_max_seqlen,
        contextual_seqlen=as_len(contextual_seqlen),
        contextual_seqlen_offsets=_offsets(contextual_seqlen),
        has_interleaved_action=has_interleaved_action,
        scaling_seqlen=scaling_seqlen,
    )


def random_jagged_data(
    generator: torch.Generator,
    seqlen: torch.Tensor,
    dim: int,
    max_seqlen: int,
    total_len: int,
    *,
    num_candidates: Optional[torch.Tensor] = None,
    max_num_candidates: int = 0,
    contextual_seqlen: Optional[torch.Tensor] = None,
    contextual_max_seqlen: int = 0,
    dtype: torch.dtype = torch.float32,
) -> JaggedData:
    """Uniform [0, 1) values drawn from `generator` (on its device), padding
    rows zeroed so reductions over values are exact."""
    values = torch.rand((total_len, dim), generator=generator,
                        device=generator.device).to(dtype)
    jd = make_jagged_data(
        values, seqlen.to(values.device), max_seqlen,
        num_candidates=num_candidates, max_num_candidates=max_num_candidates,
        contextual_seqlen=contextual_seqlen, contextual_max_seqlen=contextual_max_seqlen)
    return jd.replace(values=values * jd.token_mask()[:, None].to(dtype))
