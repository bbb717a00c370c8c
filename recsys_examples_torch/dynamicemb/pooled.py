"""Pooled (bag) dynamic-embedding lookup: SUM or MEAN over jagged ids
(counterpart of recsys_examples_tpu/dynamicemb/pooled.py): each sample's bag
of ids maps to one pooled vector.

The forward gathers the per-token rows (`ShardedDynamicEmbedding.forward`)
and sums them into their sample with `index_add_`; tokens past
`offsets[-1]` (padding) add nothing. The backward broadcasts each sample's
gradient to its tokens (divided by the bag length for MEAN) and reuses the
sequence path's reduction and fused row optimizer. Not a kernel in the JAX
package, and none here.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from recsys_examples_torch.dynamicemb.sharded_collection import (
    LookupResidual,
    ShardedDynamicEmbedding,
)


class PoolingMode:
    SUM = "sum"
    MEAN = "mean"


class PooledResidual(NamedTuple):
    inner: LookupResidual
    offsets: torch.Tensor    # [B+1]
    lengths: torch.Tensor    # [B]


def _sample_of_token(offsets: torch.Tensor, T: int) -> torch.Tensor:
    """[T] sample of each token row (padding tokens map to the last sample;
    callers mask them)."""
    B = offsets.shape[0] - 1
    t = torch.arange(T, dtype=torch.int64, device=offsets.device)
    s = torch.searchsorted(offsets.to(torch.int64), t, right=True) - 1
    return s.clamp(0, B - 1)


def _valid_tokens(offsets: torch.Tensor, T: int) -> torch.Tensor:
    return torch.arange(T, device=offsets.device) < offsets[-1].to(torch.int64)


class PooledDynamicEmbedding:
    """Bag-pooled facade over a ShardedDynamicEmbedding."""

    def __init__(self, inner: ShardedDynamicEmbedding, mode: str = PoolingMode.SUM):
        if mode not in (PoolingMode.SUM, PoolingMode.MEAN):
            raise ValueError(f"pooling mode {mode!r}")
        self.inner = inner
        self.mode = mode

    def init_state(self):
        return self.inner.init_state()

    @torch.no_grad()
    def forward(self, state, ids: torch.Tensor, offsets: torch.Tensor, train: bool = True
                ) -> Tuple[object, torch.Tensor, PooledResidual]:
        """ids [T] int64 (jagged values, EMPTY_KEY padding allowed), offsets
        [B+1]. Returns (state, pooled [B, dim], residual)."""
        T, B = ids.shape[0], offsets.shape[0] - 1
        state, per_token, res = self.inner.forward(state, ids, train=train)
        seg = _sample_of_token(offsets, T)
        contrib = torch.where(_valid_tokens(offsets, T)[:, None], per_token,
                              per_token.new_zeros(()))
        pooled = per_token.new_zeros((B, per_token.shape[1])).index_add_(0, seg, contrib)
        lengths = (offsets[1:] - offsets[:-1]).to(torch.int32)
        if self.mode == PoolingMode.MEAN:
            pooled = pooled / lengths.clamp_min(1).to(pooled.dtype)[:, None]
        return state, pooled, PooledResidual(res, offsets, lengths)

    @torch.no_grad()
    def backward(self, state, res: PooledResidual, grad_pooled: torch.Tensor):
        """grad_pooled [B, dim] -> the tokens' gradients -> the sequence
        path's backward."""
        T = res.inner.reverse_idx.shape[0]
        seg = _sample_of_token(res.offsets, T)
        g_tok = grad_pooled[seg]
        if self.mode == PoolingMode.MEAN:
            g_tok = g_tok / res.lengths.clamp_min(1).to(grad_pooled.dtype)[seg][:, None]
        g_tok = torch.where(_valid_tokens(res.offsets, T)[:, None], g_tok, g_tok.new_zeros(()))
        return self.inner.backward(state, res.inner, g_tok)
