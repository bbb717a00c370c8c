"""HSTU positional (+ timestamp) encoder and the trainable relative
attention bias (counterpart of recsys_examples_tpu/modules/position_encoder.py
`HSTUPositionalEncoder`, `t5_relative_buckets`, `RelativeAttentionBias`).

The position index of token i in its sequence is `min(i, high)` with
`high = clamp(seqlen - num_targets, 0, num_buckets - 1)`; the embedding is
added to `x * sqrt(dim)`. The stored tables are flax's: uniform in
[0, 2/sqrt(P)), shifted by -1/sqrt(P) when read. Plain autograd gives the
table's gradient (the JAX package's custom VJP only works around TPU
scatters).

`RelativeAttentionBias` returns the dense fp32 bias [1, H, N, N] that the
attention (kernel K4) takes: `rel_bias[bucket(i - j)]`. The bias depends on
i - j only, so it is built from the 2N - 1 values of one diagonal each, and
its gradient is summed along the diagonals first: the [N, N] bucket index
and the sort-based index backward over N * N rows are never made.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from recsys_examples_torch.ops.jagged import row_to_batch


class HSTUPositionalEncoder(nn.Module):
    def __init__(self, num_position_buckets: int, num_time_buckets: int,
                 embedding_dim: int, use_time_encoding: bool = False, device=None):
        super().__init__()
        self.num_position_buckets = num_position_buckets
        self.num_time_buckets = num_time_buckets
        self.embedding_dim = embedding_dim
        self.use_time_encoding = use_time_encoding
        self.position_embeddings = nn.Parameter(
            torch.empty(num_position_buckets, embedding_dim, device=device))
        if use_time_encoding:
            self.timestamp_embeddings = nn.Parameter(
                torch.empty(num_time_buckets + 1, embedding_dim, device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's uniform(scale=2/sqrt(buckets)) init of each table."""
        for p, n in ((self.position_embeddings, self.num_position_buckets),
                     (getattr(self, "timestamp_embeddings", None), self.num_time_buckets)):
            if p is not None:
                p.copy_(torch.rand(p.shape, generator=generator, device=generator.device)
                        * (2.0 / n ** 0.5))

    def forward(
        self,
        seq_embeddings: torch.Tensor,                  # [T, D]
        seq_lengths: torch.Tensor,                     # [B]
        seq_offsets: torch.Tensor,                     # [B+1]
        num_targets: Optional[torch.Tensor] = None,
        seq_timestamps: Optional[torch.Tensor] = None,  # [T]
        seq_start_position: Optional[torch.Tensor] = None,  # [B]
    ) -> torch.Tensor:
        T = seq_embeddings.shape[0]
        dt = seq_embeddings.dtype
        dev = seq_embeddings.device
        offsets = seq_offsets.to(torch.int64)
        b = row_to_batch(offsets, T)
        pos = torch.arange(T, device=dev) - offsets[b]
        high = seq_lengths.to(torch.int64)
        if num_targets is not None:
            high = high - num_targets.to(torch.int64)
        high = high.clamp(0, self.num_position_buckets - 1)
        if seq_start_position is not None:
            pos = pos + seq_start_position.to(torch.int64)[b]
        idx = torch.minimum(pos, high[b])
        shift = 1.0 / self.num_position_buckets ** 0.5
        out = seq_embeddings * self.embedding_dim ** 0.5 \
            + (self.position_embeddings[idx] - shift).to(dt)

        if self.use_time_encoding:
            if seq_timestamps is None:
                raise ValueError("use_time_encoding requires seq_timestamps")
            # sqrt bucketization of time deltas vs the sequence's last event
            last_idx = (offsets[b + 1] - 1).clamp(0, T - 1)
            delta = (seq_timestamps[last_idx] - seq_timestamps).clamp_min(0).float()
            bucket = torch.sqrt(delta).to(torch.int64).clamp(0, self.num_time_buckets)
            shift_t = 1.0 / self.num_time_buckets ** 0.5
            out = out + (self.timestamp_embeddings[bucket] - shift_t).to(dt)

        valid = torch.arange(T, device=dev) < offsets[-1]
        return torch.where(valid[:, None], out, out.new_zeros(()))


def t5_relative_buckets(rel: torch.Tensor, num_buckets: int, max_distance: int,
                        causal: bool) -> torch.Tensor:
    """T5-style log-bucketed relative positions (rel = q_pos - k_pos, an
    integer tensor): exact below half the buckets, logarithmic up to
    `max_distance`, clamped beyond. The log ratio is evaluated in fp32 and
    truncated, in the JAX package's order."""
    n = num_buckets
    if causal:
        rel = rel.clamp_min(0)
        base = torch.zeros_like(rel)
    else:
        n = n // 2
        base = (rel < 0).to(rel.dtype) * n
        rel = rel.abs()
    max_exact = n // 2
    large = max_exact + (
        torch.log(rel.clamp_min(1).to(torch.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (n - max_exact)
    ).to(rel.dtype)
    large = large.clamp_max(n - 1)
    return base + torch.where(rel < max_exact, rel, large)


class _Toeplitz(torch.autograd.Function):
    """vec [H, 2N-1] -> [H, N, N] with out[h, i, j] = vec[h, N-1-i+j]."""

    @staticmethod
    def forward(ctx, vec, N):
        ctx.N = N
        H = vec.shape[0]
        hankel = vec.contiguous().as_strided((H, N, N), (2 * N - 1, 1, 1))
        return hankel.flip(1)

    @staticmethod
    def backward(ctx, g):
        # d vec[h, m] = the sum of g[h, i, j] over N-1-i+j = m: copy row i
        # into row i of a zeroed [N, 2N-1] buffer, shifted right by N-1-i
        # (element (i, j) lands at flat i * (2N-2) + j + N-1), and sum the rows
        N = ctx.N
        H = g.shape[0]
        out = g.new_empty((H, 2 * N - 1))
        for h in range(H):      # one head at a time: the buffer is 2 N^2 floats
            buf = g.new_zeros((N * (2 * N - 1),))
            buf.as_strided((N, N), (2 * N - 2, 1), N - 1).copy_(g[h])
            out[h] = buf.view(N, 2 * N - 1).sum(0)
        return out, None


class RelativeAttentionBias(nn.Module):
    """Trainable relative attention bias: param `rel_bias` [num_buckets, H],
    normal(0.02). `forward(max_seqlen)` returns the dense fp32 bias
    [1, H, N, N] with `[0, h, i, j] = rel_bias[bucket(i - j), h]`.

    With `tp` > 1 the param holds this rank's H/tp heads (columns
    [tp_rank H/tp, (tp_rank + 1) H/tp)), and the bias is theirs."""

    def __init__(self, num_heads: int, num_buckets: int = 128, max_distance: int = 1024,
                 causal: bool = True, device=None, tp: int = 1, tp_rank: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.causal = causal
        self.tp, self.tp_rank = tp, tp_rank
        self.rel_bias = nn.Parameter(torch.empty(num_buckets, num_heads // tp, device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        full = 0.02 * torch.randn((self.num_buckets, self.num_heads), generator=generator,
                                  device=generator.device)
        h = self.rel_bias.shape[1]
        self.rel_bias.copy_(full[:, self.tp_rank * h:(self.tp_rank + 1) * h])

    def forward(self, max_seqlen: int) -> torch.Tensor:
        N = max_seqlen
        # diagonal m of the bias holds rel = i - j = N-1-m
        rel = (N - 1) - torch.arange(2 * N - 1, device=self.rel_bias.device)
        bucket = t5_relative_buckets(rel, self.num_buckets, self.max_distance, self.causal)
        # index_select: its backward is an index_add, not the sort-based
        # backward of advanced indexing (most diagonals share two buckets)
        vec = self.rel_bias.index_select(0, bucket).t()     # [H, 2N-1]
        return _Toeplitz.apply(vec, N)[None]        # [1, H, N, N]
