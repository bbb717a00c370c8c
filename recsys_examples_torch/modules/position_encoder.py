"""HSTU positional (+ timestamp) encoder (counterpart of
recsys_examples_tpu/modules/position_encoder.py `HSTUPositionalEncoder`).

The position index of token i in its sequence is `min(i, high)` with
`high = clamp(seqlen - num_targets, 0, num_buckets - 1)`; the embedding is
added to `x * sqrt(dim)`. The stored tables are flax's: uniform in
[0, 2/sqrt(P)), shifted by -1/sqrt(P) when read. Plain autograd gives the
table's gradient (the JAX package's custom VJP only works around TPU
scatters). `RelativeAttentionBias` waits with kernel K4.
"""
from __future__ import annotations

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
