"""SID-GR batch container and synthetic generator (counterpart of
recsys_examples_tpu/data/sid_batch.py).

History is a flattened stream of item SIDs (num_hierarchies tokens per
item); the candidate is the next item's SID tuple. The generator is numpy, a
copy of the JAX package's with the same generator calls in the same order,
so a seed gives the same batch in both packages. `SIDBatch.to(device)` makes
the tensors a model takes (integers as int64, torch's index type).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SIDBatch:
    history_sids: "np.ndarray | torch.Tensor"     # [cap] flattened (items * H)
    history_lengths: "np.ndarray | torch.Tensor"  # [B] (in tokens, multiple of H)
    history_offsets: "np.ndarray | torch.Tensor"  # [B+1]
    candidate_sids: "np.ndarray | torch.Tensor"   # [B, H]
    batch_size: int
    num_hierarchies: int
    max_history_tokens: int

    def to(self, device) -> "SIDBatch":
        """The same batch as int64 tensors on `device`."""
        t = lambda x: torch.as_tensor(
            x if torch.is_tensor(x) else np.asarray(x)).to(device, torch.int64)
        return dataclasses.replace(
            self, history_sids=t(self.history_sids),
            history_lengths=t(self.history_lengths),
            history_offsets=t(self.history_offsets),
            candidate_sids=t(self.candidate_sids))


def random_sid_batch(
    seed: int,
    batch_size: int,
    max_history_items: int,
    num_hierarchies: int,
    codebook_size: int,
) -> SIDBatch:
    """A batch of numpy int32 arrays; `.to(device)` moves it."""
    rng = np.random.default_rng(seed)
    n_items = rng.integers(1, max_history_items + 1, size=(batch_size,))
    lengths = (n_items * num_hierarchies).astype(np.int32)
    cap = batch_size * max_history_items * num_hierarchies
    total = int(lengths.sum())
    sids = np.zeros((cap,), np.int32)
    sids[:total] = rng.integers(0, codebook_size, size=(total,))
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    cand = rng.integers(
        0, codebook_size, size=(batch_size, num_hierarchies)
    ).astype(np.int32)
    return SIDBatch(
        history_sids=sids,
        history_lengths=lengths,
        history_offsets=offsets,
        candidate_sids=cand,
        batch_size=batch_size,
        num_hierarchies=num_hierarchies,
        max_history_tokens=max_history_items * num_hierarchies,
    )


def make_sid_mapping(
    num_items: int, num_hierarchies: int, codebook_size: int, seed: int = 0
) -> np.ndarray:
    """PID -> SID tuple mapping table [num_items, H]."""
    rng = np.random.default_rng(seed)
    return rng.integers(
        0, codebook_size, size=(num_items, num_hierarchies)
    ).astype(np.int32)
