"""Frozen (inference) dynamic tables (counterpart of
recsys_examples_tpu/dynamicemb/exportable_tables.py: `InferenceTableState`,
`inference_lookup`)."""
from __future__ import annotations

import dataclasses

import torch

from recsys_examples_torch.dynamicemb.dynamicemb_config import EMPTY_KEY, hash_keys


@dataclasses.dataclass
class InferenceTableState:
    keys: torch.Tensor     # [num_buckets, C] int64
    values: torch.Tensor   # [num_buckets * C, dim] embedding columns only

    @property
    def bucket_capacity(self) -> int:
        return self.keys.shape[1]

    @property
    def num_buckets(self) -> int:
        return self.keys.shape[0]


def inference_lookup(state: InferenceTableState, keys: torch.Tensor) -> torch.Tensor:
    """Pure lookup: [n] ids -> [n, dim]; missing keys and `EMPTY_KEY` give
    zeros."""
    C = state.bucket_capacity
    keys = keys.to(torch.int64)
    b = hash_keys(keys, state.num_buckets)
    bucket_keys = state.keys[b]
    match = (bucket_keys == keys[:, None]) & (keys[:, None] != EMPTY_KEY)
    found = match.any(dim=1)
    # argmax rejects bool; on ints it returns the first maximum, as JAX does
    slot = b * C + match.to(torch.int32).argmax(dim=1)
    emb = state.values[torch.where(found, slot, torch.zeros_like(slot))]
    return torch.where(found[:, None], emb, emb.new_zeros(()))
