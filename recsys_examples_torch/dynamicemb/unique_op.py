"""Segmented (multi-table) key dedup, sort-based, with fixed-length outputs
(counterpart of recsys_examples_tpu/dynamicemb/unique_op.py).

Given keys from several tables concatenated, produce the unique keys per
table, reverse indices mapping each input to its unique slot, and optional
frequency counts. Every output has the input's length, padded with
EMPTY_KEY: nothing here depends on the number of uniques, so nothing waits
for the device (`torch.unique` would copy that count to the host), and the
outputs compare slot by slot with the JAX package's.
"""
from __future__ import annotations

from typing import Optional

import torch

from recsys_examples_torch.dynamicemb.dynamicemb_config import EMPTY_KEY


def segmented_unique(
    keys: torch.Tensor,                        # [n] int64 (EMPTY_KEY = padding)
    table_ids: Optional[torch.Tensor] = None,  # [n] ints, or None (one table)
    num_tables: int = 1,
    *,
    return_counts: bool = False,
):
    """Returns (unique_keys [n], reverse_idx [n], unique_table_ids [n],
    num_unique [], counts [n]?).

    Unique entries are sorted by (table id, key); `unique_keys` holds
    EMPTY_KEY past `num_unique`. `reverse_idx` (int64, an index tensor) maps
    every input to its unique slot; padding inputs map to the slot after the
    last real unique. `num_unique` stays on the device.
    """
    n = keys.shape[0]
    dev = keys.device
    keys = keys.to(torch.int64)
    if n == 0:
        e = torch.zeros((0,), dtype=torch.int64, device=dev)
        out = (keys, e, e.to(torch.int32), torch.zeros((), dtype=torch.int64, device=dev))
        return out + (e.to(torch.int32),) if return_counts else out
    is_pad = keys == EMPTY_KEY
    if table_ids is None:
        tid = is_pad.to(torch.int64) * num_tables
    else:
        tid = torch.where(is_pad, num_tables, table_ids.to(torch.int64))
    # lexicographic (table id, key) order by two stable sorts; padding last
    sk, o1 = torch.sort(keys, stable=True)
    st, o2 = torch.sort(tid[o1], stable=True)
    order, sk = o1[o2], sk[o2]
    first = torch.ones((n,), dtype=torch.bool, device=dev)
    first[1:] = (sk[1:] != sk[:-1]) | (st[1:] != st[:-1])
    uid_sorted = torch.cumsum(first, 0) - 1
    pad_sorted = st == num_tables
    num_unique = torch.where(pad_sorted, -1, uid_sorted).max() + 1
    # every member of a group writes the same key to the group's slot
    unique_keys = torch.full((n,), EMPTY_KEY, dtype=torch.int64, device=dev)
    unique_keys.scatter_(0, uid_sorted, torch.where(pad_sorted, EMPTY_KEY, sk))
    unique_tids = torch.zeros((n,), dtype=torch.int64, device=dev)
    unique_tids.scatter_(0, uid_sorted, torch.where(pad_sorted, 0, st))
    reverse = torch.empty((n,), dtype=torch.int64, device=dev)
    reverse[order] = uid_sorted
    out = (unique_keys, reverse, unique_tids.to(torch.int32), num_unique)
    if return_counts:
        counts = torch.zeros((n,), dtype=torch.int64, device=dev)
        counts.scatter_add_(0, uid_sorted, (~pad_sorted).to(torch.int64))
        return out + (counts.to(torch.int32),)
    return out


def table_offsets_from_unique(
    unique_tids: torch.Tensor, num_unique: torch.Tensor, num_tables: int
) -> torch.Tensor:
    """[num_tables + 1] offsets of each table's group of unique keys
    (`unique_tids[:num_unique]` is sorted by table id)."""
    n = unique_tids.shape[0]
    pos = torch.arange(n, device=unique_tids.device)
    ut = torch.where(pos < num_unique, unique_tids.to(torch.int64), num_tables)
    probe = torch.arange(num_tables + 1, device=unique_tids.device)
    return torch.searchsorted(ut, probe, right=False).to(torch.int32)
