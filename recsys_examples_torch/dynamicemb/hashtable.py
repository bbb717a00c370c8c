"""Bucketized scored hash table: the dynamic-embedding core (counterpart of
recsys_examples_tpu/dynamicemb/hashtable.py).

  - State = dense tensors: keys/scores [num_buckets, bucket_capacity],
    values [num_slots, dim], optimizer state [num_slots, opt_dim].
  - lookup: hash -> gather the bucket row -> compare.
  - insert_and_evict: per key pick the slot (match > rank-th empty >
    min-score eviction); of the keys wanting one cell the lowest index wins
    and the others retry, up to `rounds` rounds; leftovers count as overflow.
  - "not found"/"failed" are -1 slots.

The JAX package's ops are pure (state in, state out) and its step donates
the state. Here every op UPDATES THE STATE'S TENSORS IN PLACE, under
`no_grad`, and returns the same state object: a 4.2M x 128 fp32 value table
is 2.1 GB and is never cloned. Keys, scores, slots and counters come out
bit for bit as the JAX package's; slots are int64 (torch's index type). One
case is decided here that the JAX package leaves open: a key that wins a
cell and is evicted again within the same `insert_and_evict` call keeps its
stale slot there, and two lanes then write one value row in an undefined
order. Here the stale slot is returned as well, but only the cell's final
owner writes the row (see `insert_and_evict`).

Host syncs: the scatters go through `utils.scatter.masked_set_` and never
wait for the device. `insert_and_evict` reads one flag per round from the
device (are any keys still pending?), so a call whose keys are all resident
costs one sync and runs no round, as the JAX `while_loop` does. While
tracing is on, the counter `emb/insert_rounds` counts those syncs.

Scores are int64; larger = more recently/frequently used = kept longer.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from recsys_examples_torch.dynamicemb.dynamicemb_config import EMPTY_KEY, hash_keys
from recsys_examples_torch.utils import observability
from recsys_examples_torch.utils.device import resolve_device
from recsys_examples_torch.utils.scatter import masked_set_

_I64_MIN = -(2 ** 63)
_I64_MAX = 2 ** 63 - 1


@dataclasses.dataclass
class HashTableState:
    keys: torch.Tensor     # [num_buckets, C] int64, EMPTY_KEY = free
    scores: torch.Tensor   # [num_buckets, C] int64
    values: torch.Tensor   # [num_buckets * C, dim] float (embedding only)
    opt: Optional[torch.Tensor]  # [num_buckets * C, opt_dim] float or None
    # stats, [1] int64 each
    inserted: torch.Tensor
    evicted: torch.Tensor
    overflowed: torch.Tensor

    @property
    def num_buckets(self) -> int:
        return self.keys.shape[0]

    @property
    def bucket_capacity(self) -> int:
        return self.keys.shape[1]

    @property
    def capacity(self) -> int:
        return self.keys.shape[0] * self.keys.shape[1]

    @property
    def value_dim(self) -> int:
        return self.values.shape[1]


def create_table_state(
    capacity: int,
    bucket_capacity: int,
    value_dim: int,
    value_dtype: torch.dtype = torch.float32,
    opt_dim: int = 0,
    device="cuda",
) -> HashTableState:
    if capacity % bucket_capacity:
        raise ValueError("capacity must be a multiple of bucket_capacity")
    dev = resolve_device(device)
    nb = capacity // bucket_capacity
    i64 = dict(dtype=torch.int64, device=dev)
    return HashTableState(
        keys=torch.full((nb, bucket_capacity), EMPTY_KEY, **i64),
        scores=torch.zeros((nb, bucket_capacity), **i64),
        values=torch.zeros((capacity, value_dim), dtype=value_dtype, device=dev),
        opt=(torch.zeros((capacity, opt_dim), dtype=value_dtype, device=dev)
             if opt_dim > 0 else None),
        inserted=torch.zeros((1,), **i64),
        evicted=torch.zeros((1,), **i64),
        overflowed=torch.zeros((1,), **i64),
    )


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1, 0 when there is none (what
    `argmax` of a bool row gives, written so that ties cannot matter)."""
    C = mask.shape[1]
    lane = torch.arange(C, device=mask.device)
    first = torch.where(mask, lane, C).amin(dim=1)
    return torch.where(first < C, first, 0)


def _first_min(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along dim 1."""
    return _first_true(x == x.amin(dim=1, keepdim=True))


def _take(rows: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    return rows.gather(1, col[:, None])[:, 0]


@torch.no_grad()
def lookup(state: HashTableState, keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """keys [n] int64 -> (slots [n] flat index or -1, found [n] bool).
    EMPTY_KEY inputs (padding) are never found."""
    C = state.bucket_capacity
    b = hash_keys(keys, state.num_buckets)
    match = (state.keys[b] == keys[:, None]) & (keys[:, None] != EMPTY_KEY)
    found = match.any(dim=1)
    slots = torch.where(found, b * C + _first_true(match), -1)
    return slots, found


def _bucket_rank(b: torch.Tensor, want: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Rank of each wanted key among the wanted keys of its bucket, in index
    order: same-bucket keys then claim different empty slots in one round."""
    n = b.shape[0]
    bm = torch.where(want, b, num_buckets)
    sorted_b, order = torch.sort(bm, stable=True)
    idx = torch.arange(n, device=b.device)
    firsts = torch.ones((n,), dtype=torch.bool, device=b.device)
    firsts[1:] = sorted_b[1:] != sorted_b[:-1]
    run_start = torch.cummax(torch.where(firsts, idx, 0), 0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - run_start
    return rank


def _choose_slot(bucket_keys, bucket_scores, key, rank, protected=None):
    """Per-key target slot: match > rank-th empty > min-score eviction
    (the first minimum; simultaneous same-bucket evictions resolve over
    retry rounds through the claim step). Returns (slot, found, evicts,
    stuck).

    With `protected` [n, C] (cells never to evict): the key of rank r past
    the bucket's e empty cells takes the (r - e)-th unprotected live cell in
    (score, lane) order, so a bucket takes all its evictions in one round;
    that is the sequence of victims the rounds of first minima give while
    no cell won in the call becomes a minimum again. A key past the last
    such cell is `stuck`: no cell of its bucket may take it."""
    match = (bucket_keys == key[:, None]) & (key[:, None] != EMPTY_KEY)
    found = match.any(dim=1)
    empty = bucket_keys == EMPTY_KEY
    empty_cum = torch.cumsum(empty, dim=1)
    takes_empty = rank < empty_cum[:, -1]
    kth_empty = _first_true(empty_cum > rank[:, None])
    stuck = torch.zeros_like(found)
    if protected is None:
        victim = _first_min(bucket_scores)
    else:
        evictable = ~empty & ~protected
        order = torch.sort(torch.where(evictable, bucket_scores, _I64_MAX), dim=1,
                           stable=True).indices
        j = rank - empty_cum[:, -1]
        stuck = ~found & ~takes_empty & (j >= evictable.sum(dim=1))
        victim = _take(order, j.clamp(0, bucket_keys.shape[1] - 1))
    slot = torch.where(found, _first_true(match), torch.where(takes_empty, kth_empty, victim))
    return slot, found, ~found & ~takes_empty, stuck


@torch.no_grad()
def insert_and_evict(
    state: HashTableState,
    keys: torch.Tensor,                  # [n] int64, pre-deduped; EMPTY_KEY = skip
    scores: torch.Tensor,                # [n] int64
    values: Optional[torch.Tensor],      # [n, dim] or None (keep existing)
    opt_rows: Optional[torch.Tensor] = None,  # [n, opt_dim] initial opt state
    *,
    update_existing_values: bool = False,
    rounds: int = 16,
    protect: Optional[torch.Tensor] = None,
) -> Tuple[HashTableState, torch.Tensor, torch.Tensor]:
    """Insert keys (evicting min-score victims in full buckets), in place.

    Returns (state, slots [n] (-1 = failed or skipped), evicted_mask).
    Existing keys get their score refreshed (max(old, new)); their values
    are overwritten only when update_existing_values. A key stored and
    evicted again within this call keeps the slot it had won: compare
    `state.keys` at the slot with the key to tell (`owns_slot`).

    `protect` [capacity] bool (the embedding cache's prefetch passes it,
    the JAX package has none): marked cells are never evicted, every cell
    this call wins is marked, in place, and a bucket's evictions take its
    cells in (score, lane) order in one round (`_choose_slot`). A key
    whose bucket has no cell left for it fails (slot -1, counted as
    overflow). Where the rounds of the unprotected call would evict no
    marked cell and place every key, the result is theirs.
    """
    n = keys.shape[0]
    C, NB = state.bucket_capacity, state.num_buckets
    keys = keys.to(torch.int64)
    scores = scores.to(torch.int64)
    b = hash_keys(keys, NB)
    active = keys != EMPTY_KEY
    flat_keys, flat_scores = state.keys.view(-1), state.scores.view(-1)

    # Hits first (keys are pre-deduped, so hit cells are distinct): their
    # scores refresh with one scatter and they never enter the round loop.
    match0 = (state.keys[b] == keys[:, None]) & active[:, None]
    found_any = match0.any(dim=1)
    flat0 = b * C + _first_true(match0)
    masked_set_(flat_scores, flat0, torch.maximum(flat_scores[flat0], scores), found_any)
    slots_out = torch.where(found_any, flat0, -1)
    evicted_any = torch.zeros((n,), dtype=torch.bool, device=keys.device)
    stuck_any = torch.zeros_like(evicted_any)
    pending = active & ~found_any

    for _ in range(rounds):
        observability.count("emb/insert_rounds")
        if not bool(pending.any()):      # the one host sync of a round
            break
        bucket_keys = state.keys[b]
        raw_scores = state.scores[b]
        bucket_scores = torch.where(bucket_keys == EMPTY_KEY, _I64_MIN, raw_scores)
        rank = _bucket_rank(b, pending, NB)
        prot = None if protect is None else protect.view(NB, C)[b]
        slot_in, found, is_evict, stuck = _choose_slot(bucket_keys, bucket_scores, keys,
                                                       rank, prot)
        flat = b * C + slot_in
        # a stuck key stays stuck: its bucket only fills up
        stuck_any |= pending & stuck
        pending = pending & ~stuck
        # claim: of the keys wanting one cell the lowest index wins this round
        tgt = torch.where(pending, flat, NB * C)
        tgt_sorted, order = torch.sort(tgt, stable=True)
        first = torch.ones((n,), dtype=torch.bool, device=keys.device)
        first[1:] = tgt_sorted[1:] != tgt_sorted[:-1]
        win = torch.empty_like(first)
        win[order] = first & (tgt_sorted < NB * C)
        # only winners write
        refreshed = torch.where(found, torch.maximum(_take(raw_scores, slot_in), scores),
                                scores)
        masked_set_(flat_keys, flat, keys, win)
        masked_set_(flat_scores, flat, refreshed, win)
        slots_out = torch.where(win, flat, slots_out)
        if protect is not None:
            masked_set_(protect, flat, True, win)
        evicted_any |= win & is_evict
        found_any = found_any | (win & found)
        pending = pending & ~win

    # A key that won a cell can lose it again to a later round's eviction
    # (scores that tie, as under LFU): its slot is stale, and only the
    # cell's final owner writes the value row.
    won = slots_out >= 0
    owns = owns_slot(state, keys, slots_out)
    if values is not None:
        write_val = owns if update_existing_values else owns & ~found_any
        masked_set_(state.values, slots_out, values, write_val)
        if opt_rows is not None and state.opt is not None:
            masked_set_(state.opt, slots_out, opt_rows, write_val)
    state.inserted += (won & ~found_any).sum()
    state.evicted += evicted_any.sum()
    state.overflowed += (pending | stuck_any).sum()
    return state, slots_out, evicted_any


def owns_slot(state: HashTableState, keys: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """[n] bool: the key is stored at its slot (False for -1 slots and for
    keys evicted again within the call that returned the slot)."""
    return (slots >= 0) & (state.keys.view(-1)[slots.clamp_min(0)] == keys)


@torch.no_grad()
def erase(state: HashTableState, keys: torch.Tensor) -> HashTableState:
    """Remove keys."""
    slots, found = lookup(state, keys)
    masked_set_(state.keys.view(-1), slots, EMPTY_KEY, found)
    masked_set_(state.scores.view(-1), slots, 0, found)
    return state


@torch.no_grad()
def update_scores(state: HashTableState, slots: torch.Tensor,
                  scores: torch.Tensor) -> HashTableState:
    masked_set_(state.scores.view(-1), slots, scores, slots >= 0)
    return state


@torch.no_grad()
def add_scores(state: HashTableState, slots: torch.Tensor,
               inc: torch.Tensor) -> HashTableState:
    """Accumulate into scores (LFU counting); -1 slots are skipped."""
    ok = slots >= 0
    state.scores.view(-1).index_add_(
        0, slots.clamp_min(0), torch.where(ok, inc.to(torch.int64), 0))
    return state


def export_batch(state: HashTableState, start_bucket: int, num_buckets: int):
    """A contiguous bucket range: (keys, scores, values, valid, opt), for
    dump and checkpoint. Views of the state, not copies."""
    C = state.bucket_capacity
    rows = slice(start_bucket * C, (start_bucket + num_buckets) * C)
    k = state.keys[start_bucket:start_bucket + num_buckets].reshape(-1)
    s = state.scores[start_bucket:start_bucket + num_buckets].reshape(-1)
    o = None if state.opt is None else state.opt[rows]
    return k, s, state.values[rows], k != EMPTY_KEY, o


def count_matched(state: HashTableState, threshold) -> torch.Tensor:
    """Number of live keys with score >= threshold."""
    return ((state.keys != EMPTY_KEY) & (state.scores >= threshold)).sum()


def table_size(state: HashTableState) -> torch.Tensor:
    return (state.keys != EMPTY_KEY).sum()
