"""Device table + host-RAM tier with prefetch: the embedding cache
(counterpart of recsys_examples_tpu/dynamicemb/hybrid_storage.py).

  - device tier: the bucketized table on the card (the "cache");
  - host tier: `HostStorage` (the native C++ store, csrc/host_store.cpp) or
    a `tiered_storage.TieredHostStorage` that caps RAM over an SSD arena;
  - prefetch(keys): before the train step, the batch's keys missing on the
    card come from the host tier (or, in neither tier, from the key-seeded
    initializer) into the device table, and the rows their insert evicts go
    back to the host tier. The train step then finds every batch key on
    the card.

Under a mesh each rank's table shard is the cache for the keys it owns
(`sharded_collection.route_owner`), and each rank has its own host store:
`prefetch` takes the global batch's keys and brings the ones this rank owns
onto its card. The JAX package's single controller keeps one host store for
all shards and prefetches every owner's bucket in one call; the union of the
ranks' stores and the sum of their `stats` are its store and stats.

What the JAX package does for its TPU alone is left out: the power-of-two
bucket padding of `_pack` (one compile per width) and the jitted ops; the
sorted unique keys go to the insert as they are, which sees the same lanes
in the same order, less the EMPTY_KEY lanes it skips. The state is updated
in place, as everywhere in the port.

One deliberate difference: the prefetch's insert never takes one of the
batch's own keys as its victim while the bucket holds another key. The
JAX prefetch looks the hits up without refreshing their scores and may
evict them to make room for the misses; the train step then misses them
and write-allocates fresh rows, and their trained rows go stale in the host
tier. Here the hits' cells and the cells this insert wins are protected in
the victim choice (`hashtable.insert_and_evict(protect=...)`). Wherever the
JAX prefetch evicts none of the batch's keys, both packages leave the same
table, bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from recsys_examples_torch.dynamicemb.batched_table import (
    DynamicEmbeddingTable,
    DynamicEmbTableState,
)
from recsys_examples_torch.dynamicemb.dynamicemb_config import EMPTY_KEY
from recsys_examples_torch.dynamicemb.hashtable import (
    export_batch,
    insert_and_evict,
    lookup,
    owns_slot,
)
from recsys_examples_torch.dynamicemb.initializer import initialize_embeddings
from recsys_examples_torch.dynamicemb.optimizer import initial_opt_row
from recsys_examples_torch.dynamicemb.sharded_collection import route_owner
from recsys_examples_torch.utils.device import resolve_device
from recsys_examples_torch.utils.native import NativeHostStore
from recsys_examples_torch.utils.scatter import masked_set_


class HostStorage:
    """Host-RAM key -> (value row, score) store over the native C++ store."""

    def __init__(self, value_dim: int):
        self.value_dim = value_dim
        self._store = NativeHostStore(value_dim)

    def __len__(self):
        return len(self._store)

    def get_batch(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(values [n, vd], found [n]) for int64 keys."""
        return self._store.get(np.asarray(keys, np.int64))

    def put_batch(self, keys: np.ndarray, values: np.ndarray, scores: np.ndarray) -> None:
        keys = np.asarray(keys, np.int64)
        live = keys != EMPTY_KEY
        self._store.put(keys[live], np.asarray(values, np.float32)[live],
                        np.asarray(scores, np.int64)[live])

    def pop(self, key: int) -> None:
        self._store.erase(np.asarray([key], np.int64))

    def erase(self, keys: np.ndarray) -> None:
        self._store.erase(np.asarray(keys, np.int64))

    def export(self, score_threshold: int = 0):
        return self._store.export(score_threshold)


@torch.no_grad()
def insert_flush(table: DynamicEmbeddingTable, state: DynamicEmbTableState,
                 keys: torch.Tensor, score: int, emb: torch.Tensor, opt_rows,
                 have_row: torch.Tensor, protect: torch.Tensor):
    """The device side of a prefetch, in place: fresh rows from the
    key-seeded initializer where `have_row` is False, the insert (evicting
    min-score victims, never a `protect`ed cell while the bucket holds
    another), and the victims' rows as they were before it, for the host
    flush.

    keys [n] (distinct, no EMPTY_KEY); emb [n, dim]; opt_rows [n, opt_dim]
    or None. Returns (victim keys [n] (EMPTY_KEY: no victim), victim scores
    [n], victim rows [n, value_dim], placed [n]): `placed` is False where
    the insert found no cell within its rounds; those keys are not on the
    card and their host rows must stay."""
    opts, t = table.options, state.table
    n = keys.shape[0]
    init_e = initialize_embeddings(keys, table.dim, opts.initializer_args, opts.value_dtype)
    emb = torch.where(have_row[:, None], emb.to(opts.value_dtype), init_e)
    if opt_rows is not None:
        init_o = initial_opt_row(table.opt_args.optimizer, n, table.dim, table.opt_args,
                                 opts.value_dtype, keys.device)
        opt_rows = torch.where(have_row[:, None], opt_rows.to(opts.value_dtype), init_o)
    old_keys, old_scores = t.keys.view(-1).clone(), t.scores.view(-1).clone()
    # keys and scores first; the victims' rows are read before the new rows land
    _, slots, evicted = insert_and_evict(
        t, keys, torch.full((n,), score, dtype=torch.int64, device=keys.device), None,
        update_existing_values=True, rounds=opts.insert_rounds, protect=protect)
    has_victim = evicted & (slots >= 0)
    vslots = torch.where(has_victim, slots, 0)
    vkeys = torch.where(has_victim, old_keys[vslots], EMPTY_KEY)
    vrows = t.values[vslots]
    if t.opt is not None:
        vrows = torch.cat([vrows, t.opt[vslots]], dim=1)
    owns = owns_slot(t, keys, slots)
    masked_set_(t.values, slots, emb, owns)
    if opt_rows is not None and t.opt is not None:
        masked_set_(t.opt, slots, opt_rows, owns)
    return vkeys, old_scores[vslots], vrows, slots >= 0


class HybridDynamicEmbedding:
    """A device table (the cache) over a host tier; `prefetch` keeps each
    batch's keys on the card, so the train step never misses to the host.
    With `mesh`, the table is this rank's shard over the mesh's data axis (or
    `axis`) and the cache holds the keys this rank owns."""

    def __init__(self, table: DynamicEmbeddingTable, host_storage=None, mesh=None,
                 axis=None, device="cuda"):
        self.table = table
        self.mesh = mesh
        if mesh is None:
            self.world, self.rank = 1, 0
        else:
            axis = axis if axis is not None else mesh.data_axis
            self.world, self.rank = mesh.size(axis), mesh.index(axis)
        self.device = resolve_device(device)
        self.host = host_storage if host_storage is not None else HostStorage(table.value_dim)
        self.stats = {"lookups": 0, "device_hits": 0, "host_onboards": 0,
                      "evict_flushes": 0, "insert_failures": 0}

    def init_state(self) -> DynamicEmbTableState:
        return self.table.init_state(self.device)

    @torch.no_grad()
    def prefetch(self, state: DynamicEmbTableState, keys: np.ndarray) -> DynamicEmbTableState:
        """Bring the batch's keys (this rank's, under a mesh, of the global
        batch's `keys`) onto the card, in place: host-tier rows are
        onboarded, keys in neither tier write-allocated with the key-seeded
        initializer, and the rows the insert evicts flushed to the host
        tier. Reads the lookup's flags and the step from the card (two host
        syncs) and copies the victims back."""
        keys = np.asarray(keys).reshape(-1)
        ukeys = np.unique(keys[keys != EMPTY_KEY])
        if self.mesh is not None:
            own = route_owner(torch.from_numpy(ukeys.astype(np.int64)), self.world)
            ukeys = ukeys[(own == self.rank).numpy()]
        if len(ukeys) == 0:
            return state
        t = state.table
        dev = t.keys.device
        dk = torch.from_numpy(ukeys.astype(np.int64)).to(dev)
        hit_slots, found = lookup(t, dk)
        found = found.cpu().numpy()
        self.stats["lookups"] += len(ukeys)
        self.stats["device_hits"] += int(found.sum())
        miss = ~found
        if not miss.any():
            return state
        miss_keys = ukeys[miss]
        host_vals, host_found = self.host.get_batch(miss_keys)
        self.stats["host_onboards"] += int(host_found.sum())

        dim, vd, od = self.table.dim, self.table.value_dim, self.table.opt_dim
        n = len(miss_keys)
        emb = np.zeros((n, dim), np.float32)
        opt = np.zeros((n, max(od, 1)), np.float32)
        hv = host_vals[host_found]
        emb[host_found] = hv[:, :dim]
        if od > 0 and hv.shape[1] >= vd:
            opt[host_found] = hv[:, dim:vd]
        protect = torch.zeros((t.capacity,), dtype=torch.bool, device=dev)
        masked_set_(protect, hit_slots, True, hit_slots >= 0)
        score = int(state.step[0]) + 1
        to = lambda x: torch.from_numpy(x).to(dev)
        vkeys, vscores, vrows, placed = insert_flush(
            self.table, state, to(miss_keys.astype(np.int64)), score, to(emb),
            to(opt) if od > 0 else None, to(host_found), protect)
        vkeys = vkeys.cpu().numpy()
        live = vkeys != EMPTY_KEY
        if live.any():
            self.host.put_batch(vkeys[live], vrows.float().cpu().numpy()[live],
                                vscores.cpu().numpy()[live])
            self.stats["evict_flushes"] += int(live.sum())
        # drop only the keys that landed on the card from the host tier: a
        # key that found no cell within the insert's rounds keeps its row
        landed = miss_keys[placed.cpu().numpy()]
        self.stats["insert_failures"] += n - len(landed)
        if len(landed):
            self.host.erase(landed)
        return state

    @torch.no_grad()
    def flush_all(self, state: DynamicEmbTableState) -> None:
        """Copy the whole device table to the host tier (before a full dump)."""
        nb = state.table.num_buckets
        step = max(1, min(nb, 4096))
        for start in range(0, nb, step):
            k, s, v, valid, o = export_batch(state.table, start, min(step, nb - start))
            if o is not None:
                v = torch.cat([v, o], dim=1)
            valid = valid.cpu().numpy()
            self.host.put_batch(k.cpu().numpy()[valid], v.float().cpu().numpy()[valid],
                                s.cpu().numpy()[valid])

    def hit_rate(self) -> float:
        """Device-tier hit rate since the start."""
        lk = self.stats["lookups"]
        return self.stats["device_hits"] / lk if lk else 1.0
