"""Host-RAM + SSD key/value tiers (counterpart of
recsys_examples_tpu/dynamicemb/tiered_storage.py), for the embedding host
tier (`HybridDynamicEmbedding`) and the inference KV host tier
(`inference/kvcache.py::HostKVStorage`). numpy only.

  - RAM tier: the native C++ store (csrc/host_store.cpp, `NativeHostStore`).
  - SSD tier: a fixed-slot `np.memmap` arena of rows and an in-RAM key ->
    slot index; reads and writes go through the page cache.
  - put() fills RAM up to `ram_capacity`, then spills the LOWEST-SCORE RAM
    entries to SSD (the table's eviction scores, so the spill order follows
    the table's own LRU or LFU policy).
  - get() probes RAM, then SSD; SSD hits are promoted back to RAM.

Rows, found flags and scores follow the JAX package's bit for bit: the
same stores, visited in the same order.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

from recsys_examples_torch.utils.native import NativeHostStore


class SSDStore:
    """Fixed-slot memmap arena: int64 key -> (f32 row, int64 score)."""

    def __init__(self, path: str, row_dim: int, capacity: int):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.row_dim = row_dim
        self.capacity = capacity
        self._rows = np.memmap(
            path, dtype=np.float32, mode="w+",
            shape=(capacity, row_dim),
        )
        self._index: dict = {}        # key -> slot
        self._scores: dict = {}
        self._free = list(range(capacity - 1, -1, -1))

    def __len__(self) -> int:
        return len(self._index)

    def put(self, keys: np.ndarray, rows: np.ndarray,
            scores: Optional[np.ndarray] = None) -> int:
        """Returns the number stored (stops when the arena is full)."""
        n = 0
        for i, k in enumerate(keys):
            k = int(k)
            slot = self._index.get(k)
            if slot is None:
                if not self._free:
                    break
                slot = self._free.pop()
                self._index[k] = slot
            self._rows[slot] = rows[i]
            self._scores[k] = int(scores[i]) if scores is not None else 0
            n += 1
        return n

    def get(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
        m = len(keys)
        rows = np.zeros((m, self.row_dim), np.float32)
        scores = np.zeros((m,), np.int64)
        found = np.zeros((m,), bool)
        slots = []
        which = []
        for i, k in enumerate(keys):
            slot = self._index.get(int(k))
            if slot is not None:
                slots.append(slot)
                which.append(i)
        if slots:
            # one batched fancy-read through the page cache
            rows[which] = self._rows[np.asarray(slots)]
            for i in which:
                scores[i] = self._scores[int(keys[i])]
                found[i] = True
        return rows, scores, found

    def erase(self, keys: np.ndarray) -> None:
        for k in keys:
            slot = self._index.pop(int(k), None)
            if slot is not None:
                self._free.append(slot)
                self._scores.pop(int(k), None)

    def export(self, batch: int = 65536) -> Iterator[Tuple[np.ndarray,
                                                           np.ndarray,
                                                           np.ndarray]]:
        items = list(self._index.items())
        for lo in range(0, len(items), batch):
            chunk = items[lo:lo + batch]
            ks = np.asarray([k for k, _ in chunk], np.int64)
            sl = np.asarray([s for _, s in chunk])
            yield ks, np.array(self._rows[sl]), np.asarray(
                [self._scores[int(k)] for k in ks], np.int64
            )


class TieredHostStorage:
    """RAM tier (native C++ store) over an SSD spill tier.

    Drop-in for `hybrid_storage.HostStorage` (get_batch/put_batch/pop/erase/
    export) so `HybridDynamicEmbedding` can cap host RAM."""

    def __init__(self, value_dim: int, ram_capacity: int,
                 ssd_path: str, ssd_capacity: int):
        self.value_dim = value_dim
        self.ram_capacity = ram_capacity
        self._ram = NativeHostStore(value_dim)
        self._ssd = SSDStore(ssd_path, value_dim, ssd_capacity)
        self.stats = {"ssd_spills": 0, "ssd_hits": 0, "ram_hits": 0}

    def __len__(self) -> int:
        return len(self._ram) + len(self._ssd)

    @property
    def ram_len(self) -> int:
        return len(self._ram)

    @property
    def ssd_len(self) -> int:
        return len(self._ssd)

    def put_batch(self, keys: np.ndarray, rows: np.ndarray,
                  scores: Optional[np.ndarray] = None) -> None:
        keys = np.ascontiguousarray(keys, np.int64)
        rows = np.ascontiguousarray(rows, np.float32)
        if scores is None:
            scores = np.zeros((len(keys),), np.int64)
        self._ram.put(keys, rows, scores)
        self._maybe_spill()

    def _maybe_spill(self) -> None:
        over = len(self._ram) - self.ram_capacity
        if over <= 0:
            return
        # spill the lowest-score RAM entries (matches the device table's
        # eviction ordering); export yields everything >= threshold 0
        spill_k, spill_r, spill_s = [], [], []
        for ks, rs, ss in self._ram.export(score_threshold=0):
            spill_k.append(ks)
            spill_r.append(rs)
            spill_s.append(ss)
        ks = np.concatenate(spill_k)
        rs = np.concatenate(spill_r)
        ss = np.concatenate(spill_s)
        order = np.argsort(ss, kind="stable")[:over]
        stored = self._ssd.put(ks[order], rs[order], ss[order])
        victims = ks[order][:stored]
        self._ram.erase(victims)
        self.stats["ssd_spills"] += int(stored)

    def get_batch(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        keys = np.ascontiguousarray(keys, np.int64)
        rows, found = self._ram.get(keys)
        self.stats["ram_hits"] += int(found.sum())
        missing = ~found
        if missing.any():
            mk = keys[missing]
            s_rows, s_scores, s_found = self._ssd.get(mk)
            if s_found.any():
                self.stats["ssd_hits"] += int(s_found.sum())
                # promote SSD hits to RAM
                hit_keys = mk[s_found]
                self._ram.put(hit_keys, s_rows[s_found], s_scores[s_found])
                self._ssd.erase(hit_keys)
                self._maybe_spill()
                sub = np.zeros((len(mk), self.value_dim), np.float32)
                sub[s_found] = s_rows[s_found]
                rows[missing] = sub
                f2 = found.copy()
                f2[np.where(missing)[0][s_found]] = True
                found = f2
        return rows, found

    def pop(self, key: int) -> None:
        k = np.asarray([key], np.int64)
        self._ram.erase(k)
        self._ssd.erase(k)

    def erase(self, keys: np.ndarray) -> None:
        """Drop keys from both tiers (the embedding cache's prefetch, for
        the rows it moved onto the card; the JAX package's prefetch erases
        through `HostStorage._store`, which this class lacks)."""
        keys = np.asarray(keys, np.int64)
        self._ram.erase(keys)
        self._ssd.erase(keys)

    def export(self, score_threshold: int = 0):
        yield from self._ram.export(score_threshold=score_threshold)
        for ks, rs, ss in self._ssd.export():
            keep = ss >= score_threshold
            if keep.any():
                yield ks[keep], rs[keep], ss[keep]
