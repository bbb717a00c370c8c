"""SID-GR real-data pipeline: raw interactions -> sequences -> SID batches
(counterpart of recsys_examples_tpu/data/sid_sequence_dataset.py).

The JAX package reads the interaction log with pandas; the card's machine
has none, so this module reads csv/tsv/dat with `csv` and json/jsonl with
`json`, and gives the same npz: the same dropped rows, item relabelling
(sorted unique ids), stable (user, time) order and per-user sequences.
Parquet input raises an ImportError that names what it would need.

As in the JAX package: no cross-hierarchy codebook offsets (one codebook
per hierarchy), leave-one-out splits, and every batch padded to
[B * max_history_tokens] tokens. The mapping file may be .npy / .npz (key
"mapping") / torch .pt, laid out [H, num_items] or [num_items, H].

Preprocess CLI:
    python -m recsys_examples_torch.data.sid_sequence_dataset \\
        interactions.csv sequences.npz [--min-seq-len 2] [--max-seq-len N]
"""
from __future__ import annotations

import csv
import dataclasses
import json
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from recsys_examples_torch.data.sid_batch import SIDBatch

_PARQUET = (".parquet", ".pq")


def _parquet_error(path: str) -> ImportError:
    return ImportError(
        f"{path}: reading parquet needs pandas and pyarrow, which the PyTorch port "
        "does not use; convert the file to csv, jsonl or a sequence npz")


# ----------------------------------------------------------- preprocessing
def _typed(values: List) -> List:
    """A column as pandas would type it: int64 where every present value is
    an integer, else float64 where every one is a number, else strings.
    Missing values (empty fields, JSON null) stay None."""
    for cast in (int, float):
        try:
            return [None if v is None else cast(v) for v in values]
        except (TypeError, ValueError):
            continue
    return values


def _read_columns(path: str, names: Sequence[str]) -> Dict[str, List]:
    """The named columns of an interaction log, missing fields as None;
    columns the file lacks are left out."""
    ext = os.path.splitext(path)[1].lower()
    if ext in _PARQUET:
        raise _parquet_error(path)
    if ext in (".json", ".jsonl"):
        with open(path) as f:
            if ext == ".jsonl":
                rows = [json.loads(line) for line in f if line.strip()]
            else:
                data = json.load(f)
                if isinstance(data, dict):       # {column: [values] or {index: value}}
                    cols = {k: list(v.values()) if isinstance(v, dict) else list(v)
                            for k, v in data.items()}
                    n = len(next(iter(cols.values()), []))
                    rows = [{k: v[i] for k, v in cols.items()} for i in range(n)]
                else:
                    rows = data
        have = set().union(*(r.keys() for r in rows)) if rows else set()
        return {c: [r.get(c) for r in rows] for c in names if c in have}
    sep = "\t" if ext in (".tsv", ".dat") else ","
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter=sep)
        header = next(reader)
        idx = {c: header.index(c) for c in names if c in header}
        cols: Dict[str, List] = {c: [] for c in idx}
        for row in reader:
            if not row:
                continue
            for c, i in idx.items():
                v = row[i] if i < len(row) else ""
                cols[c].append(v if v != "" else None)
    return cols


def preprocess_interactions(
    interactions_path: str,
    out_path: str,
    user_col: str = "user_id",
    item_col: str = "item_id",
    time_col: Optional[str] = "timestamp",
    min_seq_len: int = 2,
    max_seq_len: Optional[int] = None,
    relabel_items: bool = True,
) -> dict:
    """Raw interaction log (csv/tsv/dat/json/jsonl) -> per-user sequence npz.

    Output npz: flat_items [total] int64, offsets [N+1] int64, user_ids [N]
    int64, num_items scalar. Returns summary stats."""
    cols = _read_columns(interactions_path, [c for c in (user_col, item_col, time_col)
                                             if c is not None])
    for c in (user_col, item_col):
        if c not in cols:
            raise KeyError(f"{interactions_path} has no column {c!r}")
    use = [user_col, item_col] + ([time_col] if time_col in cols else [])
    table = {c: _typed(cols[c]) for c in use}
    keep = [i for i in range(len(table[user_col]))
            if all(table[c][i] is not None for c in use)]        # dropna
    table = {c: [v[i] for i in keep] for c, v in table.items()}
    if relabel_items:
        # contiguous item ids (sorted unique values) so the SID map is dense
        uniq = sorted(set(table[item_col]))
        code = {v: i for i, v in enumerate(uniq)}
        table[item_col] = [code[v] for v in table[item_col]]
    key = (lambda i: (table[user_col][i], table[time_col][i])) if time_col in table \
        else (lambda i: table[user_col][i])
    order = sorted(range(len(keep)), key=key)                     # stable

    flat, offsets, users = [], [0], []
    start = 0
    while start < len(order):
        uid = table[user_col][order[start]]
        end = start
        while end < len(order) and table[user_col][order[end]] == uid:
            end += 1
        seq = np.asarray([table[item_col][i] for i in order[start:end]], np.int64)
        start = end
        if len(seq) < min_seq_len:
            continue
        if max_seq_len is not None:
            seq = seq[-max_seq_len:]
        flat.append(seq)
        offsets.append(offsets[-1] + len(seq))
        users.append(uid)
    if not flat:
        raise ValueError("no user has a sequence >= min_seq_len")
    flat_items = np.concatenate(flat)
    num_items = int(flat_items.max()) + 1
    np.savez(
        out_path,
        flat_items=flat_items,
        offsets=np.asarray(offsets, np.int64),
        user_ids=np.asarray(users, np.int64),
        num_items=np.int64(num_items),
    )
    return {
        "num_users": len(users),
        "num_items": num_items,
        "num_interactions": int(flat_items.shape[0]),
        "out_path": out_path,
    }


def load_sequences(path: str):
    """(flat_items, offsets, user_ids, num_items) from a preprocessed npz."""
    if os.path.splitext(path)[1].lower() in _PARQUET:
        raise _parquet_error(path)
    data = np.load(path)
    return (
        data["flat_items"],
        data["offsets"],
        data["user_ids"],
        int(data["num_items"]),
    )


def load_sid_mapping(path: str, num_hierarchies: int) -> np.ndarray:
    """PID -> SID mapping as [num_items, H] int32, from .npy / .npz (key
    "mapping") / torch .pt laid out [H, num_items] or [num_items, H]."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        arr = np.load(path)["mapping"]
    elif ext == ".npy":
        arr = np.load(path)
    else:
        arr = torch.load(path, map_location="cpu", weights_only=True)
    arr = np.asarray(arr)
    if arr.ndim != 2:
        raise ValueError(f"SID mapping must be 2D, got {arr.shape}")
    if arr.shape[0] == num_hierarchies and arr.shape[1] != num_hierarchies:
        arr = arr.T  # layout [H, num_items]
    if arr.shape[1] != num_hierarchies:
        raise ValueError(
            f"SID mapping {arr.shape} incompatible with "
            f"num_hierarchies={num_hierarchies}"
        )
    return np.ascontiguousarray(arr, np.int32)


def build_rq_sid_mapping(
    item_embeddings: np.ndarray,
    codebook_sizes: Sequence[int],
    iters: int = 25,
    seed: int = 0,
    make_unique: bool = True,
) -> np.ndarray:
    """Residual k-means quantization: item embeddings -> SID tuples
    [num_items, H] int32. Level h quantizes the residual left by the levels
    before it. With make_unique, colliding tuples are moved to the nearest
    free tuple (last level fastest) when the codebooks have room."""
    rng = np.random.default_rng(seed)
    x = np.asarray(item_embeddings, np.float64).copy()
    n = x.shape[0]
    codes = np.zeros((n, len(codebook_sizes)), np.int32)
    for h, K in enumerate(codebook_sizes):
        K = min(K, n)
        centers = x[rng.choice(n, size=K, replace=False)].copy()
        assign = np.zeros(n, np.int64)
        for _ in range(iters):
            d = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
            assign = d.argmin(1)
            for k in range(K):
                m = assign == k
                if m.any():
                    centers[k] = x[m].mean(0)
        codes[:, h] = assign.astype(np.int32)
        x = x - centers[assign]
    sizes = [int(k) for k in codebook_sizes]
    if make_unique and n <= int(np.prod(sizes)):
        # odometer search outward from the item's own code, last level fastest
        seen = set()
        for i in range(n):
            t = tuple(int(c) for c in codes[i])
            if t not in seen:
                seen.add(t)
                continue
            found = False
            for lvl in range(len(sizes) - 1, -1, -1):
                idx = list(range(lvl, len(sizes)))
                total = int(np.prod([sizes[j] for j in idx]))
                for step in range(1, total):
                    rem = step
                    cand = list(t)
                    for j in reversed(idx):
                        cand[j] = (t[j] + rem) % sizes[j]
                        rem //= sizes[j]
                    ct = tuple(cand)
                    if ct not in seen:
                        codes[i] = np.asarray(ct, np.int32)
                        seen.add(ct)
                        found = True
                        break
                if found:
                    break
    return codes


# ------------------------------------------------------------- the dataset
@dataclasses.dataclass
class SIDSequenceDataset:
    """Iterable SID batches (numpy; `SIDBatch.to` moves them) from
    preprocessed sequences + a PID->SID map.

    Leave-one-out: the eval candidate is each user's last item; the train
    candidate is the second-to-last, with history before it, so eval labels
    are never trained on."""

    flat_items: np.ndarray     # [total] int64
    offsets: np.ndarray        # [N+1] int64
    sid_mapping: np.ndarray    # [num_items, H] int32
    batch_size: int
    max_history_items: int
    split: str = "train"       # "train" | "eval"
    shuffle: bool = True
    seed: int = 0
    drop_last: bool = False

    def __post_init__(self):
        lengths = np.diff(self.offsets)
        need = 2 if self.split == "train" else 1
        self._rows = np.nonzero(lengths >= need + 1)[0]
        self._H = self.sid_mapping.shape[1]
        if int(self.flat_items.max()) >= self.sid_mapping.shape[0]:
            raise ValueError(
                "sequence contains item ids outside the SID mapping"
            )

    def __len__(self) -> int:
        n = len(self._rows)
        b = self.batch_size
        return n // b if self.drop_last else (n + b - 1) // b

    def _example(self, row: int):
        s, e = int(self.offsets[row]), int(self.offsets[row + 1])
        seq = self.flat_items[s:e]
        if self.split == "train":
            seq = seq[:-1]  # hold out the eval candidate entirely
        cand = seq[-1]
        hist = seq[:-1][-self.max_history_items:]
        return hist, cand

    def __iter__(self) -> Iterator[SIDBatch]:
        rows = self._rows
        if self.shuffle and self.split == "train":
            rows = np.random.default_rng(self.seed).permutation(rows)
        H = self._H
        B = self.batch_size
        cap = B * self.max_history_items * H
        for i in range(len(self)):
            chunk = rows[i * B:(i + 1) * B]
            sids = np.zeros((cap,), np.int32)
            lengths = np.zeros((B,), np.int32)
            cand = np.zeros((B, H), np.int32)
            off = 0
            for j, row in enumerate(chunk):
                hist, c = self._example(int(row))
                toks = self.sid_mapping[hist].reshape(-1)  # [n*H]
                sids[off:off + len(toks)] = toks
                lengths[j] = len(toks)
                cand[j] = self.sid_mapping[c]
                off += len(toks)
            offsets = np.zeros((B + 1,), np.int32)
            np.cumsum(lengths, out=offsets[1:])
            yield SIDBatch(
                history_sids=sids,
                history_lengths=lengths,
                history_offsets=offsets,
                candidate_sids=cand,
                batch_size=B,
                num_hierarchies=H,
                max_history_tokens=self.max_history_items * H,
            )


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="raw interaction log -> per-user sequence npz"
    )
    p.add_argument("interactions", help="csv/tsv/dat/json/jsonl of events")
    p.add_argument("out", help="output .npz path")
    p.add_argument("--user-col", default="user_id")
    p.add_argument("--item-col", default="item_id")
    p.add_argument("--time-col", default="timestamp")
    p.add_argument("--min-seq-len", type=int, default=2)
    p.add_argument("--max-seq-len", type=int, default=None)
    a = p.parse_args(argv)
    stats = preprocess_interactions(
        a.interactions, a.out, user_col=a.user_col, item_col=a.item_col,
        time_col=a.time_col, min_seq_len=a.min_seq_len,
        max_seq_len=a.max_seq_len,
    )
    print(stats)
    return stats


if __name__ == "__main__":
    main()
