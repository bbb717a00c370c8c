"""Sequence dataset loaders + preprocessor (MovieLens / KuaiRand)
(counterpart of recsys_examples_tpu/data/sequence_dataset.py).

Raw data -> per-user chronological item/action sequences -> HSTUBatch
stream. The preprocessor writes a compact .npz (user -> item ids, action
ids, timestamps) once, with the same arrays as the JAX package's; the
loader slices train/eval batches on the host.

Everything here is numpy and the standard library: the preprocessors read
the files with `csv` (pandas is not a dependency of the port), and the
batch producers emit numpy leaves only, since they run on the prefetch
worker thread. `HSTUBatch.to(device)` makes the tensors, on the main
thread.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from recsys_examples_torch.data.hstu_batch import HSTUBatch, JaggedIds


def _read_csv(path: str) -> Tuple[List[str], List[List[str]]]:
    """(header, columns of raw strings)."""
    with open(path, newline="") as f:
        rows = csv.reader(f)
        header = next(rows)
        cols = [list(c) for c in zip(*rows)] or [[] for _ in header]
    return header, cols


def _int_column(col: List[str]) -> np.ndarray:
    """A numeric column as int64; a decimal column is truncated toward 0,
    as pandas' `to_numpy(np.int64)` does."""
    try:
        return np.asarray(col, dtype=np.int64)
    except ValueError:
        return np.asarray(col, dtype=np.float64).astype(np.int64)


def _category_strings(col: List[str]) -> List[str]:
    """The strings pandas' `read_csv(...)[col].astype(str)` gives: integer
    columns in canonical form, decimal columns (and integer columns with
    empty cells) as floats, empty cells as "nan", other text unchanged."""
    filled = [c for c in col if c != ""]
    try:
        ints = [int(c) for c in filled]
        if len(filled) == len(col):
            return [str(i) for i in ints]
    except ValueError:
        pass
    try:
        return [str(float(c)) if c != "" else "nan" for c in col]
    except ValueError:
        return [c if c != "" else "nan" for c in col]


def _group_sequences(users: np.ndarray, times: np.ndarray, min_seq_len: int):
    """Row order sorted by (user, time), stable, and the kept users' row
    ranges: (order, kept user ids, starts, ends)."""
    order = np.lexsort((times, users))
    su = users[order]
    if len(su) == 0:
        return order, su, su, su
    starts = np.flatnonzero(np.r_[True, su[1:] != su[:-1]])
    ends = np.r_[starts[1:], len(su)]
    keep = (ends - starts) >= min_seq_len
    return order, su[starts[keep]], starts[keep], ends[keep]


def _pack(order, starts, ends, columns: Dict[str, np.ndarray]):
    rows = order[np.concatenate([np.arange(s, e) for s, e in zip(starts, ends)])] \
        if len(starts) else np.zeros(0, np.int64)
    out = {name: col[rows].astype(np.int64) for name, col in columns.items()}
    out["offsets"] = np.concatenate([[0], np.cumsum(ends - starts)]).astype(np.int64)
    return out


def preprocess_movielens(
    ratings_path: str, out_path: str, min_seq_len: int = 5
) -> dict:
    """ml-1m/ml-20m ratings.dat/.csv -> sequences .npz.

    Ratings become 'actions'; items are movie ids."""
    if ratings_path.endswith(".dat"):
        with open(ratings_path, "rb") as f:
            raw = f.read().replace(b"::", b" ").split()
        table = np.asarray(raw, dtype=np.int64).reshape(-1, 4)
        user, movie, rating, ts = table.T
    else:
        _, cols = _read_csv(ratings_path)
        user, movie, rating, ts = (_int_column(c) for c in cols[:4])
    order, users, starts, ends = _group_sequences(user, ts, min_seq_len)
    packed = _pack(order, starts, ends,
                   {"item_ids": movie, "action_ids": rating, "timestamps": ts})
    data = {"user_ids": users.astype(np.int64), "item_ids": packed["item_ids"],
            "action_ids": packed["action_ids"], "timestamps": packed["timestamps"],
            "offsets": packed["offsets"]}
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **data)
    return data


# KuaiRand event -> bit weight
KUAIRAND_EVENT_WEIGHTS = {
    "is_click": 1,
    "is_like": 2,
    "is_follow": 4,
    "is_comment": 8,
    "is_forward": 16,
    "is_hate": 32,
    "long_view": 64,
    "is_profile_enter": 128,
}

KUAIRAND_CONTEXTUAL_COLS = (
    "user_active_degree",
    "follow_user_num_range",
    "fans_user_num_range",
    "friend_user_num_range",
    "register_days_range",
)


def preprocess_kuairand(
    log_paths,
    user_features_path: Optional[str],
    out_path: str,
    min_seq_len: int = 5,
) -> dict:
    """KuaiRand (pure/1k/27k) log CSVs -> sequences .npz: per-user video_id
    sequences ordered by time_ms, the per-event binary columns bit-merged
    into one action weight (is_click=1, is_like=2, ..., is_profile_enter=128),
    and the user contextual features (categorical ranges) label-encoded.

    The npz uses the same schema as `preprocess_movielens` plus `ctx_<name>`
    columns [num_users] when user features are given."""
    if isinstance(log_paths, str):
        log_paths = [log_paths]
    frames = [dict(zip(*_read_csv(p))) for p in log_paths]
    names = list(frames[0])
    col = lambda n: np.concatenate([_int_column(fr[n]) for fr in frames])
    n_rows = sum(len(fr[names[0]]) for fr in frames)
    aw = np.zeros(n_rows, np.int64)
    for e, w in KUAIRAND_EVENT_WEIGHTS.items():
        if e in names:
            flag = np.concatenate([np.asarray(fr[e], np.float64) for fr in frames])
            aw |= (flag != 0).astype(np.int64) * w
    time_col = "time_ms" if "time_ms" in names else "timestamp"
    user = col("user_id")
    ts = col(time_col)

    ctx_maps = {}
    if user_features_path:
        header, ucols = _read_csv(user_features_path)
        uf = dict(zip(header, ucols))
        uids = _int_column(uf["user_id"])
        for c in KUAIRAND_CONTEXTUAL_COLS:
            if c in uf:
                strs = _category_strings(uf[c])
                cats = {v: i for i, v in enumerate(sorted(set(strs)))}
                ctx_maps[c] = {int(u): cats[s] for u, s in zip(uids, strs)}

    order, users, starts, ends = _group_sequences(user, ts, min_seq_len)
    packed = _pack(order, starts, ends,
                   {"item_ids": col("video_id"), "action_ids": aw, "timestamps": ts})
    data = {"user_ids": users.astype(np.int64), "item_ids": packed["item_ids"],
            "action_ids": packed["action_ids"], "timestamps": packed["timestamps"],
            "offsets": packed["offsets"]}
    for c, m in ctx_maps.items():
        data[f"ctx_{c}"] = np.asarray([m.get(int(u), 0) for u in users], np.int64)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **data)
    return data


def _assemble_native(lib, args):
    """One call of csrc/batch_assembler.cpp; `.calls` counts them."""
    from recsys_examples_torch.utils.native import _ptr

    _assemble_native.calls += 1
    return int(lib.assemble_batch(*[_ptr(a) if isinstance(a, np.ndarray) else a
                                    for a in args]))


_assemble_native.calls = 0


class SequenceDataset:
    """Per-user sequences with a leave-last-N-out train/eval split."""

    def __init__(
        self,
        npz_path: str,
        max_history_len: int,
        max_num_candidates: int = 1,
        num_tasks: int = 1,
        eval_holdout: int = 1,
        action_vocab_size: int = 0,
        label_mode: str = "rating_ge4",   # rating_ge4 | action_bits
        contextual_feature_names: Tuple[str, ...] = (),
    ):
        d = np.load(npz_path)
        self.user_ids = d["user_ids"]
        self.item_ids = d["item_ids"]
        self.action_ids = d["action_ids"] if "action_ids" in d else None
        self.timestamps = d["timestamps"] if "timestamps" in d else None
        self.offsets = d["offsets"]
        self.max_history_len = max_history_len
        self.max_num_candidates = max_num_candidates
        self.num_tasks = num_tasks
        self.eval_holdout = eval_holdout
        self.action_vocab_size = action_vocab_size
        self.label_mode = label_mode
        self.contextual_feature_names = tuple(contextual_feature_names)
        self.contextual = {
            n: d[f"ctx_{n}"]
            for n in self.contextual_feature_names
            if f"ctx_{n}" in d
        }
        # the "user" contextual feature is the user id itself
        self.num_users = len(self.user_ids)

    def _user_seq(self, u: int, train: bool):
        s, e = self.offsets[u], self.offsets[u + 1]
        items = self.item_ids[s:e]
        actions = (
            self.action_ids[s:e] if self.action_ids is not None else None
        )
        if train:
            items = items[: len(items) - self.eval_holdout]
            if actions is not None:
                actions = actions[: len(actions) - self.eval_holdout]
        # truncate oldest
        if len(items) > self.max_history_len + self.max_num_candidates:
            cut = len(items) - (self.max_history_len + self.max_num_candidates)
            items = items[cut:]
            if actions is not None:
                actions = actions[cut:]
        return items, actions

    def _assemble(self, uids: np.ndarray, train: bool, cap: int):
        """Pack one batch: the native C++ packer (csrc/batch_assembler.cpp)
        where it applies and builds, else the Python loop."""
        from recsys_examples_torch.utils.native import batch_assembler_lib

        batch_size = len(uids)
        iv = np.zeros((cap,), np.int64)
        av = np.zeros((cap,), np.int64)
        lens = np.zeros((batch_size,), np.int32)
        ncand = np.zeros((batch_size,), np.int32)
        labels = np.zeros(
            (batch_size * max(self.max_num_candidates, 1),), np.int32
        )
        lab_len = np.zeros((batch_size,), np.int32)
        lib = batch_assembler_lib()
        if (lib is not None and self.action_ids is not None
                and self.label_mode == "rating_ge4"):
            total = _assemble_native(lib, (
                np.ascontiguousarray(self.item_ids, np.int64),
                np.ascontiguousarray(self.action_ids, np.int64),
                np.ascontiguousarray(self.offsets, np.int64),
                np.ascontiguousarray(uids, np.int64),
                batch_size, int(train), self.eval_holdout,
                self.max_history_len, self.max_num_candidates, cap, 4,
                iv, av, lens, ncand, labels, lab_len))
            if total < 0:
                raise ValueError(f"batch of {batch_size} users overflows {cap} tokens")
            return iv, av, lens, ncand, labels, lab_len
        pos = 0
        for j, u in enumerate(uids):
            items, actions = self._user_seq(int(u), train)
            n = len(items)
            nc = min(self.max_num_candidates, max(n - 1, 0))
            iv[pos:pos + n] = items
            if actions is not None:
                av[pos:pos + n] = actions
            lens[j] = n
            ncand[j] = nc
            # labels from actions on candidates: MovieLens rating >= 4, or
            # KuaiRand bit-encoded multi-event weights (decode_bits unpacks
            # bit t as task t's label)
            if nc > 0 and actions is not None:
                if self.label_mode == "action_bits":
                    task_mask = (1 << self.num_tasks) - 1
                    pos_lab = (actions[n - nc:] & task_mask).astype(np.int32)
                else:
                    pos_lab = (actions[n - nc:] >= 4).astype(np.int32)
                labels[
                    j * self.max_num_candidates:
                    j * self.max_num_candidates + nc
                ] = pos_lab
                lab_len[j] = nc
            pos += n
        return iv, av, lens, ncand, labels, lab_len

    def batches(
        self, batch_size: int, *, train: bool = True, seed: int = 0,
        shuffle: bool = True,
    ) -> Iterator[HSTUBatch]:
        """Batches of `batch_size` users with numpy leaves; a train stream
        repeats (reshuffled each pass), an eval stream ends after one."""
        rng = np.random.default_rng(seed)
        order = np.arange(self.num_users)
        while True:
            if shuffle:
                rng.shuffle(order)
            for i in range(0, self.num_users - batch_size + 1, batch_size):
                uids = order[i:i + batch_size]
                item_max = self.max_history_len + self.max_num_candidates
                cap = batch_size * item_max
                iv, av, lens, ncand, labels, lab_len = self._assemble(
                    uids, train, cap
                )
                offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
                feats = {"item": JaggedIds(values=iv, lengths=lens, offsets=offs,
                                           max_len=item_max)}
                f2m = {"item": item_max}
                act_name = None
                if self.action_ids is not None and self.action_vocab_size:
                    act_name = "action"
                    feats["action"] = JaggedIds(values=av, lengths=lens, offsets=offs,
                                                max_len=item_max)
                    f2m["action"] = item_max
                ctx_names = []
                for cname in self.contextual_feature_names:
                    if cname == "user":
                        src = self.user_ids
                    elif cname in self.contextual:
                        src = self.contextual[cname]
                    else:
                        continue
                    feats[cname] = JaggedIds(
                        values=np.asarray(src)[uids].astype(np.int64),
                        lengths=np.ones((batch_size,), np.int32),
                        offsets=np.arange(batch_size + 1, dtype=np.int32),
                        max_len=1,
                    )
                    f2m[cname] = 1
                    ctx_names.append(cname)
                yield HSTUBatch(
                    features=feats,
                    batch_size=batch_size,
                    feature_to_max_seqlen=f2m,
                    item_feature_name="item",
                    action_feature_name=act_name,
                    contextual_feature_names=tuple(ctx_names),
                    max_num_candidates=self.max_num_candidates,
                    num_candidates=ncand if self.max_num_candidates else None,
                    labels=labels,
                    label_lengths=lab_len,
                )
            if not train:
                return


def sequence_dataset_iterator(ds_args, trainer_args) -> Iterator[HSTUBatch]:
    """The train stream of `ds_args`' file dataset, seeded by the trainer's
    seed."""
    ds = make_sequence_dataset(ds_args)
    yield from ds.batches(ds_args.batch_size, train=True, seed=trainer_args.seed,
                          shuffle=ds_args.shuffle)


def make_sequence_dataset(ds_args, max_num_candidates=None) -> "SequenceDataset":
    """`max_num_candidates` overrides ds_args (the eval loop trains on the
    last-N candidates of the train split but scores the holdout alone, so
    eval labels never overlap training labels)."""
    label_mode = (
        "action_bits" if ds_args.dataset_name.startswith("kuairand")
        else "rating_ge4"
    )
    return SequenceDataset(
        ds_args.dataset_path,
        max_history_len=ds_args.max_history_len,
        max_num_candidates=ds_args.max_num_candidates
        if max_num_candidates is None else max_num_candidates,
        num_tasks=ds_args.num_tasks,
        action_vocab_size=ds_args.action_vocab_size,
        label_mode=label_mode,
        contextual_feature_names=tuple(ds_args.contextual_feature_names),
    )


class PrefetchIterator:
    """Background-thread batch prefetch: overlaps host-side batch assembly
    with the device step. The worker only pulls from `it`, which must make
    numpy leaves and touch neither torch nor CUDA; depth <= 0 is a
    synchronous pass-through."""

    def __init__(self, it: Iterator[HSTUBatch], depth: int = 2):
        import queue
        import threading

        self._it = it if depth <= 0 else None
        if self._it is not None:
            return
        self._q = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()
        self._error = None

        def put(item) -> bool:
            # bounded waits, so close() can unblock and stop us
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in it:
                    if not put(item):
                        return
            except Exception as e:      # handed to the consumer by __next__
                self._error = e
            finally:
                put(self._done)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def close(self, timeout: float = 5.0):
        """Stop the worker and drain; idempotent. The training entries call
        this after the loop so no background thread outlives the run."""
        if self._it is not None:
            return
        import queue

        def drain():
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    return

        self._stop.set()
        drain()
        self._t.join(timeout)
        drain()
        self._q.put_nowait(self._done)     # a later next() ends the stream

    def __iter__(self):
        return self

    def __next__(self):
        if self._it is not None:
            return next(self._it)
        item = self._q.get()
        if item is self._done:
            # leave the sentinel for any later call: the stream stays ended
            self._q.put_nowait(item)
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


def _cli(argv=None):
    """Preprocessor CLI.

    python -m recsys_examples_torch.data.sequence_dataset \\
        --preprocess ml-1m --ratings ratings.dat --out ml1m_seq.npz
    python -m recsys_examples_torch.data.sequence_dataset \\
        --preprocess kuairand --logs a.csv,b.csv \\
        --user-features user_features_pure.csv --out kuairand_seq.npz
    """
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--preprocess", required=True,
                   choices=["ml-1m", "ml-20m", "kuairand"])
    p.add_argument("--ratings", default=None)
    p.add_argument("--logs", default=None, help="comma-separated log CSVs")
    p.add_argument("--user-features", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--min-seq-len", type=int, default=5)
    args = p.parse_args(argv)
    if args.preprocess in ("ml-1m", "ml-20m"):
        if not args.ratings:
            p.error("--ratings is required for MovieLens")
        d = preprocess_movielens(args.ratings, args.out, args.min_seq_len)
    else:
        if not args.logs:
            p.error("--logs is required for KuaiRand")
        d = preprocess_kuairand(
            args.logs.split(","), args.user_features, args.out,
            args.min_seq_len,
        )
    print(f"wrote {args.out}: {len(d['user_ids'])} users, "
          f"{len(d['item_ids'])} events")


if __name__ == "__main__":
    _cli()
