"""The port's SID-GR data pipeline against the JAX package's
(tests/test_sid_sequence_dataset.py's cases): the preprocessed npz from the
same interaction log (csv, tsv, jsonl; a tied timestamp, string item ids, a
row with a missing field, no time column), the mapping loader's layouts, the
RQ k-means mapping and the dataset's batches, all bit for bit; parquet
raises an ImportError that names what it would need; the preprocess CLI."""
import csv
import json

import numpy as np
import pytest
import torch

from recsys_examples_torch.data import sid_sequence_dataset as tds
from recsys_examples_tpu.data import sid_sequence_dataset as jds


def write_interactions(path, n_users=12, n_items=30, seed=0, fmt="csv", str_items=False,
                       with_time=True, missing=False):
    """An interaction log with a timestamp tie inside a user and, with
    `missing`, one row whose item is empty."""
    rng = np.random.default_rng(seed)
    rows = []
    for u in range(n_users):
        n = int(rng.integers(2, 9))
        ts = np.sort(rng.integers(0, 10_000, size=n))
        ts[-1] = ts[0] if n > 2 else ts[-1]
        for t in ts:
            item = int(rng.integers(0, n_items))
            rows.append({"user_id": u, "item_id": f"i{item}" if str_items else item,
                         "timestamp": int(t)})
    rng.shuffle(rows)
    if missing:
        rows[3]["item_id"] = None
    cols = ["user_id", "item_id"] + (["timestamp"] if with_time else [])
    if fmt == "jsonl":
        with open(path, "w") as f:
            for r in rows:
                f.write(json.dumps({c: r[c] for c in cols}) + "\n")
        return
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t" if fmt == "tsv" else ",")
        w.writerow(cols)
        for r in rows:
            w.writerow(["" if r[c] is None else r[c] for c in cols])


def npz_equal(a, b):
    da, db = np.load(a), np.load(b)
    assert set(da.files) == set(db.files)
    for k in da.files:
        assert da[k].dtype == db[k].dtype, k
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


@pytest.mark.parametrize("fmt,kw", [
    ("csv", dict(missing=True)),
    ("tsv", dict(str_items=True)),
    ("jsonl", dict(str_items=True, missing=True)),
    ("csv", dict(with_time=False)),
])
def test_preprocess_matches_jax(tmp_path, fmt, kw):
    raw = tmp_path / f"inter.{fmt}"
    write_interactions(str(raw), seed=3, fmt=fmt, **kw)
    for args in (dict(), dict(min_seq_len=3, max_seq_len=4)):
        want = jds.preprocess_interactions(str(raw), str(tmp_path / "j.npz"), **args)
        got = tds.preprocess_interactions(str(raw), str(tmp_path / "t.npz"), **args)
        assert {k: v for k, v in got.items() if k != "out_path"} == \
            {k: v for k, v in want.items() if k != "out_path"}
        npz_equal(tmp_path / "t.npz", tmp_path / "j.npz")
        for a, b in zip(tds.load_sequences(str(tmp_path / "t.npz")),
                        jds.load_sequences(str(tmp_path / "j.npz"))):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tds.preprocess_interactions(str(raw), str(tmp_path / "x.npz"), min_seq_len=99)


def test_load_sid_mapping_layouts(tmp_path):
    H, N = 3, 17
    m = np.arange(H * N, dtype=np.int32).reshape(N, H) % 7
    np.save(tmp_path / "a.npy", m)
    np.save(tmp_path / "b.npy", m.T)                       # layout [H, num_items]
    np.savez(tmp_path / "c.npz", mapping=m)
    torch.save(torch.from_numpy(m.T.copy()), tmp_path / "d.pt")
    for name in ("a.npy", "b.npy", "c.npz", "d.pt"):
        got = tds.load_sid_mapping(str(tmp_path / name), H)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, m)
        np.testing.assert_array_equal(got, jds.load_sid_mapping(str(tmp_path / name), H))
    with pytest.raises(ValueError):
        tds.load_sid_mapping(str(tmp_path / "a.npy"), 5)
    np.save(tmp_path / "e.npy", m.reshape(-1))
    with pytest.raises(ValueError):
        tds.load_sid_mapping(str(tmp_path / "e.npy"), H)


@pytest.mark.parametrize("n,sizes,unique", [
    (64, [2, 8, 8], True),      # room for every tuple
    (40, [8, 8, 8], True),
    (50, [2, 2, 4], True),      # collisions moved across levels, 16 < 50: kept
    (30, [4, 4], False),
])
def test_rq_mapping_matches_jax(n, sizes, unique):
    rng = np.random.default_rng(n)
    emb = rng.normal(size=(n, 6))
    got = tds.build_rq_sid_mapping(emb, sizes, iters=6, seed=1, make_unique=unique)
    want = jds.build_rq_sid_mapping(emb, sizes, iters=6, seed=1, make_unique=unique)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if unique and n <= np.prod(sizes):
        assert len({tuple(r) for r in got}) == n


def _batches(mod, *a, **kw):
    return [(np.asarray(b.history_sids), np.asarray(b.history_lengths),
             np.asarray(b.history_offsets), np.asarray(b.candidate_sids),
             b.batch_size, b.num_hierarchies, b.max_history_tokens)
            for b in mod.SIDSequenceDataset(*a, **kw)]


@pytest.mark.parametrize("kw", [
    dict(split="train", shuffle=True, seed=4),
    dict(split="train", shuffle=False, drop_last=True),
    dict(split="eval", shuffle=True),           # eval never shuffles
])
def test_dataset_batches_match_jax(tmp_path, kw):
    """Leave-one-out splits, history truncation to the last items, padding
    and the shuffled order, batch for batch."""
    raw, seq = tmp_path / "inter.csv", tmp_path / "seq.npz"
    write_interactions(str(raw), n_users=24, n_items=40, seed=3)
    tds.preprocess_interactions(str(raw), str(seq))
    flat, offs, _, n_items = tds.load_sequences(str(seq))
    mapping = tds.build_rq_sid_mapping(np.random.default_rng(0).normal(size=(n_items, 6)),
                                       [8, 8, 8], iters=3)
    args = (flat, offs, mapping)
    kw = dict(batch_size=5, max_history_items=3, **kw)
    got, want = _batches(tds, *args, **kw), _batches(jds, *args, **kw)
    assert len(got) == len(want) == len(tds.SIDSequenceDataset(*args, **kw)) > 1
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert got[0][0].dtype == np.int32


def test_dataset_leave_one_out_and_bad_ids():
    flat = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9], np.int64)
    offs = np.array([0, 4, 7, 10], np.int64)      # 0123 | 456 | 789
    mapping = np.stack([np.arange(10, dtype=np.int32), np.arange(10, dtype=np.int32) * 2], 1)
    ev = list(tds.SIDSequenceDataset(flat, offs, mapping, batch_size=3,
                                     max_history_items=8, split="eval", shuffle=False))[0]
    np.testing.assert_array_equal(ev.candidate_sids, mapping[[3, 6, 9]])
    np.testing.assert_array_equal(ev.history_lengths, [6, 4, 4])
    tr = list(tds.SIDSequenceDataset(flat, offs, mapping, batch_size=3,
                                     max_history_items=8, split="train", shuffle=False))[0]
    np.testing.assert_array_equal(tr.candidate_sids, mapping[[2, 5, 8]])
    b = tr.to("cpu")
    assert b.history_sids.dtype == torch.int64
    with pytest.raises(ValueError, match="outside"):
        tds.SIDSequenceDataset(flat, offs, mapping[:5], batch_size=1, max_history_items=2)


def test_parquet_raises_import_error(tmp_path):
    p = tmp_path / "events.parquet"
    p.write_bytes(b"PAR1")
    for fn in (lambda: tds.preprocess_interactions(str(p), str(tmp_path / "o.npz")),
               lambda: tds.load_sequences(str(p))):
        with pytest.raises(ImportError, match="pandas and pyarrow"):
            fn()


def test_preprocess_cli(tmp_path, capsys):
    raw = tmp_path / "inter.tsv"
    write_interactions(str(raw), fmt="tsv")
    stats = tds.main([str(raw), str(tmp_path / "t.npz"), "--max-seq-len", "5"])
    want = jds.preprocess_interactions(str(raw), str(tmp_path / "j.npz"), max_seq_len=5)
    assert stats["num_users"] == want["num_users"] and "num_items" in capsys.readouterr().out
    npz_equal(tmp_path / "t.npz", tmp_path / "j.npz")
