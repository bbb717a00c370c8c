"""The port's file-backed data path against the JAX package's, on files the
tests write: `preprocess_movielens` (ratings.dat and ratings.csv) and
`preprocess_kuairand` give the same .npz arrays; train and eval batches on
the native packer (csrc/batch_assembler.cpp, built by the port's loader)
and on the Python loop equal JAX's array for array (the port keeps ids
int64 where JAX narrows them to int32: values are compared); the eval
candidate override scores the holdout alone; the retrieval entry's train
and holdout streams equal JAX's; `PrefetchIterator` hands over
numpy leaves only, from its worker thread."""
import itertools
import threading

import numpy as np
import pandas as pd
import pytest

from recsys_examples_torch.data import sequence_dataset as tsd
from recsys_examples_torch.training import gin_args as t_args
from recsys_examples_torch.training import pretrain_gr_ranking as t_rank
from recsys_examples_torch.utils import native as tnat
from recsys_examples_tpu.data import sequence_dataset as jsd
from recsys_examples_tpu.training import gin_args as j_args
from recsys_examples_tpu.training import pretrain_gr_ranking as j_rank
from recsys_examples_tpu.utils import native as jnat


def _ratings(seed=0, users=24):
    rng = np.random.default_rng(seed)
    rows = []
    for uid in range(1, users + 1):
        n = 3 if uid % 7 == 0 else int(rng.integers(5, 40))   # some below min_seq_len
        ts = np.sort(rng.integers(0, 500, size=n))   # ties inside a user
        for t in ts:
            rows.append((uid, int(rng.integers(1, 300)), int(rng.integers(1, 6)), int(t)))
    rng.shuffle(rows)                          # the preprocessor sorts
    return rows


@pytest.fixture(scope="module")
def ml_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ml")
    rows = _ratings()
    dat = tmp / "ratings.dat"
    dat.write_text("".join(f"{u}::{m}::{r}::{t}\n" for u, m, r, t in rows))
    csv = tmp / "ratings.csv"
    csv.write_text("userId,movieId,rating,timestamp\n"
                   + "".join(f"{u},{m},{r}.5,{t}\n" for u, m, r, t in rows))
    return tmp, dat, csv


def _assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("fmt", ["dat", "csv"])
def test_preprocess_movielens_matches_jax(ml_files, fmt):
    tmp, dat, csv = ml_files
    src = str(dat if fmt == "dat" else csv)
    got = tsd.preprocess_movielens(src, str(tmp / f"t_{fmt}.npz"))
    want = jsd.preprocess_movielens(src, str(tmp / f"j_{fmt}.npz"))
    _assert_same_arrays(got, want)
    _assert_same_arrays(dict(np.load(tmp / f"t_{fmt}.npz")), dict(np.load(tmp / f"j_{fmt}.npz")))
    assert 5 <= len(got["user_ids"]) < 24


@pytest.fixture(scope="module")
def kuairand_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kr")
    rng = np.random.default_rng(1)
    rows = []
    for uid in range(14):
        for t in range(int(rng.integers(3, 20))):
            row = {"user_id": uid, "video_id": int(rng.integers(0, 500)),
                   "time_ms": 1000 * int(rng.integers(0, 8)) + int(rng.integers(0, 3))}
            for e in jsd.KUAIRAND_EVENT_WEIGHTS:
                row[e] = int(rng.random() < 0.3)
            rows.append(row)
    df = pd.DataFrame(rows)
    logs = [tmp / "log1.csv", tmp / "log2.csv"]
    df.iloc[::2].to_csv(logs[0], index=False)
    df.iloc[1::2].to_csv(logs[1], index=False)
    uf = pd.DataFrame({
        "user_id": np.arange(13),                 # user 13 has no features
        "user_active_degree": ["high_active", "full_active", "low_active"] * 4 + ["x"],
        "follow_user_num_range": ["0", "(0,10]"] * 6 + ["0"],
        "fans_user_num_range": list(range(100, 113)),      # an integer column
        "friend_user_num_range": ["0"] * 13,
        "register_days_range": ["15-30", "31-60", "61-90", "91-180"] * 3 + ["15-30"],
    })
    ufp = tmp / "user_features.csv"
    uf.to_csv(ufp, index=False)
    return tmp, [str(p) for p in logs], str(ufp)


@pytest.mark.parametrize("with_features", [True, False])
def test_preprocess_kuairand_matches_jax(kuairand_files, with_features):
    tmp, logs, ufp = kuairand_files
    ufp = ufp if with_features else None
    got = tsd.preprocess_kuairand(logs, ufp, str(tmp / "t.npz"))
    want = jsd.preprocess_kuairand(logs, ufp, str(tmp / "j.npz"))
    _assert_same_arrays(got, want)
    assert ("ctx_fans_user_num_range" in got) == with_features


def _leaves(batch):
    out = {"batch_size": batch.batch_size, "f2m": dict(batch.feature_to_max_seqlen),
           "names": (batch.item_feature_name, batch.action_feature_name,
                     tuple(batch.contextual_feature_names), batch.max_num_candidates)}
    for n, f in batch.features.items():
        for k in ("values", "lengths", "offsets"):
            out[f"{n}.{k}"] = np.asarray(getattr(f, k))
        out[f"{n}.max_len"] = f.max_len
    for k in ("num_candidates", "labels", "label_lengths", "timestamps"):
        v = getattr(batch, k)
        out[k] = None if v is None else np.asarray(v)
    return out


def _assert_same_batches(got_batches, want_batches):
    got_batches, want_batches = list(got_batches), list(want_batches)
    assert len(got_batches) == len(want_batches) > 0
    for g, w in zip(got_batches, want_batches):
        g, w = _leaves(g), _leaves(w)
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert isinstance(g[k], np.ndarray), k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.fixture(scope="module")
def ml_npz(ml_files):
    tmp, dat, _ = ml_files
    return str(tsd.preprocess_movielens(str(dat), str(tmp / "seq.npz")) and tmp / "seq.npz")


def test_port_builds_and_uses_the_native_packer(ml_npz):
    assert tnat.batch_assembler_lib() is not None, tnat.BUILD_ERRORS
    assert tnat.kk_partition_lib() is not None, tnat.BUILD_ERRORS
    assert str(tnat.CSRC_DIR).endswith("csrc")
    before = tsd._assemble_native.calls
    ds = tsd.SequenceDataset(ml_npz, max_history_len=16, max_num_candidates=2,
                             action_vocab_size=6)
    next(ds.batches(4, train=True, shuffle=False))
    assert tsd._assemble_native.calls == before + 1


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("nc,hist,shuffle", [(2, 16, True), (1, 8, False), (0, 32, False)])
def test_movielens_batches_match_jax(ml_npz, monkeypatch, native, train, nc, hist, shuffle):
    if not native:
        monkeypatch.setitem(tnat._LIBS, "batch_assembler", None)
        monkeypatch.setattr(jnat, "_asm_lib", None)
        monkeypatch.setattr(jnat, "_asm_tried", True)
    else:
        assert jnat.batch_assembler_lib() is not None
    kw = dict(max_history_len=hist, max_num_candidates=nc, action_vocab_size=6,
              contextual_feature_names=("user",))
    tb = tsd.SequenceDataset(ml_npz, **kw).batches(4, train=train, seed=3, shuffle=shuffle)
    jb = jsd.SequenceDataset(ml_npz, **kw).batches(4, train=train, seed=3, shuffle=shuffle)
    n = 7 if train else None        # a train stream repeats: take two passes' worth
    take = (lambda it: [next(it) for _ in range(n)]) if n else list
    _assert_same_batches(take(tb), take(jb))


@pytest.mark.parametrize("train", [True, False])
def test_kuairand_batches_match_jax(kuairand_files, train):
    """action_bits labels (the Python loop) and two contextual features."""
    tmp, logs, ufp = kuairand_files
    path = str(tmp / "seq.npz")
    tsd.preprocess_kuairand(logs, ufp, path)
    kw = dict(max_history_len=8, max_num_candidates=2, num_tasks=3, action_vocab_size=256,
              label_mode="action_bits",
              contextual_feature_names=("user", "user_active_degree", "absent"))
    tb = tsd.SequenceDataset(path, **kw).batches(3, train=train, shuffle=False)
    jb = jsd.SequenceDataset(path, **kw).batches(3, train=train, shuffle=False)
    take = (lambda it: [next(it) for _ in range(5)]) if train else list
    _assert_same_batches(take(tb), take(jb))


def test_eval_candidate_override_matches_jax(ml_npz):
    """Train on a last-4 candidate window, evaluate the holdout alone: the
    entries' eval batches equal JAX's, and each eval candidate is the
    user's true last item."""
    kw = dict(dataset_name="movielens-1m", dataset_path=ml_npz, batch_size=4,
              max_history_len=16, max_num_candidates=4, eval_max_num_candidates=1,
              action_vocab_size=6)
    tds, jds = t_args.DatasetArgs(**kw), j_args.DatasetArgs(**kw)
    got = list(t_rank.eval_batches(tds, None, 0))
    _assert_same_batches(got, j_rank.eval_batches(jds, None, 0))
    _assert_same_batches(t_rank.eval_batches(tds, None, 2), j_rank.eval_batches(jds, None, 2))
    d = np.load(ml_npz)
    for j, b in enumerate(got[:2]):
        item = b.features["item"]
        assert b.max_num_candidates == 1 and (b.num_candidates == 1).all()
        for u in range(4):
            uid = 4 * j + u
            last = item.values[item.offsets[u] + item.lengths[u] - 1]
            assert last == d["item_ids"][d["offsets"][uid + 1] - 1]


def test_retrieval_entry_streams_match_jax(ml_npz):
    """The retrieval entry's file-backed streams: its train batches (the
    ranking entry's `batch_iterator`, which both packages' retrieval entries
    use) and its leave-one-out holdout batches (`_eval_batches`) equal JAX's."""
    from recsys_examples_torch.training import pretrain_gr_retrieval as t_ret
    from recsys_examples_tpu.training import pretrain_gr_retrieval as j_ret

    kw = dict(dataset_name="movielens-1m", dataset_path=ml_npz, batch_size=4,
              max_history_len=16, action_vocab_size=6)
    tds, jds = t_args.DatasetArgs(**kw), j_args.DatasetArgs(**kw)
    targs, jargs = t_args.TrainerArgs(), j_args.TrainerArgs()
    take = lambda it: list(itertools.islice(it, 4))
    _assert_same_batches(take(t_rank.batch_iterator(tds, targs)),
                         take(j_rank.batch_iterator(jds, jargs)))
    _assert_same_batches(t_ret._eval_batches(tds, targs, 0), j_ret._eval_batches(jds, jargs, 0))


def test_prefetch_iterator_hands_over_numpy_from_a_worker(ml_npz):
    ds = tsd.SequenceDataset(ml_npz, max_history_len=16, max_num_candidates=2,
                             action_vocab_size=6, contextual_feature_names=("user",))
    seen = []

    def producer():
        for b in ds.batches(4, train=False, shuffle=False):
            seen.append(threading.current_thread() is not threading.main_thread())
            yield b

    it = tsd.PrefetchIterator(producer(), depth=2)
    batches = list(it)
    it.close()
    assert len(batches) == ds.num_users // 4 and all(seen)
    for b in batches:
        for k, v in _leaves(b).items():
            if k.endswith(("values", "lengths", "offsets")) or k in ("labels", "label_lengths"):
                assert isinstance(v, np.ndarray), k
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_iterator_raises_the_producers_error_and_closes():
    def bad():
        yield 1
        raise ValueError("broken producer")

    it = tsd.PrefetchIterator(bad(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="broken producer"):
        next(it)
    endless = tsd.PrefetchIterator(iter(lambda: 0, 1), depth=2)
    assert next(endless) == 0
    endless.close(timeout=5.0)
    assert not endless._t.is_alive()
    assert list(tsd.PrefetchIterator(iter([1, 2]), depth=0)) == [1, 2]


def test_cli_writes_the_npz(ml_files, tmp_path, capsys):
    _, dat, _ = ml_files
    out = tmp_path / "cli.npz"
    tsd._cli(["--preprocess", "ml-1m", "--ratings", str(dat), "--out", str(out)])
    assert "users" in capsys.readouterr().out
    _assert_same_arrays(dict(np.load(out)), jsd.preprocess_movielens(
        str(dat), str(tmp_path / "j.npz")))
