"""The port's balanced shuffler against the JAX package's: the native KK
and LPT partitions (csrc/kk_partition.cpp, built by the port's loader and
handed to the JAX package's loader too, which looks for its own build
under csrc/), the numpy LPT twin used without the library, "best", and
`shuffle_hstu_batch`, all equal exactly."""
import dataclasses

import numpy as np
import pytest

from recsys_examples_torch.data import batch_shuffler as tbs
from recsys_examples_torch.data.hstu_batch import random_hstu_batch as t_batch
from recsys_examples_torch.utils import native as tnat
from recsys_examples_tpu.data import batch_shuffler as jbs
from recsys_examples_tpu.data.hstu_batch import random_hstu_batch as j_batch


@pytest.fixture
def both_native(monkeypatch):
    lib = tnat.kk_partition_lib()
    assert lib is not None, tnat.BUILD_ERRORS
    monkeypatch.setattr(jbs, "_NATIVE", lib)
    monkeypatch.setattr(jbs, "_NATIVE_TRIED", True)


@pytest.fixture
def neither_native(monkeypatch):
    monkeypatch.setitem(tnat._LIBS, "kk_partition", None)
    monkeypatch.setattr(jbs, "_NATIVE", None)
    monkeypatch.setattr(jbs, "_NATIVE_TRIED", True)


def _costs(seed, n):
    rng = np.random.default_rng(seed)
    return tbs.hstu_sample_cost(np.minimum(rng.zipf(1.2, n), 4096).astype(np.float64))


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype == np.int64


@pytest.mark.parametrize("method", ["kk", "lpt", "best"])
@pytest.mark.parametrize("seed,n,k", [(0, 64, 8), (1, 256, 8), (2, 30, 4), (3, 7, 3)])
def test_native_partitions_match_jax(both_native, method, seed, n, k):
    c = _costs(seed, n)
    got = tbs.karmarkar_karp(c, k, method=method)
    _assert_same(got, jbs.karmarkar_karp(c, k, method=method))
    counts = np.bincount(got[0], minlength=k)
    assert counts.max() == -(-n // k) and counts.sum() == n     # the per-part cap
    np.testing.assert_allclose(got[1].sum(), c.sum(), rtol=1e-12)


@pytest.mark.parametrize("method", ["lpt", "best"])
@pytest.mark.parametrize("seed,n,k", [(0, 64, 8), (4, 100, 6)])
def test_python_twin_matches_jax(neither_native, method, seed, n, k):
    c = _costs(seed, n)
    _assert_same(tbs.karmarkar_karp(c, k, method=method),
                 jbs.karmarkar_karp(c, k, method=method))


def test_kk_without_the_library_warns_and_runs_lpt(neither_native):
    c = _costs(5, 40)
    with pytest.warns(RuntimeWarning, match="NOT the KK algorithm"):
        got = tbs.karmarkar_karp(c, 4, method="kk")
    _assert_same(got, tbs.karmarkar_karp(c, 4, method="lpt"))


def test_balance_stats_and_permutation_match_jax(both_native):
    rng = np.random.default_rng(7)
    seqlen = np.minimum(rng.zipf(1.2, 64), 512)
    np.testing.assert_array_equal(tbs.balanced_permutation(seqlen, 8),
                                  jbs.balanced_permutation(seqlen, 8))
    got, want = tbs.balance_stats(seqlen, 8), jbs.balance_stats(seqlen, 8)
    assert got == want and got["balanced_max_over_mean"] <= got["naive_max_over_mean"]


@pytest.mark.parametrize("nc,action,ts", [(3, 8, True), (0, 0, False)])
def test_shuffle_hstu_batch_matches_jax(both_native, nc, action, ts):
    kw = dict(seed=11, batch_size=8, max_history_len=40, item_vocab=500,
              action_vocab=action, max_num_candidates=nc, num_tasks=2,
              contextual_vocabs={"user": 50})
    tb, jb = t_batch(**kw), j_batch(**kw)
    if ts:
        stamps = np.arange(tb.features["item"].capacity, dtype=np.int64) * 7
        tb = dataclasses.replace(tb, timestamps=stamps)
        jb = dataclasses.replace(jb, timestamps=stamps)
    got, want = tbs.shuffle_hstu_batch(tb, 4), jbs.shuffle_hstu_batch(jb, 4)
    assert got.features.keys() == want.features.keys()
    for n, f in want.features.items():
        for k in ("values", "lengths", "offsets"):
            g = getattr(got.features[n], k)
            assert isinstance(g, np.ndarray)
            np.testing.assert_array_equal(g, np.asarray(getattr(f, k)), err_msg=f"{n}.{k}")
    for k in ("num_candidates", "labels", "label_lengths", "timestamps"):
        w = getattr(want, k)
        if w is None:
            assert getattr(got, k) is None
        else:
            np.testing.assert_array_equal(getattr(got, k), np.asarray(w), err_msg=k)
