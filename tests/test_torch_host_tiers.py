"""The host tiers against the JAX package's on the CPU: the native store
(`utils/native.py::NativeHostStore`, csrc/host_store.cpp built by each
package's own loader), the SSD arena (`SSDStore`) and RAM over SSD
(`TieredHostStorage`). The same keys, rows and scores, made from a seed
with numpy, go to both; rows, found flags, scores, the export's contents and
the spill and promote counters must match bit for bit. Mirrors
tests/test_tiered_storage.py."""
import numpy as np
import pytest

from recsys_examples_torch.dynamicemb import tiered_storage as tts
from recsys_examples_torch.utils import native as tnat
from recsys_examples_tpu.dynamicemb import tiered_storage as jts
from recsys_examples_tpu.utils import native as jnat

DIM = 8


def _rows(rng, n):
    return rng.standard_normal((n, DIM)).astype(np.float32)


def _exported(store, *a):
    """{key: (row, score)} of a store's export."""
    return {int(k): (r.copy(), int(s)) for ks, rs, ss in store.export(*a)
            for k, r, s in zip(ks, rs, ss)}


def _assert_same_export(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k][0], want[k][0])
        assert got[k][1] == want[k][1]


def test_native_store_matches_jax():
    """put (new and overwritten keys), get with misses, erase, slot reuse
    after erase, export with a score threshold and in batches."""
    rng = np.random.default_rng(0)
    t, j = tnat.NativeHostStore(DIM), jnat.NativeHostStore(DIM)
    assert j.native
    keys = rng.choice(1000, 40, replace=False).astype(np.int64)
    rows, scores = _rows(rng, 40), rng.integers(0, 9, 40)
    for s in (t, j):
        s.put(keys, rows, scores)
        s.put(keys[:5], rows[5:10], scores[5:10])     # overwrite
        s.erase(keys[10:15])
        s.put(np.asarray([5000, 5001], np.int64), rows[:2])   # into freed slots, score 0
    assert len(t) == len(j) == 37
    probe = np.concatenate([keys, [5000, 5001, 7]]).astype(np.int64)
    (tr, tf), (jr, jf) = t.get(probe), j.get(probe)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tr, jr)
    for thr in (0, 4):
        _assert_same_export(_exported(t, thr), _exported(j, thr))
    # batched export in the store's slot order
    tb = [k.tolist() for k, _, _ in t.export(0, 7)]
    jb = [k.tolist() for k, _, _ in j.export(0, 7)]
    assert tb == jb and len(tb) == 6


def test_native_store_raises_without_its_library(monkeypatch):
    """No dict fallback: a store whose library cannot be built raises."""
    monkeypatch.setitem(tnat._LIBS, "host_store", None)
    monkeypatch.setitem(tnat.BUILD_ERRORS, "host_store", "no compiler")
    with pytest.raises(RuntimeError, match="host_store"):
        tnat.NativeHostStore(DIM)


def test_ssd_store_matches_jax(tmp_path):
    """JAX's `test_ssd_store_roundtrip`: put, get, erase, a full arena."""
    rng = np.random.default_rng(1)
    t = tts.SSDStore(str(tmp_path / "t.bin"), DIM, capacity=16)
    j = jts.SSDStore(str(tmp_path / "j.bin"), DIM, capacity=16)
    keys = np.arange(10, dtype=np.int64)
    rows = _rows(rng, 30)
    more = np.arange(100, 120, dtype=np.int64)
    out = []
    for s in (t, j):
        a = s.put(keys, rows[:10], keys * 10)
        got = s.get(np.asarray([3, 99, 7], np.int64))
        s.erase(np.asarray([3], np.int64))
        b = s.put(more, rows[10:])
        out.append((a, got, b, len(s), s.get(np.arange(120, dtype=np.int64)),
                    _exported(s)))
    (ta, tg, tb, tn, tall, te), (ja, jg, jb, jn, jall, je) = out
    assert (ta, tb, tn) == (ja, jb, jn) == (10, 7, 16)
    for x, y in zip(tg + tall, jg + jall):
        np.testing.assert_array_equal(x, y)
    _assert_same_export(te, je)


@pytest.fixture(scope="module")
def tiered_runs(tmp_path_factory):
    """JAX's `test_tiered_spill_and_promote` on both packages, with random
    rows and repeated scores: puts past the RAM cap (lowest scores spill),
    gets that promote from SSD, a re-put, a pop; each step's rows, found
    flags, tier sizes and counters, and the final export."""
    d = tmp_path_factory.mktemp("tiered")
    rng = np.random.default_rng(2)
    keys = rng.choice(500, 30, replace=False).astype(np.int64)
    rows, scores = _rows(rng, 30), rng.integers(0, 5, 30)
    probes = [np.asarray(keys[[0, 1, 29]]), np.concatenate([keys[5:12], [999]]),
              keys[::3]]
    out = {}
    for name, mod in (("torch", tts), ("jax", jts)):
        s = mod.TieredHostStorage(DIM, ram_capacity=6, ssd_path=str(d / f"{name}.bin"),
                                  ssd_capacity=64)
        steps = []
        s.put_batch(keys[:20], rows[:20], scores[:20])
        steps.append((s.ram_len, s.ssd_len))
        for p in probes:
            steps.append(s.get_batch(p.astype(np.int64)) + (s.ram_len, s.ssd_len))
        s.put_batch(keys[15:], rows[15:] * 2, scores[15:] + 1)
        s.pop(int(keys[2]))
        steps.append((s.ram_len, s.ssd_len, dict(s.stats)))
        out[name] = (steps, _exported(s), _exported(s, 3))
    return out


def test_tiered_storage_matches_jax(tiered_runs):
    (ts, te, te3), (js, je, je3) = tiered_runs["torch"], tiered_runs["jax"]
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y
    assert ts[-1][2]["ssd_spills"] > 0 and ts[-1][2]["ssd_hits"] > 0
    _assert_same_export(te, je)
    _assert_same_export(te3, je3)


def test_tiered_erase_drops_both_tiers(tmp_path):
    """The port's `erase` (the embedding cache's prefetch drops the rows it
    moved onto the card) removes keys from RAM and from SSD."""
    s = tts.TieredHostStorage(DIM, ram_capacity=2, ssd_path=str(tmp_path / "a.bin"),
                              ssd_capacity=16)
    keys = np.arange(6, dtype=np.int64)
    s.put_batch(keys, _rows(np.random.default_rng(3), 6), keys)
    assert s.ram_len == 2 and s.ssd_len == 4
    s.erase(np.asarray([0, 5], np.int64))      # one on SSD, one in RAM
    assert len(s) == 4
    _, found = s.get_batch(keys)
    np.testing.assert_array_equal(found, [False, True, True, True, True, False])
