"""`HostKVStorage` (the host tier of the paged KV cache) against the JAX
package's on the CPU: the same users and KV, made from a seed with numpy,
are appended, offloaded, evicted and onboarded on both sides. The cache
state (pages, directory, LRU stamps) and the gathered KV must match bit for
bit, and so must the host tier's lengths and its spill and promote counters.
Mirrors tests/test_kvcache.py::test_explicit_evict_and_host_offload (in
bf16 pages) and tests/test_tiered_storage.py::test_host_kv_storage_ssd_spill
(fp32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch import convert
from recsys_examples_torch.inference import kvcache as tk
from recsys_examples_tpu.inference import kvcache as jk

L, H, DH, PG = 2, 2, 8, 4

# the JAX cache ops, jitted once (the host tier calls them by module name)
_JITTED = {"allocate_kvcache": jax.jit(jk.allocate_kvcache, static_argnums=1),
           "append_kvcache": jax.jit(jk.append_kvcache, static_argnums=1),
           "gather_kvcache": jax.jit(jk.gather_kvcache, static_argnums=(1, 3)),
           "lookup_kvcache": jax.jit(jk.lookup_kvcache),
           "evict_users": jax.jit(jk.evict_users)}


@pytest.fixture(autouse=True)
def jitted_jax_ops(monkeypatch):
    for name, fn in _JITTED.items():
        monkeypatch.setattr(jk, name, fn)


def _cfgs(dtype, num_pages=16, max_users=4, maxp=4):
    kw = dict(num_layers=L, num_heads=H, head_dim=DH, page_size=PG, num_pages=num_pages,
              max_users=max_users, max_pages_per_user=maxp)
    jt, tt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    return jk.KVCacheConfig(**kw, dtype=jt), tk.KVCacheConfig(**kw, dtype=tt)


def _snap(pkg, st):
    """The cache state as numpy (bf16 pages as float32), copied: the port
    writes its page pools in place."""
    out = (convert.kvcache_to_numpy(st) if pkg == "torch"
           else {f: np.asarray(getattr(st, f)) for f in convert.KVCACHE_FIELDS})
    return {f: (np.array(x, np.float32) if x.dtype.kind == "V" or str(x.dtype) == "bfloat16"
                else np.array(x)) for f, x in out.items()}


def _assert_same(want, got, where):
    for f in convert.KVCACHE_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{where}: {f}")


def _script(pkg, cfg, dtype, ssd_dir=None, ram_users=0):
    """Users 42, 7 and 9 appended (lengths 5, 3, 9; 42 then grows by 2),
    offloaded, explicitly evicted, onboarded back into the same cache (42)
    and into a fresh one (7, 9); with an SSD tier, the users beyond
    `ram_users` spill and a lookup promotes them. Returns the states at
    each step, the gathered KV of every onboarded user, and the host tier's
    lookups, size and counters."""
    rng = np.random.default_rng(5)
    m = tk if pkg == "torch" else jk
    if pkg == "torch":
        i64 = lambda x: torch.tensor(x, dtype=torch.int64)
        i32 = lambda x: torch.tensor(x, dtype=torch.int32)
        kv = lambda a: torch.from_numpy(a).to(cfg.dtype)
        ok = dict(device="cpu")
    else:
        i64 = lambda x: jnp.asarray(x, jnp.int64)
        i32 = lambda x: jnp.asarray(x, jnp.int32)
        kv = lambda a: jnp.asarray(a).astype(cfg.dtype)
        ok = {}
    host = m.HostKVStorage(cfg, ram_capacity_users=ram_users, ssd_dir=ssd_dir)
    st = m.create_kvcache(cfg, **ok)
    states, looks = [], []
    for uid, n in ((42, 5), (7, 3), (9, 9), (42, 2)):
        st, s = m.allocate_kvcache(st, cfg, i64([uid]), i32([n + (5 if uid == 42 and n == 2
                                                                    else 0)]))
        k = rng.standard_normal((L, 1, n, H, DH)).astype(np.float32)
        v = rng.standard_normal((L, 1, n, H, DH)).astype(np.float32)
        st = m.append_kvcache(st, cfg, s, kv(k), kv(v), i32([n]))
        host.offload(st, uid)
        states.append(_snap(pkg, st))
    looks.append([host.lookup(u) for u in (42, 7, 9, 5)])
    st = m.evict_users(st, i64([42]))
    states.append(_snap(pkg, st))
    st = host.onboard(st, 42)
    states.append(_snap(pkg, st))
    fresh = m.create_kvcache(cfg, **ok)
    for uid in (7, 9):
        fresh = host.onboard(fresh, uid)
    states.append(_snap(pkg, fresh))
    gathered = []
    for state, users in ((st, [42]), (fresh, [7, 9])):
        slot, cached = m.lookup_kvcache(state, i64(users))
        k, v, lens = m.gather_kvcache(state, cfg, slot, 16)
        gathered.append([np.asarray(x.float() if pkg == "torch" else x.astype(jnp.float32))
                         for x in (k, v, lens, cached)])
    looks.append([host.lookup(u) for u in (42, 7, 9)])
    return states, gathered, looks, len(host), dict(host.stats)


def test_offload_evict_onboard_matches_jax():
    """bf16 pages (the serving cache's dtype): their values widen to the
    float32 host rows exactly and come back bit for bit."""
    jcfg, tcfg = _cfgs("bf16")
    jst, jg, jl, jn, jstats = _script("jax", jcfg, "bf16")
    tst, tg, tl, tn, tstats = _script("torch", tcfg, "bf16")
    for i, (a, b) in enumerate(zip(jst, tst)):
        _assert_same(a, b, f"step {i}")
    for a, b in zip(jg, tg):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    assert tl == jl and tl[0] == [7, 3, 9, 0]
    assert (tn, tstats) == (jn, jstats) == (3, {"ssd_spills": 0, "ssd_hits": 0})
    # the onboarded KV is the KV that went out
    np.testing.assert_array_equal(tg[0][3], [7])
    np.testing.assert_array_equal(tg[1][3], [3, 9])


def test_ssd_spill_and_promote_matches_jax(tmp_path):
    """One user in RAM at a time: each offload spills the one before to the
    SSD arena, and every lookup promotes its user back."""
    jcfg, tcfg = _cfgs("fp32")
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jst, jg, jl, jn, jstats = _script("jax", jcfg, "fp32", str(tmp_path / "j"), 1)
    tst, tg, tl, tn, tstats = _script("torch", tcfg, "fp32", str(tmp_path / "t"), 1)
    for i, (a, b) in enumerate(zip(jst, tst)):
        _assert_same(a, b, f"step {i}")
    for a, b in zip(jg, tg):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    assert (tl, tn, tstats) == (jl, jn, jstats)
    assert tstats["ssd_spills"] > 0 and tstats["ssd_hits"] > 0
