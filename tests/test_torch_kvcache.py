"""Paged KV cache: the port's directory, page and LRU state against the JAX
package, bit for bit, over a sequence of allocate / append / lookup / evict
calls under pool pressure."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch import convert
from recsys_examples_torch.inference import kvcache as tk
from recsys_examples_tpu.inference import kvcache as jk

L, H, DH, PG = 2, 2, 8, 4


def _cfgs(num_pages, max_users, maxp):
    kw = dict(num_layers=L, num_heads=H, head_dim=DH, page_size=PG,
              num_pages=num_pages, max_users=max_users,
              max_pages_per_user=maxp)
    return (jk.KVCacheConfig(**kw, dtype=jnp.float32),
            tk.KVCacheConfig(**kw, dtype=torch.float32))


def _assert_same(jst, tst, where):
    got = convert.kvcache_to_numpy(tst)
    for f in convert.KVCACHE_FIELDS:
        want = np.asarray(getattr(jst, f))
        assert got[f].dtype == want.dtype, (where, f, got[f].dtype, want.dtype)
        np.testing.assert_array_equal(got[f], want, err_msg=f"{where}: {f}")


@pytest.mark.parametrize("pool", [(12, 4, 4), (20, 6, 3)])
def test_state_sequence_bit_exact(pool):
    jcfg, tcfg = _cfgs(*pool)
    jst = jk.create_kvcache(jcfg)
    tst = tk.create_kvcache(tcfg, device="cpu")
    _assert_same(jst, tst, "create")
    rng = np.random.default_rng(sum(pool))
    lru_evictions = 0
    for step in range(14):
        B = 3
        # users from a small pool (repeats hit the cache; a user may appear
        # twice in one batch), -1 marks an inactive row
        users = rng.integers(1, 9, size=B).astype(np.int64)
        users[rng.random(B) < 0.15] = -1
        total = rng.integers(0, PG * pool[2] + 3, size=B).astype(np.int32)

        js, jc = jk.lookup_kvcache(jst, jnp.asarray(users))
        ts, tc = tk.lookup_kvcache(tst, torch.from_numpy(users))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))

        before = set(np.asarray(jst.user_ids).tolist()) - {-1}
        jst, jslots = jk.allocate_kvcache(
            jst, jcfg, jnp.asarray(users), jnp.asarray(total))
        tst, tslots = tk.allocate_kvcache(
            tst, tcfg, torch.from_numpy(users), torch.from_numpy(total))
        np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
        _assert_same(jst, tst, f"allocate {step}")
        lru_evictions += len(before - set(tst.user_ids.tolist()))

        S = 6
        k = rng.standard_normal((L, B, S, H, DH)).astype(np.float32)
        v = rng.standard_normal((L, B, S, H, DH)).astype(np.float32)
        new = np.clip(total - np.asarray(jc), 0, S).astype(np.int32)
        jst = jk.append_kvcache(jst, jcfg, jslots, jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(new))
        tst = tk.append_kvcache(tst, tcfg, tslots, torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(new))
        _assert_same(jst, tst, f"append {step}")

        jg = jk.gather_kvcache(jst, jcfg, jslots, 10)
        tg = tk.gather_kvcache(tst, tcfg, tslots, 10)
        for a, b in zip(tg, jg):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

        if step % 4 == 3:
            gone = rng.integers(1, 9, size=2).astype(np.int64)
            jst = jk.evict_users(jst, jnp.asarray(gone))
            tst = tk.evict_users(tst, torch.from_numpy(gone))
            _assert_same(jst, tst, f"evict {step}")
    assert lru_evictions > 0     # the pool was short: LRU eviction ran
    # JAX state carried across by convert.py is the same state
    carried = convert.kvcache_state(
        {f: np.asarray(getattr(jst, f)) for f in convert.KVCACHE_FIELDS})
    _assert_same(jst, carried, "convert")
