"""The embedding cache (`dynamicemb/hybrid_storage.py`) against the JAX
package's on the CPU: the same keys, rows and gradients, made from a seed
with numpy, go to both. Table state (keys, scores, slots, counters,
values), the host tier's rows and scores and the cache's counters must
match bit for bit wherever the JAX prefetch evicts none of the batch's
keys; where it does, the port keeps them (the pinned deliberate
difference). Each JAX run is shared through a module-scoped fixture."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch.dynamicemb import batched_table as tbt
from recsys_examples_torch.dynamicemb import dynamicemb_config as tcfg
from recsys_examples_torch.dynamicemb import hashtable as tht
from recsys_examples_torch.dynamicemb import hybrid_storage as ths
from recsys_examples_torch.dynamicemb import optimizer as topt
from recsys_examples_tpu.dynamicemb import batched_table as jbt
from recsys_examples_tpu.dynamicemb import dynamicemb_config as jcfg
from recsys_examples_tpu.dynamicemb import hashtable as jht
from recsys_examples_tpu.dynamicemb import hybrid_storage as jhs
from recsys_examples_tpu.dynamicemb import optimizer as jopt


def _tables(capacity, bucket, optimizer="sgd", strategy="timestamp", rounds=16, dim=4,
            mode="debug"):
    """(port table, JAX table) of the same options."""
    def make(cfg, opt):
        return (cfg.DynamicEmbTableOptions(
            embedding_dim=dim, max_capacity=capacity, bucket_capacity=bucket,
            insert_rounds=rounds,
            score_strategy=cfg.DynamicEmbScoreStrategy(strategy),
            initializer_args=cfg.DynamicEmbInitializerArgs(
                mode=cfg.DynamicEmbInitializerMode(mode))),
            opt.SparseOptimizerArgs(optimizer=optimizer, learning_rate=0.1))
    return (tbt.DynamicEmbeddingTable(*make(tcfg, topt)),
            jbt.DynamicEmbeddingTable(*make(jcfg, jopt)))


def _host(hyb):
    """The host tier as {key: (row, score)}."""
    out = {}
    for ks, rs, ss in hyb.host.export():
        for k, r, s in zip(ks, rs, ss):
            out[int(k)] = (r.copy(), int(s))
    return out


def _table_np(t):
    """keys, scores, values, opt and counters of a table state, as numpy."""
    f = lambda x: None if x is None else np.asarray(x)
    return {k: f(getattr(t, k)) for k in ("keys", "scores", "values", "opt", "inserted",
                                          "evicted", "overflowed")}


# values after a sparse optimizer step: fp32 arithmetic that XLA may fuse
# (test_torch_dynamicemb.py's tolerance); everything else bit for bit
VAL_TOL = dict(rtol=1e-5, atol=1e-7)


def _assert_same(port_hyb, port_state, jax_hyb, jax_state, trained=False):
    """Table, step, counters and host tier equal JAX's bit for bit; with
    `trained`, the value rows (on the card and in the host tier) to
    VAL_TOL."""
    got, want = _table_np(port_state.table), _table_np(jax_state.table)
    for k in want:
        if want[k] is None:
            assert got[k] is None
        elif trained and k in ("values", "opt"):
            np.testing.assert_allclose(got[k], want[k], **VAL_TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(port_state.step), np.asarray(jax_state.step))
    assert port_hyb.stats == jax_hyb.stats
    assert port_hyb.hit_rate() == jax_hyb.hit_rate()
    hp, hj = _host(port_hyb), _host(jax_hyb)
    assert hp.keys() == hj.keys()
    for k in hj:
        if trained:
            np.testing.assert_allclose(hp[k][0], hj[k][0], **VAL_TOL)
        else:
            np.testing.assert_array_equal(hp[k][0], hj[k][0])
        assert hp[k][1] == hj[k][1]


def _run_flush_case(pkg):
    """JAX's `test_hybrid_prefetch_and_flush`: train keys 0-15 into a
    16-row cache, flush it, flood it with keys 100-115, prefetch keys 0-3
    back from the host tier."""
    t, j = _tables(16, 8)
    tbl, hs, arr = (t, ths, lambda x: torch.from_numpy(x)) if pkg == "torch" else (
        j, jhs, jnp.asarray)
    hyb = hs.HybridDynamicEmbedding(tbl, **({"device": "cpu"} if pkg == "torch" else {}))
    state = hyb.init_state()
    state, _, _ = tbl.forward_train(state, arr(np.arange(16, dtype=np.int64)))
    hyb.flush_all(state)
    flushed = len(hyb.host)
    state, _, _ = tbl.forward_train(state, arr(np.arange(100, 116, dtype=np.int64)))
    state = hyb.prefetch(state, np.arange(4, dtype=np.int64))
    ev = np.asarray(tbl.forward_eval(state, arr(np.arange(4, dtype=np.int64))))
    return hyb, state, flushed, ev


@pytest.fixture(scope="module")
def flush_jax():
    return _run_flush_case("jax")


def test_prefetch_and_flush_match_jax(flush_jax):
    hyb, state, flushed, ev = _run_flush_case("torch")
    jhyb, jstate, jflushed, jev = flush_jax
    assert flushed == jflushed >= 14
    np.testing.assert_array_equal(ev, jev)
    np.testing.assert_allclose(ev, np.tile((np.arange(4) / 100000.0)[:, None], (1, 4)),
                               rtol=1e-5)
    _assert_same(hyb, state, jhyb, jstate)


def _run_insert_failure(pkg):
    """JAX's `test_prefetch_insert_failure_preserves_host_rows`: 64 host
    rows prefetched into 16 cells with one claim round."""
    t, j = _tables(16, 8, rounds=1)
    tbl, hs = (t, ths) if pkg == "torch" else (j, jhs)
    hyb = hs.HybridDynamicEmbedding(tbl, **({"device": "cpu"} if pkg == "torch" else {}))
    keys = np.arange(1, 65, dtype=np.int64)
    hyb.host.put_batch(keys, np.tile(keys[:, None].astype(np.float32), (1, tbl.value_dim)),
                       np.ones(len(keys), np.int64))
    state = hyb.prefetch(hyb.init_state(), keys)
    return hyb, state


def test_prefetch_insert_failure_preserves_host_rows():
    hyb, state = _run_insert_failure("torch")
    jhyb, jstate = _run_insert_failure("jax")
    assert hyb.stats["insert_failures"] > 0
    _assert_same(hyb, state, jhyb, jstate)
    keys = np.arange(1, 65, dtype=np.int64)
    _, found = tht.lookup(state.table, torch.from_numpy(keys))
    vals, host_found = hyb.host.get_batch(keys[~found.numpy()])
    assert host_found.all()
    np.testing.assert_array_equal(vals[:, 0], keys[~found.numpy()].astype(np.float32))


SELF_EVICT_BATCH = np.concatenate([np.arange(4), np.arange(16, 28)]).astype(np.int64)


def _run_self_eviction(pkg):
    """A 16-row cache (two buckets of 8) trained on keys 0-15, then a batch
    of keys 0-3 and 12 new ones prefetched: what the device holds of the
    batch afterwards."""
    t, j = _tables(16, 8)
    tbl, hs, arr, look = (t, ths, lambda x: torch.from_numpy(x), tht.lookup) \
        if pkg == "torch" else (j, jhs, jnp.asarray, jht.lookup)
    hyb = hs.HybridDynamicEmbedding(tbl, **({"device": "cpu"} if pkg == "torch" else {}))
    state = hyb.prefetch(hyb.init_state(), np.arange(16, dtype=np.int64))
    state, _, _ = tbl.forward_train(state, arr(np.arange(16, dtype=np.int64)))
    state = hyb.prefetch(state, SELF_EVICT_BATCH)
    _, found = look(state.table, arr(SELF_EVICT_BATCH))
    return np.asarray(found).astype(int), hyb.stats


def test_prefetch_keeps_the_batchs_own_keys():
    """The deliberate difference: the JAX prefetch evicts keys 0-3 (its
    hits) to make room for the misses and the train step would miss them;
    the port's insert takes other victims, and every batch key is on the
    device."""
    jfound, jstats = _run_self_eviction("jax")
    found, stats = _run_self_eviction("torch")
    np.testing.assert_array_equal(jfound, [0] * 4 + [1] * 12)
    np.testing.assert_array_equal(found, [1] * 16)
    assert stats["evict_flushes"] >= jstats["evict_flushes"] > 0


STEPS, DIM, WIDTH = 8, 8, 13
EMPTY = tcfg.EMPTY_KEY


def _batch(rng, step, prev, gone):
    """Step `step`'s keys: 4 of the last batch's (the hits: the most recent
    scores on the card), 3 keys the card no longer holds (onboarded from the
    host tier) and 6 fresh ones."""
    keep = rng.choice(prev, min(4, len(prev)), replace=False) if len(prev) else prev
    back = rng.choice(gone, min(3, len(gone)), replace=False) if len(gone) else gone
    keys = np.unique(np.concatenate([keep, back, np.arange(6) + 6 * step])).astype(np.int64)
    return np.concatenate([keys, np.full(WIDTH - len(keys), EMPTY, np.int64)])


def _run_steps(pkg, strategy, optimizer, batches=None):
    """Eight steps of prefetch, train forward and backward on a 32-row cache
    (one bucket of 32), batches of up to 13 keys padded with EMPTY_KEY: the
    later steps evict and onboard.
    The JAX run draws the batches, taking the returning keys among those
    its card no longer holds, so that its prefetch never meets a stale
    hit; the port replays them. Returns the cache, the state, each step's
    slots, the batch keys missing on the card after their prefetch, and the
    batches."""
    rng, grad_rng = np.random.default_rng(3), np.random.default_rng(4)
    t, j = _tables(32, 32, optimizer=optimizer, strategy=strategy, dim=DIM, mode="uniform")
    tbl, hs, arr, look = (t, ths, lambda x: torch.from_numpy(x), tht.lookup) \
        if pkg == "torch" else (j, jhs, jnp.asarray, jht.lookup)
    hyb = hs.HybridDynamicEmbedding(tbl, **({"device": "cpu"} if pkg == "torch" else {}))
    fwd, bwd = (tbl.forward_train, tbl.backward) if pkg == "torch" else (
        jax.jit(tbl.forward_train), jax.jit(tbl.backward))
    state = hyb.init_state()
    slots_all, missing, drawn = [], 0, []
    seen = np.zeros(0, np.int64)
    pad = lambda k: np.concatenate([k, np.full(STEPS * WIDTH - len(k), EMPTY, np.int64)])
    for i in range(STEPS):
        if batches is None:   # one lookup width, one compile
            on = np.asarray(look(state.table, arr(pad(seen)))[1])[:len(seen)]
            prev = drawn[-1][drawn[-1] != EMPTY] if drawn else seen
            keys = _batch(rng, i, prev, seen[~on])
        else:
            keys = batches[i]
        drawn.append(keys)
        live = keys[keys != EMPTY]
        seen = np.union1d(seen, live)
        state = hyb.prefetch(state, keys)
        missing += int((~np.asarray(look(state.table, arr(keys))[1]))[keys != EMPTY].sum())
        state, slots, _ = fwd(state, arr(keys))
        slots_all.append(np.asarray(slots))
        g = grad_rng.standard_normal((WIDTH, DIM)).astype(np.float32)
        state = bwd(state, slots, arr(g * (keys != EMPTY)[:, None]))
    return hyb, state, slots_all, missing, drawn


@pytest.fixture(scope="module")
def steps_jax():
    return {(s, o): _run_steps("jax", s, o)
            for s, o in (("timestamp", "sgd"), ("lfu", "rowwise_adagrad"))}


@pytest.mark.parametrize("strategy, optimizer", [("timestamp", "sgd"), ("lfu", "rowwise_adagrad")])
def test_table_steps_match_jax(steps_jax, strategy, optimizer):
    """LRU (timestamp scores) and LFU, with the optimizer rows in the host
    tier (rowwise adagrad): keys, scores, slots, counters and the host
    tier's keys and scores equal JAX's bit for bit after eight steps of
    prefetch, train forward and backward; the trained value rows to
    VAL_TOL."""
    jhyb, jstate, jslots, jmissing, batches = steps_jax[(strategy, optimizer)]
    hyb, state, slots, missing, _ = _run_steps("torch", strategy, optimizer, batches)
    assert jmissing == missing == 0     # JAX evicted no batch key: the case holds
    assert hyb.stats["evict_flushes"] > 0 and hyb.stats["host_onboards"] > 0
    for a, b in zip(slots, jslots):
        np.testing.assert_array_equal(a, b)
    _assert_same(hyb, state, jhyb, jstate, trained=True)


def test_tiered_host_tier_gives_the_same_table(tmp_path):
    """The cache over a RAM tier of 8 rows and an SSD arena gives the table
    the plain host tier gives: the rows come back through spill and promote
    unchanged. (The JAX package's `host_storage or HostStorage(...)` drops a
    tiered store that is still empty, so the JAX side has no such run.)"""
    from recsys_examples_torch.dynamicemb.tiered_storage import TieredHostStorage

    runs = []
    for tiered in (False, True):
        tbl, _ = _tables(64, 8, dim=8, mode="uniform")
        host = TieredHostStorage(tbl.value_dim, ram_capacity=8,
                                 ssd_path=str(tmp_path / "emb.bin"),
                                 ssd_capacity=512) if tiered else None
        hyb = ths.HybridDynamicEmbedding(tbl, host_storage=host, device="cpu")
        state = hyb.init_state()
        for wave in range(4):
            keys = np.arange(wave * 64, wave * 64 + 64, dtype=np.int64)
            state = hyb.prefetch(state, keys)
            state, _, _ = tbl.forward_train(state, torch.from_numpy(keys))
        state = hyb.prefetch(state, np.arange(16, dtype=np.int64))
        runs.append((hyb, state))
    (plain, ps), (tiered, ts) = runs
    assert tiered.host.stats["ssd_spills"] > 0 and tiered.host.stats["ssd_hits"] > 0
    for k in ("keys", "scores", "values"):
        assert torch.equal(getattr(ps.table, k), getattr(ts.table, k))
    assert plain.stats == tiered.stats
