"""The port's dynamic embedding tables against the JAX package's, on the
CPU: the same numpy-seeded keys, scores and gradients go through both. Keys,
scores, slots and counters must be equal bit for bit; table values and
optimizer state to rtol 1e-5 (`mean`, `sqrt` and `pow` may differ from XLA's
by an ulp).

One case is pinned here: a key that `insert_and_evict` stores and evicts
again within one call (scores that tie) keeps a stale slot in both packages;
in the JAX package two lanes then write one value row in an order XLA leaves
undefined, in the port only the cell's final owner writes it. `_stale` finds
such lanes, and `_resync` takes the port's rows where the JAX rows are
undefined."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch.dynamicemb import batched_table as tbt
from recsys_examples_torch.dynamicemb import dynamicemb_config as tcfg
from recsys_examples_torch.dynamicemb import hashtable as tht
from recsys_examples_torch.dynamicemb import optimizer as topt
from recsys_examples_torch.dynamicemb.initializer import initialize_embeddings as t_init
from recsys_examples_torch.dynamicemb.sharded_collection import (
    ShardedDynamicEmbedding as TSharded,
)
from recsys_examples_torch.dynamicemb.unique_op import (
    segmented_unique as t_unique,
    table_offsets_from_unique as t_offsets,
)
from recsys_examples_torch import convert
from recsys_examples_tpu.dynamicemb import batched_table as jbt
from recsys_examples_tpu.dynamicemb import dynamicemb_config as jcfg
from recsys_examples_tpu.dynamicemb import hashtable as jht
from recsys_examples_tpu.dynamicemb import optimizer as jopt
from recsys_examples_tpu.dynamicemb.initializer import initialize_embeddings as j_init
from recsys_examples_tpu.dynamicemb.sharded_collection import (
    ShardedDynamicEmbedding as JSharded,
)
from recsys_examples_tpu.dynamicemb.unique_op import (
    segmented_unique as j_unique,
    table_offsets_from_unique as j_offsets,
)

EMPTY = tcfg.EMPTY_KEY
VAL_TOL = dict(rtol=1e-5, atol=1e-7)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=msg)


def _assert_table_equal(t: tht.HashTableState, j: jht.HashTableState, msg=""):
    for f in ("keys", "scores", "inserted", "evicted", "overflowed"):
        _eq(getattr(t, f), getattr(j, f), f"{msg} {f}")
    np.testing.assert_allclose(t.values.numpy(), np.asarray(j.values), **VAL_TOL,
                               err_msg=f"{msg} values")
    assert (t.opt is None) == (j.opt is None)
    if t.opt is not None:
        np.testing.assert_allclose(t.opt.numpy(), np.asarray(j.opt), **VAL_TOL,
                                   err_msg=f"{msg} opt")


def test_empty_key_and_config_match_jax():
    assert EMPTY == int(jcfg.EMPTY_KEY)
    for w in (1, 3, 16):
        for cap, bc in ((1 << 12, 128), (1000, 128), (5, 8)):
            a = tcfg.DynamicEmbTableOptions(8, max_capacity=cap, bucket_capacity=bc)
            b = jcfg.DynamicEmbTableOptions(8, max_capacity=cap, bucket_capacity=bc)
            assert a.sharded_capacity(w) == b.sharded_capacity(w)
    assert tcfg.DynamicEmbTableOptions(8).insert_rounds \
        == jcfg.DynamicEmbTableOptions(8).insert_rounds == 16
    for name in ("DynamicEmbScoreStrategy", "DynamicEmbEvictStrategy",
                 "DynamicEmbInitializerMode"):
        assert {m.name: m.value for m in getattr(tcfg, name)} \
            == {m.name: m.value for m in getattr(jcfg, name)}


def test_masked_set_drops_lanes_like_xla():
    """`masked_set_` against XLA's `.at[idx].set(vals, mode="drop")` with the
    dropped lanes sent out of range: rows, scalars, no kept lane, no lane."""
    from recsys_examples_torch.utils.scatter import masked_set_

    rng = np.random.default_rng(0)
    target = rng.standard_normal((9, 3)).astype(np.float32)
    idx = np.array([4, 7, 4, 0, 8, 2], np.int64)        # lanes 0 and 2 share a row
    keep = np.array([True, False, False, True, True, False])
    vals = rng.standard_normal((6, 3)).astype(np.float32)
    want = jnp.asarray(target).at[np.where(keep, idx, 100 + np.arange(6))].set(
        jnp.asarray(vals), mode="drop")
    got = masked_set_(_t(target), _t(idx), _t(vals), _t(keep))
    _eq(got, want)
    flat = masked_set_(_t(target[:, 0]), _t(idx), 7, _t(keep))      # a scalar, 1-D
    _eq(flat, jnp.asarray(target[:, 0]).at[idx[keep]].set(7.0))
    none = masked_set_(_t(target), _t(idx), _t(vals), _t(np.zeros(6, bool)))
    _eq(none, target)
    empty = masked_set_(_t(target), _t(idx[:0]), _t(vals[:0]), _t(keep[:0]))
    _eq(empty, target)


# ------------------------------------------------------------ unique
@pytest.mark.parametrize("case", ["single", "padded", "tables", "all_pad", "one"])
def test_segmented_unique_matches_jax(case):
    rng = np.random.default_rng(1)
    n, tids, nt = 200, None, 1
    keys = rng.integers(-50, 50, size=n).astype(np.int64)
    if case in ("padded", "tables"):
        keys[rng.random(n) < 0.2] = EMPTY
    if case == "tables":
        nt = 3
        tids = rng.integers(0, nt, size=n).astype(np.int32)
    if case == "all_pad":
        keys[:] = EMPTY
    if case == "one":
        keys = keys[:1]
    got = t_unique(_t(keys), None if tids is None else _t(tids), nt, return_counts=True)
    want = j_unique(jnp.asarray(keys), None if tids is None else jnp.asarray(tids), nt,
                    return_counts=True)
    for name, g, w in zip(("unique_keys", "reverse", "tids", "num_unique", "counts"),
                          got, want):
        _eq(g, w, name)
    assert len(t_unique(_t(keys))) == 4
    _eq(t_offsets(got[2], got[3], nt), j_offsets(want[2], want[3], nt))
    # the contract: reverse maps every input to its unique slot
    uk, rev = got[0].numpy(), got[1].numpy()
    np.testing.assert_array_equal(uk[rev], keys)


# ------------------------------------------------------------ initializer
@pytest.mark.parametrize("mode", ["UNIFORM", "CONSTANT", "DEBUG", "NORMAL",
                                  "TRUNCATED_NORMAL"])
@pytest.mark.parametrize("bounds", [(0.0, 0.0), (-0.3, 0.7)])
def test_initialize_embeddings_matches_jax(mode, bounds):
    rng = np.random.default_rng(2)
    keys = np.concatenate([rng.integers(-2 ** 62, 2 ** 62, size=500),
                           np.array([0, 1, -1, EMPTY, 2 ** 63 - 1, 49_999_999])]
                          ).astype(np.int64)
    kw = dict(mean=0.1, std_dev=0.5, lower=bounds[0], upper=bounds[1], value=0.25)
    ta = tcfg.DynamicEmbInitializerArgs(mode=tcfg.DynamicEmbInitializerMode[mode], **kw)
    ja = jcfg.DynamicEmbInitializerArgs(mode=jcfg.DynamicEmbInitializerMode[mode], **kw)
    for dim in (8, 128):
        got = t_init(_t(keys), dim, ta).numpy()
        want = np.asarray(j_init(jnp.asarray(keys), dim, ja))
        assert got.dtype == want.dtype == np.float32
        if mode in ("NORMAL", "TRUNCATED_NORMAL"):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ hash table
def _both_tables(cap, bc, dim, opt_dim=0):
    return (tht.create_table_state(cap, bc, dim, opt_dim=opt_dim, device="cpu"),
            jht.create_table_state(cap, bc, dim, opt_dim=opt_dim))


def _stale(j: jht.HashTableState, keys, slots):
    """Lanes whose JAX slot no longer holds their key: stored, then evicted
    again within the same call."""
    keys, slots = np.asarray(keys), np.asarray(slots)
    cell = np.asarray(j.keys).reshape(-1)[np.maximum(slots, 0)]
    return (slots >= 0) & (cell != keys)


def _resync(j: jht.HashTableState, t: tht.HashTableState, rows):
    """The JAX table with the port's values (and opt) in `rows`."""
    if len(rows) == 0:
        return j
    rows = np.unique(rows)
    j = j.replace(values=j.values.at[rows].set(jnp.asarray(t.values[rows].numpy())))
    if j.opt is not None:
        j = j.replace(opt=j.opt.at[rows].set(jnp.asarray(t.opt[rows].numpy())))
    return j


def _insert_both(t, j, keys, scores, values, opt_rows=None, **kw):
    t, ts, te = tht.insert_and_evict(
        t, _t(keys), _t(scores), None if values is None else _t(values),
        None if opt_rows is None else _t(opt_rows), **kw)
    j, js, je = jht.insert_and_evict(
        j, jnp.asarray(keys), jnp.asarray(scores),
        None if values is None else jnp.asarray(values),
        None if opt_rows is None else jnp.asarray(opt_rows), **kw)
    stale = _stale(j, keys, js)
    _eq(ts, js, "slots")
    _eq(~tht.owns_slot(t, _t(keys), ts).numpy() & (ts.numpy() >= 0), stale, "stale lanes")
    _eq(te, je, "evicted mask")
    j = _resync(j, t, np.asarray(js)[stale])
    _assert_table_equal(t, j)
    return t, j, int(stale.sum())


def _lookup_both(t, j, keys):
    ts, tf = tht.lookup(t, _t(keys))
    js, jf = jht.lookup(j, jnp.asarray(keys))
    _eq(ts, js, "lookup slots")
    _eq(tf, jf, "lookup found")
    return ts.numpy(), tf.numpy()


@pytest.mark.parametrize("rounds", [16, 1])
def test_insert_lookup_evict_match_jax(rounds):
    """An empty table, then half full, then overfull (evictions; with
    rounds=1 same-cell losers overflow). Scores tie within a batch, as they
    do under the STEP strategy."""
    rng = np.random.default_rng(3)
    cap, bc, dim = 256, 8, 4
    t, j = _both_tables(cap, bc, dim, opt_dim=1)
    pool = rng.permutation(5000).astype(np.int64) + 1
    for step, n in enumerate((0, 100, 60, 300, 300, 200)):
        fresh = pool[step * 300: step * 300 + n]
        old = rng.choice(pool[: max(step, 1) * 300], size=n // 3)
        keys = np.unique(np.concatenate([fresh, old]))
        rng.shuffle(keys)
        keys = np.concatenate([keys, np.full(7, EMPTY)])
        scores = np.full(keys.shape, step + 1, np.int64)
        values = rng.standard_normal((keys.shape[0], dim)).astype(np.float32)
        opt_rows = rng.random((keys.shape[0], 1)).astype(np.float32)
        t, j, _ = _insert_both(t, j, keys, scores, values, opt_rows, rounds=rounds)
        _lookup_both(t, j, np.concatenate([keys, pool[-50:]]))
    assert int(t.evicted) > 0 and int(tht.table_size(t)) == int(jht.table_size(j))
    assert int(tht.table_size(t)) == int(t.inserted) - int(t.evicted)
    if rounds == 1:
        assert int(t.overflowed) > 0
    _eq(tht.count_matched(t, 4), jht.count_matched(j, jnp.int64(4)))
    for g, w in zip(tht.export_batch(t, 3, 5), jht.export_batch(j, 3, 5)):
        _eq(g, w, "export_batch")


def test_same_bucket_flood_matches_jax():
    """Every key in one bucket: ranks hand out the empties in one round,
    then evictions serialise over rounds and the rest overflows."""
    t, j = _both_tables(8, 8, 2)
    keys = np.arange(1, 7, dtype=np.int64)
    t, j, _ = _insert_both(t, j, keys, np.ones(6, np.int64), np.zeros((6, 2), np.float32),
                           rounds=8)
    assert len(set(tht.lookup(t, _t(keys))[0].tolist())) == 6
    flood = np.arange(100, 130, dtype=np.int64)
    scores = np.random.default_rng(4).integers(0, 5, size=30).astype(np.int64)
    scores[:2] = 0      # the two that take the empties are the next round's minimum
    vals = np.arange(60, dtype=np.float32).reshape(30, 2)
    t, j, stale = _insert_both(t, j, flood, scores, vals, rounds=4)
    assert int(t.overflowed) > 0 and int(t.evicted) > 0
    # keys stored and evicted again within the call: every stored flood key's
    # row holds that key's values, whatever lane wrote the cell before it
    assert stale > 0
    slots, found = tht.lookup(t, _t(flood))
    assert found.any()
    np.testing.assert_array_equal(t.values[slots[found]].numpy(), vals[found.numpy()])
    # refresh: hits keep max(old, new) and no value is rewritten
    live = t.keys.reshape(-1).numpy().copy()
    t, j, _ = _insert_both(t, j, live, np.full(8, 2, np.int64),
                           np.full((8, 2), 9, np.float32))
    t, j, _ = _insert_both(t, j, live, np.full(8, 7, np.int64),
                           np.full((8, 2), 5, np.float32), update_existing_values=True)


def test_erase_and_scores_match_jax():
    rng = np.random.default_rng(5)
    t, j = _both_tables(1024, 8, 3)
    keys = rng.permutation(400)[:90].astype(np.int64)
    t, j, _ = _insert_both(t, j, keys, np.arange(90, dtype=np.int64),
                           rng.standard_normal((90, 3)).astype(np.float32))
    gone = np.concatenate([keys[:20], [1000, 1001, EMPTY]])
    t, j = tht.erase(t, _t(gone)), jht.erase(j, jnp.asarray(gone))
    _assert_table_equal(t, j, "erase")
    slots, found = _lookup_both(t, j, np.concatenate([keys, [1000]]))
    assert not found[:20].any() and found[20:90].all()
    new = rng.integers(0, 100, size=slots.shape[0]).astype(np.int64)
    t = tht.update_scores(t, _t(slots), _t(new))
    j = jht.update_scores(j, jnp.asarray(slots.astype(np.int32)), jnp.asarray(new))
    _assert_table_equal(t, j, "update_scores")
    t = tht.add_scores(t, _t(slots), _t(new))
    j = jht.add_scores(j, jnp.asarray(slots.astype(np.int32)), jnp.asarray(new))
    _assert_table_equal(t, j, "add_scores")


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("optimizer", ["sgd", "adam", "adagrad", "rowwise_adagrad"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_sparse_update_matches_jax(optimizer, weight_decay):
    rng = np.random.default_rng(6)
    dim, cap = 8, 64
    kw = dict(optimizer=optimizer, learning_rate=0.05, weight_decay=weight_decay,
              initial_accumulator=0.1)
    ta, ja = topt.SparseOptimizerArgs(**kw), jopt.SparseOptimizerArgs(**kw)
    od = topt.opt_dim_for(optimizer, dim)
    assert od == jopt.opt_dim_for(optimizer, dim)
    assert topt.value_dim_for(optimizer, dim) == jopt.value_dim_for(optimizer, dim)
    t, j = _both_tables(cap, 8, dim, opt_dim=od)
    keys = rng.permutation(1000)[:40].astype(np.int64)
    init_t = topt.initial_opt_row(optimizer, 40, dim, ta, torch.float32)
    init_j = jopt.initial_opt_row(optimizer, 40, dim, ja, jnp.float32)
    assert (init_t is None) == (init_j is None)
    if init_t is not None:
        _eq(init_t, init_j)
    t, j, _ = _insert_both(t, j, keys, np.ones(40, np.int64),
                           rng.standard_normal((40, dim)).astype(np.float32),
                           None if init_t is None else init_t.numpy())
    slots = tht.lookup(t, _t(keys))[0].numpy()
    slots[::7] = -1
    for step in (0, 1, 2, 5):
        g = rng.standard_normal((40, dim)).astype(np.float32)
        t = topt.sparse_update(t, _t(slots), _t(g), ta, torch.tensor(step))
        j = jopt.sparse_update(j, jnp.asarray(slots.astype(np.int32)), jnp.asarray(g), ja,
                               jnp.int32(step))
        _assert_table_equal(t, j, f"step {step}")


# ------------------------------------------------------------ table module
def _mk_tables(strategy="TIMESTAMP", admission=0, optimizer="rowwise_adagrad",
               mode="UNIFORM", cap=64, bc=8, dim=8, rounds=16):
    def mk(cfg, bt, opt):
        opts = cfg.DynamicEmbTableOptions(
            embedding_dim=dim, max_capacity=cap, bucket_capacity=bc,
            score_strategy=cfg.DynamicEmbScoreStrategy[strategy],
            admission_threshold=admission, insert_rounds=rounds,
            initializer_args=cfg.DynamicEmbInitializerArgs(
                mode=cfg.DynamicEmbInitializerMode[mode]))
        return bt.DynamicEmbeddingTable(
            opts, opt.SparseOptimizerArgs(optimizer=optimizer, learning_rate=0.1))
    return mk(tcfg, tbt, topt), mk(jcfg, jbt, jopt)


def _assert_state_equal(ts, js, msg=""):
    _assert_table_equal(ts.table, js.table, msg)
    _eq(ts.step, js.step, f"{msg} step")
    assert (ts.counter is None) == (js.counter is None)
    if ts.counter is not None:
        _assert_table_equal(ts.counter, js.counter, f"{msg} counter")


@pytest.mark.parametrize("strategy,admission,cap", [
    ("STEP", 0, 64), ("TIMESTAMP", 0, 64), ("LFU", 0, 64), ("STEP", 2, 512), ("LFU", 3, 512)])
def test_table_steps_match_jax(strategy, admission, cap):
    """N train steps (forward_train with batch frequencies, then backward),
    an eval lookup and the score API. Without admission the table overfills
    and evicts (under LFU new keys tie at 0 and evict each other within a
    call); with admission it is large enough that the counter table, whose
    stale slots would change which keys are admitted, never evicts."""
    rng = np.random.default_rng(7)
    tt, jt = _mk_tables(strategy, admission, cap=cap, bc=8 if cap == 64 else 32)
    ts, js = tt.init_state("cpu"), jt.init_state()
    for step in range(8):
        ids = rng.zipf(1.3, size=60).astype(np.int64) % 150
        ids[rng.random(60) < 0.1] = EMPTY
        tuk, _, _, _, tc = t_unique(_t(ids), return_counts=True)
        juk, _, _, _, jc = j_unique(jnp.asarray(ids), return_counts=True)
        ts, tslots, temb = tt.forward_train(ts, tuk, frequencies=tc)
        js, jslots, jemb = jt.forward_train(js, juk, frequencies=jc)
        stale = _stale(js.table, juk, jslots)
        rows = np.asarray(jslots)[stale]
        _eq(tslots, jslots, f"step {step} slots")
        np.testing.assert_allclose(temb.numpy()[~stale], np.asarray(jemb)[~stale], **VAL_TOL)
        g = rng.standard_normal(temb.shape).astype(np.float32)
        ts = tt.backward(ts, tslots, _t(g), keys=tuk)
        js = jt.backward(js, jslots, jnp.asarray(g))
        js = js.replace(table=_resync(js.table, ts.table, rows))
        _assert_state_equal(ts, js, f"step {step}")
    if admission:
        assert int(ts.table.evicted) == int(ts.counter.evicted) == 0
        assert 0 < int(ts.table.inserted) < int(ts.counter.inserted)
    else:
        assert int(ts.table.evicted) > 0
    probe = np.concatenate([np.arange(0, 150, 3), [EMPTY]]).astype(np.int64)
    np.testing.assert_allclose(tt.forward_eval(ts, _t(probe)).numpy(),
                               np.asarray(jt.forward_eval(js, jnp.asarray(probe))), **VAL_TOL)
    _eq(tt.get_score(ts, _t(probe)), jt.get_score(js, jnp.asarray(probe)))
    new = rng.integers(0, 50, size=probe.shape[0]).astype(np.int64)
    ts = tt.set_score(ts, _t(probe), _t(new))
    js = jt.set_score(js, jnp.asarray(probe), jnp.asarray(new))
    _assert_state_equal(ts, js, "set_score")


def test_custom_scores_and_overflow_match_jax():
    """CUSTOM scores, and one insert round so that same-cell losers fall
    back to their transient init embeddings (slot -1)."""
    rng = np.random.default_rng(8)
    tt, jt = _mk_tables("CUSTOM", cap=16, rounds=1)
    ts, js = tt.init_state("cpu"), jt.init_state()
    with pytest.raises(ValueError, match="CUSTOM"):
        tt.forward_train(ts, _t(np.array([1], np.int64)))
    for step in range(3):
        keys = rng.permutation(200)[:30].astype(np.int64)
        sc = rng.integers(0, 9, size=30).astype(np.int64)
        ts, tslots, temb = tt.forward_train(ts, _t(keys), custom_scores=_t(sc))
        js, jslots, jemb = jt.forward_train(js, jnp.asarray(keys), custom_scores=jnp.asarray(sc))
        _eq(tslots, jslots)
        np.testing.assert_array_equal(temb.numpy(), np.asarray(jemb))
        _assert_state_equal(ts, js, f"step {step}")
    assert int(ts.table.overflowed) > 0 and (tslots.numpy() < 0).any()


@pytest.mark.parametrize("optimizer", ["adam", "rowwise_adagrad", "sgd"])
def test_fill_with_duplicates_and_expand_match_jax(optimizer):
    rng = np.random.default_rng(9)
    tt, jt = _mk_tables(optimizer=optimizer, cap=64)
    ts, js = tt.init_state("cpu"), jt.init_state()
    keys = rng.integers(0, 40, size=70).astype(np.int64)     # duplicates
    keys[5] = EMPTY
    vals = rng.standard_normal((70, 8)).astype(np.float32)
    ts = tt.fill(ts, _t(keys), _t(vals))
    js = jt.fill(js, jnp.asarray(keys), jnp.asarray(vals))
    _assert_state_equal(ts, js, "fill")
    # dict semantics: the last occurrence of a key wins
    k = int(keys[-1])
    slot = int(tht.lookup(ts.table, _t(np.array([k], np.int64)))[0])
    np.testing.assert_array_equal(ts.table.values[slot].numpy(), vals[-1])
    sc = rng.integers(1, 99, size=70).astype(np.int64)
    ts = tt.fill(ts, _t(keys), _t(vals + 1), _t(sc))
    js = jt.fill(js, jnp.asarray(keys), jnp.asarray(vals + 1), jnp.asarray(sc))
    _assert_state_equal(ts, js, "refill")

    tt2, ts2 = tt.expand(ts)
    jt2, js2 = jt.expand(js)
    assert tt2.capacity == jt2.capacity == 128
    _assert_state_equal(ts2, js2, "expand")
    live = keys[keys != EMPTY]
    s_old, f_old = tht.lookup(ts.table, _t(live))
    s_new, f_new = tht.lookup(ts2.table, _t(live))
    assert f_old.all() and f_new.all()
    np.testing.assert_array_equal(ts2.table.values[s_new].numpy(),
                                  ts.table.values[s_old].numpy())


def test_sharded_embedding_forward_backward_match_jax():
    """ShardedDynamicEmbedding with mesh=None: per-token embeddings, the
    residual and the table after the backward; eval inserts nothing."""
    rng = np.random.default_rng(10)
    tt, jt = _mk_tables(cap=256, dim=8)
    tsh, jsh = TSharded(tt, mesh=None, device="cpu"), JSharded(jt, mesh=None)
    ts, js = tsh.init_state(), jsh.init_state()
    for step in range(4):
        ids = rng.zipf(1.2, size=80).astype(np.int64) % 500
        ids[-6:] = EMPTY
        ts, temb, tres = tsh.forward(ts, _t(ids), train=True)
        js, jemb, jres = jsh.forward(js, jnp.asarray(ids), train=True)
        np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), **VAL_TOL)
        for f in tres._fields:
            _eq(getattr(tres, f), getattr(jres, f), f)
        assert int(tres.num_overflow) == 0
        g = rng.standard_normal(temb.shape).astype(np.float32)
        ts = tsh.backward(ts, tres, _t(g))
        js = jsh.backward(js, jres, jnp.asarray(g))
        _assert_state_equal(ts, js, f"step {step}")
    before = convert.dynamic_table_to_numpy(ts)["table"]
    ids = np.arange(490, 520, dtype=np.int64)
    _, temb, tres = tsh.forward(ts, _t(ids), train=False)
    _, jemb, _ = jsh.forward(js, jnp.asarray(ids), train=False)
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), **VAL_TOL)
    assert (tres.slots.numpy() == -1).all()
    after = convert.dynamic_table_to_numpy(ts)["table"]
    for f, a in after.items():
        np.testing.assert_array_equal(a, before[f], err_msg=f)


def test_table_state_converts_both_ways():
    """convert.dynamic_table_state carries a JAX DynamicEmbTableState's
    numpy leaves into the port, and dynamic_table_to_numpy brings them back."""
    rng = np.random.default_rng(11)
    tt, jt = _mk_tables("LFU", admission=2)
    js = jt.init_state()
    for _ in range(3):
        ids = (rng.zipf(1.3, size=50) % 90).astype(np.int64)
        uk, _, _, _, c = j_unique(jnp.asarray(ids), return_counts=True)
        js, _, _ = jt.forward_train(js, uk, frequencies=c)

    def leaves(s):
        tab = lambda h: None if h is None else {
            f: None if getattr(h, f) is None else np.asarray(getattr(h, f))
            for f in convert.HASH_TABLE_FIELDS}
        return {"table": tab(s.table), "counter": tab(s.counter), "step": np.asarray(s.step)}

    ts = convert.dynamic_table_state(leaves(js), device="cpu")
    _assert_state_equal(ts, js, "converted")
    back = convert.dynamic_table_to_numpy(ts)
    for part in ("table", "counter"):
        for f, a in leaves(js)[part].items():
            np.testing.assert_array_equal(back[part][f], a, err_msg=f)
    np.testing.assert_array_equal(back["step"], np.asarray(js.step))
    # the converted state goes on training exactly as the JAX one
    ids = (rng.zipf(1.3, size=50) % 90).astype(np.int64)
    tuk, _, _, _, tc = t_unique(_t(ids), return_counts=True)
    juk, _, _, _, jc = j_unique(jnp.asarray(ids), return_counts=True)
    ts, tslots, _ = tt.forward_train(ts, tuk, frequencies=tc)
    js, jslots, _ = jt.forward_train(js, juk, frequencies=jc)
    _eq(tslots, jslots)
    _assert_state_equal(ts, js, "after one more step")
