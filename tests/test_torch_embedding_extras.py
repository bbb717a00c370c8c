"""The embedding extras against the JAX package's on the CPU: pooled bags
(`dynamicemb/pooled.py`, SUM and MEAN, forward and backward), grouped
features in one table (`GroupedShardedDynamicEmbedding`), the planner and
its memory report, and the frozen table (`freeze_table`,
`inference_lookup`, `export_serialized`). The same ids and gradients, made
from a seed with numpy, go to both; values are held to rtol 1e-5, keys,
scores, slots and counters bit for bit. Mirrors
tests/test_pooled_embedding.py and tests/test_hybrid_and_planner.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch.dynamicemb import batched_table as tbt
from recsys_examples_torch.dynamicemb import dynamicemb_config as tcfg
from recsys_examples_torch.dynamicemb import exportable_tables as tex
from recsys_examples_torch.dynamicemb import optimizer as topt
from recsys_examples_torch.dynamicemb import planner as tpl
from recsys_examples_torch.dynamicemb import pooled as tpo
from recsys_examples_torch.dynamicemb import sharded_collection as tsc
from recsys_examples_tpu.dynamicemb import batched_table as jbt
from recsys_examples_tpu.dynamicemb import dynamicemb_config as jcfg
from recsys_examples_tpu.dynamicemb import exportable_tables as jex
from recsys_examples_tpu.dynamicemb import optimizer as jopt
from recsys_examples_tpu.dynamicemb import planner as jpl
from recsys_examples_tpu.dynamicemb import pooled as jpo
from recsys_examples_tpu.dynamicemb import sharded_collection as jsc

DIM = 8
VAL_TOL = dict(rtol=1e-5, atol=1e-7)


def _table(cfg, opt, mod, optimizer="sgd", mode="uniform", capacity=256):
    return mod.DynamicEmbeddingTable(
        cfg.DynamicEmbTableOptions(
            embedding_dim=DIM, max_capacity=capacity, bucket_capacity=8,
            initializer_args=cfg.DynamicEmbInitializerArgs(
                mode=cfg.DynamicEmbInitializerMode(mode))),
        opt.SparseOptimizerArgs(optimizer=optimizer, learning_rate=0.5))


def _tables(**kw):
    return _table(tcfg, topt, tbt, **kw), _table(jcfg, jopt, jbt, **kw)


def _assert_table(t, j):
    for f in ("keys", "scores", "inserted", "evicted", "overflowed"):
        np.testing.assert_array_equal(getattr(t.table, f).numpy(), np.asarray(getattr(j.table, f)),
                                      err_msg=f)
    np.testing.assert_allclose(t.table.values.numpy(), np.asarray(j.table.values), **VAL_TOL)
    if t.table.opt is not None:
        np.testing.assert_allclose(t.table.opt.numpy(), np.asarray(j.table.opt), **VAL_TOL)


def _bags(seed=0):
    """Bags of 3, 0, 2 and 4 ids (a duplicate inside a bag, a repeat across
    bags), three padding tokens past offsets[-1]."""
    rng = np.random.default_rng(seed)
    lengths = np.array([3, 0, 2, 4], np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    ids = np.zeros((12,), np.int64)
    ids[:9] = rng.integers(1, 64, 9)
    ids[2], ids[8] = ids[0], ids[3]
    return ids, offsets


@pytest.mark.parametrize("mode", [tpo.PoolingMode.SUM, tpo.PoolingMode.MEAN])
def test_pooled_forward_backward_match_jax(mode):
    """Two train steps: pooled [B, dim] and the table after each backward."""
    t, j = _tables(optimizer="adam")
    tp = tpo.PooledDynamicEmbedding(tsc.ShardedDynamicEmbedding(t, device="cpu"), mode)
    jp = jpo.PooledDynamicEmbedding(jsc.ShardedDynamicEmbedding(j, mesh=None), mode)
    ts, js = tp.init_state(), jp.init_state()
    jfwd = jax.jit(jp.forward, static_argnames="train")
    jbwd = jax.jit(jp.backward)
    rng = np.random.default_rng(1)
    for step in range(2):
        ids, offsets = _bags(step)
        g = rng.standard_normal((4, DIM)).astype(np.float32)
        ts, tpool, tres = tp.forward(ts, torch.from_numpy(ids), torch.from_numpy(offsets))
        js, jpool, jres = jfwd(js, jnp.asarray(ids), jnp.asarray(offsets))
        np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), **VAL_TOL)
        assert not tpool[1].any()                   # the empty bag
        np.testing.assert_array_equal(tres.inner.slots.numpy(), np.asarray(jres.inner.slots))
        ts = tp.backward(ts, tres, torch.from_numpy(g))
        js = jbwd(js, jres, jnp.asarray(g))
        _assert_table(ts, js)
    # eval: nothing inserted
    ts, tpool, _ = tp.forward(ts, torch.from_numpy(ids), torch.from_numpy(offsets), train=False)
    js, jpool, _ = jfwd(js, jnp.asarray(ids), jnp.asarray(offsets), train=False)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), **VAL_TOL)


def test_grouped_forward_backward_match_jax():
    """Three features in one table: ids keyed by feature in bits 58 and up
    (the same id in two features is two keys), ids outside [0, 2^58) and
    EMPTY_KEY padding skipped; forward and backward against JAX."""
    t, j = _tables(optimizer="rowwise_adagrad")
    names = ("item", "action", "user")
    tg = tsc.GroupedShardedDynamicEmbedding(t, names, device="cpu")
    jg = jsc.GroupedShardedDynamicEmbedding(j, names, mesh=None)
    rng = np.random.default_rng(2)
    ids = {"item": rng.integers(0, 40, 10), "action": rng.integers(0, 40, 6),
           "user": np.array([3, -1, 1 << 58, 5, tcfg.EMPTY_KEY])}
    ids = {k: np.asarray(v, np.int64) for k, v in ids.items()}
    ids["action"][0] = ids["item"][0]
    ts, js = tg.init_state(), jg.init_state()
    ts, temb, tres = tg.forward(ts, {k: torch.from_numpy(v) for k, v in ids.items()})
    js, jemb, jres = jax.jit(jg.forward)(js, {k: jnp.asarray(v) for k, v in ids.items()})
    for k in names:
        np.testing.assert_allclose(temb[k].numpy(), np.asarray(jemb[k]), **VAL_TOL)
    assert not temb["user"][1:3].any() and not temb["user"][4].any()
    np.testing.assert_array_equal(tres.recv_keys.numpy(), np.asarray(jres.recv_keys))
    np.testing.assert_array_equal(tres.slots.numpy(), np.asarray(jres.slots))
    g = {k: rng.standard_normal((len(v), DIM)).astype(np.float32) for k, v in ids.items()}
    ts = tg.backward(ts, tres, {k: torch.from_numpy(v) for k, v in g.items()})
    js = jax.jit(jg.backward)(js, jres, {k: jnp.asarray(v) for k, v in g.items()})
    _assert_table(ts, js)


def test_planner_matches_jax():
    """JAX's `test_planner_plan_and_report`, held field by field and the
    report string character by character; a set initializer is left as it
    is and a capacity below one bucket becomes one."""
    plans = []
    for cfg, opt, pl in ((tcfg, topt, tpl), (jcfg, jopt, jpl)):
        tables = {
            "item": cfg.DynamicEmbTableOptions(embedding_dim=16, max_capacity=1000,
                                               bucket_capacity=64),
            "user": cfg.DynamicEmbTableOptions(embedding_dim=16, max_capacity=500,
                                               bucket_capacity=64),
            "tiny": cfg.DynamicEmbTableOptions(
                embedding_dim=8, max_capacity=3, bucket_capacity=64,
                initializer_args=cfg.DynamicEmbInitializerArgs(lower=-0.5, upper=0.5)),
        }
        plans.append(pl.DynamicEmbeddingShardingPlanner(world_size=4).plan(
            tables, opt.SparseOptimizerArgs(optimizer="adam"),
            dist_type=pl.DistType.ROUNDROBIN))
    (tplan, tmods), (jplan, jmods) = plans
    assert tplan.memory_report() == jplan.memory_report()
    assert "TOTAL" in tplan.memory_report()
    assert tplan.world_size == jplan.world_size == 4
    for name, je in jplan.entries.items():
        te = tplan.entries[name]
        assert (te.local_capacity, te.local_bytes, te.dist_type.value) == \
            (je.local_capacity, je.local_bytes, je.dist_type.value)
        ti, ji = te.options.initializer_args, je.options.initializer_args
        assert (ti.lower, ti.upper) == (ji.lower, ji.upper)
        assert te.options.max_capacity == je.options.max_capacity
        assert tmods[name].capacity == jmods[name].capacity
    assert tplan.entries["item"].options.initializer_args.upper == pytest.approx(0.25)
    assert {m.value for m in tpl.DistType} == {m.value for m in jpl.DistType}


@pytest.fixture(scope="module")
def frozen():
    """A table trained on a few ids in both packages, frozen."""
    t, j = _tables()
    ts, js = t.init_state("cpu"), j.init_state()
    keys = np.asarray([3, 9, 27, 81, 243], np.int64)
    ts, _, temb = t.forward_train(ts, torch.from_numpy(keys))
    js, _, jemb = j.forward_train(js, jnp.asarray(keys))
    return t, ts, tex.freeze_table(t, ts), jex.freeze_table(j, js), keys, temb


def test_freeze_and_inference_lookup_match_jax(frozen):
    t, ts, tf, jf, keys, temb = frozen
    probe = np.concatenate([keys, [999, tcfg.EMPTY_KEY]]).astype(np.int64)
    got = tex.inference_lookup(tf, torch.from_numpy(probe))
    want = jex.inference_lookup(jf, jnp.asarray(probe))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:5].numpy(), temb.numpy())
    assert not got[5:].any()
    np.testing.assert_array_equal(tf.keys.numpy(), np.asarray(jf.keys))


def test_export_serialized_loads_back(frozen):
    """The serialised `torch.export` program, loaded back, gives the
    lookup's rows bit for bit, also the eval path's for the trained ids."""
    t, ts, tf, _, keys, _ = frozen
    blob = tex.export_serialized(tf, sample_n=16)
    assert isinstance(blob, bytes) and blob
    prog = tex.load_serialized(blob)
    probe = np.zeros(16, np.int64)
    probe[:5], probe[5], probe[6] = keys, 4, tcfg.EMPTY_KEY
    probe = torch.from_numpy(probe)
    out = prog.module()(probe)
    assert torch.equal(out, tex.inference_lookup(tf, probe))
    assert torch.equal(out[:5], t.forward_eval(ts, probe[:5]))
