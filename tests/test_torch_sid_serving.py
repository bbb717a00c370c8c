"""The port's SID-GR serving engine and continuous scheduler against the JAX
package's on the same contexts and params: paths equal, scores within
rtol/atol 1e-5 (fp32 on the CPU), bucket reuse and `compile_count`, beam
policies, the prefix cache and timeouts; `processor_from_spec` and
`TrieConstraint` against theirs."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch import convert
from recsys_examples_torch.inference.sid_serving import engine as t_eng
from recsys_examples_torch.inference.sid_serving import item_constraints as t_ic
from recsys_examples_torch.inference.sid_serving import logits_processor as t_lp
from recsys_examples_torch.inference.sid_serving import scheduler as t_sch
from recsys_examples_torch.models.sid_gr import SIDGRConfig as TConfig
from recsys_examples_torch.models.sid_gr import SIDGRModel as TModel
from recsys_examples_tpu.data.sid_batch import random_sid_batch
from recsys_examples_tpu.inference.sid_serving import engine as j_eng
from recsys_examples_tpu.inference.sid_serving import item_constraints as j_ic
from recsys_examples_tpu.inference.sid_serving import logits_processor as j_lp
from recsys_examples_tpu.inference.sid_serving import scheduler as j_sch
from recsys_examples_tpu.models.sid_gr import SIDGRConfig as JConfig
from recsys_examples_tpu.models.sid_gr import SIDGRModel as JModel

CFG = dict(num_hierarchies=3, codebook_size=16, hidden_size=32, num_layers=1,
           num_heads=2, head_dim=16, ffn_hidden=64, beam_width=4)
SERVING = dict(beam_width=4, ctx_buckets=(12, 24), batch_buckets=(1, 2, 4))
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jm = JModel(JConfig(**CFG))
    params = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                     random_sid_batch(0, 2, 4, 3, 16), train=False)["params"]
    params = jax.tree.map(lambda x: x.astype(jnp.float32), params)
    tm = TModel(TConfig(**CFG), device="cpu")
    tm.load_state_dict(convert.dense_state_dict(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def engines(models, **serving):
    jm, params, tm = models
    kw = dict(SERVING, **serving)
    return (j_eng.GRServingEngine(jm, params, j_eng.ServingConfig(**kw)),
            t_eng.GRServingEngine(tm, t_eng.ServingConfig(**kw)))


def test_engine_generate_matches_and_reuses_buckets(models):
    je, te = engines(models)
    rng = np.random.default_rng(0)
    # a partial item at the end of a context is dropped; an empty context
    for ctxs in ([rng.integers(0, 16, size=(9,)), rng.integers(0, 16, size=(7,))],
                 [rng.integers(0, 16, size=(12,)), rng.integers(0, 16, size=(3,))],
                 [rng.integers(0, 16, size=(20,))],
                 [np.zeros((0,), np.int64), rng.integers(0, 16, size=(6,)),
                  rng.integers(0, 16, size=(24,))]):
        want_p, want_s = je.generate(ctxs)
        got_p, got_s = te.generate(ctxs)
        assert got_p.dtype == np.int32 and got_p.shape == want_p.shape
        np.testing.assert_array_equal(got_p, want_p)
        np.testing.assert_allclose(got_s, want_s, **TOL)
        assert (np.diff(got_s, axis=1) <= 0).all()      # beams sorted by score
        assert te.compile_count == je.compile_count
    assert te.compile_count == 3      # (2, 12) twice, (1, 24), (4, 24)
    with pytest.raises(ValueError, match="exceeds"):
        te.generate([np.zeros(25, np.int64)])


def test_engine_warmup_counts_every_bucket(models):
    """warmup's one-item contexts fall into the first context bucket that
    holds an item, so it sees one bucket per batch size, as in JAX."""
    je, te = engines(models, ctx_buckets=(3, 12), batch_buckets=(1, 2))
    te.warmup()
    je.warmup()
    assert te.compile_count == je.compile_count == 2


@pytest.mark.parametrize("policy_kw", [
    dict(), dict(kind="score_margin", margin=1.0), dict(kind="scheduled", schedule=(4, 2))])
def test_scheduler_matches(models, policy_kw):
    """Mixed lengths over two context buckets and a token budget that splits
    a batch: the same requests complete with the same answers, in the same
    number of batches."""
    je, te = engines(models, max_batch_tokens=36)
    js = j_sch.GRContinuousScheduler(je, max_batch=4, beam_policy=j_sch.BeamPolicy(**policy_kw))
    ts = t_sch.GRContinuousScheduler(te, max_batch=4, beam_policy=t_sch.BeamPolicy(**policy_kw))
    rng = np.random.default_rng(1)
    ctxs = [rng.integers(0, 16, size=(n,)) for n in (6, 15, 9, 3, 24, 12, 6)]
    jr = [js.submit(c, top_k=3) for c in ctxs]
    tr = [ts.submit(c, top_k=3) for c in ctxs]
    assert ts.status()["queue_depth"] == 7
    js.run_until_empty()
    ts.run_until_empty()
    for a, b in zip(jr, tr):
        want, got = js.get_result(a), ts.get_result(b)
        assert got["sids"] == want["sids"] and 1 <= len(got["sids"]) <= 3
        np.testing.assert_allclose(got["scores"], want["scores"], **TOL)
        assert got["latency_ms"] >= 0
        assert ts.get_result(b) is None      # a result is handed out once
    st, jst = ts.status(), js.status()
    for key in ("queue_depth", "finished", "compiled_buckets", "submitted", "batches",
                "completed"):
        assert st[key] == jst[key], key
    assert st["completed"] == 7 and st["batches"] >= 3


def test_beam_policy_matches():
    for kw in (dict(kind="scheduled", schedule=(64, 16, 8)), dict(width=32),
               dict(kind="scheduled")):
        jp, tp = j_sch.BeamPolicy(**kw), t_sch.BeamPolicy(**kw)
        assert [tp.width_for(h) for h in range(5)] == [jp.width_for(h) for h in range(5)]
    paths = np.arange(12).reshape(4, 3)
    scores = np.asarray([-0.1, -0.5, -2.0, -9.0])
    for kw in (dict(kind="score_margin", margin=1.0), dict(kind="fixed")):
        want = j_sch.BeamPolicy(**kw).filter_results(paths, scores)
        got = t_sch.BeamPolicy(**kw).filter_results(paths, scores)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_prefix_cache_and_timeout(models):
    _, te = engines(models, ctx_buckets=(12,), batch_buckets=(1,))
    sched = t_sch.GRContinuousScheduler(te, max_batch=1, prefix_cache_size=2)
    ctx = np.asarray([1, 2, 3, 4] * 2, np.int32)
    r1 = sched.submit(ctx, top_k=4)
    sched.run_until_empty()
    res1 = sched.get_result(r1)
    r2 = sched.submit(ctx, top_k=2)           # served from the cache, no decode
    res2 = sched.get_result(r2)
    assert res2["cached"] is True and res2["sids"] == res1["sids"][:2]
    assert sched.status()["prefix_cache_hits"] == 1 and sched.status()["batches"] == 1
    # the cache holds two contexts: a third evicts the oldest
    for c in ([5] * 6, [7] * 6):
        sched.submit(np.asarray(c, np.int32))
    sched.run_until_empty()
    assert len(sched._prefix_cache) == 2 and ctx.tobytes() not in sched._prefix_cache
    # a request past its deadline fails without a decode
    late = t_sch.GRContinuousScheduler(te, max_batch=1, request_timeout_s=0.0)
    rid = late.submit(ctx)
    time.sleep(0.01)
    assert late.tick() == 0
    assert late.get_result(rid) == {"error": "timeout"} and late.status()["timeouts"] == 1


SPECS = [
    {"type": "suppress_tokens", "token_ids": [1, 3], "steps": [0]},
    {"type": "bad_tokens", "suppressed_token_ids": [0], "fill_value": -50.0},
    {"type": "token_bias", "token_bias": {"2": 0.5, "5": -1.0}},
    {"type": "bias_tokens", "biases": [[4, 0.25], [4, 0.25]], "steps": [1, 2]},
    {"type": "temperature", "temperature": 0.5},
    {"type": "top_k", "k": 3},
]


@pytest.mark.parametrize("step", [0, 1])
def test_processors_from_specs_match(step):
    rng = np.random.default_rng(2)
    logp = np.log(rng.dirichlet(np.ones(8), size=(2, 3))).astype(np.float32)
    paths = np.zeros((2, 3, step), np.int32)
    for specs in ([s] for s in SPECS):
        want = j_lp.processors_from_specs(specs)(step, jnp.asarray(logp), jnp.asarray(paths))
        got = t_lp.processors_from_specs(specs)(step, torch.from_numpy(logp),
                                                torch.from_numpy(paths))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=str(specs), **TOL)
    j_chain, t_chain = j_lp.processors_from_specs(SPECS), t_lp.processors_from_specs(SPECS)
    np.testing.assert_allclose(
        t_chain(step, torch.from_numpy(logp), torch.from_numpy(paths)).numpy(),
        np.asarray(j_chain(step, jnp.asarray(logp), jnp.asarray(paths))), **TOL)
    assert bool(t_chain) and not bool(t_lp.processors_from_specs(None))
    assert not bool(t_lp.make_chain()) and len(t_lp.make_chain(0.5, 2).processors) == 2
    for bad in ({"type": "nope"}, {"type": "token_bias"}, {"type": "token_suppress"}):
        with pytest.raises(ValueError):
            t_lp.processor_from_spec(bad)
        with pytest.raises(ValueError):
            j_lp.processor_from_spec(bad)


def test_trie_constraint_matches():
    rng = np.random.default_rng(3)
    catalog = np.unique(rng.integers(0, 6, size=(30, 3)), axis=0)
    jt, tt_ = j_ic.TrieConstraint(catalog, 6), t_ic.TrieConstraint(catalog, 6, device="cpu")
    assert tt_.num_items == jt.num_items
    for a, b in zip(tt_.children, jt.children):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    logits = rng.standard_normal((2, 4, 6)).astype(np.float32)
    nodes = np.zeros((2, 4), np.int32)
    for h in range(3):
        toks = rng.integers(0, 6, size=(2, 4)).astype(np.int32)
        np.testing.assert_array_equal(
            tt_.mask_logits(torch.from_numpy(logits), torch.from_numpy(nodes).long(), h).numpy(),
            np.asarray(jt.mask_logits(jnp.asarray(logits), jnp.asarray(nodes), h)))
        nodes = np.array(jt.advance(jnp.asarray(nodes), jnp.asarray(toks), h))
        # dead beams (-1) stay dead
        np.testing.assert_array_equal(
            tt_.advance(torch.full((2, 4), -1), torch.from_numpy(toks).long(), h).numpy(), -1)
    tt_.reload(np.array([[2, 2, 2]]))
    m = tt_.mask_logits(torch.zeros(1, 1, 6), torch.zeros(1, 1, dtype=torch.int64), 0)[0, 0]
    assert torch.isfinite(m[2]) and torch.isinf(m[[0, 1, 3, 4, 5]]).all()
    lp = t_ic.LogitsProcessor(temperature=2.0, top_k=2)
    np.testing.assert_allclose(
        lp(torch.tensor([[4.0, 2.0, 1.0, 3.0]])).numpy(),
        np.asarray(j_ic.LogitsProcessor(temperature=2.0, top_k=2)(
            jnp.asarray([[4.0, 2.0, 1.0, 3.0]]))))
