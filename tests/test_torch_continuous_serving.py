"""The port's stepwise pooled SID-GR scheduler (`ContinuousGRScheduler`)
against the JAX package's on the cases of tests/test_continuous_serving.py,
with its model and `make_sched`'s config, the same params (flax tree ->
`convert.dense_state_dict`, fp32 on the CPU) and the same contexts: paths
equal, scores within rtol/atol 1e-5, and the same dispatch, decode-step,
high-water and lease counts and the same step functions built. The
`/generate` front over both schedulers runs through aiohttp's test server.

Where a width schedule narrows, the JAX package decodes a path from the
first `width` slots only and fills a token it cannot reach with INT_MIN
(ROADMAP.md section C); there the paths are compared where JAX's are in
range and the port's must all be tokens.
"""
import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch import convert
from recsys_examples_torch.inference.sid_serving import continuous as t_cont
from recsys_examples_torch.inference.sid_serving import engine as t_eng
from recsys_examples_torch.inference.sid_serving import item_constraints as t_ic
from recsys_examples_torch.inference.sid_serving import logits_processor as t_lp
from recsys_examples_torch.inference.sid_serving import scheduler as t_sch
from recsys_examples_torch.models.sid_gr import SIDGRConfig as TConfig
from recsys_examples_torch.models.sid_gr import SIDGRModel as TModel
from recsys_examples_tpu.data.sid_batch import SIDBatch as JBatch
from recsys_examples_tpu.inference.sid_serving import continuous as j_cont
from recsys_examples_tpu.inference.sid_serving import engine as j_eng
from recsys_examples_tpu.inference.sid_serving import item_constraints as j_ic
from recsys_examples_tpu.inference.sid_serving import logits_processor as j_lp
from recsys_examples_tpu.inference.sid_serving import scheduler as j_sch
from recsys_examples_tpu.models.sid_gr import SIDGRConfig as JConfig
from recsys_examples_tpu.models.sid_gr import SIDGRModel as JModel

H = 4
MODEL = dict(num_hierarchies=H, codebook_size=32, hidden_size=32, num_layers=1,
             num_heads=2, head_dim=16, ffn_hidden=64, beam_width=8)
SERVING = dict(beam_width=8, ctx_buckets=(16, 64), batch_buckets=(1, 2, 4),
               max_batch_tokens=256)
TOL = dict(rtol=1e-5, atol=1e-5)
COUNTERS = ("submitted", "dispatches", "prefills", "decode_steps", "completed")


@pytest.fixture(scope="module")
def models():
    jm = JModel(JConfig(**MODEL, dtype=jnp.float32))
    batch = JBatch(
        history_sids=jnp.zeros((32,), jnp.int32),
        history_lengths=jnp.asarray([8], jnp.int32),
        history_offsets=jnp.asarray([0, 8], jnp.int32),
        candidate_sids=jnp.zeros((1, H), jnp.int32),
        batch_size=1, num_hierarchies=H, max_history_tokens=32,
    )
    params = jax.jit(lambda key: jm.init(key, batch))(jax.random.PRNGKey(0))["params"]
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    tm = TModel(TConfig(**MODEL), device="cpu")
    tm.load_state_dict(convert.dense_state_dict(params))
    return jm, params, tm


def make_scheds(models, policy=None, logits=(None, None), **kw):
    """The JAX scheduler and the port's, configured alike."""
    jm, params, tm = models
    policy = policy or dict(width=8)
    js = j_cont.ContinuousGRScheduler(
        jm, params, j_eng.ServingConfig(**SERVING), max_batch=4,
        beam_policy=j_sch.BeamPolicy(**policy), logits_processor=logits[0], **kw)
    ts = t_cont.ContinuousGRScheduler(
        tm, t_eng.ServingConfig(**SERVING), max_batch=4,
        beam_policy=t_sch.BeamPolicy(**policy), logits_processor=logits[1], **kw)
    return js, ts


def ctx(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 32, n * H).astype(np.int32)


def same_result(want, got, narrowed=False):
    assert len(got["sids"]) == len(want["sids"]) >= 1
    if narrowed:
        jp, tp = np.asarray(want["sids"]), np.asarray(got["sids"])
        np.testing.assert_array_equal(tp[jp >= 0], jp[jp >= 0])
        assert (tp >= 0).all() and (tp < 32).all()
    else:
        assert got["sids"] == want["sids"]
    np.testing.assert_allclose(got["scores"], want["scores"], **TOL)


def same_state(js, ts):
    """Counters, live depths, leases and the step functions built."""
    jst, tst = js.status(), ts.status()
    for key in ("queue_depth", "inflight", "finished", "compiled", "pool_high_water",
                "pool_free", "pool_leaks") + COUNTERS:
        assert tst.get(key) == jst.get(key), key
    assert set(ts._fns) == set(js._fns)
    assert not any(tst["pool_leaks"].values())


def run_both(js, ts, ctxs, **kw):
    """Submit the same contexts to both, run them dry; (JAX results, port
    results)."""
    jr = [js.submit(c, **kw) for c in ctxs]
    tr = [ts.submit(c, **kw) for c in ctxs]
    js.run_until_empty()
    ts.run_until_empty()
    return [js.get_result(r) for r in jr], [ts.get_result(r) for r in tr]


def test_interleaved_overlap_short_finishes_first(models):
    """A short request submitted after a long one overlaps it in flight;
    both schedulers hold the same requests in flight at every tick and
    finish them in the same order, with the same answers."""
    js, ts = make_scheds(models)
    order = {"j": [], "t": []}
    rids = {"j": [], "t": []}
    for s, tag in ((js, "j"), (ts, "t")):
        rids[tag].append(s.submit(ctx(12, 1)))       # 48 tokens -> bucket 64
        s.tick()
        assert s.status()["inflight"] == 1
        rids[tag].append(s.submit(ctx(2, 2)))        # 8 tokens -> bucket 16
        s.tick()
        assert s.status()["inflight"] == 2           # overlap in flight
        for _ in range(10):
            s.tick()
            for rid in rids[tag]:
                if rid not in order[tag] and s.finished.get(rid) is not None:
                    order[tag].append(rid)
            if len(order[tag]) == 2:
                break
    assert order["t"] == rids["t"] and order["j"] == rids["j"]    # long first
    same_state(js, ts)
    for a, b in zip(rids["j"], rids["t"]):
        same_result(js.get_result(a), ts.get_result(b))


def test_continuous_matches_whole_generation(models):
    """One request through the pooled steps: the JAX scheduler's answer and
    the port's own whole `generate_beam_decode` on the same batch."""
    _, _, tm = models
    js, ts = make_scheds(models)
    c = ctx(3, 7)
    (want,), (got,) = run_both(js, ts, [c])
    same_result(want, got)
    same_state(js, ts)
    batch = ts._make_batch([type("R", (), {"context": c})()], 1, 16)
    ref_paths, ref_scores = tm.generate_beam_decode(batch, beam_width=8)
    np.testing.assert_array_equal(np.asarray(got["sids"]),
                                  ref_paths[0, :len(got["sids"])].numpy())
    np.testing.assert_allclose(got["scores"], ref_scores[0, :len(got["scores"])].numpy(),
                               **TOL)


def test_scheduled_widths_compile_narrowing(models):
    """A narrowing schedule selects each step's width: the same step chains
    cover hierarchy steps 1..H-1 once, in order, on both sides."""
    js, ts = make_scheds(models, dict(kind="scheduled", width=8, schedule=(8, 8, 4, 2)))
    assert ts.widths == js.widths == [8, 8, 4, 2]
    (want,), (got,) = run_both(js, ts, [ctx(2, 3)])
    assert 0 < len(got["sids"]) <= 2
    same_result(want, got, narrowed=True)
    same_state(js, ts)
    spans = sorted((k[1], k[2]) for k in ts._fns if k[0] == "step")
    assert [h for h0, h1 in spans for h in range(h0, h1)] == list(range(1, H))


def test_score_margin_prunes_live_beams(models):
    js, ts = make_scheds(models, dict(kind="score_margin", width=8, margin=0.1))
    (want,), (got,) = run_both(js, ts, [ctx(2, 4)])
    same_result(want, got)
    sc = np.asarray(got["scores"])
    assert (sc.max() - sc.min()) <= 0.1 + 1e-6
    same_state(js, ts)


def test_pool_high_water_and_budget(models):
    """Two usable slots (and the scratch slot): two of four requests are
    admitted at the first tick, the rest wait for leases."""
    js, ts = make_scheds(models, pool_slots=3)
    jr = [js.submit(ctx(2, i)) for i in range(4)]
    tr = [ts.submit(ctx(2, i)) for i in range(4)]
    js.tick()
    ts.tick()
    assert ts.status()["inflight"] == 2 and ts.status()["queue_depth"] == 2
    same_state(js, ts)
    js.run_until_empty()
    ts.run_until_empty()
    st = ts.status()
    assert st["pool_high_water"][16] == 2 and st["completed"] == 4
    same_state(js, ts)
    for a, b in zip(jr, tr):
        same_result(js.get_result(a), ts.get_result(b))


def test_logits_processor_composes_with_score_margin(models):
    """A temperature + trie-constraint chain under the score-margin policy:
    every returned tuple is in the catalog and within the margin."""
    rng = np.random.default_rng(5)
    catalog = np.unique(rng.integers(0, 32, size=(40, H)).astype(np.int32), axis=0)
    jt, tt = j_ic.TrieConstraint(catalog, 32), t_ic.TrieConstraint(catalog, 32, device="cpu")

    def j_mask(step, paths):
        node = jnp.zeros(paths.shape[:2], jnp.int32)
        for s in range(step):
            node = jt.advance(node, paths[:, :, s], s)
        return jt.mask_logits(jnp.zeros(paths.shape[:2] + (32,)), node, step)

    def t_mask(step, paths):
        node = torch.zeros(paths.shape[:2], dtype=torch.int64)
        for s in range(step):
            node = tt.advance(node, paths[:, :, s], s)
        return tt.mask_logits(torch.zeros(paths.shape[:2] + (32,)), node, step)

    chains = (j_lp.make_chain(0.8, constraint_mask_fn=j_mask),
              t_lp.make_chain(0.8, constraint_mask_fn=t_mask))
    js, ts = make_scheds(models, dict(kind="score_margin", width=8, margin=3.0), chains)
    (want,), (got,) = run_both(js, ts, [ctx(2, 9)])
    same_result(want, got)
    allowed = {tuple(r) for r in catalog.tolist()}
    assert all(tuple(sid) in allowed for sid in got["sids"])
    sc = np.asarray(got["scores"])
    assert (sc.max() - sc.min()) <= 3.0 + 1e-6
    same_state(js, ts)


def test_timing_breakdown_and_metrics(models):
    js, ts = make_scheds(models)
    (want,), (got,) = run_both(js, ts, [ctx(2, 11)])
    same_result(want, got)
    t = got["timing"]
    assert t["queue_ms"] >= 0 and t["decode_ms"] >= 0 and t["total_ms"] >= t["decode_ms"]
    m, jm = ts.get_metrics(), js.get_metrics()
    assert set(m) == set(jm)
    for key in ("counters", "queue_depth", "inflight", "pool_high_water",
                "pool_utilization", "compiled_executables", "steps_per_dispatch"):
        assert m[key] == jm[key], key
    assert m["counters"]["completed"] == 1 and m["counters"]["dispatches"] > 0


DISPATCH_CTXS = [ctx(3, 40 + i) for i in range(4)]


@pytest.fixture(scope="module")
def per_step(models):
    """Four same-bucket requests at steps_per_dispatch 1, on both sides
    (the per-step reference of the two tests below)."""
    js, ts = make_scheds(models, steps_per_dispatch=1)
    return js, ts, run_both(js, ts, DISPATCH_CTXS)


def test_coalescing_reduces_dispatches(models, per_step):
    """steps_per_dispatch 2 issues fewer dispatches than per-step ticking,
    as many as the JAX scheduler does at each setting."""
    js1, ts1, (want1, got1) = per_step
    js, ts = make_scheds(models, steps_per_dispatch=2)
    want, got = run_both(js, ts, DISPATCH_CTXS)
    for a, b in zip(want1 + want, got1 + got):
        same_result(a, b)
    same_state(js1, ts1)
    same_state(js, ts)
    assert ts.metrics["completed"] == ts1.metrics["completed"] == 4
    assert ts.metrics["dispatches"] < ts1.metrics["dispatches"]


def test_full_chain_fast_path(models, per_step):
    """steps_per_dispatch >= H - 1: a same-bucket group runs prefill, every
    step and the finalize in one pool-free dispatch, with the answers of the
    pooled per-step path."""
    _, ts1, (_, slow) = per_step
    jf, tf = make_scheds(models, steps_per_dispatch=H - 1)
    want, fast = run_both(jf, tf, DISPATCH_CTXS)
    assert tf.metrics["dispatches"] == 1 and ts1.metrics["dispatches"] > 1
    assert all(p.high_water == 0 for p in tf.pools.values())
    same_state(jf, tf)
    for a, b, c in zip(want, fast, slow):
        same_result(a, b)
        assert b["sids"] == c["sids"]
        np.testing.assert_allclose(b["scores"], c["scores"], **TOL)


@pytest.mark.parametrize("kind", ["continuous", "batch"])
def test_http_generate(models, kind):
    """/generate in SGLang's payload over the stepwise and the batch
    scheduler: the answers of the scheduler driven directly, /health and
    /metrics."""
    pytest.importorskip("aiohttp")
    from aiohttp.test_utils import TestClient, TestServer

    from recsys_examples_torch.inference.sid_serving.http import create_app

    _, _, tm = models

    def scheduler():
        if kind == "continuous":
            return make_scheds(models)[1]
        eng = t_eng.GRServingEngine(tm, t_eng.ServingConfig(**SERVING))
        return t_sch.GRContinuousScheduler(eng, max_batch=4)

    ctxs = [ctx(2, 50), ctx(12, 51), ctx(1, 52)]
    direct = scheduler()
    rids = [direct.submit(c, top_k=3) for c in ctxs]
    direct.run_until_empty()
    want = [direct.get_result(r) for r in rids]

    async def drive():
        async with TestClient(TestServer(create_app(scheduler()))) as client:
            r = await client.get("/health")
            assert r.status == 200 and (await r.json()) == {"status": "ok"}
            outs = await asyncio.gather(*(
                client.post("/generate", json={"input_ids": c.tolist(),
                                               "sampling_params": {"top_k": 3}})
                for c in ctxs))
            bodies = []
            for r in outs:
                assert r.status == 200
                bodies.append(await r.json())
            m = await (await client.get("/metrics")).json()
            return bodies, m

    bodies, m = asyncio.run(drive())
    for w, b in zip(want, bodies):
        assert b["sids"] == w["sids"] and len(b["sids"]) == 3
        np.testing.assert_allclose(b["scores"], w["scores"], **TOL)
    completed = m["counters"]["completed"] if kind == "continuous" else m["completed"]
    assert completed == 3
