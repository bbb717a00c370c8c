"""Row-sharded dynamic tables: the port's exact all-to-all exchange on gloo
ranks against the JAX package's `ShardedDynamicEmbedding` on a W-device
mesh (`make_mesh(dp=W, tp=1, devices=jax.devices()[:W])`), W = 2 and 4.

Each world size is one spawn of CPU ranks (`mesh.spawn_ranks`) that runs
every scenario and saves its results; the JAX side runs in the pytest
process. Held:
  - three train steps, each port rank fed the token chunk that JAX's
    `shard_map` hands that rank: per-token embeddings within rtol 1e-6; per
    shard keys, scores, slots, counters and step bit for bit; values and
    optimizer rows within VAL_TOL; `num_overflow` 0; then an eval lookup;
  - grouped features, a pooled table and the embedding cache's prefetch
    under the mesh, each rank fed its block of samples: per-key contents
    (the owner dedups what it receives, so its table does not depend on
    the token split), pooled outputs, the union of the ranks' host stores
    and the sum of their counters;
  - JAX's overflow batch (every key owned by one rank, bucket factor 1):
    the JAX exchange drops keys past its cap until `AdaptiveBucketing`
    grows it; the port's exchange is exact, stores every key and counts no
    overflow (a deliberate difference, ROADMAP §C).
The ranks import no JAX."""
import os

import numpy as np
import pytest
import torch

from recsys_examples_torch import convert
from recsys_examples_torch.dynamicemb import batched_table as tbt
from recsys_examples_torch.dynamicemb import dynamicemb_config as tcfg
from recsys_examples_torch.dynamicemb import optimizer as topt
from recsys_examples_torch.dynamicemb.hashtable import lookup
from recsys_examples_torch.dynamicemb.hybrid_storage import HybridDynamicEmbedding
from recsys_examples_torch.dynamicemb.pooled import PooledDynamicEmbedding
from recsys_examples_torch.dynamicemb.sharded_collection import (
    AdaptiveBucketing,
    GroupedShardedDynamicEmbedding,
    ShardedDynamicEmbedding,
    route_owner,
)
from recsys_examples_torch.parallel import mesh as pm

EMPTY = tcfg.EMPTY_KEY
VAL_TOL = dict(rtol=1e-5, atol=1e-7)
# rtol 1e-6; the atol covers jitted XLA, whose initializer rows differ from the
# eager ones by up to 1.4e-8 near 0 (VAL_TOL's atol)
EMB_TOL = dict(rtol=1e-6, atol=1e-7)
STEPS, T, DIM = 3, 96, 8
# grouped features, pooled tables and the cache run at this world size only
# (each JAX scenario compiles for some seconds)
EXTRAS_AT = (4,)     # (one world size)
TABLE_FIELDS = ("keys", "scores", "inserted", "evicted", "overflowed")


def table_options(cfg, opt, W, capacity=1024, bucket=8, mode="UNIFORM",
                  optimizer="rowwise_adagrad"):
    return (cfg.DynamicEmbTableOptions(
        embedding_dim=DIM, max_capacity=capacity, bucket_capacity=bucket,
        initializer_args=cfg.DynamicEmbInitializerArgs(
            mode=cfg.DynamicEmbInitializerMode[mode])),
        opt.SparseOptimizerArgs(optimizer=optimizer, learning_rate=0.1))


def port_table(W, **kw):
    return tbt.DynamicEmbeddingTable(*table_options(tcfg, topt, W, **kw), world_size=W)


def train_ids(step):
    rng = np.random.default_rng(100 + step)
    ids = (rng.zipf(1.2, size=T) % 400).astype(np.int64)
    ids[-5:] = EMPTY
    return ids, rng.standard_normal((T, DIM)).astype(np.float32)


def grouped_ids(step):
    rng = np.random.default_rng(200 + step)
    return {"item": rng.integers(1, 300, size=32).astype(np.int64),
            "user": rng.integers(1, 300, size=16).astype(np.int64)}


def pooled_batch(step):
    """(ids [T], offsets [B+1], grads [B, dim]) of 8 bags."""
    rng = np.random.default_rng(300 + step)
    lens = rng.integers(1, 9, size=8)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    ids = rng.integers(0, 200, size=int(offs[-1])).astype(np.int64)
    return ids, offs, rng.standard_normal((8, DIM)).astype(np.float32)


def cache_batches():
    """The key stream of tests/test_hybrid_and_planner.py's sharded prefetch
    test: a first batch, then four floods of fresh keys that evict. (The
    last batch, the keys then in the host tier, comes back from it.) No
    prefetch here evicts one of its own batch's keys, where the two packages
    differ by design (see dynamicemb/hybrid_storage.py)."""
    rng = np.random.default_rng(0)
    out = [rng.choice(4096, size=64, replace=False).astype(np.int64)]
    for i in range(4):
        out.append((rng.choice(4096, size=96, replace=False) + 8192 * (i + 1)).astype(np.int64))
    return out


def all_owned_by(rank, count, W, seed=0):
    """`count` distinct keys that all route to `rank` (the JAX test's
    adversarial skew)."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        cand = rng.integers(1, 2 ** 40, size=4096).astype(np.int64)
        sel = cand[route_owner(torch.from_numpy(cand), W).numpy() == rank]
        out.extend(int(k) for k in sel)
    return np.unique(np.array(out[:count], np.int64))[:count]


def chunk(a, W, r):
    """JAX's shard_map split of a flat array padded to a multiple of W."""
    n = -(-len(a) // W)
    pad = n * W - len(a)
    if pad:
        a = np.concatenate([a, np.full((pad,) + a.shape[1:], EMPTY if a.dtype == np.int64
                                       else 0, a.dtype)])
    return a[r * n:(r + 1) * n]


def block(a, W, r):
    """Rank r's contiguous block of a's rows (the first len % W one longer)."""
    return np.array_split(a, W)[r]


def state_np(state):
    return convert.dynamic_table_to_numpy(state)


def _worker(rank, world, out_dir):
    W, r = world, rank
    mesh = pm.make_mesh(-1, 1, "cpu")
    res = {}
    # ---- three train steps on JAX's token chunks, then an eval lookup
    sh = ShardedDynamicEmbedding(port_table(W), mesh, device="cpu")
    st = sh.init_state()
    steps = []
    for s in range(STEPS):
        ids, g = train_ids(s)
        st, emb, lr = sh.forward(st, torch.from_numpy(chunk(ids, W, r)))
        sh.backward(st, lr, torch.from_numpy(chunk(g, W, r)))
        n_recv = int((lr.recv_keys != EMPTY).sum())
        steps.append(dict(emb=emb.numpy(), slots=lr.slots[:n_recv].numpy(),
                          overflow=int(lr.num_overflow.sum())))
    _, emb, _ = sh.forward(st, torch.from_numpy(chunk(np.arange(380, 420), W, r)), train=False)
    res["train"] = dict(steps=steps, state=state_np(st), eval=emb.numpy())
    res["overflow"] = _overflow_case(mesh, W, r)
    if W not in EXTRAS_AT:
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        return
    # ---- grouped features: this rank's block of each feature's ids
    grp = GroupedShardedDynamicEmbedding(port_table(W), ("item", "user"), mesh, device="cpu")
    st = grp.init_state()
    embs = []
    for s in range(STEPS):
        ids = {k: torch.from_numpy(block(v, W, r)) for k, v in grouped_ids(s).items()}
        st, emb, lr = grp.forward(st, ids)
        grp.backward(st, lr, {k: torch.ones_like(v) * (1 + (k == "user")) for k, v in emb.items()})
        embs.append({k: v.numpy() for k, v in emb.items()})
    res["grouped"] = dict(emb=embs, state=state_np(st))
    # ---- pooled bags: this rank's block of samples
    pooled = PooledDynamicEmbedding(ShardedDynamicEmbedding(port_table(W), mesh, device="cpu"))
    st = pooled.init_state()
    outs = []
    for s in range(STEPS):
        ids, offs, g = pooled_batch(s)
        b0, b1 = r * 8 // W, (r + 1) * 8 // W
        st, out, lr = pooled.forward(st, torch.from_numpy(ids[offs[b0]:offs[b1]]),
                                     torch.from_numpy(offs[b0:b1 + 1] - offs[b0]))
        pooled.backward(st, lr, torch.from_numpy(g[b0:b1]))
        outs.append(out.numpy())
    res["pooled"] = dict(out=outs, state=state_np(st))
    # ---- the cache: each rank prefetches the global batch's keys it owns
    tbl = port_table(W, capacity=512, mode="DEBUG", optimizer="sgd")
    sh = ShardedDynamicEmbedding(tbl, mesh, device="cpu")
    hyb = HybridDynamicEmbedding(tbl, mesh=mesh, device="cpu")
    st = hyb.init_state()
    for keys in cache_batches() + [None]:
        if keys is None:        # the keys evicted to the ranks' host tiers
            keys = [None] * W
            torch.distributed.all_gather_object(keys, [k for k, _, _ in hyb.host.export()])
            keys = np.sort(np.concatenate([np.concatenate(k) for k in keys if k]))
        hyb.prefetch(st, keys)
        _, emb, lr = sh.forward(st, torch.from_numpy(block(keys, W, r)))
        sh.backward(st, lr, torch.ones_like(emb))
    res["cache"] = dict(state=state_np(st), stats=dict(hyb.stats),
                        host={int(k): (row.copy(), int(sc)) for ks, rs, ss in hyb.host.export()
                              for k, row, sc in zip(ks, rs, ss)})
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _overflow_case(mesh, W, r):
    """JAX's overflow batch: every key owned by rank 0."""
    sh = ShardedDynamicEmbedding(port_table(W, capacity=4096, mode="DEBUG", optimizer="sgd"),
                                 mesh, device="cpu")
    st = sh.init_state()
    hot = all_owned_by(0, 64 * W, W)
    st, emb, lr = sh.forward(st, torch.from_numpy(chunk(hot, W, r)))
    sh.backward(st, lr, torch.ones_like(emb))
    _, found = lookup(st.table, torch.from_numpy(hot))
    return dict(overflow=int(lr.num_overflow.sum()), found=found.numpy(),
                grew=AdaptiveBucketing([sh]).observe(lr.num_overflow.sum()),
                eval=sh.forward(st, torch.from_numpy(chunk(hot, W, r)), train=False)[1].numpy())


def _jax_side(W):
    """The same scenarios through the JAX package on a W-device mesh."""
    import jax
    import jax.numpy as jnp

    from recsys_examples_tpu.dynamicemb import batched_table as jbt
    from recsys_examples_tpu.dynamicemb import dynamicemb_config as jcfg
    from recsys_examples_tpu.dynamicemb import optimizer as jopt
    from recsys_examples_tpu.dynamicemb.hybrid_storage import HybridDynamicEmbedding as JHyb
    from recsys_examples_tpu.dynamicemb.pooled import PooledDynamicEmbedding as JPooled
    from recsys_examples_tpu.dynamicemb.sharded_collection import (
        GroupedShardedDynamicEmbedding as JGrouped,
        ShardedDynamicEmbedding as JSharded,
    )
    from recsys_examples_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(dp=W, tp=1, devices=jax.devices()[:W])

    def jitted(module):
        """module's forward (train and eval) and backward under jax.jit (an
        eager shard_map runs op by op; the tolerances hold XLA's fusion)."""
        fwd = jax.jit(module.forward, static_argnames="train")
        return fwd, jax.jit(module.backward)

    jtable = lambda **kw: jbt.DynamicEmbeddingTable(*table_options(jcfg, jopt, W, **kw),
                                                    world_size=W)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    out = {}
    sh = JSharded(jtable(), mesh)
    fwd, bwd = jitted(sh)
    st = sh.init_state()
    steps = []
    for s in range(STEPS):
        ids, g = train_ids(s)
        st, emb, lr = fwd(st, jnp.asarray(ids))
        st = bwd(st, lr, jnp.asarray(g))
        steps.append(dict(emb=np.asarray(emb), slots=np.asarray(lr.slots),
                          overflow=int(np.sum(lr.num_overflow))))
    _, emb, _ = fwd(st, jnp.asarray(np.arange(380, 420)), train=False)
    out["train"] = dict(steps=steps, state=as_np(st), eval=np.asarray(emb))

    sh = JSharded(jtable(capacity=4096, mode="DEBUG", optimizer="sgd"), mesh,
                  bucket_factor=1.0)
    fwd, bwd = jitted(sh)
    st = sh.init_state()
    hot = all_owned_by(0, 64 * W, W)
    st, emb, lr = fwd(st, jnp.asarray(hot))
    st = bwd(st, lr, jnp.ones_like(emb))
    keys = np.asarray(st.table.keys).reshape(-1)
    out["overflow"] = dict(overflow=int(np.sum(lr.num_overflow)), stored=np.isin(hot, keys))
    if W not in EXTRAS_AT:
        return out
    grp = JGrouped(jtable(), ("item", "user"), mesh=mesh)
    fwd, bwd = jitted(grp)
    st = grp.init_state()
    embs = []
    for s in range(STEPS):
        ids = {k: jnp.asarray(v) for k, v in grouped_ids(s).items()}
        st, emb, lr = fwd(st, ids)
        st = bwd(st, lr, {k: jnp.ones_like(v) * (1 + (k == "user"))
                                   for k, v in emb.items()})
        embs.append({k: np.asarray(v) for k, v in emb.items()})
    out["grouped"] = dict(emb=embs, state=as_np(st))

    pooled = JPooled(JSharded(jtable(), mesh))
    fwd, bwd = jitted(pooled)
    st = pooled.init_state()
    outs = []
    for s in range(STEPS):
        ids, offs, g = pooled_batch(s)
        st, o, lr = fwd(st, jnp.asarray(ids), jnp.asarray(offs, jnp.int32))
        st = bwd(st, lr, jnp.asarray(g))
        outs.append(np.asarray(o))
    out["pooled"] = dict(out=outs, state=as_np(st))

    tbl = jtable(capacity=512, mode="DEBUG", optimizer="sgd")
    sh, hyb = JSharded(tbl, mesh=mesh), JHyb(tbl, mesh=mesh)
    fwd, bwd = jitted(sh)
    st = hyb.init_state()
    with jax.set_mesh(mesh):
        for keys in cache_batches() + [None]:
            if keys is None:
                keys = np.sort(np.concatenate([k for k, _, _ in hyb.host.export()]))
            st = hyb.prefetch(st, keys)
            st, emb, lr = fwd(st, jnp.asarray(keys))
            st = bwd(st, lr, jnp.ones_like(emb))
    out["cache"] = dict(state=as_np(st), stats=dict(hyb.stats),
                        host={int(k): (row.copy(), int(sc)) for ks, rs, ss in hyb.host.export()
                              for k, row, sc in zip(ks, rs, ss)})

    return out


_RUNS = {}


def _both(W, tmp_path_factory):
    """(W, the port ranks' results, the JAX results), run once per W."""
    if W not in _RUNS:
        d = tmp_path_factory.mktemp(f"sharded_w{W}")
        pm.spawn_ranks(_worker, W, str(d), str(d))
        port = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(W)]
        _RUNS[W] = (W, port, _jax_side(W))
    return _RUNS[W]


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def both(request, tmp_path_factory):
    return _both(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def extras(tmp_path_factory):
    return _both(EXTRAS_AT[0], tmp_path_factory)


def _shard(jstate, W, r):
    """Rank r's shard of a stacked JAX table state, as numpy mappings."""
    return convert.dynamic_table_to_numpy(convert.dynamic_table_shard(
        {"table": {f: jstate.table.__getattribute__(f) for f in convert.HASH_TABLE_FIELDS},
         "counter": None, "step": jstate.step}, W, r))


def _assert_shard(tnp, jnp_, msg):
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(tnp["table"][f], jnp_["table"][f], err_msg=f"{msg} {f}")
    np.testing.assert_array_equal(tnp["step"], jnp_["step"], err_msg=f"{msg} step")
    for f in ("values", "opt"):
        if jnp_["table"][f] is not None:
            np.testing.assert_allclose(tnp["table"][f], jnp_["table"][f], **VAL_TOL,
                                       err_msg=f"{msg} {f}")


def test_train_steps_match_jax_mesh(both):
    W, port, jx = both
    for s in range(STEPS):
        emb = np.concatenate([p["train"]["steps"][s]["emb"] for p in port])[:T]
        # fresh rows at step 0; rows after s sparse optimizer steps later
        np.testing.assert_allclose(emb, jx["train"]["steps"][s]["emb"],
                                   **(EMB_TOL if s == 0 else VAL_TOL))
        jslots = np.split(jx["train"]["steps"][s]["slots"], W)
        for r, p in enumerate(port):
            got = p["train"]["steps"][s]
            assert got["overflow"] == 0 == jx["train"]["steps"][s]["overflow"]
            np.testing.assert_array_equal(got["slots"], jslots[r][:len(got["slots"])])
            assert (jslots[r][len(got["slots"]):] == -1).all()
    for r, p in enumerate(port):
        _assert_shard(p["train"]["state"], _shard(jx["train"]["state"], W, r), f"rank {r}")
        assert p["train"]["state"]["table"]["inserted"][0] > 0
    ev = np.concatenate([p["train"]["eval"] for p in port])[:40]
    np.testing.assert_allclose(ev, jx["train"]["eval"], **VAL_TOL)


def test_grouped_features_under_the_mesh(extras):
    W, port, jx = extras
    for s in range(STEPS):
        for k in ("item", "user"):
            got = np.concatenate([p["grouped"]["emb"][s][k] for p in port])
            np.testing.assert_allclose(got, jx["grouped"]["emb"][s][k], **EMB_TOL)
    for r, p in enumerate(port):
        _assert_shard(p["grouped"]["state"], _shard(jx["grouped"]["state"], W, r), f"rank {r}")


def test_pooled_table_under_the_mesh(extras):
    W, port, jx = extras
    for s in range(STEPS):
        got = np.concatenate([p["pooled"]["out"][s] for p in port])
        np.testing.assert_allclose(got, jx["pooled"]["out"][s], rtol=1e-6, atol=1e-7)
    for r, p in enumerate(port):
        _assert_shard(p["pooled"]["state"], _shard(jx["pooled"]["state"], W, r), f"rank {r}")


def test_cache_prefetch_under_the_mesh(extras):
    W, port, jx = extras
    for r, p in enumerate(port):
        _assert_shard(p["cache"]["state"], _shard(jx["cache"]["state"], W, r), f"rank {r}")
    stats = {k: sum(p["cache"]["stats"][k] for p in port) for k in jx["cache"]["stats"]}
    assert stats == jx["cache"]["stats"]
    assert stats["evict_flushes"] > 0 and stats["host_onboards"] > 0, stats
    host = {}
    for p in port:
        assert not host.keys() & p["cache"]["host"].keys()     # one owner per key
        host.update(p["cache"]["host"])
    assert host.keys() == jx["cache"]["host"].keys()
    for k, (row, sc) in jx["cache"]["host"].items():
        assert host[k][1] == sc
        np.testing.assert_allclose(host[k][0], row, **VAL_TOL)


def test_exact_exchange_stores_what_the_jax_cap_drops(both):
    W, port, jx = both
    assert jx["overflow"]["overflow"] > 0 and not jx["overflow"]["stored"].all()
    assert all(p["overflow"]["overflow"] == 0 and not p["overflow"]["grew"] for p in port)
    assert port[0]["overflow"]["found"].all()
    assert not any(p["overflow"]["found"].any() for p in port[1:])
    # every hot row trained: sgd on ones moved each off its DEBUG init
    hot = all_owned_by(0, 64 * W, W)
    ev = np.concatenate([p["overflow"]["eval"] for p in port])
    init = np.tile((hot % 100000) / 100000.0, (DIM, 1)).T
    assert (np.abs(ev - init).max(axis=1) > 1e-3).all()
