"""KV-cached ranking inference end to end: the port's InferenceRankingGR,
RankingServer and DynamicBatcher against the JAX package's, with the same
params, item table and requests (fp32)."""
import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from recsys_examples_torch import convert
from recsys_examples_torch.inference import hstu_serving as tserve
from recsys_examples_torch.inference.inference_ranking_gr import (
    InferenceDenseModule as TDense,
    InferenceRankingGR as TRunner,
)
from recsys_examples_torch.inference.kvcache import (
    KVCacheConfig as TKVConfig,
    lookup_kvcache as t_lookup,
)
from recsys_examples_torch.modules.config import HSTUConfig as THSTUConfig
from recsys_examples_tpu.dynamicemb.batched_table import DynamicEmbeddingTable
from recsys_examples_tpu.dynamicemb.dynamicemb_config import (
    DynamicEmbInitializerArgs,
    DynamicEmbInitializerMode,
    DynamicEmbTableOptions,
)
from recsys_examples_tpu.dynamicemb.exportable_tables import freeze_table
from recsys_examples_tpu.dynamicemb.optimizer import SparseOptimizerArgs
from recsys_examples_tpu.inference import hstu_serving as jserve
from recsys_examples_tpu.inference.inference_ranking_gr import (
    InferenceDenseModule as JDense,
    InferenceRankingGR as JRunner,
)
from recsys_examples_tpu.inference.kvcache import KVCacheConfig
from recsys_examples_tpu.modules.config import HSTUConfig, KernelBackend

TOL = dict(rtol=1e-4, atol=1e-5)
MODEL = dict(hidden_size=16, num_layers=2, num_attention_heads=2,
             kv_channels=8)
KV = dict(num_layers=2, num_heads=2, head_dim=8, page_size=4, num_pages=64,
          max_users=8, max_pages_per_user=8)
DIRECTORY = ("user_ids", "user_len", "user_pages", "user_lru", "page_owner",
             "clock")


def _build():
    """A JAX runner and the port's twin: same params, table and cache."""
    jcfg = HSTUConfig(**MODEL, kernel_backend=KernelBackend.JNP,
                      dtype=jnp.float32)
    tbl = DynamicEmbeddingTable(
        DynamicEmbTableOptions(
            embedding_dim=16, max_capacity=256, bucket_capacity=16,
            initializer_args=DynamicEmbInitializerArgs(
                mode=DynamicEmbInitializerMode.NORMAL, std_dev=0.3
            ),
        ),
        SparseOptimizerArgs(optimizer="sgd"),
    )
    st = tbl.init_state()
    st, _, _ = tbl.forward_train(st, jnp.arange(1, 100, dtype=jnp.int64))
    frozen = freeze_table(tbl, st)
    mod = JDense(jcfg, head_arch=(8, 1))
    x = jnp.zeros((2, 8, 16), jnp.float32)
    ck = jnp.zeros((2, 2, 0, 2, 8), jnp.float32)
    params = nn.unbox(mod.init(
        jax.random.PRNGKey(0), x, ck, ck, jnp.zeros((2,), jnp.int32),
        jnp.full((2,), 8, jnp.int32), None, 32,
    )["params"])
    jr = JRunner(config=jcfg, kv_config=KVCacheConfig(**KV, dtype=jnp.float32),
                 dense_params=params, item_table=frozen, head_arch=(8, 1))
    jr.init_cache()

    tcfg = THSTUConfig(**MODEL, dtype=torch.float32)
    dense = TDense(tcfg, head_arch=(8, 1))
    dense.load_state_dict(convert.dense_state_dict(
        jax.tree.map(np.asarray, params)))
    tr = TRunner(tcfg, TKVConfig(**KV, dtype=torch.float32), dense,
                 convert.table_state(np.asarray(frozen.keys),
                                     np.asarray(frozen.values)),
                 device="cpu")
    tr.init_cache()
    return jr, tr


def _valid_rows(logits, new_lens):
    return [np.asarray(logits)[b, :n] for b, n in enumerate(np.asarray(new_lens))]


def _assert_kv_same(jr, tr):
    got = convert.kvcache_to_numpy(tr.kv_state)
    for f in DIRECTORY:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jr.kv_state, f)),
                                      err_msg=f)
    for f in ("k_pages", "v_pages"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(jr.kv_state, f)),
                                   **TOL)


@pytest.mark.parametrize("paged", [False, True])
def test_two_call_cache_flow_matches_jax(paged):
    jr, tr = _build()
    rng = np.random.default_rng(0)
    users = np.asarray([101, 202], np.int64)
    seq = rng.integers(1, 99, size=(2, 12)).astype(np.int64)
    ncand = np.asarray([2, 2], np.int32)
    for lens in ([8, 8], [12, 12]):      # call 2 recomputes only 6 new tokens
        lens = np.asarray(lens, np.int32)
        jl, jn = jr.forward_with_kvcache(
            jnp.asarray(users), jnp.asarray(seq), jnp.asarray(lens),
            jnp.asarray(ncand), 8, use_paged_kernel=paged)
        tl, tn = tr.forward_with_kvcache(users, seq, lens, ncand, 8,
                                         use_paged_kernel=paged)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        for g, w in zip(_valid_rows(tl, tn), _valid_rows(jl, jn)):
            np.testing.assert_allclose(g, w, **TOL)
        _assert_kv_same(jr, tr)
    np.testing.assert_array_equal(tn.numpy(), [6, 6])
    _, cached = t_lookup(tr.kv_state, torch.from_numpy(users))
    np.testing.assert_array_equal(cached.numpy(), [10, 10])

    # the port's warm candidates equal its own fresh full recompute
    _, fresh = _build()
    fresh.module.load_state_dict(tr.module.state_dict())
    fl, _ = fresh.forward_with_kvcache(users, seq, np.asarray([12, 12]),
                                       ncand, 12, use_paged_kernel=paged)
    np.testing.assert_allclose(tl[:, 4:6].numpy(), fl[:, 10:12].numpy(), **TOL)


def _requests():
    rng = np.random.default_rng(1)
    return ([11, 22, 11],
            [rng.integers(1, 99, size=(n,)).astype(np.int64) for n in (6, 9, 7)],
            [2, 3, 1])


def test_ranking_server_matches_jax():
    jr, tr = _build()
    js = jserve.RankingServer(jr, seq_buckets=(8, 16))
    ts = tserve.RankingServer(tr, seq_buckets=(8, 16))
    users, seqs, ncs = _requests()
    for _ in range(2):                   # the second round hits the cache
        want = js.predict_batch(users, seqs, ncs)
        got = ts.predict_batch(users, seqs, ncs)
        assert [g.shape for g in got] == [(n,) for n in ncs]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
    assert ts.metrics["requests"] == 6 and ts.metrics["batches"] == 2
    _assert_kv_same(jr, tr)


def test_dynamic_batcher_matches_jax():
    jr, tr = _build()
    users, seqs, ncs = _requests()

    async def drive(mod, runner):
        srv = mod.RankingServer(runner, max_batch=8, seq_buckets=(8, 16))
        b = mod.DynamicBatcher(srv, batch_window_ms=50.0)
        outs = await asyncio.gather(
            *(b.submit(u, s, n) for u, s, n in zip(users, seqs, ncs)))
        m = b.get_metrics()
        assert m["engine_batches"] == 1, m      # coalesced
        with pytest.raises(mod.RequestTimeoutError):
            await b.submit(9, seqs[0], 1, timeout_s=-1.0)
        with pytest.raises(mod.QueueFullError):
            await mod.DynamicBatcher(srv, max_queue=0).submit(1, seqs[0], 1)
        with pytest.raises(ValueError):         # oversize: fails at the door
            await b.submit(1, np.arange(1, 40), 1)
        return outs

    want = asyncio.run(drive(jserve, jr))
    got = asyncio.run(drive(tserve, tr))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
