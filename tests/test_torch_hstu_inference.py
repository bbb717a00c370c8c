"""HSTU inference block: the port against the JAX package on the paged and
the gather path, with flax params carried over by `convert.py` (fp32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from recsys_examples_torch import convert
from recsys_examples_torch.inference.hstu_inference import (
    HSTUBlockInference as TBlock,
    strip_cached_tokens as t_strip,
)
from recsys_examples_torch.modules.config import HSTUConfig as THSTUConfig
from recsys_examples_tpu.inference.hstu_inference import (
    HSTUBlockInference as JBlock,
    strip_cached_tokens as j_strip,
)
from recsys_examples_tpu.modules.config import HSTUConfig, KernelBackend

L, D, H, DH, PG, MAXP, B, S = 2, 32, 2, 16, 4, 4, 3, 6
TOL = dict(rtol=1e-4, atol=1e-5)


def _configs(learnable_out):
    kw = dict(hidden_size=D, num_layers=L, num_attention_heads=H,
              kv_channels=DH, learnable_output_layernorm=learnable_out)
    return (HSTUConfig(**kw, kernel_backend=KernelBackend.JNP,
                       dtype=jnp.float32),
            THSTUConfig(**kw, dtype=torch.float32))


def _inputs(seed, with_targets):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    nc = MAXP * PG
    return dict(
        x=f(B, S, D),
        ck=f(L, B, nc, H, DH), cv=f(L, B, nc, H, DH),
        cached=np.asarray([0, 7, nc - S], np.int32),
        new_lens=np.asarray([S, 3, 5], np.int32),
        tgt=np.asarray([2, 1, 0], np.int32) if with_targets else None,
        k_pages=f(L, 16, PG, H, DH), v_pages=f(L, 16, PG, H, DH),
        page_table=rng.permutation(16)[: B * MAXP].reshape(B, MAXP)
        .astype(np.int32),
    )


def _models(jcfg, tcfg, inp, seed):
    jmod = JBlock(jcfg)
    params = nn.unbox(jmod.init(
        jax.random.PRNGKey(seed), jnp.asarray(inp["x"]), jnp.asarray(inp["ck"]),
        jnp.asarray(inp["cv"]), jnp.asarray(inp["cached"]),
        jnp.asarray(inp["new_lens"]), None, 32,
    )["params"])
    # perturb every param so scales and biases are not their init values
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape)
        .astype(np.float32), params)
    sd = convert.dense_state_dict({"hstu_block": params, "head": {}})
    tmod = TBlock(tcfg)
    tmod.load_state_dict({k[len("hstu_block."):]: v for k, v in sd.items()})
    return jmod, params, tmod


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("with_targets", [False, True])
@pytest.mark.parametrize("learnable_out", [False, True])
def test_block_matches_jax(paged, with_targets, learnable_out):
    jcfg, tcfg = _configs(learnable_out)
    inp = _inputs(int(paged) + 2 * int(with_targets), with_targets)
    jmod, params, tmod = _models(jcfg, tcfg, inp, seed=3)
    j = lambda k: None if inp[k] is None else jnp.asarray(inp[k])
    t = lambda k: None if inp[k] is None else torch.from_numpy(inp[k])
    if paged:
        jkw = dict(paged=(j("k_pages"), j("v_pages"), j("page_table")))
        tkw = dict(paged=(t("k_pages"), t("v_pages"), t("page_table")))
        jc = tc = None
        jcv = tcv = None
    else:
        jkw = tkw = {}
        jc, jcv, tc, tcv = j("ck"), j("cv"), t("ck"), t("cv")
    want = jmod.apply({"params": params}, j("x"), jc, jcv, j("cached"),
                      j("new_lens"), j("tgt"), 32, **jkw)
    with torch.no_grad():
        got = tmod(t("x"), tc, tcv, t("cached"), t("new_lens"), t("tgt"), 32,
                   **tkw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_strip_cached_tokens_matches_jax():
    rng = np.random.default_rng(0)
    vals = rng.integers(1, 100, size=(4, 10)).astype(np.int64)
    feats = rng.standard_normal((4, 10, 3)).astype(np.float32)
    lengths = np.asarray([10, 0, 7, 4], np.int32)       # a zero-length user
    cached = np.asarray([3, 0, 7, 1], np.int32)
    for v in (vals, feats):
        jo, jn = j_strip(jnp.asarray(v), jnp.asarray(lengths),
                         jnp.asarray(cached), 8)
        to, tn = t_strip(torch.from_numpy(v), torch.from_numpy(lengths),
                         torch.from_numpy(cached), 8)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert not to.numpy()[1].any()
