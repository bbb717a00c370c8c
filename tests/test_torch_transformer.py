"""The port's SID decoder blocks and mask helpers against flax's, on the
same numpy inputs and params: every branch of `MultiHeadAttention` (dense,
`kv_x`, `kv_cache`, `return_kv`, `beam_attn` with and without earlier
steps), a block, the stack, and the five helpers of `attention_mask.py`.
fp32; rtol/atol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch import convert
from recsys_examples_torch.modules import attention_mask as t_mask
from recsys_examples_torch.modules import transformer as t_tf
from recsys_examples_tpu.modules import attention_mask as j_mask
from recsys_examples_tpu.modules import transformer as j_tf

D, H, DH, FFN = 24, 2, 8, 40
TOL = dict(rtol=1e-5, atol=1e-5)
f = lambda rng, *s: rng.standard_normal(s).astype(np.float32)
tt = torch.from_numpy


def _f32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _randomize(params, rng):
    """Non-trivial biases and LayerNorm params (flax initialises them to
    0 / 1, which would hide a swapped or dropped one)."""
    return jax.tree.map(lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(np.float32),
                        params)


@pytest.fixture(scope="module")
def mha():
    rng = np.random.default_rng(0)
    jm = j_tf.MultiHeadAttention(H, DH)
    params = _randomize(_f32(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, D)))["params"]), rng)
    tm = t_tf.MultiHeadAttention(D, H, DH)
    tm.load_state_dict(convert.dense_state_dict(params))
    return jm, params, tm


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_mha_dense_branches(mha):
    jm, params, tm = mha
    rng = np.random.default_rng(1)
    B, N = 3, 7
    x, kv_x = f(rng, B, N, D), f(rng, B, 5, D)
    lens = np.array([7, 3, 1], np.int32)
    mask = np.array(j_tf.make_padded_causal_mask(jnp.asarray(lens), N))
    np.testing.assert_array_equal(t_tf.make_padded_causal_mask(tt(lens), N).numpy(), mask)
    apply = lambda *a, **k: jm.apply({"params": params}, *a, **k)
    _close(tm(tt(x)), apply(jnp.asarray(x)))
    # padding rows of the mask are fully masked: a uniform average, no NaN
    got = tm(tt(x), mask=tt(mask))
    assert torch.isfinite(got).all()
    _close(got, apply(jnp.asarray(x), mask=jnp.asarray(mask)))
    _close(tm(tt(x), kv_x=tt(kv_x)), apply(jnp.asarray(x), kv_x=jnp.asarray(kv_x)))
    out, (k, v) = tm(tt(x), mask=tt(mask), return_kv=True)
    jout, (jk, jv) = apply(jnp.asarray(x), mask=jnp.asarray(mask), return_kv=True)
    _close(out, jout), _close(k, jk), _close(v, jv)
    # one more token over the cached K/V
    x1 = f(rng, B, 1, D)
    out, (k2, v2) = tm(tt(x1), kv_cache=(k, v), return_kv=True)
    jout, (jk2, jv2) = apply(jnp.asarray(x1), kv_cache=(jk, jv), return_kv=True)
    assert k2.shape == (B, N + 1, H, DH)
    _close(out, jout), _close(k2, jk2), _close(v2, jv2)


@pytest.mark.parametrize("steps", [0, 2])
def test_mha_beam_branch(mha, steps):
    """The step's own K/V joins the earlier steps' with identity ancestry."""
    jm, params, tm = mha
    rng = np.random.default_rng(2)
    B, W, S = 2, 5, 9
    x = f(rng, B, W, D)
    ctx = dict(k_ctx=f(rng, B, S, H, DH), v_ctx=f(rng, B, S, H, DH),
               ctx_lens=np.array([9, 4], np.int32), k_beam=None, v_beam=None, ancestry=None)
    if steps:
        ctx.update(k_beam=f(rng, B, steps, W, H, DH), v_beam=f(rng, B, steps, W, H, DH),
                   ancestry=rng.integers(0, W, size=(B, steps, W)).astype(np.int32))
    conv = lambda fn: {k: None if v is None else fn(v) for k, v in ctx.items()}
    out, (k_new, v_new) = tm(tt(x), beam_attn=t_tf.BeamAttnInputs(**conv(tt)))
    jout, (jk, jv) = jm.apply({"params": params}, jnp.asarray(x),
                              beam_attn=j_tf.BeamAttnInputs(**conv(jnp.asarray), backend="jnp"))
    assert k_new.shape == (B, W, H, DH)
    _close(out, jout), _close(k_new, jk), _close(v_new, jv)


def test_block_and_stack():
    rng = np.random.default_rng(3)
    B, N, L = 2, 6, 2
    x = f(rng, B, N, D)
    lens = np.array([6, 2], np.int32)
    mask = np.array(j_tf.make_padded_causal_mask(jnp.asarray(lens), N))
    jb = j_tf.TransformerBlock(H, DH, FFN)
    bp = _randomize(_f32(jb.init(jax.random.PRNGKey(1), jnp.zeros((1, 3, D)), train=False)["params"]), rng)
    tb = t_tf.TransformerBlock(D, H, DH, FFN)
    tb.load_state_dict(convert.dense_state_dict(bp))
    _close(tb(tt(x), mask=tt(mask), train=False),
           jb.apply({"params": bp}, jnp.asarray(x), mask=jnp.asarray(mask), train=False))

    js = j_tf.TransformerStack(L, H, DH, FFN)
    sp = _randomize(_f32(js.init(jax.random.PRNGKey(2), jnp.zeros((1, 3, D)), train=False)["params"]), rng)
    ts = t_tf.TransformerStack(D, L, H, DH, FFN)
    ts.load_state_dict(convert.dense_state_dict(sp))
    out, kvs = ts(tt(x), mask=tt(mask), train=False, return_kv=True)
    jout, jkvs = js.apply({"params": sp}, jnp.asarray(x), mask=jnp.asarray(mask),
                          train=False, return_kv=True)
    _close(out, jout)
    assert len(kvs) == L
    for (k, v), (jk, jv) in zip(kvs, jkvs):
        _close(k, jk), _close(v, jv)
    # the per-layer caches of the prefill feed a one-token step
    x1 = f(rng, B, 1, D)
    _close(ts(tt(x1), kv_caches=kvs, train=False),
           js.apply({"params": sp}, jnp.asarray(x1), kv_caches=jkvs, train=False))
    # a beam step through every layer
    W = 4
    xb = f(rng, B, W, D)
    ctx_lens = np.array([6, 2], np.int32)
    t_in = [t_tf.BeamAttnInputs(k, v, tt(ctx_lens), None, None, None) for k, v in kvs]
    j_in = [j_tf.BeamAttnInputs(k, v, jnp.asarray(ctx_lens), None, None, None, backend="jnp")
            for k, v in jkvs]
    out, new_kv = ts(tt(xb), train=False, beam_attn=t_in)
    jout, jnew = js.apply({"params": sp}, jnp.asarray(xb), train=False, beam_attn=j_in)
    _close(out, jout)
    for (k, v), (jk, jv) in zip(new_kv, jnew):
        _close(k, jk), _close(v, jv)


def test_dropout_needs_a_generator_and_eval_ignores_it():
    blk = t_tf.TransformerBlock(D, H, DH, FFN, dropout=0.5)
    x = torch.randn(2, 3, D)
    with pytest.raises(ValueError, match="Generator"):
        blk(x, train=True)
    a = blk(x, train=True, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(a, blk(x, train=False))
    assert torch.equal(blk(x, train=False), blk(x, train=False))


LENS = np.array([6, 3, 0, 5], np.int32)
TGTS = np.array([2, 0, 0, 5], np.int32)


@pytest.mark.parametrize("name,args", [
    ("padded_causal_mask", (LENS,)),
    ("history_causal_target_mask", (LENS, TGTS)),
    ("target_aware_causal_mask", (LENS, TGTS)),
])
def test_masks_match(name, args):
    N = 7
    want = np.asarray(getattr(j_mask, name)(*map(jnp.asarray, args), N))
    got = getattr(t_mask, name)(*map(tt, args), N)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_interval_converters_match():
    row = np.array([1, 1, 0, 0, 1, 0, 1], bool)
    want = np.asarray(j_mask.dense_mask_to_intervals(jnp.asarray(row)))
    got = t_mask.dense_mask_to_intervals(tt(row))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t_mask.intervals_to_dense_mask(got).numpy(), row)
    np.testing.assert_array_equal(
        np.asarray(j_mask.intervals_to_dense_mask(jnp.asarray(want))), row)
