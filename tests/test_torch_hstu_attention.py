"""The port's jagged HSTU attention (plain K1-K3 and the autograd Function
on CPU tensors) against the JAX package: `hstu_mha_reference` and the
Pallas `hstu_attn_varlen` in interpret mode, on the shapes and mask cases
of tests/test_pallas_hstu_attention.py. fp32 inputs from a numpy seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch.ops.hstu_attention import hstu_attn_varlen as t_attn
from recsys_examples_torch.ops.hstu_attention_ref import (
    hstu_attn_bwd_ref,
    hstu_mha_reference as t_ref,
)
from recsys_examples_tpu.ops.hstu_attention_ref import hstu_mha_reference as j_ref
from recsys_examples_tpu.ops.pallas.hstu_attention import hstu_attn_varlen as j_pallas

H, D, N = 2, 128, 256
LENGTHS = np.array([200, 37, 128], np.int32)
T = 512
OFFSETS = np.concatenate([[0], np.cumsum(LENGTHS)]).astype(np.int32)
ALPHA = 0.08

CASES = {
    "causal": (None, None, {}),
    "ctx_tgt_group": (np.array([3, 2, 0], np.int32), np.array([10, 4, 6], np.int32),
                      dict(target_group_size=2)),
    "noncausal": (None, None, dict(causal=False)),
    "local_window": (None, None, dict(max_attn_len=64)),
}


@pytest.fixture(scope="module")
def qkvw():
    rng = np.random.default_rng(0)

    def mk():
        x = rng.standard_normal((T, H, D)).astype(np.float32) * 0.3
        x[OFFSETS[-1]:] = 0
        return x

    return mk(), mk(), mk(), rng.standard_normal((T, H, D)).astype(np.float32)


def _torch_args(ctx, tgt):
    t = lambda x: None if x is None else torch.from_numpy(x)
    return torch.from_numpy(OFFSETS), t(ctx), t(tgt)


def _ref_kw(kw):
    return dict(causal=kw.get("causal", True), max_attn_len=kw.get("max_attn_len", 0),
                target_group_size=kw.get("target_group_size", 1), scaling_seqlen=N)


def _port_grads(qkv, w, ctx, tgt, kw, fn):
    leaves = [torch.tensor(x, requires_grad=True) for x in qkv]
    out = fn(*leaves)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("case", list(CASES))
def test_plain_forward_matches_jax_reference(qkvw, case):
    q, k, v, _ = qkvw
    ctx, tgt, kw = CASES[case]
    so, nc, nt = _torch_args(ctx, tgt)
    got = t_ref(N, ALPHA, *map(torch.from_numpy, (q, k, v)), so, num_contextuals=nc,
                num_targets=nt, **_ref_kw(kw))
    want = j_ref(N, ALPHA, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 jnp.asarray(OFFSETS), num_contextuals=None if ctx is None else jnp.asarray(ctx),
                 num_targets=None if tgt is None else jnp.asarray(tgt), **_ref_kw(kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", ["causal", "ctx_tgt_group"])
def test_autograd_matches_pallas_interpret(qkvw, case):
    """Forward and dq/dk/dv of the port's `hstu_attn_varlen` (plain K1-K3 on
    CPU tensors) against the Pallas kernels run in interpret mode."""
    q, k, v, w = qkvw
    ctx, tgt, kw = CASES[case]
    aux = (jnp.asarray(OFFSETS), None if ctx is None else jnp.asarray(ctx),
           None if tgt is None else jnp.asarray(tgt))

    def f(q, k, v):
        return j_pallas(q, k, v, aux, max_seqlen=N, alpha=ALPHA, scaling_seqlen=N,
                        interpret=True, **kw)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_out = f(jq, jk, jv)
    want_grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(w)),
                          argnums=(0, 1, 2))(jq, jk, jv)
    so, nc, nt = _torch_args(ctx, tgt)
    got_out, got_grads = _port_grads(
        (q, k, v), w, ctx, tgt, kw,
        lambda q_, k_, v_: t_attn(q_, k_, v_, so, N, num_contextuals=nc,
                                  num_targets=nt, alpha=ALPHA, scaling_seqlen=N, **kw))
    np.testing.assert_allclose(got_out, np.asarray(want_out), rtol=1e-4, atol=1e-6)
    for name, g, wg in zip(("dq", "dk", "dv"), got_grads, want_grads):
        np.testing.assert_allclose(g, np.asarray(wg), rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("case", list(CASES) + ["window_min_full"])
def test_bwd_ref_and_function_match_autograd(qkvw, case):
    """`hstu_attn_bwd_ref` (the plain K2/K3, explicit formulas) and the
    autograd Function on CPU tensors against autograd of the plain forward."""
    q, k, v, w = qkvw
    if case == "window_min_full":
        ctx, tgt, kw = None, np.array([10, 4, 6], np.int32), dict(max_attn_len=16)
        extra = dict(min_full_attn_seq_len=32)
    else:
        (ctx, tgt, kw), extra = CASES[case], {}
    so, nc, nt = _torch_args(ctx, tgt)
    ref_kw = dict(num_contextuals=nc, num_targets=nt, **_ref_kw(kw), **extra)
    want_out, want = _port_grads(
        (q, k, v), w, ctx, tgt, kw, lambda *a: t_ref(N, ALPHA, *a, so, **ref_kw))
    explicit = hstu_attn_bwd_ref(N, ALPHA, *map(torch.from_numpy, (q, k, v)),
                                 torch.from_numpy(w), so, **ref_kw)
    fn_out, fn_grads = _port_grads(
        (q, k, v), w, ctx, tgt, kw,
        lambda *a: t_attn(*a, so, N, num_contextuals=nc, num_targets=nt, alpha=ALPHA,
                          scaling_seqlen=N, **kw, **extra))
    np.testing.assert_array_equal(fn_out, want_out)
    for name, e, f_, wg in zip(("dq", "dk", "dv"), explicit, fn_grads, want):
        np.testing.assert_allclose(e.numpy(), wg, rtol=1e-5, atol=1e-7, err_msg=name)
        np.testing.assert_array_equal(f_, e.numpy(), err_msg=name)
        assert not e[OFFSETS[-1]:].any(), name   # rows no sequence owns


def test_zero_length_sequence_and_unported_options():
    rng = np.random.default_rng(3)
    lens = np.array([0, 5, 0], np.int32)
    so = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(np.int32))
    q, k, v = (torch.from_numpy(rng.standard_normal((7, 1, 32)).astype(np.float32))
               for _ in range(3))
    out = t_attn(q, k, v, so, 8, alpha=0.1)
    assert out.shape == (7, 1, 32) and not out[5:].any() and out[:5].abs().sum() > 0
    with pytest.raises(NotImplementedError):
        t_attn(q, k, v, so, 8, rab=torch.zeros(1, 1, 8, 8))
    with pytest.raises(NotImplementedError):
        t_attn(q, k, v, so, 8, quantized=True)
