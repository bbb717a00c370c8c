"""The port's jagged HSTU attention (plain K1-K4 and the autograd Function
on CPU tensors) against the JAX package: `hstu_mha_reference` and the
Pallas `hstu_attn_varlen` / `hstu_attn_varlen_rab` in interpret mode, on the
shapes and mask cases of tests/test_pallas_hstu_attention.py, and the
relative attention bias module against flax's. fp32 inputs from a numpy
seed."""
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
from recsys_examples_tpu.ops.pallas.hstu_attention import hstu_attn_varlen_rab as j_pallas_rab

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
    # a zero bias changes nothing
    assert torch.equal(t_attn(q, k, v, so, 8, alpha=0.1, rab=torch.zeros(1, 1, 8, 8)), out)
    # the int8 forward is ported (tests/test_torch_quantized.py): it runs, in
    # bf16, close to the fp32 forward; what it still refuses is a bias
    q8 = t_attn(q, k, v, so, 8, alpha=0.1, quantized=True)
    assert q8.dtype == torch.bfloat16 and not q8[5:].any()
    assert (q8.float() - out).abs().max() < 0.05 * out.abs().max()
    with pytest.raises(ValueError):
        t_attn(q, k, v, so, 8, quantized=True, rab=torch.zeros(1, 1, 8, 8))


# ------------------------------------------------------------ K4: rab
# (rab shape, lengths, max_seqlen, mask case): the two cases of
# tests/test_pallas_hstu_attention.py:100-183, then the other broadcast and
# a contextual + target-group mask, and an odd row stride (N 131) as the
# model's 8195 has
RAB_CASES = {
    "full": ((2, 2, 256, 256), [200, 256], 256, "causal"),
    "broadcast_batch": ((1, 2, 128, 128), [100, 128], 128, "causal"),
    "broadcast_both": ((1, 1, 128, 128), [100, 0, 28], 128, "causal"),
    "broadcast_head_ctx_tgt": ((3, 1, 256, 256), [200, 37, 128], 256, "ctx_tgt_group"),
    "broadcast_batch_window": ((1, 2, 128, 128), [100, 128], 128, "local_window"),
    "broadcast_batch_odd_n": ((1, 2, 131, 131), [100, 131, 67], 131, "causal"),
}


def _rab_inputs(name):
    shape, lens, n, case = RAB_CASES[name]
    rng = np.random.default_rng(7)
    total = int(sum(lens))
    mk = lambda: rng.standard_normal((total + 4, 2, 128)).astype(np.float32)
    q, k, v, w = mk(), mk(), mk(), mk()
    rab = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ctx, tgt, kw = CASES[case]
    if ctx is not None:
        ctx, tgt = ctx[: len(lens)], tgt[: len(lens)]
    return q, k, v, w, rab, offs, n, ctx, tgt, kw


@pytest.mark.parametrize("name", list(RAB_CASES))
def test_rab_autograd_matches_pallas_interpret(name):
    """Forward and dq/dk/dv/drab of `hstu_attn_varlen(rab=...)` (plain K4 on
    CPU tensors) against `hstu_attn_varlen_rab` in interpret mode; fp32,
    rtol/atol 3e-4 as the JAX package's own test."""
    q, k, v, w, rab, offs, n, ctx, tgt, kw = _rab_inputs(name)
    aux = (jnp.asarray(offs), None if ctx is None else jnp.asarray(ctx),
           None if tgt is None else jnp.asarray(tgt))

    def f(q, k, v, rab):
        return j_pallas_rab(q, k, v, rab, aux, max_seqlen=n, alpha=0.08, scaling_seqlen=n,
                            interpret=True, **kw)

    jin = tuple(map(jnp.asarray, (q, k, v, rab)))
    want_out = f(*jin)
    want_grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(w)),
                          argnums=(0, 1, 2, 3))(*jin)
    t = lambda x: None if x is None else torch.from_numpy(x)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v, rab)]
    out = t_attn(*leaves[:3], t(offs), n, num_contextuals=t(ctx), num_targets=t(tgt),
                 alpha=0.08, scaling_seqlen=n, rab=leaves[3], **kw)
    (out * torch.from_numpy(w)).sum().backward()
    tol = dict(rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **tol)
    for tag, x, wg in zip(("dq", "dk", "dv", "drab"), leaves, want_grads):
        assert x.grad.shape == wg.shape and x.grad.dtype == torch.float32
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(wg), **tol, err_msg=tag)
    # cells past max_seqlen take no gradient
    assert not leaves[3].grad[:, :, n:].any() and not leaves[3].grad[:, :, :, n:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_ref_drab_matches_autograd(dtype):
    """The explicit plain backward's drab (broadcast dims summed, in rab's
    dtype) against autograd of the plain forward, with a bias larger than
    max_seqlen."""
    q, k, v, w, rab, offs, n, ctx, tgt, kw = _rab_inputs("broadcast_head_ctx_tgt")
    rab = np.pad(rab, ((0, 0), (0, 0), (0, 16), (0, 4)), constant_values=0.5)
    t = lambda x: None if x is None else torch.from_numpy(x)
    ref_kw = dict(num_contextuals=t(ctx), num_targets=t(tgt), **_ref_kw(kw))
    ref_kw["scaling_seqlen"] = n
    rab_t = torch.from_numpy(rab).to(dtype)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    bias = rab_t.clone().requires_grad_()
    out = t_ref(n, 0.08, *leaves, t(offs), rab=bias, **ref_kw)
    (out * torch.from_numpy(w)).sum().backward()
    explicit = hstu_attn_bwd_ref(n, 0.08, *map(torch.from_numpy, (q, k, v, w)), t(offs),
                                 rab=rab_t, **ref_kw)
    assert explicit[3].dtype == dtype and explicit[3].shape == rab_t.shape
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-3)
    for tag, e, x in zip(("dq", "dk", "dv", "drab"), explicit, leaves + [bias]):
        np.testing.assert_allclose(e.float().numpy(), x.grad.float().numpy(), **tol,
                                   err_msg=tag)
    assert not explicit[3][:, :, n:].any() and not explicit[3][:, :, :, n:].any()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("buckets,max_distance", [(128, 1024), (32, 128), (64, 100)])
def test_t5_relative_buckets_match_jax(causal, buckets, max_distance):
    """Every rel in [-2 max_distance, 2 max_distance]: a last-bit difference
    in the fp32 log ratio would flip a bucket at a boundary."""
    from recsys_examples_torch.modules.position_encoder import t5_relative_buckets as tb
    from recsys_examples_tpu.modules.position_encoder import t5_relative_buckets as jb

    rel = np.arange(-2 * max_distance, 2 * max_distance + 1, dtype=np.int32)
    want = np.asarray(jb(jnp.asarray(rel), buckets, max_distance, causal))
    got = tb(torch.from_numpy(rel.astype(np.int64)), buckets, max_distance, causal).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0 and got.max() == buckets - 1


@pytest.mark.parametrize("causal", [True, False])
def test_relative_attention_bias_matches_flax(causal):
    """The dense bias [1, H, N, N] and the gradient of its param, N beyond
    max_distance included."""
    from recsys_examples_torch.modules.position_encoder import RelativeAttentionBias as TRab
    from recsys_examples_tpu.modules.position_encoder import RelativeAttentionBias as JRab

    n, heads = 150, 3
    jm = JRab(num_heads=heads, num_buckets=32, max_distance=64, causal=causal)
    params = jm.init(jax.random.PRNGKey(0), n)
    w = np.asarray(params["params"]["rel_bias"], np.float32)
    params = {"params": {"rel_bias": jnp.asarray(w)}}
    tm = TRab(heads, 32, 64, causal)
    tm.load_state_dict({"rel_bias": torch.from_numpy(w.copy())})
    got = tm(n)
    want = np.asarray(jm.apply(params, n))
    assert got.shape == want.shape == (1, heads, n, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.detach().numpy(), want)
    g = np.random.default_rng(1).standard_normal(want.shape).astype(np.float32)
    (got * torch.from_numpy(g)).sum().backward()
    jg = jax.grad(lambda p: jnp.sum(jm.apply(p, n) * g))(params)["params"]["rel_bias"]
    np.testing.assert_allclose(tm.rel_bias.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-4)
    # flax's init: normal(0.02)
    tm.init_weights(torch.Generator().manual_seed(0))
    assert 0.01 < tm.rel_bias.std().item() < 0.03
