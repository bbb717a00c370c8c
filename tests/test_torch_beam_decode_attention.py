"""Beam-decode attention: the port's plain version (and its wrapper on CPU
tensors) against the JAX package's jnp twin and its Pallas kernel run in
interpret mode. fp32 inputs from a numpy seed go to both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch.ops.beam_decode_attention import (
    beam_decode_attn as t_attn,
    beam_decode_attn_ref as t_ref,
)
from recsys_examples_tpu.ops.pallas.beam_decode_attention import (
    beam_decode_attn as j_attn,
    beam_decode_attn_ref as j_ref,
)


def _case(seed, B, W, H, Hkv, D, S, N, ctx_lens=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    case = dict(q=f(B, W, H, D), k_ctx=f(B, S, Hkv, D), v_ctx=f(B, S, Hkv, D),
                ctx_lens=(rng.integers(1, S + 1, size=B) if ctx_lens is None
                          else np.asarray(ctx_lens)).astype(np.int32),
                k_beam=None, v_beam=None, ancestry=None)
    if N:
        # random, non-identity ancestry: several beams share a slot
        case.update(k_beam=f(B, N, W, Hkv, D), v_beam=f(B, N, W, Hkv, D),
                    ancestry=rng.integers(0, W, size=(B, N, W)).astype(np.int32))
    return case


def _args(case, conv):
    return [None if case[k] is None else conv(case[k]) for k in (
        "q", "k_ctx", "v_ctx", "ctx_lens", "k_beam", "v_beam", "ancestry")]


@pytest.mark.parametrize("N", [0, 1, 3])
@pytest.mark.parametrize("Hkv", [4, 2])
def test_plain_matches_jax_ref(N, Hkv):
    # ragged context lengths: one key, mid, full
    case = _case(0, B=3, W=5, H=4, Hkv=Hkv, D=16, S=11, N=N, ctx_lens=[1, 6, 11])
    want = np.asarray(j_ref(*_args(case, jnp.asarray), sm_scale=0.3))
    got = t_ref(*_args(case, torch.from_numpy), sm_scale=0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("N,Hkv", [(0, 4), (1, 4), (3, 2)])
def test_plain_matches_pallas_interpret(N, Hkv):
    """As tests/test_beam_decode_attention.py runs the kernel on the CPU."""
    case = _case(1, B=2, W=8, H=4, Hkv=Hkv, D=128, S=384, N=N)
    scale = 1.0 / 128 ** 0.5
    want = np.asarray(j_attn(*_args(case, jnp.asarray), sm_scale=scale,
                             backend="pallas", interpret=True, block_ctx=128))
    got = t_ref(*_args(case, torch.from_numpy), sm_scale=scale).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_no_key_at_all_follows_kernel():
    """ctx_len = 0 with N = 0: the Pallas kernel returns 0 (its sum l is 0
    and the divide is guarded), the jnp twin the mean of V (a softmax over
    -1e30 everywhere is uniform); the port follows the kernel. The rows that
    do have keys agree with both."""
    case = _case(2, B=2, W=8, H=2, Hkv=2, D=128, S=128, N=0, ctx_lens=[0, 77])
    scale = 1.0 / 128 ** 0.5
    kernel = np.asarray(j_attn(*_args(case, jnp.asarray), sm_scale=scale,
                               backend="pallas", interpret=True, block_ctx=128))
    twin = np.asarray(j_ref(*_args(case, jnp.asarray), sm_scale=scale))
    got = t_ref(*_args(case, torch.from_numpy), sm_scale=scale).numpy()
    assert not kernel[0].any() and not got[0].any()
    np.testing.assert_allclose(twin[0], np.broadcast_to(
        case["v_ctx"][0].mean(0)[None], twin[0].shape), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1], kernel[1], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[1], twin[1], rtol=2e-5, atol=2e-5)
    # with a beam tail the empty context is no special case
    case = _case(3, B=2, W=4, H=2, Hkv=1, D=16, S=6, N=2, ctx_lens=[0, 3])
    np.testing.assert_allclose(
        t_ref(*_args(case, torch.from_numpy), sm_scale=0.5).numpy(),
        np.asarray(j_ref(*_args(case, jnp.asarray), sm_scale=0.5)), rtol=2e-5, atol=2e-5)


def test_wrapper_on_cpu_takes_plain_version():
    case = _case(4, B=2, W=3, H=2, Hkv=2, D=8, S=5, N=2)
    args = _args(case, torch.from_numpy)
    before = t_attn.launches
    want = t_ref(*args, sm_scale=0.4)
    for backend in ("auto", "plain"):
        assert torch.equal(t_attn(*args, sm_scale=0.4, backend=backend), want)
    # an empty beam store is N = 0
    empty = args[:4] + [args[4][:, :0], args[5][:, :0], args[6][:, :0]]
    assert torch.equal(t_attn(*empty, sm_scale=0.4), t_ref(*args[:4], None, None, None, 0.4))
    assert t_attn.launches == before      # no kernel launched on CPU
    from recsys_examples_torch.ops.beam_decode_attention import _launch_cuda

    with pytest.raises(ValueError, match="CUDA"):     # the kernel refuses CPU tensors
        _launch_cuda(*args, 0.4)
    with pytest.raises(ValueError, match="backend"):
        t_attn(*args, sm_scale=0.4, backend="pallas")
    # bf16 in, bf16 out, fp32 sums inside
    bf = [a.bfloat16() if a.is_floating_point() else a for a in args]
    out = t_attn(*bf, sm_scale=0.4)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), t_ref(*[
        a.float() if a.is_floating_point() else a for a in bf], sm_scale=0.4).numpy(),
        atol=2e-2)
