"""Paged SiLU delta attention: the port's plain version against the JAX
package's jnp twin and its Pallas kernel run in interpret mode. Inputs come
from numpy with a fixed seed and go to both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch.ops.paged_hstu_attention import (
    paged_hstu_delta_attention as torch_paged,
    paged_hstu_delta_attention_ref as torch_ref,
)
from recsys_examples_tpu.ops.pallas.paged_hstu_attention import (
    paged_hstu_delta_attention as jax_paged,
    paged_hstu_delta_attention_ref as jax_ref,
)


def _case(seed, B, S, H, dh, P, pg, maxp, with_targets, cached=None,
          new_lens=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    if cached is None:
        # keep cached + S inside the maxp * pg window: there the jnp twin
        # and the kernel agree
        cached = rng.integers(0, maxp * pg - S + 1, size=B)
    if new_lens is None:
        new_lens = rng.integers(1, S + 1, size=B)
    return dict(
        q=f(B, S, H, dh), k_pages=f(P, pg, H, dh), v_pages=f(P, pg, H, dh),
        page_table=rng.permutation(P)[: B * maxp].reshape(B, maxp)
        .astype(np.int32),
        cached_len=np.asarray(cached, np.int32),
        new_k=f(B, S, H, dh), new_v=f(B, S, H, dh),
        new_lens=np.asarray(new_lens, np.int32),
        num_targets=(rng.integers(0, 3, size=B).astype(np.int32)
                     if with_targets else None),
    )


def _args(case, conv):
    return [None if case[k] is None else conv(case[k]) for k in (
        "q", "k_pages", "v_pages", "page_table", "cached_len", "new_k",
        "new_v", "new_lens", "num_targets")]


def _torch(case, alpha, scaling, fn=torch_ref):
    return fn(*_args(case, torch.from_numpy), alpha, scaling).numpy()


@pytest.mark.parametrize("with_targets", [False, True])
def test_plain_matches_jax_ref(with_targets):
    B, S, H, dh, P, pg, maxp = 4, 6, 2, 16, 24, 8, 4
    # ragged cache: empty, mid-page, a page boundary, near-full
    case = _case(0, B, S, H, dh, P, pg, maxp, with_targets,
                 cached=[0, 5, 16, maxp * pg - S], new_lens=[6, 1, 4, 6])
    alpha, scaling = 0.35, 64.0
    want = np.asarray(jax_ref(*_args(case, jnp.asarray), alpha, scaling))
    got = _torch(case, alpha, scaling)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("with_targets", [False, True])
def test_plain_matches_pallas_interpret(with_targets):
    B, S, H, dh, P, pg, maxp = 3, 8, 2, 32, 16, 8, 4
    case = _case(1, B, S, H, dh, P, pg, maxp, with_targets)
    alpha, scaling = 1.0 / dh ** 0.5, 256.0
    want = np.asarray(jax_paged(*_args(case, jnp.asarray), alpha, scaling,
                                backend="pallas", interpret=True))
    got = _torch(case, alpha, scaling)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_new_tokens_past_page_window_follow_kernel():
    """cached_len + S > maxp * pg: the Pallas kernel keeps the new tokens
    past the page window (the jnp twin drops them); the port follows the
    kernel."""
    B, S, H, dh, P, pg, maxp = 2, 8, 2, 32, 12, 8, 2
    case = _case(2, B, S, H, dh, P, pg, maxp, True,
                 cached=[maxp * pg - 3, maxp * pg], new_lens=[8, 7])
    alpha, scaling = 1.0 / dh ** 0.5, 128.0
    want = np.asarray(jax_paged(*_args(case, jnp.asarray), alpha, scaling,
                                backend="pallas", interpret=True))
    got = _torch(case, alpha, scaling)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_wrapper_on_cpu_takes_plain_version():
    case = _case(3, 2, 4, 2, 8, 8, 4, 2, True)
    before = torch_paged.launches
    got = _torch(case, 0.5, 16.0, fn=torch_paged)
    np.testing.assert_array_equal(got, _torch(case, 0.5, 16.0))
    assert torch_paged.launches == before      # no kernel launched on CPU
    # padded query rows come out as zero
    for b, n in enumerate(case["new_lens"]):
        assert not got[b, n:].any()


def test_int8_pages_need_their_scales():
    """Int8 pages and scales that do not belong together are refused, and
    int8 pages with unit scales equal the same values as fp32 pages (the
    int8 mode is held against JAX in tests/test_torch_quantized.py)."""
    case = _case(4, 1, 2, 1, 8, 4, 4, 1, False)
    case["k_pages"] = np.round(case["k_pages"] * 20).astype(np.float32)
    case["v_pages"] = np.round(case["v_pages"] * 20).astype(np.float32)
    args = _args(case, torch.from_numpy)
    ones = torch.ones(4, 4, 1)
    with pytest.raises(TypeError, match="int8"):
        torch_paged(*args, 0.5, 16.0, k_scales=ones, v_scales=ones)
    int8 = list(args)
    int8[1], int8[2] = args[1].to(torch.int8), args[2].to(torch.int8)
    with pytest.raises(TypeError, match="scales"):
        torch_paged(*int8, 0.5, 16.0)
    with pytest.raises(ValueError, match="together"):
        torch_paged(*int8, 0.5, 16.0, k_scales=ones)
    got = torch_paged(*int8, 0.5, 16.0, k_scales=ones, v_scales=ones)
    np.testing.assert_allclose(got.numpy(), _torch(case, 0.5, 16.0), rtol=1e-6, atol=1e-6)
