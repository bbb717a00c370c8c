"""The two int8 kernel modes on the CPU: the quantize helpers bit for bit
against the JAX package's (int8 values and scales), the int8 paged plain
path against JAX's `backend="jnp"` and its Pallas kernel in interpret mode,
and the plain int8 forward (K5) against
`hstu_attn_varlen_quantized_calibrated(interpret=True)`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch.ops import hstu_attention as t_ha
from recsys_examples_torch.ops import paged_hstu_attention as t_pa
from recsys_examples_torch.ops.hstu_attention_ref import (
    hstu_mha_int8_reference,
    hstu_mha_reference,
)
from recsys_examples_tpu.ops.pallas import hstu_attention as j_ha
from recsys_examples_tpu.ops.pallas import paged_hstu_attention as j_pa


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_pages_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    k = rng.standard_normal((5, 8, 2, 16)).astype(np.float32) * 3
    v = rng.standard_normal((5, 8, 2, 16)).astype(np.float32)
    k[0, 0, 0] = 0          # an all-zero row: scale 0, values 0
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if dtype == "bfloat16":
        tk, tv, jk, jv = tk.bfloat16(), tv.bfloat16(), jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk, np.float32))
    want = j_pa.quantize_kv_pages(jk, jv)
    got = t_pa.quantize_kv_pages(tk, tv)
    for name, g, w in zip(("k8", "v8", "k_scales", "v_scales"), got, want):
        assert g.dtype == (torch.int8 if name.endswith("8") else torch.float32), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[2].shape == (5, 8, 2) and not got[0][0, 0, 0].any()


@pytest.mark.parametrize("scale", [1.0, 1e-3, 300.0])
def test_quantize_per_tensor_bit_for_bit(scale):
    x = (np.random.default_rng(1).standard_normal((40, 2, 16)) * scale).astype(np.float32)
    want_q, want_s = j_ha.quantize_per_tensor(jnp.asarray(x))
    got_q, got_s = t_ha.quantize_per_tensor(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and isinstance(got_s, float) and got_s == want_s
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert t_ha.quantize_per_tensor(torch.zeros(3, 1, 8))[1] == 1e-12 / 127.0


def _paged_case(seed, B, S, H, dh, P, pg, maxp, with_targets):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        q=f(B, S, H, dh), k_pages=f(P, pg, H, dh), v_pages=f(P, pg, H, dh),
        page_table=rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32),
        cached_len=rng.integers(0, maxp * pg - S + 1, size=B).astype(np.int32),
        new_k=f(B, S, H, dh), new_v=f(B, S, H, dh),
        new_lens=rng.integers(1, S + 1, size=B).astype(np.int32),
        num_targets=rng.integers(0, 3, size=B).astype(np.int32) if with_targets else None)


ORDER = ("q", "k_pages", "v_pages", "page_table", "cached_len", "new_k", "new_v",
         "new_lens", "num_targets")


@pytest.mark.parametrize("with_targets", [False, True])
def test_int8_paged_plain_matches_jax(with_targets):
    """The same int8 pages and scales through the port's CPU path, JAX's jnp
    twin (rtol/atol 2e-5) and the Pallas kernel in interpret mode (2e-4, as
    the JAX package's own test holds kernel against twin); and all three
    stay within quantization noise of the unquantized attention."""
    B, S, H, dh, P, pg, maxp = 2, 8, 2, 128, 12, 128, 4
    case = _paged_case(2, B, S, H, dh, P, pg, maxp, with_targets)
    alpha, scaling = 1.0 / dh ** 0.5, 256.0
    tq = t_pa.quantize_kv_pages(torch.from_numpy(case["k_pages"]),
                                torch.from_numpy(case["v_pages"]))
    k8, v8, ks, vs = (x.numpy() for x in tq)

    def run_jax(backend, **kw):
        a = {k: None if v is None else jnp.asarray(v) for k, v in case.items()}
        a.update(k_pages=jnp.asarray(k8), v_pages=jnp.asarray(v8))
        return np.asarray(j_pa.paged_hstu_delta_attention(
            *[a[k] for k in ORDER], alpha, scaling, k_scales=jnp.asarray(ks),
            v_scales=jnp.asarray(vs), backend=backend, **kw))

    a = {k: None if v is None else torch.from_numpy(v) for k, v in case.items()}
    full = t_pa.paged_hstu_delta_attention(*[a[k] for k in ORDER], alpha, scaling).numpy()
    a.update(k_pages=tq[0], v_pages=tq[1])
    before = t_pa.paged_hstu_delta_attention_int8.launches
    got = t_pa.paged_hstu_delta_attention(*[a[k] for k in ORDER], alpha, scaling,
                                          k_scales=tq[2], v_scales=tq[3]).numpy()
    assert t_pa.paged_hstu_delta_attention_int8.launches == before
    np.testing.assert_allclose(got, run_jax("jnp"), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, run_jax("pallas", interpret=True), rtol=2e-4, atol=2e-4)
    assert np.abs(got - full).max() <= 0.02 * np.abs(full).max() + 1e-3


CASES = {
    "causal": (None, None, {}),
    "ctx_tgt_group": (np.array([3, 0], np.int32), np.array([10, 6], np.int32),
                      dict(target_group_size=2)),
    "window": (None, None, dict(max_attn_len=64)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_int8_forward_plain_matches_pallas_interpret(case):
    """K5's plain version against the Pallas int8 forward in interpret mode
    on the same int8 operands and scales: both widen int8 to bf16, round P
    to bf16 and give bf16 outputs, so they differ by bf16 ulps of the sum
    order; held to the repo's kernel rule, err < 2e-2 * max|ref| + 1e-3. The
    quantization error against the fp32 attention is the JAX test's bound
    (mean error below 5% of the mean magnitude)."""
    N, H, D, T = 256, 2, 128, 512
    ctx, tgt, kw = CASES[case]
    rng = np.random.default_rng(3)
    offs = np.array([0, 200, 456], np.int32)
    q, k, v = (rng.standard_normal((T, H, D)).astype(np.float32) for _ in range(3))
    (q8, sq), (k8, sk), (v8, sv) = (t_ha.quantize_per_tensor(torch.from_numpy(x))
                                    for x in (q, k, v))
    t = lambda x: None if x is None else torch.from_numpy(x)
    j = lambda x: None if x is None else jnp.asarray(x)
    want = np.asarray(j_ha.hstu_attn_varlen_quantized_calibrated(
        *(jnp.asarray(x.numpy()) for x in (q8, k8, v8)), sq, sk, sv,
        (j(offs), j(ctx), j(tgt)), max_seqlen=N, alpha=0.08, interpret=True, **kw),
        np.float32)
    before = t_ha.hstu_attn_fwd_int8_cuda.launches
    got = t_ha.hstu_attn_varlen_quantized_calibrated(
        q8, k8, v8, sq, sk, sv, t(offs), N, num_contextuals=t(ctx), num_targets=t(tgt),
        alpha=0.08, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (T, H, D)
    assert t_ha.hstu_attn_fwd_int8_cuda.launches == before
    got = got.float().numpy()
    assert np.abs(got - want).max() < 2e-2 * np.abs(want).max() + 1e-3
    assert not got[offs[-1]:].any()
    ref_kw = dict(num_contextuals=t(ctx), num_targets=t(tgt), **kw)
    fp = hstu_mha_reference(N, 0.08, t(q), t(k), t(v), t(offs), **ref_kw).numpy()
    assert np.abs(got - fp).mean() / (np.abs(fp).mean() + 1e-6) < 0.05
    # the wrapper's CPU path is the plain version
    direct = hstu_mha_int8_reference(N, 0.08, q8, k8, v8, sq, sk, sv, t(offs), **ref_kw)
    np.testing.assert_array_equal(got, direct.float().numpy())


def test_quantized_route_of_hstu_attn_varlen():
    """`quantized=True` quantizes per tensor and takes the int8 forward:
    bf16 out, no gradient, no bias."""
    rng = np.random.default_rng(4)
    so = torch.tensor([0, 5, 12])
    q, k, v = (torch.from_numpy(rng.standard_normal((12, 2, 32)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    out = t_ha.hstu_attn_varlen(q, k, v, so, 8, alpha=0.2, quantized=True)
    full = t_ha.hstu_attn_varlen(q, k, v, so, 8, alpha=0.2)
    assert out.dtype == torch.bfloat16 and not out.requires_grad and full.requires_grad
    assert (out.float() - full).abs().max() < 0.05 * full.abs().max()
    with pytest.raises(ValueError, match="bias"):
        t_ha.hstu_attn_varlen(q, k, v, so, 8, quantized=True, rab=torch.zeros(1, 1, 8, 8))


@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_int8_score_is_exact_in_any_order(D):
    """K5's score runs as an int8 x int8 -> int32 product (wgmma s8.s8.s32)
    where the TPU kernel widens to bf16 and sums in fp32. Each term is at
    most 127^2 in size, so at these head dims every partial sum stays below
    2^24 and an fp32 sum of the widened products is exact in any order: the
    int32 product equals it bit for bit. Worst-case operands: +-127 with
    aligned signs (the largest sums) and random signs."""
    rng = np.random.default_rng(D)
    signs = rng.choice(np.array([-1, 1], np.int8), size=(64, D))
    q = np.concatenate([np.full((1, D), 127, np.int8), 127 * signs])
    k = np.concatenate([np.full((1, D), 127, np.int8), -127 * signs[::-1]])
    q8, k8 = torch.from_numpy(q), torch.from_numpy(k)
    exact = (q8.to(torch.int32) @ k8.to(torch.int32).T).numpy()
    assert np.abs(exact).max() == 127 * 127 * D < 2 ** 24
    terms = q8.to(torch.bfloat16).float()[:, None, :] * k8.to(torch.bfloat16).float()[None]
    assert (terms.abs() <= 127 * 127).all()
    for order in (np.arange(D), np.arange(D)[::-1], rng.permutation(D)):
        s = torch.zeros(terms.shape[:2])
        for i in order:                       # one fp32 sum per term, in this order
            s = s + terms[:, :, int(i)]
        np.testing.assert_array_equal(s.numpy(), exact.astype(np.float32))
    fp32 = (q8.to(torch.bfloat16).float() @ k8.to(torch.bfloat16).float().T).numpy()
    np.testing.assert_array_equal(fp32, exact.astype(np.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_int8_forward_at_cta_edges_matches_pallas_interpret(case):
    """K5's route (`hstu_attn_varlen_quantized_calibrated` on CPU tensors,
    the plain version) against the Pallas int8 forward in interpret mode at
    the edges of K1's 128-row CTA, whose template K5 runs: sequences of
    127, 128, 129 and 257 rows. Held to the repo's kernel rule, as
    `test_int8_forward_plain_matches_pallas_interpret`."""
    lengths = [127, 128, 129, 257]
    N, H, D = 257, 2, 64
    offs = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    T = int(offs[-1])
    ctx, tgt, kw = CASES[case]
    if ctx is not None:
        ctx, tgt = np.array([3, 0, 70, 130], np.int32), np.array([10, 6, 2, 9], np.int32)
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((T, H, D)).astype(np.float32) for _ in range(3))
    (q8, sq), (k8, sk), (v8, sv) = (t_ha.quantize_per_tensor(torch.from_numpy(x))
                                    for x in (q, k, v))
    t = lambda x: None if x is None else torch.from_numpy(x)
    j = lambda x: None if x is None else jnp.asarray(x)
    want = np.asarray(j_ha.hstu_attn_varlen_quantized_calibrated(
        *(jnp.asarray(x.numpy()) for x in (q8, k8, v8)), sq, sk, sv,
        (j(offs), j(ctx), j(tgt)), max_seqlen=N, alpha=0.125, interpret=True, **kw),
        np.float32)
    got = t_ha.hstu_attn_varlen_quantized_calibrated(
        q8, k8, v8, sq, sk, sv, t(offs), N, num_contextuals=t(ctx), num_targets=t(tgt),
        alpha=0.125, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (T, H, D)
    got = got.float().numpy()
    assert np.abs(got - want).max() < 2e-2 * np.abs(want).max() + 1e-3
