"""The tile walks of K4's forward and dk/dv (`rab_fwd_tile_walk`,
`rab_dkv_tile_walk` in `ops/hstu_attention_ref.py`: the RAB instances of
K1's and K3's kernels, tile by tile, in plain PyTorch) against the JAX
kernel `hstu_attn_varlen_rab` in interpret mode, on the bias cases of
tests/test_torch_hstu_attention.py with an fp32 and a bf16 bias, bf16 q, k,
v and dO from a numpy seed; then against the plain version at the kernels'
tile and CTA edges. The pass rule is the port's kernel rule,
err < 2e-2 * max|ref| + 1e-3: the walks round P and dS to bf16 where the
kernels do, and sum in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_examples_torch.ops.hstu_attention_ref import (
    hstu_attn_bwd_ref,
    hstu_mha_reference,
    rab_dkv_tile_walk,
    rab_fwd_tile_walk,
)
from recsys_examples_tpu.ops.pallas.hstu_attention import hstu_attn_varlen_rab as j_rab
from test_torch_hstu_attention import CASES, RAB_CASES

ALPHA = 0.08
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(name, bias):
    """bf16 q, k, v, dO [T + 4, 2, 128] (4 rows no sequence owns) and the
    bias of RAB_CASES[name] in `bias`'s dtype, as numpy fp32 holding exactly
    representable values."""
    shape, lens, n, case = RAB_CASES[name]
    rng = np.random.default_rng(11)
    total = int(sum(lens))
    bf = lambda x: torch.from_numpy(x.astype(np.float32)).bfloat16().float().numpy()
    mk = lambda: bf(rng.standard_normal((total + 4, 2, 128)))
    q, k, v, w = mk(), mk(), mk(), mk()
    rab = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    if bias == "bf16":
        rab = bf(rab)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ctx, tgt, kw = CASES[case]
    if ctx is not None:
        ctx, tgt = ctx[: len(lens)], tgt[: len(lens)]
    return q, k, v, w, rab, offs, n, ctx, tgt, kw


_JAX = {}


def _jax_rab(name, bias):
    """out, dk, dv of `hstu_attn_varlen_rab` in interpret mode, bf16, as
    fp32 numpy (one run per case and bias dtype, shared by the tests)."""
    if (name, bias) not in _JAX:
        q, k, v, w, rab, offs, n, ctx, tgt, kw = _inputs(name, bias)
        aux = (jnp.asarray(offs), None if ctx is None else jnp.asarray(ctx),
               None if tgt is None else jnp.asarray(tgt))
        bf = lambda x: jnp.asarray(x, jnp.bfloat16)
        f = lambda q, k, v, r: j_rab(q, k, v, r, aux, max_seqlen=n, alpha=ALPHA,
                                     scaling_seqlen=n, interpret=True, **kw)
        out, vjp = jax.vjp(f, bf(q), bf(k), bf(v), jnp.asarray(rab, DTYPES[bias][1]))
        _, dk, dv, _ = vjp(bf(w))
        _JAX[name, bias] = [np.asarray(x, np.float32) for x in (out, dk, dv)]
    return _JAX[name, bias]


def _walk_args(name, bias):
    q, k, v, w, rab, offs, n, ctx, tgt, kw = _inputs(name, bias)
    t = lambda x: None if x is None else torch.from_numpy(x)
    b = lambda x: torch.from_numpy(x).bfloat16()
    kw = dict(num_contextuals=t(ctx), num_targets=t(tgt), scaling_seqlen=n, **kw)
    return (b(q), b(k), b(v), b(w), torch.from_numpy(rab).to(DTYPES[bias][0]),
            torch.from_numpy(offs), n, kw)


def _assert_close(tag, got, want):
    want = want.float().numpy() if isinstance(want, torch.Tensor) else want
    got = got.float().numpy()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert scale > 0, tag
    assert err < 2e-2 * scale + 1e-3, f"{tag}: max_abs_err {err} against max|ref| {scale}"


@pytest.mark.parametrize("bias", list(DTYPES))
@pytest.mark.parametrize("name", list(RAB_CASES))
def test_rab_fwd_tile_walk_matches_pallas_interpret(name, bias):
    q, k, v, w, rab, offs, n, kw = _walk_args(name, bias)
    out = rab_fwd_tile_walk(q, k, v, rab, offs, n, ALPHA, **kw)
    assert out.dtype == torch.bfloat16 and not out[int(offs[-1]):].any()
    _assert_close("out", out, _jax_rab(name, bias)[0])


@pytest.mark.parametrize("bias", list(DTYPES))
@pytest.mark.parametrize("name", list(RAB_CASES))
def test_rab_dkv_tile_walk_matches_pallas_interpret(name, bias):
    q, k, v, w, rab, offs, n, kw = _walk_args(name, bias)
    dk, dv = rab_dkv_tile_walk(q, k, v, w, rab, offs, n, ALPHA, **kw)
    want = _jax_rab(name, bias)
    for tag, got, ref in (("dk", dk, want[1]), ("dv", dv, want[2])):
        assert got.dtype == torch.bfloat16 and not got[int(offs[-1]):].any(), tag
        _assert_close(tag, got, ref)


# (lengths, max_seqlen, contextual rows, targets, mask options): K3's 64-row
# tile edges, K1's 128-row CTA edges (193 leaves consumer 1 of the second CTA
# without rows), contextual rows across the consumer boundary (c 70) and past
# the CTA (c 130), whole tiles (interior tiles add the bias and skip the
# mask), targets in groups, a window with a min-full tail, non-causal
EDGE_CASES = {
    "tile_edges": ([63, 64, 65, 127, 128, 129], 129, None, None, {}),
    "cta_edges": ([191, 192, 193, 1], 193, None, None, {}),
    "ctx70_130": ([200, 260, 129], 260, [70, 130, 70], None, {}),
    "interior_tgt": ([256, 192], 256, [3, 0], [40, 7], dict(target_group_size=2)),
    "window_minfull": ([200, 77], 200, None, [9, 3], dict(max_attn_len=64,
                                                          min_full_attn_seq_len=32)),
    "noncausal": ([130, 64], 130, [2, 1], None, dict(causal=False)),
}


@pytest.mark.parametrize("name", list(EDGE_CASES))
def test_rab_tile_walks_match_plain_at_tile_edges(name):
    """Both walks against the plain forward and backward (`hstu_mha_reference`,
    `hstu_attn_bwd_ref`), bf16 operands and a bf16 bias [B, H, N, N + 3] (an
    odd row stride), H 2 x 32."""
    lens, n, ctx, tgt, kw = EDGE_CASES[name]
    rng = np.random.default_rng(13)
    total = int(sum(lens))
    mk = lambda: torch.from_numpy(rng.standard_normal((total + 3, 2, 32))
                                  .astype(np.float32)).bfloat16()
    q, k, v, w = mk(), mk(), mk(), mk()
    rab = torch.from_numpy(0.5 * rng.standard_normal((len(lens), 2, n, n + 3))
                           .astype(np.float32)).bfloat16()
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(np.int32))
    t = lambda x: None if x is None else torch.tensor(x, dtype=torch.int32)
    kw = dict(num_contextuals=t(ctx), num_targets=t(tgt), **kw)
    alpha = 32 ** -0.5
    out = rab_fwd_tile_walk(q, k, v, rab, offs, n, alpha, **kw)
    dk, dv = rab_dkv_tile_walk(q, k, v, w, rab, offs, n, alpha, **kw)
    want_out = hstu_mha_reference(n, alpha, q, k, v, offs, rab=rab, **kw)
    _, want_dk, want_dv, _ = hstu_attn_bwd_ref(n, alpha, q, k, v, w, offs, rab=rab, **kw)
    for tag, got, want in (("out", out, want_out), ("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert not got[total:].any(), tag
        _assert_close(tag, got, want)
