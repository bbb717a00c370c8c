"""Beam-decode attention: one decode step of softmax attention for W beams
over [the shared context KV ++ the beam-sparse KV of the earlier decode
steps] (counterpart of recsys_examples_tpu/ops/pallas/beam_decode_attention.py).

Per batch b, query beam w, head h:
    keys = k_ctx[b, :ctx_lens[b], h // G]
           ++ [k_beam[b, n, ancestry[b, n, w], h // G] for n < N]
    out  = softmax(q . keys * sm_scale) @ values
with G = H // Hkv (GQA). The context KV is read once per batch and never
repeated over beams; the per-beam KV is never reordered: the ancestry
indices name the beam slot that holds step n's KV on beam w's path.

  - CUDA tensors launch the hand-written kernel K7
    (`csrc/beam_decode_attention.cu`; bf16 or fp32, head dims 32/64/128) or
    raise;
  - CPU tensors, and `backend="plain"`, run `beam_decode_attn_ref`.
`beam_decode_attn.launches` counts kernel launches.

A row with no key at all (`ctx_lens[b] == 0` and N == 0) comes out as zero,
as in the TPU kernel; the JAX package's jnp twin returns the mean of V there.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIMS = (32, 64, 128)


def beam_decode_attn_ref(
    q: torch.Tensor,                    # [B, W, H, D]
    k_ctx: torch.Tensor,                # [B, S, Hkv, D]
    v_ctx: torch.Tensor,                # [B, S, Hkv, D]
    ctx_lens: torch.Tensor,             # [B] valid context lengths
    k_beam: Optional[torch.Tensor],     # [B, N, W, Hkv, D] (None when N == 0)
    v_beam: Optional[torch.Tensor],
    ancestry: Optional[torch.Tensor],   # [B, N, W] beam slot per step
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """Plain PyTorch version: fp32 scores, softmax and sums. Returns
    [B, W, H, D] in q's dtype."""
    B, W, H, D = q.shape
    S, Hkv = k_ctx.shape[1:3]
    G = H // Hkv
    dev = q.device
    qf = q.float()
    kc = k_ctx.float().repeat_interleave(G, dim=2)
    vc = v_ctx.float().repeat_interleave(G, dim=2)
    scores = torch.einsum("bwhd,bshd->bwhs", qf, kc) * sm_scale
    valid = torch.arange(S, device=dev)[None, :] < ctx_lens.to(torch.int64)[:, None]
    valid = valid[:, None, None, :].expand(B, W, H, S)
    values = None
    if k_beam is not None and k_beam.shape[1] > 0:
        N = k_beam.shape[1]
        anc = ancestry.to(torch.int64)[..., None, None].expand(B, N, W, Hkv, D)
        kg = torch.gather(k_beam, 2, anc).float().repeat_interleave(G, dim=3)
        vg = torch.gather(v_beam, 2, anc).float().repeat_interleave(G, dim=3)
        s_beam = torch.einsum("bwhd,bnwhd->bwhn", qf, kg) * sm_scale
        scores = torch.cat([scores, s_beam], dim=-1)               # [B, W, H, S + N]
        valid = torch.cat([valid, valid.new_ones(B, W, H, N)], dim=-1)
        values = vg
    scores = torch.where(valid, scores, scores.new_full((), NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m) * valid.to(scores.dtype)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bwhs,bshd->bwhd", p[..., :S], vc)
    if values is not None:
        out = out + torch.einsum("bwhn,bnwhd->bwhd", p[..., S:], values)
    return out.to(q.dtype)


def _check(name, t, dtype, shape, device, inner):
    """`inner`: how many trailing dims must be densely packed (the kernel
    takes the strides of the leading ones)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    want = 1
    for d in range(t.dim() - 1, t.dim() - 1 - inner, -1):
        if t.shape[d] != 1 and t.stride(d) != want:
            raise ValueError(f"{name}'s last {inner} dims must be contiguous")
        want *= t.shape[d]
    vec = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % vec for s in t.stride()[: t.dim() - inner]):
        raise ValueError(f"{name} and its outer strides must be 16-byte aligned")


_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
    + [ctypes.c_longlong] * 7 + [ctypes.c_float, ctypes.c_void_p]
)


def _lib():
    from recsys_examples_torch.utils import cuda_build

    fn = cuda_build.load("beam_decode_attention").beam_decode_attn_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch_cuda(q, k_ctx, v_ctx, ctx_lens, k_beam, v_beam, ancestry, sm_scale):
    B, W, H, D = q.shape
    S, Hkv = k_ctx.shape[1:3]
    dev, dt = q.device, q.dtype
    if dev.type != "cuda":
        raise ValueError(f"the beam-decode attention kernel takes CUDA tensors, got {dev}")
    if dt not in _DTYPE_CODE:
        raise TypeError(f"beam-decode attention kernel takes bf16 or fp32, got {dt}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"beam-decode attention kernel takes head dims {_HEAD_DIMS}, got {D}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads do not divide into {Hkv} kv heads")
    _check("q", q, dt, (B, W, H, D), dev, 2)
    _check("k_ctx", k_ctx, dt, (B, S, Hkv, D), dev, 2)
    _check("v_ctx", v_ctx, dt, (B, S, Hkv, D), dev, 2)
    if k_ctx.stride() != v_ctx.stride():
        raise ValueError("k_ctx and v_ctx must share their strides")
    ctx_lens = ctx_lens.to(torch.int32).contiguous()   # the model keeps int64
    _check("ctx_lens", ctx_lens, torch.int32, (B,), dev, 1)
    N = 0 if k_beam is None else k_beam.shape[1]
    beam_strides = (0, 0, 0)
    if N:
        _check("k_beam", k_beam, dt, (B, N, W, Hkv, D), dev, 2)
        _check("v_beam", v_beam, dt, (B, N, W, Hkv, D), dev, 2)
        if k_beam.stride() != v_beam.stride():
            raise ValueError("k_beam and v_beam must share their strides")
        ancestry = ancestry.to(torch.int32).contiguous()
        _check("ancestry", ancestry, torch.int32, (B, N, W), dev, 3)
        beam_strides = k_beam.stride()[:3]
    out = torch.empty((B, W, H, D), dtype=dt, device=dev)
    ptr = lambda t: t.data_ptr() if N else None
    with torch.cuda.device(dev):
        err = _lib()(
            _DTYPE_CODE[dt], q.data_ptr(), k_ctx.data_ptr(), v_ctx.data_ptr(),
            ctx_lens.data_ptr(), ptr(k_beam), ptr(v_beam), ptr(ancestry),
            out.data_ptr(), B, W, H, Hkv, D, S, N,
            q.stride(0), q.stride(1), k_ctx.stride(0), k_ctx.stride(1),
            *beam_strides, float(sm_scale),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"beam_decode_attn launch failed: error {err}")
    beam_decode_attn.launches += 1
    return out


def beam_decode_attn(
    q: torch.Tensor,
    k_ctx: torch.Tensor,
    v_ctx: torch.Tensor,
    ctx_lens: torch.Tensor,
    k_beam: Optional[torch.Tensor] = None,
    v_beam: Optional[torch.Tensor] = None,
    ancestry: Optional[torch.Tensor] = None,
    sm_scale: float = 1.0,
    *,
    backend: str = "auto",
) -> torch.Tensor:
    """Fused beam-decode attention. q [B, W, H, D] -> out [B, W, H, D].

    backend: "auto" (the kernel on CUDA tensors, the plain version on CPU
    tensors) | "plain" (the plain version wherever the tensors lie, for
    comparisons). On "auto" a CUDA tensor never falls back: a failed build
    or launch raises.
    """
    if backend not in ("auto", "plain"):
        raise ValueError(f"unknown backend {backend!r}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if k_beam is not None and k_beam.shape[1] == 0:
        k_beam = v_beam = ancestry = None
    if backend == "plain" or q.device.type == "cpu":
        return beam_decode_attn_ref(
            q, k_ctx, v_ctx, ctx_lens, k_beam, v_beam, ancestry, sm_scale)
    return _launch_cuda(q, k_ctx, v_ctx, ctx_lens, k_beam, v_beam, ancestry, sm_scale)


beam_decode_attn.launches = 0
