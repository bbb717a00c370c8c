"""Paged HSTU (SiLU) delta attention for KV-cached inference (counterpart of
recsys_examples_tpu/ops/pallas/paged_hstu_attention.py).

New-token queries attend over [the user's cached pages ++ the new tokens
themselves]. K/V pages are read through the page table; the CUDA kernel
(`csrc/paged_hstu_attention.cu`) reads them straight from the pool, the plain
version gathers them densely.

Mask (delta-q semantics):
  valid(row = cached + i, col) = (col == row) or (dist > 0), with row and col
  clamped to the history end kv_len - num_targets when num_targets is set
  (targets attend history + themselves but not other targets), col < kv_len,
  and i < new_len (padded query rows give zero).

Cached positions [0, cached_len) come from the pages, position cached + t
from the new token t. Like the TPU kernel (and unlike the JAX package's jnp
twin, which splices new tokens into the maxp * page_size window), new tokens
past maxp * page_size are kept. A page id of -1 is never read: its positions
are masked.

The int8 page mode: `quantize_kv_pages` turns bf16/fp32 pages into int8
pages with one fp32 scale per (token, head); passed with `k_scales` /
`v_scales`, CUDA tensors launch the int8 instance of the kernel (bf16 q and
new tokens; half the page bytes), CPU tensors run the plain version on the
dequantized pages. The kernel folds the scales into the scores and the
probabilities and rounds p * v_scale to bf16 before p . v8 (the TPU kernel
runs that product in fp32).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIMS = (32, 64, 128, 256)


def paged_hstu_delta_attention_ref(
    q: torch.Tensor,           # [B, S, H, dh] new-token queries
    k_pages: torch.Tensor,     # [P, pg, H, dh] one layer's key pages
    v_pages: torch.Tensor,     # [P, pg, H, dh]
    page_table: torch.Tensor,  # [B, maxp] int32 page ids (-1 unset)
    cached_len: torch.Tensor,  # [B] cached tokens
    new_k: torch.Tensor,       # [B, S, H, dh] the new tokens' keys
    new_v: torch.Tensor,       # [B, S, H, dh]
    new_lens: torch.Tensor,    # [B] valid new tokens
    num_targets: Optional[torch.Tensor],  # [B] or None
    alpha: float,
    scaling_seqlen: float,
) -> torch.Tensor:
    """Plain PyTorch version: gathers the pages densely, then applies the
    delta mask. Scores and sums in fp32; P rounds to the V dtype before
    P.V, as the kernel does."""
    B, S, H, dh = q.shape
    P, pg = k_pages.shape[:2]
    maxp = page_table.shape[1]
    Nc = maxp * pg
    dev = q.device
    pt = page_table.to(torch.int64)
    pid = pt.clamp(0, P - 1)
    kc = k_pages[pid].reshape(B, Nc, H, dh)
    vc = v_pages[pid].reshape(B, Nc, H, dh)
    k = torch.cat([kc, new_k.to(kc.dtype)], dim=1)        # [B, Nc + S, H, dh]
    v = torch.cat([vc, new_v.to(vc.dtype)], dim=1)
    cached = cached_len.to(torch.int64)[:, None]
    nl = new_lens.to(torch.int64)[:, None]
    pos_c = torch.arange(Nc, device=dev)[None, :]
    ar_s = torch.arange(S, device=dev)[None, :]
    col = torch.cat([pos_c.expand(B, Nc), cached + ar_s], dim=1)   # [B, N]
    col_ok = torch.cat([
        (pos_c < cached) & (pt >= 0).repeat_interleave(pg, dim=1),
        ar_s < nl,
    ], dim=1)
    kv_len = cached + nl                                   # [B, 1]
    row = cached + ar_s                                    # [B, S]
    hist_end = kv_len
    if num_targets is not None:
        hist_end = kv_len - num_targets.to(torch.int64)[:, None]
    rowc = torch.minimum(row, hist_end)[:, :, None]
    colc = torch.minimum(col, hist_end)[:, None, :]
    valid = (col[:, None, :] == row[:, :, None]) | (rowc - colc > 0)
    valid &= (col_ok & (col < kv_len))[:, None, :]
    valid &= (ar_s < nl)[:, :, None]                       # [B, S, N]
    sc = torch.einsum("bshd,bnhd->bhsn", q.float(), k.float()) * alpha
    p = F.silu(sc) * (1.0 / scaling_seqlen) * valid[:, None].to(sc.dtype)
    p = p.to(v.dtype).float()
    out = torch.einsum("bhsn,bnhd->bshd", p, v.float())
    return out.to(q.dtype)


def quantize_kv_pages(k_pages: torch.Tensor, v_pages: torch.Tensor):
    """bf16/fp32 pages [P, pg, H, dh] -> (int8 K pages, int8 V pages, K
    scales, V scales): symmetric scaling per (token, head), fp32 scales
    [P, pg, H]. Runs where the pages lie."""
    def one(x):
        x = x.float()
        s = x.abs().amax(dim=-1) / 127.0
        q8 = torch.round(x / s.clamp_min(1e-12)[..., None]).to(torch.int8)
        return q8, s
    k8, ks = one(k_pages)
    v8, vs = one(v_pages)
    return k8, v8, ks, vs


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
    + [ctypes.c_float] * 2 + [ctypes.c_void_p]
)


def _lib(entry="paged_hstu_delta_attention_launch", argtypes=_ARGTYPES):
    from recsys_examples_torch.utils import cuda_build

    fn = getattr(cuda_build.load("paged_hstu_attention"), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_operands(q, k_pages, v_pages, page_table, cached_len, new_k, new_v,
                    new_lens, num_targets, page_dtype):
    B, S, H, dh = q.shape
    P, pg = k_pages.shape[:2]
    maxp = page_table.shape[1]
    dev, dt = q.device, q.dtype
    if dh not in _HEAD_DIMS:
        raise ValueError(f"paged attention kernel takes head dims {_HEAD_DIMS}, got {dh}")
    _check("q", q, dt, (B, S, H, dh), dev)
    _check("new_k", new_k, dt, (B, S, H, dh), dev)
    _check("new_v", new_v, dt, (B, S, H, dh), dev)
    _check("k_pages", k_pages, page_dtype, (P, pg, H, dh), dev)
    _check("v_pages", v_pages, page_dtype, (P, pg, H, dh), dev)
    _check("page_table", page_table, torch.int32, (B, maxp), dev)
    _check("cached_len", cached_len, torch.int32, (B,), dev)
    _check("new_lens", new_lens, torch.int32, (B,), dev)
    if num_targets is not None:
        _check("num_targets", num_targets, torch.int32, (B,), dev)
    return B, S, H, dh, P, pg, maxp


def _launch_cuda(q, k_pages, v_pages, page_table, cached_len, new_k, new_v,
                 new_lens, num_targets, alpha, scaling_seqlen):
    dev, dt = q.device, q.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"paged attention kernel takes bf16 or fp32, got {dt}")
    B, S, H, dh, P, pg, maxp = _check_operands(
        q, k_pages, v_pages, page_table, cached_len, new_k, new_v, new_lens,
        num_targets, dt)
    fn = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            _DTYPE_CODE[dt], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), page_table.data_ptr(), cached_len.data_ptr(),
            new_k.data_ptr(), new_v.data_ptr(), new_lens.data_ptr(),
            None if num_targets is None else num_targets.data_ptr(),
            out.data_ptr(), B, S, H, dh, pg, maxp,
            float(alpha), 1.0 / float(scaling_seqlen), stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_hstu_delta_attention launch failed: error {err}")
    paged_hstu_delta_attention.launches += 1
    return out


_ARGTYPES_INT8 = (
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2
    + [ctypes.c_void_p]
)


def paged_hstu_delta_attention_int8(
    q, k_pages, v_pages, k_scales, v_scales, page_table, cached_len, new_k,
    new_v, new_lens, num_targets, alpha: float, scaling_seqlen: float,
):
    """The int8 instance of the kernel: CUDA tensors only, bf16 q / new_k /
    new_v, int8 pages [P, pg, H, dh] with fp32 scales [P, pg, H]. `launches`
    counts its launches."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the int8 paged attention kernel takes CUDA tensors, got {dev}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the int8 paged attention kernel takes bf16 queries, got {q.dtype}")
    B, S, H, dh, P, pg, maxp = _check_operands(
        q, k_pages, v_pages, page_table, cached_len, new_k, new_v, new_lens,
        num_targets, torch.int8)
    _check("k_scales", k_scales, torch.float32, (P, pg, H), dev)
    _check("v_scales", v_scales, torch.float32, (P, pg, H), dev)
    fn = _lib("paged_hstu_delta_attention_int8_launch", _ARGTYPES_INT8)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = fn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(), page_table.data_ptr(),
            cached_len.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
            new_lens.data_ptr(),
            None if num_targets is None else num_targets.data_ptr(),
            out.data_ptr(), B, S, H, dh, pg, maxp,
            float(alpha), 1.0 / float(scaling_seqlen),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"paged_hstu_delta_attention_int8 launch failed: error {err}")
    paged_hstu_delta_attention_int8.launches += 1
    return out


paged_hstu_delta_attention_int8.launches = 0


def paged_hstu_delta_attention(
    q, k_pages, v_pages, page_table, cached_len, new_k, new_v, new_lens,
    num_targets, alpha: float, scaling_seqlen: float,
    *, k_scales=None, v_scales=None,
):
    """Paged SiLU delta attention. Returns [B, S, H, dh] in q's dtype.

    k_pages / v_pages: one layer's pools [P, pg, H, dh], bf16 or fp32, or
    int8 with `k_scales` / `v_scales` [P, pg, H] from `quantize_kv_pages`.
    CPU tensors take the plain version (int8 pages dequantized to fp32
    first); CUDA tensors launch the kernel (int32 index tensors) or raise.
    `launches` counts the launches of the bf16/fp32 kernel,
    `paged_hstu_delta_attention_int8.launches` the int8 instance's.
    """
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    if (k_pages.dtype == torch.int8) != (k_scales is not None):
        raise TypeError("int8 pages need their scales, and scales int8 pages")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if k_scales is not None:
        if q.device.type == "cuda":
            return paged_hstu_delta_attention_int8(
                q, k_pages, v_pages, k_scales, v_scales, page_table, cached_len,
                new_k, new_v, new_lens, num_targets, alpha, scaling_seqlen)
        k_pages = k_pages.float() * k_scales[..., None]
        v_pages = v_pages.float() * v_scales[..., None]
    if q.device.type == "cpu":
        return paged_hstu_delta_attention_ref(
            q, k_pages, v_pages, page_table, cached_len, new_k, new_v,
            new_lens, num_targets, alpha, scaling_seqlen,
        )
    return _launch_cuda(
        q, k_pages, v_pages, page_table, cached_len, new_k, new_v, new_lens,
        num_targets, alpha, scaling_seqlen,
    )


paged_hstu_delta_attention.launches = 0
