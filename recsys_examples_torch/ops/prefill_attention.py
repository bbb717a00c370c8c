"""Causal GQA prefill attention: the prefill's attention of the Qwen3 and
LFM2 backbones (`models/qwen3.py` `Qwen3Attention`), over [B, N] padded
contexts of `lengths[b]` valid positions each.

Per batch row b, position i and query head h:
    out[b, i, h] = softmax_{j <= i, j < lengths[b]}(q[b, i, h] . k[b, j, h // G]
                   * sm_scale) . v[b, j, h // G]
with G = H // Hkv. The JAX package computes it outside any kernel
(recsys_examples_tpu/models/qwen3.py:154-162); so does `prefill_attn_ref`.

  - CUDA tensors launch the hand-written kernel Q1
    (`csrc/prefill_attention.cu`: bf16 on wgmma with 128-key TMA tiles and an
    online softmax, no [B, H, N, N] tensor; fp32 on scalar FMA; head dims 64
    and 128, any other zero-padded to the next by the wrapper,
    `ops/head_dims.py`) or raise;
  - CPU tensors run `prefill_attn_ref`.
`prefill_attn.launches` counts kernel launches, and so does the counter
`attn/prefill_launches` (`utils/observability.count`) while tracing is on.

Rows at or past `lengths[b]` differ between the two: the plain version
gives them the mean of V over the whole bucket (every score masked), the
kernel zeros. They feed only padded positions, which nothing reads.
`prefill_attn_tiled_ref` states the kernel's arithmetic in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from recsys_examples_torch.ops.beam_decode_attention import _check
from recsys_examples_torch.ops.head_dims import instance_head_dim, pad_head_dim, unpad_head_dim
from recsys_examples_torch.utils import observability

NEG_INF = -1e30
COUNTER = "attn/prefill_launches"
PREFILL_KEYS = 128        # keys per tile (Q1's `wg::BK`)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIMS = (64, 128)


def prefill_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """The plain version: q [B, N, H, D], k and v [B, N, Hkv, D] -> out
    [B, N, H, D] in q's dtype. GQA by repeating the kv heads, fp32 scores
    [B, H, N, N], a -1e30 mask, an fp32 softmax, P cast to q's dtype before
    P.V."""
    B, N, H, D = q.shape
    G = H // k.shape[2]
    dt = q.dtype
    kr = k.repeat_interleave(G, dim=2)
    vr = v.repeat_interleave(G, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * sm_scale
    ar = torch.arange(N, device=q.device)
    causal = ar[None, :, None] >= ar[None, None, :]
    valid = ar[None, :] < lengths[:, None]
    mask = causal & valid[:, :, None] & valid[:, None, :]
    sc = torch.where(mask[:, None], sc, sc.new_full((), NEG_INF))
    p = torch.softmax(sc, dim=-1).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), vr.float()).to(dt)


def prefill_attn_tiled_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, sm_scale: float,
                           tile: int = PREFILL_KEYS) -> torch.Tensor:
    """Q1's arithmetic in plain PyTorch: per batch row, the valid keys in
    tiles of `tile`, an online softmax in log2 units (t = s sm_scale
    log2(e); fp32 running max m and sum l; p = 2^(t - m), a masked key's
    exactly 0), O += P V with the unnormalised P rounded to q's dtype while
    l sums it unrounded, then O times 1 / l once. Rows at or past
    lengths[b] are zero. Returns [B, N, H, D] in q's dtype."""
    B, N, H, D = q.shape
    G = H // k.shape[2]
    pdt = q.dtype
    c = sm_scale * math.log2(math.e)
    out = torch.zeros(B, N, H, D, device=q.device)
    for b in range(B):
        L = max(0, min(int(lengths[b]), N))
        if L == 0:
            continue
        qf = q[b, :L].float().transpose(0, 1)                                 # [H, L, D]
        kf = k[b, :L].float().repeat_interleave(G, dim=1).transpose(0, 1)
        vf = v[b, :L].float().repeat_interleave(G, dim=1).transpose(0, 1)
        rows = torch.arange(L, device=q.device)
        m = torch.full((H, L), NEG_INF, device=q.device)
        l = torch.zeros(H, L, device=q.device)
        o = torch.zeros(H, L, D, device=q.device)
        for k0 in range(0, L, tile):
            keys = rows[k0:k0 + tile]
            t = (qf @ kf[:, k0:k0 + tile].transpose(1, 2)) * c                  # [H, L, K]
            t = torch.where(keys[None, :] <= rows[:, None], t, torch.full((), NEG_INF,
                                                                          device=q.device))
            m_new = torch.maximum(m, t.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(t - m_new[..., None])
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + p.to(pdt).float() @ vf[:, k0:k0 + tile]
            m = m_new
        out[b, :L] = (o * (1.0 / l)[..., None]).transpose(0, 1)
    return out.to(pdt)


def _lib():
    from recsys_examples_torch.utils import cuda_build

    fn = cuda_build.load("prefill_attention").prefill_attn_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 4 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_cuda(q, k, v, lengths, sm_scale):
    B, N, H, D = q.shape
    Hkv = k.shape[2]
    dev, dt = q.device, q.dtype
    if dev.type != "cuda":
        raise ValueError(f"the prefill attention kernel takes CUDA tensors, got {dev}")
    if dt not in _DTYPE_CODE:
        raise TypeError(f"the prefill attention kernel takes bf16 or fp32, got {dt}")
    if D not in _HEAD_DIMS:   # zero columns add zero scores; sm_scale stays the caller's
        d = instance_head_dim(D, _HEAD_DIMS)
        out = _launch_cuda(pad_head_dim(q, d), pad_head_dim(k, d), pad_head_dim(v, d),
                           lengths, sm_scale)
        return unpad_head_dim(out, D)
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads do not divide into {Hkv} kv heads")
    _check("q", q, dt, (B, N, H, D), dev, 2)
    _check("k", k, dt, (B, N, Hkv, D), dev, 2)
    _check("v", v, dt, (B, N, Hkv, D), dev, 2)
    if k.stride() != v.stride():
        raise ValueError("k and v must share their strides")
    lengths = lengths.to(torch.int64).contiguous()   # the models keep int64: no copy
    _check("lengths", lengths, torch.int64, (B,), dev, 1)
    out = torch.empty((B, N, H, D), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        err = _lib()(
            _DTYPE_CODE[dt], q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, N, H, Hkv, D, q.stride(0), q.stride(1) if N > 1 else H * D,
            k.stride(0), k.stride(1) if N > 1 else Hkv * D,   # a map's row stride is never 0
            float(sm_scale), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"prefill_attn launch failed: error {err}")
    prefill_attn.launches += 1
    observability.count(COUNTER)
    return out


def prefill_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
                 sm_scale: float) -> torch.Tensor:
    """Causal GQA attention over padded contexts. q [B, N, H, D], k and v
    [B, N, Hkv, D] (as they leave RoPE), lengths [B] -> out [B, N, H, D] in
    q's dtype: the kernel on CUDA tensors, which never falls back (a failed
    build or launch raises), the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return prefill_attn_ref(q, k, v, lengths, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch_cuda(q, k, v, lengths, sm_scale)


prefill_attn.launches = 0
