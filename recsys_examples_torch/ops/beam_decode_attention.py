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
    (`csrc/beam_decode_attention.cu`; bf16 on wgmma, fp32 on scalar FMA, head
    dims 32/64/128/256, any other zero-padded to the next by the wrapper,
    `ops/head_dims.py`) or raise;
  - CPU tensors, and `backend="plain"`, run `beam_decode_attn_ref`.
`beam_decode_attn.launches` counts kernel launches.

A row with no key at all (`ctx_lens[b] == 0` and N == 0) comes out as zero,
as in the TPU kernel; the JAX package's jnp twin returns the mean of V there.

On bf16 the kernel splits each (batch row, kv head)'s keys over a cluster of
CTAs and merges their softmax states; the plan and the chunk walk are stated
here in plain Python (`beam_split_plan` and what follows it), with
`beam_decode_attn_split_ref` as the kernel's arithmetic.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from recsys_examples_torch.ops.head_dims import instance_head_dim, pad_head_dim, unpad_head_dim
from recsys_examples_torch.utils.clusters import MAX_SPLITS, one_wave_split

NEG_INF = -1e30
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIMS = (32, 64, 128, 256)


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
    if scores.shape[-1] == 0:   # S 0 and N 0: no key anywhere
        return torch.zeros_like(q)
    scores = torch.where(valid, scores, scores.new_full((), NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m) * valid.to(scores.dtype)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bwhs,bshd->bwhd", p[..., :S], vc)
    if values is not None:
        out = out + torch.einsum("bwhn,bnwhd->bwhd", p[..., S:], values)
    return out.to(q.dtype)


# ---------------------------------------------------------------- the kernel's plan
# The bf16 kernel's work split, stated in plain Python; the kernel
# (`csrc/beam_decode_attention.cu`) copies `beam_batch_order`,
# `beam_row_tiles`, `beam_cta_rows` and `beam_cta_chunks` line by line, and the wrapper launches the plan of
# `beam_split_plan`. A (batch row, kv head) holds G W query rows, row r
# being beam r // G of query head kv_head * G + r % G.
BEAM_CHUNK = 64          # context keys per chunk: one 64-row TMA tile
BEAM_ROWS = 64           # query rows per consumer warpgroup (one wgmma M)
BEAM_CONSUMERS = 2       # consumer warpgroups per CTA
BEAM_CTA_ROWS = BEAM_ROWS * BEAM_CONSUMERS


class BeamPlan(NamedTuple):
    splits: int      # CTAs that share one (batch row, kv head, row tile): a cluster
    tiles: int       # row tiles per (batch row, kv head)
    grid: Tuple[int, int, int]   # (splits, tiles, B * Hkv)


def beam_batch_order(ctx_lens, S: int):
    """The batch rows in the order their CTAs launch: longest context first,
    ties by index (CTA z of the grid takes row order[z // Hkv], kv head
    z % Hkv). Each CTA finds its row by ranking ctx_lens itself: row i's
    rank is the count of rows j with a longer context, or as long and
    j < i."""
    lens = [max(0, min(int(x), S)) for x in ctx_lens]
    rank = [sum(lj > li or (lj == li and j < i) for j, lj in enumerate(lens))
            for i, li in enumerate(lens)]
    order = [0] * len(lens)
    for i, k in enumerate(rank):
        order[k] = i
    return order


def beam_row_tiles(W: int, G: int, cta_rows: int = BEAM_CTA_ROWS) -> int:
    """Row tiles of a (batch row, kv head): its G W rows in the fewest CTAs
    of at most `cta_rows` rows."""
    return -(-G * W // cta_rows)


def beam_cta_rows(tile: int, tiles: int, W: int, G: int) -> Tuple[int, int]:
    """The rows [r0, r1) of row tile `tile`: an even share, so that no tile
    makes a context pass for a handful of rows while another is full (W 200:
    two tiles of 100, not 128 and 72; W 129: 65 and 64, not 128 and 1)."""
    R = G * W
    return tile * R // tiles, (tile + 1) * R // tiles


def beam_split_plan(B: int, W: int, H: int, Hkv: int, S: int, N: int,
                    capacity: Callable[[int], int],
                    cta_rows: int = BEAM_CTA_ROWS) -> BeamPlan:
    """The grid of the bf16 kernel, from shapes alone (no device value is
    read, so no host sync): the largest split over the keys, at most
    MAX_SPLITS and at most the units a (batch row, kv head) can have (its
    context chunks and N tail steps), whose clusters (one per batch row, kv
    head and row tile) the card holds all at once (`one_wave_split`).
    `capacity(splits)` is how many clusters of `splits` CTAs it holds (the
    wrapper asks the card)."""
    tiles = beam_row_tiles(W, H // Hkv, cta_rows)
    splits = one_wave_split(B * Hkv * tiles, -(-S // BEAM_CHUNK) + N, capacity)
    return BeamPlan(splits, tiles, (splits, tiles, B * Hkv))


def beam_cta_chunks(rank: int, splits: int, n_ctx: int, N: int) -> Tuple[int, int, bool]:
    """(first context chunk, end, whether it takes the tail) of the CTA of
    cluster rank `rank`, out of n_ctx context chunks and N tail steps: an
    even share of the n_ctx + N units in order, the tail's steps all going
    to the last rank (which takes fewer context chunks for them)."""
    T = n_ctx + N
    begin = min(rank * T // splits, n_ctx)
    end = n_ctx if rank == splits - 1 else min((rank + 1) * T // splits, n_ctx)
    return begin, end, rank == splits - 1 and N > 0


def beam_decode_attn_split_ref(
    q, k_ctx, v_ctx, ctx_lens, k_beam, v_beam, ancestry, sm_scale: float = 1.0,
    *, splits: int,
):
    """The bf16 kernel's arithmetic in plain PyTorch: per (batch row, kv
    head) the `splits` CTAs of a cluster each take their context chunks
    (`beam_cta_chunks`), the last one then the N tail keys, and run an
    online softmax (fp32 m and l; l sums the unrounded P, O sums P rounded to
    q's dtype times V); the states merge in rank order, O = sum O_q e_q /
    sum l_q e_q with e_q = exp(m_q - max m). Returns [B, W, H, D] in q's
    dtype; a row with no key is zero."""
    B, W, H, D = q.shape
    S, Hkv = k_ctx.shape[1:3]
    G = H // Hkv
    N = 0 if k_beam is None else k_beam.shape[1]
    pdt = q.dtype
    out = torch.zeros(B, W, H, D)
    for b in range(B):
        L = max(0, min(int(ctx_lens[b]), S))
        n_ctx = -(-L // BEAM_CHUNK)
        for kvh in range(Hkv):
            heads = slice(kvh * G, (kvh + 1) * G)
            qf = q[b, :, heads].float().reshape(W * G, D)      # row r = w G + g
            states = []
            for rank in range(splits):
                begin, end, tail = beam_cta_chunks(rank, splits, n_ctx, N)
                m = torch.full((W * G,), NEG_INF)
                l = torch.zeros(W * G)
                o = torch.zeros(W * G, D)

                def step(s, v):   # s [R, K] scaled scores (NEG_INF masked), v [K, D] or [R, K, D]
                    nonlocal m, l, o
                    m_new = torch.maximum(m, s.amax(1))
                    corr = torch.exp(m - m_new)
                    p = torch.where(s > NEG_INF, torch.exp(s - m_new[:, None]), torch.zeros(()))
                    pv = p.to(pdt).float()
                    pv = pv @ v if v.dim() == 2 else torch.einsum("rk,rkd->rd", pv, v)
                    l = l * corr + p.sum(1)
                    o = o * corr[:, None] + pv
                    m = m_new

                for c in range(begin, end):
                    pos = torch.arange(c * BEAM_CHUNK, (c + 1) * BEAM_CHUNK)
                    kc, vc = torch.zeros(BEAM_CHUNK, D), torch.zeros(BEAM_CHUNK, D)
                    inside = pos < S
                    kc[inside] = k_ctx[b, pos[inside], kvh].float()
                    vc[inside] = v_ctx[b, pos[inside], kvh].float()
                    s = (qf @ kc.T) * sm_scale
                    step(torch.where((pos < L)[None, :], s, torch.full((), NEG_INF)), vc)
                for n in range(N if tail else 0):
                    slot = ancestry[b, n].long().repeat_interleave(G)           # [W G]
                    kt = k_beam[b, n, slot, kvh].float()
                    vt = v_beam[b, n, slot, kvh].float()
                    step(((qf * kt).sum(1) * sm_scale)[:, None], vt[:, None])
                states.append((m, l, o))
            M = torch.stack([st[0] for st in states]).amax(0)
            num, den = torch.zeros(W * G, D), torch.zeros(W * G)
            for m, l, o in states:
                e = torch.exp(m - M)
                den = den + l * e
                num = num + o * e[:, None]
            out[b, :, heads] = (num / den.clamp_min(1e-30)[:, None]).reshape(W, G, D)
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
    + [ctypes.c_longlong] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)


def _lib(entry="beam_decode_attn_launch", argtypes=_ARGTYPES):
    from recsys_examples_torch.utils import cuda_build

    fn = getattr(cuda_build.load("beam_decode_attention"), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def beam_cluster_capacity(device: int, dh: int, splits: int) -> int:
    """Clusters of `splits` CTAs of the bf16 kernel at head dim dh that card
    `device` holds at once (a host query, no device value read)."""
    fn = _lib("beam_cluster_capacity", [ctypes.c_int] * 2)
    with torch.cuda.device(device):
        n = fn(dh, splits)
    if n < 0:
        raise RuntimeError(f"beam-decode attention: cluster capacity query failed: error {n}")
    return n


def beam_launch_plan(q, k_ctx, N: int) -> BeamPlan:
    """The plan the wrapper launches the bf16 kernel with: from the shapes,
    and what the card holds (CUDA tensors). Kept per shape and card, so that
    a decode step's call costs the host one lookup."""
    B, W, H, D = q.shape
    S, Hkv = k_ctx.shape[1:3]
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    return _shape_plan(dev, B, W, H, Hkv, D, S, N)


@functools.lru_cache(maxsize=1024)
def _shape_plan(dev, B, W, H, Hkv, D, S, N) -> BeamPlan:
    return beam_split_plan(B, W, H, Hkv, S, N, lambda s: beam_cluster_capacity(dev, D, s))


def _launch_cuda(q, k_ctx, v_ctx, ctx_lens, k_beam, v_beam, ancestry, sm_scale, splits=None):
    """The kernel; bf16 takes `splits` CTAs a cluster (the wrapper's plan
    when None)."""
    B, W, H, D = q.shape
    S, Hkv = k_ctx.shape[1:3]
    dev, dt = q.device, q.dtype
    if dev.type != "cuda":
        raise ValueError(f"the beam-decode attention kernel takes CUDA tensors, got {dev}")
    if dt not in _DTYPE_CODE:
        raise TypeError(f"beam-decode attention kernel takes bf16 or fp32, got {dt}")
    if D not in _HEAD_DIMS:   # zero columns add zero scores; sm_scale stays the caller's
        d = instance_head_dim(D, _HEAD_DIMS)
        k_beam, v_beam = (None, None) if k_beam is None else (
            pad_head_dim(k_beam, d), pad_head_dim(v_beam, d))
        out = _launch_cuda(pad_head_dim(q, d), pad_head_dim(k_ctx, d), pad_head_dim(v_ctx, d),
                           ctx_lens, k_beam, v_beam, ancestry, sm_scale, splits)
        return unpad_head_dim(out, D)
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
    if splits is None:
        splits = beam_launch_plan(q, k_ctx, N).splits if dt == torch.bfloat16 else 1
    out = torch.empty((B, W, H, D), dtype=dt, device=dev)
    ptr = lambda t: t.data_ptr() if N else None
    with torch.cuda.device(dev):
        err = _lib()(
            _DTYPE_CODE[dt], q.data_ptr(), k_ctx.data_ptr(), v_ctx.data_ptr(),
            ctx_lens.data_ptr(), ptr(k_beam), ptr(v_beam), ptr(ancestry),
            out.data_ptr(), B, W, H, Hkv, D, S, N,
            q.stride(0), q.stride(1), k_ctx.stride(0),
            k_ctx.stride(1) if S > 1 else Hkv * D,   # a map's row stride is never 0
            *beam_strides, float(sm_scale), int(splits),
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
