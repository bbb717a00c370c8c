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
runs that product in fp32). fp32 queries and new tokens over int8 pages are
cast to bf16 by the wrapper and the output back to fp32.

On bf16 and int8 pages the kernel splits each user's keys over a cluster of
CTAs and sums their partial outputs (SiLU attention has no normaliser); the
plan and the chunk walk are stated here in plain Python (`paged_split_plan`
and what follows it), with `paged_hstu_delta_attention_split_ref` as the
kernel's arithmetic. Any page size: `paged_page_chunking` says how the
cached positions split into chunks. The kernels are built for head dims
32/64/128/256; the wrapper zero-pads any other head dim up to the next one
(`ops/head_dims.py`) and slices the output.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from recsys_examples_torch.ops.head_dims import instance_head_dim, pad_head_dim, unpad_head_dim
from recsys_examples_torch.utils.clusters import MAX_SPLITS, one_wave_split

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIMS = (32, 64, 128, 256)


def paged_delta_valid(page_table, cached_len, new_lens, num_targets, S: int,
                      pg: int) -> torch.Tensor:
    """The delta mask [B, S, maxp * pg + S] over [the cached positions ++ the
    S new-token slots]: query i of user b against key column n."""
    B, maxp = page_table.shape
    Nc = maxp * pg
    dev = page_table.device
    pt = page_table.to(torch.int64)
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
    return valid


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
    pid = page_table.to(torch.int64).clamp(0, P - 1)
    kc = k_pages[pid].reshape(B, Nc, H, dh)
    vc = v_pages[pid].reshape(B, Nc, H, dh)
    k = torch.cat([kc, new_k.to(kc.dtype)], dim=1)        # [B, Nc + S, H, dh]
    v = torch.cat([vc, new_v.to(vc.dtype)], dim=1)
    valid = paged_delta_valid(page_table, cached_len, new_lens, num_targets, S, pg)
    sc = torch.einsum("bshd,bnhd->bhsn", q.float(), k.float()) * alpha
    p = F.silu(sc) * (1.0 / scaling_seqlen) * valid[:, None].to(sc.dtype)
    p = p.to(v.dtype).float()
    out = torch.einsum("bhsn,bnhd->bshd", p, v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------- the kernel's plan
# The bf16 and int8 kernels' work split, stated in plain Python; the kernel
# (`csrc/paged_hstu_attention.cu`) copies `paged_page_chunking`,
# `paged_chunk_span`, `paged_page_chunks`, `paged_chunk_counts`,
# `paged_cta_chunks`, `paged_chunk_fully_valid` and `paged_chunk_valid` line
# by line, and the wrapper launches the plan of `paged_split_plan`.
PAGED_CHUNK = 64         # key positions per chunk: one 64-row TMA tile
PAGED_ROWS = 64          # query rows per consumer warpgroup (one wgmma M)


class PagedPlan(NamedTuple):
    splits: int      # CTAs that share one (user, query block, head): a cluster
    consumers: int   # consumer warpgroups per CTA
    rows: int        # query rows per CTA
    qblocks: int     # query blocks per user
    grid: Tuple[int, int, int]   # (splits, H, B * qblocks)


def paged_query_blocks(S: int) -> Tuple[int, int, int]:
    """(consumers, rows, query blocks) of a CTA: one consumer warpgroup for
    S <= 64 (decode), two above."""
    consumers = 1 if S <= PAGED_ROWS else 2
    rows = PAGED_ROWS * consumers
    return consumers, rows, -(-S // rows)


def paged_page_chunking(pg: int) -> Tuple[int, int, int, int]:
    """How the cached positions split into page chunks: (unit, chunks per
    unit, boxes per chunk, rows per box). The positions go in units of
    whole pages, each cut into 64-key chunks and a remainder:
      - pg >= 64: a unit is one page; a chunk is one box of 64 rows, the
        remainder's box reading past its page (masked);
      - pg < 64 and a multiple of 8: a unit is the most whole pages within
        64 keys (8, 16, 32: 64 keys; 24 and 48: 48), one box a page, every
        box on an 8-row swizzle atom;
      - any other pg: one page a unit and a chunk.
    A chunk shorter than 64 keys leaves the tile's last rows unloaded: the
    kernel zeroes them once and masks their columns."""
    if pg >= PAGED_CHUNK:
        return pg, -(-pg // PAGED_CHUNK), 1, PAGED_CHUNK
    pages = PAGED_CHUNK // pg if pg % 8 == 0 else 1
    return pages * pg, 1, pages, pg


def paged_chunk_span(c: int, pg: int) -> Tuple[int, int]:
    """(first position, keys) of page chunk c."""
    unit, cpu, _, _ = paged_page_chunking(pg)
    k = c % cpu
    return (c // cpu) * unit + k * PAGED_CHUNK, min(PAGED_CHUNK, unit - k * PAGED_CHUNK)


def paged_page_chunks(reach: int, pg: int) -> int:
    """Page chunks over the cached positions [0, reach)."""
    unit, cpu, _, _ = paged_page_chunking(pg)
    return reach // unit * cpu + -(-(reach % unit) // PAGED_CHUNK)


def paged_split_plan(B: int, S: int, H: int, maxp: int, pg: int,
                     capacity: Callable[[int, int], int]) -> PagedPlan:
    """The grid of the bf16 and int8 kernels, from shapes alone (no device
    value is read, so no host sync): the largest split over keys, at most
    MAX_SPLITS and at most the chunks a user can have, whose clusters
    (one per user, query block and head) the card holds all at once.
    `capacity(consumers, splits)` is how many clusters of `splits` CTAs it
    holds (the wrapper asks the card). A second wave of clusters costs more
    than the split saves: an H100 holds 39 clusters of 3 and 30 of 4, so the
    serving shape's 32 (user, head) pairs split 3 ways (PERF.md §6). Any
    page size (`paged_page_chunking`)."""
    if pg < 1:
        raise ValueError(f"page size {pg}")
    consumers, rows, qblocks = paged_query_blocks(S)
    most = paged_page_chunks(maxp * pg, pg) + -(-min(S, rows) // PAGED_CHUNK)
    splits = one_wave_split(B * H * qblocks, most, lambda s: capacity(consumers, s))
    return PagedPlan(splits, consumers, rows, qblocks, (splits, H, B * qblocks))


def paged_chunk_counts(cached: int, new_len: int, S: int, m0: int, rows: int, maxp: int,
                       pg: int) -> Tuple[int, int]:
    """(page chunks, tail chunks) of the query block at row m0: page chunk c
    < n_page covers the cached positions of `paged_chunk_span(c, pg)`, up to
    the page table's reach; chunk n_page + u the new tokens [64 u, 64 u + 64)
    that the block's rows can see. (0, 0) for a block without a live row."""
    live = min(new_len, S)
    if live <= m0:
        return 0, 0
    n_page = paged_page_chunks(min(cached, maxp * pg), pg)
    n_tail = -(-min(live, m0 + rows) // PAGED_CHUNK)
    return n_page, n_tail


def paged_cta_chunks(rank: int, splits: int, n: int) -> Tuple[int, int]:
    """The chunks [begin, end) of the CTA of cluster rank `rank`: an even
    share of the block's n chunks, in order."""
    return rank * n // splits, (rank + 1) * n // splits


def paged_chunk_fully_valid(c: int, cached: int, hist_end: int, page_row, pg: int,
                            maxp: int) -> bool:
    """Page chunk c is valid for every live row: it holds 64 keys, ends
    below both the cache and the history end (every column col < hist_end,
    and every row cached + i > col), and each page it touches is set. Such a
    chunk takes no mask."""
    c0, n = paged_chunk_span(c, pg)
    if n < PAGED_CHUNK or c0 + PAGED_CHUNK > min(cached, hist_end):
        return False
    return all(j < maxp and page_row[j] >= 0
               for j in range(c0 // pg, (c0 + PAGED_CHUNK - 1) // pg + 1))


def paged_chunk_valid(rows, c: int, n_page: int, cached: int, new_len: int, hist_end: int,
                      S: int, page_row, pg: int, maxp: int) -> torch.Tensor:
    """The mask of chunk c for query rows `rows` [R] (int64), [R, 64], live
    rows only: a page chunk's column test (one of its keys, below the cache
    and the history end, page set), or a tail chunk's delta mask."""
    j = torch.arange(PAGED_CHUNK)
    if c < n_page:
        c0, n = paged_chunk_span(c, pg)
        col = c0 + j
        page = col // pg
        row_ids = torch.as_tensor(page_row, dtype=torch.int64)
        set_ = (page < maxp) & (row_ids[page.clamp(max=maxp - 1)] >= 0)
        ok = (j < n) & (col < min(cached, hist_end)) & set_
        return ok[None, :].expand(len(rows), PAGED_CHUNK)
    t = (c - n_page) * PAGED_CHUNK + j
    col = (cached + t)[None, :]
    row = (cached + rows)[:, None]
    he = torch.tensor(hist_end)
    delta = (col == row) | (torch.minimum(row, he) - torch.minimum(col, he) > 0)
    return (t < min(new_len, S))[None, :] & delta


def paged_hstu_delta_attention_split_ref(
    q, k_pages, v_pages, page_table, cached_len, new_k, new_v, new_lens, num_targets,
    alpha: float, scaling_seqlen: float, *, splits: int, k_scales=None, v_scales=None,
):
    """The bf16 and int8 kernels' arithmetic in plain PyTorch: per (user,
    query block, head) the `splits` CTAs of a cluster each take their
    chunks (`paged_cta_chunks`), compute a fp32 partial output (certified
    chunks unmasked, the others through `paged_chunk_valid`), and the
    partials are summed in rank order; rows i >= new_len are zeroed. P rounds
    to the V operand's dtype (bf16 pages, the new tokens) or, over int8
    pages, to q's dtype after the V scale is folded in; int8 scores take
    alpha and then the K scale."""
    B, S, H, dh = q.shape
    P, pg = k_pages.shape[:2]
    maxp = page_table.shape[1]
    _, rows_per_block, qblocks = paged_query_blocks(S)
    quant = k_scales is not None
    inv = 1.0 / scaling_seqlen
    out = torch.zeros(B, S, H, dh)
    zero_row = torch.zeros(H, dh)
    tgt = [0] * B if num_targets is None else num_targets.tolist()
    for b in range(B):
        cached, nl = int(cached_len[b]), int(new_lens[b])
        he = cached + nl - tgt[b]
        prow = page_table[b].tolist()

        def page_rows(x, c):      # [64, H, ...] of chunk c's cached positions, 0 past its keys
            rows = []
            c0, n = paged_chunk_span(c, pg)
            for pos in range(c0, c0 + PAGED_CHUNK):
                j = pos // pg
                pid = prow[j] if j < maxp and pos < c0 + n else -1
                rows.append(x[pid, pos % pg].float() if pid >= 0 else torch.zeros_like(x[0, 0],
                                                                                     dtype=torch.float32))
            return torch.stack(rows)

        def tail_rows(x, u):      # [64, H, dh] of new tokens 64 u ..; zeros past S
            t = torch.zeros(PAGED_CHUNK, H, dh)
            hi = min(S, (u + 1) * PAGED_CHUNK)
            if hi > u * PAGED_CHUNK:
                t[:hi - u * PAGED_CHUNK] = x[b, u * PAGED_CHUNK:hi].float()
            return t

        for qb in range(qblocks):
            m0 = qb * rows_per_block
            rows = torch.arange(m0, min(m0 + rows_per_block, S))
            n_page, n_tail = paged_chunk_counts(cached, nl, S, m0, rows_per_block, maxp, pg)
            n = n_page + n_tail
            qf = q[b, m0:m0 + len(rows)].float()                       # [R, H, dh]
            total = torch.zeros(len(rows), H, dh)
            for r in range(splits):
                part = torch.zeros(len(rows), H, dh)
                for c in range(*paged_cta_chunks(r, splits, n)):
                    page = c < n_page
                    if page:
                        kc, vc = page_rows(k_pages, c), page_rows(v_pages, c)
                        pdt = q.dtype if quant else v_pages.dtype
                    else:
                        kc, vc = tail_rows(new_k, c - n_page), tail_rows(new_v, c - n_page)
                        pdt = new_v.dtype
                    x = torch.einsum("rhd,nhd->rhn", qf, kc) * alpha
                    if page and quant:
                        x = x * page_rows(k_scales, c).T[None]
                    p = F.silu(x) * inv
                    if page and quant:
                        p = p * page_rows(v_scales, c).T[None]
                    if not (page and paged_chunk_fully_valid(c, cached, he, prow, pg, maxp)):
                        ok = paged_chunk_valid(rows, c, n_page, cached, nl, he, S, prow, pg, maxp)
                        p = torch.where(ok[:, None, :], p, torch.zeros(()))
                    part += torch.einsum("rhn,nhd->rhd", p.to(pdt).float(), vc)
                total += part
            total[rows >= nl] = zero_row
            out[b, m0:m0 + len(rows)] = total
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
    [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
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


@functools.lru_cache(maxsize=None)
def paged_cluster_capacity(device: int, int8: bool, dh: int, consumers: int, H: int,
                           splits: int) -> int:
    """Clusters of `splits` CTAs of the bf16 (or int8) kernel instance that
    card `device` holds at once (a host query, no device value read)."""
    fn = _lib("paged_cluster_capacity", [ctypes.c_int] * 5)
    with torch.cuda.device(device):
        n = fn(int(int8), dh, consumers, H, splits)
    if n < 0:
        raise RuntimeError(f"paged attention: cluster capacity query failed: error {n}")
    return n


def paged_launch_plan(q, k_pages, page_table) -> PagedPlan:
    """The plan the wrapper launches the bf16 and int8 kernels with: from the
    shapes, and what the card holds (CUDA tensors)."""
    B, S, H, dh = q.shape
    dh = instance_head_dim(dh, _HEAD_DIMS)   # the instance a padded call launches
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    int8 = k_pages.dtype == torch.int8
    return paged_split_plan(
        B, S, H, page_table.shape[1], k_pages.shape[1],
        lambda nc, s: paged_cluster_capacity(dev, int8, dh, nc, H, s))


def _raise_on(err, name):
    if err == -4:
        raise ValueError(f"{name}: the int8 scale stages of this many heads do not fit in "
                         "the kernel's shared memory")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err}")


def _padded(q, k_pages, v_pages, new_k, new_v):
    """The operands zero-padded to the next built head dim, and the head dim
    to slice the output back to."""
    dh = q.shape[-1]
    d = instance_head_dim(dh, _HEAD_DIMS)
    return tuple(pad_head_dim(x, d) for x in (q, k_pages, v_pages, new_k, new_v)), dh


def _launch_cuda(q, k_pages, v_pages, page_table, cached_len, new_k, new_v,
                 new_lens, num_targets, alpha, scaling_seqlen):
    dev, dt = q.device, q.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"paged attention kernel takes bf16 or fp32, got {dt}")
    (q, k_pages, v_pages, new_k, new_v), dh0 = _padded(q, k_pages, v_pages, new_k, new_v)
    B, S, H, dh, P, pg, maxp = _check_operands(
        q, k_pages, v_pages, page_table, cached_len, new_k, new_v, new_lens,
        num_targets, dt)
    # the fp32 scalar kernel takes no plan
    splits, consumers = 1, 1
    if dt == torch.bfloat16:
        splits, consumers = paged_launch_plan(q, k_pages, page_table)[:2]
    fn = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            _DTYPE_CODE[dt], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), page_table.data_ptr(), cached_len.data_ptr(),
            new_k.data_ptr(), new_v.data_ptr(), new_lens.data_ptr(),
            None if num_targets is None else num_targets.data_ptr(),
            out.data_ptr(), B, S, H, dh, pg, maxp, P, splits, consumers,
            float(alpha), 1.0 / float(scaling_seqlen), stream,
        )
    _raise_on(err, "paged_hstu_delta_attention")
    paged_hstu_delta_attention.launches += 1
    return unpad_head_dim(out, dh0)


_ARGTYPES_INT8 = (
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
    + [ctypes.c_void_p]
)


def paged_hstu_delta_attention_int8(
    q, k_pages, v_pages, k_scales, v_scales, page_table, cached_len, new_k,
    new_v, new_lens, num_targets, alpha: float, scaling_seqlen: float,
):
    """The int8 instance of the kernel: CUDA tensors only, int8 pages
    [P, pg, H, dh] with fp32 scales [P, pg, H]; q / new_k / new_v bf16, or
    fp32 (cast to bf16 here, the output back to fp32). `launches` counts its
    launches."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the int8 paged attention kernel takes CUDA tensors, got {dev}")
    if q.dtype == torch.float32:
        bf = lambda x: x.to(torch.bfloat16)
        return paged_hstu_delta_attention_int8(
            bf(q), k_pages, v_pages, k_scales, v_scales, page_table, cached_len, bf(new_k),
            bf(new_v), new_lens, num_targets, alpha, scaling_seqlen).float()
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the int8 paged attention kernel takes bf16 or fp32 queries, "
                        f"got {q.dtype}")
    (q, k_pages, v_pages, new_k, new_v), dh0 = _padded(q, k_pages, v_pages, new_k, new_v)
    B, S, H, dh, P, pg, maxp = _check_operands(
        q, k_pages, v_pages, page_table, cached_len, new_k, new_v, new_lens,
        num_targets, torch.int8)
    _check("k_scales", k_scales, torch.float32, (P, pg, H), dev)
    _check("v_scales", v_scales, torch.float32, (P, pg, H), dev)
    plan = paged_launch_plan(q, k_pages, page_table)
    fn = _lib("paged_hstu_delta_attention_int8_launch", _ARGTYPES_INT8)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = fn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(), page_table.data_ptr(),
            cached_len.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
            new_lens.data_ptr(),
            None if num_targets is None else num_targets.data_ptr(),
            out.data_ptr(), B, S, H, dh, pg, maxp, P, plan.splits, plan.consumers,
            float(alpha), 1.0 / float(scaling_seqlen),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "paged_hstu_delta_attention_int8")
    paged_hstu_delta_attention_int8.launches += 1
    return unpad_head_dim(out, dh0)


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
