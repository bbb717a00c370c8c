"""Plain (dense-padded) HSTU attention with the full mask zoo, forward and
backward (counterpart of recsys_examples_tpu/ops/hstu_attention_ref.py).

These are the plain versions of the CUDA kernels K1 (forward) in
`csrc/hstu_attention_fwd.cu`, K2 (dq) and K3 (dk/dv) in
`csrc/hstu_attention_bwd.cu`, with `rab` of K4 (the same three
with a relative attention bias, and its gradient), and of K5 (the int8
forward, `hstu_mha_int8_reference`): the CPU path of
`ops.hstu_attention.hstu_attn_varlen`, and what `chip_smoke.py` holds the
kernels against on the card. Beside them stand the plain statements of
the tile plans of K1, K2 and K3, and the tile walks of K4's forward and
dk/dv (`rab_fwd_tile_walk`, `rab_dkv_tile_walk`).

HSTU attention is SiLU attention, not softmax:

    S = alpha q k^T (+ rab),  P = silu(S) / scaling_seqlen * mask,  out = P v

Sums are fp32; the bf16 rounding points are those of the kernels: P to v's
dtype before P v; in the backward dO to v's dtype, dS to k's dtype for dq
and to q's dtype for dk, P to dO's dtype for dv.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from recsys_examples_torch.ops.jagged import (
    jagged_to_padded_dense,
    padded_dense_to_jagged,
)


def get_valid_attn_mask(
    causal: bool,
    N: int,
    seq_lengths: torch.Tensor,
    num_targets: Optional[torch.Tensor] = None,
    max_attn_len: int = 0,
    num_contextuals: Optional[Union[int, torch.Tensor]] = None,
    min_full_attn_seq_len: int = 0,
    target_group_size: int = 1,
) -> torch.Tensor:
    """[B, N, N] bool mask (row = query position, col = key position)."""
    B = seq_lengths.shape[0]
    dev = seq_lengths.device
    ids = torch.arange(N, device=dev)[None, :]
    max_ids = seq_lengths.to(torch.int64).reshape(B, 1, 1)
    has_context = num_contextuals is not None and not (
        isinstance(num_contextuals, int) and num_contextuals == 0
    )
    if has_context:
        if isinstance(num_contextuals, int):
            ctx = torch.full((B, 1), num_contextuals, dtype=torch.int64, device=dev)
        else:
            ctx = num_contextuals.to(torch.int64).reshape(B, 1)
        # contextual tokens collapse onto position 0; history starts at 1
        ids = (ids - ctx + 1).clamp_min(0)
        max_ids = max_ids - ctx.reshape(B, 1, 1) + 1
    else:
        ids = ids.expand(B, N)
    row_ids = ids[:, :, None]
    col_ids = ids[:, None, :]
    row_col_dist = row_ids - col_ids
    if not causal:
        row_col_dist = row_col_dist.abs()
    valid = torch.eye(N, dtype=torch.bool, device=dev)[None] | (row_col_dist > 0)

    if num_targets is not None:
        nt = num_targets.to(torch.int64).reshape(B, 1, 1)
        # group index of each target token (floor div; -1 clamps history)
        tg_row = torch.div((row_ids - max_ids + nt).clamp_min(-1), target_group_size,
                           rounding_mode="floor")
        tg_col = torch.div((col_ids - max_ids + nt).clamp_min(-1), target_group_size,
                           rounding_mode="floor")
        valid = valid & ((tg_row == tg_col) | (tg_row < 0) | (tg_col < 0))
        max_ids = max_ids - nt

    if max_attn_len > 0:
        window = row_col_dist <= max_attn_len
        if min_full_attn_seq_len > 0:
            window = window | (row_ids >= max_ids - min_full_attn_seq_len)
        valid = valid & window

    if has_context:
        # contextual rows (position 0) attend to the full valid sequence
        valid = valid | ((row_ids == 0) & (col_ids < max_ids))
    return valid


# ------------------------------------------------------------ tile plan
# The plain statements of the tile plans of K1, K2 and K3 (csrc/hstu_mask.cuh
# is a line-by-line copy): which tiles a CTA visits, and which of them need
# no mask or only its causal form. Positions are local to one sequence of
# length n with c contextual and t target rows (0 when absent); every tile
# has BWD_TILE rows, and a K1 CTA holds FWD_ROWS query rows, BWD_TILE for
# each of its two consumers.
BWD_TILE = 64
FWD_ROWS = 128


def tile_fully_valid(q0: int, k0: int, n: int, c: int, t: int, rows: int = BWD_TILE, *,
                     causal: bool, max_attn_len: int) -> bool:
    """Every pair of query rows [q0, q0 + rows) and key columns [k0, k0 +
    rows) is valid, so the tile skips the mask: JAX's `_tile_fully_valid`
    (causal, no window, the tile below the diagonal, every row inside the
    sequence, every column a history column), with one more guard, c <= n -
    t: where contextual and target rows overlap, a contextual row no longer
    sees the history, and JAX's predicate would certify an invalid pair."""
    if not causal or max_attn_len > 0:
        return False
    n_cols = n - t
    return q0 >= k0 + rows - 1 and q0 + rows <= n and k0 + rows <= n_cols and c <= n_cols


def causal_edge(n: int, c: int, *, causal: bool, has_targets: bool,
                max_attn_len: int) -> bool:
    """Whether the mask of an edge tile reduces to `causal_edge_valid`:
    causal, no targets, no window and 0 <= c <= n (`bench.py`'s
    configuration)."""
    return causal and not has_targets and max_attn_len == 0 and 0 <= c <= n


def causal_edge_valid(row, col, n: int, c: int):
    """`_compute_mask` under `causal_edge`: both inside the sequence, and the
    key on or before the query or the query a contextual row (positions as
    ints or numpy arrays)."""
    return (row < n) & (col < n) & ((row >= col) | (row < c))


def kv_tile_end(q0: int, n: int, c: int, rows: int = BWD_TILE, *, causal: bool,
                has_context: bool) -> int:
    """K2: how far into the keys the query tile [q0, q0 + rows) looks (JAX's
    `_kv_extent`): causal rows stop at their diagonal, a tile holding
    contextual rows goes to the end."""
    if not causal or (has_context and q0 < c):
        return n
    return min(n, q0 + rows)


def fwd_cta_tiles(m0: int, n: int, c: int, *, causal: bool, has_context: bool) -> int:
    """K1: how many key tiles the CTA of query rows [m0, m0 + FWD_ROWS)
    walks: `kv_tile_end` of its rows, in BWD_TILE-row tiles (JAX's
    `_kv_extent` at BQ = 128)."""
    end = kv_tile_end(m0, n, c, FWD_ROWS, causal=causal, has_context=has_context)
    return -(-end // BWD_TILE)


def fwd_tiles(q0: int, n: int, c: int, *, causal: bool, has_context: bool) -> int:
    """K1: how many key tiles the consumer of query rows [q0, q0 +
    BWD_TILE) computes, from tile 0 on: up to its own `kv_tile_end`, and none
    when its rows lie past the sequence. It releases the CTA's later tiles
    untouched (under causal, the last tile of consumer 0, whose rows sit
    above it, unless they are contextual)."""
    if q0 >= n:
        return 0
    return -(-kv_tile_end(q0, n, c, BWD_TILE, causal=causal, has_context=has_context)
             // BWD_TILE)


def dkv_query_tiles(k0: int, n: int, c: int, rows: int = BWD_TILE, *, causal: bool,
                    has_context: bool) -> list:
    """K3: the first rows of the query tiles that reach key tile [k0, k0 +
    rows), in the order the kernel walks them. When causal: the tiles of the
    contextual rows [0, c), then the tiles from the key tile on; else all."""
    n_q = -(-n // rows)
    n_ctx, first = 0, 0
    if causal:
        n_ctx = -(-min(max(c, 0), n) // rows) if has_context else 0
        first = max(k0 // rows, n_ctx)
    return [(i if i < n_ctx else first + i - n_ctx) * rows
            for i in range(n_ctx + n_q - first)]


# ------------------------------------------------------------ K4's tile walks
# K4's forward and dk/dv as the RAB instances of K1's and K3's kernels walk
# their tiles (csrc/hstu_attention_fwd.cu, csrc/hstu_attention_bwd.cu), in
# plain PyTorch: the same tiles, the same bias cells, the mask form each tile
# takes and the same bf16 rounding points, with fp32 sums (their order
# aside). Slow, and meant for small shapes: the CPU tests hold them against
# the JAX kernel, so a walk that reads the bias untransposed or drops alpha
# from dk shows without a card.
def _walk_seqs(seq_offsets, num_contextuals, num_targets):
    """(b, off, n, c, t) of each sequence."""
    so = [int(x) for x in seq_offsets]
    for b in range(len(so) - 1):
        c = 0 if num_contextuals is None else int(num_contextuals[b])
        t = 0 if num_targets is None else int(num_targets[b])
        yield b, so[b], so[b + 1] - so[b], c, t


def _rows(x: torch.Tensor, r0: int) -> torch.Tensor:
    """A tile as TMA loads it: packed rows [r0, r0 + BWD_TILE) of x [T, H,
    d] as fp32 [H, BWD_TILE, d], zero past T (past its sequence's end, the
    next sequence's rows)."""
    t = x[r0:r0 + BWD_TILE].float()
    t = F.pad(t, (0, 0, 0, 0, 0, BWD_TILE - t.shape[0]))
    return t.transpose(0, 1)


def _bias_cells(rab: torch.Tensor, b: int, n: int, r0: int, c0: int) -> torch.Tensor:
    """fp32 [H|1, BWD_TILE, BWD_TILE]: rab[b|0, :, r0 + i, c0 + j], 0 where
    a row or a column lies past the sequence's end n."""
    cells = rab[min(b, rab.shape[0] - 1), :, r0:min(r0 + BWD_TILE, n),
                c0:min(c0 + BWD_TILE, n)].float()
    return F.pad(cells, (0, BWD_TILE - cells.shape[2], 0, BWD_TILE - cells.shape[1]))


def _tile_mask(q0: int, k0: int, n: int, c: int, t: int, valid: torch.Tensor, *,
               causal: bool, has_targets: bool, max_attn_len: int) -> torch.Tensor:
    """[BWD_TILE, BWD_TILE] mask of query rows [q0, +64) x key columns [k0,
    +64) in the form the kernels take: none on a certified interior tile,
    the causal form where `causal_edge` holds, else the full mask
    (`valid`, the sequence's, padded with False)."""
    if tile_fully_valid(q0, k0, n, c, t, causal=causal, max_attn_len=max_attn_len):
        return torch.ones(BWD_TILE, BWD_TILE)
    if causal_edge(n, c, causal=causal, has_targets=has_targets, max_attn_len=max_attn_len):
        rows = torch.arange(q0, q0 + BWD_TILE)[:, None]
        cols = torch.arange(k0, k0 + BWD_TILE)[None, :]
        return causal_edge_valid(rows, cols, n, c).float()
    return valid[q0:q0 + BWD_TILE, k0:k0 + BWD_TILE].float()


def _seq_valid(n, c, t, causal, has_ctx, has_tgt, max_attn_len, min_full, group):
    """The sequence's dense mask, padded with False to whole tiles and one
    more tile (edge tiles reach past n)."""
    pad = (-(-max(n, 1) // BWD_TILE) + 1) * BWD_TILE
    valid = torch.zeros(pad, pad, dtype=torch.bool)
    if n:
        one = lambda x: torch.tensor([x])
        valid[:n, :n] = get_valid_attn_mask(
            causal, n, one(n), num_targets=one(t) if has_tgt else None,
            max_attn_len=max_attn_len, num_contextuals=one(c) if has_ctx else None,
            min_full_attn_seq_len=min_full, target_group_size=group)[0]
    return valid


def rab_fwd_tile_walk(q, k, v, rab, seq_offsets, max_seq_len: int, alpha: float, *,
                      causal: bool = True, num_targets=None, num_contextuals=None,
                      max_attn_len: int = 0, target_group_size: int = 1,
                      scaling_seqlen: int = -1, min_full_attn_seq_len: int = 0):
    """K4's forward as `fwd_wgmma_kernel<D, true>` walks it: per 128-row CTA
    of a sequence, per consumer of 64 query rows q0, the key tiles of
    `fwd_tiles`; per tile x = alpha Q K^T + the bias cells (0 past n), the
    tile's mask form, P = silu(x) / scaling * mask rounded to v's dtype, O
    += P V in fp32; O's rows below n stored in v's dtype. Returns [T, H, V]
    (rows no sequence owns zero)."""
    scaling = max_seq_len if scaling_seqlen == -1 else scaling_seqlen
    out = torch.zeros(v.shape, dtype=v.dtype)
    plan = dict(causal=causal, has_context=num_contextuals is not None)
    form = dict(causal=causal, has_targets=num_targets is not None, max_attn_len=max_attn_len)
    for b, off, n, c, t in _walk_seqs(seq_offsets, num_contextuals, num_targets):
        valid = _seq_valid(n, c, t, causal, plan["has_context"], form["has_targets"],
                           max_attn_len, min_full_attn_seq_len, target_group_size)
        for m0 in range(0, n, FWD_ROWS):
            for q0 in (m0, m0 + BWD_TILE):
                qt = _rows(q, off + q0)
                o = torch.zeros(v.shape[1], BWD_TILE, v.shape[2])
                for i in range(fwd_tiles(q0, n, c, **plan)):
                    k0 = i * BWD_TILE
                    x = alpha * qt @ _rows(k, off + k0).transpose(1, 2) \
                        + _bias_cells(rab, b, n, q0, k0)
                    mask = _tile_mask(q0, k0, n, c, t, valid, **form)
                    p = (F.silu(x) / scaling * mask).to(v.dtype).float()
                    o += p @ _rows(v, off + k0)
                rows = max(0, min(BWD_TILE, n - q0))
                out[off + q0:off + q0 + rows] = o[:, :rows].transpose(0, 1).to(v.dtype)
    return out


def rab_dkv_tile_walk(q, k, v, dout, rab, seq_offsets, max_seq_len: int, alpha: float, *,
                      causal: bool = True, num_targets=None, num_contextuals=None,
                      max_attn_len: int = 0, target_group_size: int = 1,
                      scaling_seqlen: int = -1, min_full_attn_seq_len: int = 0):
    """K4's dk and dv as `dkv_wgmma_kernel<D, true>` walks them: per 64-row
    key tile n0 of a sequence, the 64-row query tiles of `dkv_query_tiles`;
    per tile the transposed blocks (rows keys, columns queries) x^T = alpha
    K Q^T + rab[query][key] (0 past n), the tile's mask form, P^T =
    silu(x) / scaling * mask and dS^T = (dO V^T)^T * dsilu(x) * mask *
    alpha / scaling, each rounded to dO's and q's dtype; dv += P^T dO and dk
    += dS^T Q in fp32; rows below n stored in k's and v's dtype. Returns
    (dk, dv) [T, H, D] (rows no sequence owns zero)."""
    scaling = max_seq_len if scaling_seqlen == -1 else scaling_seqlen
    dout = dout.to(v.dtype)
    dk, dv = torch.zeros(k.shape, dtype=k.dtype), torch.zeros(v.shape, dtype=v.dtype)
    plan = dict(causal=causal, has_context=num_contextuals is not None)
    form = dict(causal=causal, has_targets=num_targets is not None, max_attn_len=max_attn_len)
    for b, off, n, c, t in _walk_seqs(seq_offsets, num_contextuals, num_targets):
        valid = _seq_valid(n, c, t, causal, plan["has_context"], form["has_targets"],
                           max_attn_len, min_full_attn_seq_len, target_group_size)
        for n0 in range(0, n, BWD_TILE):
            kt, vt = _rows(k, off + n0), _rows(v, off + n0)
            dka = torch.zeros(k.shape[1], BWD_TILE, k.shape[2])
            dva = torch.zeros(v.shape[1], BWD_TILE, v.shape[2])
            for q0 in dkv_query_tiles(n0, n, c, **plan):
                qt, ot = _rows(q, off + q0), _rows(dout, off + q0)
                x = alpha * kt @ qt.transpose(1, 2) \
                    + _bias_cells(rab, b, n, q0, n0).transpose(1, 2)
                mask = _tile_mask(q0, n0, n, c, t, valid, **form).T
                sg = torch.sigmoid(x)
                pt = (x * sg / scaling * mask).to(dout.dtype).float()
                g = sg * (1 + x * (1 - sg)) * mask * (alpha / scaling)
                dst = (vt @ ot.transpose(1, 2) * g).to(q.dtype).float()
                dva += pt @ ot
                dka += dst @ qt
            rows = min(BWD_TILE, n - n0)
            dk[off + n0:off + n0 + rows] = dka[:, :rows].transpose(0, 1).to(k.dtype)
            dv[off + n0:off + n0 + rows] = dva[:, :rows].transpose(0, 1).to(v.dtype)
    return dk, dv


def _padded(x: torch.Tensor, seq_offsets: torch.Tensor, N: int) -> torch.Tensor:
    """[T, H, d] jagged -> [B, H, N, d] padded dense."""
    T, H = x.shape[:2]
    d = jagged_to_padded_dense(x.reshape(T, -1), seq_offsets, N)
    return d.reshape(d.shape[0], N, H, -1).transpose(1, 2)


def _jagged(x: torch.Tensor, seq_offsets: torch.Tensor, T: int) -> torch.Tensor:
    """[B, H, N, d] padded dense -> [T, H, d] jagged."""
    B, H, N, d = x.shape
    return padded_dense_to_jagged(
        x.transpose(1, 2).reshape(B, N, H * d), seq_offsets, T
    ).reshape(T, H, d)


def _scores_and_mask(q, k, seq_offsets, max_seq_len, alpha, causal, num_targets,
                     num_contextuals, max_attn_len, min_full_attn_seq_len,
                     target_group_size, rab=None):
    """Padded fp32 scores alpha q k^T (+ rab) [B, H, N, N] and the
    [B, 1, N, N] mask."""
    N = max_seq_len
    pq = _padded(q, seq_offsets, N).float()
    pk = _padded(k, seq_offsets, N).float()
    s = torch.einsum("bhxa,bhya->bhxy", pq, pk) * alpha
    if rab is not None:
        s = s + rab[:, :, :N, :N].float()
    mask = get_valid_attn_mask(
        causal=causal, N=N, seq_lengths=seq_offsets[1:] - seq_offsets[:-1],
        num_targets=num_targets, max_attn_len=max_attn_len,
        num_contextuals=num_contextuals,
        min_full_attn_seq_len=min_full_attn_seq_len,
        target_group_size=target_group_size,
    )
    return s, mask[:, None]


def hstu_mha_reference(
    max_seq_len: int,
    alpha: float,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seq_offsets: torch.Tensor,
    causal: bool = True,
    num_targets: Optional[torch.Tensor] = None,
    num_contextuals: Optional[Union[int, torch.Tensor]] = None,
    max_attn_len: int = 0,
    target_group_size: int = 1,
    scaling_seqlen: int = -1,
    min_full_attn_seq_len: int = 0,
    rab: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Jagged HSTU multi-head attention, dense-padded (plain K1; with `rab`
    plain K4 forward).

    q, k: [T, H, D]; v: [T, H, V]; seq_offsets: [B+1]; rab: [B|1, H|1, Nq, Nk]
    with Nq, Nk >= max_seq_len, added to the scores before the SiLU.
    Returns [T, H, V] in v's dtype. Padding rows of the output are zero.
    """
    if scaling_seqlen == -1:
        scaling_seqlen = max_seq_len
    s, mask = _scores_and_mask(
        q, k, seq_offsets, max_seq_len, alpha, causal, num_targets,
        num_contextuals, max_attn_len, min_full_attn_seq_len, target_group_size, rab)
    p = F.silu(s) * (1.0 / scaling_seqlen) * mask.to(s.dtype)
    pv = _padded(v, seq_offsets, max_seq_len)
    out = torch.einsum("bhxy,bhyv->bhxv", p.to(v.dtype).float(), pv.float())
    return _jagged(out.to(v.dtype), seq_offsets, q.shape[0])


def hstu_mha_int8_reference(
    max_seq_len: int,
    alpha: float,
    q8: torch.Tensor,
    k8: torch.Tensor,
    v8: torch.Tensor,
    q_scale: float,
    k_scale: float,
    v_scale: float,
    seq_offsets: torch.Tensor,
    **mask_kwargs,
) -> torch.Tensor:
    """Plain K5: `hstu_mha_reference` on int8 q, k [T, H, D], v [T, H, V]
    with per-tensor scales. The int8 values are widened to bf16 (exact), the
    two scales of the scores fold into alpha, P rounds to bf16 before P v8,
    and the fp32 sum takes `v_scale` before it rounds to bf16 [T, H, V].
    `mask_kwargs`: `hstu_mha_reference`'s mask arguments (no bias)."""
    scaling_seqlen = mask_kwargs.pop("scaling_seqlen", -1)
    if scaling_seqlen == -1:
        scaling_seqlen = max_seq_len
    kw = dict(causal=True, num_targets=None, num_contextuals=None, max_attn_len=0,
              min_full_attn_seq_len=0, target_group_size=1)
    kw.update(mask_kwargs)
    bf = torch.bfloat16
    s, mask = _scores_and_mask(
        q8.to(bf), k8.to(bf), seq_offsets, max_seq_len,
        float(alpha) * float(q_scale) * float(k_scale), kw["causal"], kw["num_targets"],
        kw["num_contextuals"], kw["max_attn_len"], kw["min_full_attn_seq_len"],
        kw["target_group_size"])
    p = F.silu(s) * (1.0 / scaling_seqlen) * mask.to(s.dtype)
    pv = _padded(v8.to(bf), seq_offsets, max_seq_len)
    out = torch.einsum("bhxy,bhyv->bhxv", p.to(bf).float(), pv.float()) * float(v_scale)
    return _jagged(out.to(bf), seq_offsets, q8.shape[0])


def hstu_attn_bwd_ref(
    max_seq_len: int,
    alpha: float,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    seq_offsets: torch.Tensor,
    causal: bool = True,
    num_targets: Optional[torch.Tensor] = None,
    num_contextuals: Optional[Union[int, torch.Tensor]] = None,
    max_attn_len: int = 0,
    target_group_size: int = 1,
    scaling_seqlen: int = -1,
    min_full_attn_seq_len: int = 0,
    rab: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dq, dk, dv, drab) of `hstu_mha_reference` by recompute (plain K2 and
    K3; with `rab` plain K4 backward, else drab is None):

        dP = dO v^T,  dS_rab = dP * dsilu(S) * mask / scaling,  dS = alpha dS_rab
        dq = dS k,  dk = dS^T q,  dv = P^T dO,  drab = dS_rab

    with S and P as in the forward. Rows past seq_offsets[-1] are zero. drab
    has rab's shape and dtype: its broadcast dims are summed (in fp32), and
    cells past max_seq_len or that no valid (row, col) pair reaches are zero.
    """
    if scaling_seqlen == -1:
        scaling_seqlen = max_seq_len
    N, T = max_seq_len, q.shape[0]
    s, mask = _scores_and_mask(
        q, k, seq_offsets, max_seq_len, alpha, causal, num_targets,
        num_contextuals, max_attn_len, min_full_attn_seq_len, target_group_size, rab)
    m = mask.to(s.dtype) * (1.0 / scaling_seqlen)
    sig = torch.sigmoid(s)
    p = s * sig * m
    do = _padded(dout.to(v.dtype), seq_offsets, N)
    pv = _padded(v, seq_offsets, N)
    dp = torch.einsum("bhxv,bhyv->bhxy", do.float(), pv.float())
    ds_rab = dp * (sig * (1.0 + s * (1.0 - sig))) * m
    ds = ds_rab * alpha
    drab = None
    if rab is not None:
        drab = torch.zeros(rab.shape, dtype=torch.float32, device=rab.device)
        g = ds_rab
        if rab.shape[0] == 1 and g.shape[0] > 1:
            g = g.sum(dim=0, keepdim=True)
        if rab.shape[1] == 1 and g.shape[1] > 1:
            g = g.sum(dim=1, keepdim=True)
        drab[:, :, :N, :N] = g
        drab = drab.to(rab.dtype)
    pq = _padded(q, seq_offsets, N).float()
    pk = _padded(k, seq_offsets, N).float()
    dq = torch.einsum("bhxy,bhya->bhxa", ds.to(k.dtype).float(), pk)
    dk = torch.einsum("bhxy,bhxa->bhya", ds.to(q.dtype).float(), pq)
    dv = torch.einsum("bhxy,bhxv->bhyv", p.to(do.dtype).float(), do.float())
    return (_jagged(dq.to(q.dtype), seq_offsets, T),
            _jagged(dk.to(k.dtype), seq_offsets, T),
            _jagged(dv.to(v.dtype), seq_offsets, T),
            drab)


def hstu_cached_mha_reference(
    N: int,
    scaling_seqlen: int,
    alpha: float,
    delta_q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    delta_x_offsets: torch.Tensor,
    seq_offsets: torch.Tensor,
    num_targets: Optional[torch.Tensor] = None,
    max_attn_len: int = 0,
) -> torch.Tensor:
    """Delta-q (KV-cached inference) HSTU attention.

    delta_q: [L, H, D] new-token queries (L = B * delta_len, equal per batch
    row); k/v: [T, H, D] the whole jagged keys/values; delta_x_offsets: [L]
    the new tokens' global positions. Returns [L, H, V] in v's dtype."""
    L, H, D = delta_q.shape
    V = v.shape[2]
    B = seq_offsets.shape[0] - 1
    seq_offsets = seq_offsets.to(torch.int64)
    dq = delta_q.reshape(B, -1, H, D).transpose(1, 2).float()        # [B, H, dL, D]
    fk, fv = _padded(k, seq_offsets, N), _padded(v, seq_offsets, N)
    p = F.silu(torch.einsum("bhxa,bhya->bhxy", dq, fk.float()) * alpha) * (1.0 / scaling_seqlen)
    seq_lengths = seq_offsets[1:] - seq_offsets[:-1]
    col_ids = torch.arange(N, device=k.device)[None, None, :]
    row_ids = (delta_x_offsets.to(torch.int64).reshape(B, -1)
               - seq_offsets[:-1, None])[:, :, None]
    valid = col_ids == row_ids
    if num_targets is not None:
        last = (seq_lengths - num_targets.to(torch.int64)).reshape(B, 1, 1)
        row_ids = torch.minimum(row_ids, last)
        col_ids = torch.minimum(col_ids.expand(valid.shape), last)
    dist = row_ids - col_ids
    valid = valid | (dist > 0)
    if max_attn_len > 0:
        valid = valid & (dist <= max_attn_len)
    p = p * valid[:, None].to(p.dtype)
    out = torch.einsum("bhxy,bhyv->bhxv", p.to(fv.dtype).float(), fv.float())
    return out.transpose(1, 2).reshape(L, H, V).to(v.dtype)
