"""Jagged <-> dense conversions and jagged concat/split (counterpart of
recsys_examples_tpu/ops/jagged.py).

Each op keeps the JAX package's contract: a values buffer of a given row
count, lengths/offsets, and zeros in the rows past `offsets[-1]`. Offsets
and index tensors are int64 here, torch's index type. These are gathers,
which PyTorch runs as they are; the attention kernels live in
`ops/hstu_attention.py`.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def lengths_to_offsets(lengths: torch.Tensor) -> torch.Tensor:
    return torch.cat([lengths.new_zeros(1), torch.cumsum(lengths, 0)])


def row_to_batch(offsets: torch.Tensor, total_len: int) -> torch.Tensor:
    """For each flat row t in [0, total_len), the batch index owning it.

    Rows beyond offsets[-1] map to B-1 (padding; callers mask separately).
    """
    offsets = offsets.to(torch.int64)
    t = torch.arange(total_len, device=offsets.device)
    b = torch.searchsorted(offsets, t, right=True) - 1
    return b.clamp(0, offsets.shape[0] - 2)


def _gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[idx] for an index tensor of any shape. `index_select`'s
    backward is an `index_add_`; advanced indexing's is a sort-based
    accumulate, which took 37 ms over the 7 such gathers of one full-width
    train step (chip_smoke.py's phase 6 profile, H100)."""
    out = values.index_select(0, idx.reshape(-1))
    return out.reshape(idx.shape + values.shape[1:])


def _rows(mask: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """A [rows] mask shaped to broadcast over `values`' trailing dims."""
    return mask.reshape(mask.shape + (1,) * (values.dim() - 1))


def jagged_to_padded_dense(
    values: torch.Tensor,
    offsets: torch.Tensor,
    max_len: int,
    padding_value: float = 0.0,
) -> torch.Tensor:
    """[T, D] jagged -> [B, N, D] padded dense."""
    offsets = offsets.to(torch.int64)
    pos = torch.arange(max_len, device=values.device)
    idx = offsets[:-1, None] + pos[None, :]                 # [B, N]
    valid = pos[None, :] < (offsets[1:] - offsets[:-1])[:, None]
    idx = idx.clamp(0, values.shape[0] - 1)
    out = _gather_rows(values, idx)                         # [B, N, D]
    pad = torch.full((), padding_value, dtype=values.dtype, device=values.device)
    return torch.where(valid.reshape(valid.shape + (1,) * (values.dim() - 1)), out, pad)


def padded_dense_to_jagged(
    dense: torch.Tensor,
    offsets: torch.Tensor,
    total_len: int,
) -> torch.Tensor:
    """[B, N, D] -> [T, D] jagged (rows past offsets[-1] are zero)."""
    offsets = offsets.to(torch.int64)
    N = dense.shape[1]
    b = row_to_batch(offsets, total_len)
    t = torch.arange(total_len, device=dense.device)
    pos = t - offsets[b]
    valid = (t < offsets[-1]) & (pos < N)
    out = _gather_rows(dense.flatten(0, 1), b * N + pos.clamp(0, N - 1))
    return torch.where(_rows(valid, out), out, out.new_zeros(()))


def concat_2D_jagged(
    values_a: torch.Tensor,
    offsets_a: torch.Tensor,
    values_b: torch.Tensor,
    offsets_b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample concat of two jagged buffers: out_i = a_i ++ b_i.

    Returns (values [Ta+Tb, D], offsets [B+1]).
    """
    offsets_a = offsets_a.to(torch.int64)
    offsets_b = offsets_b.to(torch.int64)
    total = values_a.shape[0] + values_b.shape[0]
    len_a = offsets_a[1:] - offsets_a[:-1]
    len_b = offsets_b[1:] - offsets_b[:-1]
    offsets_c = lengths_to_offsets(len_a + len_b)
    b_idx = row_to_batch(offsets_c, total)
    t = torch.arange(total, device=values_a.device)
    pos = t - offsets_c[b_idx]
    from_a = pos < len_a[b_idx]
    idx_a = (offsets_a[b_idx] + pos).clamp(0, values_a.shape[0] - 1)
    idx_b = (offsets_b[b_idx] + pos - len_a[b_idx]).clamp(0, values_b.shape[0] - 1)
    rows_valid = t < offsets_c[-1]
    out = torch.where(_rows(from_a, values_a), _gather_rows(values_a, idx_a),
                      _gather_rows(values_b, idx_b))
    return out * _rows(rows_valid, values_a).to(values_a.dtype), offsets_c


def concat_multi_2D_jagged(
    values_list: Sequence[torch.Tensor],
    offsets_list: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-fold of concat_2D_jagged over several jagged buffers."""
    v, o = values_list[0], offsets_list[0]
    for vv, oo in zip(values_list[1:], offsets_list[1:]):
        v, o = concat_2D_jagged(v, o, vv, oo)
    return v, o


def split_2D_jagged(
    values: torch.Tensor,
    offsets: torch.Tensor,
    len_a: torch.Tensor,
    total_a: int,
    total_b: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of concat_2D_jagged: per-sample split at len_a[i].

    total_a/total_b are the buffer sizes of the two outputs.
    Returns (values_a, offsets_a, values_b, offsets_b).
    """
    offsets = offsets.to(torch.int64)
    len_a = len_a.to(torch.int64)
    len_b = offsets[1:] - offsets[:-1] - len_a
    offsets_a = lengths_to_offsets(len_a)
    offsets_b = lengths_to_offsets(len_b)

    def gather_part(part_offsets, part_total, extra):
        b = row_to_batch(part_offsets, part_total)
        t = torch.arange(part_total, device=values.device)
        src = (offsets[b] + extra[b] + t - part_offsets[b]).clamp(0, values.shape[0] - 1)
        valid = t < part_offsets[-1]
        return _gather_rows(values, src) * _rows(valid, values).to(values.dtype)

    va = gather_part(offsets_a, total_a, torch.zeros_like(len_a))
    vb = gather_part(offsets_b, total_b, len_a)
    return va, offsets_a, vb, offsets_b


def interleave_jagged(values_a: torch.Tensor, values_b: torch.Tensor) -> torch.Tensor:
    """Row-interleave two equal-shape jagged buffers: [a0,b0,a1,b1,...].
    Lengths double."""
    T, D = values_a.shape
    return torch.stack([values_a, values_b], dim=1).reshape(2 * T, D)


def jagged_dense_bmm_broadcast_add(
    values: torch.Tensor,
    offsets: torch.Tensor,
    dense: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-sample jagged @ dense[b] + bias[b]: values [T, K], dense [B, K, N],
    bias [B, N] or None -> [T, N] in values' dtype (fp32 sums); rows past
    offsets[-1] are zero."""
    b = row_to_batch(offsets, values.shape[0])
    out = torch.einsum("tk,tkn->tn", values.float(), dense[b].float()).to(values.dtype)
    if bias is not None:
        out = out + bias[b]
    mask = torch.arange(values.shape[0], device=values.device) < offsets[-1]
    return out * mask[:, None].to(out.dtype)


def jagged_reduce_sum(values: torch.Tensor, offsets: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Per-sample sum of jagged rows -> [num_segments, D]."""
    b = row_to_batch(offsets, values.shape[0])
    mask = torch.arange(values.shape[0], device=values.device) < offsets[-1]
    masked = values * _rows(mask, values).to(values.dtype)
    return values.new_zeros((num_segments,) + values.shape[1:]).index_add_(0, b, masked)
