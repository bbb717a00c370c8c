"""Attention mask builders for the SID decoder (counterpart of
recsys_examples_tpu/modules/attention_mask.py).

The decoder consumes dense [B, N, N] boolean masks; the converters to and
from the interval (prefix-count) form are kept for parity with the original's
block-sparse encoding.
"""
from __future__ import annotations

import torch


def _valid(lengths: torch.Tensor, N: int):
    """Row and column validity [B, N, 1], [B, 1, N], and the positions [N]."""
    pos = torch.arange(N, device=lengths.device)
    ok = pos[None, :] < lengths[:, None]
    return ok[:, :, None], ok[:, None, :], pos


def padded_causal_mask(lengths: torch.Tensor, N: int) -> torch.Tensor:
    """[B, N, N] causal within each sample's valid region."""
    valid_r, valid_c, pos = _valid(lengths, N)
    causal = pos[None, :, None] >= pos[None, None, :]
    return causal & valid_r & valid_c


def history_causal_target_mask(
    lengths: torch.Tensor, num_targets: torch.Tensor, N: int
) -> torch.Tensor:
    """History tokens: causal among themselves. Target tokens: attend all
    history + themselves, but not each other."""
    valid_r, valid_c, pos = _valid(lengths, N)
    hist_end = (lengths - num_targets)[:, None]
    is_tgt = pos[None, :] >= hist_end
    causal = pos[None, :, None] >= pos[None, None, :]
    diag = (pos[:, None] == pos[None, :])[None]
    base = causal & ~is_tgt[:, None, :]      # anyone -> history, causal
    tgt_self = is_tgt[:, :, None] & diag     # target -> itself
    return (base | tgt_self) & valid_r & valid_c


def target_aware_causal_mask(
    lengths: torch.Tensor, num_targets: torch.Tensor, N: int
) -> torch.Tensor:
    """Causal, but target positions are clamped to the history end, so
    targets see all history and never each other except themselves."""
    valid_r, valid_c, pos = _valid(lengths, N)
    hist_end = (lengths - num_targets)[:, None]
    clamped = torch.minimum(pos[None, :], hist_end)
    diag = (pos[:, None] == pos[None, :])[None]
    m = (clamped[:, :, None] > clamped[:, None, :]) | diag
    return m & valid_r & valid_c


def dense_mask_to_intervals(mask_row: torch.Tensor) -> torch.Tensor:
    """One mask row [N] bool -> the prefix-count array [N+1] int32 whose
    diffs are the mask."""
    return torch.cat([mask_row.new_zeros(1, dtype=torch.int32),
                      torch.cumsum(mask_row.to(torch.int32), 0, dtype=torch.int32)])


def intervals_to_dense_mask(intervals: torch.Tensor) -> torch.Tensor:
    return (intervals[1:] - intervals[:-1]) > 0
