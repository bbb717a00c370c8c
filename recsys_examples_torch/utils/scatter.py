"""A masked in-place scatter that never waits for the device.

XLA's `x.at[idx].set(v, mode="drop")` with distinct out-of-range sentinels
has no torch twin: a boolean-mask index (`idx[keep]`) copies the mask's
count to the host, and `index_put_` with several lanes on one cell is not
deterministic on CUDA. `masked_set_` sends every dropped lane to the cell of
one kept lane, carrying that lane's value, so each cell receives one value
however the device orders the writes. (`inference/kvcache.py` uses the same
idea for XLA's last-write-wins scatters.)
"""
from __future__ import annotations

from typing import Union

import torch


def masked_set_(target: torch.Tensor, idx: torch.Tensor,
                vals: Union[torch.Tensor, int, float], keep: torch.Tensor) -> torch.Tensor:
    """In place `target[idx[keep]] = vals[keep]` along dim 0.

    `idx` [n] and `keep` [n] bool; `vals` [n, *target.shape[1:]] or a scalar.
    Kept lanes must address distinct rows, or carry equal values. Dropped
    lanes may hold any index. With no kept lane the target is unchanged.
    """
    n = idx.shape[0]
    if n == 0:
        return target
    idx = idx.to(torch.int64)
    any_kept = keep.any()
    one = keep.to(torch.uint8).argmax().view(1)     # some kept lane, as a tensor
    dst = torch.where(keep, idx, torch.where(any_kept, idx[one], 0))
    if not isinstance(vals, torch.Tensor):
        vals = torch.full((), vals, dtype=target.dtype, device=target.device)
    vals = vals.to(target.dtype).expand((n,) + target.shape[1:])
    fill = torch.where(any_kept, vals[one], target[:1])
    shape = (n,) + (1,) * (target.dim() - 1)
    target.index_put_((dst,), torch.where(keep.view(shape), vals, fill))
    return target
