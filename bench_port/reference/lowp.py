"""The control's precision: a product's operands rounded to float8 (e4m3)
with one scale per tensor, as an fp8 path would feed the tensor cores. The
rounding passes the gradient straight through, so the backward pass sees
the rounded forward values."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale (amax -> 448), in x's
    dtype."""
    with torch.no_grad():
        scale = x.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
        q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def rounding(lowp: bool):
    """The operand rounding of a reference run: fp8 for the control, none
    for the reference."""
    return fp8 if lowp else identity
