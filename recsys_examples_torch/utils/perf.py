"""Analytic FLOPs / MFU model for HSTU training (counterpart of
recsys_examples_tpu/utils/perf.py): exact jagged attention FLOPs from the
batch's sequence lengths plus the dense GEMM FLOPs, with the accounting of
the reference's `cal_hstu_flops_single_rank`, so MFU stays comparable with
its published H100 table."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

# NVIDIA H100 SXM dense bf16 tensor-core peak (data sheet, 700 W)
H100_PEAK_TFLOPS = 989.0
# dense bf16 peaks by card name, most specific first (NVIDIA data sheets:
# the sparse figures halved)
_PEAK_TFLOPS_BY_NAME = (
    ("H100 PCIe", 756.0),
    ("H100 NVL", 835.0),
    ("H100", H100_PEAK_TFLOPS),
)


def device_peak_tflops(device: Union[str, torch.device] = "cuda") -> float:
    """Dense bf16 peak of the card `device` names, from its name; NaN for a
    CPU device or a card not in the table (MFU is then not defined)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return float("nan")
    name = torch.cuda.get_device_name(dev)
    return next((peak for key, peak in _PEAK_TFLOPS_BY_NAME if key in name),
                float("nan"))


def hstu_flops_exact(
    seqlens: np.ndarray,                    # [B] post-preprocess lengths
    num_contextuals: "np.ndarray | int",    # [B] or scalar
    num_candidates: "np.ndarray | int",     # [B] or scalar
    hidden_size: int,
    num_heads: int,
    head_dim: int,
    num_layers: int,
    *,
    has_bwd: bool = True,
    is_causal: bool = True,
    residual: bool = True,
) -> float:
    """Exact HSTU-block FLOPs:

      attention: contextual rows attend everywhere, history rows are
        causal, candidate rows attend to contextual + history only;
        backward x3.5
      GEMMs: the uvqk projection and the output projection; backward x3
      other: the u * attn elementwise product and the residual add
    """
    S = np.asarray(seqlens, np.float64)
    C = np.broadcast_to(np.asarray(num_contextuals, np.float64), S.shape)
    Ncand = np.broadcast_to(np.asarray(num_candidates, np.float64), S.shape)
    Nh = S - C - Ncand
    D = float(hidden_size)
    H = float(num_heads)
    dh = float(head_dim)

    attn = 4.0 * H * S * (C + Nh) * dh
    if is_causal:
        attn -= 2.0 * H * Nh * Nh * dh
    attn += 4.0 * H * Ncand * dh
    if has_bwd:
        attn *= 3.5

    gemm = 2.0 * S * 4.0 * H * dh * D   # uvqk projection fwd
    gemm += 2.0 * S * H * dh * D        # output projection fwd
    if has_bwd:
        gemm *= 3.0

    other = S * H * dh                  # u * attn_out elementwise fwd
    if has_bwd:
        other *= 2.0
    if residual:
        # S*H*D follows the reference line for line, though the [T, D]
        # residual add is physically S*D
        other += S * H * D

    return float((attn + gemm + other).sum() * num_layers)


def hstu_train_flops(
    seqlens: np.ndarray,       # [B] preprocessed sequence lengths (tokens)
    hidden_size: int,
    num_heads: int,
    head_dim: int,
    num_layers: int,
    *,
    causal: bool = True,
    fwd_only: bool = False,
) -> float:
    """Simplified causal-only FLOPs model (no contextual/candidate mask
    structure), the one the training entries log; `hstu_flops_exact` keeps
    the reference's accounting."""
    n = seqlens.astype(np.float64)
    D = hidden_size
    Hdh = num_heads * head_dim
    gemm = 2.0 * n * D * 4 * Hdh + 2.0 * n * Hdh * D
    att = 2.0 * 2.0 * Hdh * (n ** 2) * (0.5 if causal else 1.0)
    fwd = (gemm + att).sum() * num_layers
    return float(fwd if fwd_only else 3.0 * fwd)
