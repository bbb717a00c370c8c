"""The sparse expert layer of an MoE decoder (LFM2-MoE's `Lfm2MoeSparseMoeBlock`):
routing with a biased selection, the routed rows permuted by expert, a
grouped expert GEMM, and a combine in a fixed order.

It replaces no TPU kernel: the JAX package has no expert layer. It was added
for the LFM2-24B-A2B serving backbone (`models/lfm2_moe.py`), whose 38 MoE
layers hold 64 experts each.

  - `route`: s = sigmoid(x W_gate^T) in fp32; the experts are the top k of
    s + expert_bias; their weights are s there, divided by (their sum +
    1e-6) when `norm_topk_prob`, times `routed_scaling_factor`.
  - `permute`: the T x k routed rows sorted by expert on the device
    (a stable sort), and the experts' row offsets from a search of the
    sorted ids, so no count is read back to the host.
  - `grouped_gemm`: for each expert e, the rows offsets[e] .. offsets[e+1]
    of `a` times w[e]^T. Two epilogues: "swiglu" (w stacks the gate and up
    projections, [E, 2I, K]; out = silu(gate) * up, [M, I]) and "scatter"
    (out[dst_rows[r]] = row_scale[r] * (a[r] w[e]^T)). On CUDA tensors one
    launch of the kernel in `csrc/moe_grouped_gemm.cu`; on CPU tensors the
    plain version, a loop over the experts.
  - `combine`: the k weighted rows of each token summed in fp32 in a fixed
    order (a reduction over a dense [T, k, D] view: no atomics).

The kernel. Every expert is hit at the serving cell's decode step (2,048
rows x top 4 over 64 experts, about 128 rows each), so each launch streams
all the experts' weights: it is bound by device memory (45.9 GB a decode
step over 38 layers), with the FLOPs at ~40% of the bound. A CTA takes 128
routed rows of one expert (two consumer warpgroups of 64 rows) and 256
weight rows (gate and up tiles of 128 for "swiglu", two 128-column tiles
otherwise); a producer warp feeds a 4-stage ring of TMA tiles ([128][64]
each, the 128-byte swizzle), consumers run m64n128k16 wgmma chains with
fp32 sums, and the epilogue applies SiLU x up, or the routing weight and
the row's destination, from registers. The CTAs of one weight tile and of
consecutive row tiles of the same expert are neighbours in the grid, so a
tile read by two row tiles comes from L2 the second time. The tiles are
planned on the device: the grid holds ceil(M / 128) + E row tiles (each
expert adds at most one partial tile), and each CTA finds its expert and
first row from the offsets; CTAs past the last tile return at once.

`grouped_gemm.launches` counts kernel launches, and the counter
`moe/gemm_launches` counts them while tracing is on."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from recsys_examples_torch.utils import observability

MODES = {"swiglu": 1, "scatter": 2}
COL_TILE = 128      # the kernel's weight rows of one of a CTA's two accumulators
DEPTH = 64          # the reduction's columns a ring stage


def route(x: torch.Tensor, gate_weight: torch.Tensor, expert_bias: Optional[torch.Tensor],
          top_k: int, norm_topk_prob: bool = True, scaling: float = 1.0
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, D] -> (weights [T, k] fp32, experts [T, k] int64). The logits
    are computed in fp32 from x as it is given, so that a selection near a
    tie does not hang on the rounding of the scores."""
    s = torch.sigmoid(x.float() @ gate_weight.float().T)
    pick = s if expert_bias is None else s + expert_bias.float()
    experts = torch.topk(pick, top_k, dim=-1).indices
    w = s.gather(1, experts)
    if norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-6)
    return w * scaling, experts


def permute(experts: torch.Tensor, num_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """experts [T, k] -> (order [T k] int64: the routed slot t k + j of each
    row sorted by expert, offsets [E + 1] int32: expert e's rows are
    offsets[e] .. offsets[e + 1] of the sorted order). No host sync."""
    ids, order = torch.sort(experts.reshape(-1), stable=True)
    bounds = torch.arange(num_experts + 1, device=ids.device, dtype=ids.dtype)
    return order, torch.searchsorted(ids, bounds).to(torch.int32)


def combine(y: torch.Tensor, tokens: int, dtype: torch.dtype) -> torch.Tensor:
    """y [T k, D], row t k + j the j-th expert's weighted output of token t
    -> [T, D]: the k rows summed in fp32, in order, then rounded."""
    return y.view(tokens, -1, y.shape[-1]).sum(1, dtype=torch.float32).to(dtype)


def grouped_gemm_ref(a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor, mode: str,
                     row_scale: Optional[torch.Tensor] = None,
                     dst_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: a loop over the experts, each product in fp32 from
    the operands as given, rounded to a's dtype once after its epilogue (as
    the kernel rounds). Reads the offsets on the host."""
    M, N_out = a.shape[0], _out_cols(w, mode)
    bounds = offsets.to("cpu", torch.int64).tolist()
    out = torch.zeros((M, N_out), dtype=a.dtype, device=a.device)
    for e in range(w.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi <= lo:
            continue
        p = a[lo:hi].float() @ w[e].float().T
        if mode == "swiglu":
            out[lo:hi] = (F.silu(p[:, :N_out]) * p[:, N_out:]).to(a.dtype)
        else:
            out[dst_rows[lo:hi]] = (p * row_scale[lo:hi, None].float()).to(a.dtype)
    return out


def _out_cols(w: torch.Tensor, mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"unknown grouped-GEMM mode {mode!r}")
    return w.shape[1] // 2 if mode == "swiglu" else w.shape[1]


_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


def _lib():
    from recsys_examples_torch.utils import cuda_build

    fn = cuda_build.load("moe_grouped_gemm").moe_grouped_gemm_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch_cuda(a, w, offsets, mode, row_scale, dst_rows):
    E, N_w, K = w.shape
    M = a.shape[0]
    dev = a.device
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the grouped-GEMM kernel takes bf16, got {a.dtype} and {w.dtype}")
    if a.dim() != 2 or a.shape[1] != K or not a.is_contiguous() or not w.is_contiguous():
        raise ValueError(f"a [M, {K}] and w [E, N, {K}] must be contiguous, got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    if K % DEPTH or N_w % (2 * COL_TILE if mode == "swiglu" else COL_TILE):
        raise ValueError(f"the kernel takes K a multiple of {DEPTH} and N a multiple of "
                         f"{COL_TILE} (per half for swiglu), got K {K}, N {N_w}")
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("a and w must be 16-byte aligned")
    offsets = offsets.to(torch.int32).contiguous()
    if offsets.shape != (E + 1,) or offsets.device != dev:
        raise ValueError(f"offsets must be [{E + 1}] on {dev}")
    out = torch.empty((M, _out_cols(w, mode)), dtype=a.dtype, device=dev)
    scale_ptr = dst_ptr = None
    if mode == "scatter":
        row_scale = row_scale.to(torch.float32).contiguous()
        dst_rows = dst_rows.to(torch.int64).contiguous()
        if row_scale.shape != (M,) or dst_rows.shape != (M,):
            raise ValueError("row_scale and dst_rows must be [M]")
        scale_ptr, dst_ptr = row_scale.data_ptr(), dst_rows.data_ptr()
    if M == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib()(a.data_ptr(), w.data_ptr(), offsets.data_ptr(), scale_ptr, dst_ptr,
                     out.data_ptr(), M, N_w, K, E, MODES[mode], out.shape[1],
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_grouped_gemm launch failed: error {err}")
    grouped_gemm.launches += 1
    observability.count("moe/gemm_launches", 1)
    return out


def grouped_gemm(a: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor, mode: str,
                 row_scale: Optional[torch.Tensor] = None,
                 dst_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows offsets[e] .. offsets[e + 1] of a [M, K] times w[e]^T, w [E, N,
    K], under the epilogue `mode` (the module's docstring). "scatter" takes
    row_scale [M] and dst_rows [M] (a permutation of the M rows) and returns
    [M, N]; "swiglu" returns [M, N / 2]. The kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if mode == "scatter" and (row_scale is None or dst_rows is None):
        raise ValueError("the scatter epilogue takes row_scale and dst_rows")
    if a.device.type == "cpu":
        return grouped_gemm_ref(a, w, offsets, mode, row_scale, dst_rows)
    return _launch_cuda(a, w, offsets, mode, row_scale, dst_rows)


grouped_gemm.launches = 0
