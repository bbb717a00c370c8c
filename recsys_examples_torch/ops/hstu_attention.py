"""Jagged varlen HSTU (SiLU) attention with its gradient (counterpart of
recsys_examples_tpu/ops/pallas/hstu_attention.py `hstu_attn_varlen`).

`hstu_attn_varlen` is a `torch.autograd.Function` over packed [T, H, D]
q, k, v and `seq_offsets [B+1]`, as the original `hstu_attn_varlen_func`
takes them. Its forward runs K1, its backward K2 (dq) then K3 (dk, dv):
  - CUDA tensors launch the hand-written kernels of `csrc/hstu_attention.cu`
    (bf16, head dims 32/64/128/256) or raise;
  - CPU tensors run the plain versions of `ops/hstu_attention_ref.py`.
Each kernel wrapper counts its launches in `.launches`.

Not ported yet: the relative attention bias (K4, `hstu_attn_varlen_rab`)
and the int8 forward (K5, `hstu_attn_varlen_quantized_calibrated`).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from recsys_examples_torch.ops.hstu_attention_ref import (
    hstu_attn_bwd_ref,
    hstu_mha_reference,
)

_HEAD_DIMS = (32, 64, 128, 256)


@dataclasses.dataclass(frozen=True)
class AttnOptions:
    """The static arguments of one attention call."""
    max_seqlen: int
    alpha: float
    scaling_seqlen: int
    causal: bool = True
    target_group_size: int = 1
    max_attn_len: int = 0
    min_full_attn_seq_len: int = 0

    def ref_kwargs(self):
        return dict(causal=self.causal, max_attn_len=self.max_attn_len,
                    target_group_size=self.target_group_size,
                    scaling_seqlen=self.scaling_seqlen,
                    min_full_attn_seq_len=self.min_full_attn_seq_len)


# ------------------------------------------------------------ CUDA wrappers
_COMMON = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ENTRIES = {
    "hstu_attn_fwd_launch": 4,        # q, k, v, out
    "hstu_attn_bwd_dq_launch": 5,     # q, k, v, dO, dq
    "hstu_attn_bwd_dkv_launch": 6,    # q, k, v, dO, dk, dv
}


def _fn(entry: str):
    from recsys_examples_torch.utils import cuda_build

    fn = getattr(cuda_build.load("hstu_attention"), entry)
    fn.argtypes = [ctypes.c_void_p] * _ENTRIES[entry] + _COMMON
    fn.restype = ctypes.c_int
    return fn


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


def _launch(entry, tensors, outs, seq_offsets, num_contextuals, num_targets,
            opts: AttnOptions):
    """Check the operands and launch `entry` on the current stream."""
    q = tensors[0]
    T, H, dh = q.shape
    B = seq_offsets.shape[0] - 1
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{entry} takes CUDA tensors, got {dev}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"HSTU attention kernels take head dims {_HEAD_DIMS}, got {dh}")
    for name, t in zip(("q", "k", "v", "dout"), tensors):
        _check(name, t, torch.bfloat16, (T, H, dh), dev)
    _check("seq_offsets", seq_offsets, torch.int32, (B + 1,), dev)
    for name, t in (("num_contextuals", num_contextuals), ("num_targets", num_targets)):
        if t is not None:
            _check(name, t, torch.int32, (B,), dev)
    if opts.target_group_size < 1:
        raise ValueError("target_group_size must be >= 1")
    fn = _fn(entry)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = fn(
            *(t.data_ptr() for t in tensors), *(o.data_ptr() for o in outs),
            seq_offsets.data_ptr(), ptr(num_contextuals), ptr(num_targets),
            B, H, dh, opts.max_seqlen, float(opts.alpha),
            1.0 / float(opts.scaling_seqlen), int(opts.causal),
            opts.target_group_size, opts.max_attn_len,
            opts.min_full_attn_seq_len, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} failed: error {err}")


def hstu_attn_fwd_cuda(q, k, v, seq_offsets, num_contextuals, num_targets,
                       opts: AttnOptions) -> torch.Tensor:
    """K1. Rows no sequence owns come out zero."""
    out = torch.zeros_like(q)
    _launch("hstu_attn_fwd_launch", (q, k, v), (out,), seq_offsets,
            num_contextuals, num_targets, opts)
    hstu_attn_fwd_cuda.launches += 1
    return out


def hstu_attn_bwd_dq_cuda(q, k, v, dout, seq_offsets, num_contextuals,
                          num_targets, opts: AttnOptions) -> torch.Tensor:
    """K2."""
    dq = torch.zeros_like(q)
    _launch("hstu_attn_bwd_dq_launch", (q, k, v, dout), (dq,), seq_offsets,
            num_contextuals, num_targets, opts)
    hstu_attn_bwd_dq_cuda.launches += 1
    return dq


def hstu_attn_bwd_dkv_cuda(q, k, v, dout, seq_offsets, num_contextuals,
                           num_targets, opts: AttnOptions
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3."""
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    _launch("hstu_attn_bwd_dkv_launch", (q, k, v, dout), (dk, dv), seq_offsets,
            num_contextuals, num_targets, opts)
    hstu_attn_bwd_dkv_cuda.launches += 1
    return dk, dv


hstu_attn_fwd_cuda.launches = 0
hstu_attn_bwd_dq_cuda.launches = 0
hstu_attn_bwd_dkv_cuda.launches = 0


# ------------------------------------------------------------ dispatch
def _on(device: torch.device) -> str:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type


def hstu_attn_fwd(q, k, v, seq_offsets, num_contextuals, num_targets,
                  opts: AttnOptions) -> torch.Tensor:
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if _on(q.device) == "cuda":
        return hstu_attn_fwd_cuda(q, k, v, seq_offsets, num_contextuals,
                                  num_targets, opts)
    return hstu_mha_reference(
        opts.max_seqlen, opts.alpha, q, k, v, seq_offsets,
        num_targets=num_targets, num_contextuals=num_contextuals,
        **opts.ref_kwargs())


def hstu_attn_bwd(q, k, v, dout, seq_offsets, num_contextuals, num_targets,
                  opts: AttnOptions):
    """(dq, dk, dv): K2 then K3 on CUDA tensors, the plain versions on CPU
    tensors. dO is cast to v's dtype first."""
    dout = dout.to(v.dtype).contiguous()
    if _on(q.device) == "cuda":
        dq = hstu_attn_bwd_dq_cuda(q, k, v, dout, seq_offsets, num_contextuals,
                                   num_targets, opts)
        dk, dv = hstu_attn_bwd_dkv_cuda(q, k, v, dout, seq_offsets,
                                        num_contextuals, num_targets, opts)
        return dq, dk, dv
    return hstu_attn_bwd_ref(
        opts.max_seqlen, opts.alpha, q, k, v, dout, seq_offsets,
        num_targets=num_targets, num_contextuals=num_contextuals,
        **opts.ref_kwargs())


class _HSTUAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seq_offsets, num_contextuals, num_targets, opts):
        ctx.opts = opts
        ctx.save_for_backward(q, k, v, seq_offsets, num_contextuals, num_targets)
        return hstu_attn_fwd(q, k, v, seq_offsets, num_contextuals, num_targets, opts)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seq_offsets, num_contextuals, num_targets = ctx.saved_tensors
        dq, dk, dv = hstu_attn_bwd(q, k, v, dout, seq_offsets, num_contextuals,
                                   num_targets, ctx.opts)
        return dq, dk, dv, None, None, None, None


def hstu_attn_varlen(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seq_offsets: torch.Tensor,
    max_seqlen: int,
    *,
    num_contextuals: Optional[torch.Tensor] = None,
    num_targets: Optional[torch.Tensor] = None,
    alpha: float = 1.0,
    scaling_seqlen: int = -1,
    causal: bool = True,
    target_group_size: int = 1,
    max_attn_len: int = 0,
    min_full_attn_seq_len: int = 0,
    rab: Optional[torch.Tensor] = None,
    quantized: bool = False,
) -> torch.Tensor:
    """Jagged varlen HSTU attention: q, k [T, H, D], v [T, H, V] -> [T, H, V].

    `scaling_seqlen` -1 means `max_seqlen`, the static length bound (not the
    batch's longest sequence). On CUDA the offsets and counts are passed to
    the kernels as int32.
    """
    if rab is not None or quantized:
        raise NotImplementedError(
            "relative attention bias (K4) and int8 attention (K5) are not ported yet")
    opts = AttnOptions(
        max_seqlen=int(max_seqlen), alpha=float(alpha),
        scaling_seqlen=int(max_seqlen if scaling_seqlen == -1 else scaling_seqlen),
        causal=bool(causal), target_group_size=int(target_group_size),
        max_attn_len=int(max_attn_len),
        min_full_attn_seq_len=int(min_full_attn_seq_len),
    )
    if q.device.type == "cuda":
        i32 = lambda t: None if t is None else t.to(torch.int32).contiguous()
        seq_offsets = i32(seq_offsets)
        num_contextuals, num_targets = i32(num_contextuals), i32(num_targets)
    return _HSTUAttention.apply(q, k, v, seq_offsets, num_contextuals, num_targets, opts)
