"""Jagged varlen HSTU (SiLU) attention with its gradient (counterpart of
recsys_examples_tpu/ops/pallas/hstu_attention.py `hstu_attn_varlen` and
`hstu_attn_varlen_rab`).

`hstu_attn_varlen` is a `torch.autograd.Function` over packed [T, H, D]
q, k, v and `seq_offsets [B+1]`, as the original `hstu_attn_varlen_func`
takes them. Its forward runs K1, its backward K2 (dq) then K3 (dk, dv); with
a relative attention bias `rab` the three kernels of K4 run instead (forward,
dq + drab, dk/dv):
  - CUDA tensors launch the hand-written kernels (built for head dims
    32/64/128/256, all wgmma, TMA, warp-specialised; the wrappers zero-pad
    any other head dim up to the next and slice the outputs and gradients,
    `ops/head_dims.py`) or raise: K1 and K4's forward from
    `csrc/hstu_attention_fwd.cu`, K2, K3, K4's dq + drab and K4's dk/dv
    from `csrc/hstu_attention_bwd.cu`;
  - CPU tensors run the plain versions of `ops/hstu_attention_ref.py`.
Each kernel wrapper counts its launches in `.launches`.

`hstu_attn_varlen_quantized_calibrated` is the int8 forward (K5, the int8
instance of K1's kernel in `csrc/hstu_attention_fwd.cu`): int8 q, k, v with
three per-tensor scales (`quantize_per_tensor`), forward only, no autograd,
no bias.
`hstu_attn_varlen(quantized=True)` quantizes its operands per tensor and
takes that route.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from recsys_examples_torch.ops.head_dims import instance_head_dim, pad_head_dim, unpad_head_dim
from recsys_examples_torch.ops.hstu_attention_ref import (
    hstu_attn_bwd_ref,
    hstu_mha_int8_reference,
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
# rab, drab, their batch and head strides, row stride, dtype and atomic flags
_RAB_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
# entry: (library, tensor pointers, the arguments after the mask options)
_ENTRIES = {
    "hstu_attn_fwd_launch": ("hstu_attention_fwd", 4, []),          # q, k, v, out
    "hstu_attn_bwd_dq_launch": ("hstu_attention_bwd", 5, []),       # q, k, v, dO, dq
    "hstu_attn_bwd_dkv_launch": ("hstu_attention_bwd", 6, []),      # ..., dk, dv
    "hstu_attn_rab_fwd_launch": ("hstu_attention_fwd", 4, _RAB_ARGS),
    "hstu_attn_rab_bwd_dq_launch": ("hstu_attention_bwd", 5, _RAB_ARGS),
    "hstu_attn_rab_bwd_dkv_launch": ("hstu_attention_bwd", 6, _RAB_ARGS),
    "hstu_attn_fwd_int8_launch": ("hstu_attention_fwd", 4, [ctypes.c_float]),   # v_scale
}


def _fn(entry: str):
    from recsys_examples_torch.utils import cuda_build

    lib, n_ptr, extra = _ENTRIES[entry]
    fn = getattr(cuda_build.load(lib), entry)
    # pointers, seq_offsets and the two counts; T (for the TMA maps), B, H,
    # dh, max_seqlen; alpha, 1 / scaling; the four mask options
    fn.argtypes = [ctypes.c_void_p] * (n_ptr + 3) + [ctypes.c_int] * 5 \
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 4 + extra + [ctypes.c_void_p]
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


def _rab_args(rab, drab, B, H, opts: AttnOptions, dev):
    """The kernels' bias arguments: pointers, batch and head strides (0 for a
    broadcast dim), row stride, dtype flag, and whether drab's cells are
    shared between CTAs (a broadcast dim: fp32 atomics)."""
    if rab is None:
        return (None, None, 0, 0, 0, 0, 0)
    N = opts.max_seqlen
    if rab.dim() != 4 or rab.shape[0] not in (1, B) or rab.shape[1] not in (1, H) \
            or rab.shape[2] < N or rab.shape[3] < N:
        raise ValueError(f"rab has shape {tuple(rab.shape)}, expected "
                         f"[{B}|1, {H}|1, >={N}, >={N}]")
    if rab.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rab has dtype {rab.dtype}, expected float32 or bfloat16")
    if rab.device != dev or not rab.is_contiguous():
        raise ValueError(f"rab must be contiguous on {dev}")
    sb = 0 if rab.shape[0] == 1 else rab.stride(0)
    sh = 0 if rab.shape[1] == 1 else rab.stride(1)
    if drab is not None:
        _check("drab", drab, torch.float32, rab.shape, dev)
    shared = (rab.shape[0] == 1 and B > 1) or (rab.shape[1] == 1 and H > 1)
    return (rab.data_ptr(), None if drab is None else drab.data_ptr(), sb, sh,
            rab.shape[3], int(rab.dtype == torch.bfloat16), int(shared))


def _check_operands(entry, tensors, dtype, seq_offsets, num_contextuals, num_targets,
                    opts: AttnOptions):
    """What every kernel of `csrc/hstu_attention*.cu` asks of its operands.
    Returns (B, H, dh, device)."""
    T, H, dh = tensors[0].shape
    B = seq_offsets.shape[0] - 1
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{entry} takes CUDA tensors, got {dev}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"HSTU attention kernels take head dims {_HEAD_DIMS}, got {dh}")
    for name, t in zip(("q", "k", "v", "dout"), tensors):
        _check(name, t, dtype, (T, H, dh), dev)
    _check("seq_offsets", seq_offsets, torch.int32, (B + 1,), dev)
    for name, t in (("num_contextuals", num_contextuals), ("num_targets", num_targets)):
        if t is not None:
            _check(name, t, torch.int32, (B,), dev)
    if opts.target_group_size < 1:
        raise ValueError("target_group_size must be >= 1")
    return B, H, dh, dev


def _launch(entry, tensors, outs, seq_offsets, num_contextuals, num_targets,
            opts: AttnOptions, rab=None, drab=None, dtype=torch.bfloat16, extra=()):
    """Check the operands and launch `entry` on the current stream; `extra`:
    the arguments after the mask options, but for the bias's."""
    B, H, dh, dev = _check_operands(entry, tensors, dtype, seq_offsets,
                                    num_contextuals, num_targets, opts)
    if _ENTRIES[entry][2] is _RAB_ARGS:
        extra = _rab_args(rab, drab, B, H, opts, dev)
    fn = _fn(entry)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = fn(
            *(t.data_ptr() for t in tensors), *(o.data_ptr() for o in outs),
            seq_offsets.data_ptr(), ptr(num_contextuals), ptr(num_targets),
            tensors[0].shape[0], B, H, dh, opts.max_seqlen,
            float(opts.alpha), 1.0 / float(opts.scaling_seqlen), int(opts.causal),
            opts.target_group_size, opts.max_attn_len, opts.min_full_attn_seq_len,
            *extra, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} failed: error {err}")


def _padded(*tensors):
    """The operands zero-padded to the next built head dim (themselves when
    theirs is built), and the head dim to slice the results back to."""
    dh = tensors[0].shape[-1]
    d = instance_head_dim(dh, _HEAD_DIMS)
    return [pad_head_dim(t, d) for t in tensors], dh


def hstu_attn_fwd_cuda(q, k, v, seq_offsets, num_contextuals, num_targets,
                       opts: AttnOptions) -> torch.Tensor:
    """K1. Rows no sequence owns come out zero."""
    (q, k, v), dh = _padded(q, k, v)
    out = torch.zeros_like(q)
    _launch("hstu_attn_fwd_launch", (q, k, v), (out,), seq_offsets,
            num_contextuals, num_targets, opts)
    hstu_attn_fwd_cuda.launches += 1
    return unpad_head_dim(out, dh)


def hstu_attn_bwd_dq_cuda(q, k, v, dout, seq_offsets, num_contextuals,
                          num_targets, opts: AttnOptions) -> torch.Tensor:
    """K2."""
    (q, k, v, dout), dh = _padded(q, k, v, dout)
    dq = torch.zeros_like(q)
    _launch("hstu_attn_bwd_dq_launch", (q, k, v, dout), (dq,), seq_offsets,
            num_contextuals, num_targets, opts)
    hstu_attn_bwd_dq_cuda.launches += 1
    return unpad_head_dim(dq, dh)


def hstu_attn_bwd_dkv_cuda(q, k, v, dout, seq_offsets, num_contextuals,
                           num_targets, opts: AttnOptions
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3."""
    (q, k, v, dout), dh = _padded(q, k, v, dout)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    _launch("hstu_attn_bwd_dkv_launch", (q, k, v, dout), (dk, dv), seq_offsets,
            num_contextuals, num_targets, opts)
    hstu_attn_bwd_dkv_cuda.launches += 1
    return unpad_head_dim(dk, dh), unpad_head_dim(dv, dh)


def hstu_attn_rab_fwd_cuda(q, k, v, rab, seq_offsets, num_contextuals, num_targets,
                           opts: AttnOptions) -> torch.Tensor:
    """K4 forward: K1 with `rab` [B|1, H|1, Nq, Nk] (fp32 or bf16) added to
    the scores."""
    (q, k, v), dh = _padded(q, k, v)
    out = torch.zeros_like(q)
    _launch("hstu_attn_rab_fwd_launch", (q, k, v), (out,), seq_offsets,
            num_contextuals, num_targets, opts, rab)
    hstu_attn_rab_fwd_cuda.launches += 1
    return unpad_head_dim(out, dh)


def hstu_attn_rab_bwd_dq_cuda(q, k, v, dout, rab, seq_offsets, num_contextuals,
                              num_targets, opts: AttnOptions, need_drab: bool = True
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K4 dq + drab. drab is fp32 of rab's shape: a broadcast dim of rab is
    summed by fp32 atomics (the last bits depend on their order); cells no
    valid (row, col) pair reaches are zero."""
    (q, k, v, dout), dh = _padded(q, k, v, dout)
    dq = torch.zeros_like(q)
    drab = torch.zeros(rab.shape, dtype=torch.float32, device=rab.device) \
        if need_drab else None
    _launch("hstu_attn_rab_bwd_dq_launch", (q, k, v, dout), (dq,), seq_offsets,
            num_contextuals, num_targets, opts, rab, drab)
    hstu_attn_rab_bwd_dq_cuda.launches += 1
    return unpad_head_dim(dq, dh), drab


def hstu_attn_rab_bwd_dkv_cuda(q, k, v, dout, rab, seq_offsets, num_contextuals,
                               num_targets, opts: AttnOptions
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 dk, dv."""
    (q, k, v, dout), dh = _padded(q, k, v, dout)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    _launch("hstu_attn_rab_bwd_dkv_launch", (q, k, v, dout), (dk, dv), seq_offsets,
            num_contextuals, num_targets, opts, rab)
    hstu_attn_rab_bwd_dkv_cuda.launches += 1
    return unpad_head_dim(dk, dh), unpad_head_dim(dv, dh)


def hstu_attn_fwd_int8_cuda(q8, k8, v8, seq_offsets, num_contextuals, num_targets,
                            opts: AttnOptions, v_scale: float) -> torch.Tensor:
    """K5: K1 on int8 q, k, v [T, H, dh]. `opts.alpha` already holds
    alpha * q_scale * k_scale; the bf16 output is scaled by `v_scale`. Rows
    no sequence owns come out zero."""
    (q8, k8, v8), dh = _padded(q8, k8, v8)
    out = torch.zeros(q8.shape, dtype=torch.bfloat16, device=q8.device)
    _launch("hstu_attn_fwd_int8_launch", (q8, k8, v8), (out,), seq_offsets, num_contextuals,
            num_targets, opts, dtype=torch.int8, extra=(float(v_scale),))
    hstu_attn_fwd_int8_cuda.launches += 1
    return unpad_head_dim(out, dh)


hstu_attn_fwd_cuda.launches = 0
hstu_attn_fwd_int8_cuda.launches = 0
hstu_attn_bwd_dq_cuda.launches = 0
hstu_attn_bwd_dkv_cuda.launches = 0
hstu_attn_rab_fwd_cuda.launches = 0
hstu_attn_rab_bwd_dq_cuda.launches = 0
hstu_attn_rab_bwd_dkv_cuda.launches = 0


# ------------------------------------------------------------ dispatch
def _on(device: torch.device) -> str:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type


def hstu_attn_fwd(q, k, v, seq_offsets, num_contextuals, num_targets,
                  opts: AttnOptions, rab=None) -> torch.Tensor:
    """K1 (with `rab`: K4's forward) on CUDA tensors, the plain version on
    CPU tensors."""
    if _on(q.device) == "cuda":
        if rab is not None:
            return hstu_attn_rab_fwd_cuda(q, k, v, rab, seq_offsets, num_contextuals,
                                          num_targets, opts)
        return hstu_attn_fwd_cuda(q, k, v, seq_offsets, num_contextuals,
                                  num_targets, opts)
    return hstu_mha_reference(
        opts.max_seqlen, opts.alpha, q, k, v, seq_offsets,
        num_targets=num_targets, num_contextuals=num_contextuals, rab=rab,
        **opts.ref_kwargs())


def hstu_attn_bwd(q, k, v, dout, seq_offsets, num_contextuals, num_targets,
                  opts: AttnOptions, rab=None, need_drab: bool = True):
    """(dq, dk, dv, drab): K2 then K3 (with `rab`: K4's two backward kernels)
    on CUDA tensors, the plain versions on CPU tensors. dO is cast to v's
    dtype first. drab has rab's shape and dtype, and is None without `rab`
    or when not needed."""
    dout = dout.to(v.dtype).contiguous()
    if _on(q.device) == "cuda":
        if rab is not None:
            dq, drab = hstu_attn_rab_bwd_dq_cuda(
                q, k, v, dout, rab, seq_offsets, num_contextuals, num_targets, opts,
                need_drab)
            dk, dv = hstu_attn_rab_bwd_dkv_cuda(
                q, k, v, dout, rab, seq_offsets, num_contextuals, num_targets, opts)
            return dq, dk, dv, None if drab is None else drab.to(rab.dtype)
        dq = hstu_attn_bwd_dq_cuda(q, k, v, dout, seq_offsets, num_contextuals,
                                   num_targets, opts)
        dk, dv = hstu_attn_bwd_dkv_cuda(q, k, v, dout, seq_offsets,
                                        num_contextuals, num_targets, opts)
        return dq, dk, dv, None
    return hstu_attn_bwd_ref(
        opts.max_seqlen, opts.alpha, q, k, v, dout, seq_offsets,
        num_targets=num_targets, num_contextuals=num_contextuals, rab=rab,
        **opts.ref_kwargs())


class _HSTUAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rab, seq_offsets, num_contextuals, num_targets, opts):
        ctx.opts = opts
        ctx.save_for_backward(q, k, v, rab, seq_offsets, num_contextuals, num_targets)
        return hstu_attn_fwd(q, k, v, seq_offsets, num_contextuals, num_targets, opts,
                             rab)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rab, seq_offsets, num_contextuals, num_targets = ctx.saved_tensors
        dq, dk, dv, drab = hstu_attn_bwd(
            q, k, v, dout, seq_offsets, num_contextuals, num_targets, ctx.opts, rab,
            need_drab=ctx.needs_input_grad[3])
        return dq, dk, dv, drab, None, None, None, None


def quantize_per_tensor(x: torch.Tensor):
    """Symmetric int8 per-tensor quantization. Returns (values int8, scale
    float); reading the scale synchronises with the device."""
    scale = max(float(x.abs().max()), 1e-12) / 127.0
    xi = torch.clamp(torch.round(x.float() * (1.0 / scale)), -127, 127).to(torch.int8)
    return xi, scale


def hstu_attn_varlen_quantized_calibrated(
    q_int8: torch.Tensor,
    k_int8: torch.Tensor,
    v_int8: torch.Tensor,
    q_scale: float,
    k_scale: float,
    v_scale: float,
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
) -> torch.Tensor:
    """Int8-quantized HSTU attention forward (inference): int8 q, k [T, H, D]
    and v [T, H, V], symmetrically quantized with static per-tensor scales.
    The q and k scales fold into alpha, the v scale into the output. Returns
    bf16 [T, H, V]. Forward only. CUDA tensors launch K5 or raise; CPU
    tensors run the plain version."""
    opts = AttnOptions(
        max_seqlen=int(max_seqlen),
        alpha=float(alpha) * float(q_scale) * float(k_scale),
        scaling_seqlen=int(max_seqlen if scaling_seqlen == -1 else scaling_seqlen),
        causal=bool(causal), target_group_size=int(target_group_size),
        max_attn_len=int(max_attn_len),
        min_full_attn_seq_len=int(min_full_attn_seq_len),
    )
    if _on(q_int8.device) == "cuda":
        i32 = lambda t: None if t is None else t.to(torch.int32).contiguous()
        return hstu_attn_fwd_int8_cuda(
            q_int8, k_int8, v_int8, i32(seq_offsets), i32(num_contextuals),
            i32(num_targets), opts, v_scale)
    return hstu_mha_int8_reference(
        opts.max_seqlen, alpha, q_int8, k_int8, v_int8, q_scale, k_scale, v_scale,
        seq_offsets, num_targets=num_targets, num_contextuals=num_contextuals,
        **opts.ref_kwargs())


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
    batch's longest sequence). `rab` [B|1, H|1, Nq, Nk] with Nq, Nk >=
    max_seqlen, fp32 or bf16, is added to the scores before the SiLU; its
    gradient comes back in its shape and dtype. On CUDA the offsets and
    counts are passed to the kernels as int32. `quantized=True` quantizes q,
    k and v per tensor to int8 and runs the int8 forward (bf16 output, no
    gradient, no bias).
    """
    if quantized:
        if rab is not None:
            raise ValueError("the int8 forward takes no relative attention bias")
        with torch.no_grad():
            (q8, sq), (k8, sk), (v8, sv) = (quantize_per_tensor(x) for x in (q, k, v))
            return hstu_attn_varlen_quantized_calibrated(
                q8, k8, v8, sq, sk, sv, seq_offsets, max_seqlen,
                num_contextuals=num_contextuals, num_targets=num_targets, alpha=alpha,
                scaling_seqlen=scaling_seqlen, causal=causal,
                target_group_size=target_group_size, max_attn_len=max_attn_len,
                min_full_attn_seq_len=min_full_attn_seq_len)
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
    return _HSTUAttention.apply(q, k, v, rab, seq_offsets, num_contextuals, num_targets,
                                opts)
