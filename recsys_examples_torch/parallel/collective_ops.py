"""Collectives with their gradients, over a process group (counterpart of
recsys_examples_tpu/parallel/collective_ops.py).

Each function is a `torch.autograd.Function`: its backward is the collective
that the forward's transpose needs. Every rank of `group` must call it, in
the same order. The first dims may differ between ranks where a function
says so: the sizes are exchanged first and the values moved exactly (the
JAX package pads to a capacity instead, for XLA's static shapes).

Gradient conventions (Megatron's):
  - `copy_to_group`: identity forward; the backward sums the ranks'
    gradients (the consumers after it differ per rank: a column-split GEMM).
  - `all_reduce`: sums over the group; the backward is the identity (the
    consumers after it are the same on every rank: the output of a
    row-split GEMM).
  - `gather_along_first_dim`: the backward is a reduce-scatter when the
    consumers differ per rank (`replicated_output=False`), and keeps this
    rank's block when they are the same on every rank.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist


# torch >= 2.10 names them *_single; older releases only have *_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _size(group) -> int:
    return dist.get_world_size(group)


def _rank(group) -> int:
    return dist.get_rank(group)


def _first_dims(x: torch.Tensor, group) -> List[int]:
    """Every rank's x.shape[0] (one small all-gather)."""
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    out = torch.empty(_size(group), dtype=torch.int64, device=x.device)
    _all_gather(out, n, group=group)
    return out.tolist()


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] == rows:
        return x.contiguous()
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + x.shape[1:])])


def _all_gather_rows(x: torch.Tensor, sizes: List[int], group) -> torch.Tensor:
    """Concatenate every rank's rows (rank order); `sizes` per rank."""
    m = max(sizes)
    out = x.new_empty((len(sizes) * m,) + x.shape[1:])
    _all_gather(out, _pad_rows(x, m), group=group)
    if all(s == m for s in sizes):
        return out
    return torch.cat([out[i * m:i * m + s] for i, s in enumerate(sizes)])


def _reduce_scatter_rows(g: torch.Tensor, sizes: List[int], group) -> torch.Tensor:
    """Sum `g` [sum(sizes), ...] over the ranks; this rank keeps its block."""
    m = max(sizes)
    if any(s != m for s in sizes):
        g = torch.cat([_pad_rows(c, m) for c in g.split(sizes)])
    out = g.new_empty((m,) + g.shape[1:])
    _reduce_scatter(out, g.contiguous(), group=group)
    return out[:sizes[_rank(group)]]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, replicated_output):
        ctx.group, ctx.replicated = group, replicated_output
        ctx.sizes = _first_dims(x, group)
        return _all_gather_rows(x, ctx.sizes, group)

    @staticmethod
    def backward(ctx, g):
        r = _rank(ctx.group)
        if ctx.replicated:
            start = sum(ctx.sizes[:r])
            return g[start:start + ctx.sizes[r]], None, None
        return _reduce_scatter_rows(g, ctx.sizes, ctx.group), None, None


def gather_along_first_dim(x: torch.Tensor, group, replicated_output: bool = False
                           ) -> torch.Tensor:
    """All-gather rows in rank order; the ranks' row counts may differ.
    Backward: a reduce-scatter, or this rank's block of the gradient with
    `replicated_output` (every rank computes the same thing from the
    result)."""
    return _Gather.apply(x, group, replicated_output)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        w = _size(group)
        out = x.new_empty((w * x.shape[0],) + x.shape[1:])
        _all_gather(out, x.contiguous(), group=group)
        ctx.width = x.shape[-1]
        return torch.cat(out.chunk(w), dim=-1)

    @staticmethod
    def backward(ctx, g):
        r = _rank(ctx.group)
        return g[..., r * ctx.width:(r + 1) * ctx.width].contiguous(), None


def gather_along_last_dim(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather feature-split activations along the last dim; the
    consumers are the same on every rank, so the backward keeps this rank's
    columns."""
    return _GatherLast.apply(x, group)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        w, r = _size(group), _rank(group)
        if x.shape[0] % w:
            raise ValueError(f"{x.shape[0]} rows do not split over {w} ranks")
        n = x.shape[0] // w
        return x[r * n:(r + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        w = _size(ctx.group)
        return _all_gather_rows(g, [g.shape[0]] * w, ctx.group), None


def split_along_first_dim(x: torch.Tensor, group) -> torch.Tensor:
    """Keep this rank's block of rows (x.shape[0] must split evenly); the
    backward all-gathers the blocks' gradients."""
    return _Split.apply(x, group)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        w = _size(group)
        if x.shape[0] % w:
            raise ValueError(f"{x.shape[0]} rows do not split over {w} ranks")
        out = x.new_empty((x.shape[0] // w,) + x.shape[1:])
        _reduce_scatter(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        w = _size(ctx.group)
        return _all_gather_rows(g, [g.shape[0]] * w, ctx.group), None


def reduce_scatter_first_dim(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the ranks and keep this rank's block of rows; the backward
    all-gathers."""
    return _ReduceScatter.apply(x, group)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the ranks; the backward is the identity (see the module
    docstring)."""
    return _AllReduce.apply(x, group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward sums the gradient over the ranks."""
    return _CopyTo.apply(x, group)


def jagged_allgather(values: torch.Tensor, lengths: torch.Tensor, group
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-gather a jagged buffer: every rank's lengths [B_r] first, then
    exactly sum(lengths) value rows from each (no capacity padding in the
    result). Values past sum(lengths) on a rank are not sent. The values'
    backward is a reduce-scatter, as `gather_along_first_dim`'s."""
    n = int(lengths.sum())
    gl = gather_along_first_dim(lengths.detach(), group)
    gv = gather_along_first_dim(values[:n], group)
    return gv, gl


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def grad_scale(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity forward, the gradient scaled by `scale`."""
    return _GradScale.apply(x, scale)
