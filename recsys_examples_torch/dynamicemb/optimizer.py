"""Fused sparse optimizers over hash-table rows (counterpart of
recsys_examples_tpu/dynamicemb/optimizer.py).

A sparse update touches only the looked-up rows: a gather, the update, a
scatter back, in place. Embeddings live in `HashTableState.values`
[cap, dim] and the optimizer state in its own tensor `HashTableState.opt`
[cap, opt_dim], as in the JAX state.

opt_dim per optimizer:
  sgd:              0
  adam:             2*dim   (m ++ v)
  adagrad:          dim     (acc)
  rowwise_adagrad:  1       (row acc)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from recsys_examples_torch.dynamicemb.hashtable import HashTableState
from recsys_examples_torch.utils.scatter import masked_set_


@dataclasses.dataclass(frozen=True)
class SparseOptimizerArgs:
    optimizer: str = "adam"   # sgd | adam | adagrad | rowwise_adagrad
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    initial_accumulator: float = 0.0


def opt_dim_for(optimizer: str, dim: int) -> int:
    if optimizer == "sgd":
        return 0
    if optimizer == "adam":
        return 2 * dim
    if optimizer == "adagrad":
        return dim
    if optimizer == "rowwise_adagrad":
        return 1
    raise ValueError(optimizer)


def value_dim_for(optimizer: str, dim: int) -> int:
    """Total floats stored per row (embedding + optimizer state), for
    memory accounting."""
    return dim + opt_dim_for(optimizer, dim)


def initial_opt_row(optimizer: str, n: int, dim: int, args: SparseOptimizerArgs,
                    dtype: torch.dtype, device=None) -> Optional[torch.Tensor]:
    """Initial optimizer-state rows [n, opt_dim] for fresh keys."""
    od = opt_dim_for(optimizer, dim)
    if od == 0:
        return None
    fill = args.initial_accumulator if optimizer in ("adagrad", "rowwise_adagrad") else 0.0
    return torch.full((n, od), fill, dtype=dtype, device=device)


@torch.no_grad()
def sparse_update(
    state: HashTableState,
    slots: torch.Tensor,    # [u] (-1 = skip)
    grads: torch.Tensor,    # [u, dim] fp32
    args: SparseOptimizerArgs,
    step: torch.Tensor,     # [] integer global step (adam bias correction)
) -> HashTableState:
    """Apply the optimizer to the rows at `slots`, in place. The rows of the
    valid slots are distinct (deduped keys)."""
    dim = grads.shape[1]
    ok = slots >= 0
    safe = slots.clamp(0, state.capacity - 1)
    w = state.values[safe].float()
    g = grads.float()
    if args.weight_decay > 0.0:
        g = g + args.weight_decay * w
    lr = args.learning_rate
    new_opt_rows = None

    if args.optimizer == "sgd":
        w = w - lr * g
    elif args.optimizer == "adam":
        o = state.opt[safe].float()
        m, v = o[:, :dim], o[:, dim:]
        m = args.beta1 * m + (1 - args.beta1) * g
        v = args.beta2 * v + (1 - args.beta2) * g * g
        t = torch.as_tensor(step, device=g.device).clamp_min(1).float()
        mhat = m / (1 - args.beta1 ** t)
        vhat = v / (1 - args.beta2 ** t)
        w = w - lr * mhat / (torch.sqrt(vhat) + args.eps)
        new_opt_rows = torch.cat([m, v], dim=1)
    elif args.optimizer == "adagrad":
        acc = state.opt[safe].float() + g * g
        w = w - lr * g / (torch.sqrt(acc) + args.eps)
        new_opt_rows = acc
    elif args.optimizer == "rowwise_adagrad":
        acc = state.opt[safe].float() + (g * g).mean(dim=1, keepdim=True)
        w = w - lr * g / (torch.sqrt(acc) + args.eps)
        new_opt_rows = acc
    else:
        raise ValueError(args.optimizer)

    masked_set_(state.values, slots, w, ok)
    if new_opt_rows is not None:
        masked_set_(state.opt, slots, new_opt_rows, ok)
    return state
