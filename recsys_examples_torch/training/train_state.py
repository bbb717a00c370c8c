"""Dense optimizers (counterpart of recsys_examples_tpu/training/train_state.py
`make_optimizer`).

`make_optimizer` returns a factory: torch optimizers are built over the
params, so the trainer calls it with the model's parameters. The optax
semantics are pinned:
  - adam / adamw: betas, eps outside the square root, bias correction,
    no amsgrad; adamw's weight decay is decoupled, as optax's is;
  - sgd: plain, no momentum;
  - adagrad: optax's initial accumulator 0.1. torch adds eps to the root
    (g / (sqrt(sum) + eps)), optax inside it (g / sqrt(sum + eps)); with the
    default eps the two differ far below fp32 rounding of the update.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch

OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]


def make_optimizer(
    lr: float = 1e-3,
    optimizer: str = "adam",
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> OptimizerFactory:
    if optimizer == "adam":
        return lambda params: torch.optim.Adam(
            params, lr=lr, betas=(beta1, beta2), eps=eps, weight_decay=0.0,
            amsgrad=False)
    if optimizer == "adamw":
        return lambda params: torch.optim.AdamW(
            params, lr=lr, betas=(beta1, beta2), eps=eps,
            weight_decay=weight_decay, amsgrad=False)
    if optimizer == "sgd":
        return lambda params: torch.optim.SGD(params, lr=lr, momentum=0.0)
    if optimizer == "adagrad":
        return lambda params: torch.optim.Adagrad(
            params, lr=lr, eps=eps, initial_accumulator_value=0.1)
    raise ValueError(f"unknown optimizer {optimizer}")
