"""Simple MLP head (counterpart of recsys_examples_tpu/modules/mlp.py, with
its defaults: bias, relu between layers, none after the last)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


class MLP(nn.Module):
    """`nn.Linear`s (`layers.i`, flax's `layer_i`) with relu between them.
    Like flax `Dense(dtype=...)`, each layer computes in `dtype` from its
    fp32 params."""

    def __init__(self, in_features: int, layer_sizes: Sequence[int],
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dtype = dtype
        sizes = [in_features, *layer_sizes]
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=device) for a, b in zip(sizes[:-1], sizes[1:])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            w, b = lin.weight, lin.bias
            if self.dtype is not None:
                x, w, b = x.to(self.dtype), w.to(self.dtype), b.to(self.dtype)
            x = nn.functional.linear(x, w, b)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x
