"""Simple MLP (counterpart of recsys_examples_tpu/modules/mlp.py, with its
defaults: bias, relu between layers, none after the last)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

_ACTS = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # flax nn.gelu's default
    "silu": F.silu,
    "none": lambda x: x,
}


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's lecun_normal: a normal truncated at 2 sigma, scaled to variance
    1/fan_in, drawn on the generator's device."""
    std = fan_in ** -0.5 / 0.87962566103423978
    t = torch.empty(w.shape, device=generator.device)
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
    w.copy_(t)


class MLP(nn.Module):
    """`nn.Linear`s (`layers.i`, flax's `layer_i`) with `activation` between
    them. Like flax `Dense(dtype=...)`, each layer computes in `dtype` from
    its fp32 params."""

    def __init__(self, in_features: int, layer_sizes: Sequence[int],
                 dtype: Optional[torch.dtype] = None, device=None,
                 activation: str = "relu", use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.act = _ACTS[activation]
        sizes = [in_features, *layer_sizes]
        self.layers = nn.ModuleList(
            nn.Linear(a, b, bias=use_bias, device=device)
            for a, b in zip(sizes[:-1], sizes[1:])
        )

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax Dense's init: lecun normal kernels, zero biases."""
        for lin in self.layers:
            lecun_normal_(lin.weight, lin.in_features, generator)
            if lin.bias is not None:
                lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.layers):
            w, b = lin.weight, lin.bias
            if self.dtype is not None:
                x, w = x.to(self.dtype), w.to(self.dtype)
                b = None if b is None else b.to(self.dtype)
            x = F.linear(x, w, b)
            if i < len(self.layers) - 1:
                x = self.act(x)
        return x
