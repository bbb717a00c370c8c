"""Seeded weights made on the device in a few large calls.

A spec lists (name, shape, init) for every parameter: init is ("normal",
std), ("normal", std, mean) or ("uniform", low, high). The normal and the
uniform parameters each come from draws of their total size (in chunks of
at most 2^30 values) by a generator on the device seeded with the run's
seed; each parameter is a scaled slice of them, in the dtype it is served
in. The same seed gives the same weights on every call: the reference draws
its own copy after the program has been freed."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], tuple]]

_SEED_MASK = (1 << 63) - 1
_CHUNK = 1 << 30


def _draw(fn, n: int, gen, device, dtype) -> torch.Tensor:
    out = torch.empty(n, device=device, dtype=dtype)
    for i in range(0, n, _CHUNK):
        fn(out[i:i + _CHUNK], gen)
    return out


def make(spec: Spec, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed & _SEED_MASK)
    kinds = {"normal": lambda t, g: t.normal_(generator=g),
             "uniform": lambda t, g: t.uniform_(generator=g)}
    pools = {}
    for kind, fill in kinds.items():
        n = sum(math.prod(shape) for _, shape, init in spec if init[0] == kind)
        pools[kind] = [_draw(fill, n, gen, device, dtype), 0]
    out = {}
    for name, shape, init in spec:
        if init[0] not in pools:
            raise ValueError(f"{name}: unknown init {init}")
        pool = pools[init[0]]
        size = math.prod(shape)
        t = pool[0][pool[1]:pool[1] + size].view(shape)
        pool[1] += size
        if init[0] == "normal":
            t.mul_(init[1])
            if len(init) > 2:
                t.add_(init[2])
        else:
            t.mul_(init[2] - init[1]).add_(init[1])
        out[name] = t
    return out
