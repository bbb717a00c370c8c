"""On-miss embedding initializers (counterpart of
recsys_examples_tpu/dynamicemb/initializer.py).

Initial values are generated from the missed keys themselves (a key-seeded
counter RNG), so the same key always initializes identically, whatever the
batch or the device. The uint64 hash runs on int64 bits, as `hash_keys`
does, and gives the JAX package's bits: UNIFORM, CONSTANT and DEBUG are
bit-exact, the normal modes go through `log` and `cos` and agree to 1e-6.
"""
from __future__ import annotations

import math

import torch

from recsys_examples_torch.dynamicemb.dynamicemb_config import (
    DynamicEmbInitializerArgs,
    DynamicEmbInitializerMode,
    _u64_const,
    splitmix64,
)


def _key_bits(keys: torch.Tensor, dim: int, salt: int) -> torch.Tensor:
    """[n, dim] hash bits in [0, 2^32) (as int64) from (key, column, salt)."""
    k = keys.to(torch.int64)[:, None]
    col = torch.arange(dim, dtype=torch.int64, device=keys.device)[None, :]
    x = splitmix64(k * _u64_const(0x9E3779B97F4A7C15) + col + salt)
    return x & 0xFFFFFFFF


def _uniform01(bits: torch.Tensor) -> torch.Tensor:
    # int64 -> float32 rounds to nearest even, as uint32 -> float32 does
    return bits.to(torch.float32) * (1.0 / 4294967296.0)


def initialize_embeddings(
    keys: torch.Tensor,   # [n] int64
    dim: int,
    args: DynamicEmbInitializerArgs,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """[n, dim] initial embedding values, on the keys' device."""
    mode = args.mode
    n = keys.shape[0]
    if mode == DynamicEmbInitializerMode.CONSTANT:
        return torch.full((n, dim), args.value, dtype=dtype, device=keys.device)
    if mode == DynamicEmbInitializerMode.DEBUG:
        v = (keys.to(torch.int64) % 100000).to(torch.float32) / 100000.0
        return v[:, None].expand(n, dim).to(dtype)
    if mode == DynamicEmbInitializerMode.UNIFORM:
        lo, hi = args.lower, args.upper
        if lo == 0.0 and hi == 0.0:
            hi = 1.0 / (dim ** 0.5)
            lo = -hi
        u = _uniform01(_key_bits(keys, dim, 1))
        return (lo + (hi - lo) * u).to(dtype)
    # normal / truncated normal: Box-Muller on two hash streams
    u1 = _uniform01(_key_bits(keys, dim, 2)).clamp_min(1e-7)
    u2 = _uniform01(_key_bits(keys, dim, 3))
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    if mode == DynamicEmbInitializerMode.TRUNCATED_NORMAL:
        z = z.clamp(-2.0, 2.0)
    return (args.mean + args.std_dev * z).to(dtype)
