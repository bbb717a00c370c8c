"""Dynamic embedding constants and the bucket hash (counterpart of
recsys_examples_tpu/dynamicemb/dynamicemb_config.py: `EMPTY_KEY`, `hash_keys`).
"""
from __future__ import annotations

import torch

# sentinel for an empty slot
EMPTY_KEY = -(2 ** 63)

_MASK32 = 0xFFFFFFFF


def _u64_const(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


def _lsr(k: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's `>>` is arithmetic)."""
    return (k >> s) & ((1 << (64 - s)) - 1)


def hash_keys(keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """64-bit mix hash -> bucket index. splitmix64 finalizer, then the
    unsigned `% num_buckets`.

    torch has no uint64 shift or remainder on the CPU, so the uint64 math is
    done on int64 bits: the multiply wraps with the same bits, the shift is
    masked to be logical, and the unsigned modulo splits the value into
    32-bit halves: (hi * 2^32 + lo) mod n = ((hi mod n) * (2^32 mod n) + lo)
    mod n, every term below 2^63 for n < 2^31. Bit-exact with the JAX
    package's uint64 version.
    """
    if not 0 < num_buckets < (1 << 31):
        raise ValueError(f"num_buckets {num_buckets} out of range")
    k = keys.to(torch.int64)
    k = (k ^ _lsr(k, 30)) * _u64_const(0xBF58476D1CE4E5B9)
    k = (k ^ _lsr(k, 27)) * _u64_const(0x94D049BB133111EB)
    k = k ^ _lsr(k, 31)
    hi = _lsr(k, 32)
    lo = k & _MASK32
    n = num_buckets
    return ((hi % n) * ((1 << 32) % n) + lo) % n
