"""Dynamic embedding configuration, constants and the bucket hash
(counterpart of recsys_examples_tpu/dynamicemb/dynamicemb_config.py).

A table is a set of dense tensors (keys, scores, values, optimizer state)
laid out as fixed-size buckets; eviction is a min over a bucket's scores.
"""
from __future__ import annotations

import dataclasses
import enum
import math

import torch

# sentinel for an empty slot
EMPTY_KEY = -(2 ** 63)

_MASK32 = 0xFFFFFFFF


class DynamicEmbScoreStrategy(enum.Enum):
    """How per-key scores (eviction priority; larger = keep) are produced.

    TIMESTAMP: score = the table's step counter at the lookup.
    STEP:      the same counter.
    LFU:       score = access frequency count.
    CUSTOM:    the caller passes scores per lookup.
    """

    TIMESTAMP = "timestamp"
    STEP = "step"
    LFU = "lfu"
    CUSTOM = "custom"


class DynamicEmbEvictStrategy(enum.Enum):
    LRU = "lru"
    LFU = "lfu"
    CUSTOM = "custom"


class DynamicEmbInitializerMode(enum.Enum):
    NORMAL = "normal"
    TRUNCATED_NORMAL = "truncated_normal"
    UNIFORM = "uniform"
    CONSTANT = "constant"
    DEBUG = "debug"   # value = (key % 100000) / 100000 (deterministic, for tests)


@dataclasses.dataclass(frozen=True)
class DynamicEmbInitializerArgs:
    mode: DynamicEmbInitializerMode = DynamicEmbInitializerMode.UNIFORM
    mean: float = 0.0
    std_dev: float = 1.0
    lower: float = 0.0   # lower == upper == 0: +-1/sqrt(dim)
    upper: float = 0.0
    value: float = 0.0


@dataclasses.dataclass(frozen=True)
class DynamicEmbTableOptions:
    """Per-table options."""

    embedding_dim: int
    global_hbm_for_values: int = 0          # bytes budget (informational)
    max_capacity: int = 2 ** 16             # global slots across all shards
    bucket_capacity: int = 128              # slots per hash bucket
    initializer_args: DynamicEmbInitializerArgs = DynamicEmbInitializerArgs()
    eval_initializer_args: DynamicEmbInitializerArgs = DynamicEmbInitializerArgs(
        mode=DynamicEmbInitializerMode.CONSTANT, value=0.0
    )
    score_strategy: DynamicEmbScoreStrategy = DynamicEmbScoreStrategy.TIMESTAMP
    evict_strategy: DynamicEmbEvictStrategy = DynamicEmbEvictStrategy.LRU
    admission_threshold: int = 0            # >0 enables frequency admission
    value_dtype: torch.dtype = torch.float32
    # insert conflict-resolution rounds (claim/retry passes)
    insert_rounds: int = 16
    safe_check_mode: bool = False

    def sharded_capacity(self, world_size: int) -> int:
        """Per-shard slot count, bucket aligned."""
        per = math.ceil(self.max_capacity / world_size)
        buckets = max(1, math.ceil(per / self.bucket_capacity))
        return buckets * self.bucket_capacity


def _u64_const(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


def _lsr(k: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's `>>` is arithmetic)."""
    return (k >> s) & ((1 << (64 - s)) - 1)


def splitmix64(k: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer on int64 bits (the uint64 result's bits)."""
    k = (k ^ _lsr(k, 30)) * _u64_const(0xBF58476D1CE4E5B9)
    k = (k ^ _lsr(k, 27)) * _u64_const(0x94D049BB133111EB)
    return k ^ _lsr(k, 31)


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
    return umod(splitmix64(keys.to(torch.int64)), num_buckets)


def umod(k: torch.Tensor, n: int) -> torch.Tensor:
    """The uint64 that int64 `k` holds, mod n (0 < n < 2^31), on int64."""
    if not 0 < n < (1 << 31):
        raise ValueError(f"modulus {n} out of range")
    hi = _lsr(k, 32)
    lo = k & _MASK32
    return ((hi % n) * ((1 << 32) % n) + lo) % n
