"""Dynamic-embedding sharding planner (counterpart of
recsys_examples_tpu/dynamicemb/planner.py): fills each table's options the
way the reference planner does (uniform initializer bounds +-1/sqrt(dim), a
bucket-aligned capacity), builds the per-shard tables and reports their
memory. Plain Python; its report string is the JAX package's.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, Tuple

import torch

from recsys_examples_torch.dynamicemb.batched_table import DynamicEmbeddingTable
from recsys_examples_torch.dynamicemb.dynamicemb_config import (
    DynamicEmbInitializerMode,
    DynamicEmbTableOptions,
)
from recsys_examples_torch.dynamicemb.optimizer import SparseOptimizerArgs, value_dim_for


class DistType(enum.Enum):
    """Row-to-shard assignment (reference planner dist_type,
    DynamicEmb_APIs.md:96-104)."""
    CONTINUOUS = "continuous"        # contiguous row ranges
    ROUNDROBIN = "roundrobin"        # key % world
    HASH_ROUNDROBIN = "hash_roundrobin"  # hash(key) % world


@dataclasses.dataclass(frozen=True)
class TablePlanEntry:
    name: str
    options: DynamicEmbTableOptions
    opt_args: SparseOptimizerArgs
    dist_type: DistType
    local_capacity: int
    local_bytes: int


@dataclasses.dataclass
class ShardingPlan:
    entries: Dict[str, TablePlanEntry]
    world_size: int

    def memory_report(self) -> str:
        lines = ["dynamicemb memory plan (per shard):"]
        total = 0
        for e in self.entries.values():
            total += e.local_bytes
            lines.append(
                f"  {e.name}: capacity={e.local_capacity} "
                f"value_dim={value_dim_for(e.opt_args.optimizer, e.options.embedding_dim)} "
                f"bytes={e.local_bytes / 2**20:.1f}MiB dist={e.dist_type.value}"
            )
        lines.append(f"  TOTAL: {total / 2**20:.1f} MiB/shard")
        return "\n".join(lines)


class DynamicEmbeddingShardingPlanner:
    def __init__(self, world_size: int = 1):
        self.world_size = world_size

    def plan(
        self,
        tables: Dict[str, DynamicEmbTableOptions],
        opt_args: SparseOptimizerArgs,
        dist_type: DistType = DistType.ROUNDROBIN,
    ) -> Tuple[ShardingPlan, Dict[str, DynamicEmbeddingTable]]:
        entries = {}
        modules = {}
        for name, opts in tables.items():
            opts = self._prepare_options(opts)
            tbl = DynamicEmbeddingTable(opts, opt_args, self.world_size)
            vd = value_dim_for(opt_args.optimizer, opts.embedding_dim)
            dtype_bytes = torch.empty((), dtype=opts.value_dtype).element_size()
            local_bytes = tbl.capacity * (
                vd * dtype_bytes + 8 + 8  # values + keys + scores
            )
            entries[name] = TablePlanEntry(
                name=name, options=opts, opt_args=opt_args,
                dist_type=dist_type, local_capacity=tbl.capacity,
                local_bytes=local_bytes,
            )
            modules[name] = tbl
        return ShardingPlan(entries, self.world_size), modules

    def _prepare_options(
        self, opts: DynamicEmbTableOptions
    ) -> DynamicEmbTableOptions:
        """Fill defaults the way the reference planner does
        (_prepare_dynemb_table_options planner.py:124): uniform initializer
        bounds default to ±1/sqrt(dim); capacity is bucket-aligned."""
        init = opts.initializer_args
        if (
            init.mode == DynamicEmbInitializerMode.UNIFORM
            and init.lower == 0.0
            and init.upper == 0.0
        ):
            bound = 1.0 / math.sqrt(opts.embedding_dim)
            init = dataclasses.replace(init, lower=-bound, upper=bound)
        cap = max(
            opts.bucket_capacity,
            math.ceil(opts.max_capacity / opts.bucket_capacity)
            * opts.bucket_capacity,
        )
        return dataclasses.replace(
            opts, initializer_args=init, max_capacity=cap
        )
