"""Tiny cells for the CPU tests: each cell's configuration and traffic cut
to a size the CPU runs in seconds, with the same drivers, families,
references and limits."""
from __future__ import annotations

import copy

from bench_port.core import cell as cells


def _scaled(name: str, config: dict, workload: dict) -> cells.Cell:
    c = cells.resolve(name)
    cfg = copy.deepcopy(c.config)
    cfg.update(config)
    wl = copy.deepcopy(c.workload)
    wl.update(workload)
    return cells.Cell(name=name, workload=wl, config=cfg, end_to_end=c.end_to_end,
                      per_layer=c.per_layer, chips=c.chips)


def hstu(name: str = "hstu_train") -> cells.Cell:
    cfg = cells.resolve(name).config
    tables = {n: dict(t, vocab=5000) for n, t in cfg["dynamic_tables"].items()}
    return _scaled(name, {"hidden_size": 64, "num_layers": 2, "num_attention_heads": 2,
                          "kv_channels": 32, "embedding_dim": 16, "num_position_buckets": 128,
                          "prediction_head_arch": [32, 8], "dynamic_tables": tables,
                          "dynamic_table_rows": 1 << 14},
                   {"batch_size": 4, "max_history": 48, "pool_batches": 4})


def qwen3(name: str) -> cells.Cell:
    wl = cells.resolve(name).workload
    return _scaled(name, {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
                          "num_hidden_layers": 2, "num_attention_heads": 4,
                          "num_key_value_heads": 2, "head_dim": 16},
                   {"callers": 4, "max_batch": 2, "ctx_min": 8, "ctx_max": 40,
                    "length_cycle": 8, "beam_width": min(wl["beam_width"], 16),
                    "ctx_buckets": [64], "batch_buckets": [1, 2], "warm_ticks": 2,
                    "check_requests": 3})
