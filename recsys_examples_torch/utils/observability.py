"""Tracing, profiling and counters (counterpart of
recsys_examples_tpu/utils/observability.py).

  - `named_scope`: a `torch.profiler.record_function` range, the NVTX range
    of the reference; it shows in `profiler_window`'s trace.
  - `profiler_window`: `torch.profiler` over the block (CPU, and CUDA when a
    card is present); on exit a chrome trace is written into `out_dir`. The
    profiler is yielded, so a caller can read `key_averages()`.
  - `DeviceTimer`: wall time whose window closes with a sync on the watched
    outputs' devices, as JAX's `block_until_ready` closes it.
  - `AttnPerfTracker`: per-call attention FLOPs and TFLOP/s.
  - `table_stats`: a dynamic table's counters.
`PRINT_HSTU_PERF` is the JAX package's environment flag.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from recsys_examples_torch.dynamicemb.hashtable import table_size

PRINT_HSTU_PERF = os.environ.get("PRINT_HSTU_PERF", "0") == "1"


def named_scope(name: str):
    """A profiler range; costs almost nothing when no profiler runs."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiler_window(out_dir: Optional[str] = None):
    """Profile the block; write `trace.json` (chrome format) into `out_dir`
    (a `rextorch_trace` directory under the temp dir by default)."""
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "rextorch_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def _sync(x):
    """Wait for the device work behind every tensor in x (nested lists,
    tuples and dicts too)."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _sync(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _sync(v)


class DeviceTimer:
    """Wall-clock timing at device boundaries (the reference's GPUTimer):
    each window ends with a sync on the watched outputs."""

    def __init__(self):
        self.records: Dict[str, list] = {}

    @contextlib.contextmanager
    def time(self, name: str, *outputs):
        t0 = time.perf_counter()
        yield
        _sync(outputs)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        """Median ms per name."""
        return {k: float(np.median(v)) * 1e3 for k, v in self.records.items()}


class AttnPerfTracker:
    """Per-call attention FLOPs and latency (PRINT_HSTU_PERF prints each)."""

    def __init__(self, peak_tflops: float):
        self.peak = peak_tflops
        self.calls = []

    def record(self, seqlens: np.ndarray, heads: int, dim: int, dt_s: float):
        fl = float((2.0 * 2.0 * heads * dim * (seqlens.astype(np.float64) ** 2) / 2).sum())
        tflops = fl / dt_s / 1e12
        self.calls.append((dt_s, tflops))
        if PRINT_HSTU_PERF:
            print(f"[attn] {dt_s * 1e3:.2f} ms  {tflops:.1f} TFLOPS "
                  f"({100 * tflops / self.peak:.1f}% MFU)")


def table_stats(state) -> Dict[str, int]:
    """A `DynamicEmbTableState`'s counters."""
    t = state.table
    return {
        "size": int(table_size(t)),
        "capacity": t.capacity,
        "inserted": int(t.inserted[0]),
        "evicted": int(t.evicted[0]),
        "overflowed": int(t.overflowed[0]),
    }
