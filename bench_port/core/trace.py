"""A profiled window on the card and its reduction: the device's operations
with the host scopes they were launched under, the busy time (the union of
the device's operation intervals), and the idle gaps with what the host was
doing in each.

The profiler writes its chrome trace into a fresh directory under the
run's temporary directory (`TMPDIR`); it is read back and deleted."""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

WINDOW = "bench/window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# device operation kinds for the breakdown, by kernel name fragment (the
# grouping of the port's smoke script); the first match wins
GROUPS = (
    ("attention (wgmma)", ("wgmma_kernel",)),
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("sort", ("sort", "radix")),
    ("gather/scatter", ("index", "scatter", "gather")),
    ("optimizer", ("multi_tensor", "adam")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
    ("memcpy/memset", ("memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized")),
)


@dataclasses.dataclass
class Kernel:
    name: str
    start_us: float
    dur_us: float
    scopes: Tuple[str, ...]     # host annotations open at its launch


@dataclasses.dataclass
class Trace:
    kernels: List[Kernel]
    window_s: float
    busy_s: float
    idle_gaps: List[Tuple[str, float]]      # (host label, seconds), grouped

    def device_seconds(self, pattern=None, scope_prefix: Optional[str] = None) -> float:
        """Device seconds of the operations whose name matches `pattern` (a
        compiled regular expression) and that were launched under a scope
        starting with `scope_prefix`."""
        total = 0.0
        for k in self.kernels:
            if pattern is not None and not pattern.search(k.name):
                continue
            if scope_prefix is not None and not any(s.startswith(scope_prefix)
                                                    for s in k.scopes):
                continue
            total += k.dur_us
        return total * 1e-6

    def device_ops(self, top: int = 10) -> List[List]:
        """Device seconds by kind of operation, largest first."""
        totals: Dict[str, float] = {}
        for k in self.kernels:
            low = k.name.lower()
            g = next((g for g, keys in GROUPS if any(s in low for s in keys)), "other")
            totals[g] = totals.get(g, 0.0) + k.dur_us * 1e-6
        return [[g, s] for g, s in sorted(totals.items(), key=lambda x: -x[1])[:top]]


@contextlib.contextmanager
def profiled(sync):
    """Profile the block (host and card). Yields a dict that holds the
    parsed `Trace` under "trace" once the block has ended. `sync` waits for
    the card; it runs at both ends of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    out: Dict[str, Trace] = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        with record_function(WINDOW):
            yield out
            sync()
    tmp = tempfile.mkdtemp(prefix="bench_port_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del prof
    out["trace"] = parse(events["traceEvents"] if isinstance(events, dict) else events)
    torch.cuda.synchronize()


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def parse(events: List[dict], top_gaps: int = 10) -> Trace:
    """Reduce chrome-trace events to the window's device operations, its
    busy seconds and its idle gaps."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    tid = win[0].get("tid")

    # host scopes on the window's thread, and the launch time of each
    # correlation id
    scopes = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in xs if e.get("cat") == "user_annotation"
                    and e.get("tid") == tid and e["name"] != WINDOW)
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in xs
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}

    def open_scopes(t: float) -> Tuple[str, ...]:
        return tuple(n for s, e, n in scopes if s <= t <= e)

    kernels, spans = [], []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if s + d < w0 or s > w1:
            continue
        t = launch.get(e.get("args", {}).get("correlation"))
        kernels.append(Kernel(e["name"], s, d, open_scopes(t) if t is not None else ()))
        spans.append((max(s, w0), min(s + d, w1)))
    busy = _union(spans)
    busy_us = sum(e - s for s, e in busy)

    # idle gaps, labelled by the innermost host operation open at the gap's
    # start on the window's thread
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                 for e in xs if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver")
                 and e.get("tid") == tid)
    starts = [o[0] for o in ops]
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    gaps: Dict[str, float] = {}
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        i = bisect.bisect_right(starts, g0)
        cover = [o for o in ops[max(0, i - 200):i] if o[1] >= g0]
        label = min(cover, key=lambda o: o[1] - o[0])[2] if cover else "host (no op)"
        gaps[label] = gaps.get(label, 0.0) + (g1 - g0) * 1e-6
    idle = sorted(gaps.items(), key=lambda x: -x[1])[:top_gaps]
    return Trace(kernels=kernels, window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                 idle_gaps=[(n, s) for n, s in idle])
