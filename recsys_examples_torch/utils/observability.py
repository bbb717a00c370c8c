"""Tracing, profiling and counters (counterpart of
recsys_examples_tpu/utils/observability.py).

  - `named_scope(name, **attrs)`: the port's one span primitive. While
    tracing is on it records a span (name, parent, start, end, attrs) in a
    bounded in-memory buffer, and while a `torch.profiler` records it also
    opens `torch.profiler.record_function(name)`, so the span shows in the
    profiler's trace beside the device's operations. While tracing is off it
    returns one shared no-op context: no profiler range, no clock read.
  - Tracing is on inside `tracing()` and while a `torch.profiler` records.
  - `record(name, start_s, end_s, **attrs)`: a span that has already ended
    (a request's wait in a queue), on `time.perf_counter()` seconds.
  - `count(name, n)`: adds to a counter while tracing is on; `n` may be a
    device tensor, summed only when `snapshot()` reads it.
  - `snapshot()` / `reset()`: what was recorded, and clearing it.
  - `profiler_window`: `torch.profiler` over the block (CPU, and CUDA when a
    card is present); on exit a chrome trace is written into `out_dir`. The
    profiler is yielded, so a caller can read `key_averages()`.
  - `table_stats`: a dynamic table's counters.

Span times are on the profiler's clock: Unix-time microseconds, which in a
chrome trace the profiler exports are `ts + baseTimeNanoseconds / 1000`.
Durations come from `time.perf_counter_ns()`, turned into that clock by one
(`perf_counter_ns`, `time_ns`) pair taken when recording starts.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

import torch

SPAN_CAPACITY = 1 << 17     # spans kept; the oldest go first
_FOLD = 256                 # device counts held per counter before one fold

_profiler_on = torch._C._autograd._profiler_enabled
_forced = 0                 # open `tracing()` blocks
_anchor: Optional[tuple] = None     # (perf_counter_ns, time_ns) of this recording
_spans: collections.deque = collections.deque(maxlen=SPAN_CAPACITY)
_host_counts: Dict[str, float] = {}
_device_counts: Dict[str, List[torch.Tensor]] = {}
_ids = itertools.count(1)
_local = threading.local()  # per thread: the stack of open span ids
_lock = threading.Lock()
_NOOP = contextlib.nullcontext()


def enabled() -> bool:
    """Whether spans and counts are recorded now."""
    return bool(_forced) or _profiler_on()


@contextlib.contextmanager
def tracing():
    """Record spans and counts inside the block, with or without a
    profiler."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _start() -> tuple:
    """This recording's clock pair, taken at its first span."""
    global _anchor
    if _anchor is None:
        _anchor = (time.perf_counter_ns(), time.time_ns())
    return _anchor


def _keep(anchor, sid, name, parent, t0_ns, t1_ns, attrs) -> None:
    """Keep a span, its perf_counter_ns readings put on the profiler's
    clock in microseconds."""
    pc, unix = anchor
    _spans.append((sid, name, parent, threading.get_ident(), (unix + t0_ns - pc) / 1e3,
                   (unix + t1_ns - pc) / 1e3, attrs))


class _Span:
    __slots__ = ("name", "attrs", "anchor", "sid", "parent", "t0", "rf")

    def __init__(self, name: str, attrs: dict, anchor: tuple):
        self.name, self.attrs, self.anchor = name, attrs, anchor

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.sid = next(_ids)
        stack.append(self.sid)
        self.t0 = time.perf_counter_ns()
        self.rf = None
        if _profiler_on():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = time.perf_counter_ns()
        _stack().pop()
        _keep(self.anchor, self.sid, self.name, self.parent, self.t0, t1, self.attrs)
        return False


def named_scope(name: str, **attrs):
    """A span over the block while tracing is on (see the module's
    docstring); the shared no-op context otherwise."""
    global _anchor
    if _forced or _profiler_on():
        return _Span(name, attrs, _start())
    _anchor = None              # the next recording takes a fresh pair
    return _NOOP


def record(name: str, start_s: float, end_s: float, **attrs) -> None:
    """A span that ran from `start_s` to `end_s` (`time.perf_counter()`
    seconds), under the innermost span open on this thread."""
    if not enabled():
        return
    stack = _stack()
    _keep(_start(), next(_ids), name, stack[-1] if stack else None, int(start_s * 1e9),
          int(end_s * 1e9), attrs)


def count(name: str, n=1) -> None:
    """Add `n` (a number, or a one-element tensor on any device) to the
    counter `name` while tracing is on. A tensor is kept as it is and summed
    by `snapshot()`, so counting never waits for the device."""
    if not enabled():
        return
    if isinstance(n, torch.Tensor):
        held = _device_counts.setdefault(name, [])
        held.append(n.detach().reshape(()))
        if len(held) >= _FOLD:
            held[:] = _sum(held)
    else:
        _host_counts[name] = _host_counts.get(name, 0) + n


def _sum(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    """One sum per device and dtype of the tensors `ts`."""
    groups: Dict[tuple, list] = {}
    for t in ts:
        groups.setdefault((t.device, t.dtype), []).append(t)
    return [torch.stack(v).sum() for v in groups.values()]


def snapshot() -> dict:
    """{"spans": [...], "counters": {...}}: every span kept since the last
    `reset()` as a dict (id, name, parent id or None, thread, start_us,
    end_us, attrs), in the order they ended, and every counter's total.
    Device counts are read here, which waits for their devices."""
    spans = [{"id": sid, "name": name, "parent": parent, "thread": thread,
              "start_us": t0, "end_us": t1, "attrs": dict(attrs)}
             for sid, name, parent, thread, t0, t1, attrs in list(_spans)]
    counters = dict(_host_counts)
    for name, held in _device_counts.items():
        if held:
            counters[name] = counters.get(name, 0) + sum(float(t) for t in _sum(held))
    return {"spans": spans,
            "counters": {k: int(v) if float(v).is_integer() else v
                         for k, v in counters.items()}}


def reset() -> None:
    """Forget every span and counter recorded so far."""
    _spans.clear()
    _host_counts.clear()
    _device_counts.clear()


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


def table_stats(state) -> Dict[str, int]:
    """A `DynamicEmbTableState`'s counters."""
    from recsys_examples_torch.dynamicemb.hashtable import table_size

    t = state.table
    return {
        "size": int(table_size(t)),
        "capacity": t.capacity,
        "inserted": int(t.inserted[0]),
        "evicted": int(t.evicted[0]),
        "overflowed": int(t.overflowed[0]),
    }
