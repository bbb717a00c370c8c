"""Time the calls of a program's methods by wrapping them for a while.

A clock is a pair (mark, elapsed_ms): `mark()` is taken before and after
each call, and `elapsed_ms(before, after)` turns the pair into
milliseconds once the timed calls are over (for CUDA events, after a
synchronize)."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List


def host_clock():
    return time.perf_counter, lambda a, b: (b - a) * 1e3


def cuda_clock():
    import torch

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    return mark, lambda a, b: a.elapsed_time(b)


@contextlib.contextmanager
def timed_calls(hooks, clock):
    """While open, each call of a method named in `hooks` ([(object,
    method names)]) records its (before, after) marks under
    "<class>.<method>". Yields a dict that, once the block has closed,
    `ms` turns into milliseconds per call."""
    mark, _ = clock
    marks: Dict[str, List] = {}
    wrapped = []
    for obj, names in hooks:
        for name in names:
            fn = getattr(obj, name)
            key = f"{type(obj).__name__}.{name}"
            marks.setdefault(key, [])

            def call(*a, _fn=fn, _key=key, **kw):
                m0 = mark()
                out = _fn(*a, **kw)
                marks[_key].append((m0, mark()))
                return out
            setattr(obj, name, call)
            wrapped.append((obj, name))
    try:
        yield marks
    finally:
        for obj, name in wrapped:
            delattr(obj, name)


def ms(marks: Dict[str, List], clock) -> Dict[str, List[float]]:
    _, elapsed = clock
    return {key: [elapsed(a, b) for a, b in pairs] for key, pairs in marks.items()}
