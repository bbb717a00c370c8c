"""The arithmetic of the end-to-end metrics: rates over a whole window, and
the tail of every request in it.

A rate is the work of the window over its whole wall time: a stall inside
the window lowers it, as a user would see. A percentile is taken over every
request that completed in the window, the slowest included."""
from __future__ import annotations

import math
from typing import Sequence


def rate(work: float, seconds: float) -> float:
    """Work per second over a window of `seconds`."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return work / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q <= 100) by the nearest-rank rule: the
    smallest value with at least q% of the values at or below it. Every value
    counts, so one stalled request in twenty is the 95th percentile."""
    if not values:
        raise ValueError("no values")
    if not 0 < q <= 100:
        raise ValueError(f"percentile {q} outside (0, 100]")
    ordered = sorted(values)
    rank = math.ceil(q / 100.0 * len(ordered))
    return float(ordered[max(rank, 1) - 1])

