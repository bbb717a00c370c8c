"""The rate and tail arithmetic, over windows that hold a stall."""
import time

import numpy as np
import pytest

from bench_port.core.stats import percentile, rate
from bench_port.drivers.serve import Loop


def test_percentile_nearest_rank_keeps_the_stall():
    lat = [10.0] * 19 + [500.0]
    assert percentile(lat, 95) == 10.0
    assert percentile(lat + [500.0], 95) == 500.0
    assert percentile(lat, 100) == 500.0
    assert percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        percentile([], 95)


def test_rate_is_over_the_whole_window():
    # 100 requests in 9 s, then a 1 s stall with none: 10 req/s over 10 s
    assert rate(100, 10.0) == 10.0
    with pytest.raises(ValueError):
        rate(1, 0.0)


class StallingProgram:
    """Answers every queued request at each tick, after `cost` seconds; one
    tick stalls."""

    def __init__(self, cost, stall_at, stall):
        self.cost, self.stall_at, self.stall = cost, stall_at, stall
        self.queue, self.done, self.ticks, self.n = [], {}, 0, 0

    def submit(self, context):
        self.n += 1
        rid = str(self.n)
        self.queue.append((rid, context))
        return rid

    def tick(self):
        self.ticks += 1
        time.sleep(self.cost + (self.stall if self.ticks == self.stall_at else 0.0))
        for rid, c in self.queue:
            self.done[rid] = {"sids": [[1]] * 2, "scores": [0.0, -1.0]}
        n, self.queue = len(self.queue), []
        return n

    def take(self, rid):
        return self.done.pop(rid, None)


class Ctx:
    def next(self):
        return np.zeros(4, np.int32)


def test_closed_loop_latency_counts_the_stall():
    prog = StallingProgram(cost=0.01, stall_at=3, stall=0.2)
    loop = Loop(prog, Ctx(), callers=4, top_k=2)
    t0 = time.perf_counter()
    for _ in range(6):
        loop.tick(resubmit=True)
    t1 = time.perf_counter()
    lat = [r["latency_s"] for r in loop.answered]
    assert len(lat) == 24 and loop.failed == 0
    # the stalled tick's four requests waited the stall
    assert sorted(lat)[-4] >= 0.2
    assert percentile(lat, 95) >= 0.2
    assert rate(len(lat), t1 - t0) < 24 / 0.26
    loop.drain()
    assert not loop.outstanding


def test_a_bad_answer_counts_as_failed():
    prog = StallingProgram(cost=0.0, stall_at=-1, stall=0.0)
    loop = Loop(prog, Ctx(), callers=2, top_k=3)   # answers hold 2 paths, not 3
    loop.tick(resubmit=False)
    assert loop.failed == 2 and not loop.answered
