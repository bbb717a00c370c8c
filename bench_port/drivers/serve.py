"""The serving driver: a closed loop of `callers` callers in one process.
Each caller submits a request, waits for its result and submits the next;
the scheduler's tick serves one batch. The loop runs `warm_ticks` ticks in
set-up (the cell's shapes, and a queue at its steady depth), then the
window: ticks until `seconds` have passed. A request's latency runs from
its submission to the return of the tick that answered it; the rate counts
the requests answered in the window over the window's whole wall time.
After the window the queue is drained without new submissions, and a
sample of the answered requests (the longest context among them, the rest
drawn by the seed) goes to the reference once the program is freed.

The traced run times the scheduler's ticks and the engine's generates on
the host over `trace_span_ticks` ticks, then profiles `trace_profile_ticks`
ticks with every generate's lengths and every K7 call recorded."""
from __future__ import annotations

import time

import numpy as np
import torch

from bench_port.core import spans
from bench_port.core import weights as wts
from bench_port.core.cell import module
from bench_port.core.peaks import peaks_for
from bench_port.core.runctx import Outcome, Reading, RunContext, free, memory_peak, sync
from bench_port.core.stats import percentile, rate
from bench_port.core.trace import profiled


class Loop:
    """The callers' closed loop over a program's submit / tick / take."""

    def __init__(self, prog, requests, callers: int, top_k: int):
        self.prog, self.requests, self.top_k = prog, requests, top_k
        self.outstanding = {}       # rid -> (submitted at, context)
        self.answered = []          # dicts: context, paths, scores, latency_s, at
        self.failed = 0
        for _ in range(callers):
            self.submit()

    def submit(self):
        c = self.requests.next()
        t = time.perf_counter()
        self.outstanding[self.prog.submit(c)] = (t, c)

    def _ok(self, r) -> bool:
        if r is None or "error" in r or len(r.get("sids", ())) != self.top_k:
            return False
        s = np.asarray(r["scores"], np.float64)
        return bool(np.isfinite(s).all() and (np.diff(s) <= 0).all())

    def tick(self, resubmit: bool) -> int:
        """One tick; each answered caller submits again when `resubmit`."""
        self.prog.tick()
        now = time.perf_counter()
        n = 0
        for rid in list(self.outstanding):
            r = self.prog.take(rid)
            if r is None:
                continue
            t, c = self.outstanding.pop(rid)
            n += 1
            if self._ok(r):
                self.answered.append({"context": c, "paths": r["sids"], "scores": r["scores"],
                                      "latency_s": now - t, "at": now})
            else:
                self.failed += 1
            if resubmit:
                self.submit()
        return n

    def drain(self, max_ticks: int = 10_000):
        for _ in range(max_ticks):
            if not self.outstanding:
                return
            self.tick(resubmit=False)
        raise RuntimeError(f"{len(self.outstanding)} requests never answered")


def sample(answered, n: int, seed: int):
    """`n` answered requests: the one with the longest context, and the rest
    drawn by the seed."""
    if len(answered) <= n:
        return list(answered)
    longest = max(range(len(answered)), key=lambda i: len(answered[i]["context"]))
    rest = [i for i in range(len(answered)) if i != longest]
    pick = np.random.default_rng(seed + 1).choice(len(rest), size=n - 1, replace=False)
    return [answered[longest]] + [answered[rest[i]] for i in sorted(pick)]


def weights(ctx: RunContext, fam):
    """The seed's weights, made on the device in the type they are served in."""
    return wts.make(fam.param_spec(ctx.config), ctx.seed, ctx.device,
                    fam.weight_dtype(ctx.config))


def build(ctx: RunContext):
    """Set-up: the program from the seed's weights behind the callers' loop,
    run through `warm_ticks` ticks. Returns (family, program, loop)."""
    wl, cfg = ctx.workload, ctx.config
    fam = module("families", cfg["family"])
    prog = fam.Program(cfg, wl, weights(ctx, fam), ctx.device)
    loop = Loop(prog, fam.Requests(wl, cfg, ctx.seed), wl["callers"], wl["top_k"])
    for _ in range(wl["warm_ticks"]):
        loop.tick(resubmit=True)
    return fam, prog, loop


def run(ctx: RunContext) -> Outcome:
    wl, cfg, dev = ctx.workload, ctx.config, ctx.device
    fam, prog, loop = build(ctx)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t0

    metrics, reading = {}, None
    start = len(loop.answered)
    if not ctx.trace:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            loop.tick(resubmit=True)
        t1 = time.perf_counter()
        window = [r for r in loop.answered[start:] if r["at"] <= t1]
        if not window:
            raise RuntimeError("no request was answered in the window")
        metrics = {"setup_s": setup_s, "serve_req_per_s": rate(len(window), t1 - t0),
                   "serve_p95_ms": percentile([r["latency_s"] * 1e3 for r in window], 95)}
    else:
        peaks = peaks_for(torch.cuda.get_device_name(0)) if dev.startswith("cuda") else {}
        clock = spans.host_clock()
        with spans.timed_calls(prog.hooks(), clock) as marks:
            for _ in range(wl["trace_span_ticks"]):
                loop.tick(resubmit=True)
        with prog.recording() as rec:
            with profiled(lambda: sync(dev)) as out:
                for _ in range(wl["trace_profile_ticks"]):
                    loop.tick(resubmit=True)
        counters = prog.work(rec, peaks)
        del rec
        reading = Reading(spans=spans.ms(marks, clock), counters=counters,
                          trace=out["trace"], peaks=peaks)
    loop.drain()
    peak = memory_peak(dev)
    attempted = len(loop.answered) + loop.failed
    failed = loop.failed
    checked = sample(loop.answered, wl["check_requests"], ctx.seed)
    del prog, loop
    free(dev)

    compared = fam.check(cfg, wl, weights(ctx, fam), checked)
    free(dev)
    return Outcome(attempted=attempted, failed=failed, metrics=metrics, compared=compared,
                   memory_peak_bytes=peak, reading=reading)
