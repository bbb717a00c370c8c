"""Scheduler (`GRContinuousScheduler.tick`, spans `serve/tick` and
`serve/generate`): host milliseconds of a tick outside the engine's
generate, a mean over the profiled ticks."""
from bench_port.core.attribution import program_snapshot, spans_named


def read(r):
    snap = program_snapshot()
    ticks = spans_named(snap, "serve/tick")
    if not ticks:
        return None
    dur = lambda s: s["end_us"] - s["start_us"]
    inner = {t["id"]: 0.0 for t in ticks}
    for g in spans_named(snap, "serve/generate"):
        if g["parent"] in inner:
            inner[g["parent"]] += dur(g)
    return sum(dur(t) - inner[t["id"]] for t in ticks) / 1e3 / len(ticks)
