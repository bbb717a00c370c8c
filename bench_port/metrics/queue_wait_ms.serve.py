"""Scheduler (`GRContinuousScheduler.tick`, span `serve/queue`): a request's
wait from its submission to the tick that took it into a batch, in
milliseconds, a mean over the requests admitted in the profiled ticks."""
from bench_port.core.attribution import program_snapshot, spans_named


def read(r):
    waits = spans_named(program_snapshot(), "serve/queue")
    if not waits:
        return None
    return sum(s["end_us"] - s["start_us"] for s in waits) / 1e3 / len(waits)
