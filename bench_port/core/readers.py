"""Readings that more than one per-layer metric takes, each a function of a
run's `Reading` that returns None where it finds nothing to read."""


def mfu(r):
    """The model FLOPs counted over the profiled window (counter
    `model_flops`) over its wall time, as a share of the card's dense bf16
    peak."""
    if r.trace is None or not r.counters.get("model_flops"):
        return None
    return 100.0 * r.counters["model_flops"] / r.trace.window_s / r.peaks["bf16_flops"]


def idle_share(r):
    """The share of the profiled window in which no operation ran on the
    card (the window less the union of the operations' intervals)."""
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (r.trace.window_s - r.trace.busy_s) / r.trace.window_s


def scope_ms_per_generate(r, prefix: str):
    """Device milliseconds of the operations launched under the program's
    scopes whose names start with `prefix`, per profiled generate."""
    n = r.counters.get("generates", 0)
    if r.trace is None or not n:
        return None
    t = r.trace.device_seconds(scope_prefix=prefix)
    return 1e3 * t / n if t > 0 else None
