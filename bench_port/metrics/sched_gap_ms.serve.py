"""Scheduler (`GRContinuousScheduler.tick`): host milliseconds of a tick
outside the engine's generate, a mean over the timed ticks."""


def read(r):
    ticks = r.spans.get("GRContinuousScheduler.tick", [])
    gens = r.spans.get("Qwen3ServingEngine.generate", [])
    if not ticks or len(ticks) != len(gens):
        return None
    return sum(t - g for t, g in zip(ticks, gens)) / len(ticks)
