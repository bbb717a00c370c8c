"""dynamicemb/ (`ShardedDynamicEmbedding`, spans `emb/phase_a` and
`emb/phase_c`): device milliseconds of the operations launched in phases A
and C of every dynamic table, per profiled train step (the program's
`train/step` spans)."""
from bench_port.core.attribution import program_snapshot, spans_named


def read(r):
    snap = program_snapshot()
    steps = len(spans_named(snap, "train/step"))
    if r.trace is None or not steps or not spans_named(snap, "emb/phase_a"):
        return None
    t = sum(r.trace.device_seconds(scope_prefix=p) for p in ("emb/phase_a", "emb/phase_c"))
    return 1e3 * t / steps
