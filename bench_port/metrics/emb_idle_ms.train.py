"""dynamicemb/ (`ShardedDynamicEmbedding`, spans `emb/*`): milliseconds a
profiled train step in which the card sat idle waiting for work that the
host launched in phases A and C (`core/attribution.py`)."""
from bench_port.core.attribution import idle_ms, program_snapshot, spans_named


def read(r):
    snap = program_snapshot()
    return idle_ms(r, snap, "emb/", len(spans_named(snap, "train/step")))
