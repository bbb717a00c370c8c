"""Runtime (`qwen3_runtime.py`, spans `qwen3/decode_*`): milliseconds a
profiled generate in which the card sat idle waiting for work that the
host launched in the decode steps (`core/attribution.py`)."""
from bench_port.core.attribution import idle_ms, program_snapshot


def read(r):
    return idle_ms(r, program_snapshot(), "qwen3/decode_", r.counters.get("generates", 0))
