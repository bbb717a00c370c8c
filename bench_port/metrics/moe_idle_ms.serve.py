"""MoE layers (`models/lfm2_moe.py`, spans `moe/route`, `moe/experts`,
`moe/combine`): milliseconds a profiled generate in which the card sat idle
waiting for work that the host launched under them (`core/attribution.py`
charges each gap to the innermost span, so this idle is not in
`decode_idle_ms.serve`)."""
from bench_port.core.attribution import idle_ms, program_snapshot


def read(r):
    return idle_ms(r, program_snapshot(), "moe/", r.counters.get("generates", 0))
