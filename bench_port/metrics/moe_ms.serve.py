"""MoE layers (`models/lfm2_moe.py`, spans `moe/route`, `moe/experts`,
`moe/combine`): device milliseconds of the operations launched under them,
per profiled generate."""
from bench_port.core.readers import scope_ms_per_generate


def read(r):
    return scope_ms_per_generate(r, "moe/")
