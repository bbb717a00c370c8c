"""Conv layers (`models/lfm2_moe.py`, spans `conv/layer` and `conv/state`,
and the runtime's `conv/state` around their state writes): device
milliseconds of the operations launched under them, per profiled
generate."""
from bench_port.core.readers import scope_ms_per_generate


def read(r):
    return scope_ms_per_generate(r, "conv/")
