"""Runtime (`qwen3_runtime.py`, scope `qwen3/prefill`): device milliseconds
of the operations launched under the scope, per profiled generate."""
from bench_port.core.readers import scope_ms_per_generate


def read(r):
    return scope_ms_per_generate(r, "qwen3/prefill")
