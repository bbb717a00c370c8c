"""Runtime (`qwen3_runtime.py`, scopes `qwen3/decode_*`): device
milliseconds of the operations launched under the decode steps' scopes,
per profiled generate."""
from bench_port.core.readers import scope_ms_per_generate


def read(r):
    return scope_ms_per_generate(r, "qwen3/decode_")
