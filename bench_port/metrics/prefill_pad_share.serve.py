"""Serving engine (`Qwen3ServingEngine.generate`, counters
`serve/prefill_tokens` and `serve/prefill_valid_tokens`): the share of the
prefill's token slots (batch bucket x context bucket) that hold no
request's token, over the profiled generates."""
from bench_port.core.attribution import program_snapshot


def read(r):
    c = (program_snapshot() or {}).get("counters", {})
    total, valid = c.get("serve/prefill_tokens"), c.get("serve/prefill_valid_tokens")
    if not total or valid is None:
        return None
    return 100.0 * (1.0 - valid / total)
