"""Kernel K7 (`ops/beam_decode_attention.py`): the least time its profiled
launches could take (the bytes each call must move and its FLOPs, at the
card's peaks) over its device time."""
import re

K7 = re.compile(r"beam_wgmma_kernel")


def read(r):
    if r.trace is None:
        return None
    t = r.trace.device_seconds(K7)
    if t <= 0 or not r.counters.get("k7_bound_s"):
        return None
    return 100.0 * r.counters["k7_bound_s"] / t
