"""The grouped expert GEMM (`ops/moe.py`, `csrc/moe_grouped_gemm.cu`): the
least time its profiled launches could take (the weights of the experts
each touches, its rows in and out, or its FLOPs, at the card's peaks) over
its device time."""
import re

KERNEL = re.compile(r"moe_grouped_gemm_kernel")


def read(r):
    if r.trace is None:
        return None
    t = r.trace.device_seconds(KERNEL)
    if t <= 0 or not r.counters.get("moe_gemm_bound_s"):
        return None
    return 100.0 * r.counters["moe_gemm_bound_s"] / t
