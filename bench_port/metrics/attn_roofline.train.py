"""Kernels K1, K2, K3 (`ops/hstu_attention.py`): the least time their
launches in the profiled steps could take (their bytes and FLOPs on this
data's valid pairs, at the card's peaks) over their device time."""
import re

# the bias-free instances of the forward, dq and dk/dv kernels, mangled or
# demangled
K123 = re.compile(r"(fwd_wgmma_kernel(ILi\d+ELb0ELb0E|<\d+, false, false>)"
                  r"|dq_wgmma_kernel(ILi\d+ELb0E|<\d+, false>)"
                  r"|dkv_wgmma_kernel(ILi\d+ELb0E|<\d+, false>))")


def read(r):
    if r.trace is None:
        return None
    t = r.trace.device_seconds(K123)
    if t <= 0 or not r.counters.get("attn_bound_s"):
        return None
    return 100.0 * r.counters["attn_bound_s"] / t
