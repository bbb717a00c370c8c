"""Whole train step: the model FLOPs of the profiled steps (the reference's
accounting) over the profiled window's wall time, as a share of the card's
dense bf16 peak."""
from bench_port.core.readers import mfu as read  # noqa: F401
