"""Whole generate: the model FLOPs of the valid work of the profiled
generates over the profiled window's wall time, as a share of the card's
dense bf16 peak."""
from bench_port.core.readers import mfu as read  # noqa: F401
