"""What a driver gets and gives back."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from bench_port.core.trace import Trace


@dataclasses.dataclass
class RunContext:
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = dataclasses.field(default_factory=time.perf_counter)  # process start


@dataclasses.dataclass
class Reading:
    """What the per-layer readers read: spans (ms per call, by name),
    counters, the profiled window's trace and the card's peaks."""
    spans: Dict[str, List[float]]
    counters: Dict[str, float]
    trace: Optional[Trace]
    peaks: Dict[str, float]


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: Dict[str, float]           # end-to-end values (untraced run)
    compared: Dict[str, float]          # the numbers the comparison reads
    memory_peak_bytes: int
    reading: Optional[Reading] = None   # traced run


def sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def free(device) -> None:
    import gc

    import torch

    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    """The peak on the fullest card."""
    import torch

    if not str(device).startswith("cuda"):
        return 0
    return max(int(torch.cuda.max_memory_allocated(i)) for i in range(torch.cuda.device_count()))
