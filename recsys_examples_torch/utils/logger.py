"""Logging helpers (counterpart of recsys_examples_tpu/utils/logger.py)."""
from __future__ import annotations

import logging
import sys
import time
from typing import Optional, Union

import torch

_logger = None


def get_logger():
    global _logger
    if _logger is None:
        _logger = logging.getLogger("recsys_examples_torch")
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(
            logging.Formatter("[%(asctime)s %(levelname)s] %(message)s")
        )
        _logger.addHandler(h)
        _logger.setLevel(logging.INFO)
        _logger.propagate = False
    return _logger


def print_rank_0(msg: str):
    """Log `msg` on rank 0 (every process is rank 0 without torch.distributed)."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0:
        get_logger().info(msg)


class StepTimer:
    """Wall-clock step timer with EMA. On a CUDA device `stop` first waits
    for the device, so it times a step that has finished there, not its
    enqueue."""

    def __init__(self, alpha: float = 0.1,
                 device: Optional[Union[str, torch.device]] = None):
        self.alpha = alpha
        self.device = torch.device(device) if device is not None else None
        self.ema = None
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self._t0
        self.ema = dt if self.ema is None else (
            self.alpha * dt + (1 - self.alpha) * self.ema
        )
        return dt
