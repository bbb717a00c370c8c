"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """Return the torch device an entry point runs on.

    The default is CUDA. Asking for CUDA on a machine without a card
    raises: the port never falls back to the CPU unless the caller passes
    `"cpu"` (as the CPU tests do).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
