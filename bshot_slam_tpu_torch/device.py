"""Where the port's state lives: the card unless the caller asks otherwise."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the card; raises when CUDA is asked for but not visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`.  To the card it goes through pinned memory
    with a non-blocking copy, so the host does not wait for the queued
    device work (a plain copy from pageable memory synchronises)."""
    t = torch.from_numpy(np.require(a, requirements=("C", "W")))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
