"""Where the port's state lives: the card unless the caller asks otherwise,
and what the card can do (its peak rates, its name and power limit)."""

from __future__ import annotations

import dataclasses
import subprocess
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Peaks:
    """A card's peak rates: `lanes` is instructions per SM per clock by
    class; an SM dispatches at most `dispatch_lanes` over all classes."""

    sms: int
    clock_hz: float
    lanes: dict
    dispatch_lanes: int
    bytes_per_s: float

    @property
    def lanes_per_s(self) -> float:
        """SM clocks per second over the card: lanes x this = a class's rate."""
        return self.sms * self.clock_hz

    @property
    def f32_rate(self) -> float:
        """f32 instructions per second on the CUDA cores (an FMA is one; the
        port's coordinate math runs in true f32, so no tensor-core rate)."""
        return self.lanes["f32"] * self.lanes_per_s

    def bound_ms(self, nbytes: float, ops: dict) -> tuple:
        """(least ms for the work, "bytes" or "operations"): `nbytes` moved
        at the memory rate, or `ops` (instructions, one per lane, by class)
        each class at its own rate and all of them at the dispatch rate,
        whichever takes longer."""
        t_bytes = nbytes / self.bytes_per_s * 1e3
        t_ops = max([n / (self.lanes[c] * self.lanes_per_s) for c, n in ops.items()]
                    + [sum(ops.values()) / (self.dispatch_lanes * self.lanes_per_s)]) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# H100 SXM: 132 SMs at the 1.98 GHz boost clock, 3.35 TB/s of HBM3.  Lanes
# per SM per clock by instruction class (compute capability 9.0): f32 add,
# multiply, FMA and compare 128 (67 TFLOP/s with an FMA as 2 flops); 32-bit
# integer add, compare and logic 64; popc 16.  An SM dispatches at most 128
# lanes per clock over all classes.
H100 = Peaks(sms=132, clock_hz=1.98e9, lanes={"f32": 128, "int": 64, "popc": 16},
             dispatch_lanes=128, bytes_per_s=3.35e12)
# Cards whose peaks are known, by a part of `torch.cuda.get_device_name`.
CARDS = {"H100 80GB HBM3": H100, "H100 SXM": H100}


def card_peaks(name: str) -> Optional[Peaks]:
    """The peaks of the card called `name`, or None for a card not in CARDS."""
    return next((p for key, p in CARDS.items() if key in name), None)


def card_line() -> str:
    """The first card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def card(device) -> dict:
    """{"device": the card's name, "power_limit": its limit} for a CUDA
    device, {"device": "cpu", "power_limit": None} otherwise."""
    if torch.device(device).type != "cuda":
        return {"device": "cpu", "power_limit": None}
    name, limit = (s.strip() for s in card_line().split(",", 1))
    return {"device": name, "power_limit": limit}


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
