"""Map rows placed before the window, far outside the drive's query window.

`bench_torch._prefilled_map`'s recipe, drawn on the device from the run's
seed instead of numpy's generator: positions uniform in [1.9e6, 2.1e6) mm
on each axis snapped down to the map's grid, random 352-bit descriptors,
seg ratios uniform in [0, 1), voxel blocks of the snapped positions.  So
matching and dedup pay for a map of that many live rows every frame while
the drive's own rows decide the poses.
"""

from __future__ import annotations

import torch


def prefill_rows(n: int, snap_mm: float, block_mm: float, n_words: int,
                 generator: torch.Generator, device) -> dict:
    """The rows as tensors on `device`: positions (n, 3) float32,
    descriptors (n, n_words) int32, seg_ratios (n,) float32, blocks (n, 3)
    int32."""
    f32 = torch.float32
    pos = 1.9e6 + 2e5 * torch.rand((n, 3), generator=generator, dtype=f32,
                                   device=device)
    pos = torch.trunc(pos / snap_mm) * snap_mm
    words = torch.randint(-2**31, 2**31, (n, n_words), generator=generator,
                          dtype=torch.int64, device=device).to(torch.int32)
    seg = torch.rand((n,), generator=generator, dtype=f32, device=device)
    blocks = torch.round(pos / block_mm).to(torch.int32)
    return {"positions": pos, "descriptors": words, "seg_ratios": seg,
            "blocks": blocks}
