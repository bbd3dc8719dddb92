"""B-SHOT binarisation: SHOT-352 floats -> 352-bit binary descriptors.

Port of `bshot_slam_tpu.ops.bshot`.  Each group of 4 SHOT floats maps to
4 bits: the first subset (in the reference's priority order) whose sum
exceeds 0.9x the group sum has its bits set; an all-zero group gives 0000.

Packing: bit b of word w is descriptor bit 32w + b (LSB first), 11 words.
Words are carried as int32 tensors holding the uint32 bit pattern (torch
has no uint32 shifts on the CPU); convert at the numpy boundary with
`.view(np.uint32)` / `.view(np.int32)`.
"""

from __future__ import annotations

import torch

from bshot_slam_tpu_torch.config import DescriptorConfig

# Subset priority order: singles, pairs (01,12,23,03,13,02), triples, all.
_SUBSETS = (
    (1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1),
    (1, 1, 0, 0), (0, 1, 1, 0), (0, 0, 1, 1), (1, 0, 0, 1),
    (0, 1, 0, 1), (1, 0, 1, 0),
    (1, 1, 1, 0), (0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 0, 1),
    (1, 1, 1, 1),
)


_SUBSETS_ON: dict = {}


def _subsets(device: torch.device) -> torch.Tensor:
    """The (15, 4) subset table on `device`, copied there once (a host copy
    per frame would synchronise)."""
    t = _SUBSETS_ON.get(device)
    if t is None:
        t = _SUBSETS_ON[device] = torch.tensor(_SUBSETS, dtype=torch.float32,
                                               device=device)
    return t


def binarize(shot: torch.Tensor, threshold: float = 0.9) -> torch.Tensor:
    """(..., 352) SHOT floats -> (..., 352) {0,1} uint8 bits."""
    batch = shot.shape[:-1]
    groups = shot.reshape(batch + (88, 4)).to(torch.float32)
    total = torch.sum(groups, dim=-1)
    thr = threshold * total
    subsets = _subsets(shot.device)
    sums = groups @ subsets.T  # (..., 88, 15)
    cond = sums > thr[..., None]
    cond[..., -1] = True  # the all-ones fallback always fires
    first = torch.argmax(cond.to(torch.uint8), dim=-1)  # first true
    bits = subsets.to(torch.uint8)[first]  # (..., 88, 4)
    all_zero = torch.all(groups == 0, dim=-1)
    bits = torch.where(all_zero[..., None], 0, bits).to(torch.uint8)
    return bits.reshape(batch + (352,))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 352) {0,1} -> (..., 11) int32 words (uint32 bit patterns)."""
    batch = bits.shape[:-1]
    words = bits.reshape(batch + (11, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    w = torch.sum(words << shifts, dim=-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., 11) int32 words -> (..., 352) uint8 bits."""
    batch = words.shape[:-1]
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1  # exact under sign extension
    return bits.reshape(batch + (352,)).to(torch.uint8)


def bshot_from_shot(shot: torch.Tensor, cfg: DescriptorConfig) -> torch.Tensor:
    """SHOT floats -> packed (..., 11) int32 B-SHOT descriptors."""
    return pack_bits(binarize(shot, cfg.bshot_threshold))
