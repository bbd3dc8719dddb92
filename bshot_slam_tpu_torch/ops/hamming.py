"""Hamming-distance matching of packed B-SHOT descriptors.

Port of `bshot_slam_tpu.ops.hamming`.  Mutual-nearest-neighbour
correspondences with the reference's strict-< first-minimum scans (ties to
the lowest index), on kernel C (`kernels.mapops.hamming_nn_bounded`) on the
card and its plain XOR-popcount version on the CPU, where `mutual_nn` can
also take the distances as a product of unpacked bits (`matmul_distances`,
the reference's MXU form).  Every path gives the kernel-path outputs:
`distances` is the best distance on mutual rows and 2^30 elsewhere.
`mutual_nn_sharded` matches against a map sharded along a mesh axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bshot_slam_tpu_torch.kernels import BIG, on_cpu
from bshot_slam_tpu_torch.kernels.mapops import (  # noqa: F401  (re-export)
    hamming_nn_bounded, popcount_distances,
)
from bshot_slam_tpu_torch.ops.bshot import unpack_bits
from bshot_slam_tpu_torch.parallel import layout
from bshot_slam_tpu_torch.parallel.comm import Axis

_BIG = 2**30


class MutualMatches(NamedTuple):
    src_to_ref: torch.Tensor  # (Na,) best ref index per src
    distances: torch.Tensor  # (Na,) Hamming distance on mutual rows, else 2^30
    mutual: torch.Tensor  # (Na,) True where the pair is a mutual NN


def mutual_nn_bounded(
    a_words: torch.Tensor,
    a_mask: torch.Tensor,
    b_words: torch.Tensor,
    b_mask: torch.Tensor,
    n_valid_b,
    tail_start: int = -1,
) -> MutualMatches:
    """Mutual-NN correspondences with candidates bounded to the live rows
    [0, n_valid_b) plus the tail [tail_start, end)."""
    amin, aarg, _, barg = hamming_nn_bounded(
        a_words, a_mask, b_words, b_mask, n_valid_b, tail_start=tail_start
    )
    return _mutual(amin, aarg, barg, a_mask)


def mutual_nn_sharded(a_words, a_mask, b_words, b_mask, b_pos, n_valid_b,
                      tail_start: int, axis: Axis):
    """`mutual_nn_bounded` against candidates whose map rows are sharded
    cyclically along `axis`: this rank's rows [0, tail_start) (live up to
    `n_valid_b`) and the tail every rank holds.  Kernel C scores the local
    candidates; one MIN of packed keys gives each source its best global
    candidate, ties to the lowest global index; the owner of that row holds
    the row's own best source (the sources are on every rank), so it makes
    the mutual test and sends the row's position, in one SUM.  Returns
    (MutualMatches with global indices, (Na, 3) positions of the matched
    candidates from `b_pos`), bit for bit the single-device results."""
    amin, aarg, _, barg = hamming_nn_bounded(a_words, a_mask, b_words, b_mask,
                                             n_valid_b, tail_start=tail_start)
    g = layout.global_index(aarg, tail_start, axis)
    amin, g = layout.argmin_combine(amin, g, axis, "C: key min")
    ar = torch.arange(g.shape[0], dtype=torch.int32, device=g.device)
    mine, local = layout.owner(g, tail_start, axis)
    vals = torch.cat([b_pos[local].view(torch.int32),
                      (barg[local] == ar).to(torch.int32)[:, None]], dim=1)
    got = layout.sum_from_owners(vals, mine, axis, "C: owner rows")
    tail = g >= tail_start * axis.size
    t = torch.clamp(g - tail_start * axis.size + tail_start, tail_start,
                    b_pos.shape[0] - 1)
    pos = torch.where(tail[:, None], b_pos[t], got[:, :3].view(torch.float32))
    back = torch.where(tail, barg[t] == ar, got[:, 3] > 0)
    mutual = back & a_mask & (amin < 1e30)
    return MutualMatches(
        src_to_ref=g.to(torch.int32),
        distances=torch.where(mutual, amin, float(_BIG)).to(torch.int32),
        mutual=mutual,
    ), pos


def _mutual(amin, aarg, barg, a_mask) -> MutualMatches:
    ar = torch.arange(aarg.shape[0], dtype=torch.int32, device=aarg.device)
    mutual = (barg[aarg.long()] == ar) & a_mask & (amin < 1e30)
    return MutualMatches(
        src_to_ref=aarg,
        distances=torch.where(mutual, amin, float(_BIG)).to(torch.int32),
        mutual=mutual,
    )


def matmul_distances(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """(Na, 352) x (Nb, 352) {0,1} bits -> (Na, Nb) int32 Hamming distances
    as popcount(a) + popcount(b) - 2 a.b, the cross term one float32
    product (exact: every sum is at most 352; TF32 is off, `_precision`)."""
    cross = a_bits.to(torch.float32) @ b_bits.to(torch.float32).T
    pa = torch.sum(a_bits.to(torch.int32), dim=-1)
    pb = torch.sum(b_bits.to(torch.int32), dim=-1)
    return (pa[:, None] + pb[None, :] - 2.0 * cross).to(torch.int32)


def mutual_nn(a_words, a_mask, b_words, b_mask,
              use_matmul: bool = True) -> MutualMatches:
    """Mutual-NN correspondences over every candidate row.  On the CPU
    `use_matmul` takes the distances as `matmul_distances` of the unpacked
    bits, else as kernel C's plain XOR-popcount; both are exact, so the
    matches are the same.  On the card the call goes through kernel C."""
    if not (use_matmul and on_cpu(a_words, b_words)
            and a_words.shape[0] and b_words.shape[0]):
        return mutual_nn_bounded(a_words, a_mask, b_words, b_mask,
                                 b_words.shape[0])
    d = matmul_distances(unpack_bits(a_words), unpack_bits(b_words))
    d = torch.where(a_mask[:, None] & b_mask[None, :], d.to(torch.float32), BIG)
    aarg = torch.argmin(d, dim=1)  # first (lowest-index) minimum
    amin = torch.gather(d, 1, aarg[:, None])[:, 0]
    barg = torch.argmin(d, dim=0).to(torch.int32)
    return _mutual(amin, aarg.to(torch.int32), barg, a_mask)
