"""Hamming-distance matching of packed B-SHOT descriptors.

Port of `bshot_slam_tpu.ops.hamming`.  Mutual-nearest-neighbour
correspondences with the reference's strict-< first-minimum scans (ties to
the lowest index), on kernel C (`kernels.mapops.hamming_nn_bounded`) on the
card and its plain XOR-popcount version on the CPU.  Both paths give the
kernel-path outputs: `distances` is the best distance on mutual rows and
2^30 elsewhere.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bshot_slam_tpu_torch.kernels.mapops import (  # noqa: F401  (re-export)
    hamming_nn_bounded, popcount_distances,
)

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
    ar = torch.arange(a_words.shape[0], dtype=torch.int32, device=a_words.device)
    mutual = (barg[aarg.long()] == ar) & a_mask & (amin < 1e30)
    return MutualMatches(
        src_to_ref=aarg,
        distances=torch.where(mutual, amin, float(_BIG)).to(torch.int32),
        mutual=mutual,
    )


def mutual_nn(a_words, a_mask, b_words, b_mask) -> MutualMatches:
    """Mutual-NN correspondences over every candidate row."""
    return mutual_nn_bounded(a_words, a_mask, b_words, b_mask, b_words.shape[0])
