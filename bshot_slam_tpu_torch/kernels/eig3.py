"""The closed-form 3x3 symmetric eigendecomposition: CUDA kernel I and its
plain version.

I, `eigh3`, replaces no Pallas kernel: it is `geometry/eig3.py:eigh3`
(the port of bshot_slam_tpu/geometry/eig3.py), which the plain path runs
as ~645 elementwise PyTorch operations, one launch each.  The step calls
it twice a frame: on the normals' covariances of every cloud row
(`ops/normals.normals_from_moments`) and on the keypoints' LRF
covariances (`ops/shot.local_reference_frames`).

The CUDA side (csrc/eig3.cu) is one launch per call, one thread per
matrix: the whole solve in registers, every step with the _rn intrinsics
in the plain version's order, so its outputs equal the plain version's on
the same CUDA tensors bit for bit.  `eigh3_plain` is
`geometry.eig3.eigh3`, which stays the plain version (and `eigvalsh3`
stays there, plain).  Bytes per matrix, each read or written once, are
`EIG3_BYTES`.
"""

from __future__ import annotations

import torch

from bshot_slam_tpu_torch.geometry.eig3 import eigh3 as eigh3_plain
from bshot_slam_tpu_torch.kernels import _build, on_cpu, ptr, stream_arg

# 9 floats in, 3 eigenvalues and 9 eigenvector entries out.
EIG3_BYTES = 4 * (9 + 3 + 9)


def eigh3(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues ascending (..., 3), eigenvectors (..., 3, 3) columns)
    of symmetric (..., 3, 3) float32 matrices: evecs[..., :, i] pairs
    evals[..., i].  Reads the upper triangle's six components."""
    if on_cpu(A):
        return eigh3_plain(A)
    if A.dtype != torch.float32:
        raise TypeError(f"A must be torch.float32, got {A.dtype}")
    if A.dim() < 2 or tuple(A.shape[-2:]) != (3, 3):
        raise ValueError(f"A must have shape (..., 3, 3), got {tuple(A.shape)}")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    batch = A.shape[:-2]
    evals = torch.empty((*batch, 3), dtype=torch.float32, device=A.device)
    evecs = torch.empty((*batch, 3, 3), dtype=torch.float32, device=A.device)
    n = A.numel() // 9
    if n == 0:  # nothing to launch
        return evals, evecs
    P = _build.P
    fn = _build.bind("eig3", "bshot_eigh3", [P, _build.I, P, P, P])
    _build.check(fn(ptr(A), n, ptr(evals), ptr(evecs), stream_arg(A.device)),
                 "eigh3")
    eigh3.launches += 1
    return evals, evecs


eigh3.launches = 0
