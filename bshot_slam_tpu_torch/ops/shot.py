"""SHOT-352 local descriptors.

Port of `bshot_slam_tpu.ops.shot`: per keypoint, its `max_neighbors`
nearest in-radius surface points; a local reference frame from their
distance-weighted covariance (signs toward the neighbour majority); then
8 azimuth x 2 elevation x 2 radial volumes x 11 normal-cosine bins with
multilinear soft binning, L2-normalised.  Neighbour selection is exact,
ties to the lowest index.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bshot_slam_tpu_torch.config import DescriptorConfig
from bshot_slam_tpu_torch.kernels.eig3 import eigh3
from bshot_slam_tpu_torch.kernels.neighborhood import shot_neighbors
from bshot_slam_tpu_torch.ops.keypoints import fma_dot3

_EPS = 1e-12


class NeighborGather(NamedTuple):
    rel: torch.Tensor  # (K, M, 3) neighbor - keypoint
    normals: torch.Tensor  # (K, M, 3)
    dist: torch.Tensor  # (K, M)
    nmask: torch.Tensor  # (K, M) within-radius validity


def gather_neighbors(
    keypoints: torch.Tensor,
    kp_mask: torch.Tensor,
    points: torch.Tensor,
    mask: torch.Tensor,
    normals: torch.Tensor,
    radius: float,
    max_neighbors: int,
) -> NeighborGather:
    """Nearest `max_neighbors` in-radius surface points per keypoint;
    zero-distance duplicates of the keypoint are excluded.  The selection
    is kernel H (`kernels.neighborhood.shot_neighbors`)."""
    idx = shot_neighbors(keypoints, kp_mask, points, mask, radius, max_neighbors)
    r2 = radius * radius
    pnv = torch.cat([points, normals, mask.to(torch.float32)[:, None]], dim=1)
    g = pnv[idx]  # (K, M, 7)
    nb, nn, vbit = g[..., :3], g[..., 3:6], g[..., 6]
    rel = nb - keypoints[:, None, :]
    d2g = fma_dot3(rel, rel)
    nmask = (vbit > 0) & (d2g <= r2) & (d2g > 0) & kp_mask[:, None]
    dist = torch.sqrt(d2g)
    rel = torch.where(nmask[..., None], rel, 0.0)
    nn = torch.where(nmask[..., None], nn, 0.0)
    return NeighborGather(rel=rel, normals=nn,
                          dist=torch.where(nmask, dist, 0.0), nmask=nmask)


def lrf_covariances(g: NeighborGather, radius: float):
    """(distance-weighted neighbour covariances (K, 3, 3), valid (K,)): the
    weights fall linearly to 0 at `radius`."""
    w = torch.where(g.nmask, radius - g.dist, 0.0)
    wsum = torch.sum(w, dim=1)
    wn = w / torch.clamp(wsum, min=_EPS)[:, None]
    return torch.einsum("km,kmi,kmj->kij", wn, g.rel, g.rel), wsum > _EPS


def local_reference_frames(g: NeighborGather, radius: float):
    """Disambiguated LRF per keypoint: (frames (K, 3, 3) rows [x, y, z],
    valid (K,)).  The eigen-solve is kernel I on the card."""
    cov, valid = lrf_covariances(g, radius)
    _, evecs = eigh3(cov)  # ascending
    x_axis = evecs[..., 2]
    z_axis = evecs[..., 0]

    def majority_flip(axis):
        dots = torch.einsum("kmi,ki->km", g.rel, axis)
        npos = torch.sum(torch.where(g.nmask, (dots >= 0).to(torch.float32), 0.0), dim=1)
        nneg = torch.sum(torch.where(g.nmask, (dots < 0).to(torch.float32), 0.0), dim=1)
        return torch.where((nneg > npos)[:, None], -axis, axis)

    x_axis = majority_flip(x_axis)
    z_axis = majority_flip(z_axis)
    y_axis = torch.linalg.cross(z_axis, x_axis)
    frames = torch.stack([x_axis, y_axis, z_axis], dim=-2)  # rows
    return frames, valid


def _soft_bins(coord: torch.Tensor, n_bins: int, circular: bool):
    """Linear soft assignment of a bin coordinate in [0, n_bins): returns
    (bin_lo, bin_hi, w_lo, w_hi); centres at i + 0.5."""
    c = coord - 0.5
    lo = torch.floor(c)
    frac = c - lo
    lo_i = lo.to(torch.int32)
    hi_i = lo_i + 1
    if circular:
        lo_i = torch.remainder(lo_i, n_bins)
        hi_i = torch.remainder(hi_i, n_bins)
    else:
        lo_i = torch.clamp(lo_i, 0, n_bins - 1)
        hi_i = torch.clamp(hi_i, 0, n_bins - 1)
    return lo_i, hi_i, 1.0 - frac, frac


def shot_descriptors(
    keypoints: torch.Tensor,
    kp_mask: torch.Tensor,
    points: torch.Tensor,
    mask: torch.Tensor,
    normals: torch.Tensor,
    cfg: DescriptorConfig,
):
    """SHOT descriptors: (desc (K, 352) f32 L2-normalised, valid (K,))."""
    radius = cfg.shot_radius_mm
    g = gather_neighbors(keypoints, kp_mask, points, mask, normals, radius,
                         cfg.max_neighbors)
    frames, lrf_valid = local_reference_frames(g, radius)

    local = torch.einsum("kai,kmi->kma", frames, g.rel)  # (K, M, 3)
    xl, yl, zl = local[..., 0], local[..., 1], local[..., 2]
    d = g.dist
    nA, nE, nR, nC = (cfg.n_azimuth_bins, cfg.n_elevation_bins,
                      cfg.n_radial_bins, cfg.n_cosine_bins)

    az = torch.atan2(yl, xl)
    az = torch.where(az < 0, az + 2.0 * math.pi, az)
    az_coord = az / (2.0 * math.pi) * nA
    a_lo, a_hi, aw_lo, aw_hi = _soft_bins(az_coord, nA, circular=True)

    el_coord = torch.clamp(zl / max(radius, _EPS) + 1.0, 0.0, 2.0 - 1e-6) / 2.0 * nE
    e_lo, e_hi, ew_lo, ew_hi = _soft_bins(el_coord, nE, circular=False)

    r_coord = torch.clamp(d / radius, 0.0, 1.0 - 1e-6) * nR
    r_lo, r_hi, rw_lo, rw_hi = _soft_bins(r_coord, nR, circular=False)

    cosine = torch.einsum("kmi,ki->km", g.normals, frames[:, 2, :])
    cosine = torch.clamp(cosine, -1.0, 1.0)
    c_coord = (cosine + 1.0) / 2.0 * nC
    c_coord = torch.clamp(c_coord, max=nC - 1e-6)
    c_lo, c_hi, cw_lo, cw_hi = _soft_bins(c_coord, nC, circular=False)

    wgt = g.nmask.to(torch.float32)
    # The 16-corner quadrilinear weight factorises into (spatial trilinear)
    # x (cosine linear): desc[k,v,c] = sum_m vol_w[k,m,v] * cos_w[k,m,c].
    nV = nA * nE * nR
    K, M = g.nmask.shape
    dev = keypoints.device
    v_iota = torch.arange(nV, dtype=torch.int32, device=dev)
    c_iota = torch.arange(nC, dtype=torch.int32, device=dev)
    vol_w = torch.zeros((K, M, nV), dtype=torch.float32, device=dev)
    for a_i, a_w in ((a_lo, aw_lo), (a_hi, aw_hi)):
        for e_i, e_w in ((e_lo, ew_lo), (e_hi, ew_hi)):
            for r_i, r_w in ((r_lo, rw_lo), (r_hi, rw_hi)):
                vol = (a_i * nE + e_i) * nR + r_i  # (K, M)
                w = wgt * a_w * e_w * r_w
                vol_w = vol_w + w[..., None] * (vol[..., None] == v_iota).to(torch.float32)
    cos_w = cw_lo[..., None] * (c_lo[..., None] == c_iota).to(torch.float32)
    cos_w = cos_w + cw_hi[..., None] * (c_hi[..., None] == c_iota).to(torch.float32)
    desc = torch.einsum("kmv,kmc->kvc", vol_w, cos_w).reshape(K, nV * nC)

    norm = torch.linalg.norm(desc, dim=-1, keepdim=True)
    desc = desc / torch.clamp(norm, min=_EPS)
    valid = kp_mask & lrf_valid & (norm[:, 0] > _EPS)
    return torch.where(valid[:, None], desc, 0.0), valid
