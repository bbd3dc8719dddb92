"""B-SHOT loop-closure detection and verification.

Port of `bshot_slam_tpu.backend.loop_closure`.  Candidate keyframe pairs
come from two channels: proximity (estimated positions close, temporally
far apart) and appearance (the centred, L2-normalised 352-bin bit
histograms of the keyframes' B-SHOTs, compared by cosine).  Each pair is
verified like an odometry frame: mutual-NN Hamming matching (kernel C,
keyframe against keyframe), RANSAC, then ICP (kernel D) on the keypoint
sets.  The verified measurement M satisfies p_b = M p_a, i.e.
M = T_b^-1 T_a: the pose-graph edge Z for edge (i=b, j=a).

RANSAC draws come from the caller, as in the odometry step: a
`torch.Generator`, or an iterator yielding one (H, 3) array of uniform
draws per verified pair (tests inject the reference's).

`find_loop_closures` computes the keyframe histograms once and verifies
each pair through `odometry.graphs` by default (`graphs=True`): on the
card one CUDA graph for the histograms of the whole store and one per
keypoint count, captured at the first pair and replayed for the rest, as
the reference compiles `keyframe_bow` and `_verify_pair` once; on the CPU
the same bodies run eagerly.  `graphs` may also be an engine's `Graphs`
(captured once per engine, or eager), or False (eager, for comparison).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from bshot_slam_tpu_torch.backend.keyframes import KeyframeStore
from bshot_slam_tpu_torch.config import SlamConfig
from bshot_slam_tpu_torch.geometry import se3
from bshot_slam_tpu_torch.ops import hamming
from bshot_slam_tpu_torch.ops.bshot import unpack_bits
from bshot_slam_tpu_torch.ops.icp import icp_point_to_point
from bshot_slam_tpu_torch.ops.ransac import ransac_rigid


class LoopEdge(NamedTuple):
    kf_i: int  # graph edge source (keyframe b)
    kf_j: int  # graph edge target (keyframe a)
    z: np.ndarray  # (4, 4) measured T_i^-1 T_j
    n_inliers: int
    rmse_mm: float  # ICP residual of the refined measurement


def _verify_pair(rng, kp_a, desc_a, mask_a, kp_b, desc_b, mask_b,
                 inlier_th: float, iterations: int, icp_iterations: int = 10):
    """(T (4, 4), n_inliers, icp rmse) of keyframe a against keyframe b:
    mutual NN (kernel C), RANSAC, and ICP (kernel D) refining the RANSAC
    pose on the keypoint sets."""
    m = hamming.mutual_nn(desc_a, mask_a, desc_b, mask_b)
    dst = kp_b[m.src_to_ref.long()]
    rr = ransac_rigid(rng, kp_a, dst, m.mutual, inlier_th, iterations)
    src_est = se3.apply(rr.transform, kp_a)
    icp = icp_point_to_point(src_est, mask_a & m.mutual, kp_b, mask_b,
                             iterations=icp_iterations, max_corr_dist=inlier_th)
    return icp.transform @ rr.transform, rr.n_inliers, icp.rmse


_BOW_CHUNK = 64  # keyframes unpacked at once: (64, 600, 352) floats


def keyframe_bow(store: KeyframeStore, n: int | None = None) -> torch.Tensor:
    """(n, 352) L2-normalised per-keyframe B-SHOT bit histograms of the
    first n keyframes (all Mk by default); empty keyframes give zeros.
    Each histogram is centred before normalising: every descriptor set
    shares a large mean bit frequency."""
    n = store.poses.shape[0] if n is None else n
    return bow_rows(store.descriptors[:n], store.kp_mask[:n])


def bow_rows(descriptors: torch.Tensor, kp_mask: torch.Tensor) -> torch.Tensor:
    """`keyframe_bow` of (n, K, 11) descriptors and their (n, K) mask, in
    chunks of _BOW_CHUNK rows; each row's reductions keep their shape, so
    a row's histogram does not depend on n."""
    n = descriptors.shape[0]
    out = []
    for c0 in range(0, n, _BOW_CHUNK):
        c1 = min(n, c0 + _BOW_CHUNK)
        bits = unpack_bits(descriptors[c0:c1]).to(torch.float32)
        mask = kp_mask[c0:c1]
        h = torch.sum(bits * mask[..., None], dim=1)  # (c, 352)
        cnt = torch.sum(mask, dim=1)
        hn = h / torch.clamp(cnt, min=1).to(torch.float32)[:, None]
        h = torch.where(cnt[:, None] > 0, hn - torch.mean(hn, dim=1, keepdim=True), h)
        out.append(h / torch.clamp(torch.linalg.norm(h, dim=1), min=1e-6)[:, None])
    if not out:
        return torch.zeros((0, 352), dtype=torch.float32, device=descriptors.device)
    return torch.cat(out)


def appearance_pairs(store: KeyframeStore, n: int, cfg: SlamConfig,
                     bow: torch.Tensor | None = None) -> np.ndarray:
    """Top descriptor-similarity keyframe pairs (i < j, gap-qualified),
    best first: the retrieval channel that survives unbounded drift.  `bow`:
    the store's histograms where the caller has them, else
    `keyframe_bow(store)` over the whole store, as the reference compiles
    them once for all Mk rows."""
    bcfg = cfg.backend
    bow = (keyframe_bow(store) if bow is None else bow)[:n].cpu().numpy()
    sim = bow @ bow.T  # cosine: rows are unit vectors
    gap = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    ok = np.triu(gap >= bcfg.lc_min_gap) & (sim >= bcfg.lc_appearance_min_sim)
    pairs = np.argwhere(ok)
    if len(pairs) == 0:
        return pairs.reshape(0, 2)
    order = np.argsort(-sim[pairs[:, 0], pairs[:, 1]])
    return pairs[order][: bcfg.lc_appearance_top]


def _pair_rng(rng, iterations: int, device) -> torch.Tensor:
    """The (H, 3) RANSAC draws for one pair on `device`: drawn from the
    generator (the numbers RANSAC would draw from it), or the next injected
    ones."""
    if isinstance(rng, torch.Generator):
        return torch.rand((iterations, 3), generator=rng, device=device)
    return torch.tensor(np.array(next(rng), np.float32), device=device)


def candidate_pairs(store: KeyframeStore, n: int, cfg: SlamConfig,
                    max_candidates: int = 8,
                    bow: torch.Tensor | None = None) -> np.ndarray:
    """(P, 2) keyframe pairs to verify: proximity (closest first, capped),
    then the appearance channel's pairs not already listed (`bow` as in
    `appearance_pairs`)."""
    bcfg = cfg.backend
    pos = store.poses[:n, :3, 3].cpu().numpy()
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    gap = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    pairs = np.argwhere(np.triu((d < bcfg.lc_max_dist_mm) & (gap >= bcfg.lc_min_gap)))
    if len(pairs):
        order = np.argsort(d[pairs[:, 0], pairs[:, 1]])
        pairs = pairs[order][:max_candidates]
    else:
        pairs = pairs.reshape(0, 2)
    seen = {tuple(p) for p in pairs.tolist()}
    extra = [p for p in appearance_pairs(store, n, cfg, bow).tolist()
             if tuple(p) not in seen]
    if extra:
        pairs = np.concatenate([pairs, np.asarray(extra)], axis=0)
    return pairs


def find_loop_closures(store: KeyframeStore, cfg: SlamConfig, rng,
                       max_candidates: int = 8, n: int | None = None,
                       stats: dict | None = None, graphs=True) -> List[LoopEdge]:
    """Detect and verify loop closures among the first n stored keyframes
    (`store.count` by default).  `stats`, when given, receives the number
    of pairs verified and the best candidate's inlier count.  `graphs`:
    True, an `odometry.graphs.Graphs` to replay from, or False (see the
    module docstring)."""
    n = int(store.count) if n is None else n
    if stats is not None:
        stats.update(verified=0, best_inliers=0)
    if n < 2:
        return []
    bcfg = cfg.backend
    dev = store.poses.device
    from bshot_slam_tpu_torch.odometry.graphs import Graphs  # imports this module

    if not isinstance(graphs, Graphs):
        graphs = Graphs(dev, eager=not graphs)
    pairs = candidate_pairs(store, n, cfg, max_candidates, graphs.bow(store))
    edges: List[LoopEdge] = []
    for a, b in pairs:
        T, n_inl, rmse = graphs.verify_pair(
            _pair_rng(rng, cfg.match.ransac_iterations, dev),
            store.keypoints[a], store.descriptors[a], store.kp_mask[a],
            store.keypoints[b], store.descriptors[b], store.kp_mask[b],
            cfg.match.ransac_inlier_th_mm, cfg.match.ransac_iterations,
            cfg.match.icp_iterations,
        )
        n_inl = int(n_inl)
        if stats is not None:
            stats["verified"] += 1
            stats["best_inliers"] = max(stats["best_inliers"], n_inl)
        if n_inl >= bcfg.lc_min_inliers:
            edges.append(LoopEdge(kf_i=int(b), kf_j=int(a),
                                  z=T.cpu().numpy(), n_inliers=n_inl,
                                  rmse_mm=float(rmse)))
    return edges
