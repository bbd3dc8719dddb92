"""Evaluation metrics: ATE RMSE, ground-removal accuracy, repeatability.

The reference computes none of these programmatically end to end — accuracy
prints in pointcloud_preprocessing.cpp:280-286, repeatability in
lidar_odometry.cpp:392-445, and trajectory comparison by eye against a
loaded overlay (odometry_test.cpp:257-263).  This module makes them first-
class numbers the benchmark and tests can assert on.
"""

from __future__ import annotations

import numpy as np


def ate_rmse(estimate: np.ndarray, reference: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error RMSE (mm) between (n, 3) position tracks.

    With align=True the estimate is first rigidly aligned to the reference
    (Umeyama without scale), the standard ATE protocol.
    """
    est = np.asarray(estimate, np.float64)
    ref = np.asarray(reference, np.float64)
    n = min(len(est), len(ref))
    est, ref = est[:n], ref[:n]
    if n == 0:
        return float("nan")
    if align and n >= 3:
        mu_e = est.mean(0)
        mu_r = ref.mean(0)
        H = (ref - mu_r).T @ (est - mu_e)
        U, _, Vt = np.linalg.svd(H)
        D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
        R = U @ D @ Vt
        est = (R @ (est - mu_e).T).T + mu_r
    return float(np.sqrt(((est - ref) ** 2).sum(axis=1).mean()))


def ground_accuracy(classes: np.ndarray, valid: np.ndarray,
                    keep_truth: np.ndarray) -> float:
    """Reference's preprocessing 'Accuracy' = kept-correct / labeled-keep
    (reference: pointcloud_preprocessing.cpp:280-286 semantics: fraction of
    labeled keep points that survive as class 0)."""
    m = np.asarray(valid) & np.asarray(keep_truth)
    if m.sum() == 0:
        return float("nan")
    return float((np.asarray(classes)[m] == 0).mean())


def relative_pose_errors(est_poses: np.ndarray, ref_poses: np.ndarray):
    """Per-step (rotation deg, translation mm) errors of consecutive deltas."""
    est = np.asarray(est_poses)
    ref = np.asarray(ref_poses)
    n = min(len(est), len(ref))
    rot, trans = [], []
    for i in range(1, n):
        de = np.linalg.inv(est[i - 1]) @ est[i]
        dr = np.linalg.inv(ref[i - 1]) @ ref[i]
        err = np.linalg.inv(dr) @ de
        c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        rot.append(np.degrees(np.arccos(c)))
        trans.append(np.linalg.norm(err[:3, 3]))
    return np.asarray(rot), np.asarray(trans)
