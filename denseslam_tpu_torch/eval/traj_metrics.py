"""Trajectory metrics: ATE, RPE, and KITTI rotation/translation errors
(a copy of denseslam_tpu/eval/traj_metrics.py, which uses numpy only; the
port keeps its own so that it imports nothing of the JAX package).

KITTI error definitions mirror the reference's in-code helpers
(reference: src/DenseSLAM/Utils.h:251-265 — rotation error
acos(0.5(tr(R)-1)), translation error ||t||); ATE/RPE follow the TUM
benchmark definitions used to score the dumped trajectories (SURVEY.md
section 4.3).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def kitti_rotation_error(T_rel: np.ndarray) -> float:
    """acos((trace(R)-1)/2) of a relative pose (Utils.h:251-258)."""
    tr = np.trace(T_rel[:3, :3])
    return float(np.arccos(np.clip(0.5 * (tr - 1.0), -1.0, 1.0)))


def kitti_translation_error(T_rel: np.ndarray) -> float:
    """||t|| of a relative pose (Utils.h:260-265)."""
    return float(np.linalg.norm(T_rel[:3, 3]))


def _umeyama_align(src: np.ndarray, dst: np.ndarray,
                   with_scale: bool = False) -> np.ndarray:
    """Rigid (optionally similarity) alignment dst ~= s R src + t -> 4x4."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    if with_scale:
        var = (sc ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(S) @ D) / var)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    T = np.eye(4)
    T[:3, :3] = s * R
    T[:3, 3] = t
    return T


def ate_rmse(est: Sequence[np.ndarray], gt: Sequence[np.ndarray],
             align: bool = True) -> float:
    """Absolute trajectory error (RMSE of aligned positions), meters."""
    p_est = np.stack([np.asarray(T)[:3, 3] for T in est])
    p_gt = np.stack([np.asarray(T)[:3, 3] for T in gt])
    if align and len(est) >= 3:
        A = _umeyama_align(p_est, p_gt)
        p_est = p_est @ A[:3, :3].T + A[:3, 3]
    return float(np.sqrt(((p_est - p_gt) ** 2).sum(axis=1).mean()))


def rpe(est: Sequence[np.ndarray], gt: Sequence[np.ndarray],
        delta: int = 1) -> Dict[str, float]:
    """Relative pose error over frame gaps of `delta`."""
    t_errs, r_errs = [], []
    for i in range(len(est) - delta):
        Te = np.linalg.inv(np.asarray(est[i])) @ np.asarray(est[i + delta])
        Tg = np.linalg.inv(np.asarray(gt[i])) @ np.asarray(gt[i + delta])
        E = np.linalg.inv(Tg) @ Te
        t_errs.append(kitti_translation_error(E))
        r_errs.append(kitti_rotation_error(E))
    return dict(
        rpe_trans_rmse=float(np.sqrt(np.mean(np.square(t_errs)))) if t_errs else 0.0,
        rpe_rot_rmse=float(np.sqrt(np.mean(np.square(r_errs)))) if r_errs else 0.0,
    )


def kitti_sequence_errors(est: Sequence[np.ndarray], gt: Sequence[np.ndarray],
                          lengths=(100, 200, 300, 400, 500, 600, 700, 800),
                          step: int = 10) -> Dict[str, float]:
    """KITTI odometry benchmark protocol: average t/r error over subsequences
    of fixed path lengths, as %, deg/m."""
    gt_pos = np.stack([np.asarray(T)[:3, 3] for T in gt])
    dists = np.concatenate([[0.0], np.cumsum(
        np.linalg.norm(np.diff(gt_pos, axis=0), axis=1))])

    def frame_at_dist(start, length):
        target = dists[start] + length
        idx = np.searchsorted(dists, target)
        return idx if idx < len(dists) else -1

    t_errs, r_errs = [], []
    for first in range(0, len(est), step):
        for L in lengths:
            last = frame_at_dist(first, L)
            if last < 0:
                continue
            Tg = np.linalg.inv(np.asarray(gt[first])) @ np.asarray(gt[last])
            Te = np.linalg.inv(np.asarray(est[first])) @ np.asarray(est[last])
            E = np.linalg.inv(Tg) @ Te
            t_errs.append(kitti_translation_error(E) / L)
            r_errs.append(kitti_rotation_error(E) / L)
    if not t_errs:
        return dict(kitti_t_err_pct=float("nan"), kitti_r_err_deg_per_m=float("nan"))
    return dict(
        kitti_t_err_pct=float(np.mean(t_errs)) * 100.0,
        kitti_r_err_deg_per_m=float(np.degrees(np.mean(r_errs))),
    )
