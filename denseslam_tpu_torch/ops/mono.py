"""Monocular visual odometry: batched 8-point essential matrix + chierality
(port of denseslam_tpu/ops/mono.py).

All K RANSAC hypotheses solve together: a batch of (K, 8, 9) SVD
nullspaces, inliers scored by Sampson distance in one (K, N) reduction,
and the four (R, t) decompositions of the winner ranked by triangulated
depth counts. Scale is unobservable; `estimate_scale_ground` fixes it
from the calibrated camera height over the ground plane.

The hypotheses' correspondence draws are `raw` (K, 8) non-negative
integers: the caller draws them from its threefry key as the JAX version
draws them (`ransac.draw_hypotheses(key, K, size=8)`).

The SVDs have a sign ambiguity (of the nullspace vector and of U and V),
and the card's batched solver (cuSOLVER) differs from LAPACK in the last
bits: compare the chosen motion, the inlier sets and the counts, never
the factors. The 8-point nullspaces are solved in float64 (see
`_eight_point`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import FrontendConfig
from ..utils import lie
from ..utils.camera import Intrinsics
from ..utils.numerics import true_div

# the rotation by +90 degrees about z of the essential decomposition
_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


class MonoVOResult(NamedTuple):
    T_delta: torch.Tensor      # (4, 4) prev-cam -> curr-cam, ||t|| = 1
    inliers: torch.Tensor      # bool (N,)
    num_inliers: torch.Tensor  # i32 ()
    ok: torch.Tensor           # bool ()


class MonoScale(NamedTuple):
    scale: torch.Tensor        # f32 () metric scale of the unit translation
    num_ground: torch.Tensor   # i32 () points that voted
    ok: torch.Tensor           # bool ()


def _normalize(uv: torch.Tensor, intr: Intrinsics):
    x = true_div(uv[..., 0] - intr.cx, intr.fx)
    y = true_div(uv[..., 1] - intr.cy, intr.fy)
    return x, y


def _eight_point(xp, yp, xc, yc) -> torch.Tensor:
    """E from 8 normalized correspondences, batched over leading dims
    (..., 8) -> (..., 3, 3): the SVD nullspace of the 8x9 system, projected
    onto the essential manifold (two equal singular values, third zero).

    The system is built in float32, as in the JAX version, but solved in
    float64 and E rounded to float32: a float32 nullspace moves by about
    eps / s8 (s8 the system's smallest singular value, often 1e-3) between
    LAPACK and the card's batched solver, and those bits move Sampson
    distances across the inlier threshold, which decides which of the
    hypotheses tied at the top count wins (the winner is used without a
    refit). In float64 both devices round to the same E."""
    a = torch.stack([xc * xp, xc * yp, xc, yc * xp, yc * yp, yc, xp, yp,
                     torch.ones_like(xp)], dim=-1)          # (..., 8, 9)
    _, _, vt = torch.linalg.svd(a.double(), full_matrices=True)
    e = vt[..., -1, :].reshape(vt.shape[:-2] + (3, 3))
    u, s, vt2 = torch.linalg.svd(e)
    sbar = 0.5 * (s[..., 0] + s[..., 1])
    diag = torch.stack([sbar, sbar, torch.zeros_like(sbar)], dim=-1)
    return ((u * diag[..., None, :]) @ vt2).to(xp.dtype)


def _sampson(E: torch.Tensor, xp, yp, xc, yc) -> torch.Tensor:
    """Squared Sampson distance of every correspondence (N,) to each E
    (..., 3, 3) -> (..., N)."""
    def e(i, j):
        return E[..., i, j, None]

    lx = e(0, 0) * xp + e(0, 1) * yp + e(0, 2)
    ly = e(1, 0) * xp + e(1, 1) * yp + e(1, 2)
    lz = e(2, 0) * xp + e(2, 1) * yp + e(2, 2)
    mx = e(0, 0) * xc + e(1, 0) * yc + e(2, 0)
    my = e(0, 1) * xc + e(1, 1) * yc + e(2, 1)
    num = xc * lx + yc * ly + lz
    den = lx * lx + ly * ly + mx * mx + my * my
    return num * num / torch.clamp(den, min=1e-12)


def _triangulate_depths(R: torch.Tensor, t: torch.Tensor, xp, yp, xc, yc):
    """Linear triangulation depths (z_prev, z_curr) of every point for the
    motion p_c = R p_p + t; R (..., 3, 3), t (..., 3) broadcast against the
    points (N,) -> (..., N) each."""
    def r(i, j):
        return R[..., i, j, None]

    def tt(i):
        return t[..., i, None]

    # z_p * (R dp) x dc = -t x dc, with dp = (xp, yp, 1), dc = (xc, yc, 1)
    rx = r(0, 0) * xp + r(0, 1) * yp + r(0, 2)
    ry = r(1, 0) * xp + r(1, 1) * yp + r(1, 2)
    rz = r(2, 0) * xp + r(2, 1) * yp + r(2, 2)
    ax = ry - rz * yc
    ay = rz * xc - rx
    az = rx * yc - ry * xc
    bx = -(tt(1) - tt(2) * yc)
    by = -(tt(2) * xc - tt(0))
    bz = -(tt(0) * yc - tt(1) * xc)
    denom = ax * ax + ay * ay + az * az
    z_p = (ax * bx + ay * by + az * bz) / torch.clamp(denom, min=1e-12)
    z_c = z_p * rz + tt(2)
    return z_p, z_c


def _masked_median(d: torch.Tensor, sel: torch.Tensor):
    """The lower median of d over sel (the ((k - 1) // 2)-th of the sorted
    selected values, index 0 when none is selected) and the count k."""
    k = sel.to(torch.int32).sum()
    vals = torch.sort(torch.where(sel, d, float("inf"))).values
    i = torch.clamp(torch.div(k - 1, 2, rounding_mode="floor"), 0,
                    vals.shape[0] - 1)
    return vals.index_select(0, i.reshape(1).long())[0], k


def estimate_scale_ground(T_delta: torch.Tensor, uv_prev: torch.Tensor,
                          uv_curr: torch.Tensor, inliers: torch.Tensor,
                          intr: Intrinsics, camera_height_m: float,
                          camera_pitch_rad: float = 0.0) -> MonoScale:
    """Metric scale from the known camera height over the ground plane:
    triangulate the inliers at unit translation; ground candidates are
    inliers in the bottom band of the image with positive distance below
    the camera along the pitched plane normal; the scale is the camera
    height over the median distance, re-taken over the candidates within
    30% of the first median when at least 8 of them are."""
    xp, yp = _normalize(uv_prev, intr)
    xc, yc = _normalize(uv_curr, intr)
    z_p, z_c = _triangulate_depths(T_delta[:3, :3], T_delta[:3, 3],
                                   xp, yp, xc, yc)
    py, pz = z_p * yp, z_p
    pitch = torch.tensor(camera_pitch_rad, dtype=torch.float32,
                         device=uv_prev.device)
    d = py * torch.cos(pitch) - pz * torch.sin(pitch)
    row_floor = intr.cy + 0.35 * (intr.height - 1 - intr.cy)
    cand = (inliers & (z_p > 0.1) & (z_c > 0.1)
            & (uv_prev[:, 1] > row_floor) & (d > 1e-3) & torch.isfinite(d))
    med0, n_cand = _masked_median(d, cand)
    band = cand & ((d - med0).abs() < 0.3 * med0)
    med1, n_band = _masked_median(d, band)
    med = torch.where(n_band >= 8, med1, med0)
    ok = n_cand >= 8
    scale = torch.where(ok, true_div(camera_height_m,
                                     torch.clamp(med, min=1e-3)), 1.0)
    return MonoScale(scale=torch.clamp(scale, 1e-3, 1e3),
                     num_ground=n_cand.to(torch.int32), ok=ok)


def apply_scale(T_delta: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Scale the translation of a unit-norm relative pose to metric."""
    out = T_delta.clone()
    out[:3, 3] = out[:3, 3] * scale
    return out


def _decompose(E: torch.Tensor):
    """The four (R, t) candidates of E: (4, 3, 3), (4, 3)."""
    u, _, vt = torch.linalg.svd(E)
    u = u * torch.sign(torch.linalg.det(u))
    vt = vt * torch.sign(torch.linalg.det(vt))
    w = torch.tensor(_W, dtype=E.dtype, device=E.device)
    R1 = u @ w @ vt
    R2 = u @ w.T @ vt
    t1 = u[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t1, -t1, t1, -t1])


def estimate_mono_motion(uv_prev: torch.Tensor, uv_curr: torch.Tensor,
                         valid: torch.Tensor, intr: Intrinsics,
                         cfg: FrontendConfig, raw: torch.Tensor
                         ) -> MonoVOResult:
    """8-point RANSAC over the matches (N,): K = cfg.ransac_iters
    hypotheses of 8 correspondences drawn among the valid ones by `raw`
    (K, 8) (`ransac.draw_hypotheses(key, K, size=8)`), the first
    hypothesis with the most Sampson inliers, and its decomposition that
    puts the most of them in front of both cameras. ok needs >= 12
    inliers, half of them in front; otherwise T_delta is the identity."""
    dev = uv_prev.device
    xp, yp = _normalize(uv_prev, intr)
    xc, yc = _normalize(uv_curr, intr)
    n_ok = valid.to(torch.int32).sum()

    k = cfg.ransac_iters
    if tuple(raw.shape) != (k, 8):
        raise ValueError(f"raw draws of shape {tuple(raw.shape)}, "
                         f"expected {(k, 8)}")
    # valid entries first; the modulo keeps the draws on them
    order = torch.argsort((~valid).to(torch.int32), stable=True)
    sel = order[torch.remainder(raw.to(dev, torch.int64),
                                torch.clamp(n_ok, min=8))]        # (K, 8)
    Es = _eight_point(xp[sel], yp[sel], xc[sel], yc[sel])         # (K, 3, 3)

    thresh = (cfg.ransac_thresh_px / intr.fx) ** 2
    inlier_sets = (_sampson(Es, xp, yp, xc, yc) < thresh) & valid  # (K, N)
    counts = inlier_sets.to(torch.int32).sum(dim=-1)
    # first max; a (1,) index, since a 0-d one is read back to the host
    best = torch.argmax(counts).reshape(1)
    E = Es.index_select(0, best)[0]
    best_inliers = inlier_sets.index_select(0, best)[0]
    num = counts.index_select(0, best)[0]

    cands_R, cands_t = _decompose(E)
    z_p, z_c = _triangulate_depths(cands_R, cands_t, xp, yp, xc, yc)
    votes = ((z_p > 0) & (z_c > 0) & best_inliers).to(torch.int32).sum(-1)
    pick = torch.argmax(votes).reshape(1)
    R = cands_R.index_select(0, pick)[0]
    t = cands_t.index_select(0, pick)[0]

    ok = (num >= 12) & (votes.index_select(0, pick)[0]
                        >= torch.div(num, 2, rounding_mode="floor"))
    T = torch.where(ok, lie.make_T(R, t),
                    torch.eye(4, dtype=torch.float32, device=dev))
    return MonoVOResult(T_delta=T, inliers=best_inliers,
                        num_inliers=num.to(torch.int32), ok=ok)
