"""Stereo visual odometry: RANSAC + Gauss-Newton on 4-way reprojection
(port of denseslam_tpu/ops/ransac.py).

All K hypotheses run together as a batch dimension: each GN iteration is
one set of (K, 3)-point tensor ops, inlier counting one (K, N) reduction,
and the refit a masked GN over all matches.

The hypotheses' correspondence draws are `raw` (K, 3) non-negative
integers that the caller draws as the JAX version draws them:
`draw_hypotheses(key, K)`, i.e. `randint(key, (K, 3), 0, 2^31 - 1)` of a
threefry key (utils/threefry.py); there is no global RNG here.

Returns T_prev_curr ("T_delta"): p_curr = R p_prev + t.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import FrontendConfig
from ..utils import lie, numerics, threefry
from ..utils.camera import StereoRig
from ..utils.numerics import fma_dot, fma_twice, tree_sum, true_div
from .matching import QuadMatches
from .smallsolve import solve_spd6

_RAW_HIGH = 2 ** 31 - 1     # jax.random.randint(..., 0, iinfo(int32).max)


class VOResult(NamedTuple):
    T_delta: torch.Tensor      # (4, 4) prev-cam -> curr-cam
    inliers: torch.Tensor      # bool (N,)
    num_inliers: torch.Tensor  # i32 ()
    ok: torch.Tensor           # bool () solution trustworthy


def draw_hypotheses(key: torch.Tensor, k: int, device=None,
                    size: int = 3) -> torch.Tensor:
    """(k, size) int64 draws in [0, 2^31 - 1) of the threefry key `key`,
    as jax.random.randint draws them (ops/ransac.py:157 and ops/mono.py:179
    of the JAX package), on `device`: `size` correspondences a hypothesis
    (3 for this solver, 8 for ops/mono.py's). Keys live on the host, so
    this is host work and one copy."""
    raw = threefry.randint(key, (k, size), 0, _RAW_HIGH)
    return raw.to(device) if device is not None else raw


def triangulate_prev(q: QuadMatches, rig: StereoRig):
    """Previous-frame 3D points from stereo disparity."""
    intr = rig.intr
    disp = torch.clamp(q.uv_lp[:, 0] - q.uv_rp[:, 0], min=1e-3)
    base = rig.baseline_m
    z = true_div(intr.fx * base, disp)
    x = (q.uv_lp[:, 0] - intr.cx) * base / disp
    y = (q.uv_lp[:, 1] - intr.cy) * base / disp * (intr.fx / intr.fy)
    pts = torch.stack([x, y, z], dim=-1)
    ok = q.valid & (disp > 0.5) & (z > 0.1) & (z < 100.0)
    return pts, ok


def _f32(x: float) -> float:
    """x rounded to float32: the constant jitted JAX computes with."""
    return float(np.float32(x))


def _transform(T, pts):
    """R p + t of (..., 4, 4) T and (..., N, 3) points as jitted XLA:CPU
    computes `lie.transform_points` here: each coordinate a chain of 3
    FMAs from 0 (`fma_dot`), then + t. A batched matmul would go to cuBLAS
    on the card and sum otherwise than the CPU."""
    R = T[..., :3, :3]
    return (fma_dot(pts[..., :, None, :], R[..., None, :, :], dim=-1)
            + T[..., None, :3, 3])


def _reproject_residuals(T, pts_prev, obs_l, obs_r, rig: StereoRig):
    """4-way reprojection residuals (..., N, 4): left u, v + right u, v.
    T (..., 4, 4) and pts_prev (..., N, 3) broadcast. Rounded as jitted
    XLA:CPU rounds the JAX version (`_transform`, and each `q * f + c` one
    FMA: `fma_twice`), alike on every device."""
    intr = rig.intr
    p = _transform(T, pts_prev)
    z = torch.clamp(p[..., 2], min=1e-6)
    # (x, y, x - B) / z, then u_l, v_l, u_r together
    q = torch.stack([p[..., 0], p[..., 1], p[..., 0] - rig.baseline_m],
                    dim=-1) / z[..., None]
    f64 = (torch.float64, q.device)
    scale = numerics.constant((_f32(intr.fx), _f32(intr.fy), _f32(intr.fx)),
                              *f64)
    shift = numerics.constant((_f32(intr.cx), _f32(intr.cy), _f32(intr.cx)),
                              *f64)
    uvu = fma_twice(q, scale, shift)
    # u_l - obs_l.u, v_l - obs_l.v, u_r - obs_r.u, v_l - obs_r.v (v_r = v_l)
    return (torch.cat([uvu, uvu[..., 1:2]], dim=-1)
            - torch.cat([obs_l, obs_r], dim=-1)), p


def _gn_jacobian(p, rig: StereoRig):
    """Analytic Jacobian of the 4 residuals w.r.t. the left-multiplied
    twist [v, w]: (..., N, 4, 6). J_p @ dp_dxi is written out in jitted
    XLA:CPU's order, so every device rounds it alike (a batched matmul
    goes to cuBLAS on the card)."""
    intr = rig.intr
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    z = torch.clamp(z, min=1e-6)
    iz = 1.0 / z
    iz2 = iz * iz
    zero = torch.zeros_like(z)

    def duv_dp(xc):
        du = torch.stack([intr.fx * iz, zero, -intr.fx * xc * iz2], dim=-1)
        dv = torch.stack([zero, intr.fy * iz, -intr.fy * y * iz2], dim=-1)
        return du, dv

    dul, dvl = duv_dp(x)
    dur, dvr = duv_dp(x - rig.baseline_m)
    J_p = torch.stack([dul, dvl, dur, dvr], dim=-2)      # (..., N, 4, 3)
    # dp/dxi = [I | -[p]x]
    px = torch.stack([
        torch.stack([zero, z, -y], dim=-1),
        torch.stack([-z, zero, x], dim=-1),
        torch.stack([y, -x, zero], dim=-1),
    ], dim=-2)                                            # (..., N, 3, 3)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(px.shape)
    dp_dxi = torch.cat([eye, px], dim=-1)                # (..., N, 3, 6)
    # the product as jitted XLA forms it: per entry a chain of 3 FMAs
    return fma_dot(J_p[..., :, :, None], dp_dxi[..., None, :, :],
                   dim=-2)                               # (..., N, 4, 6)


def _gn_refine(T0, pts_prev, obs_l, obs_r, weights, rig, iters: int):
    """Masked Gauss-Newton, batched over leading dims: T0 (..., 4, 4),
    pts_prev / obs (..., N, 3|2), weights (..., N). Every sum is in one
    fixed order, so the card and the CPU round each step alike. The
    normal equations A = J^T W J and b = J^T W r are one (6, 7) product of
    4N terms, each exact in float64, that a halving tree adds in float64
    (`tree_sum`) and rounds once to float32: the float32 rounding of the
    exact sum but within about log2(4N) float64 ulps of a rounding
    boundary. Jitted XLA:CPU emits both einsums as chains of FMAs whose
    tiling depends on the shape (4N = 8192: two blocks of 4096 in four
    lanes for A, eight lanes for b), one launch a term here; the exact
    sum is as near to them as any cheap order, and the distance to jitted
    JAX is then JAX's own rounding (tests/test_torch_vo_order.py). The
    damping's trace is a tree too, and the update exp(xi) T is
    `lie.se3_exp_apply`."""
    T = T0
    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)
    for _ in range(iters):
        r, p = _reproject_residuals(T, pts_prev, obs_l, obs_r, rig)
        J = _gn_jacobian(p, rig)
        JTw = J * weights[..., None, None]
        M = torch.cat([J, r[..., None]], dim=-1)             # (..., N, 4, 7)
        # the products exact in float64, their sum rounded once
        terms = (JTw[..., :, None].double() * M[..., None, :]).flatten(-4, -3)
        S = tree_sum(terms, dim=-3).float()                  # (..., 6, 7)
        A, b = S[..., :6], S[..., 6]
        damp = 1e-6 * tree_sum(torch.diagonal(A, dim1=-2, dim2=-1)) + 1e-9
        xi = -solve_spd6(A + damp[..., None, None] * eye6, b)
        xi = torch.clamp(xi, -0.5, 0.5)           # guard divergent steps
        T = lie.se3_exp_apply(xi, T)
    return T


def _active_hypotheses(k: int, budget_scale: float) -> int:
    """ceil(K * clip(scale, 1/K, 1)) in float32, at least 1: the JAX
    version's count, computed on the host."""
    scale = np.clip(np.float32(budget_scale), np.float32(1.0 / k),
                    np.float32(1.0))
    return max(int(math.ceil(np.float32(k) * scale)), 1)


def estimate_stereo_motion(q: QuadMatches, rig: StereoRig,
                           cfg: FrontendConfig, raw: torch.Tensor,
                           T_init: Optional[torch.Tensor] = None,
                           budget_scale: Optional[float] = None) -> VOResult:
    """RANSAC + refit over quad matches. `raw` (K, 3) are the hypothesis
    draws (K = cfg.ransac_iters; `draw_hypotheses(key, K)`).

    budget_scale (a host number in (0, 1], optional) is the PD frame-time
    controller's knob: only the first ceil(K * budget_scale) hypotheses
    may win the vote (all K are still solved, as in the JAX version)."""
    dev = q.uv_lc.device
    pts_prev, ok = triangulate_prev(q, rig)
    obs_l = q.uv_lc
    obs_r = q.uv_rc
    n_ok = ok.to(torch.int32).sum()

    k = cfg.ransac_iters
    if tuple(raw.shape) != (k, 3):
        raise ValueError(f"raw draws of shape {tuple(raw.shape)}, expected {(k, 3)}")
    # hypotheses: K x 3 correspondences among the valid matches (valid
    # indices first; the modulo keeps the draws on them)
    order = torch.argsort((~ok).to(torch.int32), stable=True)
    denom = torch.clamp(n_ok, min=3)
    sel = order[torch.remainder(raw.to(dev, torch.int64), denom)]   # (K, 3)

    eye = torch.eye(4, dtype=torch.float32, device=dev)
    T0 = eye if T_init is None else T_init
    w3 = torch.ones((k, 3), dtype=torch.float32, device=dev)
    T_hyp = _gn_refine(T0.expand(k, 4, 4), pts_prev[sel], obs_l[sel],
                       obs_r[sel], w3, rig, cfg.gn_iters)      # (K, 4, 4)

    def count(T):
        r, _ = _reproject_residuals(T, pts_prev, obs_l, obs_r, rig)
        good = (r.abs() < cfg.ransac_thresh_px).all(dim=-1) & ok
        return good.to(torch.int32).sum(dim=-1), good

    counts, inlier_sets = count(T_hyp)                         # (K,), (K, N)
    if budget_scale is not None:
        counts = torch.where(
            torch.arange(k, device=dev) < _active_hypotheses(k, budget_scale),
            counts, -1)
    # first max; a (1,) index, since a 0-d one is read back to the host
    best = torch.argmax(counts).reshape(1)
    best_inliers = inlier_sets.index_select(0, best)[0]
    best_T = T_hyp.index_select(0, best)[0]

    w = best_inliers.to(torch.float32)
    if cfg.edge_reweighting:
        # features near the horizontal image centre weigh more in the refit
        cu = rig.intr.cx
        w = w / (true_div((obs_l[:, 0] - cu).abs(), abs(cu)) + 0.05)
    T_refined = _gn_refine(best_T, pts_prev, obs_l, obs_r, w, rig,
                           cfg.refine_iters)
    num, final_inliers = count(T_refined)
    num = num.to(torch.int32)
    ok_solution = num >= 6
    T_final = torch.where(ok_solution, T_refined, T0)
    return VOResult(T_delta=T_final, inliers=final_inliers,
                    num_inliers=num, ok=ok_solution)
