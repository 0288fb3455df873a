"""Local bundle adjustment: damped Gauss-Newton with Schur elimination
(port of denseslam_tpu/ops/ba.py).

The observation set is a dense (L, K) grid with a validity mask: every
per-observation quantity (residuals, 2x6 / 2x3 Jacobians, Huber weights)
is one batched einsum (the normal equations and the Schur solve in
float64, so that every device lands on the same step), the landmark
blocks are inverted in closed form
(ops/smallsolve.py `inv3x3`), and the reduced (6K, 6K) camera system is
one dense `torch.linalg.solve_ex` without its error check (which would
read a value back to the host; a singular system gives non-finite
values, as the JAX solve does). Stereo observations (u_l, v, u_r) anchor
scale. Nothing here reads a value back to the host: an iteration that does
not lower the cost is rejected with `torch.where`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import BackendConfig
from ..utils import lie
from ..utils.camera import StereoRig
from ..utils.numerics import true_div
from .smallsolve import inv3x3


class BAProblem(NamedTuple):
    T_wc: torch.Tensor        # (K, 4, 4) initial keyframe poses (camera-to-world)
    points_w: torch.Tensor    # (L, 3) initial landmark positions (world)
    obs: torch.Tensor         # (L, K, 3) observed (u_l, v, u_r); u_r < 0 = mono
    obs_mask: torch.Tensor    # (L, K) bool
    fixed: torch.Tensor       # (K,) bool gauge-fixed keyframes
    point_valid: torch.Tensor  # (L,) bool


class BAResult(NamedTuple):
    T_wc: torch.Tensor
    points_w: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    num_obs: torch.Tensor


def _residuals(T_cw, points_w, obs, rig: StereoRig):
    """(L, K, 3) stereo reprojection residuals and camera-frame points."""
    intr = rig.intr
    p = (torch.einsum("kij,lj->lki", T_cw[:, :3, :3], points_w)
         + T_cw[None, :, :3, 3])
    z = torch.clamp(p[..., 2], min=1e-6)
    ul = p[..., 0] / z * intr.fx + intr.cx
    v = p[..., 1] / z * intr.fy + intr.cy
    ur = (p[..., 0] - rig.baseline_m) / z * intr.fx + intr.cx
    r = torch.stack([ul - obs[..., 0], v - obs[..., 1], ur - obs[..., 2]],
                    dim=-1)
    return r, p


def _jacobians(p, rig: StereoRig):
    """J_cam (L, K, 3, 6) w.r.t. the camera twist (left-multiplied on
    T_cw) and d(residual)/d(p_c) (L, K, 3, 3)."""
    intr = rig.intr
    x, y = p[..., 0], p[..., 1]
    z = torch.clamp(p[..., 2], min=1e-6)
    iz = true_div(1.0, z)
    iz2 = iz * iz
    zero = torch.zeros_like(z)
    dul = torch.stack([intr.fx * iz, zero, -intr.fx * x * iz2], dim=-1)
    dv = torch.stack([zero, intr.fy * iz, -intr.fy * y * iz2], dim=-1)
    dur = torch.stack([intr.fx * iz, zero,
                       -intr.fx * (x - rig.baseline_m) * iz2], dim=-1)
    J_p = torch.stack([dul, dv, dur], dim=-2)
    # p_c = exp(xi) T_cw X  =>  dp/dxi = [I | -[p_c]x]
    px = torch.stack([
        torch.stack([zero, z, -y], dim=-1),
        torch.stack([-z, zero, x], dim=-1),
        torch.stack([y, -x, zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(px.shape)
    dp_dxi = torch.cat([eye, px], dim=-1)
    return J_p @ dp_dxi, J_p


def _huber_w(r, delta):
    """Huber IRLS weight per observation row (L, K)."""
    n = torch.sqrt((r * r).sum(dim=-1))
    return torch.where(n <= delta, torch.ones_like(n),
                       true_div(delta, torch.clamp(n, min=1e-9)))


def solve(problem: BAProblem, rig: StereoRig, cfg: BackendConfig,
          mesh=None, steps: Optional[list] = None) -> BAResult:
    """Damped GN with Schur elimination; a chi2 pass at half-time drops
    observations still gross after the first half of the iterations.

    mesh: when given (parallel/mesh.py `MapMesh`), each rank holds a slice
    of the landmarks, and every camera-side sum (U, the gradient, the
    Schur complement, the costs and the counts) is summed over the ranks
    by all-reduce; the landmark blocks stay on their rank and the reduced
    camera solve is the same on every rank (parallel/ba.py).

    steps: when given, a list that receives each damped step's accept
    decision (a bool tensor, in order)."""
    K = problem.T_wc.shape[0]
    allsum = ((lambda x: mesh.all_reduce(x)) if mesh is not None
              else (lambda x: x))
    dev, dt = problem.T_wc.device, problem.T_wc.dtype
    delta = cfg.huber_px
    mono = problem.obs[..., 2] < 0.0     # no right obs: zero the ur row
    sel3 = torch.arange(3, device=dev)
    zero_ur = mono[..., None] & (sel3 == 2)
    pv = problem.point_valid
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    diag_k = torch.arange(K, device=dev)

    def cost_of(T_cw, pts, mask):
        r, p = _residuals(T_cw, pts, problem.obs, rig)
        r = torch.where(zero_ur, 0.0, r)
        w = _huber_w(r, delta) * mask
        ok = w * (p[..., 2] > 0.05)
        return allsum((ok[..., None] * r * r).sum()), r, p, ok

    def gn_iters(T_cw, pts, mask, n):
        # cameras with too few effective observations are frozen like the
        # gauge-fixed ones: their blocks are near-singular, and the damped
        # solve would take large steps along the null directions
        eff = mask & pv[:, None]
        weak = allsum(eff.to(torch.int32).sum(dim=0)) < 8
        fixm = problem.fixed | weak
        lm_damp = torch.full((), 1e-4, dtype=dt, device=dev)
        for _ in range(n):
            cost0, r, p, w = cost_of(T_cw, pts, mask)
            J_cam, J_p = _jacobians(p, rig)
            row2 = mono[..., None, None] & (sel3[:, None] == 2)
            J_cam = torch.where(row2, 0.0, J_cam)
            J_pm = torch.where(row2, 0.0, J_p)
            r = torch.where(zero_ur, 0.0, r)

            J_pt = torch.einsum("lkab,kbc->lkac", J_pm, T_cw[:, :3, :3])
            wm = (w * mask * pv[:, None])[..., None, None]
            # the normal equations and their Schur solve in float64, the
            # step rounded once to float32: in float32 the library sums
            # over the landmarks put the CPU's solve of the drive's first
            # window 2.95 mm from its float64 oracle and the card's
            # 0.07-0.31 mm; in float64 both land within 2e-6 m of it
            # (tools/device_trace.py ba)
            J_cam, J_pt, r = J_cam.double(), J_pt.double(), r.double()
            Jc_w = J_cam * wm
            Jp_w = J_pt * wm
            U = allsum(torch.einsum("lkai,lkaj->kij", Jc_w, J_cam))
            V = torch.einsum("lkai,lkaj->lij", Jp_w, J_pt)
            W = torch.einsum("lkai,lkaj->lkij", Jc_w, J_pt)
            b_c = allsum(torch.einsum("lkai,lka->ki", Jc_w, r))
            b_p = torch.einsum("lkai,lka->li", Jp_w, r)

            damp_c = lm_damp * torch.clamp(
                torch.diagonal(U, dim1=-2, dim2=-1).amax(dim=-1), min=1e-3)
            U = U + damp_c[:, None, None] * eye6
            damp_p = lm_damp * torch.clamp(
                torch.diagonal(V, dim1=-2, dim2=-1).amax(dim=-1), min=1e-3)
            V = V + damp_p[:, None, None] * eye3

            Vinv = inv3x3(V)
            WVinv = torch.einsum("lkij,ljm->lkim", W, Vinv)
            # Schur: S = blockdiag(U) - sum_l W Vinv W^T
            S = -allsum(torch.einsum("lkim,lqjm->kqij", WVinv, W))
            S[diag_k, diag_k] += U
            rhs = b_c - allsum(torch.einsum("lkim,lm->ki", WVinv, b_p))

            S = torch.where(fixm[:, None, None, None]
                            | fixm[None, :, None, None], 0.0, S)
            S[diag_k, diag_k] += fixm[:, None, None] * eye6
            rhs = torch.where(fixm[:, None], 0.0, rhs)

            S_dense = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
            dx_c = -torch.linalg.solve_ex(
                S_dense + 1e-8 * torch.eye(6 * K, dtype=S.dtype, device=dev),
                rhs.reshape(-1), check_errors=False)[0].reshape(K, 6)
            # back-substitute landmarks: dx_p = -Vinv (b_p + W^T dx_c)
            Wt_dxc = torch.einsum("lkij,ki->lj", W, dx_c)
            dx_p = -torch.einsum("lij,lj->li", Vinv, b_p + Wt_dxc)
            dx_p = torch.where(pv[:, None], dx_p, 0.0)
            dx_c, dx_p = dx_c.to(dt), dx_p.to(dt)

            T_cw_new = lie.se3_exp(dx_c) @ T_cw
            pts_new = pts + dx_p
            cost1 = cost_of(T_cw_new, pts_new, mask)[0]
            better = cost1 < cost0
            if steps is not None:
                steps.append(better)
            T_cw = torch.where(better, T_cw_new, T_cw)
            pts = torch.where(better, pts_new, pts)
            lm_damp = torch.clamp(torch.where(better, lm_damp * 0.5,
                                              lm_damp * 4.0), 1e-8, 1e2)
        return T_cw, pts

    T_cw0 = lie.inv_T(problem.T_wc)
    mask0 = problem.obs_mask
    init_cost = cost_of(T_cw0, problem.points_w, mask0)[0]

    half = max(cfg.ba_iters // 2, 1)
    T_cw_h, pts_h = gn_iters(T_cw0, problem.points_w, mask0, half)

    # chi2 outlier pass: drop observations still gross after the half-solve
    r_h, _ = _residuals(T_cw_h, pts_h, problem.obs, rig)
    r_h = torch.where(zero_ur, 0.0, r_h)
    mask1 = mask0 & (torch.sqrt((r_h * r_h).sum(dim=-1)) < cfg.outlier_px)

    T_cw_f, pts_f = gn_iters(T_cw_h, pts_h, mask1,
                             max(cfg.ba_iters - half, 1))
    final_cost = cost_of(T_cw_f, pts_f, mask1)[0]
    return BAResult(T_wc=lie.inv_T(T_cw_f), points_w=pts_f,
                    initial_cost=init_cost, final_cost=final_cost,
                    num_obs=allsum(mask1.to(torch.int32).sum()))
