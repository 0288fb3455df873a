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

from .. import kernels
from ..config import FrontendConfig
from ..utils import lie, numerics, threefry
from ..utils.camera import StereoRig
from ..utils.numerics import fma_dot, fma_twice, true_div
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


def gn_normal(J: torch.Tensor, r: torch.Tensor, w: torch.Tensor
              ) -> torch.Tensor:
    """S = [A | b] (..., 6, 7) of the Gauss-Newton step: A = (J w)^T J and
    b = (J w)^T r over the 4N rows of J (..., N, 4, 6), r (..., N, 4), w
    (..., N), in jitted XLA:CPU's order (`numerics.gn_normal`). Kernel GN
    (csrc/gn_normal.cu) for CUDA tensors, one launch for the whole batch;
    the plain version for CPU ones."""
    if J.device.type == "cpu":
        return numerics.gn_normal(J, r, w)
    lead, n = J.shape[:-3], J.shape[-3]
    batch = math.prod(lead)
    dev = J.device
    kernels.check_tensor(J, "J", torch.float32, lead + (n, 4, 6))
    kernels.check_tensor(r, "r", torch.float32, lead + (n, 4), dev)
    kernels.check_tensor(w, "w", torch.float32, lead + (n,), dev)
    S = torch.empty(lead + (6, 7), dtype=torch.float32, device=dev)
    kernels.launch("gn_normal", dev, J, r, w, S, batch, n,
                   int(numerics.gn_fused_b(lead, n)))
    return S


def gn_update_plain(S: torch.Tensor, T: torch.Tensor,
                    shared: bool = False) -> torch.Tensor:
    """Kernel GU's plain version: the Gauss-Newton step after the normal
    equations S = [A | b] (..., 6, 7), in jitted XLA:CPU's order: the
    damping 1e-6 tr(A) + 1e-9 one FMA (`numerics.fma`) over the trace summed
    left to right, the solve `solve_spd6`, the step clipped to [-0.5, 0.5]
    and the update exp(xi) T `lie.se3_exp_apply` (T (..., 4, 4), or with
    `shared` one pose expanded over the batch)."""
    A, b = S[..., :6], S[..., 6]
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    tr = numerics.sum_seq(torch.diagonal(A, dim1=-2, dim2=-1))
    damp = numerics.fma(tr, torch.full_like(tr, _f32(1e-6)),
                        torch.full_like(tr, _f32(1e-9)))
    xi = -solve_spd6(A + damp[..., None, None] * eye6, b)
    xi = torch.clamp(xi, -0.5, 0.5)               # guard divergent steps
    return lie.se3_exp_apply(xi, T, shared=shared)


def gn_update(S: torch.Tensor, T: torch.Tensor,
              shared: bool = False) -> torch.Tensor:
    """The pose after one Gauss-Newton step from S (..., 6, 7) at T
    (`gn_update_plain`): kernel GU (csrc/gn_update.cu) for CUDA tensors,
    one launch for the whole batch, where the plain version is about 420
    small launches; the plain version for CPU ones."""
    if S.device.type == "cpu":
        return gn_update_plain(S, T, shared)
    lead = S.shape[:-2]
    dev = S.device
    kernels.check_tensor(S, "S", torch.float32, lead + (6, 7))
    if shared:
        T = T.reshape(-1, 4, 4)[0].contiguous()
        kernels.check_tensor(T, "T", torch.float32, (4, 4), dev)
    else:
        T = T.contiguous()
        kernels.check_tensor(T, "T", torch.float32, lead + (4, 4), dev)
    out = torch.empty(lead + (4, 4), dtype=torch.float32, device=dev)
    kernels.launch("gn_update", dev, S, T, out, math.prod(lead), int(shared))
    return out


def _gn_refine(T0, pts_prev, obs_l, obs_r, weights, rig, iters: int,
               shared_T0: bool = False):
    """Masked Gauss-Newton, batched over leading dims: T0 (..., 4, 4),
    pts_prev / obs (..., N, 3|2), weights (..., N). Every step in jitted
    XLA:CPU's order, alike on every device: the normal equations by
    `gn_normal` (kernel GN), the rest of the step by `gn_update` (kernel
    GU; tests/test_torch_gn_normal.py holds each op).
    `shared_T0`: T0 is one pose expanded over the batch (the hypotheses,
    whose JAX T0 is unbatched under vmap): the first update's product
    then takes XLA's order for one shared pose."""
    T = T0
    for it in range(iters):
        r, p = _reproject_residuals(T, pts_prev, obs_l, obs_r, rig)
        J = _gn_jacobian(p, rig)
        S = gn_normal(J.contiguous(), r.contiguous(),
                      weights.expand(J.shape[:-2]).contiguous())
        T = gn_update(S, T, shared=shared_T0 and it == 0)
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
                       obs_r[sel], w3, rig, cfg.gn_iters,
                       shared_T0=True)                          # (K, 4, 4)

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
        # as jitted XLA:CPU has it: / |cu| a multiply by its float32
        # reciprocal, contracted with + 0.05 into one FMA
        w = w / fma_twice((obs_l[:, 0] - cu).abs(), numerics.recip(abs(cu)),
                          _f32(0.05))
    T_refined = _gn_refine(best_T, pts_prev, obs_l, obs_r, w, rig,
                           cfg.refine_iters)
    num, final_inliers = count(T_refined)
    num = num.to(torch.int32)
    ok_solution = num >= 6
    T_final = torch.where(ok_solution, T_refined, T0)
    return VOResult(T_delta=T_final, inliers=final_inliers,
                    num_inliers=num, ok=ok_solution)
