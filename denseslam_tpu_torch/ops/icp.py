"""Projective point-to-plane ICP against a rendered model (port of
denseslam_tpu/ops/icp.py): the internal odometry of
`DenseSLAM.process_frame` when `use_external_odometry` is False.

Each Gauss-Newton step is one data-parallel pass over all pixels (SoA
planes), the 6x6 normal equations one matrix product over an (N, 6)
Jacobian, a small dense solve and an `se3_exp` update. The JAX version's
`fori_loop` is a Python loop here; nothing reads a value back to the
host. The normal equations sum over pixels in another order than XLA's,
so the poses agree with the JAX version's to a tolerance
(tests/test_torch_frame.py states it).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import lie
from ..utils.camera import Intrinsics
from ..utils.numerics import sqrt, true_div
from .raycast import pixel_grid
from .smallsolve import solve_spd6


class ICPResult(NamedTuple):
    T_wc: torch.Tensor          # refined camera-to-world pose
    inlier_frac: torch.Tensor   # fraction of valid pixels with good association
    rmse: torch.Tensor          # point-to-plane RMSE over inliers (m)
    converged: torch.Tensor     # bool: enough inliers to trust the solve


def _bilinear_plane(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    inb: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of plane img (H, W) at (u, v), 0 where not `inb`.
    Coordinates outside are moved to 0 first, so the corner casts stay
    defined; in bounds this is the JAX version's clip."""
    h, w = img.shape
    u = torch.where(inb, u, 0.0)
    v = torch.where(inb, v, 0.0)
    u0 = torch.clamp(torch.floor(u), 0, w - 2)
    v0 = torch.clamp(torch.floor(v), 0, h - 2)
    du = u - u0
    dv = v - v0
    flat = img.reshape(-1)
    base = (v0 * w + u0).long()
    p00 = flat[base]
    p01 = flat[base + 1]
    p10 = flat[base + w]
    p11 = flat[base + w + 1]
    val = (p00 * (1 - du) * (1 - dv) + p01 * du * (1 - dv)
           + p10 * (1 - du) * dv + p11 * du * dv)
    return torch.where(inb, val, 0.0)


def track(depth: torch.Tensor, model_points_w: torch.Tensor,
          model_normals_w: torch.Tensor, model_mask: torch.Tensor,
          T_wc_init: torch.Tensor, T_wc_render: torch.Tensor,
          intr: Intrinsics, num_iters: int = 12,
          dist_thresh_m: float = 0.15, normal_min_cos: float = 0.5,
          min_inliers: int = 300) -> ICPResult:
    """Refine T_wc so that the frame's depth (H, W) aligns with the model
    (its world points, normals and hit mask, rendered from T_wc_render).
    Projective association: each pixel's point goes to the world by the
    estimate, into the render camera, and takes the bilinear model point
    and normal there."""
    h, w = depth.shape
    vv, uu = pixel_grid(h, w, depth.device)
    d = depth.reshape(-1)
    cx = true_div(uu.reshape(-1) - intr.cx, intr.fx) * d
    cy = true_div(vv.reshape(-1) - intr.cy, intr.fy) * d
    cz = d
    valid_d = d > 0
    n_valid = torch.clamp(valid_d.to(torch.float32).sum(), min=1.0)

    planes = [model_points_w[..., i] for i in range(3)]
    planes += [model_normals_w[..., i] for i in range(3)]
    planes.append(model_mask.to(torch.float32))

    T_render_inv = lie.inv_T(T_wc_render)
    Ri = T_render_inv[:3, :3]
    ti = T_render_inv[:3, 3]
    eye6 = torch.eye(6, dtype=torch.float32, device=depth.device)

    T_est = T_wc_init
    frac = rmse = torch.zeros((), dtype=torch.float32, device=depth.device)
    enough = torch.zeros((), dtype=torch.bool, device=depth.device)
    for _ in range(num_iters):
        R = T_est[:3, :3]
        t = T_est[:3, 3]
        # current points -> world (SoA)
        px = R[0, 0] * cx + R[0, 1] * cy + R[0, 2] * cz + t[0]
        py = R[1, 0] * cx + R[1, 1] * cy + R[1, 2] * cz + t[1]
        pz = R[2, 0] * cx + R[2, 1] * cy + R[2, 2] * cz + t[2]
        # into the render camera for association
        rx = Ri[0, 0] * px + Ri[0, 1] * py + Ri[0, 2] * pz + ti[0]
        ry = Ri[1, 0] * px + Ri[1, 1] * py + Ri[1, 2] * pz + ti[1]
        rz = Ri[2, 0] * px + Ri[2, 1] * py + Ri[2, 2] * pz + ti[2]
        zsafe = torch.where(rz.abs() > 1e-9, rz, 1e-9)
        u = rx / zsafe * intr.fx + intr.cx
        v = ry / zsafe * intr.fy + intr.cy
        inb = (u >= 0) & (u <= w - 2) & (v >= 0) & (v <= h - 2) & (rz > 0)

        mx, my, mz, nx, ny, nz, mm = (_bilinear_plane(p, u, v, inb)
                                      for p in planes)
        nn = sqrt(nx * nx + ny * ny + nz * nz)
        inv_nn = true_div(1.0, torch.clamp(nn, min=1e-9))
        nx_u, ny_u, nz_u = nx * inv_nn, ny * inv_nn, nz * inv_nn

        dxp, dyp, dzp = px - mx, py - my, pz - mz
        r = nx_u * dxp + ny_u * dyp + nz_u * dzp
        dist2 = dxp * dxp + dyp * dyp + dzp * dzp
        ok = (valid_d & inb & (mm > 0.999) & (nn > 0.5)
              & (dist2 < dist_thresh_m * dist_thresh_m))
        wgt = ok.to(torch.float32)

        # J = [n, p x n] for r = n . (p_w - m)
        J = torch.stack([nx_u, ny_u, nz_u, py * nz_u - pz * ny_u,
                         pz * nx_u - px * nz_u, px * ny_u - py * nx_u],
                        dim=-1)                                   # (N, 6)
        Jw = J * wgt[:, None]
        JTJ = Jw.T @ J
        JTr = Jw.T @ r
        damp = 1e-6 * torch.diagonal(JTJ).sum() + 1e-8
        xi = -solve_spd6(JTJ + damp * eye6, JTr)

        n_in = wgt.sum()
        enough = n_in >= min_inliers
        xi = torch.where(enough, xi, 0.0)
        T_est = lie.se3_exp(xi) @ T_est
        rmse = sqrt((wgt * r * r).sum() / torch.clamp(n_in, min=1.0))
        frac = n_in / n_valid
    return ICPResult(T_wc=T_est, inlier_frac=frac, rmse=rmse,
                     converged=enough)
