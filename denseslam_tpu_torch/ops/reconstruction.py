"""Sparse 3D reconstruction from tracked features and known egomotion
(port of denseslam_tpu/ops/reconstruction.py): every track of a fixed-cap
(L, K) observation grid triangulated at once, a linear midpoint start
(a batched 3x3 solve) refined by batched Gauss-Newton on the reprojection
residuals.

Every sum over the K views and the 3 coordinates is written out in a
fixed order (`_vsum`), not as an einsum: cuBLAS and the CPU's BLAS sum in
other orders, and the normal equations of a far point are ill
conditioned enough to turn those last bits into millimetres. Written out,
the card and the CPU compute the same points."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import lie
from ..utils.camera import Intrinsics
from ..utils.numerics import sqrt, true_div
from .smallsolve import solve3x3


class Tracks(NamedTuple):
    uv: torch.Tensor        # f32 (L, K, 2) observations per frame
    obs_mask: torch.Tensor  # bool (L, K)
    T_wc: torch.Tensor      # f32 (K, 4, 4) camera poses


class Reconstruction(NamedTuple):
    points_w: torch.Tensor     # (L, 3)
    valid: torch.Tensor        # (L,)
    reproj_rmse: torch.Tensor  # (L,) pixels


def _vsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 (the views), left to right."""
    acc = x[:, 0]
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k]
    return acc


def _dot3(a, b):
    """a (..., 3) . b (..., 3), left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def triangulate_tracks(tracks: Tracks, intr: Intrinsics, gn_iters: int = 5,
                       max_reproj_px: float = 3.0,
                       min_obs: int = 2) -> Reconstruction:
    """Midpoint start + `gn_iters` Gauss-Newton steps for every track; a
    point is valid with >= min_obs observations, a reprojection RMSE under
    max_reproj_px and every observing camera seeing it 5 cm or more in
    front."""
    dev = tracks.uv.device
    T_cw = lie.inv_T(tracks.T_wc)                          # (K, 4, 4)
    R = T_cw[:, :3, :3]
    t = T_cw[:, :3, 3]

    # normalized rays per observation
    x = true_div(tracks.uv[..., 0] - intr.cx, intr.fx)     # (L, K)
    y = true_div(tracks.uv[..., 1] - intr.cy, intr.fy)
    m = tracks.obs_mask.to(torch.float32)

    # linear midpoint start: min sum ||(I - d d^T)(p - c)||^2, i.e.
    # A p = b with A = sum (I - d d^T), b = sum (I - d d^T) c, for the
    # world ray direction d = R^T [x, y, 1] through the camera centre c
    dx = R[:, 0, 0][None] * x + R[:, 1, 0][None] * y + R[:, 2, 0][None]
    dy = R[:, 0, 1][None] * x + R[:, 1, 1][None] * y + R[:, 2, 1][None]
    dz = R[:, 0, 2][None] * x + R[:, 1, 2][None] * y + R[:, 2, 2][None]
    norm = sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx / norm, dy / norm, dz / norm
    centers = tracks.T_wc[:, :3, 3]                        # (K, 3)
    cx_, cy_, cz_ = (centers[:, i][None] for i in range(3))

    a11, a12, a13 = 1 - dx * dx, -dx * dy, -dx * dz
    a22, a23, a33 = 1 - dy * dy, -dy * dz, 1 - dz * dz

    def msum(a):
        return _vsum(m * a)

    A = torch.stack([
        torch.stack([msum(a11), msum(a12), msum(a13)], dim=-1),
        torch.stack([msum(a12), msum(a22), msum(a23)], dim=-1),
        torch.stack([msum(a13), msum(a23), msum(a33)], dim=-1),
    ], dim=-2)                                             # (L, 3, 3)
    bx = a11 * cx_ + a12 * cy_ + a13 * cz_
    by = a12 * cx_ + a22 * cy_ + a23 * cz_
    bz = a13 * cx_ + a23 * cy_ + a33 * cz_
    b = torch.stack([msum(bx), msum(by), msum(bz)], dim=-1)
    eye = torch.eye(3, dtype=torch.float32, device=dev)[None]
    p = solve3x3(A + 1e-6 * eye, b)                        # (L, 3)

    def residuals(p):
        pl = p[:, None, :]                                 # (L, 1, 3)
        pc_x = _dot3(R[:, 0, :][None], pl) + t[:, 0][None]
        pc_y = _dot3(R[:, 1, :][None], pl) + t[:, 1][None]
        pc_z = _dot3(R[:, 2, :][None], pl) + t[:, 2][None]
        z = torch.clamp(pc_z, min=1e-6)
        ru = (pc_x / z - x) * intr.fx
        rv = (pc_y / z - y) * intr.fy
        return ru, rv, pc_x, pc_y, z

    w = m[..., None]
    for _ in range(gn_iters):
        ru, rv, pcx, pcy, z = residuals(p)
        iz = true_div(1.0, z)
        # d(ru)/dp = fx * (R0 / z - pcx R2 / z^2), and likewise for rv
        Ju = intr.fx * (R[:, 0, :][None] * iz[..., None]
                        - R[:, 2, :][None] * (pcx * iz * iz)[..., None])
        Jv = intr.fy * (R[:, 1, :][None] * iz[..., None]
                        - R[:, 2, :][None] * (pcy * iz * iz)[..., None])
        Juw, Jvw = Ju * w, Jv * w
        H = (_vsum(Juw[..., :, None] * Ju[..., None, :])
             + _vsum(Jvw[..., :, None] * Jv[..., None, :]))
        g = (_vsum(Juw * ru[..., None]) + _vsum(Jvw * rv[..., None]))
        dp = -solve3x3(H + 1e-5 * eye, g)
        p = p + torch.clamp(dp, -1.0, 1.0)

    ru, rv, _, _, z = residuals(p)
    n_obs = tracks.obs_mask.to(torch.int32).sum(dim=1)
    sq = m * (ru * ru + rv * rv)
    rmse = sqrt(_vsum(sq) / torch.clamp(n_obs, min=1))
    in_front = torch.where(tracks.obs_mask, z > 0.05, True).all(dim=1)
    valid = (n_obs >= min_obs) & (rmse < max_reproj_px) & in_front
    return Reconstruction(points_w=p, valid=valid, reproj_rmse=rmse)
