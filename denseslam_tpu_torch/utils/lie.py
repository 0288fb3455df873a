"""SO(3)/SE(3) helpers (port of part of denseslam_tpu/utils/lie.py). Poses
are row-major float32 4x4 matrices; tangent vectors are [vx, vy, vz, wx,
wy, wz] (translation first). Every function takes leading batch dims."""

from __future__ import annotations

import numpy as np
import torch

from .numerics import true_div

_EPS = 1e-8
# below theta^2 = 1e-4 the closed forms cancel in float32; the Taylor
# expansions are accurate to ~theta^4 there
_SMALL2 = 1e-4


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _theta(w: torch.Tensor):
    theta2 = (w * w).sum(dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    return theta2, theta


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with the Taylor branch for small angles."""
    theta2, theta = _theta(w)
    W = hat(w)
    W2 = W @ W
    small = theta2 < _SMALL2
    a = torch.where(small, 1.0 - true_div(theta2, 6.0),
                    torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - true_div(theta2, 24.0),
                    (1.0 - torch.cos(theta)) / theta2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a * W + b * W2


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp: (..., 6) [v, w] -> (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2, theta = _theta(w)
    W = hat(w)
    W2 = W @ W
    small = theta2 < _SMALL2
    b = torch.where(small, 0.5 - true_div(theta2, 24.0),
                    (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - true_div(theta2, 120.0),
                    (theta - torch.sin(theta)) / (theta2 * theta))
    R = so3_exp(w)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    V = eye + b * W + c * W2
    t = (V @ v[..., None])[..., 0]
    return make_T(R, t)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) transforms to (..., N, 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def se3_exp_np(xi) -> np.ndarray:
    """Pure-numpy se(3) exp, [v, w] convention (translation first)."""
    xi = np.asarray(xi, dtype=np.float64)
    v, w = xi[:3], xi[3:]
    theta = float(np.linalg.norm(w))
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]],
                 dtype=np.float64)
    W2 = W @ W
    t2 = theta * theta
    if theta < 1e-5:
        a, b, c = 1.0 - t2 / 6.0, 0.5 - t2 / 24.0, 1.0 / 6.0 - t2 / 120.0
    else:
        a = np.sin(theta) / theta
        b = (1.0 - np.cos(theta)) / t2
        c = (theta - np.sin(theta)) / (t2 * theta)
    R = np.eye(3) + a * W + b * W2
    V = np.eye(3) + b * W + c * W2
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T.astype(np.float32)


def make_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from (..., 3, 3) rotation and (..., 3) translation."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    # built on the device: a tensor made from a Python list is copied from
    # the host, and that copy waits for the card
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(
        batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 fused multiply-add: the f32 product is exact in f64, so one f64
    add and one rounding back to f32 reproduce fma(a, b, c)."""
    return (a.double() * b.double() + c.double()).float()


def inv_T(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform (orthonormal R).

    The JAX reference forms -R^T t with a 3x3 dot that XLA:CPU lowers to a
    fused multiply-add chain, fma(r2, t2, fma(r1, t1, r0 * t0)); it is
    written out the same way here so that voxel projections agree with the
    reference bit for bit."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    acc = Rt[..., :, 0] * t[..., None, 0]
    acc = _fma_f32(Rt[..., :, 1], t[..., None, 1], acc)
    acc = _fma_f32(Rt[..., :, 2], t[..., None, 2], acc)
    return make_T(Rt, -acc)
