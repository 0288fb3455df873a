"""SO(3)/SE(3) helpers (port of denseslam_tpu/utils/lie.py). Poses
are row-major float32 4x4 matrices; tangent vectors are [vx, vy, vz, wx,
wy, wz] (translation first). Every function takes leading batch dims."""

from __future__ import annotations

import numpy as np
import torch

from .numerics import (fma, fma_dot_exact, fma_twice, sincosf, sqrt,
                       true_div)

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


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) skew matrix -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


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


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of SO(3) for angles in [0, pi), with the Taylor branch for
    small angles and the diagonal-based extraction near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    # clipped strictly inside (-1, 1): arccos' derivative diverges at +-1
    # and would poison the pose graph's Jacobians at near-identity edges
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-6, 1.0 - 1e-6)
    theta = torch.arccos(cos_t)
    w_raw = vee(R - R.transpose(-1, -2)) * 0.5
    sin_t = torch.sin(theta)
    th = theta[..., None]
    small = th < 1e-2
    scale = torch.where(
        small, 0.5 + true_div(th ** 2, 12.0),
        th / torch.clamp(2.0 * sin_t[..., None], min=_EPS))
    w = 2.0 * scale * w_raw
    near_pi = th > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp(
        (diag - cos_t[..., None])
        / torch.clamp(1.0 - cos_t[..., None], min=_EPS), min=0.0)
    axis = torch.sqrt(axis_sq)
    sign = torch.sign(torch.where(w_raw.abs() > 1e-9, w_raw,
                                  torch.ones_like(w_raw)))
    w_pi = axis * sign * th
    return torch.where(near_pi, w_pi, w)


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


def se3_exp_apply(xi: torch.Tensor, T: torch.Tensor,
                  shared: bool = False) -> torch.Tensor:
    """se3_exp(xi) @ T for (..., 6) xi and (..., 4, 4) T in se3_exp's
    arithmetic, every sum in one fixed order so that every device rounds
    it alike: each small product a chain of FMAs from 0 (`fma_dot_exact`,
    jitted XLA:CPU's order; a matmul goes to cuBLAS on the card), the root
    correctly rounded (`sqrt`), sin and cos those of glibc that jitted
    XLA:CPU calls (`numerics.sincosf`), and each
    `eye + a W + b W2` two FMAs, as XLA contracts it (`fma`).
    `shared`: T is one pose for the whole batch of xi (see below)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = fma_dot_exact(w, w)[..., None, None]
    theta = sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = hat(w)
    W2 = fma_dot_exact(W[..., :, :, None], W[..., None, :, :], dim=-2)
    small = theta2 < _SMALL2
    sin, cos = sincosf(theta)
    a = torch.where(small, 1.0 - true_div(theta2, 6.0), sin / theta)
    b = torch.where(small, 0.5 - true_div(theta2, 24.0),
                    (1.0 - cos) / theta2)
    c = torch.where(small, 1.0 / 6.0 - true_div(theta2, 120.0),
                    (theta - sin) / (theta2 * theta))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    # eye + a W + b W2, contracted by jitted XLA:CPU into two FMAs
    R = fma(b, W2, fma(a, W, eye))
    V = fma(c, W2, fma(b, W, eye))
    E = make_T(R, fma_dot_exact(V, v[..., None, :], dim=-1))
    if shared:
        # one T (4, 4) for a batch of xi (the hypotheses' first step, JAX's
        # T0 unbatched under vmap): XLA makes one (B * 4, 4) x (4, 4) dot
        # of it, which runs in Eigen: the 4 products rounded, added
        # (p0 + p1) + (p2 + p3)
        p = E[..., :, :, None] * T[..., None, :, :]
        return (p[..., 0, :] + p[..., 1, :]) + (p[..., 2, :] + p[..., 3, :])
    return fma_dot_exact(E[..., :, :, None], T[..., None, :, :], dim=-2)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Log map of SE(3): (..., 4, 4) -> (..., 6) [v, w]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2, theta = _theta(w)
    W = hat(w)
    W2 = W @ W
    small = theta2 < _SMALL2
    # V^-1 = I - W/2 + (1/theta^2)(1 - theta sin / (2(1-cos))) W^2
    denom = torch.clamp(2.0 * (1.0 - torch.cos(theta)), min=1e-12)
    coef = torch.where(
        small, 1.0 / 12.0 + true_div(theta2, 720.0),
        (1.0 - theta * torch.sin(theta) / denom) / theta2)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    Vinv = eye - 0.5 * W + coef * W2
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) transforms to (..., N, 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def rotate_vectors(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation of (..., 4, 4) T to (..., N, 3) vectors."""
    return vecs @ T[..., :3, :3].transpose(-1, -2)


def pose_error_weighted(T_a: torch.Tensor, T_b: torch.Tensor) -> torch.Tensor:
    """Drift between two poses of one frame, the online-correction error
    || se3(T_a^-1 T_b) ||_W with weight 1 on translation and 0.5 on
    rotation."""
    xi = se3_log(inv_T(T_a) @ T_b)
    v, w = xi[..., :3], xi[..., 3:]
    return torch.sqrt((v * v).sum(dim=-1) + 0.5 * (w * w).sum(dim=-1))


def pose_error_weighted_np(T_a, T_b) -> float:
    """`pose_error_weighted` in float64 numpy, for host-side gates."""
    Ta = np.asarray(T_a, np.float64)
    Tb = np.asarray(T_b, np.float64)
    D = np.linalg.inv(Ta) @ Tb
    R, t = D[:3, :3], D[:3, 3]
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = float(np.arccos(c))
    if theta < 1e-7:
        w = np.zeros(3)
        Vinv = np.eye(3)
    else:
        w = theta / (2.0 * np.sin(theta)) * np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                      [-w[1], w[0], 0]], dtype=np.float64)
        t2 = theta * theta
        coef = (1.0 - theta * np.sin(theta)
                / max(2.0 * (1.0 - np.cos(theta)), 1e-12)) / t2
        Vinv = np.eye(3) - 0.5 * W + coef * (W @ W)
    v = Vinv @ t
    return float(np.sqrt(v @ v + 0.5 * (w @ w)))


def project_to_so3(R: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalise a near-rotation matrix (nearest rotation, det +1)."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    one = torch.ones_like(det)
    d = torch.stack([one, one, det], dim=-1)
    return (u * d[..., None, :]) @ vt


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
    # numpy's rule, without torch's symbolic-shape machinery (about 2 ms a
    # call on the host, and make_T runs in every Gauss-Newton step)
    batch = np.broadcast_shapes(tuple(R.shape[:-2]), tuple(t.shape[:-1]))
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    # built on the device: a tensor made from a Python list is copied from
    # the host, and that copy waits for the card
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(
        batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


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
    acc = fma_twice(Rt[..., :, 1], t[..., None, 1], acc)
    acc = fma_twice(Rt[..., :, 2], t[..., None, 2], acc)
    return make_T(Rt, -acc)
