"""The SE(3) helpers the dense-mapping slice needs (port of part of
denseslam_tpu/utils/lie.py). Poses are row-major float32 4x4 matrices."""

from __future__ import annotations

import numpy as np
import torch


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
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(batch + (1, 4))
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
