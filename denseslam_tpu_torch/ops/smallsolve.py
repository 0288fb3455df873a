"""Small fixed-size linear solves as unrolled elementwise programs (port of
denseslam_tpu/ops/smallsolve.py).

The same unrolled Cholesky / adjugate forms as the JAX version, in the
same op order, batched over leading dimensions, so the solves agree with
the reference to float32 rounding (tests/test_torch_ransac.py)."""

from __future__ import annotations

import torch

from ..utils.numerics import fma, sqrt


def solve_spd6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 symmetric-positive-definite solve via unrolled Cholesky.

    A: (..., 6, 6) SPD (GN normal equations + damping), b: (..., 6).

    Every entry is formed by the JAX version's operations in its order,
    rounded as jitted XLA:CPU rounds them: it contracts each
    `s - L[i][k] * L[j][k]` (and `s - L * y`, `s - L * x`) into one FMA
    (read from `tests/_torch_golden.py --dump`: `vfnmadd` in the solve's
    fusions), here `fma` (rounded once, alike on every device), and its
    simplifier turns the last unknown, x5 = (s5 / L55) / L55 with
    L55 = sqrt(max(m, 1e-20)), into s5 / max(m, 1e-20), which the other
    unknowns then use. The ops
    that are independent of each other run together: a column of L is one
    tensor (its diagonal entry and the entries below it take the same
    subtractions), and the forward substitution subtracts each solved y_k
    from all later rows at once (each row still subtracts in k order).
    That keeps the bits and launches about half the kernels."""
    n = 6
    low = []                            # low[k]: L[k+1:, k], (..., 5 - k)
    diag = []                           # L[k][k], (...,)
    for j in range(n):
        v = A[..., j:, j]               # rows j.. of column j
        for k in range(j):
            lk = low[k][..., j - k - 1:]             # L[j:, k]
            v = fma(-lk, lk[..., :1], v)             # - L[i][k] * L[j][k]
        m = torch.clamp(v[..., 0], min=1e-20)
        d = sqrt(m)                                  # correctly rounded
        diag.append(d)
        low.append(v[..., 1:] * torch.reciprocal(d)[..., None])
    y = [None] * n                      # forward: L y = b
    s = b
    for k in range(n - 1):
        y[k] = s[..., 0] / diag[k]
        s = fma(-low[k], y[k][..., None], s[..., 1:])
    x = [None] * n                      # backward: L^T x = y
    x[n - 1] = s[..., 0] / m            # (s5 / L55) / L55, simplified
    for i2 in reversed(range(n - 1)):
        s = y[i2]
        for k in range(i2 + 1, n):
            s = fma(-low[i2][..., k - i2 - 1], x[k], s)
        x[i2] = s / diag[i2]
    return torch.stack(x, dim=-1)


def inv3x3(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / determinant); a
    near-singular determinant is replaced by eps."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    det = torch.where(det.abs() < eps, torch.full_like(det, eps), det)
    inv = torch.stack([
        torch.stack([c00, c01, c02], dim=-1),
        torch.stack([c10, c11, c12], dim=-1),
        torch.stack([c20, c21, c22], dim=-1),
    ], dim=-2)
    return inv / det[..., None, None]


def solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve via the closed-form inverse. A: (..., 3, 3),
    b: (..., 3). The product is written out, left to right, so that the
    card and the CPU sum it alike (an einsum goes to cuBLAS or the CPU's
    BLAS, which sum in other orders)."""
    inv = inv3x3(A)
    return (inv[..., 0] * b[..., 0, None] + inv[..., 1] * b[..., 1, None]
            + inv[..., 2] * b[..., 2, None])
