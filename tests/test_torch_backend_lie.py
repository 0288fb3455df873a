"""The port's Lie helpers (utils/lie.py) and pose-graph edge Jacobians
(ops/posegraph.py `edge_terms`) against the JAX package on the CPU, from
the same numpy inputs (split from tests/test_torch_backend.py, whose
module fixture these do not use).

Tolerances, and why:
  * lie functions: atol 1e-6 (f32 transcendental and matmul rounding).
  * pose-graph Jacobians against `jax.jacfwd` at rotation angles 0, 1e-4
    and 1: atol 1e-5 (observed 2.4e-7); all finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.ops import posegraph as jpg
from denseslam_tpu.utils import lie as jl
from denseslam_tpu_torch.ops import posegraph as ppg
from denseslam_tpu_torch.utils import lie as pl


def _t(a):
    return torch.tensor(np.asarray(a))


def _rand_poses(rng, n, rot=1.0):
    xi = np.concatenate([rng.normal(0, 1, (n, 3)),
                         rng.normal(0, rot, (n, 3))], 1)
    return np.stack([jl.se3_exp_np(x) for x in xi])



def _skew(T, U):
    R = T[:, :3, :3]
    return (R - R.swapaxes(-1, -2),)



# function -> its numpy arguments built from two pose stacks T, U
LIE = {
    "vee": _skew,
    "so3_log": lambda T, U: (T[:, :3, :3],),
    "se3_log": lambda T, U: (T,),
    "rotate_vectors": lambda T, U: (T, U[:, :, :3].copy()),
    "pose_error_weighted": lambda T, U: (T, U),
    "project_to_so3": lambda T, U: (T[:, :3, :3] * 1.01,),
}



@pytest.mark.parametrize("name", sorted(LIE))
def test_lie_matches_jax(name):
    rng = np.random.default_rng(1)
    T = _rand_poses(rng, 16)
    T[0] = np.eye(4, dtype=np.float32)
    T[1] = jl.se3_exp_np([0.1, 0, 0, 1e-4, 0, 0])
    T[2] = jl.se3_exp_np([0, 0, 0, 0, 3.05, 0])       # near pi
    args = LIE[name](T, _rand_poses(rng, 16, rot=0.1))
    want = np.asarray(getattr(jl, name)(*(jnp.asarray(a) for a in args)))
    got = getattr(pl, name)(*(_t(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)



def test_pose_error_weighted_np_matches_jax():
    rng = np.random.default_rng(2)
    A, B = _rand_poses(rng, 8, 0.3), _rand_poses(rng, 8, 0.3)
    B[0] = A[0]
    for a, b in zip(A, B):
        assert pl.pose_error_weighted_np(a, b) == jl.pose_error_weighted_np(a, b)



def _edge_terms(a, b, m):
    zero6 = jnp.zeros((6,), jnp.float32)
    f_i = lambda x: jpg._edge_residual(x, zero6, a, b, m)  # noqa: E731
    f_j = lambda x: jpg._edge_residual(zero6, x, a, b, m)  # noqa: E731
    return f_i(zero6), jax.jacfwd(f_i)(zero6), jax.jacfwd(f_j)(zero6)



# one program for every case (a function made inside a case compiles anew)
_jax_edge_terms = jax.jit(jax.vmap(_edge_terms))



@pytest.mark.parametrize("angle", [0.0, 1e-4, 1.0])
def test_posegraph_jacobian_matches_jacfwd(angle):
    """Edge residual Jacobians from the port's one forward-mode pass
    against jax.jacfwd, on edges whose measured relative rotation has the
    given angle and whose current estimate is off it by a small twist."""
    rng = np.random.default_rng(3)
    e = 6
    axis = rng.normal(size=(e, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    Ti = _rand_poses(rng, e)
    Tm = np.stack([jl.se3_exp_np(np.r_[rng.normal(0, 0.5, 3), angle * a])
                   for a in axis])
    noise = np.stack([jl.se3_exp_np(np.r_[rng.normal(0, 1e-3, 3),
                                          rng.normal(0, 1e-4, 3)])
                      for _ in range(e)])
    noise[0] = np.eye(4)                  # one edge exactly at its measurement
    Tj = (Ti.astype(np.float64) @ Tm @ noise).astype(np.float32)
    want = _jax_edge_terms(Ti, Tj, Tm)
    got = ppg.edge_terms(_t(Ti), _t(Tj), _t(Tm))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)

