"""ops/ransac.py, ops/smallsolve.py and the new utils/lie.py helpers of
the port vs the JAX package. The JAX side runs jitted.

Tolerances, and why:
  * solve_spd6 / inv3x3 / solve3x3: rtol 1e-5 — the same unrolled
    programs, but XLA contracts their multiply-adds into FMAs.
  * so3_exp / se3_exp / transform_points: atol 1e-6 (sin, cos and the 3x3
    products round differently).
  * estimate_stereo_motion, given the JAX hypothesis draws: T_delta within
    1e-5, inlier sets and counts equal. The K hypotheses run as one batch
    in the port, as JAX's vmap runs them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import tiny_test_config
from denseslam_tpu.ops import matching as jm
from denseslam_tpu.ops import ransac as jr
from denseslam_tpu.ops import smallsolve as jss
from denseslam_tpu.utils import lie as jl
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.ops import matching as pm
from denseslam_tpu_torch.ops import ransac as pr
from denseslam_tpu_torch.ops import smallsolve as pss
from denseslam_tpu_torch.utils import lie as pl


def test_solve_spd6_matches_jax():
    rng = np.random.default_rng(0)
    J = rng.normal(size=(32, 20, 6)).astype(np.float32)
    A = np.einsum("kni,knj->kij", J, J) + 1e-3 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(32, 6)).astype(np.float32)
    want = np.asarray(jax.jit(jss.solve_spd6)(jnp.asarray(A), jnp.asarray(b)))
    got = pss.solve_spd6(torch.tensor(A), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    oracle = np.linalg.solve(A.astype(np.float64), b[..., None])[..., 0]
    np.testing.assert_allclose(got, oracle, rtol=1e-3, atol=1e-4)


def test_inv3x3_and_solve3x3_match_jax():
    rng = np.random.default_rng(1)
    A = (rng.normal(size=(16, 3, 3)) + 3 * np.eye(3)).astype(np.float32)
    A[0] = 0.0                                     # singular: guarded det
    b = rng.normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        pss.inv3x3(torch.tensor(A)).numpy()[1:],
        np.asarray(jax.jit(jss.inv3x3)(jnp.asarray(A)))[1:], rtol=1e-5)
    np.testing.assert_allclose(
        pss.solve3x3(torch.tensor(A), torch.tensor(b)).numpy()[1:],
        np.asarray(jax.jit(jss.solve3x3)(jnp.asarray(A), jnp.asarray(b)))[1:],
        rtol=1e-5, atol=1e-6)
    assert np.isfinite(pss.inv3x3(torch.tensor(A)).numpy()).all()


@pytest.mark.parametrize("scale", [1e-3, 0.5])     # Taylor / closed form
def test_lie_exp_and_transform_match_jax(scale):
    rng = np.random.default_rng(2)
    xi = (scale * rng.normal(size=(8, 6))).astype(np.float32)
    np.testing.assert_allclose(
        pl.se3_exp(torch.tensor(xi)).numpy(),
        np.asarray(jax.jit(jl.se3_exp)(jnp.asarray(xi))), atol=1e-6)
    np.testing.assert_allclose(
        pl.so3_exp(torch.tensor(xi[:, 3:])).numpy(),
        np.asarray(jax.jit(jl.so3_exp)(jnp.asarray(xi[:, 3:]))), atol=1e-6)
    np.testing.assert_array_equal(pl.hat(torch.tensor(xi[:, :3])).numpy(),
                                  np.asarray(jl.hat(jnp.asarray(xi[:, :3]))))
    T = np.asarray(jl.se3_exp(jnp.asarray(xi)))
    pts = rng.normal(size=(8, 30, 3)).astype(np.float32)
    np.testing.assert_allclose(
        pl.transform_points(torch.tensor(T), torch.tensor(pts)).numpy(),
        np.asarray(jax.jit(jl.transform_points)(jnp.asarray(T),
                                                jnp.asarray(pts))),
        atol=1e-6)


def _quads(rng, cfg, T_delta, n=200, n_bad=40):
    """Stereo quads of random points seen before and after T_delta, with
    0.3 px noise, 40 gross outliers and 20 invalid rows."""
    intr, b = cfg.rig.intr, cfg.rig.baseline_m
    P = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 20, n)], -1)
    Q = P @ T_delta[:3, :3].T + T_delta[:3, 3]

    def proj(X, dx):
        return np.stack([(X[:, 0] - dx) / X[:, 2] * intr.fx + intr.cx,
                         X[:, 1] / X[:, 2] * intr.fy + intr.cy], -1)

    noise = lambda: rng.normal(0, 0.3, (n, 2))  # noqa: E731
    uv = [proj(P, 0) + noise(), proj(P, b) + noise(), proj(Q, 0) + noise(),
          proj(Q, b) + noise()]
    uv[2][:n_bad] += rng.uniform(-30, 30, (n_bad, 2))
    valid = np.ones(n, bool)
    valid[-20:] = False
    idx = np.arange(n, dtype=np.int32)
    uv_lp, uv_rp, uv_lc, uv_rc = (a.astype(np.float32) for a in uv)
    return [idx, idx, idx, idx, uv_lc, uv_rc, uv_lp, uv_rp, valid]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread each spares the other test processes of a parallel run
    the oversubscribed cores (the exact FMAs' float64 passes are memory
    bound)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def motion():
    """The configuration and the JAX solver, jitted once for the module."""
    cfg = tiny_test_config(width=320, height=240, baseline_m=0.537)
    cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, ransac_iters=32))
    solve = jax.jit(lambda q, k, T: jr.estimate_stereo_motion(
        q, cfg.rig, cfg.frontend, k, T_init=T))
    return cfg, convert.config_from_dict(dataclasses.asdict(cfg)), solve


@pytest.mark.parametrize("seed", [0, 1])
def test_estimate_stereo_motion_with_jax_draws(motion, seed):
    cfg, pcfg, solve = motion
    rng = np.random.default_rng(seed)
    xi = np.array([0.02, -0.01, 0.3, 0.002, 0.01, -0.003], np.float32)
    T_gt = np.asarray(jl.se3_exp(jnp.asarray(xi)))
    q = _quads(rng, cfg, T_gt)
    key = jax.random.PRNGKey(seed)
    T_init = np.asarray(jl.se3_exp(jnp.asarray(0.5 * xi)))
    want = solve(jm.QuadMatches(*map(jnp.asarray, q)), key,
                 jnp.asarray(T_init))
    raw = np.asarray(jax.random.randint(key, (32, 3), 0,
                                        jnp.iinfo(jnp.int32).max))
    got = pr.estimate_stereo_motion(
        pm.QuadMatches(*map(torch.tensor, q)), pcfg.rig, pcfg.frontend,
        raw=torch.tensor(raw), T_init=torch.tensor(T_init))
    assert bool(got.ok) and bool(want.ok)
    np.testing.assert_array_equal(np.asarray(want.inliers),
                                  got.inliers.numpy())
    assert int(want.num_inliers) == int(got.num_inliers) > 100
    np.testing.assert_allclose(got.T_delta.numpy(), np.asarray(want.T_delta),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.T_delta.numpy(), T_gt, atol=2e-2)


def test_estimate_stereo_motion_draws_from_a_generator():
    """The port draws the hypotheses from the caller's threefry key as
    jax.random.randint draws them from the same key (the draws equal bit
    for bit, so the solutions do); the draws are a required argument."""
    from denseslam_tpu_torch.utils import threefry
    cfg = convert.config_from_dict(dataclasses.asdict(
        tiny_test_config(width=320, height=240, baseline_m=0.537)))
    cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, ransac_iters=16))
    xi = torch.tensor([0.0, 0.0, 0.3, 0.0, 0.01, 0.0])
    q = pm.QuadMatches(*map(torch.tensor, _quads(
        np.random.default_rng(5), cfg, pl.se3_exp(xi).numpy())))
    raw = np.asarray(jax.random.randint(jax.random.PRNGKey(7), (16, 3), 0,
                                        jnp.iinfo(jnp.int32).max))
    drawn = pr.draw_hypotheses(threefry.prng_key(7), 16)
    np.testing.assert_array_equal(drawn.numpy(), raw)
    a = pr.estimate_stereo_motion(q, cfg.rig, cfg.frontend, raw=drawn)
    b = pr.estimate_stereo_motion(q, cfg.rig, cfg.frontend,
                                  raw=torch.tensor(raw))
    assert bool(a.ok) and torch.equal(a.T_delta, b.T_delta)
    with pytest.raises(TypeError, match="raw"):
        pr.estimate_stereo_motion(q, cfg.rig, cfg.frontend)
