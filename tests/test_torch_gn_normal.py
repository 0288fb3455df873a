"""The stereo VO's Gauss-Newton step and the fusion's voxel projection in
jitted XLA:CPU's order, against jitted JAX, bit for bit.

Kernel GN's plain version (denseslam_tpu_torch/utils/numerics.py
`gn_normal`) against the einsums of denseslam_tpu/ops/ransac.py
`_gn_refine` jitted at the shapes of the main path and of the tier-1
tests: the hypotheses' batch (vmapped, 4N = 12), one system of 256
features (4N = 1024, b fused into a loop with the residuals) and one of
2048 (4N = 8192, two panels, XLA's GEMV emitter). Then the rest of the
step as jitted XLA:CPU computes it: the solve (ops/smallsolve.py, FMAs
and the simplified last unknown), glibc's sinf and cosf (utils/numerics.py)
and the update (utils/lie.py `se3_exp_apply`, two FMAs a Rodrigues sum).
Kernel PJ's plain version (ops/tsdf.py `fusion_geometry_plain`) against
`_fusion_geometry` inside a jitted `lax.scan`, as `process_sequence` runs
it. The JAX programs take every input as an argument: constants would be
folded by XLA's evaluator, which rounds otherwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import tiny_test_config
from denseslam_tpu.ops import ransac as jransac
from denseslam_tpu.ops import smallsolve as jss
from denseslam_tpu.ops import tsdf as jt
from denseslam_tpu.utils import lie as jlie
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.ops import ransac as pransac
from denseslam_tpu_torch.ops import smallsolve as pss
from denseslam_tpu_torch.ops import tsdf as pt
from denseslam_tpu_torch.utils import lie as plie
from denseslam_tpu_torch.utils import numerics


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits_equal(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


def _normal_equations(T, pts, obs_l, obs_r, w, rig):
    """J, r and the normal equations as JAX's `_gn_refine` forms them."""
    r, p = jransac._reproject_residuals(T, pts, obs_l, obs_r, rig)
    J = jransac._gn_jacobian(p, rig)
    JTw = J * w[:, None, None]
    return (jnp.einsum("nri,nrj->ij", JTw, J),
            jnp.einsum("nri,nr->i", JTw, r))


@pytest.mark.parametrize("batch,n", [(256, 3), (0, 256), (0, 2048)],
                         ids=["hypotheses-12", "refit-1024", "refit-8192"])
def test_gn_normal_equals_jitted_einsums(batch, n):
    """S from the residuals and Jacobian of random points seen from a
    pose near the identity, against the jitted einsums: the hypotheses
    vmapped (4N = 12), one system of 4N = 1024 (b fused with the
    residuals into one FMA chain) and 4N = 8192 (GEMV)."""
    cfg = tiny_test_config(width=160, height=120, baseline_m=0.537)
    rig = cfg.rig
    prig = convert.config_from_dict(dataclasses.asdict(cfg)).rig
    rng = np.random.default_rng(n)
    lead = (batch,) if batch else ()
    pts = np.stack([rng.uniform(-8, 8, lead + (n,)),
                    rng.uniform(-2, 2, lead + (n,)),
                    rng.uniform(2, 40, lead + (n,))], -1).astype(np.float32)
    obs_l = rng.uniform(0, 160, lead + (n, 2)).astype(np.float32)
    obs_r = rng.uniform(0, 160, lead + (n, 2)).astype(np.float32)
    w = rng.uniform(0.1, 2, lead + (n,)).astype(np.float32)
    T = np.asarray(jlie.se3_exp(jnp.array([0.05, -0.02, 0.4, 0.01, -0.02,
                                           0.005], jnp.float32)))
    fn = lambda *a: _normal_equations(*a, rig)  # noqa: E731
    if batch:
        fn = jax.vmap(fn, in_axes=(None, 0, 0, 0, 0))
    A, b = jax.jit(fn)(T, pts, obs_l, obs_r, w)
    Tp = torch.tensor(T).expand(lead + (4, 4))
    r, p = pransac._reproject_residuals(Tp, torch.tensor(pts),
                                        torch.tensor(obs_l),
                                        torch.tensor(obs_r), prig)
    J = pransac._gn_jacobian(p, prig)
    assert numerics.gn_fused_b(lead, n) == (not batch and 4 * n < 4096)
    S = numerics.gn_normal(J.contiguous(), r.contiguous(), torch.tensor(w))
    _bits_equal(A, S[..., :6].numpy())
    _bits_equal(b, S[..., 6].numpy())


def _spd(rng, batch):
    M = rng.normal(size=(batch, 24, 6)).astype(np.float32)
    A = np.einsum("bki,bkj->bij", M, M).astype(np.float32)
    return A, (rng.normal(size=(batch, 6)) * 100).astype(np.float32)


def test_solve_spd6_equals_jitted_jax():
    """The solve vmapped over 256 systems and alone."""
    rng = np.random.default_rng(6)
    A, b = _spd(rng, 256)
    _bits_equal(jax.jit(jax.vmap(jss.solve_spd6))(A, b),
                pss.solve_spd6(torch.tensor(A), torch.tensor(b)).numpy())
    for k in range(8):
        _bits_equal(jax.jit(jss.solve_spd6)(A[k], b[k]),
                    pss.solve_spd6(torch.tensor(A[k]),
                                   torch.tensor(b[k])).numpy())


@pytest.mark.parametrize("form", ["shared", "batched", "one"])
def test_gn_update_equals_the_jitted_step(form):
    """Kernel GU's plain version (ops/ransac.py `gn_update_plain`) against
    the rest of JAX's Gauss-Newton body, jitted: the damping, the solve,
    the clip and exp(xi) T, vmapped over 256 systems from one shared pose
    (the hypotheses' first step) or a pose each, and for one system. The
    right-hand sides span steps in the small-angle branch, about 0 and in
    the reduced range of sin and cos, and the clip."""
    rng = np.random.default_rng(11)
    A, b = _spd(rng, 256)
    b = (b * np.array([1e-6, 1e-3, 0.1, 1.0])[np.arange(256) % 4, None]
         ).astype(np.float32)
    xi = np.clip(-np.linalg.solve(A.astype(np.float64), b[..., None])[..., 0],
                 -0.5, 0.5)
    theta = np.linalg.norm(xi[:, 3:], axis=1)
    assert (theta < 1e-2).any() and (theta > 0.8).any()
    assert ((theta > 0.05) & (theta < 0.75)).any()
    assert (np.abs(xi) == 0.5).any()
    T = np.stack([np.asarray(jlie.se3_exp(jnp.asarray(
        rng.normal(size=6).astype(np.float32) * 0.3))) for _ in range(256)])

    def step(A, b, T):
        damp = 1e-6 * jnp.trace(A) + 1e-9
        xi = -jss.solve_spd6(A + damp * jnp.eye(6, dtype=A.dtype), b)
        return jlie.se3_exp(jnp.clip(xi, -0.5, 0.5)) @ T

    S = torch.tensor(np.concatenate([A, b[..., None]], -1))
    if form == "shared":
        want = jax.jit(jax.vmap(step, in_axes=(0, 0, None)))(A, b, T[0])
        got = pransac.gn_update_plain(
            S, torch.tensor(T[0]).expand(256, 4, 4), shared=True)
    elif form == "batched":
        want = jax.jit(jax.vmap(step))(A, b, T)
        got = pransac.gn_update_plain(S, torch.tensor(T))
    else:
        want = np.stack([jax.jit(step)(A[k], b[k], T[k]) for k in range(8)])
        got = torch.stack([pransac.gn_update_plain(S[k], torch.tensor(T[k]))
                           for k in range(8)])
    _bits_equal(want, got.numpy())


def test_sinf_cosf_equal_jitted_jax():
    """sin and cos over the update's angles, the reduced range and small
    arguments: glibc's, as the jitted program calls it."""
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.uniform(-0.9, 0.9, 20000),
                        rng.uniform(-110, 110, 20000),
                        rng.uniform(-1e-3, 1e-3, 2000),
                        [0.0, 0.75, -0.75, 2.0 ** -12, 0.7853982]]
                       ).astype(np.float32)
    sin, cos = numerics.sincosf(torch.tensor(x))
    _bits_equal(jax.jit(jnp.sin)(x), sin.numpy())
    _bits_equal(jax.jit(jnp.cos)(x), cos.numpy())


def test_se3_exp_apply_equals_jitted_jax():
    """exp(xi) T of one system (the refit's update), over steps of every
    size the clip lets through and the small-angle branch. Vmapped, the
    sum |w|^2 is rounded as the program's vectorization has it (its
    vector body and its scalar rest apart); the hypotheses' batch is held
    inside `_gn_refine` (tests/test_torch_vo_order.py)."""
    rng = np.random.default_rng(8)
    xi = rng.uniform(-0.5, 0.5, (48, 6)).astype(np.float32)
    xi[:16, 3:] *= 1e-4                    # the small-angle branch
    step = jax.jit(lambda a, b: jlie.se3_exp(a) @ b)
    for k in range(len(xi)):
        T = np.asarray(jlie.se3_exp(jnp.asarray(
            rng.normal(size=6).astype(np.float32) * 0.3)))
        _bits_equal(step(xi[k], T), plie.se3_exp_apply(
            torch.tensor(xi[k]), torch.tensor(T)).numpy())


def test_fusion_geometry_equals_the_scans_projection():
    """u, v, z of every visible voxel: the plain version against JAX's
    `_fusion_geometry` in a jitted `lax.scan` over three poses, on a map
    allocated by a rendered frame (160x120, 6 cm voxels)."""
    from denseslam_tpu.io import synthetic as js

    cfg = tiny_test_config(width=160, height=120)
    cfg = dataclasses.replace(cfg, tsdf=dataclasses.replace(
        cfg.tsdf, voxel_size_m=0.06))
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    intr, tc = cfg.rig.intr, cfg.tsdf
    poses = np.asarray(js.make_trajectory(4, step_m=0.3, yaw_rate=0.02),
                       np.float32)
    _, depths = js.render_trajectory(poses[:1], intr)
    m, s, k = jt.allocate_for_frame(jt.make_map(tc), jnp.asarray(depths[0]),
                                    jnp.asarray(poses[0]), intr, tc)

    def body(carry, T):
        u, v, z, _ = jt._fusion_geometry(m, s, k, T, intr, tc)
        return carry, (u, v, z)

    _, (u, v, z) = jax.jit(lambda Ts: jax.lax.scan(body, 0, Ts))(
        jnp.asarray(poses[1:]))
    pm = convert.map_state_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(m)], device="cpu")
    slots, mask = torch.tensor(np.asarray(s)), torch.tensor(np.asarray(k))
    assert int(mask.sum()) > 100
    for f in range(3):
        got = pt._fusion_geometry(pm, slots, mask, torch.tensor(poses[f + 1]),
                                  pcfg.rig.intr, pcfg.tsdf)
        for want, g in zip((u[f], v[f], z[f]), got[:3]):
            _bits_equal(want, g.numpy())
