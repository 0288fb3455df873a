"""The monocular ops of the port vs the JAX package (split from
tests/test_torch_mono.py, whose module fixtures these do not use): every
function of ops/mono.py on a synthetic two-view problem with JAX's draws,
and `DenseSLAM.process_frame` in mono mode at 320x240.

Tolerances, and why (as in tests/test_torch_mono.py): normalisation,
Sampson distances, triangulated depths and the ground-plane scale equal
bit for bit (JAX run op by op); E of each 8-point hypothesis equal to
JAX's up to its sign within 1e-6 / s8, s8 the 8x9 system's smallest
singular value (the float32 nullspace moves by about eps / s8; 5.8e-8 /
s8 observed), on the hypotheses with s8 > 1e-6 (a repeated draw makes the
nullspace 2-D, and either SVD may pick any vector of it); the chosen
motion within 1e-4 (its E carries the same eps / s8: 1.3e-5 observed on
the unit translation), its inlier set and count equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import tiny_test_config
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.ops import mono as jm
from denseslam_tpu.utils import lie as jl
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.ops import mono as pm
from test_torch_mono import K, _config, _port_config, one_torch_thread  # noqa: F401


def _two_views(seed, noise_px, outlier_frac, intr, ground=False):
    """Random points seen from the identity and from T_gt (p_c = T_gt p_p),
    with pixel noise and gross outliers; with `ground`, half of them on the
    ground plane 1.2 m below the camera and the motion forward."""
    rng = np.random.default_rng(seed)
    n = 240
    if ground:
        pts = np.concatenate([
            np.stack([rng.uniform(-3, 3, n // 2), np.full(n // 2, 1.2),
                      rng.uniform(2.5, 9.0, n // 2)], -1),
            rng.uniform([-3, -2, 2.5], [3, 0.5, 9.0], (n - n // 2, 3))])
        T_gt = np.eye(4, dtype=np.float32)
        T_gt[2, 3] = -0.3
    else:
        pts = rng.uniform([-3, -2, 2.0], [3, 2, 10.0], (n, 3))
        T_gt = np.asarray(jl.se3_exp(jnp.asarray(
            [0.15, 0.0, 0.25, 0.0, 0.02, 0.0], jnp.float32)))
    pts = pts.astype(np.float32)

    def proj(T):
        pc = pts @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([pc[:, 0] / pc[:, 2] * intr.fx + intr.cx,
                       pc[:, 1] / pc[:, 2] * intr.fy + intr.cy], -1)
        return uv.astype(np.float32), pc[:, 2]

    uv_p, zp = proj(np.eye(4, dtype=np.float32))
    uv_c, zc = proj(T_gt)
    uv_p += rng.normal(0, noise_px, uv_p.shape).astype(np.float32)
    uv_c += rng.normal(0, noise_px, uv_c.shape).astype(np.float32)
    n_out = int(outlier_frac * n)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        uv_c[idx] += rng.uniform(20, 80, (n_out, 2)).astype(np.float32)
    return uv_p, uv_c, (zp > 0.1) & (zc > 0.1)



CASES = {"clean": (0, 0.0, 0.0, False), "noisy": (1, 0.3, 0.15, False),
         "ground": (2, 0.2, 0.0, True), "degenerate": (3, 0.0, 0.0, False)}



@pytest.mark.parametrize("case", sorted(CASES))
def test_mono_functions_match_jax_with_its_draws(case):
    seed, noise, outliers, ground = CASES[case]
    cfg = _config(ransac_iters=128)
    pcfg = _port_config(cfg)
    intr, pintr = cfg.rig.intr, pcfg.rig.intr
    uv_p, uv_c, ok = _two_views(seed, noise, outliers, intr, ground)
    if case == "degenerate":
        ok[:] = False
    key = jax.random.PRNGKey(seed)
    raw = np.asarray(jax.random.randint(key, (128, 8), 0,
                                        jnp.iinfo(jnp.int32).max))
    ju, jc, jok = jnp.asarray(uv_p), jnp.asarray(uv_c), jnp.asarray(ok)
    tu, tc, tok = torch.tensor(uv_p), torch.tensor(uv_c), torch.tensor(ok)

    want = jm.estimate_mono_motion(ju, jc, jok, intr, cfg.frontend, key)
    got = pm.estimate_mono_motion(tu, tc, tok, pintr, pcfg.frontend,
                                  raw=torch.tensor(raw))
    assert bool(got.ok) == bool(want.ok) == (case != "degenerate")
    assert int(got.num_inliers) == int(want.num_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    np.testing.assert_allclose(got.T_delta.numpy(), np.asarray(want.T_delta),
                               rtol=0, atol=1e-4)
    if case == "degenerate":
        np.testing.assert_array_equal(got.T_delta.numpy(), np.eye(4))
        return

    # the parts, op by op
    xp, yp = jm._normalize(ju, intr)
    xc, yc = jm._normalize(jc, intr)
    pxp, pyp = pm._normalize(tu, pintr)
    pxc, pyc = pm._normalize(tc, pintr)
    for a, b in ((xp, pxp), (yp, pyp), (xc, pxc), (yc, pyc)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    sel = np.argsort(~ok, kind="stable")[raw % max(int(ok.sum()), 8)]
    # the 8x9 systems' smallest singular values s8 (float64): the float32
    # nullspace moves by about eps / s8, and a repeated draw makes s8 0
    a = np.stack([np.asarray(v)[sel] for v in (xp, yp, xc, yc)], -1)
    a = np.stack([a[..., 2] * a[..., 0], a[..., 2] * a[..., 1], a[..., 2],
                  a[..., 3] * a[..., 0], a[..., 3] * a[..., 1], a[..., 3],
                  a[..., 0], a[..., 1], np.ones_like(a[..., 0])], -1)
    s8 = np.linalg.svd(a.astype(np.float64), compute_uv=False)[:, 7]
    posed = s8 > 1e-6
    assert posed.sum() > 64
    s = sel[posed]
    E_j = np.asarray(jax.vmap(jm._eight_point)(xp[s], yp[s], xc[s], yc[s]))
    s = torch.tensor(s)
    E_p = pm._eight_point(pxp[s], pyp[s], pxc[s], pyc[s]).numpy()
    sign = np.sign((E_j * E_p).sum(axis=(1, 2)))[:, None, None]
    err = np.abs(sign * E_p - E_j).max(axis=(1, 2))
    assert (err * s8[posed]).max() <= 1e-6
    d_j = np.asarray(jax.vmap(lambda E: jm._sampson(E, xp, yp, xc, yc))(
        jnp.asarray(E_j)))
    np.testing.assert_array_equal(
        pm._sampson(torch.tensor(E_j), pxp, pyp, pxc, pyc).numpy(), d_j)
    T = np.asarray(want.T_delta)
    zj = jm._triangulate_depths(jnp.asarray(T[:3, :3]), jnp.asarray(T[:3, 3]),
                                xp, yp, xc, yc)
    zp = pm._triangulate_depths(torch.tensor(T[:3, :3]),
                                torch.tensor(T[:3, 3]), pxp, pyp, pxc, pyc)
    for a, b in zip(zj, zp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    for pitch in (0.05, 0.0):
        sj = jm.estimate_scale_ground(want.T_delta, ju, jc, want.inliers,
                                      intr, 1.2, pitch)
        sp = pm.estimate_scale_ground(torch.tensor(T), tu, tc,
                                      torch.tensor(np.asarray(want.inliers)),
                                      pintr, 1.2, pitch)
        assert float(sp.scale) == float(sj.scale)
        assert int(sp.num_ground) == int(sj.num_ground)
        assert bool(sp.ok) == bool(sj.ok)
    if ground:      # the level camera's true scale, as tests/test_mono.py
        assert bool(sp.ok) and abs(float(sp.scale) - 0.3) < 0.03
    np.testing.assert_array_equal(
        pm.apply_scale(torch.tensor(T), sp.scale).numpy(),
        np.asarray(jm.apply_scale(want.T_delta, sj.scale)))



def test_dense_slam_mono_process_frame():
    """tests/test_mono.py `test_mono_pipeline_mode` on the port: frames
    without depth only track, a frame with supplied depth fuses."""
    cfg = dataclasses.replace(
        tiny_test_config(width=320, height=240),
        pipeline=dataclasses.replace(tiny_test_config().pipeline,
                                     sensor="mono", fusion_db_capacity=4))
    cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, camera_height_m=1.2, ransac_iters=K))
    pcfg = _port_config(cfg)
    poses = js.make_trajectory(4, step_m=0.2, yaw_rate=0.0)
    grays, depths = (np.asarray(a) for a in js.render_trajectory(
        poses, cfg.rig.intr))
    slam = pd.DenseSLAM(pcfg, device="cpu", seed=0)
    out0 = slam.process_frame(torch.tensor(grays[0]))
    assert not out0["fused"] and out0["num_blocks"] == 0
    out1 = slam.process_frame(torch.tensor(grays[1]))
    assert not out1["fused"] and out1["tracking_ok"]
    out2 = slam.process_frame(torch.tensor(grays[2]),
                              depth=torch.tensor(depths[2]))
    assert out2["fused"] and out2["num_blocks"] > 0
    assert out2["num_inliers"] >= 12
    with pytest.raises(ValueError, match="raw draws"):
        slam.process_frame(torch.tensor(grays[3]),
                           draws=torch.zeros((K, 3), dtype=torch.int64))

