"""The stereo VO of the port (ops/matching.py stereo half, models/frontend.py
`vo_step`) vs the JAX package at 160x120.

Frames: the synthetic street as a rectified stereo pair under the stereo
drive's nuisance of scripts/long_drive_eval.py (gain 1 + 0.15 sin(2 pi t /
150), photometric noise 2.0 on each image), drawn with numpy. The JAX side
runs jitted; the matching ops are given JAX's features (as numpy), and the
RANSAC draws of `vo_step` are the ones JAX's key gives each frame.
Tolerances, and why:
  * match_stereo, quad_match: >= 99% of rows agree (100% on these frames).
    The descriptor cost matrices are float32 matmuls that XLA:CPU and
    torch sum in another order, so a near-tie argmin may pick the other
    neighbour. stereo_disparities given the same match: exact.
  * estimate_gain: bit for bit (the port adds the two sums over the
    matches in XLA:CPU's order, ops/matching.py `xla_sum`).
  * refine_quad_subpix, both modes: atol 1e-3 px, as refine_temporal_subpix
    (ZSSD sums and bilinear weights; XLA contracts FMAs).
  * vo_step per frame from JAX's state: poses within 1e-4 m (translation)
    and 1e-5 (rotation entries), as the RGB-D step; inliers, tracking and
    the prior flag equal; features exact but the descriptors, within 1e-6
    (jitted XLA contracts the Sobel taps into FMAs); disparities, images
    and the exposure within rtol 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import tiny_test_config
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.models import frontend as jfe
from denseslam_tpu.ops import features as jf
from denseslam_tpu.ops import matching as jm
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import frontend as pfe
from denseslam_tpu_torch.ops import matching as pm

W, H = 160, 120
N = 4
K = 32


def _config():
    cfg = tiny_test_config(width=W, height=H, baseline_m=0.537)
    return dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, max_features=256, ransac_iters=K, bucket_w=25,
        bucket_h=25))


def stereo_frames(cfg, n, rng):
    """n street frames along make_trajectory(n, 0.25, 0.003) as stereo
    pairs, with the stereo drive's gain ramp and photometric noise."""
    poses = js.make_trajectory(n, step_m=0.25, yaw_rate=0.003)
    lefts, rights, _ = js.render_stereo_trajectory(poses, cfg.rig,
                                                   js.street_scene())
    gain = 1.0 + 0.15 * np.sin(2 * np.pi * np.arange(n) / 150.0)

    def nuisance(g):
        g = np.asarray(g) * gain[:, None, None]
        return np.clip(g + 2.0 * rng.normal(size=g.shape), 0,
                       255).astype(np.float32)

    return poses, nuisance(lefts), nuisance(rights)


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
def ref():
    cfg = _config()
    poses, lefts, rights = stereo_frames(cfg, N, np.random.default_rng(0))
    fc = cfg.frontend
    det_l = jax.jit(lambda x: jf.bucket(jf.detect(x, fc), W, H, fc))
    det_r = jax.jit(lambda x: jf.detect(x, fc))
    feats = [([np.asarray(a) for a in det_l(jnp.asarray(lefts[i]))],
              [np.asarray(a) for a in det_r(jnp.asarray(rights[i]))])
             for i in (0, 1)]
    sd = jax.jit(lambda a, b: jm.stereo_disparities(a, b, fc))
    disp0 = [np.asarray(x) for x in sd(*(_jf(f) for f in feats[0]))]
    return dict(cfg=cfg, pcfg=convert.config_from_dict(dataclasses.asdict(cfg)),
                poses=poses, lefts=lefts, rights=rights, feats=feats,
                disp0=disp0, stereo_disparities=sd, quads={},
                T_pred=(np.linalg.inv(poses[1]) @ poses[0]).astype(np.float32))


def _jf(leaves):
    return jf.Features(*map(jnp.asarray, leaves))


def _pf(leaves):
    return convert.features_from_numpy(leaves, device="cpu")


def _agree(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


def test_match_stereo_and_disparities(ref):
    fc = ref["cfg"].frontend
    fl, fr = ref["feats"][1]
    want = np.asarray(jax.jit(lambda a, b: jm.match_stereo(a, b, fc))(
        _jf(fl), _jf(fr)))
    got = pm.match_stereo(_pf(fl), _pf(fr), ref["pcfg"].frontend).numpy()
    assert (got >= 0).sum() > 50
    assert _agree(want, got) >= 0.99
    dj = ref["stereo_disparities"](_jf(fl), _jf(fr))
    dp = pm.stereo_disparities(_pf(fl), _pf(fr), torch.tensor(want))
    for a, b in zip(dj, dp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (dp[1] > 0).sum() == (dp[0] > 0).sum() > 50


def _quads(ref, prior):
    """JAX's and the port's quad_match of frame 1 against frame 0, made
    once a module for each `prior` (the tests below only read them)."""
    if prior not in ref["quads"]:
        ref["quads"][prior] = _make_quads(ref, prior)
    return ref["quads"][prior]


def _make_quads(ref, prior):
    cfg, fc = ref["cfg"], ref["cfg"].frontend
    (fl0, fr0), (fl1, fr1) = ref["feats"]
    if prior:
        extra = (ref["disp0"][0], ref["disp0"][1], ref["T_pred"])
        qj = jax.jit(lambda a, b, c, d, x, y, T: jm.quad_match(
            a, b, c, d, fc, x, y, T, cfg.rig))(
                *map(_jf, (fl1, fr1, fl0, fr0)), *map(jnp.asarray, extra))
        qp = pm.quad_match(*map(_pf, (fl1, fr1, fl0, fr0)),
                           ref["pcfg"].frontend,
                           *map(torch.tensor, extra), rig=ref["pcfg"].rig)
    else:
        qj = jax.jit(lambda a, b, c, d: jm.quad_match(a, b, c, d, fc))(
            *map(_jf, (fl1, fr1, fl0, fr0)))
        qp = pm.quad_match(*map(_pf, (fl1, fr1, fl0, fr0)),
                           ref["pcfg"].frontend)
    return [np.asarray(x) for x in qj], qp


@pytest.mark.parametrize("prior", [False, True])
def test_quad_match_agrees(ref, prior):
    qj, qp = _quads(ref, prior)
    assert qp.valid.sum() > 15
    for name, a, b in zip(pm.QuadMatches._fields, qj, qp):
        if name.startswith("idx") or name == "valid":
            assert _agree(a, b.numpy()) >= 0.99, name
    same = (qj[8] == qp.valid.numpy()) & (qj[8])
    for name, a, b in zip(pm.QuadMatches._fields[4:8], qj[4:8], qp[4:8]):
        np.testing.assert_array_equal(a[same], b.numpy()[same], name)


def test_estimate_gain_agrees(ref):
    qj, _ = _quads(ref, False)
    img0, img1 = ref["lefts"][0], ref["lefts"][1] * 1.03
    args = (img0, img1, qj[6], qj[4], qj[8])
    want = float(jax.jit(jm.estimate_gain)(*map(jnp.asarray, args)))
    got = pm.estimate_gain(*map(torch.tensor, args))
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == want
    assert abs(want - 1.03) < 0.05
    none = pm.estimate_gain(*map(torch.tensor, args[:4]),
                            torch.zeros(len(qj[8]), dtype=torch.bool))
    assert float(none) == 1.0


@pytest.mark.parametrize("mode", ["temporal", "full"])
def test_refine_quad_subpix_agrees(ref, mode):
    cfg = ref["cfg"]
    fc = dataclasses.replace(cfg.frontend, refine_mode=mode)
    pfc = dataclasses.replace(ref["pcfg"].frontend, refine_mode=mode)
    qj, _ = _quads(ref, False)
    imgs = (ref["lefts"][0], ref["rights"][0], ref["lefts"][1],
            ref["rights"][1])
    want = jax.jit(lambda q, a, b, c, d, T: jm.refine_quad_subpix(
        q, a, b, c, d, fc, T, cfg.rig))(
            jm.QuadMatches(*map(jnp.asarray, qj)), *map(jnp.asarray, imgs),
            jnp.asarray(ref["T_pred"]))
    got = pm.refine_quad_subpix(
        pm.QuadMatches(*map(torch.tensor, qj)), *map(torch.tensor, imgs),
        pfc, torch.tensor(ref["T_pred"]), ref["pcfg"].rig)
    for name in ("uv_lc", "uv_rc", "uv_lp", "uv_rp"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-3, err_msg=name)
    moved = np.abs(got.uv_lc.numpy() - qj[4]).max(axis=1) > 1e-3
    assert moved.sum() > 10
    stereo_moved = (np.abs(got.uv_rc.numpy() - qj[5]).max(axis=1)
                    > 1e-3).sum()
    assert (stereo_moved > 10) == (mode == "full")


def test_refine_quad_subpix_at_patch_7(ref):
    """refine_patch 7, a size the JAX probes run (the port's `_zssd` keeps
    its row order to 9x9 patches and sums 7x7 ones in one chain), refines
    as JAX does, within the tolerance of refine_quad_subpix above."""
    cfg = ref["cfg"]
    fc = dataclasses.replace(cfg.frontend, refine_mode="full",
                             refine_patch=7)
    pfc = dataclasses.replace(ref["pcfg"].frontend, refine_mode="full",
                              refine_patch=7)
    qj, _ = _quads(ref, False)
    imgs = (ref["lefts"][0], ref["rights"][0], ref["lefts"][1],
            ref["rights"][1])
    want = jax.jit(lambda q, a, b, c, d: jm.refine_quad_subpix(
        q, a, b, c, d, fc))(jm.QuadMatches(*map(jnp.asarray, qj)),
                            *map(jnp.asarray, imgs))
    got = pm.refine_quad_subpix(pm.QuadMatches(*map(torch.tensor, qj)),
                                *map(torch.tensor, imgs), pfc)
    for name in ("uv_lc", "uv_rc", "uv_lp", "uv_rp"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-3, err_msg=name)
    moved = np.abs(got.uv_lc.numpy() - qj[4]).max(axis=1) > 1e-3
    assert moved.sum() > 10


@pytest.fixture(scope="module")
def drive(ref):
    """JAX vo_step jitted, frame by frame, with the draws its key gives."""
    cfg = ref["cfg"]
    step = jax.jit(lambda st, l, r: jfe.vo_step(st, l, r, cfg))
    # JAX's fresh state holds disp_l weakly typed and disp_r strongly, as
    # its step returns them, once disp_l is strong: the same values, in the
    # step's own types from the start, compile the step once
    st = jfe.init_frontend(cfg)
    st = st._replace(disp_l=jnp.asarray(np.asarray(st.disp_l)))
    states, outs, draws = [st], [], []
    for i in range(N):
        draws.append(np.asarray(jax.random.randint(
            jax.random.split(st.key)[1], (K, 3), 0,
            jnp.iinfo(jnp.int32).max)))
        st, out = step(st, jnp.asarray(ref["lefts"][i]),
                       jnp.asarray(ref["rights"][i]))
        states.append(st)
        outs.append(out)
    return states, outs, draws


def _leaves(st):
    return [np.asarray(x) for x in jax.tree.leaves(st)]


def _assert_pose_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[..., :3, 3], want[..., :3, 3], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[..., :3, :3], want[..., :3, :3], rtol=0,
                               atol=1e-5)


def test_vo_step_per_frame_with_jax_draws(ref, drive):
    """Each frame starts from the JAX state, carried across by
    io/convert.py; the port's step then matches JAX's step."""
    states, outs, draws = drive
    for i in range(N):
        st = convert.frontend_state_from_numpy(_leaves(states[i]),
                                               device="cpu")
        new, out = pfe.vo_step(st, torch.tensor(ref["lefts"][i]),
                               torch.tensor(ref["rights"][i]), ref["pcfg"],
                               raw=torch.tensor(draws[i]))
        nxt, want = states[i + 1], outs[i]
        _assert_pose_close(out.T_wc, want.T_wc)
        _assert_pose_close(new.T_delta_prev, nxt.T_delta_prev)
        assert int(out.num_inliers) == int(want.num_inliers)
        assert int(out.num_quads) == int(want.num_quads)
        assert bool(out.tracking_ok) == bool(want.tracking_ok)
        assert bool(new.prior_ok) == bool(nxt.prior_ok)
        assert int(new.frame) == int(nxt.frame)
        for key in ("feats_l", "feats_r"):
            for name, a, b in zip(("uv", "cls", "desc", "score", "valid"),
                                  getattr(nxt, key), getattr(new, key)):
                tol = 1e-6 if name == "desc" else 0
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                           atol=tol, err_msg=f"{key}.{name}")
        for key in ("disp_l", "disp_r", "exposure", "img_l", "img_r"):
            np.testing.assert_allclose(getattr(new, key).numpy(),
                                       np.asarray(getattr(nxt, key)),
                                       rtol=1e-6, err_msg=key)
    assert int(out.num_inliers) >= 20 and bool(out.tracking_ok)
    assert float(new.exposure) != 1.0
    gt = np.linalg.inv(ref["poses"][0]) @ ref["poses"][N - 1]
    np.testing.assert_allclose(np.asarray(out.T_wc)[:3, 3], gt[:3, 3],
                               atol=0.15)
