"""The stereo throughput path of the port (models/dense_slam.py
`process_sequence`: stereo VO on every frame, SGM depth and fusion on
keyframes) vs the JAX package's `process_sequence`, over 5 street frames
at 160x120 (`tiny_test_config`, 256 features, 32 RANSAC hypotheses,
f32 cost volume of 32 disparities, a keyframe every 2 frames, the gather
sampler, decay and a sliding window), and the port's copy of
eval/traj_metrics.py.

Frames: the stereo street under the stereo drive's nuisance of
scripts/long_drive_eval.py (gain ramp, photometric noise 2.0), drawn with
numpy. The JAX drive is process_sequence jitted on 1-frame chunks (one
compile); its RANSAC draws come from its key, and the port is given the
same draws. Tolerances, and why:
  * poses within 2e-6 m (translation) and 1e-6 (rotation entries): the
    first two frames equal bit for bit, the VO's solver in jitted
    XLA:CPU's order (tests/test_torch_gn_normal.py), and 9.1e-7 m and
    7.5e-8 observed by the last frame; tracking, keyframe decisions and
    inlier counts equal; features exact but the descriptors (1e-6, Sobel
    FMAs in jitted XLA), uv (1e-4 px) and scores (rtol 1e-6).
  * keyframe depth: equal bit for bit to jitted JAX `compute_depth`, and
    the fusion DB's (mm-quantised) keyframe depth of JAX's jitted
    process_sequence equal on every pixel: the port's cost volume rounds
    as jitted XLA does (tests/test_torch_cost_volume.py).
  * the map: hash tables, stamps and counters equal; weights and colours
    equal and tsdf within 5e-5 on all but <= 5e-6 of the voxel pool
    (1.4e-6 observed, 3 voxels: the poses' last bits move a voxel across
    a pixel edge; the fusion itself is jitted XLA's, kernel PJ's order).
    Replayed with the port's own depths and poses through JAX's jitted
    `integrate`, the JAX fusion equals the port's map bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import (SlideWindowParams, StereoConfig,
                                  VoxelDecayParams, tiny_test_config)
from denseslam_tpu.eval import traj_metrics as jtm
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.models import dense_slam as jd
from denseslam_tpu.models import frontend as jfe
from denseslam_tpu.ops import stereo as jst
from denseslam_tpu.ops import tsdf as jt
from denseslam_tpu_torch.eval import traj_metrics as ptm
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.models import frontend as pfe
from denseslam_tpu_torch.ops import stereo as pst
from denseslam_tpu_torch.ops import tsdf as pt

N = 5
K = 32
MAP_LEAVES = ["keys", "tsdf", "weight", "color", "alloc_frame", "last_seen",
              "frame", "decayed_blocks", "overflow"]


def _config():
    cfg = tiny_test_config(width=160, height=120, baseline_m=0.537)
    return dataclasses.replace(
        cfg,
        frontend=dataclasses.replace(cfg.frontend, max_features=256,
                                     ransac_iters=K, bucket_w=25,
                                     bucket_h=25),
        stereo=StereoConfig(max_disparity=32),
        tsdf=dataclasses.replace(cfg.tsdf, alloc_subsample=2),
        decay=VoxelDecayParams(enabled=True, min_decay_age=1,
                               max_decay_weight=2),
        slide_window=SlideWindowParams(enabled=True, max_age=3),
        pipeline=dataclasses.replace(cfg.pipeline, fusion_db_capacity=4,
                                     keyframe_every=2))


def _frames(cfg, rng):
    poses = js.make_trajectory(N, step_m=0.25, yaw_rate=0.003)
    lefts, rights, _ = js.render_stereo_trajectory(poses, cfg.rig,
                                                   js.street_scene())
    gain = 1.0 + 0.15 * np.sin(2 * np.pi * np.arange(N) / 150.0)

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
    poses, lefts, rights = _frames(cfg, np.random.default_rng(3))
    fids = np.arange(N, dtype=np.int32)
    seq = jax.jit(lambda st, m, db, l, r, f: jd.process_sequence(
        st, m, db, l, r, f, cfg))
    m, db = jax.tree.map(lambda x: x.astype(x.dtype), (
        jt.make_map(cfg.tsdf), jd.make_fusion_db(cfg)))
    # the frontend state in the types the step returns (disp_l strong,
    # disp_r weak), so that the sequence compiles once
    st = jfe.init_frontend(cfg, seed=0)
    st = st._replace(disp_l=jnp.asarray(np.asarray(st.disp_l)))
    stats, draws = [], []
    for i in range(N):
        draws.append(np.asarray(jax.random.randint(
            jax.random.split(st.key)[1], (K, 3), 0,
            jnp.iinfo(jnp.int32).max)))
        st, m, db, s = seq(st, m, db, *(jnp.asarray(a[i:i + 1])
                                        for a in (lefts, rights, fids)))
        stats.append(jax.tree.map(lambda x: np.asarray(x)[0], s))
    return dict(cfg=cfg, pcfg=convert.config_from_dict(dataclasses.asdict(cfg)),
                poses=poses, lefts=lefts, rights=rights, fids=fids,
                draws=np.stack(draws),
                stats=jax.tree.map(lambda *x: np.stack(x), *stats),
                map=[np.asarray(x) for x in jax.tree.leaves(m)],
                db=[np.asarray(x) for x in jax.tree.leaves(db)])


@pytest.fixture(scope="module")
def port_run(ref):
    pcfg = ref["pcfg"]
    st = pfe.init_frontend(pcfg, device="cpu")
    m = pt.make_map(pcfg.tsdf, device="cpu")
    db = pd.make_fusion_db(pcfg, device="cpu")
    return pd.process_sequence(
        st, m, db, torch.tensor(ref["lefts"]), torch.tensor(ref["rights"]),
        torch.tensor(ref["fids"]), pcfg, draws=torch.tensor(ref["draws"]))


def _assert_pose_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[..., :3, 3], want[..., :3, 3], rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(got[..., :3, :3], want[..., :3, :3], rtol=0,
                               atol=1e-6)


def test_process_sequence_matches_jax(ref, port_run):
    _, m, db, stats = port_run
    want = ref["stats"]
    assert set(stats) == set(want)
    _assert_pose_close(stats["T_wc"], want["T_wc"])
    for name in ("tracking_ok", "num_inliers", "fused"):
        np.testing.assert_array_equal(stats[name].numpy(), want[name], name)
    assert stats["fused"].sum() >= 2 and stats["tracking_ok"].all()
    np.testing.assert_allclose(stats["T_wc"][:, :3, 3].numpy(),
                               ref["poses"][:, :3, 3], atol=0.15)
    for key in ("feats_l", "feats_r"):
        for name, a, b in zip(("uv", "cls", "desc", "score", "valid"),
                              want[key], stats[key]):
            rtol, atol = {"uv": (0, 1e-4), "desc": (0, 1e-6),
                          "score": (1e-6, 0)}.get(name, (0, 0))
            np.testing.assert_allclose(b.numpy(), a, rtol=rtol, atol=atol,
                                       err_msg=f"{key}.{name}")
    np.testing.assert_allclose(stats["sig"].numpy(), want["sig"], atol=1e-6)

    got = convert.map_state_to_numpy(m)
    for name, a, b in zip(MAP_LEAVES, ref["map"], got):
        if name not in ("tsdf", "weight", "color"):
            np.testing.assert_array_equal(a, b, name)
    assert (got[2] > 0).sum() > 5000
    differ = ((ref["map"][2] != got[2]) | (ref["map"][3] != got[3])
              | (np.abs(ref["map"][1] - got[1]) > 5e-5))
    assert differ.mean() <= 5e-6, differ.mean()
    for name, a, b in zip(["depth", "gray", "T_fused", "frame_id", "valid",
                           "head"], ref["db"], convert.fusion_db_to_numpy(db)):
        if name == "T_fused":
            _assert_pose_close(b, a)
        else:
            np.testing.assert_array_equal(a, b, name)


@pytest.fixture(scope="module")
def kf_depths(ref, port_run):
    """The port's depth of each fused keyframe, as process_sequence
    computed it."""
    pcfg = ref["pcfg"]
    kf = np.flatnonzero(port_run[3]["fused"].numpy())
    return kf, [pst.compute_depth(torch.tensor(ref["lefts"][i]),
                                  torch.tensor(ref["rights"][i]), pcfg.rig,
                                  pcfg.stereo)[0].numpy() for i in kf]


def test_keyframe_depth_matches_jax(ref, kf_depths):
    cfg = ref["cfg"]
    depth = jax.jit(lambda l, r: jst.compute_depth(l, r, cfg.rig,
                                                   cfg.stereo)[0])
    for i, dp in zip(*kf_depths):
        dj = np.asarray(depth(jnp.asarray(ref["lefts"][i]),
                              jnp.asarray(ref["rights"][i])))
        assert (dp > 0).mean() > 0.3
        np.testing.assert_array_equal(dj.view(np.int32), dp.view(np.int32))


def test_process_sequence_fusion_is_exact(ref, port_run, kf_depths):
    """The port's map equals the JAX fusion of the port's keyframe depths
    at the port's poses, fuse_keyframe's steps each jitted on its own
    (`integrate` in the order the port copies)."""
    _, m, _, stats = port_run
    cfg = ref["cfg"]
    intr, tc = cfg.rig.intr, cfg.tsdf
    alloc = jax.jit(lambda m, d, T: jt.allocate_for_frame(m, d, T, intr, tc))
    integ = jax.jit(lambda m, s, k, d, c, T: jt.integrate(
        m, s, k, d, c, T, intr, tc))
    tail = jax.jit(lambda m: jt.advance_frame(jt.decay_and_slide(
        m, cfg.decay.max_decay_weight, cfg.decay.min_decay_age,
        cfg.slide_window.max_age)))
    mj, db = jt.make_map(tc), jd.make_fusion_db(cfg)
    for i, depth in zip(*kf_depths):
        d = jd.db_quantize_depth(db, jnp.asarray(depth))
        T = jnp.asarray(stats["T_wc"][i].numpy())
        col = jt.pack_gray(jnp.asarray(ref["lefts"][i]))
        mj, s, k = alloc(mj, d, T)
        mj = tail(integ(mj, s, k, d, col, T))
    for name, a, b in zip(MAP_LEAVES, jax.tree.leaves(mj),
                          convert.map_state_to_numpy(m)):
        np.testing.assert_array_equal(np.asarray(a), b, name)


@pytest.mark.parametrize("metric", ["ate_rmse", "rpe", "kitti_sequence_errors"])
def test_traj_metrics_copy(ref, port_run, metric):
    """The port's copy of eval/traj_metrics.py gives the JAX package's
    numbers on the drive's poses (KITTI lengths cut to the drive)."""
    est = port_run[3]["T_wc"].numpy().astype(np.float64)
    gt = ref["poses"].astype(np.float64)
    kw = dict(lengths=(0.5, 0.75), step=1) if metric.startswith("kitti") else {}
    want = getattr(jtm, metric)(est, gt, **kw)
    got = getattr(ptm, metric)(est, gt, **kw)
    assert got == want
    vals = list(got.values()) if isinstance(got, dict) else [got]
    assert all(np.isfinite(v) and v >= 0 for v in vals)
