"""The RGB-D throughput path of the port vs the JAX package, at 160x120:
`rgbd_vo_step` frame by frame, `process_sequence_rgbd` over 4 frames with
true-RGB fusion (`gray_color_fusion=False`, kernel B2's plain version),
and the state converters.

Frames: the synthetic street with the RGB-D sensor model of
scripts/long_drive_eval.py (1% relative depth noise, 5% holes,
photometric noise 2.0, a gain ramp), drawn with numpy. The JAX side runs
jitted, its RANSAC draws come from its PRNG key, and the port is given
the same draws. Tolerances, and why:
  * per frame and over the sequence: poses within 1e-4 m (translation)
    and 1e-5 (rotation entries); tracking, keyframe decisions and inlier
    counts equal; features exact (virtual right uv within 1e-4 px).
    The float32 matmuls and reductions of matching and Gauss-Newton sum
    in another order than XLA:CPU.
  * the map after the sequence: hash tables, stamps and counters equal.
    The jitted JAX fusion contracts the voxel projection's multiply-adds
    into FMAs, so a voxel that projects within an FMA rounding of a pixel
    boundary samples the neighbouring pixel: weights and colours differ
    on at most 1e-4 of voxels, and elsewhere tsdf by at most 5e-5 (a few
    ulps of the voxel's camera depth over the 0.2 m truncation). Replayed
    with the port's own poses through JAX's jitted `integrate` (the
    program whose projection and running averages the port copies), the
    JAX fusion equals the port's map bit for bit, every leaf.

The JAX drive is process_sequence_rgbd on 1-frame chunks (one compile),
so that the per-frame states are at hand; the port runs the 4 frames in
one call."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import (SlideWindowParams, VoxelDecayParams,
                                  tiny_test_config)
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.models import dense_slam as jd
from denseslam_tpu.models import frontend as jfe
from denseslam_tpu.ops import tsdf as jt
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.models import frontend as pfe
from denseslam_tpu_torch.ops import tsdf as pt

N = 4
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
        tsdf=dataclasses.replace(cfg.tsdf, sampler="pallas",
                                 alloc_subsample=2, gray_color_fusion=False,
                                 pallas_overflow_cap=8),
        decay=VoxelDecayParams(enabled=True, min_decay_age=1,
                               max_decay_weight=2),
        slide_window=SlideWindowParams(enabled=True, max_age=2),
        pipeline=dataclasses.replace(cfg.pipeline, fusion_db_capacity=4,
                                     keyframe_every=2, sensor="rgbd"))


def _frames(cfg, rng):
    poses = js.make_trajectory(N, step_m=0.25, yaw_rate=0.003)
    g, d = js.render_trajectory(poses, cfg.rig.intr, js.street_scene())
    g, d = np.asarray(g), np.asarray(d)
    gain = 1.0 + 0.15 * np.sin(2 * np.pi * np.arange(N) / 150.0)
    g = np.clip(g * gain[:, None, None] + 2.0 * rng.normal(size=g.shape),
                0, 255).astype(np.float32)
    dn = d * (1.0 + 0.01 * rng.normal(size=d.shape))
    holes = rng.random(d.shape) < 0.05
    d = np.where(holes | (d <= 0) | (d > cfg.tsdf.max_depth_m), 0.0,
                 dn).astype(np.float32)
    return poses, g, d


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
    """The JAX drive: process_sequence_rgbd jitted once for a 1-frame chunk
    and called frame by frame, so the frontend state after every frame is
    at hand; the draws are the ones its key gives each frame."""
    cfg = _config()
    poses, grays, depths = _frames(cfg, np.random.default_rng(0))
    fids = np.arange(N, dtype=np.int32)
    seq = jax.jit(lambda st, m, db, g, d, f: jd.process_sequence_rgbd(
        st, m, db, g, d, f, cfg))
    # strong types throughout, so that every call hits the one compile
    st, m, db = jax.tree.map(lambda x: x.astype(x.dtype), (
        jfe.init_frontend(cfg, seed=0), jt.make_map(cfg.tsdf),
        jd.make_fusion_db(cfg)))
    states, stats, draws = [st], [], []
    for i in range(N):
        draws.append(np.asarray(jax.random.randint(
            jax.random.split(st.key)[1], (K, 3), 0,
            jnp.iinfo(jnp.int32).max)))
        st, m, db, s = seq(st, m, db, *(jnp.asarray(a[i:i + 1])
                                        for a in (grays, depths, fids)))
        states.append(st)
        stats.append(jax.tree.map(lambda x: np.asarray(x)[0], s))
    return dict(cfg=cfg, pcfg=convert.config_from_dict(dataclasses.asdict(cfg)),
                poses=poses, grays=grays, depths=depths, fids=fids,
                draws=np.stack(draws), states=states,
                stats=jax.tree.map(lambda *x: np.stack(x), *stats),
                map=[np.asarray(x) for x in jax.tree.leaves(m)],
                db=[np.asarray(x) for x in jax.tree.leaves(db)])


def _assert_pose_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[..., :3, 3], want[..., :3, 3], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[..., :3, :3], want[..., :3, :3], rtol=0,
                               atol=1e-5)


def _leaves(st):
    return [np.asarray(x) for x in jax.tree.leaves(st)]


def test_rgbd_vo_step_per_frame_with_jax_draws(ref):
    """Each frame starts from the JAX state, carried across by
    io/convert.py; the port's step then matches JAX's step."""
    pcfg, want = ref["pcfg"], ref["stats"]
    for i in range(N):
        st = convert.frontend_state_from_numpy(_leaves(ref["states"][i]),
                                               device="cpu")
        new, out = pfe.rgbd_vo_step(st, torch.tensor(ref["grays"][i]),
                                    torch.tensor(ref["depths"][i]), pcfg,
                                    raw=torch.tensor(ref["draws"][i]))
        nxt = ref["states"][i + 1]
        _assert_pose_close(out.T_wc, want["T_wc"][i])
        _assert_pose_close(new.T_delta_prev, nxt.T_delta_prev)
        assert int(out.num_inliers) == int(want["num_inliers"][i])
        assert bool(out.tracking_ok) == bool(want["tracking_ok"][i])
        assert bool(new.prior_ok) == bool(nxt.prior_ok)
        assert int(new.frame) == int(nxt.frame)
        for a, b in zip(nxt.feats_l, new.feats_l):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-6)
        np.testing.assert_allclose(new.disp_l.numpy(), np.asarray(nxt.disp_l),
                                   rtol=1e-6)
        assert int(out.num_quads) >= int(out.num_inliers)
    assert int(out.num_inliers) >= 6


def test_frontend_state_round_trip(ref):
    """JAX state -> port -> JAX leaves, the threefry key among them:
    unchanged; and a fresh port state, key and all, equals a fresh JAX
    state."""
    leaves = _leaves(ref["states"][2])
    st = convert.frontend_state_from_numpy(leaves, device="cpu")
    back = convert.frontend_state_to_numpy(st)
    assert len(back) == len(leaves)
    for a, b in zip(leaves, back):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    init = _leaves(jfe.init_frontend(ref["cfg"]))
    fresh = pfe.init_frontend(ref["pcfg"], device="cpu")
    for a, b in zip(init, convert.frontend_state_to_numpy(fresh)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_dense_slam_last_flow_matches_jax(ref):
    """DenseSLAM.last_flow (the viewer's scene-flow pane) on the RGB-D
    path: None on a fresh system; after frame 1 the JAX rgbd_vo_step's
    (flow_uv_prev, flow_uv_curr, flow_valid) from the same state (the
    program JAX's DenseSLAM runs there), flags equal, positions within
    1e-3 px (the subpixel refinement's tolerance in
    tests/test_torch_vo.py)."""
    step = jax.jit(lambda st, g, d: jfe.rgbd_vo_step(st, g, d, ref["cfg"]))
    _, want = step(ref["states"][1], jnp.asarray(ref["grays"][1]),
                   jnp.asarray(ref["depths"][1]))
    slam = pd.DenseSLAM(ref["pcfg"], device="cpu", seed=0)
    assert slam.last_flow is None
    for i in (0, 1):
        slam.process_frame(torch.tensor(ref["grays"][i]),
                           depth=torch.tensor(ref["depths"][i]),
                           draws=torch.tensor(ref["draws"][i]))
    got = [t.numpy() for t in slam.last_flow]
    np.testing.assert_array_equal(got[2], np.asarray(want.flow_valid))
    assert got[2].sum() >= 8
    for g, w in zip(got[:2], (want.flow_uv_prev, want.flow_uv_curr)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def port_run(ref):
    pcfg = ref["pcfg"]
    st = pfe.init_frontend(pcfg, device="cpu")
    m = pt.make_map(pcfg.tsdf, device="cpu")
    db = pd.make_fusion_db(pcfg, device="cpu")
    return pd.process_sequence_rgbd(
        st, m, db, torch.tensor(ref["grays"]), torch.tensor(ref["depths"]),
        torch.tensor(ref["fids"]), pcfg, draws=torch.tensor(ref["draws"]))


def test_process_sequence_rgbd_matches_jax(ref, port_run):
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
            tol = 1e-4 if (key, name) == ("feats_r", "uv") else 1e-6
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=tol,
                                       err_msg=f"{key}.{name}")
    np.testing.assert_allclose(stats["sig"].numpy(), want["sig"], atol=1e-6)

    got = convert.map_state_to_numpy(m)
    for name, a, b in zip(MAP_LEAVES, ref["map"], got):
        if name not in ("tsdf", "weight", "color"):
            np.testing.assert_array_equal(a, b, name)
    assert (got[2] > 0).sum() > 10000
    differ = (ref["map"][2] != got[2]) | (ref["map"][3] != got[3])
    assert differ.mean() <= 1e-4, differ.mean()
    same = ~differ
    assert np.abs(ref["map"][1][same] - got[1][same]).max() <= 5e-5
    for name, a, b in zip(["depth", "gray", "T_fused", "frame_id", "valid",
                           "head"], ref["db"], convert.fusion_db_to_numpy(db)):
        if name == "T_fused":
            _assert_pose_close(b, a)
        else:
            np.testing.assert_array_equal(a, b, name)


def test_process_sequence_rgbd_fusion_is_exact(ref, port_run):
    """The port's map equals the JAX fusion of the frames it fused at the
    poses it estimated, bit for bit: fuse_keyframe's steps, each jitted
    on its own (allocation, `integrate` in the order the port copies, and
    the decay / slide tail)."""
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
    for i in np.flatnonzero(stats["fused"].numpy()):
        d = jd.db_quantize_depth(db, jnp.asarray(ref["depths"][i]))
        T = jnp.asarray(stats["T_wc"][i].numpy())
        col = jt.pack_gray(jnp.asarray(ref["grays"][i]))
        mj, s, k = alloc(mj, d, T)
        mj = tail(integ(mj, s, k, d, col, T))
    for name, a, b in zip(MAP_LEAVES, jax.tree.leaves(mj),
                          convert.map_state_to_numpy(m)):
        np.testing.assert_array_equal(np.asarray(a), b, name)
