"""The per-frame path of the port against the JAX package:
`SLAMSystem.process_frame` (stereo VO at the PD controller's RANSAC
budget, keyframe-gated SGM and fusion, the backend tick on every fused
keyframe, relocalization after a blackout) and the RANSAC budget of
`vo_step` (internal ICP odometry, `pose_override`, ICP `track` and
`depth_postprocess` are in tests/test_torch_frame_icp.py).

Frames: the synthetic street at 160x120 under the stereo drive's
photometric noise, drawn with numpy; 256 features, 32 RANSAC hypotheses,
32 disparities, a keyframe every 2 frames, online correction on, the
backend cut as in tests/test_torch_system.py. Both systems draw each
frame's hypotheses from their frontend's key and the verification
samples from their seeds (the port through utils/threefry.py); nothing
is handed in. Its PD controller
reads wall time, so both sides hold its scale at 0.5.

Tolerances, and why:
  * tracking flags, keyframe decisions, relocalizations, keyframe ids,
    inlier counts and every counter equal;
  * poses within 1e-5 m (translation) and 1e-5 (rotation entries),
    observed 2.9e-6, through two ticks and the relocalization (the
    descriptor and exposure sums and the BA's einsums round in another
    order). The drive ends at the relocalization: a tick on the window
    across the blackout amplifies those last bits to millimetres, by an
    amount that moves with torch's thread count;
  * the map: tables, stamps and counters equal, weights and colours on
    all but 1e-3 of the pool and tsdf within 5e-5 on all but 1e-3 of it
    (observed 1.4e-5 and 1.4e-6: a voxel within a rounding of a pixel
    edge samples the next pixel);
  * `vo_step` at budget 0.25 and 1.0: poses within 1e-5, inlier counts
    equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import (OnlineCorrectionParams, SlideWindowParams,
                                  StereoConfig, VoxelDecayParams,
                                  tiny_test_config)
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.models import system as jsys
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import frontend as pfe
from denseslam_tpu_torch.models import system as psys

K = 32
N_DRIVE = 6          # street frames before the blackout
N_BLANK = 3          # featureless frames: tracking lost
N_BACK = 1           # a frame back at the pose of keyframe 2


def _config():
    cfg = tiny_test_config(width=160, height=120, baseline_m=0.537)
    return dataclasses.replace(
        cfg,
        frontend=dataclasses.replace(cfg.frontend, max_features=256,
                                     ransac_iters=K, bucket_w=25,
                                     bucket_h=25),
        stereo=StereoConfig(max_disparity=32),
        tsdf=dataclasses.replace(cfg.tsdf, alloc_subsample=2,
                                 sampler="gather", storage_dtype="float32"),
        decay=VoxelDecayParams(enabled=True, min_decay_age=4,
                               max_decay_weight=2),
        slide_window=SlideWindowParams(enabled=True, max_age=8),
        correction=OnlineCorrectionParams(enabled=True, correction_num=5,
                                          start_correction_num=1,
                                          min_error=0.001),
        backend=dataclasses.replace(
            cfg.backend, window_keyframes=4, max_landmarks=256,
            max_pg_nodes=32, max_pg_edges=64, retrieval_capacity=128),
        pipeline=dataclasses.replace(cfg.pipeline, fusion_db_capacity=8,
                                     keyframe_every=2))


def _draws(key, n, k):
    """What the JAX frontend draws on its next n frames: its key splits
    once a frame, and the second half draws."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(
            sub, (k, 3), 0, jnp.iinfo(jnp.int32).max)))
    return np.stack(out)


def _settle_types(slam):
    """JAX's fresh frontend state holds disp_l weakly typed, and the state
    its VO step returns holds it strongly typed: the same values, strongly
    typed from the start, spare the jitted step a second compile."""
    st = slam.fe_state
    slam.fe_state = st._replace(disp_l=jnp.asarray(np.asarray(st.disp_l)))


def _pose_close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[..., :3, 3], want[..., :3, 3], rtol=0,
                               atol=atol)
    np.testing.assert_allclose(got[..., :3, :3], want[..., :3, :3], rtol=0,
                               atol=atol)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are small: one thread each spares the other
    test processes of a parallel run the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def drive():
    """N_DRIVE street frames, a blackout, then the view of keyframe 2
    again (where the system relocalizes), through both systems'
    process_frame with the rendered depth
    (as tests/test_system.py's relocalization drive; SGM on the per-frame
    path runs on the card, chip_smoke.py phase `frame`)."""
    cfg = _config()
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    rng = np.random.default_rng(7)
    poses = js.make_trajectory(N_DRIVE, step_m=0.25, yaw_rate=0.003)
    back = np.stack([poses[2]] * N_BACK)
    lefts, rights, depths = js.render_stereo_trajectory(
        np.concatenate([poses, back]), cfg.rig, js.street_scene())

    def noisy(g):
        g = np.asarray(g)
        return np.clip(g + 2.0 * rng.normal(size=g.shape), 0,
                       255).astype(np.float32)

    def frames(g):
        blank = np.zeros((N_BLANK,) + g.shape[1:], np.float32)
        return np.concatenate([g[:N_DRIVE], blank, g[N_DRIVE:]])

    lefts, rights = frames(noisy(lefts)), frames(noisy(rights))
    depths = frames(np.asarray(depths))
    n = lefts.shape[0]
    jsystem = jsys.SLAMSystem(cfg, seed=0, ba_every=2, loop_every=1,
                              reloc_after=2)
    _settle_types(jsystem.slam)
    draws = _draws(jsystem.slam.fe_state.key, n, K)
    psystem = psys.SLAMSystem(pcfg, seed=0, ba_every=2, loop_every=1,
                              reloc_after=2, device="cpu")
    for s in (jsystem, psystem):
        s.pd.lo = s.pd.hi = s.pd.scale = 0.5
    jo, po, jstates = [], [], []
    flows = [(jsystem.slam.last_flow, psystem.slam.last_flow)]
    for i in range(n):
        jstates.append(jsystem.slam.fe_state)
        jo.append(jsystem.process_frame(jnp.asarray(lefts[i]),
                                        jnp.asarray(rights[i]),
                                        depth=jnp.asarray(depths[i])))
        po.append(psystem.process_frame(torch.tensor(lefts[i]),
                                        torch.tensor(rights[i]),
                                        depth=torch.tensor(depths[i])))
        if i < 2:
            flows.append(tuple([np.asarray(a) for a in s.slam.last_flow]
                               for s in (jsystem, psystem)))
    return dict(jo=jo, po=po, jsystem=jsystem, psystem=psystem, poses=poses,
                pcfg=pcfg, lefts=lefts, rights=rights, draws=draws,
                jstates=jstates, flows=flows)


def test_dense_slam_last_flow_matches_jax(drive):
    """DenseSLAM.last_flow (the viewer's scene-flow pane): None on a fresh
    system; after frame 1, the stereo path's first frame with a previous
    one, JAX's (flow_uv_prev, flow_uv_curr, flow_valid): the flags equal,
    the positions within 1e-3 px (the subpixel refinement's tolerance in
    tests/test_torch_vo.py)."""
    assert drive["flows"][0] == (None, None)
    (juv_p, juv_c, jval), (puv_p, puv_c, pval) = drive["flows"][2]
    assert not drive["flows"][1][1][2].any()      # frame 0: nothing to flow
    np.testing.assert_array_equal(pval, jval)
    assert pval.sum() >= 16
    for got, want in ((puv_p, juv_p), (puv_c, juv_c)):
        np.testing.assert_allclose(got[pval], want[jval], rtol=0, atol=1e-3)


def test_process_frame_flags_match_jax(drive):
    for j, p in zip(drive["jo"], drive["po"]):
        for key in ("frame", "tracking_ok", "fused", "num_inliers",
                    "num_quads", "num_blocks", "num_loops",
                    "num_corrections"):
            assert p[key] == j[key], (key, p["frame"])
        assert p.get("relocalized") == j.get("relocalized")
        assert p["budget_scale"] == j["budget_scale"] == 0.5
    fused = [p["fused"] for p in drive["po"]]
    assert sum(fused) >= 3 and not any(fused[N_DRIVE:N_DRIVE + N_BLANK])


def test_process_frame_poses_match_jax(drive):
    """Per frame, in the pose history and the frontend's."""
    for j, p in zip(drive["jo"], drive["po"]):
        _pose_close(p["T_wc"], j["T_wc"], 1e-5)
    hist_p = np.stack([T for _, T in drive["psystem"].trajectory()])
    hist_j = np.stack([np.asarray(T)
                       for _, T in drive["jsystem"].trajectory()])
    _pose_close(hist_p, hist_j, 1e-5)
    _pose_close(drive["psystem"].slam.fe_state.T_wc.numpy(),
                drive["jsystem"].slam.fe_state.T_wc, 1e-5)


def test_process_frame_backend_matches_jax(drive):
    ps, js_ = drive["psystem"], drive["jsystem"]
    ids_p, poses_p = ps.keyframe_trajectory()
    ids_j, poses_j = js_.keyframe_trajectory()
    np.testing.assert_array_equal(ids_p, ids_j)
    _pose_close(poses_p, poses_j, 1e-5)
    assert ((ps.num_loops, ps.num_corrections, ps.num_culled,
             ps.backend.ba_rejects, len(ps.backend.odom_edges))
            == (js_.num_loops, js_.num_corrections, js_.num_culled,
                js_.backend.ba_rejects, len(js_.backend.odom_edges)))
    assert ps.num_corrections >= 1


def test_relocalization_after_lost_tracking(drive):
    """Mirrors tests/test_system.py's per-frame relocalization: blank
    frames lose tracking, the view of a keyframe comes back, and the
    system relocalizes against the keyframe database."""
    ps, js_ = drive["psystem"], drive["jsystem"]
    assert ps.num_relocs == js_.num_relocs == 1
    i = next(k for k, o in enumerate(drive["po"]) if o.get("relocalized"))
    assert i == N_DRIVE + N_BLANK
    _pose_close(drive["po"][i]["T_wc"], drive["jo"][i]["T_wc"], 1e-5)
    # both systems land 0.31 m from the true pose: 256 features at
    # 160x120 verify coarsely (tests/test_system.py's 320x240: < 0.15 m)
    err = np.linalg.norm(drive["po"][i]["T_wc"][:3, 3]
                         - drive["poses"][2][:3, 3])
    assert err < 0.5, err


def test_process_frame_map_matches_jax(drive):
    got = convert.map_state_to_numpy(drive["psystem"].slam.submaps.active)
    want = [np.asarray(x)
            for x in jax.tree.leaves(drive["jsystem"].slam.submaps.active)]
    names = ["keys", "tsdf", "weight", "color", "alloc_frame", "last_seen",
             "frame", "decayed_blocks", "overflow"]
    for name, a, b in zip(names, want, got):
        if name not in ("tsdf", "weight", "color"):
            np.testing.assert_array_equal(b, a, name)
    assert (got[2] > 0).sum() > 2000
    assert ((want[2] != got[2]) | (want[3] != got[3])).mean() <= 1e-3
    assert (np.abs(want[1] - got[1]) > 5e-5).mean() <= 1e-3


# ---------------------------------------------------------------------------
# The RANSAC budget of vo_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [0.25, 1.0])
def test_vo_budget_matches_jax(drive, scale):
    """`estimate_stereo_motion`'s budget, through `vo_step` on frame 3 of
    the drive from JAX's state before it (the drive runs at 0.5): only
    the first ceil(K * scale) hypotheses may win the vote, 8 of 32 at
    0.25."""
    i = 3
    st = drive["jstates"][i]
    left, right = drive["lefts"][i], drive["rights"][i]
    _, want = drive["jsystem"].slam._vo(st, jnp.asarray(left),
                                        jnp.asarray(right),
                                        budget_scale=jnp.float32(scale))
    pst = convert.frontend_state_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(st)], device="cpu")
    _, got = pfe.vo_step(pst, torch.tensor(left), torch.tensor(right),
                         drive["pcfg"], raw=torch.tensor(drive["draws"][i]),
                         budget_scale=scale)
    assert bool(got.tracking_ok) and bool(want.tracking_ok)
    assert int(got.num_inliers) == int(want.num_inliers) > 0
    _pose_close(got.T_wc.numpy(), want.T_wc, 1e-5)
