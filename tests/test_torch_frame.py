"""The per-frame path of the port against the JAX package:
`SLAMSystem.process_frame` (stereo VO at the PD controller's RANSAC
budget, keyframe-gated SGM and fusion, the backend tick on every fused
keyframe, relocalization after a blackout), `DenseSLAM.process_frame`
with internal ICP odometry (`use_external_odometry=False`, the bilateral
filter and the depth post-processing on), and the ops under them:
`depth_postprocess`, ICP `track`, a given pose (`pose_override`) and
the RANSAC budget of `vo_step`.

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
  * ICP `track` from the same model: poses within 1e-5 (its 6x6 normal
    equations sum over pixels in another order than XLA's). The ICP
    drive: poses within 1e-3 m (observed 2.1e-4; its ICP settles at a
    1.6 cm RMSE, and the jitted JAX render's FMA-rounded model points
    move the poorly constrained solution), its RMSE within 1e-4 m; the
    map fused at those poses: keys on all but 1e-3 of the table, tsdf
    within 5e-3 (a 2e-4 m move over the 0.2 m truncation is 1e-3) on all
    but 1e-3 of the pool;
    `depth_postprocess`: the culled pixels equal on all but 1e-3 (the
    3x3 point transforms round differently at the 10% gate);
  * `vo_step` at budget 0.25 and 1.0: poses within 1e-5, inlier counts
    equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import (OnlineCorrectionParams, PostProcessParams,
                                  SlideWindowParams, StereoConfig,
                                  VoxelDecayParams, tiny_test_config)
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.models import dense_slam as jd
from denseslam_tpu.models import system as jsys
from denseslam_tpu.utils import lie as jl
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.models import frontend as pfe
from denseslam_tpu_torch.models import system as psys
from denseslam_tpu_torch.ops import icp as picp
from denseslam_tpu_torch.ops import splat as psp

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
# Internal odometry and the ops under the per-frame path
# ---------------------------------------------------------------------------

def _icp_config():
    cfg = tiny_test_config(width=160, height=120, baseline_m=0.2)
    return dataclasses.replace(
        cfg, stereo=StereoConfig(max_disparity=48),
        postprocess=PostProcessParams(enabled=True),
        pipeline=dataclasses.replace(cfg.pipeline,
                                     use_external_odometry=False,
                                     bilateral_filter=True),
        splat=dataclasses.replace(cfg.splat, max_blocks=1024,
                                  max_voxels=1 << 16))


@pytest.fixture(scope="module")
def icp_drive():
    """4 frames of the default scene through both DenseSLAM.process_frame
    with ICP against a splat render of the map, the bilateral filter and
    the depth post-processing on (tests/test_pipeline.py's internal-ICP
    drive), then a 5th frame whose pose is given (`pose_override`)."""
    cfg = _icp_config()
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    poses = js.make_trajectory(5, step_m=0.04, yaw_rate=0.003)
    jslam = jd.DenseSLAM(cfg)
    pslam = pd.DenseSLAM(pcfg, device="cpu")
    jo, po, depths = [], [], []
    for i, T in enumerate(poses):
        _, d = js.render_view(jnp.asarray(T), cfg.rig.intr)
        depths.append(np.asarray(d))
        given = i == len(poses) - 1
        jo.append(jslam.process_frame(
            jnp.zeros_like(d), depth=d,
            pose_override=jnp.asarray(T) if given else None))
        po.append(pslam.process_frame(torch.zeros(d.shape),
                                      depth=torch.tensor(depths[-1]),
                                      pose_override=T if given else None))
    return dict(cfg=cfg, pcfg=pcfg, poses=poses, depths=depths, jo=jo,
                po=po, jslam=jslam, pslam=pslam)


def test_icp_process_frame_matches_jax(icp_drive):
    s = icp_drive
    for j, p, T in zip(s["jo"][:-1], s["po"][:-1], s["poses"]):
        assert p["tracking_ok"] == j["tracking_ok"] and p["fused"]
        _pose_close(p["T_wc"], j["T_wc"], 1e-3)
        assert np.abs(p["T_wc"][:3, 3] - T[:3, 3]).max() < 0.05
        if "icp_rmse" in j:
            assert abs(p["icp_rmse"] - j["icp_rmse"]) < 1e-4
    got = convert.map_state_to_numpy(s["pslam"].submaps.active)
    want = [np.asarray(x)
            for x in jax.tree.leaves(s["jslam"].submaps.active)]
    assert (got[0] != want[0]).mean() <= 1e-3
    assert (np.abs(got[1] - want[1]) > 5e-3).mean() <= 1e-3


def test_pose_override_matches_jax(icp_drive):
    """The given pose replaces the odometry and the frame fuses there,
    culled against the last fused frame."""
    s = icp_drive
    j, p = s["jo"][-1], s["po"][-1]
    np.testing.assert_array_equal(p["T_wc"], s["poses"][-1])
    np.testing.assert_array_equal(p["T_wc"], np.asarray(j["T_wc"]))
    assert p["fused"] and j["fused"] and p["tracking_ok"]
    assert "icp_rmse" not in p and p["frame"] == j["frame"] == 4
    np.testing.assert_array_equal(s["pslam"].fe_state.T_wc.numpy(),
                                  s["poses"][-1])
    assert abs(p["num_blocks"] - j["num_blocks"]) <= 2


def test_icp_track_matches_jax(icp_drive):
    """track from a perturbed pose against a splat render of the drive's
    map, through the JAX pipeline's own jitted track."""
    s = icp_drive
    T_true = s["poses"][3].astype(np.float32)
    T_render = s["poses"][2].astype(np.float32)
    rc = psp.splat_render(s["pslam"].submaps.active, torch.tensor(T_render),
                          s["pcfg"].rig.intr, s["pcfg"].tsdf,
                          psp.SplatConfig(**dataclasses.asdict(
                              s["pcfg"].splat)))
    xi = np.array([0.02, -0.015, 0.03, 0.008, -0.01, 0.006], np.float32)
    T_init = T_true @ np.asarray(jl.se3_exp(jnp.asarray(xi)))
    depth = s["depths"][3]
    want = s["jslam"]._icp(*map(jnp.asarray, (
        depth, rc.points.numpy(), rc.normals.numpy(), rc.mask.numpy(),
        T_init, T_render)))
    got = picp.track(torch.tensor(depth), rc.points, rc.normals, rc.mask,
                     torch.tensor(T_init), torch.tensor(T_render),
                     s["pcfg"].rig.intr)
    assert bool(got.converged) and bool(want.converged)
    _pose_close(got.T_wc.numpy(), want.T_wc, 1e-5)
    np.testing.assert_allclose(got.inlier_frac.numpy(), want.inlier_frac,
                               atol=1e-5)
    np.testing.assert_allclose(got.rmse.numpy(), want.rmse, atol=1e-5)
    assert np.abs(got.T_wc.numpy()[:3, 3] - T_true[:3, 3]).max() < 0.03


def test_depth_postprocess_matches_jax(icp_drive):
    """The cull of frame 3's depth against frame 2's, with frame 3's pose
    pushed 0.3 m so that the lower half disagrees."""
    s = icp_drive
    T_prev = s["poses"][2].astype(np.float32)
    T_curr = s["poses"][3].astype(np.float32).copy()
    T_curr[2, 3] += 0.3
    args = (s["depths"][3], T_curr, s["depths"][2], T_prev)
    want = np.asarray(s["jslam"]._postproc(*map(jnp.asarray, args)))
    got = pd.depth_postprocess(*map(torch.tensor, args), s["pcfg"]).numpy()
    culled_w = (want == 0) & (args[0] > 0)
    culled_g = (got == 0) & (args[0] > 0)
    assert culled_g.mean() > 0.05
    assert (culled_g != culled_w).mean() <= 1e-3
    keep = ~culled_g & ~culled_w
    np.testing.assert_array_equal(got[keep], want[keep])


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
