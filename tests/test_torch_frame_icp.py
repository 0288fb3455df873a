"""The per-frame path's internal odometry in the port against the JAX
package (split from tests/test_torch_frame.py, whose stereo drive these
do not use): `DenseSLAM.process_frame` with internal ICP odometry
(`use_external_odometry=False`, the bilateral filter and the depth
post-processing on), a given pose (`pose_override`), ICP `track` and
`depth_postprocess`, on 5 frames of the default scene at 160x120.

Tolerances, and why:
  * ICP `track` from the same model: poses within 1e-5 (its 6x6 normal
    equations sum over pixels in another order than XLA's). The ICP
    drive: poses within 1e-3 m (observed 2.1e-4; its ICP settles at a
    1.6 cm RMSE, and the jitted JAX render's FMA-rounded model points
    move the poorly constrained solution), its RMSE within 1e-4 m; the
    map fused at those poses: keys on all but 1e-3 of the table, tsdf
    within 5e-3 (a 2e-4 m move over the 0.2 m truncation is 1e-3) on all
    but 1e-3 of the pool;
  * `depth_postprocess`: the culled pixels equal on all but 1e-3 (the
    3x3 point transforms round differently at the 10% gate).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import (PostProcessParams, StereoConfig,
                                  tiny_test_config)
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.models import dense_slam as jd
from denseslam_tpu.utils import lie as jl
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.ops import icp as picp
from denseslam_tpu_torch.ops import splat as psp
from test_torch_frame import _pose_close, one_torch_thread  # noqa: F401


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

