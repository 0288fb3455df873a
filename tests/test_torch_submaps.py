"""The port's submaps (models/dense_slam.py `SubmapManager` and the
multi-submap methods of `DenseSLAM`), run on the CPU without the JAX
package: the properties tests/test_submaps.py holds the JAX package to,
on the same scenes and drifts (the port's own synthetic renderer and
numpy se(3) exp), the chunk path's spawn of tests/test_system.py, and
the flush's inherited defect, named where it is matched. The spills and
the memory budget are in tests/test_torch_submaps_spill.py, which shares
this file's config and helpers.

Config: `tiny_test_config` (80x60, 4096 slots) with online correction
(3 a call, 1 to start, min_error 0.005) and an 8-slot fusion DB, as
tests/test_submaps.py sets it. Frames are fused at given poses
(`pose_override`) from rendered depth.
"""

import dataclasses

import numpy as np
import pytest
import torch

from denseslam_tpu_torch.config import (OnlineCorrectionParams, StereoConfig,
                                        tiny_test_config)
from denseslam_tpu_torch.io import synthetic
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.models.system import SLAMSystem
from denseslam_tpu_torch.ops import tsdf as pt
from denseslam_tpu_torch.utils import lie

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are small: one thread each spares the other
    test processes of a parallel run the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    c = tiny_test_config()
    return dataclasses.replace(
        c,
        correction=OnlineCorrectionParams(
            enabled=True, correction_num=3, start_correction_num=1,
            min_error=0.005),
        pipeline=dataclasses.replace(c.pipeline, fusion_db_capacity=8))


def _budget_cfg(cfg, factor=1.5):
    one = pd.DenseSLAM(cfg, device=CPU).submaps.submap_device_bytes(0)
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, map_memory_budget_mb=factor * one / 1e6)), one


def _fuse(slam, cfg, poses, true_poses, idx, scene=None):
    for i in idx:
        _, depth = synthetic.render_view(true_poses[i], cfg.rig.intr, scene,
                                         device=CPU)
        slam.process_frame(torch.zeros_like(depth), depth=depth,
                           pose_override=poses[i])


def _drifted(gt, rng, trans, rot):
    return [(gt[i] @ lie.se3_exp_np(np.concatenate(
        [rng.normal(0, trans, 3), rng.normal(0, rot, 3) if rot else
         np.zeros(3)]))).astype(np.float32) for i in range(len(gt))]


def _two_submaps(cfg, drift, gt, evict=False, slam=None):
    """Frames 0-2 into submap 0, a spawn at frame 3, frames 3-4 into
    submap 1 (submap 0 spilled before them with `evict`)."""
    slam = slam or pd.DenseSLAM(cfg, device=CPU)
    _fuse(slam, cfg, drift, gt, range(3))
    slam.submaps.create_new(drift[3], anchor_frame_id=3)
    if evict:
        slam.submaps.evict_to_host(0)
    _fuse(slam, cfg, drift, gt, range(3, 5))
    return slam


def _leaves(m):
    return pd._map_leaves(m)


def _assert_same(a_leaves, b_leaves):
    for a, b in zip(a_leaves, b_leaves):
        assert a.dtype == b.dtype
        assert torch.equal(a.cpu(), b.cpu())


def _err_matrix():
    # a visible rigid drift: vertical lift + pitch, which moves the ground
    # plane and the spheres in depth
    return lie.se3_exp_np(np.array([0.05, 0.18, 0.0, 0.03, 0.0, 0.0]))


def _composite_err(slam, T_eval, gt_depth, sel):
    d = slam.raycast_composite(T_eval).depth.numpy()
    both = (d > 0) & sel
    assert both.sum() > 300, both.sum()
    return float(np.median(np.abs(d[both] - gt_depth[both])))


def test_alignment_realigns_composite(cfg):
    scene = synthetic.street_scene(length_m=40.0)
    slam = pd.DenseSLAM(cfg, device=CPU)
    gt = synthetic.make_trajectory(6, step_m=2.0, yaw_rate=0.0)
    D_err = _err_matrix()
    drift = list(gt[:3]) + [(D_err @ gt[i]).astype(np.float32)
                            for i in range(3, 6)]
    _fuse(slam, cfg, drift, gt, range(3), scene)
    slam.submaps.create_new(drift[3], anchor_frame_id=3)
    _fuse(slam, cfg, drift, gt, range(3, 6), scene)
    assert slam.submaps.num_local_maps == 2

    # only where submap 1 is the sole source
    T_eval = gt[5]
    _, g = synthetic.render_view(T_eval, cfg.rig.intr, scene, device=CPU)
    g = g.numpy()
    rc0 = slam._render(slam.submaps.maps[0], torch.as_tensor(T_eval))
    sel = (~rc0.mask.numpy()) & (g > 0) & (g < cfg.tsdf.max_depth_m)
    err_before = _composite_err(slam, T_eval, g, sel)

    slam.apply_pose_updates(np.array([0, 3]), np.stack([gt[0], gt[3]]))
    d_target = np.linalg.inv(D_err)
    assert np.linalg.norm(slam.submaps.delta(1) - d_target) < 0.05
    err_after = _composite_err(slam, T_eval, g, sel)
    assert err_after < err_before * 0.5, (err_before, err_after)


def test_correction_history_survives_spawn(cfg):
    gt = synthetic.make_trajectory(5, step_m=0.06, yaw_rate=0.0)
    drift = [gt[0]] + _drifted(gt, np.random.default_rng(5), 0.04,
                               0.01)[1:]
    slam = _two_submaps(cfg, drift, gt)
    assert int(slam.submaps.dbs[0].valid.sum()) == 3
    T0_before = slam.submaps.dbs[0].T_fused.clone()
    num = slam.apply_pose_updates(np.arange(5), np.stack(gt))
    assert num > 0
    assert slam.submaps.pending_corrections[0]
    assert torch.equal(T0_before, slam.submaps.dbs[0].T_fused)
    assert slam.restore_submap(0) > 0
    assert not torch.equal(T0_before, slam.submaps.dbs[0].T_fused)


def test_subtrigger_corrections_replay_at_flush(cfg):
    gt = synthetic.make_trajectory(5, step_m=0.06, yaw_rate=0.0)
    # about 2 cm: past min_error 0.005, below the 0.05 replay trigger
    drift = _drifted(gt, np.random.default_rng(7), 0.012, 0.0)
    slam = _two_submaps(cfg, drift, gt)
    T0_before = slam.submaps.dbs[0].T_fused.clone()
    slam.apply_pose_updates(np.arange(5), np.stack(gt))
    pend = slam.submaps.pending_corrections[0]
    assert pend
    assert all(e <= cfg.correction.inactive_min_error
               for _, e in pend.values())
    assert slam.restore_submap(0) == 0
    assert slam.submaps.pending_corrections[0]
    assert torch.equal(T0_before, slam.submaps.dbs[0].T_fused)
    slam.submaps.evict_to_host(0)
    assert slam.flush_deferred_corrections() == 1
    assert not slam.submaps.pending_corrections[0]
    assert not torch.equal(T0_before, slam.submaps.dbs[0].T_fused)


def test_ghost_render_matches_full_restore(cfg):
    gt = synthetic.make_trajectory(5, step_m=0.06, yaw_rate=0.0)
    slam = _two_submaps(cfg, list(gt), gt, evict=True)
    T_eval = gt[0]
    d_full = slam.raycast_composite(T_eval).depth.numpy()
    assert slam.submaps.is_on_host(0)
    restores = slam.submaps.num_restores
    d_ghost = slam.raycast_composite(T_eval, ghost=True).depth.numpy()
    assert slam.submaps.is_on_host(0)
    assert slam.submaps.num_restores == restores
    assert slam.submaps.num_ghost_renders >= 1
    both = (d_full > 0) & (d_ghost > 0)
    assert both.sum() > 500
    assert np.median(np.abs(d_full[both] - d_ghost[both])) < 0.02
    assert (d_ghost > 0).sum() > 0.95 * (d_full > 0).sum()


def _replayed_on_restore(cfg, seed):
    gt = synthetic.make_trajectory(5, step_m=0.06, yaw_rate=0.0)
    drift = _drifted(gt, np.random.default_rng(seed), 0.04, 0.01)
    slam = _two_submaps(cfg, drift, gt, evict=True)
    slam.apply_pose_updates(np.arange(5), np.stack(gt))
    assert slam.submaps.pending_corrections[0]
    return slam, gt


def test_ghost_defers_to_restore_on_armed_corrections(cfg):
    slam, gt = _replayed_on_restore(cfg, 11)
    pend = slam.submaps.pending_corrections[0]
    assert any(e > cfg.correction.inactive_min_error for _, e in pend.values())
    ghosts = slam.submaps.num_ghost_renders
    restores = slam.submaps.num_restores
    slam.raycast_composite(gt[0], ghost=True)
    assert slam.submaps.num_restores == restores + 1
    assert slam.submaps.num_ghost_renders == ghosts
    assert not slam.submaps.pending_corrections[0]


def test_flush_holds_every_flushed_submap_at_once(cfg):
    """The defect the port inherits from the JAX package's
    `flush_deferred_corrections`: the budget is enforced once, after the
    loop, so the device peak during a flush is the active submap plus
    every flushed one, however small the budget."""
    cfg2, one = _budget_cfg(cfg, factor=1.5)
    gt = synthetic.make_trajectory(7, step_m=0.06, yaw_rate=0.0)
    drift = _drifted(gt, np.random.default_rng(3), 0.04, 0.01)
    slam = pd.DenseSLAM(cfg2, device=CPU)
    _fuse(slam, cfg, drift, gt, range(2))
    slam.submaps.create_new(drift[2], anchor_frame_id=2)
    _fuse(slam, cfg, drift, gt, range(2, 4))
    slam.submaps.create_new(drift[4], anchor_frame_id=4)
    _fuse(slam, cfg, drift, gt, range(4, 7))
    sm = slam.submaps
    assert sm.is_on_host(0) and sm.is_on_host(1)
    slam.apply_pose_updates(np.arange(7), np.stack(gt))
    assert sm.pending_corrections[0] and sm.pending_corrections[1]
    peak = [0]
    restore = slam.restore_submap

    def watched(si, force_replay=False):
        n = restore(si, force_replay=force_replay)
        peak[0] = max(peak[0], sm.device_memory_bytes())
        return n

    slam.restore_submap = watched
    assert slam.flush_deferred_corrections() == 2
    assert peak[0] == 3 * one
    assert sm.device_memory_bytes() <= cfg2.pipeline.map_memory_budget_mb * 1e6


def test_chunk_mode_submap_spawn():
    """The chunk path runs the spawn policy once a chunk: turning away from
    the fused scene spawns a submap, and the old one keeps its DB (the
    drive of tests/test_system.py:272 at 160x120 with 256 features, 32
    RANSAC hypotheses and 32 disparities)."""
    cfg = tiny_test_config(width=160, height=120, baseline_m=0.25)
    cfg = dataclasses.replace(
        cfg,
        frontend=dataclasses.replace(cfg.frontend, max_features=256,
                                     ransac_iters=32, bucket_w=25,
                                     bucket_h=25),
        stereo=StereoConfig(max_disparity=32),
        pipeline=dataclasses.replace(cfg.pipeline, fusion_db_capacity=8,
                                     new_submap_threshold=0.5))
    system = SLAMSystem(cfg, ba_every=0, loop_every=0, device=CPU)
    n, chunk = 12, 4
    poses = synthetic.make_trajectory(n, step_m=0.1, yaw_rate=0.18)
    lefts, rights, _ = synthetic.render_stereo_trajectory(poses, cfg.rig,
                                                          device=CPU)
    for i in range(0, n, chunk):
        system.process_chunk(lefts[i:i + chunk], rights[i:i + chunk])
    assert system.slam.submaps.num_local_maps >= 2
    assert int(system.slam.submaps.dbs[0].valid.sum()) > 0


def test_rebuild_from_rows_inverts_gather(cfg):
    """gather_block_rows of the allocated slots, then rebuild_from_rows
    through the inverse permutation, gives the pool back bit for bit."""
    slam = pd.DenseSLAM(cfg, device=CPU)
    gt = synthetic.make_trajectory(2, step_m=0.06, yaw_rate=0.0)
    _fuse(slam, cfg, gt, gt, range(2))
    m = slam.submaps.active
    slots = torch.nonzero(m.table.valid).flatten()
    n, s = slots.numel(), m.num_slots
    inv = torch.full((s,), n, dtype=torch.int64)
    inv[slots] = torch.arange(n)
    back = pt.rebuild_from_rows(inv, *pt.gather_block_rows(m, slots),
                                m.frame, m.decayed_blocks, m.overflow)
    _assert_same(_leaves(m), _leaves(back))


