"""The port's submap spills and memory (models/dense_slam.py
`SubmapManager`), run on the CPU without the JAX package, as
tests/test_submaps.py holds the JAX package (split from
tests/test_torch_submaps.py, whose config, helpers and setup this file
shares): the memory budget's spills and restores, the compact, delta and
async spills bit for bit, no storage shared between host and device
copies, the clean cache, and the async spill's inherited defect (it
installs the dispatch snapshot), named where it is matched.
"""

import numpy as np
import torch

from denseslam_tpu_torch.io import synthetic
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.utils import lie
from test_torch_submaps import (CPU, _assert_same, _budget_cfg,  # noqa: F401
                                _drifted, _fuse, _leaves, _replayed_on_restore,
                                cfg, one_torch_thread)


def test_memory_budget_spills_and_restores(cfg):
    cfg2, _ = _budget_cfg(cfg)
    budget = cfg2.pipeline.map_memory_budget_mb * 1e6
    gt = synthetic.make_trajectory(5, step_m=0.06, yaw_rate=0.0)
    drift = [gt[0]] + _drifted(gt, np.random.default_rng(5), 0.04,
                               0.01)[1:]
    slam = pd.DenseSLAM(cfg2, device=CPU)
    _fuse(slam, cfg, drift, gt, range(3))
    blocks0 = slam.submaps.local_map_size(0)
    assert blocks0 > 0
    sm = slam.submaps
    sm.create_new(drift[3], anchor_frame_id=3)
    assert sm.is_on_host(0) and sm.num_evictions == 1
    assert sm.device_memory_bytes() <= budget
    assert sm.num_active_local_maps == 1
    assert sm.local_map_size(0) == blocks0
    _fuse(slam, cfg, drift, gt, range(3, 5))

    rc = slam.raycast_composite(gt[0])
    assert sm.is_on_host(0)
    assert int(rc.mask.sum()) > 100
    assert sm.num_restores >= 1

    T0_before = sm.dbs[0].T_fused.clone()
    restores = sm.num_restores
    assert slam.apply_pose_updates(np.arange(5), np.stack(gt)) > 0
    assert sm.is_on_host(0) and sm.num_restores == restores
    # frames 1-2 stash; frame 0 did not drift
    assert len(sm.pending_corrections[0]) == 2
    assert torch.equal(T0_before, sm.dbs[0].T_fused)

    slam.restore_submap(0)
    assert not sm.pending_corrections[0]
    assert not torch.equal(T0_before, sm.dbs[0].T_fused)
    sm.evict_to_host(0)
    slam.apply_pose_updates(np.array([4]), gt[4][None])
    assert not sm.pending_corrections[0]
    assert sm.num_restores == restores + 1



def test_compact_spill_roundtrip_bit_exact(cfg):
    slam = pd.DenseSLAM(cfg, device=CPU)
    gt = synthetic.make_trajectory(3, step_m=0.06, yaw_rate=0.01)
    _fuse(slam, cfg, gt, gt, range(3))
    sm = slam.submaps
    before = [t.clone() for t in _leaves(sm.maps[0])]
    sm.evict_to_host(0)
    host0 = sm.maps[0]
    _assert_same(before, _leaves(host0))
    sm.restore_to_device(0)
    assert not sm.is_on_host(0)
    _assert_same(before, _leaves(sm.maps[0]))
    # a clean restore evicts free: the host copy object comes back
    assert sm._spill_cache[0] is not None and not sm.dirty[0]
    sm.evict_to_host(0)
    assert sm.maps[0] is host0
    # a dirty restore fetches again
    sm.restore_to_device(0)
    sm.maps[0] = sm.maps[0]._replace(tsdf=sm.maps[0].tsdf * 0.5)
    sm.mark_dirty(0)
    sm.evict_to_host(0)
    assert torch.equal(sm.maps[0].tsdf, before[1] * 0.5)



def test_host_and_device_copies_share_no_storage(cfg):
    """On the CPU `.to("cpu")` returns the tensor itself: every evict and
    restore must copy, or an in-place correction of a restored submap
    would change its cached host copy."""
    slam = pd.DenseSLAM(cfg, device=CPU)
    gt = synthetic.make_trajectory(3, step_m=0.06, yaw_rate=0.01)
    _fuse(slam, cfg, gt, gt, range(3))
    sm = slam.submaps
    sm.create_new(gt[2], anchor_frame_id=2)
    sm._SPILL_GRAN = 256                  # so that the async spill compacts
    dev_m, dev_db = sm.maps[0], sm.dbs[0]
    for evict in (sm.evict_to_host, sm.evict_to_host_async):
        sm.mark_dirty(0)
        evict(0)
        sm.finalize_spills()
        host_m, host_db = sm.maps[0], sm.dbs[0]
        sm.restore_to_device(0)
        for a, b, c in zip(_leaves(dev_m) + list(dev_db),
                           _leaves(host_m) + list(host_db),
                           _leaves(sm.maps[0]) + list(sm.dbs[0])):
            if a.numel():
                assert len({a.data_ptr(), b.data_ptr(), c.data_ptr()}) == 3
        dev_m, dev_db = sm.maps[0], sm.dbs[0]
    # writing the restored copy leaves the clean cache as it was
    cached = sm._spill_cache[0][0].tsdf.clone()
    sm.maps[0].tsdf.mul_(0.5)
    assert torch.equal(sm._spill_cache[0][0].tsdf, cached)



def test_budget_caps_clean_cache_footprint(cfg):
    cfg2, one = _budget_cfg(cfg)
    slam = pd.DenseSLAM(cfg2, device=CPU)
    gt = synthetic.make_trajectory(4, step_m=0.06, yaw_rate=0.0)
    _fuse(slam, cfg, gt, gt, range(3))
    slam.submaps.create_new(gt[3], anchor_frame_id=3)
    assert slam.submaps.is_on_host(0)
    slam.submaps.restore_to_device(0)
    assert slam.submaps.device_memory_bytes() > 1.5 * one
    assert 0 in slam.submaps.enforce_memory_budget()
    assert slam.submaps.is_on_host(0)
    assert slam.submaps.device_memory_bytes() <= 1.5 * one



def test_delta_respill_bit_exact(cfg):
    slam, _ = _replayed_on_restore(cfg, 3)
    sm = slam.submaps
    assert slam.restore_submap(0) > 0
    assert sm.dirty[0] and sm._delta_rows[0].size > 0
    ref = [t.clone() for t in _leaves(sm.maps[0])]
    db_ref = [t.clone() for t in sm.dbs[0]]
    sm.evict_to_host(0)
    assert sm.num_delta_spills == 1 and sm.is_on_host(0)
    _assert_same(ref, _leaves(sm.maps[0]))
    _assert_same(db_ref, list(sm.dbs[0]))



def test_async_spill_matches_sync(cfg):
    slam = pd.DenseSLAM(cfg, device=CPU)
    gt = synthetic.make_trajectory(3, step_m=0.06, yaw_rate=0.0)
    _fuse(slam, cfg, gt, gt, range(3))
    sm = slam.submaps
    sm.create_new(gt[2], anchor_frame_id=2)
    # the 4096-slot test pool fits one row bucket, which the async path
    # declines as not compacted
    sm._SPILL_GRAN = 256
    ref = [t.clone() for t in _leaves(sm.maps[0])]
    db_ref = [t.clone() for t in sm.dbs[0]]
    assert sm.evict_to_host_async(0)
    assert sm.num_async_spills == 1 and not sm.is_on_host(0)
    sm.finalize_spills()
    assert sm.is_on_host(0)
    _assert_same(ref, _leaves(sm.maps[0]))
    _assert_same(db_ref, list(sm.dbs[0]))
    sm.restore_to_device(0)
    assert not sm.is_on_host(0)
    _assert_same(ref, _leaves(sm.maps[0]))



def test_async_spill_installs_the_dispatch_snapshot(cfg):
    """The defect the port inherits from the JAX package's
    `evict_to_host_async`: what lands is the snapshot taken at dispatch,
    so a device-side change between dispatch and landing is lost."""
    slam = pd.DenseSLAM(cfg, device=CPU)
    gt = synthetic.make_trajectory(3, step_m=0.06, yaw_rate=0.0)
    _fuse(slam, cfg, gt, gt, range(3))
    sm = slam.submaps
    sm.create_new(gt[2], anchor_frame_id=2)
    sm._SPILL_GRAN = 256
    snap = [t.clone() for t in _leaves(sm.maps[0])]
    assert sm.evict_to_host_async(0)
    sm.maps[0].tsdf.mul_(0.5)             # a change while in flight
    sm.dbs[0].T_fused[0, 0, 3] += 1.0
    sm.finalize_spills()
    _assert_same(snap, _leaves(sm.maps[0]))
    assert sm.dbs[0].T_fused[0, 0, 3] == 0.0



def test_clean_cache_drop_and_registry_helpers(cfg):
    """drop_clean_cache frees a clean resident for free; a global pose set
    by set_estimated_global_pose moves delta() and with it the frustum
    filter behind _spilled_submap_in_view."""
    slam = pd.DenseSLAM(cfg, device=CPU)
    gt = synthetic.make_trajectory(4, step_m=0.06, yaw_rate=0.0)
    _fuse(slam, cfg, gt, gt, range(3))
    sm = slam.submaps
    sm.create_new(gt[3], anchor_frame_id=3)
    sm.evict_to_host(0)
    host0 = sm.maps[0]
    sm.restore_to_device(0)
    evictions = sm.num_evictions
    assert sm.drop_clean_cache() == 1
    assert sm.is_on_host(0) and sm.maps[0] is host0
    assert sm.num_evictions == evictions + 1
    assert sm.drop_clean_cache() == 0
    assert slam._spilled_submap_in_view(0, gt[0])
    away = lie.se3_exp_np(np.array([0.0, 0.0, -50.0, 0.0, 0.0, 0.0]))
    sm.set_estimated_global_pose(0, away)
    np.testing.assert_allclose(sm.delta(0), away, atol=1e-6)
    assert not slam._spilled_submap_in_view(0, gt[0])

