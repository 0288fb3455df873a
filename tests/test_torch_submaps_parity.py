"""The port's submaps against the JAX package on the same numpy inputs, on
the CPU: a short per-frame drive through both packages' `DenseSLAM` with
the new-submap policy and a memory budget: spawns, spills, deferred corrections, the
inter-submap alignment, a ghost composite with a restore, the delta
respill and the sequence-end flush.

The drive: `tiny_test_config` (80x60, 4096 slots) with online correction
(3 a call, 1 to start, min_error 0.005), a 32-node pose graph, an 8-slot
fusion DB,
new_submap_threshold 0.5 and a budget of 1.5 submaps (each package's own
submap: the port's DB depth is int32, JAX's uint16); 10 frames turning
0.25 rad a frame through the default scene, fused from JAX-rendered depth
at given poses drifted by 4 cm / 0.01 rad, then the backend's poses set
to the truth. JAX runs jitted, as its DenseSLAM does. Tolerances, and why:
  * the registry (submap count, anchor frames, where each submap lives),
    the swap counters, the pending frame ids, the delta rows (the mask of
    `online_correction_delta`) and the re-fuse counts equal;
  * global poses after the alignment within 1e-4 (the graph's Jacobians
    and solve round in another order, as the loop graph's do,
    tests/test_torch_backend.py);
  * maps: tables, stamps and counters equal; weights and colours on all
    but 1e-3 of the pool, tsdf within 5e-5 on all but 1e-3 of it (XLA
    contracts the running averages into FMAs; tests/test_torch_frame.py);
  * the composite depth: the same pixels hit, depth within 1e-4 m on all
    but 3% of them and within 0.05 m (a voxel) on all (observed 1.5% and
    0.021 m after a restore with replays, 0.02% with ghosts). This is
    more than the renders alone need (keys equal on 99.5% of pixels): the
    submaps render through their alignment delta, a rotated camera, and
    rendering one and the same map there, the jitted JAX splat and the
    port's part on 2.3% of the pixels (FMA-contracted projections pick
    another voxel at a depth edge); op by op the renders are bit for bit
    (tests/test_torch_render.py).
The drive is made once a test run (tests/_torch_shared.py) and shared
with tests/test_torch_submaps_parity_state.py: the state carried across
(`io/convert.py`), the block-row transfer, the composite merge and the
host-side frustum filter `_inview_slots`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import OnlineCorrectionParams, tiny_test_config
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.models import dense_slam as jd
from denseslam_tpu.utils import lie as jl
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import dense_slam as pd
from _torch_shared import shared

N = 9
SPAWN_FRAMES = [0, 2, 5]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are small: one thread each spares the other
    test processes of a parallel run the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config():
    c = tiny_test_config()
    return dataclasses.replace(
        c,
        correction=OnlineCorrectionParams(
            enabled=True, correction_num=3, start_correction_num=1,
            min_error=0.005),
        # the inter-submap graph holds a node a submap (3 here): 32 slots
        # spare both packages the 1536-wide dense solve of the default 256
        backend=dataclasses.replace(c.backend, max_pg_nodes=32,
                                    max_pg_edges=64),
        pipeline=dataclasses.replace(c.pipeline, fusion_db_capacity=8,
                                     new_submap_threshold=0.5))


def _with_budget(cfg, one_bytes):
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, map_memory_budget_mb=1.5 * one_bytes / 1e6))


def _jax_state(jslam):
    """The JAX DenseSLAM's state in io/convert.py's layout (copies)."""
    sm = jslam.submaps
    return dict(
        submaps=[convert.submap_state_to_numpy(sm, i)
                 for i in range(sm.num_local_maps)],
        fe_state=[np.array(x) for x in jax.tree.leaves(jslam.fe_state)],
        frame=int(jslam.frame),
        pose_history=[(int(f), np.asarray(T, np.float32))
                      for f, T in jslam.pose_history])


def _registry(slam):
    sm = slam.submaps
    return dict(
        n=sm.num_local_maps, anchors=list(sm.anchor_frames),
        on_host=[sm.is_on_host(i) for i in range(sm.num_local_maps)],
        dirty=list(sm.dirty),
        counters=(sm.num_evictions, sm.num_restores, sm.num_ghost_renders,
                  sm.num_delta_spills, sm.num_async_spills),
        pending=[sorted(p) for p in sm.pending_corrections],
        delta_rows=[None if r is None else np.asarray(r).tolist()
                    for r in sm._delta_rows])


def _snapshot(jslam, pslam):
    return dict(jax=_registry(jslam), port=_registry(pslam),
                jstate=_jax_state(jslam),
                pstate=convert.slam_state_to_numpy(pslam))


def _drive():
    """The drive's stages, each package's state at each, and the frustum
    filter of every submap from the final JAX state at three poses (JAX's
    and the port's, from that state loaded into it): plain values, which
    tests/test_torch_submaps_parity_state.py shares."""
    cfg = _config()
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    jcfg = _with_budget(cfg, jd.DenseSLAM(cfg).submaps.submap_device_bytes(0))
    pcfg = _with_budget(pcfg, pd.DenseSLAM(pcfg, device="cpu")
                        .submaps.submap_device_bytes(0))
    gt = js.make_trajectory(N, step_m=0.1, yaw_rate=0.25)
    rng = np.random.default_rng(5)
    drift = [gt[0]] + [(gt[i] @ jl.se3_exp_np(np.concatenate(
        [rng.normal(0, 0.04, 3), rng.normal(0, 0.01, 3)]))).astype(
            np.float32) for i in range(1, N)]
    depths = [np.asarray(js.render_view(jnp.asarray(gt[i]),
                                        cfg.rig.intr)[1]) for i in range(N)]
    jslam = jd.DenseSLAM(jcfg)
    pslam = pd.DenseSLAM(pcfg, device="cpu")
    stages = {}
    for i in range(N):
        jslam.process_frame(jnp.zeros_like(depths[i]),
                            depth=jnp.asarray(depths[i]),
                            pose_override=jnp.asarray(drift[i]))
        pslam.process_frame(torch.zeros(depths[i].shape),
                            depth=torch.tensor(depths[i]),
                            pose_override=drift[i])
        if i == 3:      # two submaps, the first spilled
            stages["two_submaps"] = _snapshot(jslam, pslam)
    stages["drive"] = _snapshot(jslam, pslam)
    ids, poses = np.arange(N), np.stack(gt)
    refused = (jslam.apply_pose_updates(ids, poses),
               pslam.apply_pose_updates(ids, poses))
    stages["updates"] = dict(_snapshot(jslam, pslam), refused=refused)
    T_eval = gt[0]
    rcj = jslam.raycast_composite(jnp.asarray(T_eval), respill=False,
                                  ghost=True)
    rcp = pslam.raycast_composite(T_eval, respill=False, ghost=True)
    stages["composite"] = dict(_snapshot(jslam, pslam),
                               depth=(np.asarray(rcj.depth),
                                      rcp.depth.numpy()))
    jslam.submaps.enforce_memory_budget()
    pslam.submaps.enforce_memory_budget()
    stages["enforced"] = _snapshot(jslam, pslam)
    # poses moved again by about 1.5 cm: past min_error, below the replay
    # trigger, so the spilled submaps ghost-render and the flush replays
    nudged = np.stack([(T @ jl.se3_exp_np(np.r_[rng.normal(0, 0.012, 3),
                                               np.zeros(3)]))
                       for T in gt]).astype(np.float32)
    jslam.apply_pose_updates(ids, nudged)
    pslam.apply_pose_updates(ids, nudged)
    rcj = jslam.raycast_composite(jnp.asarray(T_eval), respill=False,
                                  ghost=True)
    rcp = pslam.raycast_composite(T_eval, respill=False, ghost=True)
    stages["ghost"] = dict(_snapshot(jslam, pslam),
                           depth=(np.asarray(rcj.depth), rcp.depth.numpy()))
    flushed = (jslam.flush_deferred_corrections(),
               pslam.flush_deferred_corrections())
    stages["flushed"] = dict(_snapshot(jslam, pslam), flushed=flushed)
    loaded = pd.DenseSLAM(pcfg, device="cpu")
    convert.slam_state_from_numpy(_jax_state(jslam), loaded)
    inview = [(np.asarray(jslam._inview_slots(idx, jnp.asarray(T))),
               loaded._inview_slots(idx, T))
              for T in gt[[0, 4, 8]]
              for idx in range(jslam.submaps.num_local_maps)]
    return dict(stages=stages, pcfg=pcfg, gt=gt, inview=inview)


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    return shared("submaps_parity_drive", _drive, tmp_path_factory)


STAGES = ["two_submaps", "drive", "updates", "composite", "enforced",
          "ghost", "flushed"]


def _maps_close(want, got):
    names = ["keys", "tsdf", "weight", "color", "alloc_frame", "last_seen",
             "frame", "decayed_blocks", "overflow"]
    for name, a, b in zip(names, want, got):
        if name not in ("tsdf", "weight", "color"):
            np.testing.assert_array_equal(b, a, name)
    for k in (2, 3):
        assert (want[k] != got[k]).mean() <= 1e-3
    assert (np.abs(want[1].astype(np.float32) - got[1].astype(np.float32))
            > 5e-5).mean() <= 1e-3


@pytest.mark.parametrize("stage", STAGES)
def test_drive_matches_jax(drive, stage):
    st = drive["stages"][stage]
    assert st["port"] == st["jax"]
    for a, b in zip(st["jstate"]["submaps"], st["pstate"]["submaps"]):
        _maps_close(a["map"], b["map"])
        np.testing.assert_array_equal(b["db"][0], a["db"][0])
        for x, y in zip(a["db"][1:], b["db"][1:]):
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-6)
        np.testing.assert_allclose(b["global_pose"], a["global_pose"],
                                   rtol=0, atol=1e-4)


def test_drive_exercised_the_machinery(drive):
    """What the drive is for: the policy spawned, the budget spilled, the
    alignment moved a submap, the composite restored and ghosted, the
    flush replayed; and the two packages agree on each count."""
    s = drive["stages"]
    assert s["drive"]["port"]["anchors"] == SPAWN_FRAMES
    assert s["drive"]["port"]["on_host"] == [True, True, False]
    assert s["updates"]["refused"][0] == s["updates"]["refused"][1] > 0
    assert all(s["updates"]["port"]["pending"][:2])
    evictions, restores, ghosts, deltas, _ = s["flushed"]["port"]["counters"]
    assert restores >= 4 and ghosts >= 1 and deltas >= 2
    assert s["flushed"]["flushed"][0] == s["flushed"]["flushed"][1] >= 1
    g = s["updates"]["pstate"]["submaps"]
    assert any(np.abs(e["global_pose"] - e["spawn_pose"]).max() > 1e-3
               for e in g)


@pytest.mark.parametrize("stage", ["composite", "ghost"])
def test_composite_depth_matches_jax(drive, stage):
    dj, dp = drive["stages"][stage]["depth"]
    assert (dj > 0).sum() > 500
    np.testing.assert_array_equal(dp > 0, dj > 0)
    diff = np.abs(dj - dp)
    assert (diff > 1e-4).mean() <= 0.03
    assert diff.max() < 0.05


