"""The port's submaps against the JAX package on the same numpy inputs, on
the CPU: the block-row transfer (`gather_block_rows` /
`rebuild_from_rows`), the composite merge, the host-side frustum filter
`_inview_slots`, the state carried across (`io/convert.py`), and a short
per-frame drive through both packages' `DenseSLAM` with the new-submap
policy and a memory budget: spawns, spills, deferred corrections, the
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
The ops: bit for bit (the row gathers run op by op, the composite merge
against its jitted JAX form), and `_inview_slots` the same slot set from
the same state (float64 numpy on both sides).
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
from denseslam_tpu.ops import raycast as jrc
from denseslam_tpu.ops import tsdf as jt
from denseslam_tpu.utils import lie as jl
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.ops import raycast as prc
from denseslam_tpu_torch.ops import tsdf as pt

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


@pytest.fixture(scope="module")
def drive():
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
    return dict(stages=stages, jslam=jslam, pslam=pslam, gt=gt)


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


@pytest.mark.parametrize("stage", ["two_submaps", "updates"])
def test_state_round_trip_from_jax(drive, stage):
    """A JAX multi-submap state (submaps on the host and on the device,
    deferred corrections) loaded into the port and read back, bit for
    bit."""
    want = drive["stages"][stage]["jstate"]
    pslam = pd.DenseSLAM(drive["pslam"].cfg, device="cpu")
    convert.slam_state_from_numpy(want, pslam)
    assert any(pslam.submaps.is_on_host(i)
               for i in range(pslam.submaps.num_local_maps))
    got = convert.slam_state_to_numpy(pslam)
    assert len(got["submaps"]) == len(want["submaps"]) >= 2
    for a, b in zip(want["submaps"], got["submaps"]):
        for x, y in zip(a["map"] + a["db"], b["map"] + b["db"]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(y, x)
        for k in ("on_host", "anchor_frame", "dirty"):
            assert a[k] == b[k]
        for k in ("global_pose", "spawn_pose"):
            np.testing.assert_array_equal(b[k], a[k])
        assert sorted(a["pending"]) == sorted(b["pending"])
        for f, (T, e) in a["pending"].items():
            np.testing.assert_array_equal(b["pending"][f][0], T)
            assert b["pending"][f][1] == e
    for x, y in zip(want["fe_state"], got["fe_state"]):
        np.testing.assert_array_equal(y, x)


def test_block_rows_match_jax(drive):
    """gather_block_rows and rebuild_from_rows on the same map and slots,
    bit for bit."""
    leaves = drive["stages"]["drive"]["jstate"]["submaps"][0]["map"]
    jm = jax.tree.unflatten(jax.tree.structure(jt.make_map(
        _config().tsdf)), [jnp.asarray(x) for x in leaves])
    pm = convert.map_state_from_numpy(leaves, "cpu")
    keys = leaves[0]
    slots = np.flatnonzero(keys != 2 ** 30).astype(np.int32)
    n, s = slots.size, keys.size
    npad = n + 7
    pad = np.zeros(npad, np.int32)
    pad[:n] = slots
    rj = jt.gather_block_rows(jm, jnp.asarray(pad))
    rp = pt.gather_block_rows(pm, torch.tensor(pad))
    for a, b in zip(rj, rp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    inv = np.full(s, npad, np.int32)
    inv[slots] = np.arange(n, dtype=np.int32)
    scal = (leaves[6], leaves[7], leaves[8])
    bj = jt.rebuild_from_rows(jnp.asarray(inv), *rj, *scal)
    bp = pt.rebuild_from_rows(torch.tensor(inv), *rp, *(torch.tensor(x)
                                                       for x in scal))
    for a, b in zip(jax.tree.leaves(bj), convert.map_state_to_numpy(bp)):
        np.testing.assert_array_equal(b, np.asarray(a))
    for a, b in zip(leaves, convert.map_state_to_numpy(bp)):
        np.testing.assert_array_equal(b, a)


def _raycast_pair(rng, h=12, w=16):
    depth = rng.uniform(0.5, 5.0, (h, w)).astype(np.float32)
    mask = rng.uniform(size=(h, w)) < 0.7
    depth[~mask] = 0.0
    pts = rng.normal(0, 3, (h, w, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (h, w, 3)).astype(np.float32)
    col = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    arrs = (depth, pts, nrm, mask, col)
    return (jrc.Raycast(*(jnp.asarray(a) for a in arrs)),
            prc.Raycast(*(torch.tensor(a) for a in arrs)))


def test_composite_merge_matches_jax():
    """_composite_transform and _composite_merge against the JAX functions
    jitted, as the JAX DenseSLAM runs them: bit for bit. (Its 3x3 dots are
    an FMA chain there, as in torch's CPU matmul; run op by op, XLA:CPU's
    dot rounds the three-term sums another way, on about half of them.)"""
    rng = np.random.default_rng(2)
    bj, bp = _raycast_pair(rng)
    rj, rp = _raycast_pair(rng)
    D = jl.se3_exp_np(np.array([0.3, -0.1, 0.2, 0.05, -0.2, 0.1]))
    fj = jax.jit(jd._composite_transform)(bj, jnp.asarray(D))
    mj = jax.jit(jd._composite_merge)(fj, rj, jnp.asarray(D))
    fp = pd._composite_transform(bp, torch.tensor(D))
    mp = pd._composite_merge(fp, rp, torch.tensor(D))
    for a, b in zip(tuple(fj) + tuple(mj), tuple(fp) + tuple(mp)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_inview_slots_match_jax(drive):
    """The frustum filter of every submap from the same state (the JAX
    drive's, loaded into the port), at three poses: the same slots."""
    jslam = drive["jslam"]
    pslam = pd.DenseSLAM(drive["pslam"].cfg, device="cpu")
    convert.slam_state_from_numpy(_jax_state(jslam), pslam)
    hits = 0
    for T in drive["gt"][[0, 4, 8]]:
        for idx in range(jslam.submaps.num_local_maps):
            want = jslam._inview_slots(idx, jnp.asarray(T))
            got = pslam._inview_slots(idx, T)
            np.testing.assert_array_equal(got, want)
            hits += want.size
    assert hits > 0
