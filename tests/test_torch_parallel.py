"""parallel/ of the port (the sharded map over torch.distributed, the
sharded BA) against JAX's ShardedTsdf on `make_map_mesh(4)` (the
conftest's virtual CPU devices) and against the port's own single-chip
path. The owner hash and the single-process launch, which need no ranks:
tests/test_torch_parallel_launch.py.

The four ranks are spawned once for the module (gloo on the CPU, one torch
thread each); every scenario runs inside that one spawn
(tests/_torch_parallel_ranks.py) and each test asserts on what the ranks
wrote. The JAX programs (the sharded fusion and raycast) compile once.

The frames are fused at their render poses lifted by (9.1, 13, 3.9) mm:
the synthetic street's floor lies exactly on a block face (y = 1.2 m),
where the middle band sample of every floor pixel ties, and jitted XLA
(which contracts the world-point multiply-adds into FMAs) and the port
(one rounding per op, as JAX run op by op) break the tie on opposite
sides for 6% of the keys. Lifted, JAX's jitted key generation equals its
op-by-op one on every key.

Tolerances: against the port's single-chip path every block, bit for bit.
Against JAX's jitted shard_map fusion keys, weights, stamps and counters
bit for bit, the tsdf within 5e-5 and colours equal on all but 1e-5 of
the voxels (the tolerance tests/test_torch_correction.py states for the
jitted JAX functions); the raycast depth within 1e-4 m of JAX's
where both hit; the sharded BA's poses within 1e-4 of the single solve
(the camera-side sums add in another order)."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import tiny_test_config
from denseslam_tpu.parallel import mesh as jmesh
from denseslam_tpu.parallel import sharded_map as jsm
from denseslam_tpu_torch.config import (OnlineCorrectionParams,
                                        VoxelDecayParams)
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.io import synthetic as ps
from denseslam_tpu_torch.ops import ba as pba_ops
from denseslam_tpu_torch.parallel import launch
from denseslam_tpu_torch.parallel import sharded_map as psm
from denseslam_tpu_torch.utils import lie as pl

RANKS = 4
N_FUSE = 3
N_DRIVE = 10          # the decay drive: blocks leave the view and decay
LIFT = np.float32([0.0091, 0.013, 0.0039])


def _inputs():
    cfg = tiny_test_config()
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    poses = ps.make_trajectory(4, step_m=0.07, yaw_rate=0.01)
    views = [ps.render_view(T, pcfg.rig.intr, device="cpu") for T in poses]
    poses = np.asarray(poses, np.float32).copy()
    poses[:, :3, 3] += LIFT
    drive = ps.make_trajectory(N_DRIVE, step_m=0.15, yaw_rate=0.05)
    drive_views = [ps.render_view(T, pcfg.rig.intr, device="cpu")
                   for T in drive]
    drive = np.asarray(drive, np.float32).copy()
    drive[:, :3, 3] += LIFT
    grays = [g.numpy() for g, _ in views]
    depths = [d.numpy() for _, d in views]
    rng = np.random.default_rng(3)
    drifted = [np.asarray(poses[0], np.float32)]
    for T in poses[1:]:
        xi = np.concatenate([rng.normal(0, 0.04, 3),
                             rng.normal(0, 0.01, 3)]).astype(np.float32)
        drifted.append((torch.tensor(np.asarray(T, np.float32))
                        @ pl.se3_exp(torch.tensor(xi))).numpy())
    spawn = ps.make_trajectory(6, step_m=0.06, yaw_rate=0.0)
    far = np.asarray(spawn[5], np.float32).copy()
    far[0, 3] += 12.0
    from tests.test_backend_ops import make_ba_problem
    bcfg = tiny_test_config(width=320, height=240, baseline_m=0.2)
    problem, _, _ = make_ba_problem(np.random.default_rng(0), K=4, L=64,
                                    rig=bcfg.rig)
    db8 = dataclasses.replace(pcfg.pipeline, fusion_db_capacity=8)
    return dict(
        cfg=pcfg, n_fuse=N_FUSE, render_at=1,
        poses=[np.asarray(T, np.float32) for T in poses], grays=grays,
        depths=depths, drifted=drifted,
        ccfg=dataclasses.replace(
            pcfg, pipeline=db8, correction=OnlineCorrectionParams(
                enabled=True, correction_num=3, start_correction_num=2,
                min_error=0.005)),
        dcfg=dataclasses.replace(pcfg, decay=VoxelDecayParams(
            enabled=True, min_decay_age=2, max_decay_weight=2)),
        drive_poses=list(drive), drive_grays=[g.numpy() for g, _ in
                                              drive_views],
        drive_depths=[d.numpy() for _, d in drive_views],
        scfg=dataclasses.replace(
            convert.config_from_dict(dataclasses.asdict(bcfg)),
            rig=pcfg.rig, tsdf=pcfg.tsdf,
            correction=OnlineCorrectionParams(
                enabled=True, correction_num=3, start_correction_num=1,
                min_error=0.005),
            pipeline=dataclasses.replace(db8, new_submap_threshold=0.6)),
        spawn_poses=[np.asarray(T, np.float32) for T in spawn[:3]],
        spawn_depths=[ps.render_view(T, pcfg.rig.intr, device="cpu")[1]
                      .numpy() for T in spawn[:3]],
        far=far, far_depth=ps.render_view(far, pcfg.rig.intr,
                                          device="cpu")[1].numpy(),
        ba_problem=[np.asarray(a) for a in problem],
        ba_rig=convert.config_from_dict(dataclasses.asdict(bcfg)).rig,
        jax_cfg=cfg)


@pytest.fixture(scope="module")
def ranks():
    """Spawn the ranks once; return each rank's record and the inputs."""
    sys.path.insert(0, os.path.dirname(__file__))
    import _torch_parallel_ranks as worker

    inp = _inputs()
    jax_cfg = inp.pop("jax_cfg")
    recs = launch.run_local(worker.scenarios, RANKS, inp, device="cpu")
    inp["jax_cfg"] = jax_cfg
    return recs, inp


@pytest.fixture(scope="module")
def jax_map(ranks):
    """JAX's sharded map over 4 virtual devices after the same frames, and
    its render at the same pose (one compile each)."""
    _, inp = ranks
    cfg = inp["jax_cfg"]
    st = jsm.ShardedTsdf(cfg, jmesh.make_map_mesh(RANKS))
    m = st.make_map()
    for i in range(N_FUSE):
        m = st.fuse(m, jnp.asarray(inp["depths"][i]),
                    jnp.asarray(inp["grays"][i]), jnp.asarray(inp["poses"][i]))
    rc = st.raycast(m, jnp.asarray(inp["poses"][inp["render_at"]]))
    return cfg, st, m, rc


def _shard(a, r):
    a = np.asarray(a)
    n = a.shape[0] // RANKS
    return a[r * n:(r + 1) * n]


def _assert_jax_shards(recs, name, m):
    """Each rank's map `name` is JAX's shard slice of `m`: keys, weights,
    stamps and counters bit for bit, the tsdf and colours within the
    jitted tolerance."""
    want = [np.asarray(x) for x in jax.tree.leaves(m)]
    for r, rec in enumerate(recs):
        got = rec[name]
        for i, (a, b) in enumerate(zip(want, got)):
            if i in (1, 3):
                continue
            a = _shard(a, r) if a.ndim else a
            np.testing.assert_array_equal(b, a, f"leaf {i}, rank {r}")
        np.testing.assert_allclose(got[1], _shard(want[1], r), rtol=0,
                                   atol=5e-5)
        assert (got[3] != _shard(want[3], r)).mean() <= 1e-5
        assert (got[0] != 2 ** 30).sum() > 100     # every rank owns blocks


def test_local_tables_equal_jax_shards(ranks, jax_map):
    """Each rank's table after 3 frames is JAX's shard slice."""
    recs, _ = ranks
    _assert_jax_shards(recs, "fuse_exchange", jax_map[2])


def test_sharded_decay_over_a_drive_equals_jax_shards(ranks):
    """A 10-frame drive with decay (age 2, weight 2): blocks leave the
    view, decay frees them and later frames allocate into the holes. Each
    rank's table is JAX's shard slice, keys and counters bit for bit: the
    sharded map parts from the single-chip one after decay only as JAX's
    does (the inherited hash defect, ops/hash.py)."""
    recs, inp = ranks
    cfg = inp["jax_cfg"]
    cfg = dataclasses.replace(cfg, decay=dataclasses.replace(
        cfg.decay, enabled=True, min_decay_age=2, max_decay_weight=2))
    st = jsm.ShardedTsdf(cfg, jmesh.make_map_mesh(RANKS))
    m = st.make_map()
    for d, g, T in zip(inp["drive_depths"], inp["drive_grays"],
                       inp["drive_poses"]):
        m = st.fuse(m, jnp.asarray(d), jnp.asarray(g), jnp.asarray(T))
    assert int(m.decayed_blocks) > 0
    # later inserts claimed holes that decay left: some shard holds a key
    # twice
    shards = [k[k != 2 ** 30] for k in np.split(np.asarray(m.table.keys),
                                                RANKS)]
    assert sum(k.size - np.unique(k).size for k in shards) > 0
    _assert_jax_shards(recs, "decay_drive", m)


def test_exchange_alloc_equals_replicated(ranks):
    recs, _ = ranks
    for rec in recs:
        kx, kr = rec["fuse_exchange"][0], rec["fuse_replicated"][0]
        np.testing.assert_array_equal(np.sort(kx), np.sort(kr))
        ox, orr = np.argsort(kx, kind="stable"), np.argsort(kr, kind="stable")
        for i in (1, 2, 3):
            np.testing.assert_array_equal(rec["fuse_exchange"][i][ox],
                                          rec["fuse_replicated"][i][orr])


def _same_blocks(a, b):
    assert a.keys() == b.keys() and len(a) > 50
    for k in a:
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(x, y)


def test_sharded_fusion_equals_single_chip(ranks):
    """The gathered sharded map holds the single-chip map's blocks with
    the same voxels, bit for bit; the block count is a sum over ranks."""
    recs, _ = ranks
    _same_blocks(recs[0]["gathered_blocks"], recs[0]["single_blocks"])
    assert recs[0]["num_blocks"] == len(recs[0]["single_blocks"])
    assert recs[0]["memory_bytes"] == recs[0]["num_blocks"] * 16 * 512


def test_sharded_correction_and_purge_equal_single_chip(ranks):
    """Every rank re-fuses the single-chip correction's frames and purges
    the same DB entry; rank 0's gathered map equals the single-chip one."""
    recs, _ = ranks
    one = recs[0]
    assert one["correct_num"] == one["single_correct_num"] >= 2
    np.testing.assert_array_equal(one["purge_valid"],
                                  one["single_purge_valid"])
    for rec in recs[1:]:
        assert rec["correct_num"] == one["correct_num"]
        np.testing.assert_array_equal(rec["purge_valid"], one["purge_valid"])
    _same_blocks(*one["purged_blocks"])


def test_sharded_decay_and_catchup_equal_single_chip(ranks):
    recs, _ = ranks
    one = recs[0]
    assert one["decay_counts"] == one["single_decay_counts"]
    assert one["decay_counts"][1] > one["decay_counts"][0]
    for rec in recs[1:]:
        assert rec["decay_counts"] == one["decay_counts"]
    for g, s in one["decay_blocks"]:
        _same_blocks(g, s)


def test_raycast_combine_matches_jax(ranks, jax_map):
    """The MIN-combined depth, the winner's colour and the mask, the same
    on every rank, against JAX's pmin / pmax combine."""
    recs, _ = ranks
    _, _, _, rc = jax_map
    got = recs[0]["raycast"]
    for rec in recs[1:]:
        for f in got:
            np.testing.assert_array_equal(rec["raycast"][f], got[f])
    d_j, d_p = np.asarray(rc.depth), got["depth"]
    both = (d_j > 0) & (d_p > 0)
    assert both.sum() > 1000
    assert (np.asarray(rc.mask) == got["mask"]).mean() >= 0.999
    np.testing.assert_allclose(d_p[both], d_j[both], rtol=0, atol=1e-4)
    assert (np.abs(got["color"][both] - np.asarray(rc.color)[both])
            > 1e-3).mean() <= 1e-3


def test_gather_to_single_equals_jax(ranks, jax_map):
    """The repacked single table is JAX's, key for key; at probe_len 1
    both drop the same blocks with the same warning (the inherited
    defect of denseslam_tpu/parallel/sharded_map.py:412-417)."""
    recs, _ = ranks
    cfg, st, m, _ = jax_map
    want = np.asarray(st.gather_to_single(m).table.keys)
    p1 = dataclasses.replace(cfg, tsdf=dataclasses.replace(cfg.tsdf,
                                                           probe_len=1))
    with pytest.warns(UserWarning, match="gather_to_single") as w:
        want1 = np.asarray(jsm.ShardedTsdf(
            p1, jmesh.make_map_mesh(RANKS)).gather_to_single(m).table.keys)
    for rec in recs:
        np.testing.assert_array_equal(rec["gather_keys"], want)
        np.testing.assert_array_equal(rec["gather_p1_keys"], want1)
        assert rec["gather_p1_warnings"] == [str(x.message) for x in w]
    dropped = int(str(w[0].message).split()[1])
    assert dropped > 0 and (want1 != 2 ** 30).sum() + dropped == (
        want != 2 ** 30).sum()


def test_dense_slam_mesh_spawn_and_composite(ranks):
    """DenseSLAM(mesh=...): the composite of one sharded submap equals
    raycast_view; a jump spawns, demoting the shard to a whole host submap
    and starting a fresh shard; corrections and the composite work across
    both; every rank holds the same poses and DB."""
    recs, _ = ranks
    d_c, d_v = recs[0]["composite_one"]
    both = (d_c > 0) & (d_v > 0)
    assert both.sum() > 1000
    np.testing.assert_allclose(d_c[both], d_v[both], atol=1e-5)
    f = recs[0]["slam"]
    assert (f["before"], f["after"]) == (1, 2)
    assert f["on_host"] == [True, False] and f["on_host_after"]
    assert f["size0"] > 50 and f["size1"] > 50
    assert f["mask_old"] > 100 and f["mask_new"] > 100
    for rec in recs[1:]:
        g = rec["slam"]
        np.testing.assert_array_equal(g["history"], f["history"])
        for a, b in zip(g["db"], f["db"]):
            np.testing.assert_array_equal(a, b)
        assert (g["size0"], g["size1"], g["refused"]) == (
            f["size0"], f["size1"], f["refused"])


def test_sharded_ba_matches_single_solve(ranks):
    recs, inp = ranks
    prob = pba_ops.BAProblem(*(torch.tensor(a) for a in inp["ba_problem"]))
    single = pba_ops.solve(prob, inp["ba_rig"], inp["scfg"].backend)
    for rec in recs:
        got = rec["ba"]
        np.testing.assert_allclose(got["T_wc"], single.T_wc.numpy(),
                                   rtol=0, atol=1e-4)
        assert got["num_obs"] == int(single.num_obs)
        np.testing.assert_allclose(got["final"], float(single.final_cost),
                                   rtol=1e-3, atol=1e-3)
    pts = np.concatenate([rec["ba"]["points"] for rec in recs])
    np.testing.assert_allclose(pts, single.points_w.numpy(), rtol=0,
                               atol=1e-3)
    assert recs[0]["ba"]["final"] < recs[0]["ba"]["initial"]
