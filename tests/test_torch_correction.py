"""Online correction in the port (models/dense_slam.py `online_correction`,
`purge_culled`, `DenseSLAM.apply_pose_updates`; ops/tsdf.py
`decay_defusion_part`, `slide_window_defusion_part`) against the JAX
package on the CPU.

One map and fusion DB, built by the JAX package (6 street keyframes fused
at 160x120, f32 storage, the gather sampler, decay and a sliding window),
is carried into the port by io/convert.py; both sides then replay the
same optimised poses. Tolerances, and why:
  * against the JAX functions as the JAX DenseSLAM runs them (its jitted
    `_correct`, `apply_pose_updates` and `purge_culled`): every leaf of
    the map bit for bit, DB equal (T_fused bit for bit), the re-fuse
    count equal. Those programs project the voxels and contract the
    running averages as `process_sequence`'s scan does, the order the
    port copies (kernel PJ, ops/tsdf.py); before it did, their tsdf was
    within 5e-5 (1.9e-5 on 1.4% of the pool's voxels) and their colours
    equal on all but 2 of 2.1 M voxels.
  * against the same replay with each step jitted on its own
    (allocate_for_frame, `integrate` and `deintegrate`, the programs whose
    voxel projection and running averages the port copies, as
    tests/test_torch_stereo_path.py does): every leaf bit for bit.
  * the defusion parts: bit for bit (masks and fills only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import (OnlineCorrectionParams, SlideWindowParams,
                                  VoxelDecayParams, tiny_test_config)
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.models import dense_slam as jd
from denseslam_tpu.ops import tsdf as jt
from denseslam_tpu.utils import lie as jl
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.ops import tsdf as pt

MAP_LEAVES = ["keys", "tsdf", "weight", "color", "alloc_frame", "last_seen",
              "frame", "decayed_blocks", "overflow"]
DB_LEAVES = ["depth", "gray", "T_fused", "frame_id", "valid", "head"]
N_KF = 6


def _config():
    cfg = tiny_test_config(width=160, height=120, baseline_m=0.537)
    return dataclasses.replace(
        cfg,
        tsdf=dataclasses.replace(cfg.tsdf, sampler="gather",
                                 storage_dtype="float32"),
        decay=VoxelDecayParams(enabled=True, min_decay_age=2,
                               max_decay_weight=2),
        slide_window=SlideWindowParams(enabled=True, max_age=4),
        correction=OnlineCorrectionParams(enabled=True, correction_num=3,
                                          start_correction_num=2,
                                          min_error=0.01),
        pipeline=dataclasses.replace(cfg.pipeline, fusion_db_capacity=8))


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
    """The JAX map and DB after N_KF fused keyframes, as numpy leaves, and
    optimised poses for the DB: slots 1-4 moved by 2-5 cm / 0.3-1 deg (past
    min_error), slot 5 by less than min_error, slot 0 not at all."""
    cfg = _config()
    poses = js.make_trajectory(N_KF, step_m=0.3, yaw_rate=0.01)
    grays, depths = js.render_trajectory(jnp.asarray(poses), cfg.rig.intr,
                                         js.street_scene())
    slam = jd.DenseSLAM(cfg)
    m, db = slam.submaps.active, slam.db
    for i in range(N_KF):
        m, db = slam._fuse(m, db, depths[i], grays[i], jnp.asarray(poses[i]),
                           jnp.int32(2 * i))
    rng = np.random.default_rng(5)
    opt = poses.copy()
    for i, s in ((1, 0.02), (2, 0.05), (3, 0.03), (4, 0.04), (5, 0.002)):
        opt[i] = poses[i] @ jl.se3_exp_np(np.r_[rng.normal(0, s, 3),
                                                rng.normal(0, s / 3, 3)])
    valid = np.zeros(cfg.pipeline.fusion_db_capacity, bool)
    valid[:N_KF] = True
    opt_T = np.tile(np.eye(4, dtype=np.float32), (len(valid), 1, 1))
    opt_T[:N_KF] = opt
    return dict(cfg=cfg, pcfg=convert.config_from_dict(dataclasses.asdict(cfg)),
                slam=slam, map=[np.asarray(x) for x in jax.tree.leaves(m)],
                db=[np.asarray(x) for x in jax.tree.leaves(db)],
                opt_T=opt_T, opt_valid=valid, ids=2 * np.arange(N_KF))


def _jax_state(ref):
    tdef_m = jax.tree.structure(ref["slam"].submaps.active)
    tdef_db = jax.tree.structure(ref["slam"].db)
    return (jax.tree.unflatten(tdef_m, [jnp.asarray(x) for x in ref["map"]]),
            jax.tree.unflatten(tdef_db, [jnp.asarray(x) for x in ref["db"]]))


def _port_state(ref):
    return (convert.map_state_from_numpy(ref["map"], "cpu"),
            convert.fusion_db_from_numpy(ref["db"], "cpu"))


def _assert_map(got, want):
    """Every leaf equal, bit for bit."""
    got = convert.map_state_to_numpy(got)
    want = [np.asarray(x) for x in jax.tree.leaves(want)]
    for name, a, b in zip(MAP_LEAVES, want, got):
        np.testing.assert_array_equal(b, a, name)


def _assert_db(got, want):
    for name, a, b in zip(DB_LEAVES, jax.tree.leaves(want),
                          convert.fusion_db_to_numpy(got)):
        np.testing.assert_array_equal(b, np.asarray(a), name)


def test_online_correction_matches_jax(ref):
    m, db = _jax_state(ref)
    mj, dbj, nj = ref["slam"]._correct(m, db, jnp.asarray(ref["opt_T"]),
                                       jnp.asarray(ref["opt_valid"]))
    mp, dbp = _port_state(ref)
    mp, dbp, n = pd.online_correction(mp, dbp, torch.tensor(ref["opt_T"]),
                                      torch.tensor(ref["opt_valid"]),
                                      ref["pcfg"])
    assert n == int(nj) == 3        # correction_num of the 4 stale slots
    _assert_map(mp, mj)
    _assert_db(dbp, dbj)


def _replay_jitted(ref, slots):
    """online_correction's replay of `slots` in JAX, allocation,
    de-integration and integration each jitted on its own, then its GC."""
    cfg = ref["cfg"]
    intr, tc = cfg.rig.intr, cfg.tsdf
    alloc = jax.jit(lambda m, d, T: jt.allocate_for_frame(m, d, T, intr, tc))
    integ = jax.jit(lambda m, s, k, d, c, T: jt.integrate(
        m, s, k, d, c, T, intr, tc))
    deinteg = jax.jit(lambda m, s, k, d, c, T: jt.deintegrate(
        m, s, k, d, c, T, intr, tc))
    m, db = _jax_state(ref)
    for slot in slots:
        depth = jd.db_depth(db, slot)
        color = jt.pack_gray(jd.db_gray(db, slot))
        T_old, T_new = db.T_fused[slot], jnp.asarray(ref["opt_T"][slot])
        m, s, k = alloc(m, depth, T_old)
        m = deinteg(m, s, k, depth, color, T_old)
        m, s, k = alloc(m, depth, T_new)
        m = integ(m, s, k, depth, color, T_new)
    m = jt.decay_defusion_part(m)
    return jt.slide_window_defusion_part(m, cfg.slide_window.max_age)


def test_online_correction_is_exact_op_by_op(ref):
    mp, dbp = _port_state(ref)
    mp, _, _ = pd.online_correction(mp, dbp, torch.tensor(ref["opt_T"]),
                                    torch.tensor(ref["opt_valid"]),
                                    ref["pcfg"])
    # the worst three: slots 2, 4, 3 (their drift, largest first)
    err = [jl.pose_error_weighted_np(ref["db"][2][i], ref["opt_T"][i])
           for i in range(N_KF)]
    slots = [int(i) for i in np.argsort(err)[::-1][:3]]
    _assert_map(mp, _replay_jitted(ref, slots))


def test_online_correction_below_start_count_does_nothing(ref):
    """Fewer stale slots than start_correction_num: nothing is replayed."""
    valid = np.zeros_like(ref["opt_valid"])
    valid[2] = True
    mp, dbp = _port_state(ref)
    mp, dbp, n = pd.online_correction(mp, dbp, torch.tensor(ref["opt_T"]),
                                      torch.tensor(valid), ref["pcfg"])
    assert n == 0
    _assert_map(mp, _jax_state(ref)[0])
    _assert_db(dbp, _jax_state(ref)[1])


def test_purge_culled_matches_jax(ref):
    culled = np.zeros_like(ref["opt_valid"])
    culled[[1, 4, 7]] = True          # slot 7 is empty: nothing to purge
    mj, dbj = ref["slam"]._purge(*_jax_state(ref), jnp.asarray(culled))
    mp, dbp = pd.purge_culled(*_port_state(ref), torch.tensor(culled),
                              ref["pcfg"])
    _assert_map(mp, mj)
    _assert_db(dbp, dbj)
    assert dbp.valid.sum() == N_KF - 2


@pytest.mark.parametrize("part", ["decay", "slide_window"])
def test_defusion_parts_match_jax(ref, part):
    """Both GC passes on a map whose last keyframe was just de-integrated
    (its blocks touched this frame, many of them left empty)."""
    cfg = ref["cfg"]
    intr, tc = cfg.rig.intr, cfg.tsdf
    m, db = _jax_state(ref)
    slot = N_KF - 1
    depth = jd.db_depth(db, slot)
    T = db.T_fused[slot]
    m, s, k = jax.jit(lambda m: jt.allocate_for_frame(m, depth, T, intr,
                                                      tc))(m)
    m = jt.deintegrate(m, s, k, depth, jt.pack_gray(jd.db_gray(db, slot)), T,
                       intr, tc)
    mp = convert.map_state_from_numpy([np.asarray(x)
                                       for x in jax.tree.leaves(m)], "cpu")
    if part == "decay":
        want, got = jt.decay_defusion_part(m), pt.decay_defusion_part(mp)
    else:
        want = jt.slide_window_defusion_part(m, 1)
        got = pt.slide_window_defusion_part(mp, 1)
    freed = (np.asarray(m.table.keys) != np.asarray(want.table.keys)).sum()
    assert freed > 0
    _assert_map(got, want)


def test_apply_pose_updates_matches_jax(ref):
    """The DenseSLAM handoff: frame ids and poses in, the JAX re-fuse count
    and map out (frame 2 * i sits in DB slot i)."""
    m, db = _jax_state(ref)
    js_ = ref["slam"]
    js_.submaps.maps[0], js_.submaps.dbs[0] = m, db
    ids, poses = ref["ids"], ref["opt_T"][:N_KF]
    want = js_.apply_pose_updates(ids, poses)
    ps = pd.DenseSLAM(ref["pcfg"], device="cpu")
    ps.submaps.active, ps.db = _port_state(ref)
    got = ps.apply_pose_updates(ids, poses)
    assert got == want == 3
    _assert_map(ps.submaps.active, js_.submaps.active)
    _assert_db(ps.db, js_.db)
    assert ps.submaps.dirty[0]
    # the same poses again: every slot now sits at its optimised pose
    assert ps.apply_pose_updates(ids, poses) == js_.apply_pose_updates(
        ids, poses)
