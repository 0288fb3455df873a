"""The rank side of tests/test_torch_parallel.py: every scenario of the
port's sharded map, run once in each of the ranks that the test module
spawns (parallel/launch.py `run_local`: gloo on the CPU, one torch thread
each). Each rank returns what it saw; the test process holds it against
JAX's ShardedTsdf and the port's single-chip path.

Imports only torch and the port (no JAX), so that a spawned rank starts
quickly."""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.ops import ba
from denseslam_tpu_torch.ops import hash as vhash
from denseslam_tpu_torch.ops import tsdf as pt
from denseslam_tpu_torch.parallel import ba as pba
from denseslam_tpu_torch.parallel import sharded_map as psm


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _leaves(m):
    return convert.map_state_to_numpy(m)


def _by_key(m):
    """{key: (tsdf, weight, color)} of every allocated block of map m."""
    keys = m.table.keys.numpy()
    idx = np.flatnonzero(keys != vhash.EMPTY_KEY)
    # copies: the port's ops change the map in place afterwards
    tsdf = m.tsdf.float().numpy().copy()
    w = m.weight.float().numpy().copy()
    col = m.color.numpy().copy()
    return {int(keys[i]): (tsdf[i], w[i], col[i]) for i in idx}


def _single_fuse(cfg, m, depth, gray, T):
    """The port's single-chip fusion with the sharded path's tail:
    allocate, integrate, slide window, decay, advance."""
    intr, tc = cfg.rig.intr, cfg.tsdf
    m, s, k = pt.allocate_for_frame(m, depth, T, intr, tc)
    m = pt.integrate(m, s, k, depth, pt.pack_gray(gray), T, intr, tc)
    if cfg.slide_window.enabled:
        m = pt.slide_window(m, cfg.slide_window.max_age)
    if cfg.decay.enabled:
        m = pt.decay(m, cfg.decay.max_decay_weight, cfg.decay.min_decay_age)
    return pt.advance_frame(m)


def _gathered(st, m):
    g = st.gather_to_single(m)
    return _by_key(g), g


def scenarios(mesh, inp):
    """Every scenario on this rank; the single-chip references run on
    rank 0 only."""
    torch.set_num_threads(1)
    one = mesh.rank == 0
    cfg = inp["cfg"]
    out = {}
    grays = [_t(g) for g in inp["grays"]]
    depths = [_t(d) for d in inp["depths"]]
    poses = [_t(T) for T in inp["poses"]]
    n_fuse = inp["n_fuse"]

    # fusion, exchange (the default) and replicated allocation
    st = psm.ShardedTsdf(cfg, mesh)
    rcfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, parallel_alloc="replicated"))
    st_r = psm.ShardedTsdf(rcfg, mesh)
    m_x, m_r = st.make_map(), st_r.make_map()
    m_si = pt.make_map(cfg.tsdf, "cpu")
    for i in range(n_fuse):
        m_x = st.fuse(m_x, depths[i], grays[i], poses[i])
        m_r = st_r.fuse(m_r, depths[i], grays[i], poses[i])
        if one:
            m_si = _single_fuse(cfg, m_si, depths[i], grays[i], poses[i])
    out["fuse_exchange"] = _leaves(m_x)
    out["fuse_replicated"] = _leaves(m_r)
    out["num_blocks"] = st.num_blocks(m_x)
    out["memory_bytes"] = st.memory_bytes(m_x)
    g_x, g_map = _gathered(st, m_x)
    out["gather_keys"] = g_map.table.keys.numpy()
    if one:
        out["single_blocks"] = _by_key(m_si)
        out["gathered_blocks"] = g_x
    # the gather at probe_len 1: the inherited drop, with its warning
    p1 = dataclasses.replace(cfg, tsdf=dataclasses.replace(cfg.tsdf,
                                                           probe_len=1))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        g1 = psm.ShardedTsdf(p1, mesh).gather_to_single(m_x)
    out["gather_p1_keys"] = g1.table.keys.numpy()
    out["gather_p1_warnings"] = [str(w.message) for w in caught]

    # the raycast combine
    rc = st.raycast(m_x, poses[inp["render_at"]])
    out["raycast"] = {f: getattr(rc, f).numpy() for f in rc._fields}

    # correction and purge against the single-chip path
    ccfg = inp["ccfg"]
    st_c = psm.ShardedTsdf(ccfg, mesh)
    m_sh, m_si = st_c.make_map(), pt.make_map(ccfg.tsdf, "cpu")
    db_sh, db_si = pd.make_fusion_db(ccfg, "cpu"), pd.make_fusion_db(ccfg,
                                                                      "cpu")
    drifted = [_t(T) for T in inp["drifted"]]
    for i in range(len(drifted)):
        d = pd.db_quantize_depth(db_sh, depths[i])
        m_sh = st_c.fuse(m_sh, d, grays[i], drifted[i])
        db_sh = pd.db_push(db_sh, d, grays[i], drifted[i], i)
        if one:
            m_si = _single_fuse(ccfg, m_si, d, grays[i], drifted[i])
            db_si = pd.db_push(db_si, d, grays[i], drifted[i], i)
    c = db_sh.frame_id.shape[0]
    opt_T = torch.eye(4).repeat(c, 1, 1)
    opt_valid = torch.zeros(c, dtype=torch.bool)
    for i in range(len(drifted)):
        opt_T[i] = poses[i]
        opt_valid[i] = True
    m_sh, db_sh, n_sh = st_c.correct(m_sh, db_sh, opt_T, opt_valid)
    culled = db_sh.frame_id == 1
    m_sh, db_sh = st_c.purge(m_sh, db_sh, culled)
    out["correct_num"] = n_sh
    out["purge_valid"] = db_sh.valid.numpy()
    g_c, _ = _gathered(st_c, m_sh)
    if one:
        m_si, db_si, n_si = pd.online_correction(m_si, db_si, opt_T,
                                                 opt_valid, ccfg)
        m_si, db_si = pd.purge_culled(m_si, db_si, culled, ccfg)
        out["single_correct_num"] = n_si
        out["single_purge_valid"] = db_si.valid.numpy()
        out["purged_blocks"] = (g_c, _by_key(m_si))

    # decay with fusion, then the sequence-end catch-up
    dcfg = inp["dcfg"]
    st_d = psm.ShardedTsdf(dcfg, mesh)
    m_sh, m_si = st_d.make_map(), pt.make_map(dcfg.tsdf, "cpu")
    for i in range(n_fuse):
        m_sh = st_d.fuse(m_sh, depths[i], grays[i], poses[i])
        if one:
            m_si = _single_fuse(dcfg, m_si, depths[i], grays[i], poses[i])
    dec, dec_si = [int(m_sh.decayed_blocks)], [int(m_si.decayed_blocks)]
    g_d, _ = _gathered(st_d, m_sh)
    blocks = [(g_d, _by_key(m_si))] if one else []
    w = dcfg.decay.max_decay_weight
    for _ in range(dcfg.decay.min_decay_age):
        m_sh = st_d.decay_catchup_step(m_sh, w)
        if one:
            m_si = pt.decay_catchup(m_si, w)
    dec.append(int(m_sh.decayed_blocks))
    dec_si.append(int(m_si.decayed_blocks))
    m_dd = st_d.make_map()
    for d, g, T in zip(inp["drive_depths"], inp["drive_grays"],
                       inp["drive_poses"]):
        m_dd = st_d.fuse(m_dd, _t(d), _t(g), _t(T))
    out["decay_drive"] = _leaves(m_dd)
    g_d, _ = _gathered(st_d, m_sh)
    out["decay_counts"] = dec
    if one:
        blocks.append((g_d, _by_key(m_si)))
        out["decay_blocks"] = blocks
        out["single_decay_counts"] = dec_si

    # DenseSLAM over the mesh: spawn, corrections, the composite
    scfg = inp["scfg"]
    slam = pd.DenseSLAM(scfg, mesh=mesh)
    sp = [_t(T) for T in inp["spawn_poses"]]
    sd = [_t(d) for d in inp["spawn_depths"]]
    for i in range(3):
        slam.process_frame(torch.zeros_like(sd[i]), depth=sd[i],
                           pose_override=sp[i])
    rc_c = slam.raycast_composite(sp[1])
    rc_v = slam.raycast_view(sp[1])
    out["composite_one"] = (rc_c.depth.numpy(), rc_v.depth.numpy())
    n_before = slam.submaps.num_local_maps
    far = _t(inp["far"])
    far_d = _t(inp["far_depth"])
    slam.process_frame(torch.zeros_like(far_d), depth=far_d,
                       pose_override=far)
    sm = slam.submaps
    facts = dict(before=n_before, after=sm.num_local_maps,
                 on_host=[sm.is_on_host(i) for i in range(sm.num_local_maps)],
                 size0=sm.local_map_size(0))
    slam.process_frame(torch.zeros_like(far_d), depth=far_d,
                       pose_override=far)
    facts["size1"] = sm.local_map_size(1)
    n = slam.apply_pose_updates(np.arange(4), np.stack(
        [np.asarray(T) for T in inp["spawn_poses"][:3]] + [inp["far"]]))
    facts["refused"] = n
    facts["pending0"] = len(sm.pending_corrections[0])
    facts["mask_old"] = int(slam.raycast_composite(sp[1]).mask.sum())
    facts["mask_new"] = int(slam.raycast_composite(far).mask.sum())
    facts["on_host_after"] = sm.is_on_host(0)
    facts["history"] = np.stack([T for _, T in slam.pose_history])
    facts["db"] = convert.fusion_db_to_numpy(slam.db)
    out["slam"] = facts

    # the sharded BA on this rank's landmark slice
    prob = ba.BAProblem(*(torch.tensor(a) for a in inp["ba_problem"]))
    res = pba.make_sharded_solver(mesh, inp["ba_rig"], scfg.backend)(
        pba.shard_problem(prob, mesh))
    out["ba"] = dict(T_wc=res.T_wc.numpy(), points=res.points_w.numpy(),
                     initial=float(res.initial_cost),
                     final=float(res.final_cost), num_obs=int(res.num_obs))
    return out
