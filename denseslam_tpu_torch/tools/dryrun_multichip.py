"""One full, non-trivial SLAM step over the map axis, on small shapes (port
of `__graft_entry__.dryrun_multichip`):

  1. stereo VO on rendered frames (tracking must lock);
  2. sharded TSDF fusion at drifted poses, with the fusion DB, beside the
     single-chip map;
  3. the sharded Schur BA of a noise-perturbed problem: the cost starts
     above 1, falls below a fifth of it, and matches the single solve;
  4. one sharded online correction, which must re-fuse frames, move the
     map towards the true geometry and equal the single-chip correction;
  5. a spawn under DenseSLAM(mesh=...): the shard demoted to a host
     submap, a fresh shard active, and the composite across both.

Every rank runs it; rank 0 prints the JAX dry run's summary line and a
JSON object of the same facts. Launch on cards with torchrun (NCCL):

    torchrun --nproc_per_node 4 -m denseslam_tpu_torch.tools.dryrun_multichip

or spawn N local ranks: `--spawn 4 --backend gloo --device cpu` (or
`--device cuda:0` for ranks that share one card).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch


def dryrun(mesh) -> dict:
    """The dry run on this rank of `mesh`; returns its facts."""
    from ..config import OnlineCorrectionParams, tiny_test_config
    from ..io import synthetic
    from ..models import dense_slam as ds
    from ..models import frontend as fe
    from ..ops import ba
    from ..ops import splat as splat_ops
    from ..ops import tsdf as tsdf_ops
    from ..parallel import ba as pba
    from ..parallel import sharded_map as sm
    from ..utils import lie

    n = mesh.size
    dev = mesh.device
    cfg = tiny_test_config(width=160, height=120, baseline_m=0.2)
    cfg = dataclasses.replace(
        cfg,
        tsdf=dataclasses.replace(cfg.tsdf, table_slots=max(
            1024 * n, cfg.tsdf.table_slots), raycast_steps=48),
        correction=OnlineCorrectionParams(
            enabled=True, correction_num=2, start_correction_num=1,
            min_error=0.003),
        pipeline=dataclasses.replace(cfg.pipeline, fusion_db_capacity=8))
    intr = cfg.rig.intr
    rng = np.random.default_rng(0)

    def T(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # 1. stereo VO on rendered frames
    gt = synthetic.make_trajectory(3, step_m=0.05, yaw_rate=0.0)
    st_fe = fe.init_frontend(cfg, device=dev)
    for i in range(3):
        left, right, _ = synthetic.render_stereo(T(gt[i]), cfg.rig,
                                                 device=dev)
        st_fe, vo = fe.vo_step(st_fe, left, right, cfg)
    if not bool(vo.tracking_ok):
        raise AssertionError("VO failed to lock on rendered frames")
    vo_err = float(lie.pose_error_weighted(vo.T_wc, T(gt[2])))
    if vo_err >= 0.05:
        raise AssertionError(f"VO pose error {vo_err}")

    # 2. sharded fusion at drifted poses, with the single-chip shadow
    st = sm.ShardedTsdf(cfg, mesh)
    m_sh, db = st.make_map(), ds.make_fusion_db(cfg, dev)
    m_si, db_si = tsdf_ops.make_map(cfg.tsdf, dev), ds.make_fusion_db(cfg,
                                                                      dev)
    drift = [np.asarray(gt[0], np.float32)]
    for i in range(1, 3):
        xi = np.concatenate([rng.normal(0, 0.04, 3),
                             rng.normal(0, 0.01, 3)]).astype(np.float32)
        drift.append((T(gt[i]) @ lie.se3_exp(T(xi))).cpu().numpy())
    for i in range(3):
        gray, depth = synthetic.render_view(T(gt[i]), intr, device=dev)
        depth = ds.db_quantize_depth(db, depth)
        m_sh = st.fuse(m_sh, depth, gray, T(drift[i]))
        db = ds.db_push(db, depth, gray, T(drift[i]), i)
        m_si, db_si = ds.fuse_keyframe(m_si, db_si, depth, gray,
                                       T(drift[i]), i, cfg)
    blocks = st.num_blocks(m_sh)
    if blocks <= 0:
        raise AssertionError("sharded fusion allocated nothing")

    # 3. the sharded BA of a noise-perturbed problem
    K, L = 4, 16 * n
    T_true = synthetic.make_trajectory(K, step_m=0.08, yaw_rate=0.01)
    pts_true = rng.uniform([-1.2, -0.9, 1.5], [1.2, 0.9, 5.0],
                           (L, 3)).astype(np.float32)
    obs = np.zeros((L, K, 3), np.float32)
    mask = np.zeros((L, K), bool)
    for k in range(K):
        T_cw = lie.inv_T(T(T_true[k])).cpu().numpy()
        pc = pts_true @ T_cw[:3, :3].T + T_cw[:3, 3]
        z = pc[:, 2]
        obs[:, k, 0] = pc[:, 0] / z * intr.fx + intr.cx
        obs[:, k, 1] = pc[:, 1] / z * intr.fy + intr.cy
        obs[:, k, 2] = (pc[:, 0] - cfg.rig.baseline_m) / z * intr.fx + intr.cx
        mask[:, k] = z > 0.2
    T_init = [np.asarray(T_true[0], np.float32)]
    for k in range(1, K):
        xi = np.concatenate([rng.normal(0, 0.03, 3),
                             rng.normal(0, 0.008, 3)]).astype(np.float32)
        T_init.append((T(T_true[k]) @ lie.se3_exp(T(xi))).cpu().numpy())
    pts_init = pts_true + rng.normal(0, 0.03, pts_true.shape).astype(
        np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    problem = ba.BAProblem(
        T_wc=T(np.stack(T_init)), points_w=T(pts_init), obs=T(obs),
        obs_mask=torch.as_tensor(mask, device=dev),
        fixed=torch.as_tensor(fixed, device=dev),
        point_valid=torch.ones(L, dtype=torch.bool, device=dev))
    res = pba.make_sharded_solver(mesh, cfg.rig, cfg.backend)(
        pba.shard_problem(problem, mesh))
    res_single = ba.solve(problem, cfg.rig, cfg.backend)
    c0, c1 = float(res.initial_cost), float(res.final_cost)
    ba_dT = float((res.T_wc - res_single.T_wc).abs().max())
    if not (c0 > 1.0 and c1 < 0.2 * c0):
        raise AssertionError(f"BA did not converge: {c0} -> {c1}")
    if ba_dT > 1e-3 or abs(c1 - float(res_single.final_cost)) > (
            1e-5 + 1e-3 * abs(c1)):
        raise AssertionError(
            f"sharded BA differs from the single solve: {ba_dT}, {c1} vs "
            f"{float(res_single.final_cost)}")

    # 4. the sharded online correction against the single-chip one
    c = cfg.pipeline.fusion_db_capacity
    opt_T = torch.eye(4, device=dev).repeat(c, 1, 1)
    opt_valid = torch.zeros(c, dtype=torch.bool, device=dev)
    for slot, fid in enumerate(db.frame_id.cpu().numpy()):
        if fid >= 0:
            opt_T[slot] = T(gt[int(fid)])
            opt_valid[slot] = True
    T_eval = T(gt[1])
    d_before = st.raycast(m_sh, T_eval).depth.cpu().numpy()
    m_sh, db, n_corr = st.correct(m_sh, db, opt_T, opt_valid)
    m_si, _, n_corr_si = ds.online_correction(m_si, db_si, opt_T, opt_valid,
                                              cfg)
    if not n_corr == n_corr_si > 0:
        raise AssertionError(f"correction re-fused {n_corr} / {n_corr_si}")
    d_sh = st.raycast(m_sh, T_eval).depth.cpu().numpy()
    sp = cfg.splat
    d_si = splat_ops.splat_render(
        m_si, T_eval, intr, cfg.tsdf, splat_ops.SplatConfig(
            max_blocks=sp.max_blocks, max_voxels=sp.max_voxels,
            surface_eta=sp.surface_eta, z_bits=sp.z_bits,
            fill_levels=sp.fill_levels)).depth.cpu().numpy()
    both = (d_sh > 0) & (d_si > 0)
    med_diff = float(np.median(np.abs(d_sh[both] - d_si[both])))
    if both.sum() <= 2000 or med_diff >= 1e-4:
        raise AssertionError(f"sharded/single corrected maps differ: "
                             f"{med_diff} on {both.sum()} pixels")
    _, g = synthetic.render_view(T_eval, intr, device=dev)
    g = g.cpu().numpy()
    el = (g > 0) & (g < 9)
    e_before = float(np.median(np.abs(d_before - g)[(d_before > 0) & el]))
    e_after = float(np.median(np.abs(d_sh - g)[(d_sh > 0) & el]))
    if not e_after < e_before:
        raise AssertionError(f"correction did not help: {e_before} -> "
                             f"{e_after}")

    # 5. a spawn under DenseSLAM(mesh=...)
    cfg5 = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, new_submap_threshold=0.6))
    slam = ds.DenseSLAM(cfg5, mesh=mesh)
    for i in range(2):
        _, depth = synthetic.render_view(T(gt[i]), intr, device=dev)
        slam.process_frame(torch.zeros_like(depth), depth=depth,
                           pose_override=T(gt[i]))
    far = np.asarray(gt[2], np.float32).copy()
    far[0, 3] += 12.0
    _, depth = synthetic.render_view(T(far), intr, device=dev)
    slam.process_frame(torch.zeros_like(depth), depth=depth,
                       pose_override=T(far))
    n_sub = slam.submaps.num_local_maps
    if n_sub != 2 or not slam.submaps.is_on_host(0):
        raise AssertionError("sharded spawn did not demote the shard")
    old_px = int(slam.raycast_composite(T(gt[0])).mask.sum())
    if old_px <= 100:
        raise AssertionError("composite lost the demoted submap's content")
    return dict(ranks=n, vo_err=vo_err, blocks=blocks, ba_cost0=c0,
                ba_cost1=c1, ba_obs=int(res.num_obs), ba_max_dT=ba_dT,
                refused=int(n_corr), err_before=e_before, err_after=e_after,
                sharded_single_med_diff=med_diff, submaps=n_sub,
                composite_old_px=old_px)


def summary(f: dict) -> str:
    """The JAX dry run's line (`__graft_entry__.dryrun_multichip`)."""
    return (f"dryrun_multichip({f['ranks']}): VO err {f['vo_err']:.4f}; "
            f"fused blocks={f['blocks']}; BA cost {f['ba_cost0']:.3f}->"
            f"{f['ba_cost1']:.3f} (matches single-device, {f['ba_obs']} "
            f"obs); correction re-fused {f['refused']} frames, raycast "
            f"GT-med-err {f['err_before']:.4f}->{f['err_after']:.4f}, "
            f"sharded==single (med diff {f['sharded_single_med_diff']:.2e}); "
            f"spawn -> {f['submaps']} submaps")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spawn", type=int, default=0,
                    help="spawn this many local ranks (else torchrun's)")
    ap.add_argument("--backend", default=None, help="nccl or gloo")
    ap.add_argument("--device", default=None,
                    help="cpu, cuda:0 (ranks share it), default cuda:rank")
    args = ap.parse_args(argv)
    from ..parallel import launch

    if args.spawn:
        backend = args.backend or ("nccl" if args.device is None else "gloo")
        facts = launch.run_local(dryrun, args.spawn, backend=backend,
                                 device=args.device)[0]
    else:
        launch.init_distributed(backend=args.backend, device=args.device)
        try:
            facts = dryrun(launch.global_map_mesh(
                None if args.device is None else torch.device(args.device)))
            if not launch.is_coordinator():
                return 0
        finally:
            launch.shutdown_distributed()
    print(summary(facts))
    print(json.dumps(facts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
