"""CLI entry point — the `SystemEntry.cpp` equivalent (port of
denseslam_tpu/main.py).

Flags mirror the reference's gflags + param.yaml surface
(reference: src/DenseSLAM/SystemEntry.cpp:12-33, 136-199): dataset
selection, frame offset/limit, voxel decay, sliding window, online
correction, depth weighting, raycast dumps, trajectory saving, low-res
input. Runs the headless loop (SystemEntry.cpp:342-372); there is no GUI —
previews are dumped as images, or served to a browser by the live viewer
(--live_viewer PORT, io/viewer.py). The flags are the JAX command line's,
plus --device: the run goes on the CUDA card unless it says otherwise
(`--device cpu` runs the plain PyTorch versions of the kernels).

Usage:
  python -m denseslam_tpu_torch.main --dataset_root /data/kitti/odometry/07 \\
      --dataset_type kitti_odometry --sensor stereo --frame_limit 100 \\
      --voxel_decay --slide_window --save_trajectory out/traj.txt
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--dataset_type", default="kitti_odometry",
                   choices=["kitti_odometry", "kitti_tracking", "kitti_raw",
                            "tum", "icl_nuim"])
    p.add_argument("--sensor", default="stereo",
                   choices=["monocular", "stereo", "rgbd"])
    p.add_argument("--internal_odometry", action="store_true",
                   help="track with ICP against the map raycast instead of "
                        "sparse VO (reference: use_orbslam_vo=false -> "
                        "InfiniTamDriver::TrackLocalMap)")
    p.add_argument("--frame_offset", type=int, default=0)
    p.add_argument("--frame_limit", type=int, default=None)
    p.add_argument("--input_scale", type=float, default=1.0)
    p.add_argument("--use_color", action="store_true")
    # depth source
    p.add_argument("--sgm_backend", default="xla",
                   choices=["xla", "pallas"],
                   help="SGM aggregation backend for --compute_depth (on "
                        "the card both run the CUDA kernels)")
    p.add_argument("--compute_depth", action="store_true",
                   help="compute depth with the on-device SGM stereo instead "
                        "of reading precomputed depth/disparity")
    # map params
    p.add_argument("--voxel_size", type=float, default=0.06)
    p.add_argument("--max_depth", type=float, default=50.0)
    p.add_argument("--table_slots_log2", type=int, default=17)
    p.add_argument("--max_visible_log2", type=int, default=14)
    p.add_argument("--sampler", default="gather",
                   choices=["gather", "pallas"],
                   help="fusion image-sampling backend (ops/sampling.py; "
                        "pallas = the tile-sampler kernel)")
    p.add_argument("--storage_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="TSDF pool storage dtype")
    # renderer (reference: ITMVisualisationEngine previews)
    p.add_argument("--renderer", default="splat",
                   choices=["splat", "march"],
                   help="preview/ICP renderer: forward splat (fast) or "
                        "bounded sphere tracing (reference-exact)")
    p.add_argument("--splat_refine", type=int, default=0,
                   help="sub-voxel sphere-trace refinement steps after "
                        "splat")
    p.add_argument("--splat_prune_sdf", type=float, default=0.0,
                   help="invalidate refined pixels sampling |tsdf| above "
                        "this (kills fabricated fill depth; needs "
                        "--splat_refine > 0)")
    p.add_argument("--no_bleed_fill", action="store_true",
                   help="disable the occlusion-aware fill override "
                        "(background bleed-through suppression)")
    # regularisation (reference param.yaml voxel_decay / slide_window blocks)
    p.add_argument("--voxel_decay", action="store_true")
    p.add_argument("--min_decay_age", type=int, default=30)
    p.add_argument("--max_decay_weight", type=float, default=2)
    p.add_argument("--slide_window", action="store_true")
    p.add_argument("--slide_window_max_age", type=int, default=60)
    # online correction
    p.add_argument("--online_correction", action="store_true")
    p.add_argument("--correction_num", type=int, default=5)
    p.add_argument("--start_correction_num", type=int, default=10)
    # depth weighting (WeightParams)
    p.add_argument("--depth_weighting", action="store_true")
    p.add_argument("--max_new_w", type=int, default=5)
    p.add_argument("--weight_max_distance", type=float, default=30.0)
    # post processing
    p.add_argument("--depth_postprocess", action="store_true")
    # backend
    p.add_argument("--enable_backend", action="store_true",
                   help="run local BA + loop closing (SLAMSystem)")
    p.add_argument("--keyframe_every", type=int, default=1,
                   help="fuse every k-th frame (lowfreq_exp)")
    p.add_argument("--chunk", type=int, default=0,
                   help="throughput mode: batch N frames per chunk scan "
                        "(process_chunk; implies --enable_backend, stereo "
                        "sensor, on-device SGM depth). Raycast dumps drop "
                        "to chunk rate; the memory log repeats the "
                        "chunk-end value per frame.")
    # submaps (reference: F_originalBlocksThreshold, DenseSlam.h:502-507)
    p.add_argument("--new_submap_threshold", type=float, default=-1.0,
                   help="spawn a new submap when the visible fraction of "
                        "the active map drops below this (<0 disables, the "
                        "reference default)")
    p.add_argument("--map_memory_budget_mb", type=float, default=-1.0,
                   help="device-memory budget for all submaps (pools + "
                        "fusion DBs); oldest inactive submaps spill to host "
                        "DRAM above it (the ITMSwappingEngine "
                        "SaveToGlobalMemory role; <0 = unbounded)")
    # outputs
    p.add_argument("--save_trajectory", default=None)
    p.add_argument("--save_composite", default=None,
                   help="end-of-run composite raycast across ALL submaps "
                        "under their optimised global poses (16-bit depth "
                        "PNG, x256) — the ITMVoxelMapGraphManager composite "
                        "visualisation")
    p.add_argument("--save_kitti_trajectory", default=None)
    p.add_argument("--save_mesh", default=None)
    p.add_argument("--save_raycast_depth_dir", default=None)
    p.add_argument("--save_raycast_rgb_dir", default=None)
    p.add_argument("--save_memory_log", default=None,
                   help="per-frame map memory log (memory.txt equivalent)")
    p.add_argument("--checkpoint_out", default=None)
    p.add_argument("--checkpoint_in", default=None)
    p.add_argument("--metrics_json", default=None)
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the run (the "
                        "Tic/Toc + GUI-plot telemetry analogue, SURVEY.md "
                        "section 5)")
    p.add_argument("--quiet", action="store_true")
    # live viewer (Pangolin-GUI equivalent)
    p.add_argument("--live_viewer", type=int, default=0, metavar="PORT",
                   help="serve a live HTTP dashboard on PORT (0 = off)")
    p.add_argument("--viewer_every", type=int, default=5,
                   help="render viewer raycast panes every N frames")
    p.add_argument("--device", default=None,
                   help="torch device of the run (default: the CUDA card; "
                        "'cpu' runs the kernels' plain versions)")
    return p


def build_config(args, rig):
    from .config import (OnlineCorrectionParams, PipelineConfig,
                         PostProcessParams, SlideWindowParams, SplatParams,
                         StereoConfig, SystemConfig, TsdfConfig,
                         VoxelDecayParams, WeightParams)

    tsdf = TsdfConfig(
        voxel_size_m=args.voxel_size,
        trunc_dist_m=args.voxel_size * 4,
        table_slots=1 << args.table_slots_log2,
        max_visible_blocks=1 << args.max_visible_log2,
        max_alloc_per_frame=1 << args.max_visible_log2,
        max_depth_m=args.max_depth,
        sampler=args.sampler,
        storage_dtype=args.storage_dtype,
        weights=WeightParams(
            depth_weighting=args.depth_weighting,
            max_new_w=args.max_new_w,
            max_distance=args.weight_max_distance,
        ),
    )
    return SystemConfig(
        rig=rig,
        tsdf=tsdf,
        decay=VoxelDecayParams(args.voxel_decay, args.min_decay_age,
                               args.max_decay_weight),
        slide_window=SlideWindowParams(args.slide_window,
                                       args.slide_window_max_age),
        correction=OnlineCorrectionParams(
            args.online_correction, args.correction_num,
            args.start_correction_num),
        postprocess=PostProcessParams(enabled=args.depth_postprocess),
        stereo=StereoConfig(sgm_backend=args.sgm_backend),
        pipeline=PipelineConfig(
            keyframe_every=args.keyframe_every,
            sensor={"monocular": "mono"}.get(args.sensor, args.sensor),
            use_external_odometry=not args.internal_odometry,
            new_submap_threshold=args.new_submap_threshold,
            map_memory_budget_mb=args.map_memory_budget_mb,
            renderer=args.renderer,
            splat_refine=args.splat_refine,
            splat_prune_sdf=args.splat_prune_sdf,
        ),
        splat=(dataclasses.replace(SplatParams(), bleed_rel=0.0,
                                   bleed_abs=0.0)
               if args.no_bleed_fill else SplatParams()),
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from .device import resolve_device
    from .io import datasets, png
    from .io.checkpoint import load_slam_checkpoint, save_slam_checkpoint
    from .io.trajectory import save_kitti, save_tum
    from .models.dense_slam import DenseSLAM
    from .models.system import SLAMSystem
    from .ops import raycast as rc_ops
    from .utils.timing import TIMERS

    dev = resolve_device(args.device)
    ds_cfg = datasets.CONFIGS[datasets.DatasetType[args.dataset_type.upper()]]()
    inp = datasets.Input(
        args.dataset_root, ds_cfg,
        frame_offset=args.frame_offset, frame_limit=args.frame_limit,
        input_scale=args.input_scale, use_color=args.use_color,
    )
    cfg = build_config(args, inp.rig)

    if args.chunk and cfg.pipeline.sensor != "stereo":
        raise SystemExit("--chunk requires the stereo sensor")
    if args.enable_backend or args.chunk:
        system = SLAMSystem(cfg, device=dev)
        slam = system.slam
    else:
        system = None
        slam = DenseSLAM(cfg, device=dev)
    if args.checkpoint_in:
        load_slam_checkpoint(args.checkpoint_in, slam)

    for d in [args.save_raycast_depth_dir, args.save_raycast_rgb_dir]:
        if d:
            os.makedirs(d, exist_ok=True)

    def on_dev(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    viewer = None
    if args.live_viewer:
        from .io.viewer import LiveViewer
        viewer = LiveViewer(port=args.live_viewer)
        if not args.quiet:
            print(f"live viewer: http://127.0.0.1:{viewer.port}/")

    def host(t):
        return t.cpu().numpy()

    def preview(rc):
        return host(rc_ops.render_preview(rc, rc_ops.PREVIEW_GRAY))

    def freeview_pane(panes):
        # the free camera moved and someone watches: render the
        # multi-submap composite from it (DSHandler3D free-cam role)
        fv_T = viewer.freeview_pose()
        if fv_T is not None:
            fv = slam.raycast_composite(
                torch.as_tensor(fv_T, dtype=torch.float32, device=dev))
            panes["freeview"] = preview(fv)

    def save_raycasts(fid):
        if args.save_raycast_depth_dir:
            slam.save_raycast_depth(os.path.join(
                args.save_raycast_depth_dir, f"{fid:06d}.png"))
        if args.save_raycast_rgb_dir:
            slam.save_raycast_rgb(os.path.join(
                args.save_raycast_rgb_dir, f"{fid:06d}.png"))

    mem_log = open(args.save_memory_log, "w") if args.save_memory_log else None
    prof = None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    t_start = time.time()
    n = 0

    if args.chunk:
        # Throughput mode: frames flow through the chunk scan
        # (SLAMSystem.process_chunk, one backend tick a chunk); telemetry
        # is chunk-rate.
        from .utils.image import rgb_to_gray

        def to_gray(img):
            a = on_dev(img).to(torch.float32)
            return rgb_to_gray(a) if a.dim() == 3 else a

        def chunk_panes(out):
            from .io.viewer import colorize_depth
            rc = slam.raycast_view()
            panes = dict(raycast=preview(rc),
                         raycast_depth=colorize_depth(
                             host(rc.depth), cfg.tsdf.max_depth_m))
            freeview_pane(panes)
            viewer.update(
                panes=panes,
                stats=dict(frame=n,
                           fps=n / max(time.time() - t_start, 1e-6),
                           blocks=slam.submaps.local_map_size(
                               slam.submaps.active_idx),
                           memory_mb=slam.memory_bytes() / 1e6,
                           tracking_ok=bool(out["tracking_ok"]),
                           keyframes=system.backend.num_keyframes),
                pose=np.asarray(out["T_wc"]))

        batch_l, batch_r = [], []
        out = None
        for frame in inp:
            if frame["right"] is None:
                raise SystemExit("--chunk needs stereo input")
            batch_l.append(to_gray(frame["left"]))
            batch_r.append(to_gray(frame["right"]))
            if len(batch_l) == args.chunk:
                out = system.process_chunk(torch.stack(batch_l),
                                           torch.stack(batch_r))
                batch_l, batch_r = [], []
                n += args.chunk
                if mem_log:
                    mb = slam.memory_bytes() / 100e6
                    mem_log.write(f"{mb:.6f}\n" * args.chunk)
                save_raycasts(slam.frame - 1)
                if viewer is not None:
                    chunk_panes(out)
                if not args.quiet:
                    fps = n / (time.time() - t_start)
                    print(f"frame {n}: {fps:.2f} FPS (chunked), "
                          f"tracking={'OK' if out['tracking_ok'] else 'LOST'}")
        for l, r in zip(batch_l, batch_r):      # tail, per-frame
            out = system.process_frame(l, r)
            n += 1
            if mem_log:
                mem_log.write(f"{out['memory_bytes'] / 100e6:.6f}\n")
        inp = ()                                 # skip the per-frame loop

    def frame_panes(out, left, depth):
        from .io.viewer import colorize_depth, draw_features, draw_flow
        panes = {}
        if n % max(args.viewer_every, 1) == 0:
            fs = slam.fe_state
            if fs.feats_l is not None:
                panes["input_rgb"] = draw_features(
                    host(left), host(fs.feats_l.uv), host(fs.feats_l.valid))
            else:
                panes["input_rgb"] = host(left).astype(np.uint8)
            if slam.last_flow is not None:
                # sparse scene-flow pane (reference GUI's matched-flow
                # overlay, DenseSLAMGUI.cpp:216-220)
                panes["scene_flow"] = draw_flow(
                    host(left), *(host(t) for t in slam.last_flow))
            if depth is not None:
                panes["input_depth"] = colorize_depth(
                    host(depth), cfg.tsdf.max_depth_m)
            rc = slam.raycast_view()
            panes["raycast"] = preview(rc)
            panes["raycast_depth"] = colorize_depth(
                host(rc.depth), cfg.tsdf.max_depth_m)
        freeview_pane(panes)
        viewer.update(
            panes=panes,
            stats=dict(
                frame=n, fps=n / max(time.time() - t_start, 1e-6),
                blocks=out["num_blocks"],
                memory_mb=out["memory_bytes"] / 1e6,
                tracking_ok=bool(out["tracking_ok"]),
                keyframes=(system.backend.num_keyframes
                           if system is not None else None),
            ),
            pose=np.asarray(out["T_wc"]),
        )

    for frame in inp:
        left = on_dev(frame["left"])
        right = on_dev(frame["right"]) if frame["right"] is not None else None
        depth = None if args.compute_depth else on_dev(frame["depth"])
        target = system if system is not None else slam
        out = target.process_frame(left, right, depth=depth,
                                   timestamp=frame["timestamp"])
        n += 1
        if out["fused"]:
            save_raycasts(out["frame"])
        if mem_log:
            # memory.txt convention: one line per frame, units of 100 MB
            # (reference: DenseSLAMGUI.cpp:589-595, memoryDraw.py:40-41)
            mem_log.write(f"{out['memory_bytes'] / 100e6:.6f}\n")
        if viewer is not None:
            frame_panes(out, left, depth)
        if not args.quiet and n % 10 == 0:
            fps = n / (time.time() - t_start)
            print(f"frame {n}: {fps:.2f} FPS, blocks={out['num_blocks']}, "
                  f"mem={out['memory_bytes']/1e6:.1f}MB, "
                  f"tracking={'OK' if out['tracking_ok'] else 'LOST'}")

    if prof is not None:
        prof.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir,
                                              "trace.json"))
        if not args.quiet:
            print(f"profiler trace -> {args.profile_dir}")

    # sequence end: decay catch-up (reference: DecayCatchup at shutdown)
    slam.decay_catchup()

    if viewer is not None:
        viewer.close()
    if mem_log:
        mem_log.close()
    if args.save_trajectory:
        save_tum(args.save_trajectory,
                 [(float(f), T) for f, T in slam.trajectory()])
    if args.save_kitti_trajectory:
        save_kitti(args.save_kitti_trajectory,
                   [T for _, T in slam.trajectory()])
    if args.save_mesh:
        ntris = slam.save_mesh(args.save_mesh)
        if not args.quiet:
            print(f"mesh: {ntris} triangles -> {args.save_mesh}")
    if args.save_composite:
        rc = slam.raycast_composite()
        png.write_png(args.save_composite,
                      rc_ops.depth_to_png16(rc.depth).cpu().numpy()
                      .astype(np.uint16))
        if not args.quiet:
            print(f"composite raycast ({slam.submaps.num_local_maps} "
                  f"submaps) -> {args.save_composite}")
    if args.checkpoint_out:
        save_slam_checkpoint(args.checkpoint_out, slam)

    wall = time.time() - t_start
    summary = dict(
        frames=n,
        fps=n / wall if wall > 0 else 0.0,
        mean_fusion_ms=slam.mean_fusion_ms(),
        final_blocks=slam.submaps.local_map_size(slam.submaps.active_idx),
        final_memory_mb=slam.memory_bytes() / 1e6,
        num_submaps=slam.submaps.num_local_maps,
        num_device_submaps=slam.submaps.num_active_local_maps,
        device_memory_mb=slam.submaps.device_memory_bytes() / 1e6,
        submap_evictions=slam.submaps.num_evictions,
        submap_restores=slam.submaps.num_restores,
    )
    if not args.quiet:
        print(json.dumps(summary))
        print(TIMERS.report())
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(summary, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
