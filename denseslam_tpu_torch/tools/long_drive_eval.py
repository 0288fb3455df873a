"""Full-scale trajectory validation (port of scripts/long_drive_eval.py): a
>=500-frame full-resolution synthetic LOOP drive through the COMPLETE
SLAMSystem — stereo VO + SGM depth + TSDF fusion + local BA + loop closing
+ online correction + decay/slide-window — with photometric noise and
occluders, scored against exact ground truth:

  * ATE / RPE / KITTI rot+trans errors of the full trajectory,
  * raycast-depth metrics (MAE/RMSE/AbsRel/delta-thresholds) of the fused
    map vs GT depth at sampled keyframes,
  * loop / correction / culling counters, fps.

Writes a human-readable RESULTS block (--out) and a JSON record (--json,
plus an appended `_history.jsonl` beside it) with the JAX script's keys.
Runs on the CUDA card unless --device (or --cpu, which also shrinks the map
as the JAX script's small-shape smoke mode does) says otherwise; a small
`--frames 40 --width 320 --height 240 --cpu` run smoke-tests the code path.

The frames are rendered on the run's device (io/synthetic.py) under the
JAX script's nuisance: an exposure gain 1 + gain_amp sin(2 pi t / 150),
Gaussian photometric noise, and for the depth sensors (rgbd, mono)
relative depth noise and dropped pixels. The noise is the JAX script's
own: threefry (utils/threefry.py) under `fold_in(PRNGKey(0), s0)` for the
32-frame batch that starts at frame s0, split 2 ways (stereo: left,
right) or 3 (depth sensors: gray, depth, holes), so that a drive here
sees the JAX script's frames (its normal samples within a few float32
ulps, see utils/threefry.py). There is nothing to compile ahead:
`warmup_s` times the first use of the renderer and of the SGM evaluation
(the CUDA kernels' build).
`health_ms_*` is the host's mean enqueue time of 20 small device ops.

The pieces of the drive (system_setup, system_chunk, depth_chunk,
eval_renders, mean_metrics, drive_system) are also what chip_smoke.py
runs its `system`, `submaps` and `mono` phases with.

Usage: python -m denseslam_tpu_torch.tools.long_drive_eval [--frames 500]
           [--out RESULTS.md] [--json results_long_drive.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

CHUNK = 64                 # the flagship drive's frames per chunk
NOISE_BATCH = 32           # frames per nuisance key (fold_in of the first)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sensor", default="stereo",
                    choices=["stereo", "rgbd", "mono"],
                    help="rgbd drives the TUM/ICL-style depth-sensor path "
                    "(reference: Input.h:30-35): VO from rgbd_vo_step's "
                    "virtual right views, fusion of the sensor depth, no "
                    "stereo matcher. mono drives the MONOCULAR path "
                    "(reference: Input.h:24-28 + viso_mono): VO from "
                    "8-point RANSAC + ground-plane scale (depth never "
                    "feeds the estimator); fusion consumes the supplied "
                    "depth, as the reference's precomputed-depth mono "
                    "mode does")
    ap.add_argument("--depth-noise", type=float, default=0.01,
                    help="rgbd: relative sensor depth noise sigma")
    ap.add_argument("--depth-holes", type=float, default=0.05,
                    help="rgbd: fraction of depth pixels dropped to 0")
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--closure", type=int, default=40,
                    help="extra frames past the loop start (the revisit)")
    ap.add_argument("--width", type=int, default=1226)
    ap.add_argument("--height", type=int, default=370)
    ap.add_argument("--radius", type=float, default=18.0)
    ap.add_argument("--photo-noise", type=float, default=2.0,
                    help="per-pixel gaussian intensity noise sigma")
    ap.add_argument("--gain-amp", type=float, default=0.15,
                    help="slow sinusoidal exposure modulation amplitude")
    ap.add_argument("--keyframe-every", type=int, default=4)
    ap.add_argument("--depth-eval-every", type=int, default=25,
                    help="evaluate raycast depth at every Nth fused frame")
    ap.add_argument("--render-chunk", type=int, default=16,
                    help="frames rendered at a time in the per-frame mode "
                    "(--chunk 0)")
    ap.add_argument("--chunk", type=int, default=CHUNK,
                    help="frames per process_chunk batch (the throughput "
                    "path: one chunk scan and one backend tick a batch); 0 "
                    "= the per-frame host loop (process_frame, which "
                    "relocalizes after a lost streak frame by frame)")
    ap.add_argument("--blackout", default=None, metavar="START:LEN",
                    help="blank (zero) frames [START, START+LEN) to "
                    "exercise tracking loss + relocalization (the "
                    "reference's tracker recovery, DenseSlam.cpp:89-96)")
    ap.add_argument("--dwell", default=None, metavar="START:LEN",
                    help="hold the camera stationary for LEN frames at "
                    "frame START (an intersection stop): coincident "
                    "keyframes make keyframe culling genuinely fire "
                    "(reference: ORB-SLAM2 KeyFrameCulling + fused-frame "
                    "purge, DenseSlam.cpp:417-429)")
    ap.add_argument("--prefetch", action="store_true",
                    help="run chunk k+1's scan under chunk k's eval and "
                    "telemetry (SLAMSystem.prefetch_chunk); on chunks with "
                    "eval frames, after the eval, so that the eval sees "
                    "the map the unpipelined run sees")
    ap.add_argument("--slide-max-age", type=int, default=60,
                    help="slide-window eviction age (frames)")
    ap.add_argument("--decay-min-age", type=int, default=30,
                    help="voxel decay minimum age (frames)")
    ap.add_argument("--submap-threshold", type=float, default=-1.0,
                    help="new-submap visible-fraction threshold "
                    "(reference F_originalBlocksThreshold; -1 = single "
                    "submap). Chunk mode checks once per chunk")
    ap.add_argument("--map-budget-mb", type=float, default=-1.0,
                    help="device-memory budget across submaps; oldest "
                    "inactive submaps spill to host beyond it "
                    "(ITMSwappingEngine role; -1 = unbounded)")
    ap.add_argument("--out", default=None, help="append RESULTS block here")
    ap.add_argument("--json", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="--device cpu with the small-shape smoke config")
    ap.add_argument("--device", default=None,
                    help="torch device of the run (default: the CUDA card)")
    return ap


def drive_config(sensor: str = "stereo", width: int = 1226,
                 height: int = 370, keyframe_every: int = 4,
                 slide_max_age: int = 60, decay_min_age: int = 30,
                 submap_threshold: float = -1.0, map_budget_mb: float = -1.0,
                 small: bool = False):
    """The drive's SystemConfig (scripts/long_drive_eval.py:137-172): the
    KITTI-like rig scaled to `width`, the flagship map with the tile
    sampler, bf16 SGM costs, decay, the sliding window and online
    correction; `small` is the JAX script's CPU smoke shrink (2^14 slots,
    2^11 visible blocks, the gather sampler, 64 disparities)."""
    from ..config import (OnlineCorrectionParams, PipelineConfig,
                          SlideWindowParams, StereoConfig, SystemConfig,
                          TsdfConfig, VoxelDecayParams)
    from ..utils.camera import Intrinsics, StereoRig
    w, h = width, height
    scale = w / 1226.0
    intr = Intrinsics(fx=707.09 * scale, fy=707.09 * scale,
                      cx=(w - 1) / 2.0, cy=(h - 1) / 2.0, width=w, height=h)
    cfg = SystemConfig(
        rig=StereoRig(intr=intr, baseline_m=0.537),
        tsdf=TsdfConfig(
            voxel_size_m=0.06, trunc_dist_m=0.24, table_slots=1 << 17,
            max_visible_blocks=1 << 13, max_alloc_per_frame=1 << 13,
            max_depth_m=40.0, sampler="pallas", alloc_subsample=2),
        stereo=StereoConfig(cost_dtype="bfloat16"),
        decay=VoxelDecayParams(enabled=True, min_decay_age=decay_min_age,
                               max_decay_weight=2),
        slide_window=SlideWindowParams(enabled=True, max_age=slide_max_age),
        correction=OnlineCorrectionParams(enabled=True, correction_num=5,
                                          start_correction_num=4,
                                          min_error=0.01),
        pipeline=PipelineConfig(keyframe_every=keyframe_every,
                                fusion_db_capacity=64,
                                new_submap_threshold=submap_threshold,
                                map_memory_budget_mb=map_budget_mb,
                                sensor=sensor))
    if small:
        cfg = dataclasses.replace(
            cfg, tsdf=dataclasses.replace(
                cfg.tsdf, table_slots=1 << 14, max_visible_blocks=1 << 11,
                max_alloc_per_frame=1 << 11, sampler="gather"),
            stereo=StereoConfig(max_disparity=64))
    return cfg


def drive_length(frames: int = 500, closure: int = 40,
                 chunk: int = CHUNK) -> int:
    """The drive's frame count: frames + closure, rounded up to a whole
    number of chunks (scripts/long_drive_eval.py:174-181)."""
    n = frames + closure
    if chunk > 0 and n % chunk:
        n += chunk - n % chunk
    return n


def system_setup(frames: int = 500, closure: int = 40, radius: float = 18.0,
                 chunk: int = CHUNK, dwell=None):
    """The drive's ground truth (make_loop_trajectory(frames, radius,
    closure_frames) to drive_length(...) frames, held still for `dwell` =
    (start, length) frames) and scene (loop_scene), as
    scripts/long_drive_eval.py:174-196 makes them; the defaults are the
    flagship drive's 576 frames."""
    from ..io import synthetic
    n_total = drive_length(frames, closure, chunk)
    n_path = n_total - (dwell[1] if dwell else 0)
    gt = synthetic.make_loop_trajectory(frames, radius_m=radius,
                                        closure_frames=n_path - frames)
    scene = synthetic.loop_scene(gt)
    if dwell:
        idx = np.concatenate([np.arange(dwell[0]),
                              np.full(dwell[1], dwell[0]),
                              np.arange(dwell[0], n_path)])
        gt = gt[idx]
    return gt, scene


def _gain(lo: int, hi: int, amp: float, dev) -> torch.Tensor:
    t = torch.arange(lo, hi, dtype=torch.float32, device=dev)
    return (1.0 + amp * torch.sin(2 * math.pi * t / 150.0))[:, None, None]


def _batch_keys(key, lo: int, hi: int, parts: int):
    """(s0, s1, keys) of each NOISE_BATCH-frame batch of frames [lo, hi):
    `split(fold_in(key, s0), parts)`, as scripts/long_drive_eval.py:
    316-330 keys its batches."""
    from ..utils import threefry
    for s0 in range(lo, hi, NOISE_BATCH):
        yield (s0, min(s0 + NOISE_BATCH, hi),
               threefry.split(threefry.fold_in(key, s0), parts))


def system_chunk(cfg, gt, scene, lo: int, hi: int, key, dev,
                 photo_noise: float = 2.0, gain_amp: float = 0.15):
    """Frames [lo, hi) of the drive as rectified pairs rendered on `dev`,
    under the nuisance of scripts/long_drive_eval.py:229-238 (gain
    1 + gain_amp sin(2 pi t / 150), photometric noise on each image), the
    noise drawn from the drive's threefry key `key` (`_batch_keys`)."""
    from ..io import synthetic
    from ..utils import threefry
    lefts, rights = [], []
    for s0, s1, (kl, kr) in _batch_keys(key.to(dev), lo, hi, 2):
        lg, rg, _ = synthetic.render_stereo_trajectory(
            gt[s0:s1], cfg.rig, scene, device=dev)
        gain = _gain(s0, s1, gain_amp, dev)
        nl = photo_noise * threefry.normal(kl, lg.shape)
        nr = photo_noise * threefry.normal(kr, rg.shape)
        lefts.append(torch.clamp(lg * gain + nl, 0, 255))
        rights.append(torch.clamp(rg * gain + nr, 0, 255))
    return torch.cat(lefts), torch.cat(rights)


def depth_chunk(cfg, gt, scene, lo: int, hi: int, key, dev,
                photo_noise: float = 2.0, gain_amp: float = 0.15,
                depth_noise: float = 0.01, depth_holes: float = 0.05):
    """Frames [lo, hi) for the depth sensors (rgbd, mono) as (grays,
    supplied depths) rendered on `dev`, under the depth-sensor model of
    scripts/long_drive_eval.py:240-254 (the gain and photometric noise,
    relative depth noise, dropped pixels, no depth past max_depth_m), the
    noise drawn from the drive's threefry key `key` (`_batch_keys`)."""
    from ..io import synthetic
    from ..utils import threefry
    grays, depths = [], []
    for s0, s1, (kl, kd, kh) in _batch_keys(key.to(dev), lo, hi, 3):
        lg, dd = synthetic.render_trajectory(gt[s0:s1], cfg.rig.intr, scene,
                                             device=dev)
        gain = _gain(s0, s1, gain_amp, dev)
        nl = photo_noise * threefry.normal(kl, lg.shape)
        grays.append(torch.clamp(lg * gain + nl, 0, 255))
        dn = dd * (1.0 + depth_noise * threefry.normal(kd, dd.shape))
        holes = threefry.uniform(kh, dd.shape) < depth_holes
        drop = holes | (dd <= 0) | (dd > cfg.tsdf.max_depth_m)
        depths.append(torch.where(drop, 0.0, dn))
    return torch.cat(grays), torch.cat(depths)


def eval_floor_m(cfg) -> float:
    """The depth metrics' near limit, as scripts/long_drive_eval.py:270-280
    sets it: the rig's resolvable depth for stereo, 0.5 m for a supplied
    depth (rgbd, mono)."""
    if cfg.pipeline.sensor in ("rgbd", "mono"):
        return 0.5
    return max(0.5, cfg.rig.intr.fx * cfg.rig.baseline_m
               / (cfg.stereo.max_disparity - 1))


def gt_depth(cfg, T, scene, dev) -> np.ndarray:
    """The scene's depth seen from pose T (a (4, 4) tensor or array), 0
    beyond the map's range."""
    from ..io import synthetic
    _, d = synthetic.render_view(T, cfg.rig.intr, scene, device=dev)
    d = d.cpu().numpy()
    d[d > cfg.tsdf.max_depth_m] = 0.0
    return d


def eval_renders(cfg, system, frames, base, lefts, rights, gt, scene, dev,
                 render):
    """scripts/long_drive_eval.py:421-490 on one chunk: for each eval
    frame t, the map rendered by `render` (a pose -> Raycast) at t's
    estimated pose, scored against the ground-truth depth at that pose
    (`depth`) and at the true pose (`depth_gtpose`), and the frame's input
    depth against the latter (`depth_input`: the SGM depth of the pair, or
    for rgbd and mono the supplied depth, which `rights` then holds).
    Returns the metrics of each frame (`frame` its index)."""
    from ..eval import depth_metrics
    from ..ops import stereo

    lo, hi = eval_floor_m(cfg), cfg.tsdf.max_depth_m
    out = []
    for t in frames:
        T_est = next((T for f, T in reversed(system.slam.pose_history)
                      if f == t), None)
        if T_est is None:
            continue
        rc = render(T_est).depth.cpu().numpy()
        gtd = gt_depth(cfg, gt[t], scene, dev)
        if cfg.pipeline.sensor in ("rgbd", "mono"):
            d_in = rights[t - base].cpu().numpy()
        else:
            d_in, v_in = stereo.compute_depth(
                lefts[t - base], rights[t - base], cfg.rig, cfg.stereo,
                max_depth_m=hi)
            d_in = torch.where(v_in, d_in, 0.0).cpu().numpy()
        out.append(dict(
            frame=t,
            depth=depth_metrics.depth_metrics(
                rc, gt_depth(cfg, T_est, scene, dev), min_depth=lo,
                max_depth=hi),
            depth_gtpose=depth_metrics.depth_metrics(rc, gtd, min_depth=lo,
                                                     max_depth=hi),
            depth_input=depth_metrics.depth_metrics(d_in, gtd, min_depth=lo,
                                                    max_depth=hi)))
    return out


def mean_metrics(per_frame, key):
    """The nanmean of each metric over the eval frames, as
    scripts/long_drive_eval.py:522-527 averages them."""
    rows = [f[key] for f in per_frame]
    return {k: float(np.nanmean([r[k] for r in rows])) for k in rows[0]}


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def drive_system(cfg, dev, system, gt, scene, render, cap=None,
                 after_eval=None, frames: int = 576, eval_every: int = 25,
                 make_chunk=None, chunk: int = CHUNK, prefetch: bool = False,
                 render_chunk: int = 16, log=None):
    """A loop drive through `system`: `frames` frames in chunks of `chunk`,
    each made on `dev` by `make_chunk(cfg, gt, scene, lo, hi, key, dev)`
    (system_chunk by default; `key` the threefry PRNGKey(0) of the JAX
    script's nuisance) and run through SLAMSystem.process_chunk — or with
    chunk=0 through process_frame one frame at a time, `render_chunk`
    frames made at a time, the depth sensors' depth passed as the right
    image as scripts/long_drive_eval.py:386-387 passes it (an inherited
    defect: there rgbd raises "rgbd VO needs a depth image" and mono
    fuses nothing) — with the
    drive's depth evaluation every `eval_every`-th fused keyframe through
    `render` (eval_renders), then `after_eval()` after each chunk that had
    eval frames, and finish(). With `prefetch` the next chunk's scan is
    dispatched before this chunk's eval (after it where there are eval
    frames) by SLAMSystem.prefetch_chunk, as scripts/long_drive_eval.py:
    402-419 does. Frames/s counts the processing time from the third
    chunk on (scripts/long_drive_eval.py:296-298), less the copies of a
    tick capture `cap`; `log(hi)` is called after each chunk. Returns the
    tracking flags, the eval metrics and frames, and the seconds."""
    from ..utils import threefry
    make_chunk = make_chunk or system_chunk
    key = threefry.prng_key(0)
    use_chunk = chunk > 0
    ck = chunk if use_chunk else render_chunk
    ok_frames, proc_s, proc_frames, synth_s = [], 0.0, 0, 0.0
    evals, eval_ids, eval_s, kf_seen = [], [], 0.0, 0
    lost, t_steady, steady_frame0 = 0, None, None
    every = cfg.pipeline.keyframe_every
    steady_from = 2 * ck
    t_all = time.perf_counter()

    def make(lo, hi):
        nonlocal synth_s
        t0 = time.perf_counter()
        pair = make_chunk(cfg, gt, scene, lo, hi, key, dev)
        _sync(dev)
        synth_s += time.perf_counter() - t0
        return pair

    prepped = None
    for base in range(0, frames, ck):
        hi = min(base + ck, frames)
        lefts, rights = make(base, hi) if prepped is None else prepped
        picked = []
        if use_chunk:
            cap_s = cap.seconds if cap is not None else 0.0
            t0 = time.perf_counter()
            out = system.process_chunk(lefts, rights)
            dt = time.perf_counter() - t0
            if cap is not None:
                dt -= cap.seconds - cap_s
            if base >= steady_from:
                proc_s += dt
                proc_frames += hi - base
            elif hi >= steady_from and t_steady is None:
                t_steady, steady_frame0 = time.perf_counter(), hi
            okf = np.asarray(out["tracking_ok_frames"])
            lost += int((~okf[1:]).sum() if base == 0 else (~okf).sum())
            # every eval_every-th keyframe-slot frame that tracked, as
            # scripts/long_drive_eval.py:373-378 picks them
            for i in range(hi - base):
                if (base + i) % every == 0 and okf[i]:
                    if kf_seen % eval_every == 0:
                        picked.append(base + i)
                    kf_seen += 1
        else:
            okf = np.zeros(hi - base, bool)
            for i in range(hi - base):
                t = base + i
                t0 = time.perf_counter()
                out = system.process_frame(lefts[i], rights[i])
                okf[i] = bool(out["tracking_ok"])
                if t > steady_from:
                    proc_s += time.perf_counter() - t0
                    proc_frames += 1
                lost += int(not okf[i])
                if t == steady_from:
                    t_steady, steady_frame0 = time.perf_counter(), t + 1
                if t % every == 0:
                    if kf_seen % eval_every == 0:
                        picked.append(t)
                    kf_seen += 1
        ok_frames.append(okf)
        prepped = None

        def prefetch_next():
            nonlocal prepped
            if prefetch and use_chunk and hi < frames and prepped is None:
                nxt = make(hi, min(hi + ck, frames))
                system.prefetch_chunk(*nxt)
                prepped = nxt

        if not picked:
            prefetch_next()
        t0 = time.perf_counter()
        ev = eval_renders(cfg, system, picked, base, lefts, rights, gt,
                          scene, dev, render)
        evals += ev
        if picked and after_eval is not None:
            after_eval()
        eval_ids += [e["frame"] for e in ev]
        eval_s += time.perf_counter() - t0
        prefetch_next()
        if log is not None:
            log(hi)
    system.finish()
    _sync(dev)
    t_end = time.perf_counter()
    return dict(ok_frames=ok_frames, evals=evals, eval_ids=eval_ids,
                proc_s=proc_s, proc_frames=proc_frames,
                wall_s=t_end - t_all, synth_s=synth_s, eval_s=eval_s,
                lost=lost, steady_s=(t_end - t_steady if t_steady else None),
                steady_frame0=steady_frame0)


def health_ms(dev) -> float:
    """The host's mean enqueue time of 20 small device ops (ms)."""
    x = torch.ones((8, 128), device=dev)
    float((x * 2.0).sum())
    t0 = time.perf_counter()
    outs = [(x * 2.0 + (k + 1.0)).sum() for k in range(20)]
    dt = time.perf_counter() - t0
    float(outs[-1])
    return dt / 20 * 1e3


def _span(arg):
    return tuple(int(x) for x in arg.split(":")) if arg else None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..device import resolve_device
    from ..eval import traj_metrics
    from ..models.system import SLAMSystem

    dev = resolve_device("cpu" if args.cpu else args.device)
    w, h = args.width, args.height
    cfg = drive_config(args.sensor, w, h, args.keyframe_every,
                       args.slide_max_age, args.decay_min_age,
                       args.submap_threshold, args.map_budget_mb,
                       small=args.cpu)
    dwell, blackout = _span(args.dwell), _span(args.blackout)
    n_total = drive_length(args.frames, args.closure, args.chunk)
    if n_total != args.frames + args.closure:
        print(f"(extending closure to {n_total} total frames: "
              f"chunk-multiple batches)")
    gt, scene = system_setup(args.frames, args.closure, args.radius,
                             args.chunk, dwell)
    depth_sensor = args.sensor in ("rgbd", "mono")

    def make_chunk(cfg, gt, scene, lo, hi, key, dev):
        if depth_sensor:
            a, b = depth_chunk(cfg, gt, scene, lo, hi, key, dev,
                               args.photo_noise, args.gain_amp,
                               args.depth_noise, args.depth_holes)
        else:
            a, b = system_chunk(cfg, gt, scene, lo, hi, key, dev,
                                args.photo_noise, args.gain_amp)
        if blackout is not None:
            t = torch.arange(lo, hi, device=dev)
            keep = ~((t >= blackout[0]) & (t < blackout[0] + blackout[1]))
            keep = keep.to(torch.float32)[:, None, None]
            a, b = a * keep, b * keep
        return a, b

    system = SLAMSystem(cfg, ba_every=4, loop_every=2, device=dev)
    slam = system.slam

    # first use of the eval renderer and the SGM evaluation: the CUDA
    # kernels build here, out of the drive
    print("warmup: first use of the renderer and the SGM kernels...",
          flush=True)
    tw = time.perf_counter()
    slam.raycast_view(torch.eye(4, device=dev)).depth.cpu()
    if not depth_sensor:
        from ..ops import stereo as stereo_ops
        zi = torch.zeros((h, w), device=dev)
        stereo_ops.compute_depth(zi, zi, cfg.rig, cfg.stereo,
                                 max_depth_m=cfg.tsdf.max_depth_m)[0].cpu()
    warm_s = time.perf_counter() - tw
    print(f"warmup done in {warm_s:.1f} s", flush=True)

    def render(T):
        if len(slam.submaps.maps) > 1:
            # composite of every submap; spilled ones stay resident over
            # the eval burst, and the budget is re-enforced after it
            return slam.raycast_composite(T, respill=False, ghost=True)
        return slam.raycast_view(T)

    def after_eval():
        if len(slam.submaps.maps) > 1:
            slam.submaps.enforce_memory_budget()

    ck = args.chunk if args.chunk > 0 else args.render_chunk
    print(f"long drive: {n_total} frames @ {w}x{h}, loop radius "
          f"{args.radius} m, kf_every={args.keyframe_every}, "
          f"{'chunk=%d' % ck if args.chunk > 0 else 'per-frame'}",
          flush=True)
    health_pre = health_ms(dev)
    t0 = time.perf_counter()

    def log(hi):
        if ((hi - 1) // ck) % 4 == 0:
            el = time.perf_counter() - t0
            print(f"  frame {hi}/{n_total}  {hi / el:5.1f} fps  "
                  f"loops={system.num_loops} corr={system.num_corrections} "
                  f"culled={system.num_culled} "
                  f"mem={system.memory_bytes() / 1e6:.0f}MB", flush=True)

    d = drive_system(cfg, dev, system, gt, scene, render,
                     after_eval=after_eval, frames=n_total,
                     eval_every=args.depth_eval_every, make_chunk=make_chunk,
                     chunk=args.chunk if args.chunk > 0 else 0,
                     prefetch=args.prefetch, render_chunk=args.render_chunk,
                     log=log)
    wall = d["wall_s"]
    fps = n_total / wall
    fps_steady = ((n_total - d["steady_frame0"]) / max(d["steady_s"], 1e-9)
                  if d["steady_s"] is not None else fps)

    est = [T for _, T in system.trajectory()]
    gtl = [gt[i] for i in range(len(est))]
    ate = traj_metrics.ate_rmse(est, gtl)
    rpe_d = traj_metrics.rpe(est, gtl)
    kitti = traj_metrics.kitti_sequence_errors(est, gtl)
    end_err = float(np.linalg.norm(est[-1][:3, 3] - gtl[-1][:3, 3]))
    evals = d["evals"]
    dm, dm_gt, dm_in = (mean_metrics(evals, key) if evals else {}
                        for key in ("depth", "depth_gtpose", "depth_input"))
    z_floor = eval_floor_m(cfg)
    be = system.backend
    rec = dict(
        sensor=args.sensor,
        frames=n_total, width=w, height=h, radius_m=args.radius,
        photo_noise=args.photo_noise, gain_amp=args.gain_amp,
        keyframe_every=args.keyframe_every,
        backend=dev.type,
        chunk=args.chunk, blackout=args.blackout,
        slide_max_age=args.slide_max_age, decay_min_age=args.decay_min_age,
        depth_eval_every=args.depth_eval_every,
        depth_eval_min_m=round(z_floor, 3),
        health_ms_pre=round(health_pre, 3),
        health_ms_post=round(health_ms(dev), 3),
        fps=round(fps, 2), fps_steady=round(fps_steady, 2),
        fps_pipeline=round(d["proc_frames"] / max(d["proc_s"], 1e-9), 2),
        wall_s=round(wall, 1), synth_s=round(d["synth_s"], 1),
        eval_s=round(d["eval_s"], 1), warmup_s=round(warm_s, 1),
        phase_s={k: round(v, 1) for k, v in sorted(
            {**system.phase_s, **be.phase_s}.items())},
        tracking_lost_frames=d["lost"],
        loops=system.num_loops, corrections=system.num_corrections,
        loop_margins=[lg for lg in be.loop_log
                      if lg["sim_best"] is not None][-40:],
        culled=system.num_culled, relocs=system.num_relocs,
        dwell=args.dwell,
        cull_margin_max=(max(be.cull_margins) if be.cull_margins else None),
        cull_margin_last10=[round(x, 3) for x in be.cull_margins[-10:]],
        ba_rejects=be.ba_rejects,
        pg_rejects=be.pg_rejects,
        keyframes=be.num_keyframes,
        submaps=len(slam.submaps.maps),
        submaps_on_host=sum(1 for i in range(len(slam.submaps.maps))
                            if slam.submaps.is_on_host(i)),
        final_map_mb=round(system.memory_bytes() / 1e6, 1),
        memory=slam.memory_report(),
        ate_rmse_m=round(ate, 4), end_error_m=round(end_err, 4),
        **{k: round(v, 5) for k, v in rpe_d.items()},
        **{("kitti_" + k): round(v, 5) for k, v in kitti.items()},
        depth=({k: round(v, 4) for k, v in dm.items()} if dm else None),
        depth_gtpose=({k: round(v, 4) for k, v in dm_gt.items()}
                      if dm_gt else None),
        depth_input=({k: round(v, 4) for k, v in dm_in.items()}
                     if dm_in else None),
        # per-eval-frame spread: the headline depth numbers average a few
        # frames, so one bad frame dominates the mean
        depth_per_frame=dict(
            frame=d["eval_ids"],
            absrel=[round(e["depth_gtpose"]["absrel"], 4) for e in evals],
            absrel_estpose=[round(e["depth"]["absrel"], 4) for e in evals],
            absrel_input=[round(e["depth_input"]["absrel"], 4)
                          for e in evals],
            mae=[round(e["depth_gtpose"]["mae"], 3) for e in evals],
            coverage=[round(e["depth_gtpose"]["coverage"], 3)
                      for e in evals],
        ) if evals else None,
    )
    print(json.dumps(rec))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rec, f, indent=1)
        # append-only run history beside the latest-run file
        hist = os.path.splitext(args.json)[0] + "_history.jsonl"
        with open(hist, "a") as f:
            f.write(json.dumps(rec) + "\n")
    if args.out:
        with open(args.out, "a") as f:
            f.write(f"\n## Long-drive validation "
                    f"({time.strftime('%Y-%m-%d')}, {dev.type})\n\n")
            f.write("```json\n" + json.dumps(rec, indent=1) + "\n```\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
