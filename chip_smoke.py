"""Drive the PyTorch/CUDA port (denseslam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # from the repo root, on a machine with a card
    python3 chip_smoke.py --profile build/profile  # + profiler tables of one chunk of each path
    python3 chip_smoke.py --reps 5    # 5 samples of each throughput number

Phases, one JSON line each; any failure raises and exits non-zero:

  1. env / build   card name and power limit, torch and CUDA versions; the
                   kernel sources of denseslam_tpu_torch/csrc/ compiled by
                   nvcc, all at once (B1 and B2 share one source).
  2. kernels       B1, B3, the fused SGM tail (P1/P2) and the cost volume
                   (CV) against their plain PyTorch versions at the
                   shapes of the slice: the
                   fusion sampler on the (u, v, z) of a KITTI-scale street
                   frame (V = 8192 blocks), exact; the SGM aggregation on a
                   370x1226x128 cost volume and the fused tail on sums B3
                   made, both bit for bit in f32 and bf16 for both
                   backends, and compute_depth through them equal to the
                   unfused sequence; then both SGM kernels bit for bit at
                   ragged shapes (7x37x32, 33x130x64, 5x300x256) on volumes
                   with negative costs, +-0, subnormals and BIG; CV bit
                   for bit in f32 and bf16 on the street's frame 0 at
                   370x1226x128 and on random pairs at CV_RAGGED_SHAPES
                   and CV_EDGE_SHAPES (its tiles' edges, radii 0-31).
                   Times of kernel, plain version and library call (CV:
                   the torch.cumsum volume it replaced, and its launches
                   one by one under torch.profiler), and of each SGM
                   launch of the main path alone (bytes, bound, ns per
                   step, GB/s).
  3. slice         stereo depth + fuse_sequence over 4 chunks of 10 frames
                   of the synthetic street at the scripts/bench_full.py
                   configuration; launch counts read around exactly this
                   run (per frame 3 of B3, 1 of the fused tail, 1 of B1);
                   overflow 0; SGM depth scored against the rendered
                   depth; the first 2 frames (fusion) and frame 0 (stereo)
                   rerun on the CPU and held against the card, and frame
                   1's fusion intermediates compared between the two.
  4. kernel (B2)   the true-RGB sampler against its plain version on frame
                   0 of the RGB-D slice (V = 8192 blocks), exact; times of
                   kernel, plain version and library call (two torch.take).
  5. rgbd          the RGB-D throughput path, process_sequence_rgbd, over
                   48 street frames (3 chunks of 16) at the RGB-D drive
                   configuration of scripts/long_drive_eval.py with
                   true-RGB fusion; launch counts read around exactly this
                   run; B2 once per fused keyframe, overflow 0, tracking on
                   >= 95% of frames, final position within 3% of the
                   distance travelled.
  6. rgbd_cpu_reference  frames 0-4 rerun on the card and on the CPU with
                   the same RANSAC draws: VO poses within 1 mm / 1e-4 rad;
                   the CPU fusing with the card's poses gives the card's
                   keys, weights and colours, tsdf within 1e-6.
  7. stereo        the stereo main path, process_sequence (stereo VO on
                   every frame, SGM depth and fusion on every 4th), over
                   64 street frames in one call (one flagship chunk) at
                   the stereo drive configuration of
                   scripts/long_drive_eval.py, under its gain ramp and
                   photometric noise; launch counts read around exactly
                   this run: per fused keyframe 3 of B3, 1 of the fused
                   tail, 1 of B1; overflow 0; tracking on >= 95% of
                   frames; final position within 3% of the distance
                   travelled (ATE and KITTI t_err printed); keyframe depth
                   against the rendered depth, d1.25 > 0.8, coverage > 0.3.
  8. stereo_cpu_reference  frames 0-4 rerun on the card and on the CPU
                   with the same draws: VO poses within 1 mm / 1e-4 rad;
                   every call of describe, _gn_jacobian, _zssd,
                   _reproject_residuals and _gn_refine in the card's run
                   recomputed on the CPU from its inputs, bit for bit;
                   each keyframe's cost volume equal on both
                   devices on every element, SGM + WTA of the card's
                   volume equal on both; compute_depth's depth and
                   validity equal on every pixel; the CPU fusing the
                   card's keyframe depth at the card's poses gives the
                   card's keys, weights and tsdf.
  9. render        both renderers on the stereo phase's final map at its
                   last fused keyframe's estimated pose through
                   DenseSLAM.raycast_view (the splat renderer, the
                   default, and the sphere-traced raycast), each scored
                   against the ground-truth depth there (d1.25 > 0.8,
                   coverage > 0.3), timed behind the sleep kernel and
                   profiled once (launches, device ms, busy share, host
                   syncs); the splat z-buffer keys of the same map cloned
                   to the CPU equal the card's on >= 99.9% of pixels.
 10. system        the whole system: the stereo loop drive of
                   scripts/long_drive_eval.py (576 frames, 9 chunks of 64,
                   its configuration with online correction, its gain ramp
                   and photometric noise) through SLAMSystem.process_chunk
                   and finish(), ba_every=4, loop_every=2, with the drive's
                   depth evaluation every 25th fused keyframe (the map
                   rendered at the estimated pose against the ground truth
                   there and at the true pose, and the SGM depth); launch
                   counts read around exactly this run: per fused keyframe
                   and per eval frame 3 of B3 and 1 of the fused tail, B1
                   once per fused keyframe, twice per re-fused and once
                   per purged one; tracking on >= 95% of frames, >= 1
                   verified loop, >= 1 re-fused keyframe, overflow 0, ATE
                   <= 1.0 m, eval d1.25 >= 0.85 and coverage >= 0.3;
                   frames/s from chunk 2 on, the eval kept out of it.
 11. system_cpu_reference  the first tick of that drive that ran local BA
                   and re-fused keyframes, rerun on the CPU from the card's
                   state before it with the same verification draws:
                   keyframe poses within 1 mm / 1e-4 rad; the CPU's online
                   correction from the card's poses re-fuses as many
                   keyframes and gives the card's keys, weights and tsdf
                   (within 1e-6).
 12. submaps       the same drive (the same frames, noise and draws) with
                   submaps and swapping: --submap-threshold 0.3
                   --map-budget-mb 400 of scripts/long_drive_eval.py; the
                   eval renders the composite of every submap
                   (raycast_composite, ghost renders of spilled submaps)
                   and re-enforces the budget after each eval burst;
                   launch identities as in `system`, plus B1 twice per
                   frame that a restore or the sequence-end flush replays;
                   every pose within 1e-4 m of the `system` phase's,
                   tracking >= 95%, >= 1 verified loop, >= 3 submaps, >= 1
                   on the host at the end, >= 1 eviction and ghost render,
                   overflow 0 in every submap, eval d1.25 >= 0.85 and
                   coverage >= 0.3, after every finalize_spills the
                   committed bytes less the active submap's within the
                   budget; then a spilled submap restored and evicted, by
                   the sync path and by the async one, each time the card's
                   allocated bytes rising and falling by >= 0.9 of its
                   bytes.
 13. submaps_cpu_reference  the drive's final state carried to the CPU
                   through io/convert.py and one composite made from it on
                   both devices: splat keys of every render in it equal on
                   >= 99.9% of pixels; then a spilled submap through each
                   spill (sync compacted, async, delta) and a restore, bit
                   for bit with the device copy before it.
 14. frame         the per-frame path: the drive's first 32 frames one at
                   a time through SLAMSystem.process_frame, ba_every=4,
                   loop_every=2, the RANSAC budget pinned at
                   FRAME_PD_SCALE, then again with the backend off; launch
                   identities as in `system` in both runs, tracking on >=
                   95% of frames, overflow 0, ATE bounds (FRAME_VO_ATE_M,
                   FRAME_ATE_M); then 20 more frames of the drive with the
                   PD controller live, the last 16 timed with their host
                   syncs counted by torch.cuda.set_sync_debug_mode (with
                   --profile: profiled, device ms, launches, busy share);
                   then the next frame (a keyframe) at the last live
                   budget, from one state, with process_frame's timers and
                   without them: the same host syncs (the timers add
                   none), and that count equal to the profiler's for the
                   same frame, profiled once; frames/s, the live budget's
                   range and the first local BA's moves printed.
 15. icp           internal odometry (use_external_odometry=False) on the
                   JAX package's own internal-ICP drive (default scene,
                   0.04 m a frame, rendered depth), 16 frames at 1226x370
                   through DenseSLAM.process_frame, ICP against a splat
                   render of the map: ICP converged on every frame, each
                   step from the last fused pose within ICP_STEP_FRAC of
                   the true step, the final position within
                   ICP_FINAL_FRAC of the distance travelled, B2 once per
                   fused keyframe, and one `track` call rerun on the CPU
                   from the card's model within 1 mm / 1e-4 rad.
 16. mesh          (after system_cpu_reference) DenseSLAM.save_mesh of the
                   system phase's final map (1<<17 slots) into
                   build/mesh_system.obj: >= 1e4 triangles, edges under 2
                   voxels, the median distance of the vertices to the loop
                   scene's spheres and plane under 2 voxels (p95 printed);
                   the same map meshed on the CPU: the same triangles
                   within 1e-5 m; seconds, blocks, OBJ bytes, and the
                   card's extraction at 512 and 4096 blocks a chunk.
 17. mono          the mono loop drive of scripts/long_drive_eval.py
                   --sensor mono --frames 300 (384 frames, 6 chunks of 64,
                   the depth-sensor model: photometric noise 2.0, gain
                   0.15, 1% depth noise, 5% holes; decay 30, window 60)
                   through SLAMSystem.process_chunk and finish(),
                   ba_every=4, loop_every=2, the depth evaluation every 8th
                   fused keyframe (at the estimated pose, at the true pose,
                   and of the supplied depth); launch counts read around
                   exactly this run: B1 once per fused keyframe, twice per
                   re-fused and once per purged one, no SGM kernel;
                   tracking >= 95%, >= 1 verified loop, >= 1 re-fused
                   keyframe, no overflow but the hash's probe failures
                   (the reference's, counted apart), depth_input d1.25 >=
                   0.99, depth_gtpose d1.25 >= 0.5 and coverage >= 0.3;
                   the median ATE of this drive and 4 more with other
                   8-point draws <= MONO_ATE_M; frames/s from chunk 2 on.
 18. mono_cpu_reference  frames 0-4 of that drive through
                   process_sequence_mono on the card and on the CPU with
                   the same draws: VO poses within 1 mm / 1e-4 rad; the
                   CPU fusing at the card's poses gives the card's keys,
                   weights and colours, tsdf within 1e-6.
 19. mono_frame    the drive's first 32 frames through
                   DenseSLAM.process_frame with the supplied depth, no
                   backend (B1 once per fused keyframe): poses within
                   1e-5 m of process_sequence_mono's over the same frames
                   and draws.
 20. orb           detect_pyramid on a street frame at 1226x370 on the
                   card and the CPU (keypoints and validity equal, >=
                   99.9% of descriptor bits), hamming_matrix and match
                   equal on both devices, the detection's time; then the
                   stereo phase's 64 frames through process_sequence with
                   feature_type="orb": launches as in `stereo`, tracking
                   >= 95%, the final position within 3% of the distance.
 21. bilinear      4 frames of the slice fused with bilinear_fusion=True
                   on the card and the CPU: B1 launched 0 times (the tile
                   sampler is bypassed), keys and weights equal, tsdf
                   within 1e-6.
 22. tracks        triangulate_tracks on 4096 tracks x 8 views made from a
                   seed at 1226x370: card against CPU within 1e-4, the
                   card's ms.
 23. jax_golden    the stereo main path held to the JAX package at full
                   width: the cli sequence's 64 pairs (written by
                   cli_datasets, decoded once by io/png.py for this phase
                   and cli_chunk) through process_sequence in one call at
                   the stereo drive configuration, the RANSAC draws from
                   the frontend's key, against
                   tests/golden/stereo_chunk_jax.npz (made by the JAX
                   package's jitted process_sequence on the CPU from the
                   same PNGs, tests/_torch_golden.py; tools/golden.py):
                   inputs equal (checked first), tracking, fused and
                   inlier counts equal, poses within 1e-4 m / 1e-5, each
                   keyframe's mm depth equal, map counters equal; the
                   keyframes fused anew at the golden's poses: every block
                   key, slot and stamp equal, per block weight sums equal
                   and tsdf sums within 512 x 5e-5 on >= 99% of blocks;
                   the drive's own map: keys on >= 99.9%, sums on >= 90%
                   (documented tie tolerances: jitted XLA's FMAs in the
                   voxel projection, poses apart by up to 6.7e-5 m);
                   launches per fused keyframe CV 1, B3 3, the tail 1, B1
                   1.
 24. cli           the command line (denseslam_tpu_torch.main.main, in
                   process) on the first 32 of the 64 frames of the
                   flagship loop drive that io/make_dataset.py writes
                   into build/cli/ in
                   KITTI layout (8-bit PNGs under the drive's gain ramp and
                   noise): per frame through SLAMSystem.process_frame at
                   the drive's map flags with --sampler pallas
                   --compute_depth --enable_backend --voxel_decay
                   --slide_window --online_correction and every output;
                   launch identity (B1 = fused + 2 x re-fused + purged, B3 =
                   3 x fused, the tail = fused), tracking >= 95%, ATE <=
                   FRAME_ATE_M, overflow 0, trajectories and memory log of
                   32 lines, a mesh of >= 1e4 triangles, one raycast PNG per
                   fused keyframe reading back to its render, the JAX
                   summary's keys; frames/s, mean_fusion_ms and the TIMERS
                   report printed.
 25. cli_chunk     the same sequence with --chunk 64: the launch identity,
                   tracking >= 95%, poses equal bit for bit to
                   SLAMSystem.process_chunk called directly on the decoded
                   frames.
 26. cli_resume    the sequence's first 16 frames per frame without the
                   backend, whole and as frames 0-7, a checkpoint, and
                   8-15 resumed from it (32 frames and 16 until the
                   jax_golden phase came):
                   poses and final state equal bit for bit, the checkpoint's
                   keys the JAX layout's (the frontend's key among them).
 27. cli_rgbd      48 frames in TUM layout (640x480, the rgbd phase's sensor
                   model) with --sensor rgbd --sampler pallas --use_color:
                   the RGB-D VO branch of DenseSLAM.process_frame; tracking
                   >= 95%, B1 once per fused keyframe, the final position
                   within 3% of the distance travelled.
 28. cli_cpu_reference  the cli command's first 5 frames on the card and
                   with --device cpu (and --profile_dir): poses within 1 mm
                   / 1e-4 rad.
 29. viewer        the cli command's first 16 frames with --live_viewer on
                   a free port and --viewer_every 4, a client thread
                   polling /state, fetching and decoding every pane
                   (io/png.py), moving the free camera and recording its
                   pane: the launch identity, tracking >= 95%, the panes
                   input_rgb, scene_flow, raycast, raycast_depth and
                   freeview at 370x1226 and not all zero, a recording of
                   >= 2 frames whose .avi holds as many `idx1` entries and
                   `00dc` JPEG chunks (FFD8 ... FFD9); the viewer's added
                   seconds a frame (the same frames run without it just
                   before) printed.
 30. tools         tools/scale_sequence.py --scale 0.5 on the cli sequence:
                   calib.txt's P rows halved, images and disparities at
                   half size (the disparities halved); the command line on
                   the copy's first 8 frames: the launch identity,
                   tracking on every frame.
 31. experiments   (after tools) the experiment tools of tools/ in process,
                   each run of the command line instrumented
                   (tools/common.py run_main): the card's
                   memory_allocated back within 1% of the run's map bytes
                   after every run, no kernel launched but on the odo run.
                   (a) run_demo at the JAX defaults into build/demo (20
                   frames, 320x240): both score files finite, ATE <= 2x
                   and d1.25 >= the JAX demo's CPU scores less 0.02
                   (DEMO_*); (b) tracking_exp on the cli sequence, 64
                   frames at 1226x370, the CLI's decay defaults (30, 2):
                   none, decay, slide, decay_slide, each with tracking >=
                   95% and ATE <= FRAME_ATE_M, 4 memory logs of 64 lines,
                   the none curve never falling, final blocks decay <
                   none, decay_slide <= decay, slide <= none; (c)
                   memory_draw of the 4 logs into build/exp/memory.png:
                   decoded equal to the figure, its size, each curve's
                   colour inside the plot area; (d) odo_exp
                   --compute_depth over 32 frames: per fused keyframe 3 of
                   B3 and 1 of the tail, no B1 (the gather sampler), ATE
                   <= FRAME_VO_ATE_M, RPE and the KITTI errors in
                   odo_summary.json; (e) lowfreq_exp --ks 1 4 and
                   decay_exp at (30, 2) and its baseline over 32 frames:
                   k=4 fuses ceil(k1 / 4), the decay run ends with fewer
                   blocks; eval_raycast_depth of raycast_k1 against the
                   ground-truth depth this phase writes (poses_gt.txt,
                   depth_gt/) equal to eval/depth_metrics.py in process;
                   (f) contact_sheet of the cli run's checkpoint: its size,
                   the colour pane equal bit for bit to render_preview of
                   raycast_view at the last pose, shrunk to the pane by
                   nearest resampling; (g) prepare_dataset validate 0 on
                   both sequences. Frames/s, blocks and MB of each run,
                   the demo's scores and each tool's seconds printed.
 32. vo_drift      A4's drift golden (tests/test_vo_numerics.py:185) at
                   its size and on its data: 96 frames of the loop at
                   1226x370 under its noise, with the JAX frontend's RANSAC
                   draws (both made on the card by utils/threefry.py),
                   through open-loop vo_step: KITTI t_err < 0.6% and end
                   error < 0.8% of the path; every estimate_gain call of
                   the drive recomputed on the CPU equal bit for bit.
 33. sharded       the sharded map (parallel/) on this one card: 4 ranks
                   spawned on cuda:0 over gloo (its collectives staged
                   through the host), each fusing the slice's 40 frames
                   (its SGM depths, the bench_full.py configuration) into
                   its shard with its own B1: B1 40 times in every rank;
                   the shards gathered into one table equal to the
                   slice's single-chip map, block for block and voxel for
                   voxel, over the 30 frames before decay; over all 40,
                   blocks differ only at keys held twice (the inherited
                   hash defect) and every rank counts the same decayed
                   blocks; then the dry run (tools/dryrun_multichip.py) in
                   the same ranks. Fused frames/s of the 4 ranks.
 34. throughput    frames/s of stereo + fusion, of the fusion tail alone
                   (the bench.py workload), of the RGB-D path and of the
                   stereo main path, host clock around work that ends in a
                   synchronize; the median of --reps samples.

With --profile, torch.profiler tables of one chunk of each path, the VOs
by stage, and the captured tick's local_ba, detect_loop, optimize_graph
and apply_pose_updates, each from the card's state before the tick (and
the tables of the render and per-frame profiles).

Then a line of each phase's seconds. The line before the last two holds
every kernel with its numbers (its launches summed over the paths, and
by path; CV's equal to P1's on every path, or the script fails); the line before the last is the card's name and power limit as
nvidia-smi prints them; the last line is the result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA's H100 SXM data sheet: device memory rate and the float32 rate
# outside the tensor cores (the bounds are stated against these peaks).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

CHUNK = 10
N_CHUNKS = 4
RGBD_FRAMES = 48
RGBD_CHUNK = 16
STEREO_FRAMES = 64
N_CPU_FRAMES = 5
# the flagship drive: 500 loop frames + 40 past the start, extended to 9
# chunks of 64 (scripts/long_drive_eval.py:168-176)
SYSTEM_LOOP_FRAMES = 500
SYSTEM_FRAMES = 576
SYSTEM_CHUNK = 64
EVAL_EVERY = 25          # scripts/long_drive_eval.py --depth-eval-every
SUBMAP_THRESHOLD = 0.3   # scripts/long_drive_eval.py --submap-threshold
SUBMAP_BUDGET_MB = 400.0  # and --map-budget-mb of the submaps record
# the per-frame phase: the first half of the drive's first chunk (it ran
# two chunks until the mono, ORB and mesh phases came, one until the
# experiments phase came; cut to keep the script within its time)
FRAME_FRAMES = 32
FRAME_WARMUP = 16        # frames/s counts the frames after these
# the live-PD window after the drive: FRAME_WINDOW_WARM frames, then
# FRAME_WINDOW under the profiler (4 keyframes: one local BA and two loop
# detections, the drive's rates)
FRAME_WINDOW_WARM = 4
FRAME_WINDOW = 16
# the timers' A/B after it: the next frame, a keyframe (frontend, stereo
# depth and fusion timed, a backend tick), profiled twice; each profiled
# frame costs the script about 12 s of the profiler's own processing
FRAME_TIMER_AB = 1
ICP_FRAMES = 16
# the frame phase's RANSAC budget (the first ceil(K * scale) hypotheses
# may win), pinned so that its ATE does not move with the host's speed:
# about the mean the live PD controller held on the card (PERF.md
# section 6)
FRAME_PD_SCALE = 0.45
# the frame phase's ATE bounds, set over 128 frames from the live-PD
# readings before the first pinned run: the VO and fusion alone, and with
# the backend on. The reference's local BA, started at the ground truth
# on this drive's first keyframes, pulls them 10-12 cm off it, and the
# port's equals it (tests/test_torch_drive_ba.py); the frontend follows
# each BA, so the backend run cannot meet the VO's bound (ROADMAP.md
# Queue C)
FRAME_VO_ATE_M = 0.12
FRAME_ATE_M = 0.3
# the icp phase's bounds, set before its first run on the card (PERF.md
# section 6): a pose left at the last fused keyframe's is off by all of
# the step and ends off by about the distance travelled
ICP_STEP_FRAC = 0.5
ICP_FINAL_FRAC = 0.25
# the mono loop drive of results_mono.json: scripts/long_drive_eval.py
# --sensor mono --frames 300 (its loop closes on frame 80 at frame 380),
# 40 closure frames extended to 6 chunks of 64, the depth evaluation at
# every 8th fused keyframe
MONO_LOOP_FRAMES = 300
MONO_FRAMES = 384
MONO_EVAL_EVERY = 8
MONO_FRAME_FRAMES = 32   # the mono_frame phase: the drive's first frames
# the mono phase's gates, set before its first run on the card (PERF.md
# section 6): the JAX package's TPU record of this drive is ATE 1.76 m,
# depth_gtpose d1.25 0.616, coverage 0.37
MONO_ATE_M = 2.5
# ... held by the median ATE of the drive on MONO_ATE_DRAWS sets of
# 8-point draws (the frontend keys PRNGKey(0-4); set 0 is JAX's own):
# one drive's ATE is decided by which of the hypotheses tied at the top
# count win, which last bits move (ROADMAP.md Queue C), and it moves by
# more than the margin between the JAX record and this bound from one
# draw set to the next (PERF.md section 6)
MONO_ATE_DRAWS = 5
MONO_INPUT_D1 = 0.99
MONO_GTPOSE_D1 = 0.5
MONO_GTPOSE_COVERAGE = 0.3
# the tracks phase: tracks x views triangulated from a seed
TRACKS = 4096
TRACK_VIEWS = 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA
    events, after `warm` untimed calls). The calls are queued behind a
    sleep kernel of about 0.1 s, so a wrapper whose host cost exceeds its
    kernel's time still runs back to back on the card; a function whose
    host loop outlasts the sleep (the plain SGM) is timed with its gaps."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def host_us(fn, reps: int = 50) -> float:
    """Host time of one call of `fn` (its enqueue cost), queued behind a
    sleep kernel so that nothing waits on the card."""
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def bound_ms(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def slice_config():
    """scripts/bench_full.py:51-83 in the port's config classes."""
    from denseslam_tpu_torch.config import (SlideWindowParams, StereoConfig,
                                            SystemConfig, TsdfConfig,
                                            VoxelDecayParams)
    from denseslam_tpu_torch.utils.camera import Intrinsics, StereoRig
    intr = Intrinsics(fx=707.09, fy=707.09, cx=601.89, cy=183.11,
                      width=1226, height=370)
    tsdf = TsdfConfig(
        voxel_size_m=0.06, trunc_dist_m=0.24, table_slots=1 << 17,
        max_visible_blocks=1 << 13, max_alloc_per_frame=1 << 13,
        max_depth_m=50.0, alloc_subsample=2, sampler="pallas",
        storage_dtype="bfloat16")
    cfg = SystemConfig(
        rig=StereoRig(intr=intr, baseline_m=0.537), tsdf=tsdf,
        decay=VoxelDecayParams(enabled=True, min_decay_age=30,
                               max_decay_weight=2),
        slide_window=SlideWindowParams(enabled=True, max_age=60),
        stereo=StereoConfig(cost_dtype="bfloat16"))
    return dataclasses.replace(
        cfg, pipeline=dataclasses.replace(cfg.pipeline, fusion_db_capacity=8))


def drive_config(sensor: str):
    """The drive of scripts/long_drive_eval.py:137-166 (1226x370, default
    flags, online correction on; the port's tools/long_drive_eval.py
    drive_config) for `sensor`: the stereo and mono drives as they are,
    the RGB-D drive with tsdf.gray_color_fusion=False: its fusion samples
    true RGB through kernel B2."""
    from denseslam_tpu_torch.tools.long_drive_eval import drive_config as dc
    cfg = dc(sensor)
    return dataclasses.replace(cfg, tsdf=dataclasses.replace(
        cfg.tsdf, gray_color_fusion=sensor != "rgbd"))


def rgbd_frames(cfg, dev, seed: int = 0):
    """The RGB-D slice's input: 48 street frames along
    make_trajectory(48, step_m=0.25, yaw_rate=0.003), rendered on the card,
    under the sensor model of scripts/long_drive_eval.py:50-62, 240-254
    (gain ramp of amplitude 0.15, photometric noise 2.0, 1% relative depth
    noise, 5% holes, no depth past max_depth_m), and every frame's RANSAC
    draws: all of it drawn from one seeded CPU generator."""
    from denseslam_tpu_torch.io import synthetic
    from denseslam_tpu_torch.ops import ransac

    n = RGBD_FRAMES
    poses = synthetic.make_trajectory(n, step_m=0.25, yaw_rate=0.003)
    grays, depths = synthetic.render_trajectory(
        poses, cfg.rig.intr, synthetic.street_scene(), device=dev)
    gen = torch.Generator().manual_seed(seed)
    t = torch.arange(n, dtype=torch.float32)
    gain = (1.0 + 0.15 * torch.sin(2 * math.pi * t / 150.0))[:, None, None]
    photo = torch.randn(grays.shape, generator=gen)
    rel = torch.randn(grays.shape, generator=gen)
    holes = torch.rand(grays.shape, generator=gen) < 0.05
    grays = torch.clamp(grays * gain.to(dev) + 2.0 * photo.to(dev), 0, 255)
    noisy = depths * (1.0 + 0.01 * rel.to(dev))
    drop = holes.to(dev) | (depths <= 0) | (depths > cfg.tsdf.max_depth_m)
    depths = torch.where(drop, 0.0, noisy)
    draws = torch.stack([torch.randint(
        0, ransac._RAW_HIGH, (cfg.frontend.ransac_iters, 3), generator=gen)
        for _ in range(n)])
    torch.cuda.synchronize()
    # on the card before the drive, so that no chunk copies them there
    draws = draws.to(dev)
    return dict(poses=poses, grays=grays, depths=depths, draws=draws,
                fids=torch.arange(n, dtype=torch.int32, device=dev))


def check_sampler_rgb(cfg, dev, gpu, fr):
    """Kernel B2 against its plain version on frame 0 of the RGB-D slice."""
    from denseslam_tpu_torch.models import dense_slam
    from denseslam_tpu_torch.ops import sampling
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    intr, tc = cfg.rig.intr, cfg.tsdf
    depth = dense_slam._depth_mm(fr["depths"][0]).to(torch.float32) * 1e-3
    T = torch.as_tensor(fr["poses"][0], device=dev)
    m = tsdf_ops.make_map(tc, device=dev)
    m, slots, mask = tsdf_ops.allocate_for_frame(m, depth, T, intr, tc)
    u, v, z, _ = tsdf_ops._fusion_geometry(m, slots, mask, T, intr, tc)
    z = torch.where(mask[:, None], z, torch.zeros_like(z))
    img1, img2 = tsdf_ops.rgb_images(depth,
                                     tsdf_ops.pack_gray(fr["grays"][0]))
    args = (img1, img2, u, v, z, intr.width, intr.height)

    got = sampling.sample_blocks_rgb(*args)
    want = sampling.sample_blocks_rgb_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("out1", "out2", "flags", "overflow"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"tile_sample_rgb {name} differs from plain")
    err = max(int((a.long() - b.long()).abs().max()) for a, b in
              zip(got, want))

    ui = sampling.round_i32(u).clamp(0, intr.width - 1)
    vi = sampling.round_i32(v).clamp(0, intr.height - 1)
    flat = (vi * intr.width + ui).long()
    ms = cuda_ms(lambda: sampling.sample_blocks_rgb(*args), 50)
    plain_ms = cuda_ms(lambda: sampling.sample_blocks_rgb_plain(*args), 10)
    library_ms = cuda_ms(lambda: (torch.take(img1, flat),
                                  torch.take(img2, flat)), 50)
    wrapper_us = host_us(lambda: sampling.sample_blocks_rgb(*args))

    nvox = u.numel()
    nbytes = (3 * 4 * nvox + 2 * img1.numel() * 4 + nvox * (4 + 4 + 1)
              + u.shape[0])
    # kernel 1's 21 operations per voxel and 6 more to unpack and repack
    bnd, by = bound_ms(nbytes, 27 * nvox)
    rec = dict(name="tile_sample_rgb", route="cuda",
               source="denseslam_tpu_torch/csrc/tile_sample.cu",
               replaces="denseslam_tpu/ops/sampling.py:240",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
               bound_by=by, library_ms=library_ms)
    emit(dict(phase="kernel", name=rec["name"], shape=list(u.shape),
              live_blocks=int(mask.sum()), overflow_blocks=int(got[3].sum()),
              exact=True, kernel_ms=ms, plain_ms=plain_ms,
              library_ms=library_ms, library="2x torch.take", bytes=nbytes,
              bound_ms=bnd, bound_by=by, wrapper_host_us=wrapper_us, gpu=gpu))
    return rec


def drive_rgbd(cfg, fr):
    """process_sequence_rgbd over the frames of `fr`, RGBD_CHUNK at a time,
    from a fresh state on their device. Returns (map, stats concatenated
    over the chunks, seconds of the chunks after the first, which is the
    warm-up; None for a single chunk)."""
    from denseslam_tpu_torch.models import dense_slam, frontend
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    d = fr["grays"].device
    n = fr["grays"].shape[0]
    st = frontend.init_frontend(cfg, device=d)
    m = tsdf_ops.make_map(cfg.tsdf, device=d)
    db = dense_slam.make_fusion_db(cfg, device=d)
    stats, t0 = [], None
    for c in range(0, n, RGBD_CHUNK):
        if c == RGBD_CHUNK:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        sl = slice(c, min(c + RGBD_CHUNK, n))
        st, m, db, s = dense_slam.process_sequence_rgbd(
            st, m, db, fr["grays"][sl], fr["depths"][sl], fr["fids"][sl],
            cfg, draws=fr["draws"][sl])
        stats.append(s)
    torch.cuda.synchronize()
    keys = ("T_wc", "tracking_ok", "num_inliers", "fused")
    out = {k: torch.cat([s[k] for s in stats]) for k in keys}
    return m, out, (time.perf_counter() - t0 if t0 is not None else None)


def trajectory_gates(T_wc, poses) -> dict:
    """Poses finite and of the right shape, the final position within 3%
    of the distance travelled; returns the errors, with the ATE
    unaligned (as PR 2 printed it) and aligned, and KITTI t_err over
    5 m and 10 m segments (the drives are too short for KITTI's
    100-800 m)."""
    from denseslam_tpu_torch.eval import traj_metrics
    T = T_wc.cpu().numpy().astype(np.float64)
    if T.shape != poses.shape or not np.isfinite(T).all():
        raise AssertionError("poses have the wrong shape or non-finite values")
    gt = poses[:, :3, 3]
    travelled = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    pos_err = np.linalg.norm(T[:, :3, 3] - gt, axis=1)
    if pos_err[-1] > 0.03 * travelled:
        raise AssertionError(f"final position off by {pos_err[-1]:.3f} m "
                             f"over {travelled:.2f} m")
    kitti = traj_metrics.kitti_sequence_errors(T, poses, lengths=(5.0, 10.0),
                                               step=1)
    return dict(travelled_m=travelled, final_pos_err_m=float(pos_err[-1]),
                final_pos_err_share=float(pos_err[-1] / travelled),
                ate_rmse_m=float(np.sqrt((pos_err ** 2).mean())),
                ate_rmse_aligned_m=traj_metrics.ate_rmse(T, poses),
                kitti_t_err_pct_5_10m=kitti["kitti_t_err_pct"],
                kitti_r_err_deg_per_m_5_10m=kitti["kitti_r_err_deg_per_m"])


def pose_errors(Tg, Tc, what: str = "VO"):
    """Largest translation (m) and rotation (rad) between two pose stacks,
    at most 1 mm and 1e-4 rad; the angle of Tg^T Tc from its skew part
    (arccos of the trace is ill-conditioned at small angles)."""
    Tg, Tc = Tg.cpu().double(), Tc.cpu().double()
    t_err = float((Tg[:, :3, 3] - Tc[:, :3, 3]).norm(dim=-1).max())
    Rd = Tg[:, :3, :3].transpose(1, 2) @ Tc[:, :3, :3]
    W = (Rd - Rd.transpose(1, 2)) / 2
    r_err = float(torch.stack([W[:, 2, 1], W[:, 0, 2], W[:, 1, 0]], -1)
                  .norm(dim=-1).arcsin().max())
    if t_err > 1e-3 or r_err > 1e-4:
        raise AssertionError(f"{what} card vs CPU: {t_err} m, {r_err} rad")
    return t_err, r_err


def run_rgbd(cfg, fr):
    """The RGB-D main path: 48 frames through process_sequence_rgbd, with
    the launch counts set to 0 just before and read just after."""
    from denseslam_tpu_torch import kernels
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    kernels.reset_counts()
    m, stats, _ = drive_rgbd(cfg, fr)
    launches = dict(kernels.launch_counts)

    fused = int(stats["fused"].sum())
    overflow = int(m.overflow)
    if launches["tile_sample_rgb"] != fused or fused == 0:
        raise AssertionError(f"B2 launched {launches['tile_sample_rgb']} "
                             f"times for {fused} fused keyframes")
    if overflow != 0:
        raise AssertionError(f"map overflow {overflow}")
    ok = stats["tracking_ok"].cpu().numpy()
    track = float(ok[1:].mean())
    if track < 0.95:
        raise AssertionError(f"tracking held on {track:.3f} of the frames")
    traj = trajectory_gates(stats["T_wc"], fr["poses"])
    if not torch.isfinite(m.tsdf).all():
        raise AssertionError("non-finite tsdf")
    blocks = int(tsdf_ops.num_allocated_blocks(m))
    colour = tsdf_ops.unpack_rgb(m.color[m.weight > 0])
    emit(dict(phase="rgbd", frames=RGBD_FRAMES, fused=fused,
              launches=launches, overflow=overflow, blocks=blocks,
              decayed_blocks=int(m.decayed_blocks), tracking_ok_share=track,
              inliers_median=float(np.median(
                  stats["num_inliers"].cpu().numpy()[1:])),
              **traj, fused_colour_mean=[float(c.mean()) for c in colour]))
    return dict(launches=launches, stats=stats)


def check_rgbd_against_cpu(cfg, dev, fr):
    """Frames 0-4 rerun on the card and on the CPU with the same draws: the
    VO poses agree, and the CPU fusing the card's keyframes at the card's
    poses rebuilds the card's map."""
    from denseslam_tpu_torch.models import dense_slam
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    n = N_CPU_FRAMES
    cpu = torch.device("cpu")
    sub = {k: v[:n] for k, v in fr.items()}
    mg, sg, _ = drive_rgbd(cfg, sub)
    sub_cpu = {k: (v.to(cpu) if isinstance(v, torch.Tensor) else v)
               for k, v in sub.items()}
    _, sc, _ = drive_rgbd(cfg, sub_cpu)
    t_err, r_err = pose_errors(sg["T_wc"], sc["T_wc"])
    if not torch.equal(sg["fused"].cpu(), sc["fused"]):
        raise AssertionError("card and CPU fused different keyframes")

    mc = tsdf_ops.make_map(cfg.tsdf, device=cpu)
    db = dense_slam.make_fusion_db(cfg, device=cpu)
    for i in torch.nonzero(sc["fused"]).flatten().tolist():
        mc, db = dense_slam.fuse_keyframe(
            mc, db, sub_cpu["depths"][i], sub_cpu["grays"][i],
            sg["T_wc"][i].cpu(), i, cfg)
    for name in ("weight", "color"):
        if not torch.equal(getattr(mg, name).cpu(), getattr(mc, name)):
            raise AssertionError(f"{name} differs between card and CPU")
    if not torch.equal(mg.table.keys.cpu(), mc.table.keys):
        raise AssertionError("hash tables differ between card and CPU")
    tg = mg.tsdf.cpu()
    tsdf_err = float((tg - mc.tsdf).abs().max())
    tsdf_frac = float((tg != mc.tsdf).float().mean())
    if tsdf_err > 1e-6:
        raise AssertionError(f"tsdf card vs CPU: {tsdf_err}, {tsdf_frac}")
    emit(dict(phase="rgbd_cpu_reference", frames=n,
              fused=int(sc["fused"].sum()), vo_pos_err_m=t_err,
              vo_rot_err_rad=r_err,
              tables_equal=True, weights_equal=True, colours_equal=True,
              tsdf_max_abs_err=tsdf_err,
              tsdf_frac_differ=tsdf_frac))


def stereo_frames(cfg, dev, seed: int = 1):
    """The stereo slice's input: 64 street frames along
    make_trajectory(64, step_m=0.25, yaw_rate=0.003) as rectified pairs,
    rendered on the card, under the stereo drive's nuisance of
    scripts/long_drive_eval.py:229-238 (gain 1 + 0.15 sin(2 pi t / 150),
    photometric noise 2.0 on each image), and every frame's RANSAC draws:
    all of it drawn from one seeded CPU generator."""
    from denseslam_tpu_torch.io import synthetic
    from denseslam_tpu_torch.ops import ransac

    n = STEREO_FRAMES
    poses = synthetic.make_trajectory(n, step_m=0.25, yaw_rate=0.003)
    lefts, rights, gts = synthetic.render_stereo_trajectory(
        poses, cfg.rig, synthetic.street_scene(), device=dev)
    gen = torch.Generator().manual_seed(seed)
    t = torch.arange(n, dtype=torch.float32)
    gain = (1.0 + 0.15 * torch.sin(2 * math.pi * t / 150.0))[:, None, None]
    nl = torch.randn(lefts.shape, generator=gen)
    nr = torch.randn(rights.shape, generator=gen)
    lefts = torch.clamp(lefts * gain.to(dev) + 2.0 * nl.to(dev), 0, 255)
    rights = torch.clamp(rights * gain.to(dev) + 2.0 * nr.to(dev), 0, 255)
    draws = torch.stack([torch.randint(
        0, ransac._RAW_HIGH, (cfg.frontend.ransac_iters, 3), generator=gen)
        for _ in range(n)])
    torch.cuda.synchronize()
    return dict(poses=poses, lefts=lefts, rights=rights, gts=gts,
                draws=draws.to(dev),
                fids=torch.arange(n, dtype=torch.int32, device=dev))


def drive_stereo(cfg, fr):
    """process_sequence over all frames of `fr` in one call, from a fresh
    state on their device. Returns (map, stats, seconds of the call)."""
    from denseslam_tpu_torch.models import dense_slam, frontend
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    d = fr["lefts"].device
    st = frontend.init_frontend(cfg, device=d)
    m = tsdf_ops.make_map(cfg.tsdf, device=d)
    db = dense_slam.make_fusion_db(cfg, device=d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m, db, stats = dense_slam.process_sequence(
        st, m, db, fr["lefts"], fr["rights"], fr["fids"], cfg,
        draws=fr["draws"])
    torch.cuda.synchronize()
    return m, stats, time.perf_counter() - t0


def keyframe_depths(cfg, fr, stats):
    """The SGM depth of each fused keyframe as process_sequence computed
    it (compute_depth is deterministic): (indices, (K, H, W) depths)."""
    from denseslam_tpu_torch.ops import stereo
    kf = torch.nonzero(stats["fused"]).flatten().tolist()
    return kf, torch.stack([stereo.compute_depth(
        fr["lefts"][i], fr["rights"][i], cfg.rig, cfg.stereo)[0] for i in kf])


def run_stereo(cfg, fr):
    """The stereo main path: 64 frames through process_sequence, with the
    launch counts set to 0 just before and read just after."""
    from denseslam_tpu_torch import kernels
    from denseslam_tpu_torch.eval import depth_metrics
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    kernels.reset_counts()
    m, stats, secs = drive_stereo(cfg, fr)
    launches = dict(kernels.launch_counts)

    fused = int(stats["fused"].sum())
    want = dict(tile_sample=fused, tile_sample_rgb=0, sgm_path=3 * fused,
                sgm_final=fused,
                cost_volume=fused)
    if fused == 0 or launches != want:
        raise AssertionError(f"launches {launches} for {fused} fused "
                             f"keyframes, want {want}")
    overflow = int(m.overflow)
    if overflow != 0:
        raise AssertionError(f"map overflow {overflow}")
    ok = stats["tracking_ok"].cpu().numpy()
    track = float(ok[1:].mean())
    if track < 0.95:
        raise AssertionError(f"tracking held on {track:.3f} of the frames")
    traj = trajectory_gates(stats["T_wc"], fr["poses"])
    if not torch.isfinite(m.tsdf).all():
        raise AssertionError("non-finite tsdf")
    kf, depth = keyframe_depths(cfg, fr, stats)
    q = depth_metrics.depth_metrics(depth.cpu().numpy(),
                                    fr["gts"][kf].cpu().numpy())
    if not (q["d1_25"] > 0.8 and q["coverage"] > 0.3):
        raise AssertionError(f"keyframe SGM depth off the rendered depth: {q}")
    emit(dict(phase="stereo", frames=STEREO_FRAMES, fused=fused,
              launches=launches, overflow=overflow,
              blocks=int(tsdf_ops.num_allocated_blocks(m)),
              decayed_blocks=int(m.decayed_blocks), tracking_ok_share=track,
              inliers_median=float(np.median(
                  stats["num_inliers"].cpu().numpy()[1:])),
              **traj, depth_absrel=q["absrel"], depth_d1_25=q["d1_25"],
              depth_coverage=q["coverage"], seconds=secs))
    return dict(launches=launches, stats=stats, map=m)


def check_stereo_against_cpu(cfg, dev, fr):
    """Frames 0-4 rerun on the card and on the CPU with the same draws: the
    VO poses agree; the five VO ops that used to round differently on
    the two devices (describe's norm, _gn_jacobian's product, _zssd,
    _reproject_residuals' transform, _gn_refine's sums and update), every
    call of the card's run recomputed on the CPU from its inputs, equal
    bit for bit; on each fused keyframe the cost volumes equal on
    every element, SGM + WTA of the card's volume equal on both devices,
    and compute_depth's depth and validity equal on every pixel; the CPU
    fusing the card's keyframe depth at the card's poses rebuilds the
    card's map."""
    from denseslam_tpu_torch.models import dense_slam
    from denseslam_tpu_torch.ops import stereo
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops
    from denseslam_tpu_torch.tools import device_trace
    from denseslam_tpu_torch.utils.camera import disparity_to_depth

    n = N_CPU_FRAMES
    cpu = torch.device("cpu")
    sub = {k: v[:n] for k, v in fr.items()}
    with device_trace.OpRecorder(device_trace.VO_OPS) as rec:
        mg, sg, _ = drive_stereo(cfg, sub)
    vo_ops = rec.recheck()
    sub_cpu = {k: (v.to(cpu) if isinstance(v, torch.Tensor) else v)
               for k, v in sub.items()}
    _, sc, cpu_s = drive_stereo(cfg, sub_cpu)
    t_err, r_err = pose_errors(sg["T_wc"], sc["T_wc"])
    if not torch.equal(sg["fused"].cpu(), sc["fused"]):
        raise AssertionError("card and CPU fused different keyframes")
    if len(vo_ops) != len(device_trace.VO_OPS) or any(
            r["equal"] != r["calls"] for r in vo_ops.values()):
        raise AssertionError(f"VO ops card vs CPU from equal inputs: {vo_ops}")
    # each keyframe's cost volume on both devices, SGM + WTA of each, and
    # compute_depth's depth (the same steps as compute_depth) on both
    stc = cfg.stereo
    wdt = torch.bfloat16 if stc.cost_dtype == "bfloat16" else torch.float32
    kf = torch.nonzero(sg["fused"]).flatten().tolist()
    if not kf:
        raise AssertionError("no keyframe fused in the CPU rerun's frames")
    cost_equal, dc = [], []
    for i in kf:
        cg = stereo.cost_volume(sub["lefts"][i], sub["rights"][i], stc, wdt)
        cc = stereo.cost_volume(sub_cpu["lefts"][i], sub_cpu["rights"][i],
                                stc, wdt)
        cost_equal.append(float((cg.cpu() == cc).float().mean()))
        got = stereo.disparity(cg, stc)
        want = stereo.disparity(cc, stc)
        for name, a, b in zip(("disp", "valid"), got, want):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"SGM + WTA of frame {i}'s cost volume: "
                                     f"{name} differs between card and CPU")
        dc.append(disparity_to_depth(want[0], cfg.rig, 0.05, 60.0))
    del cg, cc
    if min(cost_equal) < 1.0:
        raise AssertionError(f"cost volume card vs CPU: equal shares "
                             f"{cost_equal}")
    _, dg = keyframe_depths(cfg, sub, sg)
    dg, dc = dg.cpu(), torch.stack(dc)
    equal = float((dg == dc).float().mean())
    agree = float(((dg > 0) == (dc > 0)).float().mean())
    if equal < 1.0 or agree < 1.0:
        raise AssertionError(f"stereo card vs CPU: depth equal {equal}, "
                             f"valid {agree}")

    mc = tsdf_ops.make_map(cfg.tsdf, device=cpu)
    db = dense_slam.make_fusion_db(cfg, device=cpu)
    for j, i in enumerate(kf):
        mc, db = dense_slam.fuse_keyframe(mc, db, dg[j], sub_cpu["lefts"][i],
                                          sg["T_wc"][i].cpu(), i, cfg)
    if not torch.equal(mg.table.keys.cpu(), mc.table.keys):
        raise AssertionError("hash tables differ between card and CPU")
    if not torch.equal(mg.weight.cpu(), mc.weight):
        raise AssertionError("weights differ between card and CPU")
    tg = mg.tsdf.cpu()
    tsdf_err = float((tg - mc.tsdf).abs().max())
    if tsdf_err > 1e-6:
        raise AssertionError(f"tsdf card vs CPU: {tsdf_err}")
    emit(dict(phase="stereo_cpu_reference", frames=n, fused=len(kf),
              vo_pos_err_m=t_err, vo_rot_err_rad=r_err,
              vo_ops_equal={k: f"{r['equal']}/{r['calls']}"
                            for k, r in vo_ops.items()},
              sgm_wta_equal=True, cost_volume_equal_share=min(cost_equal),
              depth_equal_share=equal, depth_valid_agree=agree,
              tables_equal=True, weights_equal=True,
              tsdf_max_abs_err=tsdf_err, cpu_seconds=cpu_s))


def check_sampler(cfg, dev, gpu):
    """Kernel 1 against its plain version on frame 0 of the street."""
    from denseslam_tpu_torch.io import synthetic
    from denseslam_tpu_torch.ops import sampling
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    intr, tc = cfg.rig.intr, cfg.tsdf
    pose = synthetic.make_trajectory(1)[0]
    gray, depth = synthetic.render_view(pose, intr, synthetic.street_scene(),
                                        device=dev)
    depth = torch.clamp(torch.round(depth * 1e3), 0, 65535) * 1e-3
    T = torch.as_tensor(pose, device=dev)
    m = tsdf_ops.make_map(tc, device=dev)
    m, slots, mask = tsdf_ops.allocate_for_frame(m, depth, T, intr, tc)
    u, v, z, _ = tsdf_ops._fusion_geometry(m, slots, mask, T, intr, tc)
    z = torch.where(mask[:, None], z, torch.zeros_like(z))
    combo = tsdf_ops._quantized_combo(depth, tsdf_ops.pack_gray(gray))
    args = (combo, u, v, z, intr.width, intr.height)

    got = sampling.sample_blocks(*args)
    want = sampling.sample_blocks_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("sample", "flags", "overflow"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"tile_sample {name} differs from plain")
    err = int((got[0] - want[0]).abs().max())

    ui = sampling.round_i32(u).clamp(0, intr.width - 1)
    vi = sampling.round_i32(v).clamp(0, intr.height - 1)
    flat = (vi * intr.width + ui).long()
    ms = cuda_ms(lambda: sampling.sample_blocks(*args), 50)
    plain_ms = cuda_ms(lambda: sampling.sample_blocks_plain(*args), 10)
    library_ms = cuda_ms(lambda: torch.take(combo, flat), 50)
    wrapper_us = host_us(lambda: sampling.sample_blocks(*args))

    nvox = u.numel()
    nbytes = 3 * 4 * nvox + combo.numel() * 4 + nvox * (4 + 1) + u.shape[0]
    # per voxel: 2 roundings, 6 bound tests, 4 min/max, 4 tile tests,
    # index arithmetic (3) and the flag packing (2)
    bnd, by = bound_ms(nbytes, 21 * nvox)
    rec = dict(name="tile_sample", route="cuda",
               source="denseslam_tpu_torch/csrc/tile_sample.cu",
               replaces="denseslam_tpu/ops/sampling.py:269",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
               bound_by=by, library_ms=library_ms)
    emit(dict(phase="kernel", name=rec["name"], shape=list(u.shape),
              live_blocks=int(mask.sum()), overflow_blocks=int(got[2].sum()),
              exact=True, kernel_ms=ms, plain_ms=plain_ms,
              library_ms=library_ms, library="torch.take",
              bound_ms=bnd, bound_by=by, wrapper_host_us=wrapper_us, gpu=gpu))
    return rec


def check_sgm(cfg, dev, gpu):
    """Kernel 2 against its plain version on a KITTI-size cost volume: bit
    for bit in f32 (integer-valued and real-valued costs) and bf16, both
    backends."""
    from denseslam_tpu_torch.io import synthetic
    from denseslam_tpu_torch.ops import sgm
    from denseslam_tpu_torch.ops import stereo

    sc = cfg.stereo
    pose = synthetic.make_trajectory(1)
    left, right, _ = synthetic.render_stereo_trajectory(
        pose, cfg.rig, synthetic.street_scene(), device=dev)
    cost = stereo.cost_volume(left[0], right[0], sc)
    p1, p2 = sc.sgm_p1, sc.sgm_p2

    err = 0.0
    for name, c in (("f32 integer", torch.round(cost)), ("f32", cost),
                    ("bf16", cost.to(torch.bfloat16))):
        for backend in ("xla", "pallas"):
            got = sgm.sgm_aggregate(c, p1, p2, backend)
            want = sgm.sgm_aggregate_plain(c, p1, p2, backend)
            d = float((got.float() - want.float()).abs().max())
            err = max(err, d)
            if not torch.equal(got, want):
                raise AssertionError(f"sgm {name} {backend}: max |diff| {d}")
    del c, got, want
    cb = cost.to(torch.bfloat16)

    ms = cuda_ms(lambda: sgm.sgm_aggregate(cb, p1, p2, sc.sgm_backend), 10)
    wrapper_us = host_us(lambda: sgm.sgm_aggregate(cb, p1, p2, sc.sgm_backend),
                         10)
    plain_ms = cuda_ms(
        lambda: sgm.sgm_aggregate_plain(cb, p1, p2, sc.sgm_backend), 2, warm=1)
    n = cb.numel()
    # per element and direction: 2 adds of P1, 3 minimums, the add and the
    # subtract of the step, one term of the min over D; 3 direction sums
    bnd, by = bound_ms(2 * n * cb.element_size(), (4 * 8 + 3) * n)
    rec = dict(name="sgm_path", route="cuda",
               source="denseslam_tpu_torch/csrc/sgm.cu",
               replaces="denseslam_tpu/ops/sgm_pallas.py:144",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
               bound_by=by, library_ms=None)
    emit(dict(phase="kernel", name=rec["name"], shape=list(cb.shape),
              exact_f32_bf16_both_backends=True, kernel_ms=ms,
              plain_ms=plain_ms, library_ms=None, bound_ms=bnd, bound_by=by,
              wrapper_host_us=wrapper_us, gpu=gpu))
    return rec


def _edge_volume(shape, dtype, dev, seed):
    """A raw cost volume with the values the kernels' orderings must get
    right: real costs in [-2, 300) (the box filter's cumsum differences can
    be slightly negative), exact +-0, subnormals, near-ties (integers) and
    BIG where x < d, as the cost volume marks no overlap."""
    h, w, d = shape
    gen = torch.Generator().manual_seed(seed)
    c = torch.rand(shape, generator=gen) * 302.0 - 2.0
    pick = torch.randint(0, 16, shape, generator=gen)
    c = torch.where(pick == 0, torch.zeros(()), c)
    c = torch.where(pick == 1, torch.full((), -0.0), c)
    c = torch.where(pick == 2, torch.full((), 1e-40), c)
    c = torch.where(pick == 3, torch.full((), -3e-39), c)
    c = torch.where(pick >= 12, torch.round(c), c)
    invalid = torch.arange(w)[None, :, None] < torch.arange(d)[None, None, :]
    c = torch.where(invalid, torch.full((), 1e4), c)
    return c.to(dev, dtype)


RAGGED_SHAPES = ((7, 37, 32), (33, 130, 64), (5, 300, 256))


def check_sgm_ragged(cfg, dev):
    """Both SGM kernels against their plain versions bit for bit at shapes
    the tiling has to mask (W not a multiple of the column chunk, H not a
    multiple of the column group, D = 32, 64, 256), in f32 and bf16, both
    backends, on `_edge_volume`s."""
    from denseslam_tpu_torch.ops import sgm

    p1, p2 = cfg.stereo.sgm_p1, cfg.stereo.sgm_p2
    names = sgm.WtaMaps._fields
    cases = [(i, shape, dtype, backend)
             for i, shape in enumerate(RAGGED_SHAPES)
             for dtype in (torch.float32, torch.bfloat16)
             for backend in ("xla", "pallas")]
    for i, shape, dtype, backend in cases:
        what = f"{shape} {dtype} {backend}"
        c = _edge_volume(shape, dtype, dev, seed=i)
        got = sgm.sgm_aggregate(c, p1, p2, backend)
        want = sgm.sgm_aggregate_plain(c, p1, p2, backend)
        if not torch.equal(got, want):
            raise AssertionError(f"sgm {what}")
        acc, extra = sgm._three_paths(c, p1, p2, backend)
        for unique in (True, False):
            got = sgm.sgm_final(c, acc, extra, p1, p2, backend, unique)
            want = sgm.sgm_final_plain(c, acc, extra, p1, p2, backend, unique)
            for name, a, b in zip(names, got, want):
                if not (a is None and b is None or torch.equal(a, b)):
                    raise AssertionError(f"sgm_final {what} unique={unique}: "
                                         f"{name} differs")
    torch.cuda.synchronize()
    emit(dict(phase="kernel_ragged", shapes=[list(s) for s in RAGGED_SHAPES],
              dtypes=["float32", "bfloat16"], backends=["xla", "pallas"],
              sgm_path_exact=True, sgm_final_exact=True))


def sgm_launch_times(cb, p1, p2, gpu):
    """Each SGM launch of the main path ("xla": tb; bt adding the vertical
    sum in place; lr; the fused tail on acc = lr, extra = tb + bt) and the
    "pallas" order's in-place lr launch, timed alone on the volume `cb`.
    Bytes count each input volume read once and the output written once;
    the path launches do 8 operations per element for the step plus one
    per direction sum, the tail 15 as `check_sgm_final` counts them. ns
    per step is the kernel time over the length of the path (H for the
    vertical paths, W for the horizontal ones): every scanline walks it
    serially."""
    from denseslam_tpu_torch.ops import sgm

    h, w, d = cb.shape
    n = cb.numel()
    vol = n * cb.element_size()
    vert, lr = torch.empty_like(cb), torch.empty_like(cb)
    sgm._launch_path(cb, vert, 0, False, p1, p2)
    sgm._launch_path(cb, vert, 0, True, p1, p2, acc=vert)
    sgm._launch_path(cb, lr, 1, False, p1, p2)
    out, inplace = torch.empty_like(cb), vert.clone()
    maps = 7 * h * w * 4

    def path(axis, reverse, acc=None, o=out):
        return lambda: sgm._launch_path(cb, o, axis, reverse, p1, p2, acc=acc)

    cases = (
        ("sgm_path", "tb", h, 2 * vol, 8 * n, path(0, False)),
        ("sgm_path", "bt (acc = out)", h, 3 * vol, 9 * n,
         path(0, True, inplace, inplace)),
        ("sgm_path", "lr", w, 2 * vol, 8 * n, path(1, False)),
        ("sgm_path", "lr pallas (acc = out)", w, 3 * vol, 9 * n,
         path(1, False, inplace, inplace)),
        ("sgm_final", "rl + sums + WTA, xla", w, 3 * vol + maps, 15 * n,
         lambda: sgm.sgm_final(cb, lr, vert, p1, p2, "xla")),
    )
    rows = []
    for kernel, launch, steps, nbytes, nops, fn in cases:
        ms = cuda_ms(fn, 20)
        bnd, by = bound_ms(nbytes, nops)
        rows.append(dict(kernel=kernel, launch=launch, steps=steps,
                         bytes=nbytes, bound_ms=bnd, bound_by=by, ms=ms,
                         share_of_bound=bnd / ms, ns_per_step=ms * 1e6 / steps,
                         gb_per_s=nbytes / ms / 1e6))
    emit(dict(phase="sgm_launches", shape=list(cb.shape), dtype=str(cb.dtype),
              launches=rows, gpu=gpu))
    return rows


def _tie_volume(d: int, dtype, dev):
    """(2, 6, d) summed volume with a WTA tie (d = 3 and 7), a right-view
    tie (x_r = 1 at d = 2 and 4) and a right pixel whose candidates all
    equal BIG in the cost dtype (x_r = 4), as tests/test_torch_sgm_final.py
    builds it."""
    big = float(torch.tensor(1e4, dtype=dtype).float())
    fin = torch.full((2, 6, d), 500.0)
    fin[:, :, 3] = fin[:, :, 7] = 7.0
    fin[0, 3, 2] = fin[0, 5, 4] = 5.0
    fin[1, 4, 0] = fin[1, 5, 1] = big
    return fin.to(dev, dtype)


def check_sgm_final(cfg, dev, gpu):
    """Kernel 4 against its plain version on a KITTI-size volume (frame 0
    of the street): every map bit for bit, in f32 and bf16, for both
    backends, on sums that kernel 2 made; the hand-built tie volume; and
    compute_depth (kernel 2 three times + kernel 4) against the unfused
    sequence it replaces (kernel 2 four times + the torch WTA over the
    summed volume), depth and validity equal. Times of kernel 4, its plain
    version and the unfused sequence's fourth launch + WTA."""
    from denseslam_tpu_torch.io import synthetic
    from denseslam_tpu_torch.ops import sgm, stereo
    from denseslam_tpu_torch.utils.camera import disparity_to_depth

    sc = cfg.stereo
    p1, p2 = sc.sgm_p1, sc.sgm_p2
    pose = synthetic.make_trajectory(1)
    left, right, _ = synthetic.render_stereo_trajectory(
        pose, cfg.rig, synthetic.street_scene(), device=dev)
    cost = stereo.cost_volume(left[0], right[0], sc)
    names = sgm.WtaMaps._fields
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        c = cost.to(dtype)
        for backend in ("xla", "pallas"):
            acc, extra = sgm._three_paths(c, p1, p2, backend)
            got = sgm.sgm_final(c, acc, extra, p1, p2, backend)
            want = sgm.sgm_final_plain(c, acc, extra, p1, p2, backend)
            for name, a, b in zip(names, got, want):
                err = max(err, float((a.double() - b.double()).abs().max()))
                if not torch.equal(a, b):
                    raise AssertionError(f"sgm_final {dtype} {backend} "
                                         f"{name} differs from plain")
        tie = _tie_volume(c.shape[-1], dtype, dev)
        z = torch.zeros_like(tie)
        got = sgm.sgm_final(z, tie, None, p1, p2, "pallas", unique=False)
        want = sgm.sgm_final_plain(z, tie, None, p1, p2, "pallas",
                                   unique=False)
        for name, a, b in zip(names[:5], got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"sgm_final tie volume {dtype} {name}")
        if int(got.best_r[0, 1]) != 2 or int(got.best_r[1, 4]) != 0:
            raise AssertionError("sgm_final tie rule")
    del acc, extra, got, want

    # compute_depth against the unfused sequence, both backends
    wdt = torch.bfloat16 if sc.cost_dtype == "bfloat16" else torch.float32

    def unfused(sc_b):
        cb_ = stereo.cost_volume(left[0], right[0], sc_b).to(wdt)
        agg = sgm.sgm_aggregate(cb_, p1, p2, sc_b.sgm_backend)
        disp, valid = stereo.disparity_from_cost(agg, sc_b, raw_cost=cb_)
        depth = disparity_to_depth(disp, cfg.rig, 0.05, 60.0)
        return depth, valid & (depth > 0)

    for backend in ("xla", "pallas"):
        sc_b = dataclasses.replace(sc, sgm_backend=backend)
        fused = stereo.compute_depth(left[0], right[0], cfg.rig, sc_b)
        for name, a, b in zip(("depth", "valid"), fused, unfused(sc_b)):
            if not torch.equal(a, b):
                raise AssertionError(f"compute_depth {backend}: {name} "
                                     "differs from the unfused sequence")

    cb = cost.to(wdt)
    backend = sc.sgm_backend
    acc, extra = sgm._three_paths(cb, p1, p2, backend)
    fourth = torch.empty_like(cb)

    def unfused_tail():
        sgm._launch_path(cb, fourth, 1, True, p1, p2, acc=acc, extra=extra)
        return sgm.wta_maps(fourth, cb)

    ms = cuda_ms(lambda: sgm.sgm_final(cb, acc, extra, p1, p2, backend), 20)
    wrapper_us = host_us(lambda: sgm.sgm_final(cb, acc, extra, p1, p2,
                                               backend), 20)
    unfused_ms = cuda_ms(unfused_tail, 10)
    plain_ms = cuda_ms(lambda: sgm.sgm_final_plain(cb, acc, extra, p1, p2,
                                                   backend), 2, warm=1)
    h, w, d = cb.shape
    n = cb.numel()
    vols = 3 if extra is not None else 2
    nbytes = vols * n * cb.element_size() + 7 * h * w * 4
    # per element: the step (2 adds of P1, 3 minimums, add, subtract, a
    # term of min L'), the direction sum(s), a term each of cmin, the
    # argmin, the right-view compare and select, and of `second`
    bnd, by = bound_ms(nbytes, (8 + vols - 1 + 5) * n)
    rec = dict(name="sgm_final", route="cuda",
               source="denseslam_tpu_torch/csrc/sgm_final.cu",
               replaces="scripts/probes/exp_fused_sgm.py:169 and "
                        "scripts/probes/exp_fused_loop.py:118",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
               bound_by=by, library_ms=None)
    emit(dict(phase="kernel", name=rec["name"], shape=list(cb.shape),
              dtype=str(cb.dtype), backend=backend,
              exact_f32_bf16_both_backends=True, tie_rules=True,
              compute_depth_equals_unfused=True, kernel_ms=ms,
              plain_ms=plain_ms, unfused_ms=unfused_ms, library_ms=None,
              bytes=nbytes, bound_ms=bnd, bound_by=by,
              wrapper_host_us=wrapper_us, gpu=gpu))
    del acc, extra, fourth
    per_launch = sgm_launch_times(cb, p1, p2, gpu)
    rec["per_launch"] = [r for r in per_launch if r["kernel"] == "sgm_final"]
    return rec, [r for r in per_launch if r["kernel"] == "sgm_path"]


def drive(cfg, dev, run):
    """Stereo depth + fuse_sequence over the run's frames, chunk by chunk,
    on a fresh map. Returns (map, depths, seconds of the chunks after the
    first, which is the warm-up)."""
    from denseslam_tpu_torch.models import dense_slam
    from denseslam_tpu_torch.ops import stereo
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    m = tsdf_ops.make_map(cfg.tsdf, device=dev)
    db = dense_slam.make_fusion_db(cfg, device=dev)
    torch.cuda.synchronize()
    depths = []
    for c in range(N_CHUNKS):
        if c == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        d = torch.stack([
            stereo.compute_depth(run["lefts"][i], run["rights"][i], cfg.rig,
                                 cfg.stereo)[0]
            for i in range(sl.start, sl.stop)])
        m, db = dense_slam.fuse_sequence(m, db, d, run["lefts"][sl],
                                         run["T"][sl], run["fids"][sl], cfg)
        depths.append(d)
    torch.cuda.synchronize()
    return m, torch.cat(depths), time.perf_counter() - t0


CV_RAGGED_SHAPES = ((7, 37, 16), (33, 130, 64), (5, 300, 256), (260, 45, 8))
# (H, W, D, radius) at the edges of kernel CV's tiles (32-column strips of
# 16 disparities, a halo of the blocks that hold x - r - 1 and x + r): a
# width off the strip, a last strip narrower than the halo, an image
# narrower than the window, D off the chunk, r = 0, r = 7 and r = 31 (two
# halo blocks a side), a 4096-wide line and a 4096-tall column (the
# longest lines, two levels of block totals)
CV_EDGE_SHAPES = ((21, 100, 16, 3), (19, 67, 16, 3), (9, 5, 4, 7),
                  (18, 90, 40, 3), (23, 77, 24, 0), (40, 150, 32, 7),
                  (70, 300, 8, 31), (4, 4096, 32, 3), (4096, 20, 8, 3))


def cost_volume_cumsum(left, right, sc):
    """The cost volume as the port computed it before kernel CV: box
    filters by `torch.cumsum` (not XLA's order), `/ area`; timed beside
    the kernel, used nowhere in the port."""
    h, w = left.shape
    r, nd = sc.patch_radius, sc.max_disparity
    area = (2 * r + 1) ** 2

    def box_along(x, dim):
        n = x.shape[dim]
        c = torch.cumsum(x, dim=dim)
        upper = torch.cat([c] + [c.narrow(dim, n - 1, 1)] * r,
                          dim=dim).narrow(dim, r, n)
        zshape = list(c.shape)
        zshape[dim] = r + 1
        lower = torch.cat([c.new_zeros(zshape), c], dim=dim).narrow(dim, 0, n)
        return upper - lower

    def box(x):
        return box_along(box_along(x, -1), -2)

    lm = left - box(left) / area
    rm = right - box(right) / area
    shifted = rm.new_zeros((nd, h, w))
    for d in range(min(nd, w)):
        shifted[d, :, d:] = rm[:, :w - d]
    c = box(torch.abs(lm[None] - shifted)) / area
    invalid = (torch.arange(w, device=left.device)[None, None, :]
               < torch.arange(nd, device=left.device)[:, None, None])
    return c.masked_fill(invalid, 1e4).permute(1, 2, 0).contiguous()


def cv_launch_split(fn, reps: int = 20) -> dict:
    """Device ms per call of kernel CV's launches, from torch.profiler over
    `reps` calls of `fn`: the images' four (their row and column carries
    and windows), the volume's carries, the volume's fused pass."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = dict(images=0.0, carries=0.0, fused=0.0)
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if "cv_lines" in e.key or "cv_carries<false" in e.key:
            split["images"] += us / 1e3 / reps
        elif "cv_carries" in e.key:
            split["carries"] += us / 1e3 / reps
        elif "cv_fused" in e.key:
            split["fused"] += us / 1e3 / reps
    return split


def check_cost_volume(cfg, dev, gpu):
    """Kernel CV against its plain version on the card, bit for bit: the
    street's frame 0 at 370x1226x128 in f32 and bf16, random pairs at
    CV_RAGGED_SHAPES (lengths not multiples of 16; W = 300 and H = 260
    take two levels of block totals) and at CV_EDGE_SHAPES (the tiles'
    edges, other radii) in both dtypes. Times of the kernel in the main
    path's cost dtype, its launches one by one, its plain version and the
    torch.cumsum volume it replaced."""
    from denseslam_tpu_torch.io import synthetic
    from denseslam_tpu_torch.ops import stereo

    sc = cfg.stereo
    pose = synthetic.make_trajectory(1)
    left, right, _ = synthetic.render_stereo_trajectory(
        pose, cfg.rig, synthetic.street_scene(), device=dev)
    left, right = left[0].contiguous(), right[0].contiguous()
    gen = torch.Generator().manual_seed(13)
    cases = [((left, right), sc)]
    shapes = [(h, w, d, sc.patch_radius) for h, w, d in CV_RAGGED_SHAPES]
    for h, w, d, r in shapes + list(CV_EDGE_SHAPES):
        pair = [(torch.rand((h, w), generator=gen) * 255.0).to(dev)
                for _ in range(2)]
        cases.append((pair, dataclasses.replace(sc, max_disparity=d,
                                                patch_radius=r)))
    err = 0.0
    for (lt, rt), scc in cases:
        for dtype in (torch.float32, torch.bfloat16):
            got = stereo.cost_volume(lt, rt, scc, dtype)
            want = stereo.cost_volume_plain(lt, rt, scc, dtype)
            err = max(err, float((got.float() - want.float()).abs().max()))
            if got.dtype != dtype or not torch.equal(got, want):
                raise AssertionError(
                    f"cost_volume {tuple(want.shape)} radius "
                    f"{scc.patch_radius} {dtype} differs from plain")
    torch.cuda.synchronize()
    wdt = torch.bfloat16 if sc.cost_dtype == "bfloat16" else torch.float32
    ms = cuda_ms(lambda: stereo.cost_volume(left, right, sc, wdt), 20)
    ms_f32 = cuda_ms(lambda: stereo.cost_volume(left, right, sc), 20)
    split = cv_launch_split(lambda: stereo.cost_volume(left, right, sc, wdt))
    split_f32 = cv_launch_split(lambda: stereo.cost_volume(left, right, sc))
    wrapper_us = host_us(lambda: stereo.cost_volume(left, right, sc, wdt), 20)
    plain_ms = cuda_ms(lambda: stereo.cost_volume_plain(left, right, sc, wdt),
                       2, warm=1)
    cumsum_ms = cuda_ms(lambda: cost_volume_cumsum(left, right, sc).to(wdt),
                        5, warm=1)
    h, w = left.shape
    n = h * w * sc.max_disparity
    # per output element: the difference and its absolute value; per box
    # pass the block add, the carry add and the window subtraction; the
    # multiply by 1 / area and the invalid select
    bnd, by = bound_ms(2 * h * w * 4 + n * torch.finfo(wdt).bits // 8,
                       10 * n)
    bnd_f32 = bound_ms(2 * h * w * 4 + n * 4, 10 * n)[0]
    rec = dict(name="cost_volume", route="cuda",
               source="denseslam_tpu_torch/csrc/cost_volume.cu",
               replaces="denseslam_tpu/ops/stereo.py:61 (jitted XLA "
                        "cost_volume; no Pallas kernel)",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
               bound_by=by, library_ms=None)
    emit(dict(phase="kernel", name=rec["name"], shape=[h, w,
                                                      sc.max_disparity],
              dtype=str(wdt), exact_f32_bf16=True,
              ragged_shapes=[list(x) for x in CV_RAGGED_SHAPES],
              edge_shapes=[list(x) for x in CV_EDGE_SHAPES],
              kernel_ms=ms, launch_split_ms=split, kernel_f32_ms=ms_f32,
              launch_split_f32_ms=split_f32, bound_f32_ms=bnd_f32,
              plain_ms=plain_ms, cumsum_version_ms=cumsum_ms,
              library_ms=None, bound_ms=bnd, bound_by=by,
              wrapper_host_us=wrapper_us, gpu=gpu))
    return rec


def run_slice(cfg, dev):
    """The main path: 40 street frames through stereo + fusion, with the
    launch counts set to 0 just before and read just after."""
    from denseslam_tpu_torch import kernels
    from denseslam_tpu_torch.eval import depth_metrics
    from denseslam_tpu_torch.io import synthetic
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    n = CHUNK * N_CHUNKS
    poses = synthetic.make_trajectory(n, step_m=0.4, yaw_rate=0.003)
    lefts, rights, gts = synthetic.render_stereo_trajectory(
        poses, cfg.rig, synthetic.street_scene(), device=dev)
    run = dict(lefts=lefts, rights=rights,
               T=torch.as_tensor(poses, device=dev),
               fids=torch.arange(n, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()

    kernels.reset_counts()
    m, depth, _ = drive(cfg, dev, run)
    launches = dict(kernels.launch_counts)

    overflow = int(m.overflow)
    blocks = int(tsdf_ops.num_allocated_blocks(m))
    if overflow != 0:
        raise AssertionError(f"map overflow {overflow}")
    if blocks <= 0:
        raise AssertionError("no blocks allocated")
    # per frame: B3 for three directions, the fused tail for the fourth
    # and the WTA maps, B1 for the fusion
    want = dict(tile_sample=n, tile_sample_rgb=0, sgm_path=3 * n, sgm_final=n,
                cost_volume=n)
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    dn = depth.cpu().numpy()
    if dn.shape != tuple(gts.shape) or not np.isfinite(dn).all():
        raise AssertionError("depth has the wrong shape or non-finite values")
    if not torch.isfinite(m.tsdf.float()).all():
        raise AssertionError("non-finite tsdf")
    q = depth_metrics.depth_metrics(dn, gts.cpu().numpy())
    if not (q["d1_25"] > 0.8 and q["coverage"] > 0.3):
        raise AssertionError(f"SGM depth off the rendered depth: {q}")
    emit(dict(phase="slice", frames=n, blocks=blocks, overflow=overflow,
              decayed_blocks=int(m.decayed_blocks), launches=launches,
              absrel=q["absrel"], d1_25=q["d1_25"], mae_m=q["mae"],
              coverage=q["coverage"]))
    return dict(run, depth=depth, launches=launches)


SHARDED_RANKS = 4


def sharded_rank(mesh, path: str, cfg, device: str, exact_frames: int
                 ) -> dict:
    """One rank of the sharded phase: the slice's frames (saved at `path`)
    fused into this rank's shard of the map of `cfg`, B1's launches
    counted around exactly those fuses. After `exact_frames` frames and
    after all of them the shards are gathered, and rank 0 holds the
    gather against the single-chip map of the same frames (fuse_sequence,
    which it fuses itself). Then the dry run."""
    from denseslam_tpu_torch import kernels
    from denseslam_tpu_torch.models import dense_slam
    from denseslam_tpu_torch.ops import hash as vhash
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops
    from denseslam_tpu_torch.parallel.sharded_map import ShardedTsdf
    from denseslam_tpu_torch.tools.dryrun_multichip import dryrun

    if mesh.device != torch.device(device) or mesh.size != SHARDED_RANKS:
        raise AssertionError(f"rank on {mesh.device} of {mesh.size}")
    data = torch.load(path, map_location=mesh.device, weights_only=False)
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else (lambda: None))
    st = ShardedTsdf(cfg, mesh)
    m = st.make_map()
    n = data["depth"].shape[0]
    if mesh.rank == 0:
        m1 = tsdf_ops.make_map(cfg.tsdf, mesh.device)
        db1 = dense_slam.make_fusion_db(cfg, mesh.device)
    launches = {k: 0 for k in kernels.launch_counts}
    fuse_s, vs = 0.0, []
    for lo, hi in ((0, exact_frames), (exact_frames, n)):
        sync()
        mesh.barrier()
        kernels.reset_counts()
        t0 = time.perf_counter()
        for i in range(lo, hi):
            m = st.fuse(m, data["depth"][i], data["gray"][i], data["T"][i])
        blocks = st.num_blocks(m)
        sync()
        fuse_s += time.perf_counter() - t0
        for k, v in kernels.launch_counts.items():
            launches[k] += v
        g = st.gather_to_single(m, as_numpy=True)
        if mesh.rank == 0:
            sl = slice(lo, hi)
            m1, db1 = dense_slam.fuse_sequence(
                m1, db1, data["depth"][sl], data["gray"][sl], data["T"][sl],
                data["fids"][sl], cfg)
            vs.append(compare_by_key(
                g, dense_slam.copy_map(m1, torch.device("cpu")),
                cfg.tsdf.probe_len))
    local = int((m.table.keys != vhash.EMPTY_KEY).sum())
    return dict(rank=mesh.rank, launches=launches, fuse_s=fuse_s,
                blocks=blocks, local_blocks=local, overflow=int(m.overflow),
                decayed=int(m.decayed_blocks), vs_single=vs,
                single_decayed=(int(m1.decayed_blocks) if mesh.rank == 0
                                else None),
                dryrun=dryrun(mesh))


def compare_by_key(a, b, probe_len: int) -> dict:
    """Two maps (host tensors) block by block, as a lookup reads them:
    each key's first block in probe order. Counts the keys only one map
    holds, the keys a map holds twice (the inherited hash defect: a block
    that decay frees leaves a hole in a probe chain, and a later insert of
    a key further along the chain claims the hole, so the key is held
    twice and only the first block is found; denseslam_tpu/ops/hash.py
    insert_keys), and the shared keys whose blocks differ in tsdf, weight
    or colour, apart and among the keys that are held twice."""
    from denseslam_tpu_torch.ops import hash as vhash

    def live(m):
        k = m.table.keys
        k = k[k != vhash.EMPTY_KEY]
        keys = torch.unique(k)
        slots = vhash.lookup_keys(m.table, keys, probe_len).long()
        held = torch.bincount(torch.searchsorted(keys, k),
                              minlength=keys.numel())
        return keys, slots, held > 1

    ka, sa, da = live(a)
    kb, sb, db = live(b)
    ina = torch.isin(ka, kb)
    inb = torch.isin(kb, ka)
    ra, rb = sa[ina], sb[inb]
    differ = torch.zeros(int(ina.sum()), dtype=torch.bool)
    for x, y in ((a.tsdf, b.tsdf), (a.weight, b.weight), (a.color, b.color)):
        differ |= (x[ra] != y[rb]).any(dim=-1)
    twice = da[ina] | db[inb]
    return dict(keys_a=int(ka.numel()), keys_b=int(kb.numel()),
                only_a=int((~ina).sum()), only_b=int((~inb).sum()),
                held_twice_a=int(da.sum()), held_twice_b=int(db.sum()),
                blocks_differ=int(differ.sum()),
                blocks_differ_held_twice=int((differ & twice).sum()))


SHARDED_EXACT_FRAMES = 30     # the slice's decay age gate opens after these


def run_sharded(dev, gpu, run, cfg=None, device: str = "cuda:0",
                exact_frames: int = SHARDED_EXACT_FRAMES):
    """Phase `sharded` (see the module docstring): SHARDED_RANKS spawned
    ranks sharing cuda:0 over gloo. Gates: every rank on cuda:0 launched
    B1 once per frame and no other kernel, overflow 0, every rank owns
    blocks, the dry run's own checks and its map-side facts alike on all
    ranks; the gathered map equal to the single-chip map block for block
    over the first `exact_frames` frames, before decay frees a block; over
    the whole run (the inherited hash defect of `compare_by_key` makes the
    two differ after decay) every differing block is at a key held twice,
    the keys held by one map only are no more than those held twice, and
    every rank counts the same decayed blocks. These are what this
    deterministic drive has shown at full width, not laws: a stale copy of
    a key held twice decays on its own, and at 160x120 on the CPU some
    blocks differ at keys held once by the end."""
    from denseslam_tpu_torch.models import dense_slam
    from denseslam_tpu_torch.parallel import launch
    from denseslam_tpu_torch.tools.dryrun_multichip import (
        summary as dryrun_summary)

    cfg = cfg or slice_config()
    n = run["depth"].shape[0]
    db = dense_slam.make_fusion_db(cfg, device=dev)
    path = os.path.join(ROOT, "build", "sharded_frames.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(dict(depth=dense_slam.db_quantize_depth(db, run["depth"]),
                    gray=run["lefts"], T=run["T"], fids=run["fids"]), path)
    t0 = time.perf_counter()
    ranks = launch.run_local(sharded_rank, SHARDED_RANKS, path, cfg, device,
                             exact_frames, backend="gloo", device=device)
    wall = time.perf_counter() - t0
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    fuse_s = max(r["fuse_s"] for r in ranks)
    exact, whole = ranks[0]["vs_single"]
    dry = ranks[0]["dryrun"]
    emit(dict(phase="sharded", ranks=SHARDED_RANKS,
              layout="4 ranks share cuda:0 over gloo; gloo's collectives "
              "staged through the host (parallel/mesh.py)",
              frames=n, launches=launches,
              launches_by_rank=[r["launches"]["tile_sample"] for r in ranks],
              blocks=ranks[0]["blocks"],
              local_blocks=[r["local_blocks"] for r in ranks],
              overflow=ranks[0]["overflow"], decayed=ranks[0]["decayed"],
              single_decayed=ranks[0]["single_decayed"],
              vs_single_first=dict(frames=exact_frames, **exact),
              vs_single_all=dict(frames=n, **whole),
              fused_fps=n / fuse_s, fuse_s=fuse_s, wall_s=wall, dryrun=dry,
              dryrun_line=dryrun_summary(dry),
              vo_err_by_rank=[r["dryrun"]["vo_err"] for r in ranks],
              gpu=gpu))
    same = {k: v for k, v in dry.items() if k != "vo_err"}
    gates = dict(
        b1=all(r["launches"]["tile_sample"] == n for r in ranks),
        other_kernels=all(v == 0 for k, v in launches.items()
                          if k != "tile_sample"),
        overflow=all(r["overflow"] == 0 for r in ranks),
        every_rank_owns=all(r["local_blocks"] > 0 for r in ranks),
        exact=(exact["only_a"] == exact["only_b"] == exact["blocks_differ"]
               == exact["held_twice_a"] == exact["held_twice_b"] == 0
               and exact["keys_a"] > 0),
        keys_all=whole["keys_a"] > 0,
        # after decay, as every full-width run of this drive has shown: the
        # blocks that differ are all at keys held twice, and keys held by
        # one map only are fewer than the keys held twice (the inherited
        # hash defect; that the shards part from the single map only as
        # JAX's do is tests/test_torch_parallel.py's decay drive)
        differ_only_held_twice=(whole["blocks_differ"]
                                == whole["blocks_differ_held_twice"]),
        one_sided_keys=(max(whole["only_a"], whole["only_b"])
                        <= min(whole["held_twice_a"], whole["held_twice_b"])),
        decayed=ranks[0]["decayed"] > 0,
        decayed_alike=all(r["decayed"] == ranks[0]["decayed"]
                          for r in ranks),
        # what every rank must hold alike (the VO is each rank's own)
        replicated=all({k: v for k, v in r["dryrun"].items()
                        if k != "vo_err"} == same for r in ranks))
    if not all(gates.values()):
        raise AssertionError(f"sharded gates failed: {gates}")
    return dict(launches=launches)


def check_against_cpu(cfg, dev, run):
    """Frame 0's stereo and frames 0-1's fusion rerun on the CPU (the plain
    versions) and held against the card."""
    from denseslam_tpu_torch.models import dense_slam
    from denseslam_tpu_torch.ops import stereo
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    cpu = torch.device("cpu")
    dg = run["depth"][0].cpu().numpy()
    dc, _ = stereo.compute_depth(run["lefts"][0].cpu(), run["rights"][0].cpu(),
                                 cfg.rig, cfg.stereo)
    dc = dc.numpy()
    # the box-filter cumsums add in another order on the two devices, which
    # can flip a near-tie of the WTA (the CPU tests' tolerance)
    agree = float(((dg > 0) == (dc > 0)).mean())
    both = (dg > 0) & (dc > 0)
    close = float((np.abs(dg[both] - dc[both]) <= 1e-3 * dc[both]).mean())
    if agree < 0.99 or close < 0.99:
        raise AssertionError(f"stereo card vs CPU: valid {agree}, close {close}")

    maps = []
    for d in (dev, cpu):
        m = tsdf_ops.make_map(cfg.tsdf, device=d)
        db = dense_slam.make_fusion_db(cfg, device=d)
        m, db = dense_slam.fuse_sequence(
            m, db, run["depth"][:2].to(d), run["lefts"][:2].to(d),
            run["T"][:2].to(d), run["fids"][:2].to(d), cfg)
        maps.append(m)
    mg, mc = maps
    if not torch.equal(mg.table.keys.cpu(), mc.table.keys):
        raise AssertionError("hash tables differ between card and CPU")
    if not torch.equal(mg.weight.cpu(), mc.weight):
        raise AssertionError("weights differ between card and CPU")
    tg, tcp = mg.tsdf.cpu().float(), mc.tsdf.float()
    tsdf_err = float((tg - tcp).abs().max())
    tsdf_frac = float((tg != tcp).float().mean())
    if tsdf_err > 2 ** -7 or tsdf_frac > 1e-3:
        raise AssertionError(f"tsdf card vs CPU: {tsdf_err}, {tsdf_frac}")

    # frame 1's fusion intermediates on both devices, from the card's map
    # after frame 0: which op, if any, first differs
    m0 = tsdf_ops.make_map(cfg.tsdf, device=dev)
    db0 = dense_slam.make_fusion_db(cfg, device=dev)
    m0, _ = dense_slam.fuse_keyframe(m0, db0, run["depth"][0], run["lefts"][0],
                                     run["T"][0], 0, cfg)
    inter = [fusion_intermediates(cfg, dense_slam.copy_map(m0, d),
                                  run["depth"][1].to(d),
                                  run["lefts"][1].to(d), run["T"][1].to(d))
             for d in (dev, cpu)]
    differ = {}
    for key in inter[0]:
        a, b = inter[0][key].cpu(), inter[1][key]
        diff = a != b
        differ[key] = dict(frac=float(diff.float().mean()),
                           max_abs=float((a.double() - b.double()).abs().max()))
    emit(dict(phase="cpu_reference", stereo_valid_agree=agree,
              stereo_depth_close=close, tables_equal=True,
              weights_equal=True, tsdf_max_abs_err=tsdf_err,
              tsdf_frac_differ=tsdf_frac, frame1_intermediates=differ))


def fusion_intermediates(cfg, m, depth, gray, T):
    """The intermediate values of ops/tsdf.py `integrate` for one frame
    fused into map `m` (changed in place), as fuse_keyframe computes them,
    plus eta with the truncation distance divided as a Python number."""
    from denseslam_tpu_torch.models import dense_slam
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops
    from denseslam_tpu_torch.utils.numerics import true_div
    intr, tc = cfg.rig.intr, cfg.tsdf
    depth = dense_slam._depth_mm(depth).to(torch.float32) * 1e-3
    color = tsdf_ops.pack_gray(gray)
    m, slots, mask = tsdf_ops.allocate_for_frame(m, depth, T, intr, tc)
    u, v, z, safe = tsdf_ops._fusion_geometry(m, slots, mask, T, intr, tc)
    d_samp, d_valid, _, _ = tsdf_ops._sample(u, v, z, mask, depth, color,
                                             intr, tc, m)
    sdf = d_samp - z
    out = dict(slots=slots, u=u, v=v, z=z, d_samp=d_samp, sdf=sdf,
               eta=true_div(sdf, tc.trunc_dist_m),
               eta_python_divisor=sdf / tc.trunc_dist_m)
    m = tsdf_ops.integrate(m, slots, mask, depth, color, T, intr, tc)
    rows = safe.long()
    out.update(weight=m.weight[rows].float(), tsdf=m.tsdf[rows].float())
    return out


class TickCapture:
    """Records, for the first backend tick of a SLAMSystem that runs local
    BA without a reject and re-fuses keyframes, the state it read (the
    backend's registry; map and DB cloned on the card), the pose updates
    it applied with the map and DB just before and just after, and the
    backend after it. Installed on the system's `_chunk_tick` and
    `slam.apply_pose_updates`; `seconds` is the copying time."""

    def __init__(self, system):
        self.system = system
        self.pre = self.apply = self.post = None
        self.seconds = 0.0
        self._tick = system._chunk_tick
        self._apply = system.slam.apply_pose_updates
        system._chunk_tick = self._tick_hook
        system.slam.apply_pose_updates = self._apply_hook

    def _snapshot(self, with_map: bool):
        import copy

        from denseslam_tpu_torch.models.dense_slam import copy_db, copy_map
        t0 = time.perf_counter()
        sy = self.system
        be = copy.copy(sy.backend)
        be.keyframes = list(be.keyframes)
        be.odom_edges, be.loop_edges = list(be.odom_edges), list(be.loop_edges)
        be._sig_valid = be._sig_valid.copy()
        be._sig_slot, be._sig_free = dict(be._sig_slot), list(be._sig_free)
        snap = dict(backend=be, tick_count=sy._tick_count,
                    num_corrections=sy.num_corrections,
                    num_culled=sy.num_culled)
        if with_map:
            snap.update(map=copy_map(sy.slam.submaps.active, sy.device),
                        db=copy_db(sy.slam.db, sy.device))
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        return snap

    def _apply_hook(self, ids, poses, enforce_budget=True):
        if self.post is not None:
            return self._apply(ids, poses, enforce_budget)
        before = self._snapshot(True)
        n = self._apply(ids, poses, enforce_budget)
        after = self._snapshot(True)
        self._applied = dict(ids=np.array(ids), poses=np.array(poses),
                             refused=n, before=before, after=after)
        return n

    def _tick_hook(self):
        if self.post is not None:
            return self._tick()
        sy = self.system
        pre = self._snapshot(False)
        rejects = sy.backend.ba_rejects
        self._applied = None
        self._tick()
        a = self._applied
        if (a is not None and a["refused"] > 0
                and sy.backend.ba_rejects == rejects):
            self.pre, self.apply, self.post = pre, a, self._snapshot(False)


def count_purges(system):
    """Wrap the system's purge_keyframes to count the DB entries it drops;
    returns the one-element list that holds the count."""
    purge = system.slam.purge_keyframes
    purged = [0]

    def counted_purge(ids):
        before = int(system.slam.db.valid.sum())
        purge(ids)
        purged[0] += before - int(system.slam.db.valid.sum())

    system.slam.purge_keyframes = counted_purge
    return purged


def run_system(cfg, dev, gpu):
    """The whole system: the flagship drive, 576 frames in 9 chunks of 64,
    through SLAMSystem.process_chunk and finish() on the card, with the
    launch counts set to 0 just before and read just after, and the
    drive's depth evaluation every 25th fused keyframe (eval_renders).
    Frames/s counts process_chunk's time from chunk 2 on, as
    scripts/long_drive_eval.py:296-298 does (less the tick capture's
    copies); the eval renders stay out of it, as there."""
    from denseslam_tpu_torch.tools.long_drive_eval import (drive_system,
                                                           mean_metrics,
                                                           system_chunk,
                                                           system_setup)
    from denseslam_tpu_torch import kernels
    from denseslam_tpu_torch.eval import traj_metrics
    from denseslam_tpu_torch.models.system import SLAMSystem

    gt, scene = system_setup(SYSTEM_LOOP_FRAMES)
    system = SLAMSystem(cfg, ba_every=4, loop_every=2, device=dev)
    cap = TickCapture(system)
    purged = count_purges(system)
    kernels.reset_counts()
    d = drive_system(cfg, dev, system, gt, scene, system.slam.raycast_view,
                     cap=cap, frames=SYSTEM_FRAMES, eval_every=EVAL_EVERY,
                     make_chunk=cached(system_chunk))
    launches = dict(kernels.launch_counts)
    ok_frames, evals, eval_ids = d["ok_frames"], d["evals"], d["eval_ids"]
    proc_s, proc_frames = d["proc_s"], d["proc_frames"]
    wall_s, synth_s, eval_s = d["wall_s"], d["synth_s"], d["eval_s"]

    be = system.backend
    fused = be.num_keyframes + system.num_culled
    refused = system.num_corrections
    # the eval's SGM depth launches B3 three times and the tail once too
    n_eval = len(evals)
    want = dict(tile_sample=fused + 2 * refused + purged[0],
                tile_sample_rgb=0, sgm_path=3 * (fused + n_eval),
                sgm_final=fused + n_eval,
                cost_volume=fused + n_eval)
    if fused == 0 or launches != want:
        raise AssertionError(f"launches {launches}, want {want} ({fused} "
                             f"fused, {refused} re-fused, {purged[0]} "
                             f"purged, {n_eval} eval SGMs)")
    depth_q = {k: mean_metrics(evals, k)
               for k in ("depth", "depth_gtpose", "depth_input")}
    ok = np.concatenate(ok_frames)
    track = float(ok[1:].mean())
    est = [T for _, T in system.trajectory()]
    if len(est) != SYSTEM_FRAMES or not np.isfinite(np.stack(est)).all():
        raise AssertionError("trajectory has the wrong length or "
                             "non-finite poses")
    ate = traj_metrics.ate_rmse(est, list(gt))
    kitti = traj_metrics.kitti_sequence_errors(est, list(gt))
    overflow = int(system.slam.submaps.active.overflow)
    emit(dict(phase="system", frames=SYSTEM_FRAMES, chunk=SYSTEM_CHUNK,
              fused=fused, refused=refused, purged=purged[0],
              launches=launches, overflow=overflow, tracking_ok_share=track,
              loops=system.num_loops, corrections=refused,
              culled=system.num_culled, relocs=system.num_relocs,
              keyframes=be.num_keyframes, ba_rejects=be.ba_rejects,
              pg_rejects=be.pg_rejects, ate_rmse_m=ate,
              jax_record_ate_m=jax_record_ate("results_long_drive.json"),
              end_error_m=float(np.linalg.norm(est[-1][:3, 3]
                                               - gt[-1][:3, 3])),
              kitti_t_err_pct=kitti["kitti_t_err_pct"],
              kitti_r_err_deg_per_m=kitti["kitti_r_err_deg_per_m"],
              loops_accepted=[lg for lg in be.loop_log
                              if lg["accepted"] is not None],
              loop_log_last=be.loop_log[-4:],
              cull_margin_max=max(be.cull_margins, default=None),
              fps=proc_frames / proc_s, fps_frames=proc_frames,
              process_s=proc_s, wall_s=wall_s, synth_s=synth_s,
              capture_s=cap.seconds, eval_s=eval_s, eval_frames=eval_ids,
              **depth_q,
              phase_s={**system.phase_s, **be.phase_s},
              memory_mb=system.memory_bytes() / 1e6,
              blocks=int(system.slam.submaps.active.table.valid.sum()),
              gpu=gpu))
    gates = dict(tracking=track >= 0.95, loop=system.num_loops >= 1,
                 refused=refused >= 1, overflow=overflow == 0,
                 ate=ate <= 1.0, tick_captured=cap.post is not None,
                 eval_coverage=depth_q["depth"]["coverage"] >= 0.3,
                 eval_d1_25=depth_q["depth"]["d1_25"] >= 0.85)
    if not all(gates.values()):
        raise AssertionError(f"system gates failed: {gates}")
    return dict(launches=launches, capture=cap, system=system)


def check_system_against_cpu(cfg, cap):
    """The captured tick rerun on the CPU from the card's state before it,
    with the same verification draws: the keyframe poses after it (loop
    relaxation and local BA) within 1 mm / 1e-4 rad of the card's, the same
    culls; and the CPU's online correction, given the card's optimised
    poses and the card's map and DB just before them, re-fuses as many
    keyframes and gives the card's keys and weights, tsdf within 1e-6.
    Also printed: how much of the window's observation mask the two
    devices build alike, and the card's window problem solved on both."""
    from denseslam_tpu_torch.io import convert
    from denseslam_tpu_torch.models.dense_slam import (DenseSLAM, copy_db,
                                                       copy_map)
    from denseslam_tpu_torch.models.system import SLAMSystem
    from denseslam_tpu_torch.ops import ba

    def pba_to(p, device):
        return ba.BAProblem(*(t.to(device) for t in p))

    cpu = torch.device("cpu")
    sy = SLAMSystem(cfg, ba_every=4, loop_every=2, device=cpu)
    convert.backend_state_from_numpy(
        convert.backend_state_to_numpy(cap.pre["backend"]), sy.backend)
    sy._tick_count = cap.pre["tick_count"]
    # where the two ticks part: the window's BA problem built on each
    # device from the same state, and the card's problem solved on both
    pg, _ = cap.pre["backend"].window_problem()
    pc, _ = sy.backend.window_problem()
    mask_equal = float((pg.obs_mask.cpu() == pc.obs_mask).float().mean())
    bg = ba.solve(pg, cfg.rig, cfg.backend).T_wc
    bc = ba.solve(pba_to(pg, cpu), cfg.rig, cfg.backend).T_wc
    solve_t, solve_r = pose_errors(bg, bc, "BA solve of one problem")
    before = cap.apply["before"]
    # the map the tick starts from: its correction replays from the DB
    sy.slam.submaps.active = copy_map(before["map"], cpu)
    sy.slam.db = copy_db(before["db"], cpu)
    t0 = time.perf_counter()
    sy._chunk_tick()
    tick_s = time.perf_counter() - t0
    card = cap.post["backend"]
    ids_c = [k.frame_id for k in card.keyframes]
    ids_h = [k.frame_id for k in sy.backend.keyframes]
    if ids_c != ids_h:
        raise AssertionError("card and CPU keep different keyframes")
    t_err, r_err = pose_errors(
        torch.as_tensor(np.stack([k.T_wc for k in card.keyframes])),
        torch.as_tensor(np.stack([k.T_wc for k in sy.backend.keyframes])),
        "backend tick")
    culled_c = cap.post["num_culled"] - cap.pre["num_culled"]
    if sy.num_culled != culled_c:
        raise AssertionError(f"culled {sy.num_culled} on the CPU, "
                             f"{culled_c} on the card")

    slam = DenseSLAM(cfg, device=cpu)
    slam.submaps.active = copy_map(before["map"], cpu)
    slam.db = copy_db(before["db"], cpu)
    t0 = time.perf_counter()
    n = slam.apply_pose_updates(cap.apply["ids"], cap.apply["poses"],
                                enforce_budget=False)
    apply_s = time.perf_counter() - t0
    if n != cap.apply["refused"]:
        raise AssertionError(f"re-fused {n} on the CPU, "
                             f"{cap.apply['refused']} on the card")
    mg, mc = cap.apply["after"]["map"], slam.submaps.active
    if not torch.equal(mg.table.keys.cpu(), mc.table.keys):
        raise AssertionError("hash tables differ between card and CPU")
    if not torch.equal(mg.weight.cpu(), mc.weight):
        raise AssertionError("weights differ between card and CPU")
    tg = mg.tsdf.cpu()
    tsdf_err = float((tg - mc.tsdf).abs().max())
    if tsdf_err > 1e-6:
        raise AssertionError(f"tsdf card vs CPU: {tsdf_err}")
    if not torch.equal(cap.apply["after"]["db"].T_fused.cpu(), slam.db.T_fused):
        raise AssertionError("corrected DB poses differ between card and CPU")
    emit(dict(phase="system_cpu_reference", tick=cap.pre["tick_count"] + 1,
              keyframes=len(ids_h), culled=sy.num_culled, refused=n,
              cpu_refused_own_poses=sy.num_corrections,
              pose_err_m=t_err, pose_err_rad=r_err,
              window_obs_mask_equal_share=mask_equal,
              one_problem_solve_err_m=solve_t,
              one_problem_solve_err_rad=solve_r, tables_equal=True,
              weights_equal=True,
              colours_equal=bool(torch.equal(mg.color.cpu(), mc.color)),
              tsdf_max_abs_err=tsdf_err,
              tsdf_frac_differ=float((tg != mc.tsdf).float().mean()),
              cpu_tick_s=tick_s, cpu_apply_s=apply_s))


def submaps_config(cfg):
    """The drive's configuration with scripts/long_drive_eval.py's
    --submap-threshold 0.3 --map-budget-mb 400."""
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, new_submap_threshold=SUBMAP_THRESHOLD,
        map_memory_budget_mb=SUBMAP_BUDGET_MB))


def allocated_now(dev) -> int:
    """torch.cuda.memory_allocated once the card is idle; a one-element
    allocation first lets the caching allocator free blocks whose side-
    stream uses (record_stream) have completed."""
    torch.cuda.synchronize()
    torch.empty(1, device=dev)
    return torch.cuda.memory_allocated(dev)


def check_memory_freed(sm, idx: int, dev) -> dict:
    """Restore spilled submap `idx` and evict it again, synchronized on
    both sides, once with evict_to_host (a clean restore: the free path)
    and once, after mark_dirty, with evict_to_host_async and
    finalize_spills: each time the card's allocated bytes must rise, then
    fall, by >= 0.9 x the submap's submap_device_bytes."""
    out = {}
    for kind in ("sync", "async"):
        a0 = allocated_now(dev)
        sm.restore_to_device(idx)
        a1 = allocated_now(dev)
        nbytes = sm.submap_device_bytes(idx)
        if kind == "sync":
            sm.evict_to_host(idx)
        else:
            sm.mark_dirty(idx)
            if not sm.evict_to_host_async(idx):
                raise AssertionError(f"submap {idx}: no async spill started")
            sm.finalize_spills()
        a2 = allocated_now(dev)
        out[kind] = dict(submap_bytes=nbytes, rise=a1 - a0, fall=a1 - a2)
        if not (sm.is_on_host(idx) and a1 - a0 >= 0.9 * nbytes
                and a1 - a2 >= 0.9 * nbytes):
            raise AssertionError(f"submap {idx} {kind} spill: {out[kind]}")
    return out


def run_submaps(cfg, dev, gpu, ref):
    """The flagship drive again (drive_system: the same frames, noise and
    draws as `system`) with submaps and swapping on (submaps_config): the
    eval renders the composite (raycast_composite(respill=False,
    ghost=True) once there is more than one submap) and re-enforces the
    budget after each eval burst, as scripts/long_drive_eval.py:444-493
    does; the launch counts set to 0 just before and read just after.
    `ref` is the `system` phase's SLAMSystem: every pose must be within
    1e-4 m of its pose for the same frame (the submaps leave the
    trajectory alone). Then check_memory_freed on a spilled submap."""
    from denseslam_tpu_torch.tools.long_drive_eval import (drive_system,
                                                           mean_metrics,
                                                           system_chunk,
                                                           system_setup)
    from denseslam_tpu_torch import kernels
    from denseslam_tpu_torch.eval import traj_metrics
    from denseslam_tpu_torch.models.system import SLAMSystem

    scfg = submaps_config(cfg)
    gt, scene = system_setup(SYSTEM_LOOP_FRAMES)
    system = SLAMSystem(scfg, ba_every=4, loop_every=2, device=dev)
    slam = system.slam
    sm = slam.submaps
    purge, restore, finalize = (slam.purge_keyframes, slam.restore_submap,
                                sm.finalize_spills)
    purged, replayed, over_budget = [0], [0], []

    def counted_purge(ids):
        before = int(slam.db.valid.sum())
        purge(ids)
        purged[0] += before - int(slam.db.valid.sum())

    def counted_restore(si, force_replay=False):
        n = restore(si, force_replay=force_replay)
        replayed[0] += n
        return n

    def checked_finalize():
        finalize()
        over_budget.append(sm.committed_memory_bytes()
                           - sm.submap_device_bytes(sm.active_idx))

    def render(T):
        if sm.num_local_maps > 1:
            return slam.raycast_composite(T, respill=False, ghost=True)
        return slam.raycast_view(T)

    def after_eval():
        if sm.num_local_maps > 1:
            sm.enforce_memory_budget()

    slam.purge_keyframes = counted_purge
    slam.restore_submap = counted_restore
    sm.finalize_spills = checked_finalize
    kernels.reset_counts()
    d = drive_system(scfg, dev, system, gt, scene, render,
                     after_eval=after_eval, frames=SYSTEM_FRAMES,
                     eval_every=EVAL_EVERY, make_chunk=cached(system_chunk))
    launches = dict(kernels.launch_counts)

    be = system.backend
    fused = be.num_keyframes + system.num_culled
    refused = system.num_corrections
    n_eval = len(d["evals"])
    want = dict(tile_sample=fused + 2 * refused + purged[0]
                + 2 * replayed[0], tile_sample_rgb=0,
                sgm_path=3 * (fused + n_eval), sgm_final=fused + n_eval,
                cost_volume=fused + n_eval)
    if fused == 0 or launches != want:
        raise AssertionError(f"launches {launches}, want {want} ({fused} "
                             f"fused, {refused} re-fused, {purged[0]} "
                             f"purged, {replayed[0]} replayed, {n_eval} "
                             "eval SGMs)")
    depth_q = {k: mean_metrics(d["evals"], k)
               for k in ("depth", "depth_gtpose", "depth_input")}
    ok = np.concatenate(d["ok_frames"])
    track = float(ok[1:].mean())
    est = np.stack([T for _, T in system.trajectory()])
    ref_T = np.stack([T for _, T in ref.trajectory()])
    if est.shape != ref_T.shape or not np.isfinite(est).all():
        raise AssertionError("trajectory has the wrong length or "
                             "non-finite poses")
    pose_gap = float(np.abs(est[:, :3, 3] - ref_T[:, :3, 3]).max())
    ate = traj_metrics.ate_rmse(list(est), list(gt))
    n = sm.num_local_maps
    on_host = [sm.is_on_host(i) for i in range(n)]
    overflow = [int(m.overflow) for m in sm.maps]
    over_max = max(over_budget)
    t0 = time.perf_counter()
    freed = check_memory_freed(sm, on_host.index(True), dev) \
        if any(on_host) else None
    freed_s = time.perf_counter() - t0
    ph = {**system.phase_s, **be.phase_s}
    emit(dict(phase="submaps", frames=SYSTEM_FRAMES, chunk=SYSTEM_CHUNK,
              threshold=SUBMAP_THRESHOLD, budget_mb=SUBMAP_BUDGET_MB,
              submaps=n, on_host=on_host, anchor_frames=sm.anchor_frames,
              evictions=sm.num_evictions, restores=sm.num_restores,
              async_spills=sm.num_async_spills,
              delta_spills=sm.num_delta_spills,
              ghost_renders=sm.num_ghost_renders,
              submap_device_bytes=max(sm.submap_device_bytes(i)
                                      for i in range(n)),
              memory_report=slam.memory_report(),
              committed_minus_active_max=over_max,
              fused=fused, refused=refused, purged=purged[0],
              replayed=replayed[0], launches=launches, overflow=overflow,
              tracking_ok_share=track, loops=system.num_loops,
              culled=system.num_culled, pose_gap_to_system_m=pose_gap,
              ate_rmse_m=ate, eval_frames=d["eval_ids"], **depth_q,
              fps=d["proc_frames"] / d["proc_s"], process_s=d["proc_s"],
              wall_s=d["wall_s"], synth_s=d["synth_s"], eval_s=d["eval_s"],
              phase_s={k: ph[k] for k in ("spawn", "spill_wait",
                                          "tick_apply", "tick") if k in ph},
              memory_freed=freed, memory_freed_s=freed_s, gpu=gpu))
    gates = dict(tracking=track >= 0.95, loop=system.num_loops >= 1,
                 submaps=n >= 3, on_host=any(on_host),
                 evictions=sm.num_evictions >= 1,
                 ghosts=sm.num_ghost_renders >= 1,
                 overflow=not any(overflow), poses=pose_gap <= 1e-4,
                 eval_coverage=depth_q["depth"]["coverage"] >= 0.3,
                 eval_d1_25=depth_q["depth"]["d1_25"] >= 0.85,
                 budget=over_max <= SUBMAP_BUDGET_MB * 1e6)
    if not all(gates.values()):
        raise AssertionError(f"submaps gates failed: {gates}")
    return dict(launches=launches, system=system)


def _leaves_equal(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
               for x, y in zip(a, b))


def check_spills_exact(sm, idx: int, dev) -> dict:
    """Spilled submap `idx` restored, then spilled by each path (the sync
    compacted spill, the async one, the delta respill after a change to
    some rows named to mark_dirty) and restored again: each host copy and
    each restore bit-equal, in every plane and DB field, to the device copy
    before the spill."""
    from denseslam_tpu_torch.models.dense_slam import (_map_leaves, copy_db,
                                                       copy_map)

    def leaves(i):
        return _map_leaves(sm.maps[i]) + list(sm.dbs[i])

    out = {}
    sm.restore_to_device(idx)
    n0 = (sm.num_async_spills, sm.num_delta_spills)
    for kind in ("sync", "async", "delta"):
        if kind == "delta":
            m = sm.maps[idx]
            rows = torch.nonzero(m.table.valid).flatten()[::7]
            m.tsdf[rows] = -m.tsdf[rows]
            sm.mark_dirty(idx, changed_slots=rows.cpu().numpy())
        else:
            sm.mark_dirty(idx)
        snap = (_map_leaves(copy_map(sm.maps[idx], dev))
                + list(copy_db(sm.dbs[idx], dev)))
        if kind == "async":
            if not sm.evict_to_host_async(idx):
                raise AssertionError("the async spill did not start")
            sm.finalize_spills()
        else:
            sm.evict_to_host(idx)
        host_equal = _leaves_equal(snap, leaves(idx))
        sm.restore_to_device(idx)
        back_equal = _leaves_equal(snap, leaves(idx))
        out[kind] = dict(host_equal=host_equal, restore_equal=back_equal)
        if not (host_equal and back_equal):
            raise AssertionError(f"{kind} spill of submap {idx}: {out}")
    if (sm.num_async_spills, sm.num_delta_spills) != (n0[0] + 1, n0[1] + 1):
        raise AssertionError("the spills did not take their paths")
    sm.evict_to_host(idx)
    return out


def check_submaps_against_cpu(cfg, dev, run):
    """The submaps drive's final state carried to the CPU through
    io/convert.py and one composite render (the drive's: ghost=True,
    respill=False) made from it on both devices at the last frame's
    estimated pose: the splat z-buffer keys of every render inside it
    equal on >= 99.9% of pixels (the `render` phase's bar); then
    check_spills_exact on the card."""
    from denseslam_tpu_torch.io import convert
    from denseslam_tpu_torch.models.dense_slam import DenseSLAM
    from denseslam_tpu_torch.ops import splat

    system = run["system"]
    slam = system.slam
    scfg = slam.cfg
    T = slam.trajectory()[-1][1]
    t0 = time.perf_counter()
    cpu = DenseSLAM(scfg, device=torch.device("cpu"))
    convert.slam_state_from_numpy(
        convert.slam_state_to_numpy(slam), cpu)
    copy_s = time.perf_counter() - t0

    def keyed(s):
        keys, render = [], s._render

        def wrapped(m, T_wc):
            keys.append(splat.splat_zbuffer(m, T_wc, scfg.rig.intr,
                                            scfg.tsdf, s._splat_cfg)[0][:-1]
                        .cpu())
            return render(m, T_wc)

        s._render = wrapped
        return keys

    kg, kc = keyed(slam), keyed(cpu)
    dg = slam.raycast_composite(T, respill=False, ghost=True).depth.cpu()
    t0 = time.perf_counter()
    dc = cpu.raycast_composite(T, respill=False, ghost=True).depth
    cpu_s = time.perf_counter() - t0
    del slam._render, cpu._render
    if len(kg) != len(kc) or not kg:
        raise AssertionError(f"{len(kg)} renders on the card, {len(kc)} on "
                             "the CPU")
    equal = float(sum(int((a == b).sum()) for a, b in zip(kg, kc))
                  / sum(a.numel() for a in kg))
    depth_equal = float((dg == dc).float().mean())
    if equal < 0.999:
        raise AssertionError(f"composite splat keys card vs CPU: {equal}")
    slam.submaps.enforce_memory_budget()
    sm = slam.submaps
    idx = next(i for i in range(sm.num_local_maps) if sm.is_on_host(i))
    spills = check_spills_exact(sm, idx, torch.device(dev))
    emit(dict(phase="submaps_cpu_reference", renders=len(kg),
              splat_keys_equal_share=equal, depth_equal_share=depth_equal,
              pixels_hit=float((dg > 0).float().mean()), spills=spills,
              spill_submap=idx, copy_to_cpu_s=copy_s,
              cpu_composite_s=cpu_s))


def run_render(cfg, dev, fr, stereo, gpu, out=None):
    """Both renderers on the stereo phase's final map, at its last fused
    keyframe's estimated pose, through DenseSLAM.raycast_view at 1226x370:
    the splat renderer (the default) and the sphere-traced raycast, each
    scored against the ground-truth depth at that pose, timed behind the
    sleep kernel and profiled once (profile_part: launches, device ms,
    busy share, host syncs; the raycast only under --profile); then the
    splat z-buffer of the same map
    cloned to the CPU, whose keys must equal the card's on >= 99.9% of
    pixels."""
    from denseslam_tpu_torch.tools.long_drive_eval import (eval_floor_m,
                                                           gt_depth)
    from denseslam_tpu_torch import kernels
    from denseslam_tpu_torch.eval import depth_metrics
    from denseslam_tpu_torch.io import synthetic
    from denseslam_tpu_torch.models.dense_slam import DenseSLAM, copy_map
    from denseslam_tpu_torch.ops import splat

    m = stereo["map"]
    i = torch.nonzero(stereo["stats"]["fused"]).flatten().tolist()[-1]
    T = stereo["stats"]["T_wc"][i].clone()
    gtd = gt_depth(cfg, T, synthetic.street_scene(), dev)
    lo, hi = eval_floor_m(cfg), cfg.tsdf.max_depth_m
    rec = dict(phase="render", frame=i, shape=[cfg.rig.intr.height,
                                               cfg.rig.intr.width])
    for renderer, reps in (("splat", 20), ("raycast", 3)):
        slam = DenseSLAM(dataclasses.replace(cfg, pipeline=dataclasses.replace(
            cfg.pipeline, renderer=renderer)), device=dev)
        slam.submaps.active = m
        kernels.reset_counts()
        rc = slam.raycast_view(T)
        torch.cuda.synchronize()
        if any(kernels.launch_counts.values()):
            raise AssertionError(f"{renderer} launched {kernels.launch_counts}")
        for name, x in rc._asdict().items():
            if not torch.isfinite(x.float()).all():
                raise AssertionError(f"{renderer}: non-finite {name}")
        q = depth_metrics.depth_metrics(rc.depth.cpu().numpy(), gtd,
                                        min_depth=lo, max_depth=hi)
        if not (q["coverage"] > 0.3 and q["d1_25"] > 0.8):
            raise AssertionError(f"{renderer} depth off the scene: {q}")
        # the raycast's 55,220 launches take most of a minute of profiler
        # table processing: profiled only under --profile
        prof = {}
        if renderer == "splat" or out is not None:
            _, prof = profile_part(f"render_{renderer}", 1,
                                   lambda _: slam.raycast_view(T), None, out)
        rec[renderer] = dict(
            # warmed up by the calls above
            cuda_ms=cuda_ms(lambda: slam.raycast_view(T), reps, warm=0),
            **{k: prof.get(k, "not measured")
               for k in ("wall_ms", "device_ms", "device_busy_share",
                         "launches", "host_syncs")},
            d1_25=q["d1_25"], coverage=q["coverage"], absrel=q["absrel"],
            mae_m=q["mae"])
    sc = slam._splat_cfg
    intr = cfg.rig.intr
    keys_g = splat.splat_zbuffer(m, T, intr, cfg.tsdf, sc)[0][:-1].cpu()
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    keys_c = splat.splat_zbuffer(copy_map(m, cpu), T.cpu(), intr, cfg.tsdf,
                                 sc)[0][:-1]
    cpu_s = time.perf_counter() - t0
    equal = float((keys_g == keys_c).float().mean())
    if equal < 0.999:
        raise AssertionError(f"splat keys card vs CPU equal on {equal}")
    emit(dict(rec, splat_keys_equal_share=equal,
              pixels_hit=float((keys_g != 2 ** 31 - 1).float().mean()),
              cpu_zbuffer_s=cpu_s, gpu=gpu))


def drive_frames(cfg, dev, chunks, ba_every: int, loop_every: int):
    """`chunks` of (lefts, rights) one frame at a time through a fresh
    SLAMSystem.process_frame on the card, its PD controller pinned at
    FRAME_PD_SCALE (the controller still runs every frame); the launch
    counts set to 0 just before and read just after. Returns the frames'
    telemetry, their seconds, the launches, the purged keyframes, the
    system, and the window positions before and after its first local
    BA."""
    from denseslam_tpu_torch import kernels
    from denseslam_tpu_torch.models.system import SLAMSystem

    system = SLAMSystem(cfg, ba_every=ba_every, loop_every=loop_every,
                        device=dev)
    pd = system.pd
    pd_range = (pd.lo, pd.hi)
    pd.lo = pd.hi = pd.scale = FRAME_PD_SCALE
    purged = count_purges(system)
    local_ba = system.backend.local_ba
    first_ba = {}

    def logged_ba():
        before = {k.frame_id: k.T_wc[:3, 3].copy()
                  for k in system.backend.keyframes}
        res = local_ba()
        if res is not None and not first_ba:
            first_ba.update({int(f): (before[int(f)], T[:3, 3].copy())
                             for f, T in zip(*res)})
        return res

    system.backend.local_ba = logged_ba
    outs, frame_s = [], []
    torch.cuda.synchronize()
    kernels.reset_counts()
    for lefts, rights in chunks:
        for j in range(lefts.shape[0]):
            t0 = time.perf_counter()
            outs.append(system.process_frame(lefts[j], rights[j]))
            frame_s.append(time.perf_counter() - t0)
    return dict(outs=outs, frame_s=frame_s, system=system,
                launches=dict(kernels.launch_counts), purged=purged[0],
                first_ba=first_ba, pd_range=pd_range)


def frame_stats(run, gt) -> dict:
    """Launch identity (per fused keyframe 3 of B3 and 1 of the tail; B1
    once per fused, twice per re-fused and once per purged keyframe), then
    tracking, ATE, frames/s after the first FRAME_WARMUP frames, and the
    first BA's keyframe errors against the ground truth, before and after,
    of one drive_frames run."""
    from denseslam_tpu_torch.eval import traj_metrics

    outs, system = run["outs"], run["system"]
    fused = sum(o["fused"] for o in outs)
    refused = system.num_corrections
    want = dict(tile_sample=fused + 2 * refused + run["purged"],
                tile_sample_rgb=0, sgm_path=3 * fused, sgm_final=fused,
                cost_volume=fused)
    if fused == 0 or run["launches"] != want:
        raise AssertionError(f"launches {run['launches']}, want {want} "
                             f"({fused} fused, {refused} re-fused, "
                             f"{run['purged']} purged)")
    if system.backend.num_keyframes + system.num_culled != fused:
        raise AssertionError("a fused keyframe did not reach the backend")
    if any(o["budget_scale"] != FRAME_PD_SCALE for o in outs):
        raise AssertionError("the pinned budget scale moved")
    est = np.stack([o["T_wc"] for o in outs])
    if not np.isfinite(est).all():
        raise AssertionError("non-finite poses")
    n = len(outs)
    steady = run["frame_s"][FRAME_WARMUP:]
    return dict(
        fused=fused, refused=refused, purged=run["purged"],
        launches=run["launches"],
        overflow=int(system.slam.submaps.active.overflow),
        tracking_ok_share=float(np.mean([o["tracking_ok"]
                                         for o in outs[1:]])),
        ate_rmse_m=traj_metrics.ate_rmse(list(est), list(gt[:n])),
        end_error_m=float(np.linalg.norm(est[-1][:3, 3] - gt[n - 1][:3, 3])),
        loops=system.num_loops, culled=system.num_culled,
        relocs=system.num_relocs, ba_rejects=system.backend.ba_rejects,
        fps=len(steady) / sum(steady),
        frame_ms_median=1e3 * float(np.median(steady)),
        frame_ms_max=1e3 * max(steady),
        first_ba=[dict(frame=f, err_before_m=float(np.linalg.norm(
                           a - gt[f][:3, 3])),
                       err_after_m=float(np.linalg.norm(b - gt[f][:3, 3])))
                  for f, (a, b) in sorted(run["first_ba"].items())])


def sync_count(fn):
    """Run fn() under torch.cuda.set_sync_debug_mode("warn"): its result
    and the host syncs it made (cudaStreamSynchronize /
    cudaDeviceSynchronize behind a read-back, a blocking copy or a
    synchronize), counted from the warnings."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return res, sum("synchroniz" in str(w.message) for w in caught)


def live_window(run, lefts, rights, out=None):
    """The PD controller of drive_frames run `run` live again, in its own
    range, on the frames after the drive: the first FRAME_WINDOW_WARM of
    `lefts`/`rights` warm up, the next FRAME_WINDOW run timed on the host
    clock with their host syncs counted (sync_count); with `out`
    (--profile) under profile_part instead (device ms, launches, busy
    share, host syncs a frame, and the table). Returns the record and the
    budget scales the window visited."""
    system = run["system"]
    system.pd.lo, system.pd.hi = run["pd_range"]
    spans = ((0, FRAME_WINDOW_WARM),
             (FRAME_WINDOW_WARM, FRAME_WINDOW_WARM + FRAME_WINDOW))
    scales = []

    def frames(i):
        for j in range(*spans[i]):
            scales.append(system.process_frame(lefts[j],
                                               rights[j])["budget_scale"])
        return i + 1

    if out:
        _, rec = profile_part("frame", FRAME_WINDOW, frames, 0, out)
        return rec, scales
    frames(0)
    t0 = time.perf_counter()
    _, syncs = sync_count(lambda: frames(1))
    wall_ms = (time.perf_counter() - t0) * 1e3
    return dict(wall_ms=wall_ms, device_busy_share=None,
                per_frame=dict(device_ms=None, launches=None,
                               host_syncs=syncs / FRAME_WINDOW)), scales


def timer_syncs(run, lefts, rights, out=None):
    """The timers' own host syncs: the next FRAME_TIMER_AB frames of the
    drive (`lefts`, `rights`; the first is a keyframe) through the live
    window's system, its RANSAC budget pinned at the last live value, each
    run from the same state (io/convert.py's snapshot, the frontend's key
    among it) after a warm-up run from it, once with utils/timing.py's TIMERS
    as they are and once with tic and toc doing nothing, their host syncs
    counted by sync_count; then the timed run once more under
    profile_part, whose count of the runtime's sync calls checks that
    reading. Returns the syncs a frame of each mode and the profiler's."""
    from denseslam_tpu_torch.io import convert
    from denseslam_tpu_torch.utils.timing import TIMERS, Lap

    system = run["system"]
    system.pd.lo = system.pd.hi = system.pd.scale
    snap = convert.system_state_to_numpy(system)
    n = lefts.shape[0]

    def setup():
        convert.system_state_from_numpy(snap, system)
        return 0

    def frames(i):
        for j in range(n):
            system.process_frame(lefts[j], rights[j])
        return i

    recs = {}
    off = dict(tic=lambda name: None, toc=lambda name=None, sync=None: None,
               last_lap=lambda name: Lap(ms=0.0))
    for mode in ("timers_on", "timers_off"):
        if mode == "timers_off":
            for k, fn in off.items():
                setattr(TIMERS, k, fn)
        try:
            frames(setup())
            setup()
            t0 = time.perf_counter()
            _, syncs = sync_count(lambda: frames(0))
            recs[mode] = dict(host_syncs=syncs / n,
                              wall_ms=(time.perf_counter() - t0) * 1e3)
        finally:
            for k in off:
                TIMERS.__dict__.pop(k, None)
    prof = profile_part("frame_timers_on", n, frames, 0, out, setup=setup)[1]
    recs["profiler"] = prof["per_frame"]["host_syncs"]
    return recs


def run_frame(cfg, dev, gpu, out=None):
    """The per-frame path: the flagship drive's first FRAME_FRAMES frames
    (the same frames and noise) one at a time through
    SLAMSystem.process_frame at 1226x370, ba_every=4, loop_every=2, the
    RANSAC budget pinned at FRAME_PD_SCALE; then the same frames with the
    backend off (ba_every=0, loop_every=0): the VO and fusion alone; then,
    on the backend run, the next FRAME_WINDOW_WARM + FRAME_WINDOW frames of
    the drive with the PD controller live (live_window), then the timers'
    A/B (timer_syncs). Gates: tracking on >= 95% of frames, overflow 0 and
    the launch identity in both runs; ATE <= FRAME_VO_ATE_M for the VO
    alone and <= FRAME_ATE_M with the backend; the timers add no host sync,
    and the sync count of the timed frame equals the profiler's. Frames/s
    counts the frames after the first 16."""
    from denseslam_tpu_torch.tools.long_drive_eval import (system_chunk,
                                                           system_setup)
    from denseslam_tpu_torch.utils import threefry
    gt, scene = system_setup(SYSTEM_LOOP_FRAMES)
    key = threefry.prng_key(0)
    chunks = [cached(system_chunk)(cfg, gt, scene, base,
                                   min(base + SYSTEM_CHUNK, FRAME_FRAMES),
                                   key, dev)
              for base in range(0, FRAME_FRAMES, SYSTEM_CHUNK)]
    run = drive_frames(cfg, dev, chunks, 4, 2)
    full = frame_stats(run, gt)
    vo = frame_stats(drive_frames(cfg, dev, chunks, 0, 0), gt)
    end = FRAME_FRAMES + FRAME_WINDOW_WARM + FRAME_WINDOW
    lefts, rights = system_chunk(cfg, gt, scene, FRAME_FRAMES, end, key, dev)
    prof, scales = live_window(run, lefts, rights, out)
    lefts, rights = system_chunk(cfg, gt, scene, end, end + FRAME_TIMER_AB,
                                 key, dev)
    ab = timer_syncs(run, lefts, rights, out)
    on, off = (ab[k]["host_syncs"] for k in ("timers_on", "timers_off"))
    emit(dict(phase="frame", frames=FRAME_FRAMES, budget_scale=FRAME_PD_SCALE,
              **full, vo_only=vo,
              live=dict(frames=[FRAME_FRAMES, end],
                        profiled=[end - FRAME_WINDOW, end],
                        budget_scale_min=min(scales),
                        budget_scale_max=max(scales),
                        **prof["per_frame"],
                        device_busy_share=prof["device_busy_share"],
                        wall_ms_per_frame=prof["wall_ms"] / FRAME_WINDOW),
              timers=dict(frames=[end, end + FRAME_TIMER_AB],
                          host_syncs_on=on, host_syncs_off=off,
                          host_syncs_profiler=ab["profiler"],
                          wall_ms_on=ab["timers_on"]["wall_ms"],
                          wall_ms_off=ab["timers_off"]["wall_ms"]),
              gpu=gpu))
    gates = dict(tracking=min(full["tracking_ok_share"],
                              vo["tracking_ok_share"]) >= 0.95,
                 overflow=full["overflow"] == vo["overflow"] == 0,
                 ate_vo=vo["ate_rmse_m"] <= FRAME_VO_ATE_M,
                 ate=full["ate_rmse_m"] <= FRAME_ATE_M,
                 timer_syncs=on == off,
                 sync_reading=on == ab["profiler"])
    if not all(gates.values()):
        raise AssertionError(f"frame gates failed: {gates}")
    return dict(launches=full["launches"], vo_launches=vo["launches"])


def icp_frames(cfg, dev):
    """The internal-ICP drive of the JAX package's own test
    (tests/test_pipeline.py:171-187: the default scene, make_trajectory at
    0.04 m and 0.003 rad a frame, rendered depth as the sensor's) at
    1226x370 for ICP_FRAMES frames, rendered on the card."""
    from denseslam_tpu_torch.io import synthetic

    poses = synthetic.make_trajectory(ICP_FRAMES, step_m=0.04,
                                      yaw_rate=0.003)
    grays, depths = synthetic.render_trajectory(
        poses, cfg.rig.intr, synthetic.default_scene(), device=dev)
    return dict(poses=poses, grays=grays, depths=depths)


def run_icp(cfg, dev, gpu):
    """Internal odometry: icp_frames through DenseSLAM.process_frame with
    use_external_odometry=False (ICP of each frame's depth against a splat
    render of the map at the last fused pose; fusion every 4th frame
    through B2), at 1226x370; the launch counts set to 0 just before and
    read just after. Gates: ICP converged on every frame after the first;
    on every frame, the ICP pose's step from the last fused pose off the
    true step by at most ICP_STEP_FRAC of the true step (a pose left at
    the last fused one is off by all of it); the final position error at
    most ICP_FINAL_FRAC of the distance travelled; B2 once per fused
    keyframe; and one `track` call rerun on the CPU from the card's model
    lands within 1 mm / 1e-4 rad of the card's."""
    from denseslam_tpu_torch import kernels
    from denseslam_tpu_torch.models.dense_slam import DenseSLAM
    from denseslam_tpu_torch.ops import icp

    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, use_external_odometry=False))
    fr = icp_frames(cfg, dev)
    slam = DenseSLAM(cfg, device=dev)
    outs = []
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    for i in range(ICP_FRAMES):
        outs.append(slam.process_frame(fr["grays"][i],
                                       depth=fr["depths"][i]))
    secs = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    fused = [o["frame"] for o in outs if o["fused"]]
    if launches != dict(tile_sample=0, tile_sample_rgb=len(fused),
                        sgm_path=0, sgm_final=0, cost_volume=0):
        raise AssertionError(f"launches {launches} for {len(fused)} fused")
    est = np.stack([o["T_wc"] for o in outs])
    gt = fr["poses"]
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    converged = float(np.mean([o["tracking_ok"] for o in outs[1:]]))
    # each frame's step from the keyframe it was tracked against
    step_frac = []
    for i in range(1, ICP_FRAMES):
        k = max(f for f in fused if f < i)
        d_est = est[i, :3, 3] - est[k, :3, 3]
        d_gt = gt[i, :3, 3] - gt[k, :3, 3]
        step_frac.append(float(np.linalg.norm(d_est - d_gt)
                               / np.linalg.norm(d_gt)))
    travelled = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0),
                                     axis=1).sum())

    # one track call of the card's last model, on both devices
    T_prev = slam.last_fused_T
    rc = slam._render(slam.submaps.active, T_prev)
    depth = fr["depths"][ICP_FRAMES - 1]
    args = (depth, rc.points, rc.normals, rc.mask, T_prev, T_prev)
    rg = icp.track(*args, cfg.rig.intr)
    rcpu = icp.track(*(a.cpu() for a in args), cfg.rig.intr)
    t_err, r_err = pose_errors(rg.T_wc[None], rcpu.T_wc[None], "ICP track")
    emit(dict(phase="icp", frames=ICP_FRAMES, fused=len(fused),
              launches=launches, converged_share=converged,
              travelled_m=travelled, final_pos_err_m=float(err[-1]),
              final_err_frac=float(err[-1]) / travelled,
              step_err_frac_max=max(step_frac), step_err_frac=step_frac,
              pos_err_m=err.tolist(),
              icp_rmse_m=[o.get("icp_rmse") for o in outs[1:]],
              track_card_vs_cpu_m=t_err, track_card_vs_cpu_rad=r_err,
              seconds=secs, gpu=gpu))
    gates = dict(converged=converged == 1.0,
                 steps=max(step_frac) <= ICP_STEP_FRAC,
                 final_err=float(err[-1]) <= ICP_FINAL_FRAC * travelled)
    if not all(gates.values()):
        raise AssertionError(f"icp gates failed: {gates}")
    return dict(launches=launches)


def mono_frames(cfg, dev, n: int, seed: int):
    """The mono drive's first n frames, as its first chunk made them (the
    same key), the ground truth, and n frames of 8-point draws from a CPU
    generator seeded `seed`, on the card."""
    from denseslam_tpu_torch.tools.long_drive_eval import (depth_chunk,
                                                           system_setup)
    from denseslam_tpu_torch.ops import ransac
    from denseslam_tpu_torch.utils import threefry
    gt, scene = system_setup(MONO_LOOP_FRAMES)
    grays, depths = cached(depth_chunk)(cfg, gt, scene, 0, SYSTEM_CHUNK,
                                        threefry.prng_key(0), dev)
    cpu_gen = torch.Generator().manual_seed(seed)
    draws = torch.stack([torch.randint(
        0, ransac._RAW_HIGH, (cfg.frontend.ransac_iters, 8),
        generator=cpu_gen) for _ in range(n)])
    torch.cuda.synchronize()
    return dict(grays=grays[:n].clone(), depths=depths[:n].clone(),
                draws=draws.to(dev), poses=gt[:n],
                fids=torch.arange(n, dtype=torch.int32, device=dev))


def drive_mono(cfg, fr):
    """process_sequence_mono over all frames of `fr` in one call, from a
    fresh state on their device. Returns (map, stats)."""
    from denseslam_tpu_torch.models import dense_slam, frontend
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    d = fr["grays"].device
    st = frontend.init_frontend(cfg, device=d)
    m = tsdf_ops.make_map(cfg.tsdf, device=d)
    db = dense_slam.make_fusion_db(cfg, device=d)
    _, m, _, stats = dense_slam.process_sequence_mono(
        st, m, db, fr["grays"], fr["depths"], fr["fids"], cfg,
        draws=fr["draws"])
    return m, stats


def count_insert_failures(m_ops):
    """Wrap tsdf.allocate_keys to count, over every allocation (fusion and
    correction replays), the keys the hash could not insert within its
    probe length and the visible blocks dropped past max_visible_blocks,
    and to keep the most blocks the table held; returns the dict that
    holds the counts and the function to unwrap."""
    orig = m_ops.allocate_keys
    counts = dict(insert_failed=0, visible_dropped=0, peak_blocks=0)

    def allocate_keys(m, uniq, umask, total, cfg):
        m, slots, live = orig(m, uniq, umask, total, cfg)
        counts["insert_failed"] += int((umask & ~live).sum())
        counts["visible_dropped"] += max(int(total) - cfg.max_visible_blocks,
                                         0)
        counts["peak_blocks"] = max(counts["peak_blocks"],
                                    int(m.table.valid.sum()))
        return m, slots, live

    m_ops.allocate_keys = allocate_keys
    return counts, lambda: setattr(m_ops, "allocate_keys", orig)


def run_mono(cfg, dev, gpu):
    """The monocular system: the mono loop drive of
    scripts/long_drive_eval.py --sensor mono (384 frames in 6 chunks of
    64, 8-point VO with the ground-plane scale, fusion of the supplied
    depth) through SLAMSystem.process_chunk and finish(), ba_every=4,
    loop_every=2, with the depth evaluation every 8th fused keyframe (the
    map at the estimated and at the true pose, and the supplied depth);
    the launch counts set to 0 just before and read just after: B1 once
    per fused keyframe, twice per re-fused and once per purged one, no SGM
    kernel. The map's overflow is counted by source: the hash's probe
    failures apart, none other allowed. The ATE gate holds the median of
    this drive's and MONO_ATE_DRAWS - 1 more drives' (other 8-point
    draws, no eval). Frames/s from chunk 2 on, the eval kept out of it."""
    from denseslam_tpu_torch.tools.long_drive_eval import (depth_chunk,
                                                           drive_system,
                                                           mean_metrics,
                                                           system_setup)
    from denseslam_tpu_torch import kernels
    from denseslam_tpu_torch.eval import traj_metrics
    from denseslam_tpu_torch.models.system import SLAMSystem
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    gt, scene = system_setup(MONO_LOOP_FRAMES)
    system = SLAMSystem(cfg, ba_every=4, loop_every=2, device=dev)
    purged = count_purges(system)
    sources, unwrap = count_insert_failures(tsdf_ops)
    kernels.reset_counts()
    try:
        d = drive_system(cfg, dev, system, gt, scene,
                         system.slam.raycast_view, frames=MONO_FRAMES,
                         eval_every=MONO_EVAL_EVERY,
                         make_chunk=cached(depth_chunk))
    finally:
        unwrap()
    launches = dict(kernels.launch_counts)

    be = system.backend
    fused = be.num_keyframes + system.num_culled
    refused = system.num_corrections
    want = dict(tile_sample=fused + 2 * refused + purged[0],
                tile_sample_rgb=0, sgm_path=0, sgm_final=0, cost_volume=0)
    if fused == 0 or launches != want:
        raise AssertionError(f"launches {launches}, want {want} ({fused} "
                             f"fused, {refused} re-fused, {purged[0]} "
                             "purged)")
    evals = d["evals"]
    depth_q = {k: mean_metrics(evals, k)
               for k in ("depth", "depth_gtpose", "depth_input")}
    ok = np.concatenate(d["ok_frames"])
    track = float(ok[1:].mean())
    est = [T for _, T in system.trajectory()]
    if len(est) != MONO_FRAMES or not np.isfinite(np.stack(est)).all():
        raise AssertionError("trajectory has the wrong length or "
                             "non-finite poses")
    ate = traj_metrics.ate_rmse(est, list(gt))
    kitti = traj_metrics.kitti_sequence_errors(est, list(gt))
    overflow = int(system.slam.submaps.active.overflow)
    ates = [ate] + [mono_ate(cfg, dev, gt, scene, seed)
                    for seed in range(1, MONO_ATE_DRAWS)]
    emit(dict(phase="mono", frames=MONO_FRAMES, chunk=SYSTEM_CHUNK,
              fused=fused, refused=refused, purged=purged[0],
              launches=launches, overflow=overflow,
              overflow_sources=sources,
              blocks=int(tsdf_ops.num_allocated_blocks(
                  system.slam.submaps.active)),
              tracking_ok_share=track,
              loops=system.num_loops, corrections=refused,
              culled=system.num_culled, relocs=system.num_relocs,
              keyframes=be.num_keyframes, ba_rejects=be.ba_rejects,
              pg_rejects=be.pg_rejects, ate_rmse_m=ate,
              ate_by_draws_m=ates, ate_median_m=float(np.median(ates)),
              jax_record_ate_m=jax_record_ate("results_mono.json"),
              end_error_m=float(np.linalg.norm(est[-1][:3, 3]
                                               - gt[-1][:3, 3])),
              kitti_t_err_pct=kitti["kitti_t_err_pct"],
              kitti_r_err_deg_per_m=kitti["kitti_r_err_deg_per_m"],
              loops_accepted=[lg for lg in be.loop_log
                              if lg["accepted"] is not None],
              fps=d["proc_frames"] / d["proc_s"],
              fps_frames=d["proc_frames"], process_s=d["proc_s"],
              wall_s=d["wall_s"], synth_s=d["synth_s"], eval_s=d["eval_s"],
              eval_frames=d["eval_ids"], **depth_q,
              phase_s={**system.phase_s, **be.phase_s},
              memory_mb=system.memory_bytes() / 1e6, gpu=gpu))
    # the hash's probe failures are the reference's (ROADMAP.md Queue C:
    # the same table state and keys through the JAX package's
    # insert_keys fail alike); every other source of overflow must be 0
    gates = dict(tracking=track >= 0.95, loop=system.num_loops >= 1,
                 refused=refused >= 1,
                 overflow=overflow == sources["insert_failed"]
                 and sources["visible_dropped"] == 0,
                 ate=float(np.median(ates)) <= MONO_ATE_M,
                 input_d1_25=depth_q["depth_input"]["d1_25"]
                 >= MONO_INPUT_D1,
                 gtpose_d1_25=depth_q["depth_gtpose"]["d1_25"]
                 >= MONO_GTPOSE_D1,
                 gtpose_coverage=depth_q["depth_gtpose"]["coverage"]
                 >= MONO_GTPOSE_COVERAGE)
    if not all(gates.values()):
        raise AssertionError(f"mono gates failed: {gates}")
    return dict(launches=launches)


def mono_ate(cfg, dev, gt, scene, seed: int) -> float:
    """The mono drive again (the same frames and noise, no eval) with the
    8-point draws of the frontend key PRNGKey(`seed`): its ATE."""
    from denseslam_tpu_torch.tools.long_drive_eval import depth_chunk
    from denseslam_tpu_torch.eval import traj_metrics
    from denseslam_tpu_torch.models.system import SLAMSystem
    from denseslam_tpu_torch.utils import threefry

    system = SLAMSystem(cfg, seed=seed, ba_every=4, loop_every=2,
                        device=dev)
    key = threefry.prng_key(0)
    make = cached(depth_chunk)
    for base in range(0, MONO_FRAMES, SYSTEM_CHUNK):
        system.process_chunk(*make(cfg, gt, scene, base, base + SYSTEM_CHUNK,
                                   key, dev))
    system.finish()
    est = [T for _, T in system.trajectory()]
    return traj_metrics.ate_rmse(est, list(gt))


def check_mono_against_cpu(cfg, dev):
    """Frames 0-4 of the mono drive through process_sequence_mono on the
    card and on the CPU with the same draws: the VO poses agree, and the
    CPU fusing the card's keyframes at the card's poses rebuilds the
    card's map (keys, weights, colours equal, tsdf within 1e-6)."""
    from denseslam_tpu_torch.models import dense_slam
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    cpu = torch.device("cpu")
    fr = mono_frames(cfg, dev, N_CPU_FRAMES, seed=3)
    mg, sg = drive_mono(cfg, fr)
    fr_cpu = {k: (v.to(cpu) if isinstance(v, torch.Tensor) else v)
              for k, v in fr.items()}
    t0 = time.perf_counter()
    _, sc = drive_mono(cfg, fr_cpu)
    cpu_s = time.perf_counter() - t0
    t_err, r_err = pose_errors(sg["T_wc"], sc["T_wc"])
    if not torch.equal(sg["fused"].cpu(), sc["fused"]):
        raise AssertionError("card and CPU fused different keyframes")
    if not torch.equal(sg["num_inliers"].cpu(), sc["num_inliers"]):
        raise AssertionError("card and CPU counted different inliers")

    mc = tsdf_ops.make_map(cfg.tsdf, device=cpu)
    db = dense_slam.make_fusion_db(cfg, device=cpu)
    for i in torch.nonzero(sc["fused"]).flatten().tolist():
        mc, db = dense_slam.fuse_keyframe(
            mc, db, fr_cpu["depths"][i], fr_cpu["grays"][i],
            sg["T_wc"][i].cpu(), i, cfg)
    if not torch.equal(mg.table.keys.cpu(), mc.table.keys):
        raise AssertionError("hash tables differ between card and CPU")
    for name in ("weight", "color"):
        if not torch.equal(getattr(mg, name).cpu(), getattr(mc, name)):
            raise AssertionError(f"{name} differs between card and CPU")
    tg, tc = mg.tsdf.cpu().float(), mc.tsdf.float()
    tsdf_err = float((tg - tc).abs().max())
    if tsdf_err > 1e-6:
        raise AssertionError(f"tsdf card vs CPU: {tsdf_err}")
    emit(dict(phase="mono_cpu_reference", frames=N_CPU_FRAMES,
              fused=int(sc["fused"].sum()), vo_pos_err_m=t_err,
              vo_rot_err_rad=r_err,
              inliers=sg["num_inliers"].cpu().tolist(), tables_equal=True,
              weights_equal=True, colours_equal=True,
              tsdf_max_abs_err=tsdf_err,
              tsdf_frac_differ=float((tg != tc).float().mean()),
              cpu_s=cpu_s))


def run_mono_frame(cfg, dev, gpu):
    """The mono drive's first 32 frames one at a time through
    DenseSLAM.process_frame (the CLI's default path) with the supplied
    depth and the frames' draws, no backend, with the launch counts set
    to 0 just before and read just after (B1 once per fused keyframe);
    then process_sequence_mono over the same frames and draws: every pose
    within 1e-5 m and 1e-5 rad of it, the same keyframes fused."""
    from denseslam_tpu_torch import kernels
    from denseslam_tpu_torch.models.dense_slam import DenseSLAM

    fr = mono_frames(cfg, dev, MONO_FRAME_FRAMES, seed=4)
    slam = DenseSLAM(cfg, device=dev)
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    outs = [slam.process_frame(fr["grays"][i], depth=fr["depths"][i],
                               draws=fr["draws"][i])
            for i in range(MONO_FRAME_FRAMES)]
    frame_s = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    fused = [o["fused"] for o in outs]
    want = dict(tile_sample=sum(fused), tile_sample_rgb=0, sgm_path=0,
                sgm_final=0,
                cost_volume=0)
    if not any(fused) or launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    _, stats = drive_mono(cfg, fr)
    if fused != stats["fused"].cpu().tolist():
        raise AssertionError("per-frame and chunk paths fused different "
                             "keyframes")
    est = torch.as_tensor(np.stack([o["T_wc"] for o in outs]))
    seq = stats["T_wc"].cpu()
    t_err = float((est[:, :3, 3] - seq[:, :3, 3]).norm(dim=-1).max())
    r_err = float((est[:, :3, :3] - seq[:, :3, :3]).abs().max())
    track = float(np.mean([o["tracking_ok"] for o in outs[1:]]))
    emit(dict(phase="mono_frame", frames=MONO_FRAME_FRAMES,
              fused=sum(fused), launches=launches,
              tracking_ok_share=track, pose_err_m=t_err, rot_err=r_err,
              fps=MONO_FRAME_FRAMES / frame_s, gpu=gpu))
    if t_err > 1e-5 or r_err > 1e-5 or track < 0.95:
        raise AssertionError(f"mono_frame: {t_err} m, {r_err}, tracking "
                             f"{track}")
    return dict(launches=launches)


def run_orb(cfg, dev, fr, gpu):
    """The ORB feature stack at 1226x370: detect_pyramid on the stereo
    phase's first street frame on the card and on the CPU (keypoints and
    validity equal, >= 99.9% of descriptor bits equal), hamming_matrix
    and match of the card's descriptors equal on both devices; then the
    stereo phase's 64 frames through process_sequence with
    feature_type="orb", with the launch counts set to 0 just before and
    read just after (per fused keyframe 3 of B3, 1 of the tail, 1 of B1),
    tracking on >= 95% of frames, the final position within 3% of the
    distance travelled."""
    from denseslam_tpu_torch import kernels
    from denseslam_tpu_torch.ops import orb

    ocfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, feature_type="orb"))
    fc = ocfg.frontend

    def detect(img):
        return orb.detect_pyramid(img, fc.max_features, levels=fc.orb_levels,
                                  thresh=fc.orb_thresh)

    left, right = fr["lefts"][0], fr["rights"][0]
    fg, fg_r = detect(left), detect(right)
    t0 = time.perf_counter()
    f_cpu = detect(left.cpu())
    cpu_s = time.perf_counter() - t0
    for name in ("uv", "valid"):
        if not torch.equal(getattr(fg, name).cpu(), getattr(f_cpu, name)):
            raise AssertionError(f"ORB {name} differs between card and CPU")
    shifts = torch.arange(32)
    bits_g = (fg.desc.cpu()[..., None] >> shifts) & 1
    bits_c = (f_cpu.desc[..., None] >> shifts) & 1
    bit_share = float((bits_g == bits_c).float().mean())
    if bit_share < 0.999:
        raise AssertionError(f"ORB descriptor bits agree on {bit_share}")
    ham = orb.hamming_matrix(fg.desc, fg_r.desc)
    match = orb.match(fg, fg_r)
    cpu_f = [f._replace(**{k: getattr(f, k).cpu() for k in f._fields})
             for f in (fg, fg_r)]
    if not (torch.equal(ham.cpu(), orb.hamming_matrix(cpu_f[0].desc,
                                                       cpu_f[1].desc))
            and torch.equal(match.cpu(), orb.match(*cpu_f))):
        raise AssertionError("hamming_matrix or match differs between "
                             "card and CPU")
    detect_ms = cuda_ms(lambda: detect(left), 5)

    kernels.reset_counts()
    m, stats, secs = drive_stereo(ocfg, fr)
    launches = dict(kernels.launch_counts)
    fused = int(stats["fused"].sum())
    want = dict(tile_sample=fused, tile_sample_rgb=0, sgm_path=3 * fused,
                sgm_final=fused,
                cost_volume=fused)
    if fused == 0 or launches != want:
        raise AssertionError(f"launches {launches} for {fused} fused "
                             f"keyframes, want {want}")
    ok = stats["tracking_ok"].cpu().numpy()
    track = float(ok[1:].mean())
    emit(dict(phase="orb", features=int(fg.valid.sum()),
              matches_left_right=int((match >= 0).sum()),
              desc_bits_equal_share=bit_share, detect_ms=detect_ms,
              detect_cpu_s=cpu_s, frames=STEREO_FRAMES, fused=fused,
              launches=launches, tracking_ok_share=track,
              inliers_median=float(np.median(
                  stats["num_inliers"].cpu().numpy()[1:])),
              overflow=int(m.overflow), seconds=secs, gpu=gpu))
    if track < 0.95:
        raise AssertionError(f"ORB tracking held on {track:.3f} of frames")
    traj = trajectory_gates(stats["T_wc"], fr["poses"])
    emit(dict(phase="orb_trajectory", **traj))
    return dict(launches=launches)


DRIVE_CHUNKS = {}   # what a chunk is made of -> a drive's frames, on the card


def _chunk_key(make, cfg, gt, scene, lo, hi, key, dev):
    """Everything a chunk maker's frames depend on, as a dict key: the
    maker, the config, the poses and the scene (by value), the frame range,
    the threefry key and the device."""
    arrays = tuple(np.asarray(a).tobytes() for a in (gt, *scene[:2]))
    return (make.__name__, cfg, arrays, tuple(scene[2:]), lo, hi,
            tuple(key.tolist()), str(dev))


def cached(make):
    """The drive tool's chunk maker `make` (system_chunk, depth_chunk)
    with its chunks kept in DRIVE_CHUNKS: the phases that replay a drive's
    frames (`submaps` and `frame` the system drive's, the mono drive's
    other draw sets) make them once. A chunk is reused only for the same
    inputs (`_chunk_key`). main() empties DRIVE_CHUNKS after the last of
    them."""
    def make_cached(cfg, gt, scene, lo, hi, key, dev):
        k = _chunk_key(make, cfg, gt, scene, lo, hi, key, dev)
        if k not in DRIVE_CHUNKS:
            DRIVE_CHUNKS[k] = make(cfg, gt, scene, lo, hi, key, dev)
        return DRIVE_CHUNKS[k]
    return make_cached


def jax_record_ate(name: str):
    """The JAX package's record of a drive (its ATE on XLA:TPU, on the
    same frames and draws since PR 11), printed beside the card's, not
    gated: the records are another compiler's."""
    with open(os.path.join(ROOT, name)) as fh:
        return json.load(fh)["ate_rmse_m"]


def surface_distances(v: torch.Tensor, scene) -> torch.Tensor:
    """Distance of each point (N, 3) to the nearest true surface of a
    loop scene: its spheres and its ground plane, in float64. (In float32
    the plane's height 1.65 m rounds down by 2.4e-8 m, which moved the
    many vertices of the horizontal tet edges on the voxel-centre rows
    two voxels from the plane to 4.8e-9 m past two voxels.)"""
    v = v.to(torch.float64)
    c = torch.as_tensor(scene.sphere_centers, device=v.device).double()
    r = torch.as_tensor(scene.sphere_radii, device=v.device).double()
    d = (v[:, 1] - scene.plane_y).abs()
    for i in range(c.shape[0]):
        d = torch.minimum(d, ((v - c[i]).norm(dim=-1) - r[i]).abs())
    return d


def run_mesh(cfg, dev, system, gpu):
    """DenseSLAM.save_mesh of the system phase's final map (1<<17 slots)
    into build/mesh_system.obj: >= 1e4 triangles, edges under 2 voxels,
    the median distance of the vertices to the loop scene's spheres and
    plane under 2 voxels (the map is stereo depth fused at estimated
    poses); the same map meshed on the CPU: the same triangles within
    1e-5 m. Also the card's extraction time at 512 blocks a chunk (the
    JAX version's) and 4096."""
    from denseslam_tpu_torch.tools.long_drive_eval import system_setup
    from denseslam_tpu_torch.models.dense_slam import copy_map
    from denseslam_tpu_torch.ops import meshing
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    slam = system.slam
    m = slam.submaps.active
    path = os.path.join(ROOT, "build", "mesh_system.obj")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = slam.save_mesh(path)
    save_s = time.perf_counter() - t0
    extract_s = {}
    for chunk in (512, 4096):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tris = meshing.extract_mesh(m, cfg.tsdf, chunk=chunk)
        extract_s[chunk] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tris_c = meshing.extract_mesh(copy_map(m, torch.device("cpu")),
                                  cfg.tsdf)
    cpu_s = time.perf_counter() - t0
    if tris.shape != tris_c.shape or tris.shape[0] != n:
        raise AssertionError(f"triangles: {n} saved, {tris.shape[0]} card, "
                             f"{tris_c.shape[0]} CPU")
    cpu_err = float(np.abs(tris - tris_c).max()) if n else 0.0
    vsz = cfg.tsdf.voxel_size_m
    edge = float(np.linalg.norm(tris[:, [1, 2, 0]] - tris, axis=-1).max())
    _, scene = system_setup(SYSTEM_LOOP_FRAMES)
    d = surface_distances(torch.as_tensor(tris.reshape(-1, 3), device=dev),
                          scene)
    d = d.cpu().numpy()
    med, p95 = float(np.median(d)), float(np.quantile(d, 0.95))
    # not gated, an open question: the vertices more than 1.5 voxels
    # below the ground (y points down) and the median without them
    below = tris.reshape(-1, 3)[:, 1] > scene.plane_y + 1.5 * vsz
    emit(dict(phase="mesh", triangles=n,
              blocks=int(tsdf_ops.num_allocated_blocks(m)),
              obj_bytes=os.path.getsize(path), save_mesh_s=save_s,
              extract_s_by_chunk=extract_s, cpu_extract_s=cpu_s,
              cpu_max_abs_err_m=cpu_err, edge_max_m=edge,
              surface_dist_median_m=med, surface_dist_p95_m=p95,
              below_ground_share=float(below.mean()),
              surface_dist_median_not_below_m=float(np.median(d[~below])),
              gpu=gpu))
    gates = dict(triangles=n >= 10_000, cpu=cpu_err <= 1e-5,
                 edges=edge < 2 * vsz, surface=med < 2 * vsz)
    if not all(gates.values()):
        raise AssertionError(f"mesh gates failed: {gates}")


def run_bilinear(cfg, dev, run):
    """4 frames of the slice (their SGM depth, at their poses) fused with
    bilinear_fusion=True on the card and on the CPU, the launch counts set
    to 0 just before the card's and read just after: the tile sampler is
    bypassed (B1 launched 0 times); keys and weights equal, tsdf within
    1e-6."""
    from denseslam_tpu_torch import kernels
    from denseslam_tpu_torch.models import dense_slam
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    bcfg = dataclasses.replace(cfg, tsdf=dataclasses.replace(
        cfg.tsdf, bilinear_fusion=True))
    n = 4
    maps = []
    for d in (dev, torch.device("cpu")):
        m = tsdf_ops.make_map(bcfg.tsdf, device=d)
        db = dense_slam.make_fusion_db(bcfg, device=d)
        kernels.reset_counts()
        m, db = dense_slam.fuse_sequence(
            m, db, run["depth"][:n].to(d), run["lefts"][:n].to(d),
            run["T"][:n].to(d), run["fids"][:n].to(d), bcfg)
        if d == dev:
            launches = dict(kernels.launch_counts)
        maps.append(m)
    mg, mc = maps
    if any(launches.values()):
        raise AssertionError(f"bilinear fusion launched {launches}")
    if not torch.equal(mg.table.keys.cpu(), mc.table.keys):
        raise AssertionError("hash tables differ between card and CPU")
    if not torch.equal(mg.weight.cpu(), mc.weight):
        raise AssertionError("weights differ between card and CPU")
    tg, tc = mg.tsdf.cpu().float(), mc.tsdf.float()
    err = float((tg - tc).abs().max())
    if err > 1e-6:
        raise AssertionError(f"bilinear tsdf card vs CPU: {err}")
    emit(dict(phase="bilinear", frames=n, launches=launches,
              blocks=int(tsdf_ops.num_allocated_blocks(mg)),
              fused_voxels=int((mg.weight > 0).sum()), tables_equal=True,
              weights_equal=True, tsdf_max_abs_err=err,
              tsdf_frac_differ=float((tg != tc).float().mean())))
    return dict(launches=launches)


def run_tracks(cfg, dev, gpu):
    """triangulate_tracks on TRACKS tracks seen from TRACK_VIEWS poses 0.5 m
    apart at 1226x370, made from a seed (points 4-40 m ahead, 0.5 px
    noise, an observation where the point projects into the view): card
    against CPU, points and RMSEs within 1e-4 (m, px) on the valid
    tracks, validity equal; the card's time (CUDA events)."""
    from denseslam_tpu_torch.io import synthetic
    from denseslam_tpu_torch.ops import reconstruction as rec

    intr = cfg.rig.intr
    rng = np.random.default_rng(5)
    poses = synthetic.make_trajectory(TRACK_VIEWS, step_m=0.5,
                                      yaw_rate=0.01).astype(np.float64)
    z = rng.uniform(4.0, 40.0, TRACKS)
    u = rng.uniform(0, intr.width, TRACKS)
    v = rng.uniform(0, intr.height, TRACKS)
    pts = np.stack([(u - intr.cx) / intr.fx * z, (v - intr.cy) / intr.fy * z,
                    z], -1)
    uv = np.zeros((TRACKS, TRACK_VIEWS, 2))
    mask = np.zeros((TRACKS, TRACK_VIEWS), bool)
    for k in range(TRACK_VIEWS):
        Ti = np.linalg.inv(poses[k])
        pc = pts @ Ti[:3, :3].T + Ti[:3, 3]
        uk = pc[:, 0] / pc[:, 2] * intr.fx + intr.cx
        vk = pc[:, 1] / pc[:, 2] * intr.fy + intr.cy
        mask[:, k] = ((pc[:, 2] > 0.5) & (uk >= 0) & (uk < intr.width)
                      & (vk >= 0) & (vk < intr.height))
        uv[:, k] = np.stack([uk, vk], -1) + rng.normal(0, 0.5,
                                                        (TRACKS, 2))
    host = rec.Tracks(torch.tensor(uv, dtype=torch.float32),
                      torch.tensor(mask),
                      torch.tensor(poses, dtype=torch.float32))
    card = rec.Tracks(*(t.to(dev) for t in host))
    rg = rec.triangulate_tracks(card, intr)
    rc = rec.triangulate_tracks(host, intr)
    ms = cuda_ms(lambda: rec.triangulate_tracks(card, intr), 10)
    valid = rc.valid
    if not torch.equal(rg.valid.cpu(), valid):
        raise AssertionError("track validity differs between card and CPU")
    p_err = float((rg.points_w.cpu() - rc.points_w)[valid].abs().max())
    r_err = float((rg.reproj_rmse.cpu() - rc.reproj_rmse)[valid].abs().max())
    truth = np.linalg.norm(rc.points_w.numpy()[valid.numpy()]
                           - pts[valid.numpy()], axis=-1)
    emit(dict(phase="tracks", tracks=TRACKS, views=TRACK_VIEWS,
              valid=int(valid.sum()), observations=int(mask.sum()),
              card_cpu_max_abs_err_m=p_err, card_cpu_rmse_err_px=r_err,
              truth_err_median_m=float(np.median(truth)), ms=ms, gpu=gpu))
    if p_err > 1e-4 or r_err > 1e-4 or int(valid.sum()) < TRACKS // 2:
        raise AssertionError(f"tracks: {p_err} m, {r_err} px, "
                             f"{int(valid.sum())} valid")


# -- the command line (denseslam_tpu_torch.main) -----------------------------

CLI_DIR = os.path.join(ROOT, "build", "cli")
# the KITTI-layout sequence: the flagship loop drive's first frames
CLI_FRAMES = 64
CLI_RUN_FRAMES = 32       # cli: the sequence's first frames (cut from 64
# when the experiments phase came, to keep the script within its time)
CLI_RESUME_FRAMES = 16    # cli_resume: the sequence's first frames, whole
CLI_RESUME_AT = 8         # ... and resumed at this frame (32 and 16,
# cut to pay for the jax_golden phase)
CLI_RGBD_FRAMES = 48
CLI_CPU_FRAMES = 5
# io/make_dataset.py's arguments of the KITTI-layout sequence
CLI_KITTI_ARGS = ["--frames", str(CLI_FRAMES), "--width", "1226", "--height",
                  "370", "--scene", "loop", "--fx", "707.09", "--baseline",
                  "0.537", "--gain", "0.15", "--noise", "2.0", "--seed", "3"]
# the keys of the JAX package's summary (denseslam_tpu/main.py:428-439)
SUMMARY_KEYS = ("frames", "fps", "mean_fusion_ms", "final_blocks",
                "final_memory_mb", "num_submaps", "num_device_submaps",
                "device_memory_mb", "submap_evictions", "submap_restores")


def read_text(path: str) -> str:
    with open(path) as fh:
        return fh.read()


def cli_datasets():
    """The CLI phases' sequences, written into build/cli/ by
    io/make_dataset.py (rendered on the card): the first CLI_FRAMES frames
    of the flagship loop drive (loop_scene, 1226x370, fx 707.09, baseline
    0.537 m) in KITTI layout under the drive's gain ramp (0.15) and
    photometric noise (2.0); and CLI_RGBD_FRAMES frames of the default
    scene in TUM layout (freiburg1's 640x480, 10 cm a frame backing away
    from the spheres, 0.003 rad of yaw a frame; the back wall stays within
    the 13.1 m that TUM's 16-bit depth holds) under the rgbd phase's sensor
    model: gain 0.15, noise 2.0, 1% depth noise, 5% holes. The RGB-D VO
    drifts about 3 mm a frame on this scene at any step, in the JAX package
    as in the port (ROADMAP.md Queue C), so the steps are long enough for
    the 3% gate."""
    import shutil

    from denseslam_tpu_torch.io.make_dataset import make_dataset
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    kitti = make_dataset([os.path.join(CLI_DIR, "kitti")] + CLI_KITTI_ARGS)
    tum = make_dataset([
        os.path.join(CLI_DIR, "tum"), "--frames", str(CLI_RGBD_FRAMES),
        "--layout", "tum", "--scene", "default", "--step_m", "-0.1",
        "--yaw_rate", "0.003", "--gain", "0.15", "--noise", "2.0",
        "--depth_noise", "0.01", "--holes", "0.05", "--seed", "4"])
    return kitti, tum


GOLDEN = os.path.join(ROOT, "tests", "golden", "stereo_chunk_jax.npz")


def decode_kitti(kitti: str, dev):
    """The KITTI sequence's first CLI_FRAMES pairs as the port's reader
    decodes them: (lefts, rights) float32 (N, H, W) on `dev`."""
    from denseslam_tpu_torch.io import datasets
    frames = list(datasets.Input(kitti, datasets.kitti_odometry_config(),
                                 frame_limit=CLI_FRAMES))
    return (torch.stack([torch.as_tensor(f["left"]) for f in frames]).to(dev),
            torch.stack([torch.as_tensor(f["right"])
                         for f in frames]).to(dev))


def run_jax_golden(dev, gpu, frames):
    """The stereo main path held to the JAX package at full width: the
    cli sequence's 64 decoded pairs (`frames`, the flagship loop drive's
    first frames) through process_sequence in one call at
    drive_config("stereo"), the RANSAC draws from the frontend's key, held
    to tests/golden/stereo_chunk_jax.npz, which the JAX package's jitted
    process_sequence made on the CPU from the same PNGs
    (tests/_torch_golden.py). Gates (tools/golden.py `check`, the
    tolerances of tests/test_torch_stereo_path.py): the decoded inputs
    equal the golden's (checked before the drive); the configuration and
    the dataset's arguments the golden's; tracking, fused and inlier
    counts equal on every frame; poses within 1e-4 m and 1e-5 in rotation
    entries; the same keyframes, each one's mm depth in the fusion DB
    equal; the map's counters equal. Then the run's keyframes fused anew
    at the golden's poses (`replay_map`): every block key, slot and stamp
    the golden's, and per block the weight sum equal and the tsdf sum
    within 512 x 5e-5 on >= 99% of the blocks; and the drive's own map,
    fused at poses that part from JAX's by up to 6.7e-5 m: keys, slots and
    stamps on >= 99.9% of the blocks, the per-block sums on >= 90%. The
    shares are documented tie tolerances in place of 99.9% (tools/golden.py:
    jitted XLA contracts the voxel projection into FMAs and sums the VO's
    normal equations in another order, and a voxel within the last bits of
    a pixel edge samples the other pixel; observed 99.491% of the replay's
    blocks, 9831 of the drive's 9832 blocks at the golden's keys and
    94.447% within). Launch identity per fused keyframe: CV 1, B3 3, the
    tail 1, B1 1, B2 0, with the counts set to 0 just before the drive and
    read just after (the replay's B1 launches come after the read)."""
    from denseslam_tpu_torch import kernels
    from denseslam_tpu_torch.io import convert
    from denseslam_tpu_torch.models import dense_slam, frontend
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops
    from denseslam_tpu_torch.tools import golden

    g = golden.load(GOLDEN)
    lefts, rights = frames
    inputs = golden.input_digest(lefts.cpu().numpy(), rights.cpu().numpy())
    if not np.array_equal(inputs, g["inputs"]):
        off = np.flatnonzero((inputs != g["inputs"]).any(axis=1))
        raise AssertionError("jax_golden: inputs differ from the golden's "
                             f"(frames {off.tolist()})")
    cfg = drive_config("stereo")
    if (golden.config_json(convert.config_from_dict(g["meta"]["config"]))
            != golden.config_json(cfg)
            or g["meta"]["kitti_args"] != CLI_KITTI_ARGS):
        raise AssertionError("jax_golden: the golden was made for another "
                             "configuration or sequence")
    st = frontend.init_frontend(cfg, device=dev)
    m = tsdf_ops.make_map(cfg.tsdf, device=dev)
    db = dense_slam.make_fusion_db(cfg, device=dev)
    fids = torch.arange(lefts.shape[0], dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    _, m, db, stats = dense_slam.process_sequence(st, m, db, lefts, rights,
                                                  fids, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    fused = int(stats["fused"].sum())
    want = dict(tile_sample=fused, tile_sample_rgb=0, sgm_path=3 * fused,
                sgm_final=fused, cost_volume=fused)
    rec = golden.run_record(
        {k: v.cpu().numpy() for k, v in stats.items()
         if k in ("T_wc", "tracking_ok", "fused", "num_inliers")},
        convert.map_state_to_numpy(m), convert.fusion_db_to_numpy(db),
        inputs)
    del m
    replay = golden.replay_map(db, lefts, g["T_wc"], cfg)
    rec.update({"replay_" + k: v for k, v in golden.map_digest(
        convert.map_state_to_numpy(replay)).items()})
    del replay
    try:
        report, failed = golden.check(g, rec), []
    except golden.GoldenMismatch as e:
        report, failed = e.report, e.failed
    emit(dict(phase="jax_golden", frames=len(fids), fused=fused,
              launches=launches, launches_want=want, **report,
              golden_commit=g["meta"]["commit"], seconds=secs, gpu=gpu))
    if fused == 0 or launches != want:
        raise AssertionError(f"jax_golden: launches {launches}, want {want}")
    if failed:
        raise AssertionError(f"jax_golden: gates failed: {failed}")
    return dict(launches=launches)


def cli_map_flags():
    """drive_config's map in the command line's flags, where it has one: 6
    cm voxels, 40 m, 2^17 slots, 2^13 visible blocks, decay 30 / 2, window
    60, a keyframe every 4 frames, corrections 5 from the 4th."""
    return ["--voxel_size", "0.06", "--max_depth", "40",
            "--table_slots_log2", "17", "--max_visible_log2", "13",
            "--voxel_decay", "--min_decay_age", "30", "--max_decay_weight",
            "2", "--slide_window", "--slide_window_max_age", "60",
            "--keyframe_every", "4", "--correction_num", "5",
            "--start_correction_num", "4", "--quiet"]


class CliCapture:
    """Instruments in-process runs of the command line: records the
    DenseSLAM and SLAMSystem objects they build, each frame's telemetry
    (DenseSLAM.process_frame) and each chunk's tracking flags, counts the
    DB entries purge_keyframes drops, and keeps, before each raycast depth
    dump, depth_to_png16 of the same render, which the PNG must read back
    to."""

    def __enter__(self):
        from denseslam_tpu_torch.models import dense_slam as ds
        from denseslam_tpu_torch.models import system as sy
        from denseslam_tpu_torch.ops import raycast as rc

        self.slams, self.systems, self.outs, self.chunk_ok = [], [], [], []
        self.purged, self.expected = 0, {}
        cap = self
        orig = self._orig = {
            (cls, name): getattr(cls, name)
            for cls, name in ((ds.DenseSLAM, "__init__"),
                              (ds.DenseSLAM, "process_frame"),
                              (ds.DenseSLAM, "purge_keyframes"),
                              (ds.DenseSLAM, "save_raycast_depth"),
                              (sy.SLAMSystem, "__init__"),
                              (sy.SLAMSystem, "process_chunk"))}

        def slam_init(s, *a, **kw):
            orig[ds.DenseSLAM, "__init__"](s, *a, **kw)
            cap.slams.append(s)

        def process_frame(s, *a, **kw):
            out = orig[ds.DenseSLAM, "process_frame"](s, *a, **kw)
            cap.outs.append(out)
            return out

        def purge(s, ids):
            before = int(s.db.valid.sum())
            orig[ds.DenseSLAM, "purge_keyframes"](s, ids)
            cap.purged += before - int(s.db.valid.sum())

        def save_depth(s, path, T_wc=None):
            cap.expected[path] = rc.depth_to_png16(
                s.raycast_view(T_wc).depth).cpu().numpy()
            orig[ds.DenseSLAM, "save_raycast_depth"](s, path, T_wc)

        def system_init(s, *a, **kw):
            orig[sy.SLAMSystem, "__init__"](s, *a, **kw)
            cap.systems.append(s)

        def chunk(s, *a, **kw):
            out = orig[sy.SLAMSystem, "process_chunk"](s, *a, **kw)
            cap.chunk_ok.append(np.asarray(out["tracking_ok_frames"]))
            return out

        for (cls, name), fn in zip(orig, (slam_init, process_frame, purge,
                                          save_depth, system_init, chunk)):
            setattr(cls, name, fn)
        return self

    def __exit__(self, *exc):
        for (cls, name), fn in self._orig.items():
            setattr(cls, name, fn)


def cli_run(argv):
    """One in-process run of denseslam_tpu_torch.main.main(argv) under a
    CliCapture, with the launch counts set to 0 just before and read just
    after. Returns the capture, the launches and the run's seconds."""
    from denseslam_tpu_torch import kernels
    from denseslam_tpu_torch.main import main as cli_main

    with CliCapture() as cap:
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        if cli_main(argv) != 0:
            raise AssertionError(f"the command line returned non-zero: {argv}")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
    return cap, launches, seconds


def cli_launch_check(cap, launches, fused):
    """The launch identity of a stereo CLI run: per fused keyframe 3 of B3
    and 1 of the tail; B1 once per fused keyframe, twice per re-fused and
    once per purged DB entry; never B2."""
    refused = sum(s.num_corrections for s in cap.systems)
    want = dict(tile_sample=fused + 2 * refused + cap.purged,
                tile_sample_rgb=0, sgm_path=3 * fused, sgm_final=fused,
                cost_volume=fused)
    if fused == 0 or launches != want:
        raise AssertionError(f"launches {launches}, want {want} ({fused} "
                             f"fused, {refused} re-fused, {cap.purged} "
                             "purged)")
    return refused


def jax_checkpoint_keys(n_submaps: int = 1) -> set:
    """The keys of the JAX package's checkpoint (denseslam_tpu/io/
    checkpoint.py) of a float32 map with no deferred corrections: 9 map
    and 6 DB leaves a submap, 21 frontend leaves (its PRNG key the 17th)."""
    keys = {"meta/num_submaps", "meta/global_poses", "meta/spawn_poses",
            "meta/anchor_frames", "meta/frame", "meta/keyframes",
            "meta/pose_frames", "meta/pose_mats"}
    for s in range(n_submaps):
        sfx = "" if s == 0 else str(s)
        keys |= {f"map{sfx}/{i}" for i in range(9)}
        keys |= {f"db{sfx}/{i}" for i in range(6)}
    return keys | {f"fe/{i}" for i in range(21)}


def run_cli(dev, gpu, kitti):
    """The command line on the KITTI-layout loop drive: CLI_RUN_FRAMES frames
    one at a time through SLAMSystem.process_frame (the drive's map flags,
    --sampler pallas --compute_depth --enable_backend --voxel_decay
    --slide_window --online_correction, the PD controller live) with every
    output. Gates: the launch identity, tracking >= 95%, ATE <= FRAME_ATE_M
    against the drive's poses, overflow 0, the TUM and KITTI trajectories
    and the memory log of CLI_RUN_FRAMES lines, a mesh of >= 1e4 triangles, one
    raycast PNG per fused keyframe reading back (io/png.py) to its render,
    and every key of the JAX summary."""
    from denseslam_tpu_torch.eval import traj_metrics
    from denseslam_tpu_torch.io import png, trajectory
    from denseslam_tpu_torch.utils.timing import TIMERS

    out = os.path.join(CLI_DIR, "out_cli")
    rdir = os.path.join(out, "raycast")
    argv = (["--dataset_root", kitti, "--frame_limit", str(CLI_RUN_FRAMES)]
            + cli_map_flags()
            + ["--sampler", "pallas", "--compute_depth", "--enable_backend",
               "--online_correction",
               "--save_trajectory", os.path.join(out, "traj.txt"),
               "--save_kitti_trajectory", os.path.join(out, "kitti.txt"),
               "--save_mesh", os.path.join(out, "mesh.obj"),
               "--save_composite", os.path.join(out, "composite.png"),
               "--save_raycast_depth_dir", rdir,
               "--save_raycast_rgb_dir", os.path.join(out, "raycast_rgb"),
               "--save_memory_log", os.path.join(out, "memory.txt"),
               "--checkpoint_out", os.path.join(out, "ckpt.npz"),
               "--metrics_json", os.path.join(out, "metrics.json")])
    os.makedirs(out, exist_ok=True)
    TIMERS.reset()
    cap, launches, seconds = cli_run(argv)
    timers = TIMERS.report().splitlines()
    outs = cap.outs
    fused_ids = [o["frame"] for o in outs if o["fused"]]
    fused = len(fused_ids)
    refused = cli_launch_check(cap, launches, fused)
    system = cap.systems[0]
    if system.backend.num_keyframes + system.num_culled != fused:
        raise AssertionError("a fused keyframe did not reach the backend")

    gt = trajectory.load_kitti(os.path.join(kitti, "poses.txt"))[
        :CLI_RUN_FRAMES]
    tum = trajectory.load_tum(os.path.join(out, "traj.txt"))
    est = trajectory.load_kitti(os.path.join(out, "kitti.txt"))
    mem = read_text(os.path.join(out, "memory.txt")).splitlines()
    ate = traj_metrics.ate_rmse(est, gt)
    track = float(np.mean([o["tracking_ok"] for o in outs[1:]]))
    overflow = int(system.slam.submaps.active.overflow)
    with open(os.path.join(out, "mesh.obj")) as fh:
        tris = sum(1 for ln in fh if ln.startswith("f "))
    names = sorted(os.listdir(rdir))
    png_ok = (names == [f"{f:06d}.png" for f in fused_ids] and all(
        np.array_equal(png.read_png(os.path.join(rdir, n)).astype(np.int64),
                       cap.expected[os.path.join(rdir, n)])
        for n in names))
    composite = png.read_png(os.path.join(out, "composite.png"))
    summary = json.loads(read_text(os.path.join(out, "metrics.json")))
    emit(dict(phase="cli", frames=len(outs), fused=fused, refused=refused,
              purged=cap.purged, launches=launches, tracking_ok_share=track,
              ate_rmse_m=ate, end_error_m=float(np.linalg.norm(
                  est[-1][:3, 3] - gt[len(est) - 1][:3, 3])),
              loops=system.num_loops, overflow=overflow, triangles=tris,
              raycast_pngs=len(names),
              composite_valid_share=float((composite > 0).mean()),
              fps=summary["fps"], mean_fusion_ms=summary["mean_fusion_ms"],
              seconds=seconds, summary=summary, timers=timers, gpu=gpu))
    gates = dict(tracking=track >= 0.95, ate=ate <= FRAME_ATE_M,
                 overflow=overflow == 0,
                 trajectories=len(tum) == len(est) == CLI_RUN_FRAMES,
                 memory_log=len(mem) == CLI_RUN_FRAMES,
                 mesh=tris >= 10_000, raycast_pngs=png_ok,
                 summary=set(SUMMARY_KEYS) <= set(summary)
                 and summary["frames"] == CLI_RUN_FRAMES)
    if not all(gates.values()):
        raise AssertionError(f"cli gates failed: {gates}")
    return dict(launches=launches, seconds=seconds)


def run_cli_chunk(dev, gpu, kitti, frames):
    """The same sequence through the command line's chunk path (--chunk 64
    --compute_depth --sampler pallas: one SLAMSystem.process_chunk); the
    launch identity of `cli`, tracking >= 95%, and the poses equal bit for
    bit to SLAMSystem.process_chunk called directly, with the same seed,
    on the frames the dataset reader decodes (`frames`, decode_kitti's)."""
    from denseslam_tpu_torch import main as cli
    from denseslam_tpu_torch.io import datasets
    from denseslam_tpu_torch.models.system import SLAMSystem

    argv = (["--dataset_root", kitti, "--frame_limit", str(CLI_FRAMES)]
            + cli_map_flags()
            + ["--chunk", str(CLI_FRAMES), "--compute_depth", "--sampler",
               "pallas", "--online_correction"])
    cap, launches, seconds = cli_run(argv)
    system = cap.systems[0]
    fused = system.backend.num_keyframes + system.num_culled
    refused = cli_launch_check(cap, launches, fused)
    ok = np.concatenate(cap.chunk_ok)
    track = float(ok[1:].mean())
    via_cli = np.stack([T for _, T in system.trajectory()])

    inp = datasets.Input(kitti, datasets.kitti_odometry_config(),
                         frame_limit=CLI_FRAMES)
    cfg = cli.build_config(cli.build_parser().parse_args(argv), inp.rig)
    lefts, rights = frames
    direct = SLAMSystem(cfg, device=dev)
    direct.process_chunk(lefts, rights)
    direct_T = np.stack([T for _, T in direct.trajectory()])
    equal = via_cli.shape == direct_T.shape and np.array_equal(via_cli,
                                                               direct_T)
    emit(dict(phase="cli_chunk", frames=len(via_cli), fused=fused,
              refused=refused, purged=cap.purged, launches=launches,
              tracking_ok_share=track, poses_equal_process_chunk=equal,
              max_pose_diff=float(np.abs(via_cli - direct_T).max())
              if via_cli.shape == direct_T.shape else None,
              seconds=seconds, gpu=gpu))
    if track < 0.95 or not equal:
        raise AssertionError(f"cli_chunk: tracking {track}, poses equal "
                             f"{equal}")
    return dict(launches=launches)


def run_cli_resume(dev, gpu, kitti):
    """The sequence per frame without the backend (--sampler pallas
    --compute_depth, no --voxel_decay): its first CLI_RESUME_FRAMES frames
    uninterrupted, and as its first CLI_RESUME_AT frames with
    --checkpoint_out, then the rest resumed with --checkpoint_in
    --frame_offset CLI_RESUME_AT. Gates: the launch
    identity of the uninterrupted run (no re-fused or purged keyframes),
    its poses and final checkpoint (map, DB, frontend with its key,
    history) equal to the resumed run's bit for bit, and the checkpoint's
    keys those of the JAX layout."""
    out = os.path.join(CLI_DIR, "out_resume")
    os.makedirs(out, exist_ok=True)
    # without --voxel_decay: the command line runs the sequence-end decay
    # catch-up before it writes --checkpoint_out (as the JAX one does), so
    # a checkpoint written at a sequence's end holds a caught-up map that
    # an uninterrupted run never has
    base = (["--dataset_root", kitti]
            + [f for f in cli_map_flags() if f != "--voxel_decay"]
            + ["--sampler", "pallas", "--compute_depth"])
    path = lambda n: os.path.join(out, n)  # noqa: E731
    cap, launches, seconds = cli_run(
        base + ["--frame_limit", str(CLI_RESUME_FRAMES), "--checkpoint_out",
                path("whole.npz"), "--save_kitti_trajectory",
                path("whole.txt")])
    fused = sum(o["fused"] for o in cap.outs)
    cli_launch_check(cap, launches, fused)
    track = float(np.mean([o["tracking_ok"] for o in cap.outs[1:]]))
    cli_run(base + ["--frame_limit", str(CLI_RESUME_AT), "--checkpoint_out",
                    path("first.npz")])
    cli_run(base + ["--frame_limit", str(CLI_RESUME_FRAMES - CLI_RESUME_AT),
                    "--frame_offset", str(CLI_RESUME_AT), "--checkpoint_in",
                    path("first.npz"), "--checkpoint_out", path("resumed.npz"),
                    "--save_kitti_trajectory", path("resumed.txt")])
    with np.load(path("whole.npz")) as za, np.load(path("resumed.npz")) as zb:
        a, b = dict(za), dict(zb)
    differ = sorted(k for k in a if k not in b or not (
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])))
    want_keys = jax_checkpoint_keys()
    poses_equal = read_text(path("whole.txt")) == read_text(path("resumed.txt"))
    emit(dict(phase="cli_resume", frames=CLI_RESUME_FRAMES,
              resumed_at=CLI_RESUME_AT, fused=fused, launches=launches,
              tracking_ok_share=track, poses_equal=poses_equal,
              checkpoint_keys=len(a), differing_keys=differ,
              seconds=seconds, gpu=gpu))
    gates = dict(poses=poses_equal, state=not differ and set(a) == set(b),
                 keys=set(a) == want_keys,
                 tracking=track >= 0.95)
    if not all(gates.values()):
        raise AssertionError(f"cli_resume gates failed: {gates}")
    return dict(launches=launches)


def run_cli_rgbd(dev, gpu, tum):
    """The TUM-layout sequence through the command line's RGB-D path
    (--dataset_type tum --sensor rgbd --sampler pallas --use_color):
    DenseSLAM.process_frame's RGB-D VO branch with the dataset's depth.
    Gates: tracking >= 95%, B1 once per fused keyframe and no other kernel,
    the final position within 3% of the distance travelled."""
    from denseslam_tpu_torch.io import trajectory

    out = os.path.join(CLI_DIR, "out_rgbd")
    os.makedirs(out, exist_ok=True)
    argv = ["--dataset_root", tum, "--dataset_type", "tum", "--sensor",
            "rgbd", "--sampler", "pallas", "--use_color", "--max_depth",
            "10", "--max_visible_log2", "13", "--quiet",
            "--save_trajectory", os.path.join(out, "traj.txt")]
    cap, launches, seconds = cli_run(argv)
    fused = sum(o["fused"] for o in cap.outs)
    want = dict(tile_sample=fused, tile_sample_rgb=0, sgm_path=0, sgm_final=0,
                cost_volume=0)
    if fused == 0 or launches != want:
        raise AssertionError(f"cli_rgbd launches {launches}, want {want}")
    track = float(np.mean([o["tracking_ok"] for o in cap.outs[1:]]))
    gt = np.stack(trajectory.load_kitti(os.path.join(tum, "poses.txt")))
    est = torch.tensor(np.stack([T for _, T in trajectory.load_tum(
        os.path.join(out, "traj.txt"))]))
    traj = trajectory_gates(est, gt)
    emit(dict(phase="cli_rgbd", frames=len(cap.outs), fused=fused,
              launches=launches, tracking_ok_share=track, **traj,
              seconds=seconds, gpu=gpu))
    if track < 0.95:
        raise AssertionError(f"cli_rgbd tracking held on {track:.3f}")
    return dict(launches=launches)


def run_cli_cpu_reference(dev, gpu, kitti):
    """The `cli` command's first CLI_CPU_FRAMES frames on the card and with
    --device cpu (the CPU run with --profile_dir): poses within 1 mm /
    1e-4 rad. Both runs draw their RANSAC and verification hypotheses from
    the same threefry keys (made on the host, as the JAX package's) and
    hold the PD controller's budget at 1 (it reads wall time)."""
    from denseslam_tpu_torch.models.system import PDController

    argv = (["--dataset_root", kitti, "--frame_limit", str(CLI_CPU_FRAMES)]
            + cli_map_flags()
            + ["--sampler", "pallas", "--compute_depth", "--enable_backend",
               "--online_correction"])
    update = PDController.update
    poses, seconds = {}, {}
    try:
        PDController.update = lambda self, ms: self.scale
        for where in ("cuda", "cpu"):
            extra = (["--device", "cpu", "--profile_dir",
                      os.path.join(CLI_DIR, "profile_cpu")]
                     if where == "cpu" else [])
            cap, _, seconds[where] = cli_run(argv + extra)
            poses[where] = torch.tensor(np.stack(
                [T for _, T in cap.slams[0].trajectory()]))
    finally:
        PDController.update = update
    t_err, r_err = pose_errors(poses["cuda"], poses["cpu"], "CLI")
    trace = os.path.join(CLI_DIR, "profile_cpu", "trace.json")
    emit(dict(phase="cli_cpu_reference", frames=CLI_CPU_FRAMES,
              pose_err_m=t_err, pose_err_rad=r_err,
              trace_bytes=os.path.getsize(trace), seconds=seconds, gpu=gpu))


VIEWER_FRAMES = 16
VIEWER_EVERY = 4
# the panes the per-frame path serves with --compute_depth (no input depth)
VIEWER_PANES = ("input_rgb", "scene_flow", "raycast", "raycast_depth",
                "freeview")
TOOLS_FRAMES = 8
# A4's drift golden (tests/test_vo_numerics.py:185-238) at its own size
DRIFT_FRAMES = 96
DRIFT_T_ERR_PCT = 0.6
DRIFT_END_PCT = 0.8


def free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def avi_chunks(path: str):
    """The `00dc` chunks of a RIFF AVI (its LISTs walked) and the entries
    of its `idx1`, read here without the writer's code."""
    import struct

    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise AssertionError(f"{path} is not a RIFF AVI")
    chunks, index = [], []

    def walk(pos, end):
        while pos + 8 <= end:
            fourcc = data[pos:pos + 4]
            size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
            body = pos + 8
            if fourcc == b"LIST":
                walk(body + 4, body + size)
            elif fourcc == b"00dc":
                chunks.append(data[body:body + size])
            elif fourcc == b"idx1":
                index.extend(data[body + k:body + k + 4]
                             for k in range(0, size, 16))
            pos = body + size + (size & 1)

    walk(12, len(data))
    return chunks, index


class ViewerClient:
    """A dashboard client in a thread of its own while the command line
    runs: polls the live viewer's /state every 50 ms, fetches every pane it
    lists and decodes it (io/png.py), sends one /freeview/nav once panes
    appear, starts a /record of the freeview pane once that pane appears
    and stops it after two recorded frames. Connection errors end it once
    the viewer has answered (the run closed it); any other error is kept
    in `error`."""

    def __init__(self, port: int):
        import threading
        self.port = port
        self.done = threading.Event()
        self.panes, self.states, self.last = {}, 0, None
        self.nav = self.record = self.stopped = self.error = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _get(self, path: str) -> bytes:
        import urllib.request
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}",
                                    timeout=10) as r:
            return r.read()

    def _poll(self) -> None:
        from denseslam_tpu_torch.io import png
        st = json.loads(self._get("/state"))
        self.states += 1
        self.last = st
        for name in st["panes"]:
            img = png.decode_png(self._get(f"/pane/{name}"))
            self.panes[name] = dict(shape=list(img.shape),
                                    nonzero=float((img > 0).mean()))
        if st["panes"] and self.nav is None:
            self.nav = json.loads(self._get("/freeview/nav?daz=0.4&del=0.1"))
        if "freeview" in st["panes"] and self.record is None:
            self.record = json.loads(self._get(
                "/record?action=start&pane=freeview"))
        if (self.record is not None and self.stopped is None
                and st["recorded_frames"] >= 2):
            self.stopped = json.loads(self._get("/record?action=stop"))

    def _run(self) -> None:
        import urllib.error
        while not self.done.is_set():
            try:
                self._poll()
            except (urllib.error.URLError, ConnectionError):
                if self.states:
                    return
                time.sleep(0.05)
                continue
            except Exception as e:             # kept, and failed on below
                self.error = repr(e)
                return
            time.sleep(0.05)

    def close(self) -> None:
        self.done.set()
        self.thread.join(timeout=30)


def run_viewer(dev, gpu, kitti, cli_rec):
    """The command line with the live viewer: the first VIEWER_FRAMES
    frames of the `cli` sequence with its flags and --live_viewer on a free
    port, --viewer_every VIEWER_EVERY, a ViewerClient polling it; the
    launch counts set to 0 just before and read just after. Gates: the
    launch identity of `cli`, tracking >= 95%, every pane of VIEWER_PANES
    fetched, decoded at the sequence's size and not all zero, the free
    camera moved
    and its pane served, a recording of >= 2 frames started and stopped,
    its .avi's `idx1` entries as many as the recorded frames and its `00dc`
    chunks, each a JPEG (FFD8 ... FFD9). Prints the viewer's added wall
    seconds a frame (against the same frames run without it just before)
    and `cli`'s seconds a frame."""
    out = os.path.join(CLI_DIR, "out_viewer")
    os.makedirs(out, exist_ok=True)
    port = free_port()
    argv = (["--dataset_root", kitti, "--frame_limit", str(VIEWER_FRAMES)]
            + cli_map_flags()
            + ["--sampler", "pallas", "--compute_depth", "--enable_backend",
               "--online_correction", "--live_viewer", str(port),
               "--viewer_every", str(VIEWER_EVERY)])
    # the same frames without the viewer first: its added seconds a frame
    plain_s = cli_run(argv[:argv.index("--live_viewer")])[2]
    cwd = os.getcwd()
    os.chdir(out)                     # recordings land in the working dir
    client = ViewerClient(port)
    try:
        cap, launches, seconds = cli_run(argv)
    finally:
        client.close()
        os.chdir(cwd)
    outs = cap.outs
    fused = sum(o["fused"] for o in outs)
    refused = cli_launch_check(cap, launches, fused)
    track = float(np.mean([o["tracking_ok"] for o in outs[1:]]))
    rec_path = (os.path.normpath(os.path.join(out, client.record["path"]))
                if client.record and client.record.get("path") else None)
    chunks, index = avi_chunks(rec_path) if rec_path else ([], [])
    recorded = client.stopped["frames"] if client.stopped else 0
    cli_s_frame = cli_rec["seconds"] / CLI_RUN_FRAMES
    emit(dict(phase="viewer", frames=len(outs), fused=fused, refused=refused,
              launches=launches, tracking_ok_share=track, states=client.states,
              panes=client.panes, recording=rec_path, recorded_frames=recorded,
              avi_chunks=len(chunks), avi_index=len(index),
              avi_bytes=(os.path.getsize(rec_path) if rec_path else 0),
              seconds=seconds, s_per_frame=seconds / len(outs),
              plain_s_per_frame=plain_s / len(outs),
              viewer_added_s_per_frame=(seconds - plain_s) / len(outs),
              cli_s_per_frame=cli_s_frame, cli_fps=1.0 / cli_s_frame,
              client_error=client.error, gpu=gpu))
    from denseslam_tpu_torch.io import png
    hw = list(png.read_png(os.path.join(kitti, "image_0",
                                        "000000.png")).shape[:2])
    shapes_ok = all(
        name in client.panes and client.panes[name]["shape"][:2] == hw
        and client.panes[name]["nonzero"] > 0 for name in VIEWER_PANES)
    gates = dict(
        client=(client.error is None and client.states >= 1
                and not client.thread.is_alive()),
        tracking=track >= 0.95, frames=len(outs) == VIEWER_FRAMES,
        panes=shapes_ok, nav=client.nav is not None,
        record=(recorded >= 2 and client.record is not None
                and client.record["recording"] == "freeview"),
        avi=(len(index) == len(chunks) == recorded
             and all(c[:2] == b"\xff\xd8" and c[-2:] == b"\xff\xd9"
                     for c in chunks)))
    if not all(gates.values()):
        raise AssertionError(f"viewer gates failed: {gates}")
    return dict(launches=launches)


def run_tools(dev, gpu, kitti):
    """tools/scale_sequence.py --scale 0.5 on the `cli` sequence into
    build/cli/kitti_half, read back: calib.txt's P rows scaled by 0.5
    (the baseline kept), every image and disparity PFM at half size, the
    disparities halved; then the command line on its first TOOLS_FRAMES
    frames (the `cli` map flags, --sampler pallas --compute_depth, no
    backend), the launch counts set to 0 just before and read just after:
    the launch identity, tracking on every frame."""
    import shutil

    from denseslam_tpu_torch.eval import traj_metrics
    from denseslam_tpu_torch.io import datasets, pfm, png, trajectory
    from denseslam_tpu_torch.tools import scale_sequence

    half = os.path.join(CLI_DIR, "kitti_half")
    shutil.rmtree(half, ignore_errors=True)
    t0 = time.perf_counter()
    if scale_sequence.main([kitti, half, "--scale", "0.5"]) != 0:
        raise AssertionError("scale_sequence returned non-zero")
    scale_s = time.perf_counter() - t0
    (fi, fb), (hi, hb) = (datasets.read_kitti_calib(os.path.join(
        d, "calib.txt")) for d in (kitti, half))
    calib_ok = (all(abs(2 * getattr(hi, k) - getattr(fi, k)) <= 1e-9
                    * abs(getattr(fi, k)) for k in ("fx", "fy", "cx", "cy"))
                and abs(hb - fb) <= 1e-9 * fb)
    fh, fw = png.read_png(os.path.join(kitti, "image_0",
                                       "000000.png")).shape[:2]
    size = (round(fw * 0.5), round(fh * 0.5))
    shapes, disp_ok = set(), True
    for folder in ("image_0", "image_1", "precomputed-depth"):
        names = sorted(os.listdir(os.path.join(kitti, folder)))
        if sorted(os.listdir(os.path.join(half, folder))) != names:
            raise AssertionError(f"{folder}: the copy lacks files")
        for name in names[:2] + names[-1:]:
            a, b = (os.path.join(d, folder, name) for d in (kitti, half))
            if name.endswith(".pfm"):
                full, small = pfm.read_pfm(a), pfm.read_pfm(b)
                disp_ok &= bool(np.array_equal(
                    small, png.resize_nearest(full, size)
                    * np.float32(0.5)))
            else:
                small = png.read_png(b)
            shapes.add(small.shape)
    cap, launches, seconds = cli_run(
        ["--dataset_root", half, "--frame_limit", str(TOOLS_FRAMES)]
        + cli_map_flags() + ["--sampler", "pallas", "--compute_depth"])
    outs = cap.outs
    fused = sum(o["fused"] for o in outs)
    cli_launch_check(cap, launches, fused)
    # the tool copies no poses.txt (scripts/scale_sequence.py's list)
    gt = trajectory.load_kitti(os.path.join(kitti, "poses.txt"))
    est = [o["T_wc"] for o in outs]
    emit(dict(phase="tools", scale_s=scale_s, calib=dict(
                  fx=[fi.fx, hi.fx], cx=[fi.cx, hi.cx], baseline=[fb, hb]),
              shapes=sorted(list(x) for x in shapes), frames=len(outs),
              fused=fused, launches=launches,
              tracking=[bool(o["tracking_ok"]) for o in outs],
              ate_rmse_m=traj_metrics.ate_rmse(est, gt[:len(est)]),
              seconds=seconds, gpu=gpu))
    gates = dict(calib=calib_ok, shapes=shapes == {size[::-1]},
                 disparities=disp_ok, frames=len(outs) == TOOLS_FRAMES,
                 tracking=all(o["tracking_ok"] for o in outs[1:]))
    if not all(gates.values()):
        raise AssertionError(f"tools gates failed: {gates}")
    return dict(launches=launches)


EXP_DIR = os.path.join(ROOT, "build", "exp")
DEMO_DIR = os.path.join(ROOT, "build", "demo")
EXP_SHORT = 32           # the odo, lowfreq and decay runs: the first frames
# the JAX demo's own scores: scripts/run_demo.py at its defaults (20
# frames, 320x240), run unmodified on the CPU (PERF.md section 6);
# the card's demo is held within twice its ATE and 0.02 of its d1.25
DEMO_JAX_ATE_M = 0.004860936510476883
DEMO_JAX_D125 = 0.9557889955424533
DEMO_ATE_M = 2 * DEMO_JAX_ATE_M
DEMO_D125 = DEMO_JAX_D125 - 0.02


class ToolRuns:
    """Instruments the experiment tools' runs of the command line
    (tools/common.py `run_main`): for each run, its argv, each frame's
    tracking flag and whether it fused (DenseSLAM.process_frame), its
    launches (the counts set to 0 just before the run and read just
    after), its seconds, and torch.cuda.memory_allocated before it and
    after it (after the tool has freed the run's map; before it, after a
    collection of what earlier phases left). It keeps no reference to a
    run's objects."""

    def __enter__(self):
        import gc

        from denseslam_tpu_torch import kernels
        from denseslam_tpu_torch.models import dense_slam as ds
        from denseslam_tpu_torch.tools import common

        self.runs, frames = [], []
        self._orig = orig_run, orig_pf = (common.run_main,
                                          ds.DenseSLAM.process_frame)
        runs = self.runs

        def process_frame(s, *a, **kw):
            out = orig_pf(s, *a, **kw)
            frames.append((bool(out["tracking_ok"]), bool(out["fused"])))
            return out

        def run_main(argv, device=None):
            frames.clear()
            gc.collect()         # what earlier phases left for the collector
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            kernels.reset_counts()
            t0 = time.perf_counter()
            rc = orig_run(argv, device)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(kernels.launch_counts)
            runs.append(dict(argv=list(argv), rc=rc,
                             tracking=[f[0] for f in frames],
                             fused=sum(f[1] for f in frames),
                             launches=launches, seconds=seconds,
                             before=before,
                             after=torch.cuda.memory_allocated()))
            return rc

        common.run_main = run_main
        ds.DenseSLAM.process_frame = process_frame
        return self

    def __exit__(self, *exc):
        from denseslam_tpu_torch.models import dense_slam as ds
        from denseslam_tpu_torch.tools import common
        common.run_main, ds.DenseSLAM.process_frame = self._orig


def tool_call(runs: ToolRuns, name: str, argv, tool_s: dict):
    """`denseslam_tpu_torch.tools.<name>.main(argv)` under `runs`, timed;
    returns the runs it made."""
    import importlib

    mod = importlib.import_module(f"denseslam_tpu_torch.tools.{name}")
    k = len(runs.runs)
    t0 = time.perf_counter()
    rc = mod.main(argv)
    tool_s[name] = tool_s.get(name, 0.0) + time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{name} returned {rc}: {argv}")
    return runs.runs[k:]


def write_ground_truth(kitti: str, dev, frames: int):
    """What the scoring tools read beside the `cli` sequence: poses_gt.txt
    (its poses.txt) and depth_gt/ for its first `frames` frames (depth x
    256 as 16-bit PNGs, rendered by io/synthetic.py at the true poses)."""
    import shutil

    from denseslam_tpu_torch.io import datasets, png, synthetic
    from denseslam_tpu_torch.io.make_dataset import (poses_and_scene,
                                                     write_depth_gt)

    shutil.copyfile(os.path.join(kitti, "poses.txt"),
                    os.path.join(kitti, "poses_gt.txt"))
    poses, scene = poses_and_scene(["unused"] + CLI_KITTI_ARGS)
    h, w = png.read_png(os.path.join(kitti, "image_0", "000000.png")).shape
    intr, _ = datasets.read_kitti_calib(os.path.join(kitti, "calib.txt"))
    intr = intr._replace(width=w, height=h)
    _, depth = synthetic.render_trajectory(poses[:frames], intr, scene,
                                           device=dev)
    gtdir = os.path.join(kitti, "depth_gt")
    os.makedirs(gtdir, exist_ok=True)
    for i in range(frames):
        write_depth_gt(os.path.join(gtdir, f"{i:06d}.png"),
                       depth[i].cpu().numpy())
    return gtdir


def run_experiments(dev, gpu, kitti):
    """The experiment tools (denseslam_tpu_torch/tools/) on the card, in
    process, each run of the command line instrumented by ToolRuns: the
    demo; the four-profile regularisation sweep (tracking_exp) over the
    `cli` sequence's 64 frames at the CLI's decay defaults; memory_draw
    over its four logs; odo_exp --compute_depth over 32 frames (the
    phase's kernel path); lowfreq_exp at k = 1 and 4 and decay_exp at one
    point and its baseline, over 32 frames, and eval_raycast_depth on
    raycast_k1 against the ground truth this phase writes; contact_sheet
    on the `cli` run's checkpoint; prepare_dataset validate on both
    sequences. Gates in the docstring's phase list."""
    import gc
    import math
    import shutil

    from denseslam_tpu_torch.eval import depth_metrics, traj_metrics
    from denseslam_tpu_torch.io import plot, png, trajectory
    from denseslam_tpu_torch.tools import contact_sheet, memory_draw

    shutil.rmtree(EXP_DIR, ignore_errors=True)
    shutil.rmtree(DEMO_DIR, ignore_errors=True)
    os.makedirs(EXP_DIR)
    tool_s = {}
    gtdir = write_ground_truth(kitti, dev, EXP_SHORT)
    gt = trajectory.load_kitti(os.path.join(kitti, "poses_gt.txt"))
    gates, rec = {}, dict(phase="experiments")

    def metrics(path):
        return json.loads(read_text(path))

    def run_rec(run, m):
        return dict(frames=len(run["tracking"]), fused=run["fused"],
                    tracking_ok_share=float(np.mean(run["tracking"][1:])),
                    fps=m["fps"], final_blocks=m["final_blocks"],
                    final_memory_mb=m["final_memory_mb"],
                    device_memory_mb=m["device_memory_mb"],
                    seconds=run["seconds"],
                    memory_kept_bytes=run["after"] - run["before"])

    def freed(run, m):
        return abs(run["after"] - run["before"]) <= 0.01 * (
            m["device_memory_mb"] * 1e6)

    with ToolRuns() as runs:
        # (a) the demo at the JAX defaults
        demo_runs = tool_call(runs, "run_demo", ["--workdir", DEMO_DIR],
                              tool_s)
        out = os.path.join(DEMO_DIR, "out")
        ts = metrics(os.path.join(out, "trajectory_scores.json"))
        ds_ = metrics(os.path.join(out, "depth_scores.json"))["raycast"]
        rec["demo"] = dict(trajectory=ts, depth=ds_,
                           jax_cpu=dict(ate_rmse_m=DEMO_JAX_ATE_M,
                                        d1_25=DEMO_JAX_D125),
                           launches=demo_runs[0]["launches"])
        gates["demo"] = (len(demo_runs) == 1
                         and all(math.isfinite(v) for v in ts.values())
                         and all(math.isfinite(v) for v in ds_.values())
                         and ts["ate_rmse_m"] <= DEMO_ATE_M
                         and ds_["d1_25"] >= DEMO_D125)

        # (b) the four profiles at full width
        tdir = os.path.join(EXP_DIR, "tracking")
        from denseslam_tpu_torch.tools.tracking_exp import PROFILES
        trk = tool_call(runs, "tracking_exp", [
            kitti, "--out", tdir, "--dataset_type", "kitti_odometry",
            "--frames", str(CLI_FRAMES), "--min_decay_age", "30",
            "--max_decay_weight", "2"], tool_s)
        sweep = metrics(os.path.join(tdir, "sweep.json"))
        logs = [os.path.join(tdir, f"memory_kitti_{p}.txt") for p in PROFILES]
        curves = {p: [float(v) for v in read_text(lg).split()]
                  for p, lg in zip(PROFILES, logs)}
        blocks = {m["profile"]: m["final_blocks"] for m in sweep}
        profiles = {}
        for p, run, m in zip(PROFILES, trk, sweep):
            est = trajectory.load_kitti(os.path.join(tdir,
                                                     f"kitti_{p}_traj.txt"))
            profiles[p] = dict(run_rec(run, m),
                               ate_rmse_m=traj_metrics.ate_rmse(
                                   est, gt[:len(est)]),
                               launches=run["launches"], freed=freed(run, m))
        rec["tracking"] = profiles
        gates["tracking_runs"] = [m["profile"] for m in sweep] == list(
            PROFILES) and len(trk) == 4
        gates["memory_logs"] = all(len(c) == CLI_FRAMES
                                   for c in curves.values())
        gates["tracking"] = all(v["tracking_ok_share"] >= 0.95
                                and v["ate_rmse_m"] <= FRAME_ATE_M
                                for v in profiles.values())
        gates["none_never_falls"] = bool(np.all(np.diff(curves["none"])
                                                >= 0))
        gates["blocks_order"] = (blocks["decay"] < blocks["none"]
                                 and blocks["decay_slide"] <= blocks["decay"]
                                 and blocks["slide"] <= blocks["none"])

        # (c) the figure
        fig = os.path.join(EXP_DIR, "memory.png")
        t0 = time.perf_counter()
        if memory_draw.main([fig] + logs) != 0:
            raise AssertionError("memory_draw returned non-zero")
        tool_s["memory_draw"] = time.perf_counter() - t0
        img = plot.read_rgb(fig)
        want, (x0, y0, x1, y1) = memory_draw.figure(logs)
        inside = img[y0 + 1:y1, x0 + 1:x1]
        colours = [bool((inside == c).all(-1).any())
                   for c in plot.TAB10[:len(logs)]]
        rec["figure"] = dict(path=os.path.relpath(fig, ROOT),
                             shape=list(img.shape), colours_inside=colours)
        gates["figure"] = (img.shape == (memory_draw.FIG_H,
                                         memory_draw.FIG_W, 3)
                           and np.array_equal(img, want) and all(colours))

        # (d) the kernel path: SGM on every fused frame
        odir = os.path.join(EXP_DIR, "odo")
        odo = tool_call(runs, "odo_exp", [kitti, "--out", odir, "--frames",
                                          str(EXP_SHORT), "--compute_depth"],
                        tool_s)
        entry = metrics(os.path.join(odir, "odo_summary.json"))["kitti"]
        fused = odo[0]["fused"]
        want_l = dict(tile_sample=0, tile_sample_rgb=0, sgm_path=3 * fused,
                      sgm_final=fused,
                      cost_volume=fused)
        rec["odo"] = dict(entry, fused=fused, launches=odo[0]["launches"],
                          tracking_ok_share=float(np.mean(
                              odo[0]["tracking"][1:])),
                          seconds=odo[0]["seconds"])
        gates["odo_launches"] = fused > 0 and odo[0]["launches"] == want_l
        gates["odo_summary"] = ({"ate_rmse_m", "rpe_trans_rmse",
                                 "rpe_rot_rmse", "kitti_t_err_pct",
                                 "kitti_r_err_deg_per_m"} <= set(entry)
                                and entry["ate_rmse_m"] <= FRAME_VO_ATE_M)

        # (e) the other two sweeps, cut in depth
        ldir = os.path.join(EXP_DIR, "lowfreq")
        low = tool_call(runs, "lowfreq_exp", [kitti, ldir, "--ks", "1", "4",
                                              "--frames", str(EXP_SHORT)],
                        tool_s)
        lsweep = metrics(os.path.join(ldir, "lowfreq_sweep.json"))
        rec["lowfreq"] = {f"k{m['keyframe_every']}": run_rec(run, m)
                          for run, m in zip(low, lsweep)}
        k1 = os.path.join(ldir, "raycast_k1")
        gates["lowfreq"] = (
            len(low) == 2 and low[1]["fused"] == -(-low[0]["fused"] // 4)
            and len(os.listdir(k1)) == low[0]["fused"]
            and all(len(r["tracking"]) == EXP_SHORT for r in low))
        ddir = os.path.join(EXP_DIR, "decay")
        dec = tool_call(runs, "decay_exp", [kitti, ddir, "--ages", "30",
                                            "--weights", "2", "--frames",
                                            str(EXP_SHORT)], tool_s)
        dm = metrics(os.path.join(ddir, "sweep.json"))[0]
        base = metrics(os.path.join(ddir, "baseline.json"))
        rec["decay"] = dict(decay_a30_w2=run_rec(dec[0], dm),
                            baseline=run_rec(dec[1], base))
        gates["decay"] = (len(dec) == 2
                          and dm["final_blocks"] < base["final_blocks"])
        eval_json = os.path.join(EXP_DIR, "raycast_k1_depth.json")
        t0 = time.perf_counter()
        from denseslam_tpu_torch.tools import eval_raycast_depth
        if eval_raycast_depth.main([k1, gtdir, "--out", eval_json]) != 0:
            raise AssertionError("eval_raycast_depth returned non-zero")
        tool_s["eval_raycast_depth"] = time.perf_counter() - t0
        names = sorted(n for n in os.listdir(k1)
                       if os.path.exists(os.path.join(gtdir, n)))
        accs = [depth_metrics.depth_metrics(
            png.read_png(os.path.join(k1, n)).astype(np.float32) / 256.0,
            png.read_png(os.path.join(gtdir, n)).astype(np.float32) / 256.0,
            crop=True) for n in names]
        direct = {"raycast": dict(
            {k: float(np.nanmean([a[k] for a in accs]))
             for k in accs[0] if k != "n"}, frames=len(accs))}
        rec["raycast_k1_depth"] = direct["raycast"]
        gates["eval_raycast_depth"] = (
            len(names) == low[0]["fused"]
            and read_text(eval_json) == json.dumps(direct, indent=2))
        runs_all = list(runs.runs)

    # (f) the contact sheet of the `cli` run's map
    ckpt = os.path.join(CLI_DIR, "out_cli", "ckpt.npz")
    sheet_png = os.path.join(EXP_DIR, "sheet.png")
    h, w = png.read_png(os.path.join(kitti, "image_0", "000000.png")).shape
    sargs = [ckpt, sheet_png, "--memory-log",
             os.path.join(CLI_DIR, "out_cli", "memory.txt"), "--width",
             str(w), "--height", str(h), "--voxel-size", "0.06",
             "--table-log2", "17", "--max-depth", "40"]
    t0 = time.perf_counter()
    if contact_sheet.main(sargs) != 0:
        raise AssertionError("contact_sheet returned non-zero")
    tool_s["contact_sheet"] = time.perf_counter() - t0
    sheet = plot.read_rgb(sheet_png)
    rects = contact_sheet.layout(w, h)
    from denseslam_tpu_torch.config import tiny_test_config
    from denseslam_tpu_torch.io.checkpoint import load_slam_checkpoint
    from denseslam_tpu_torch.models.dense_slam import DenseSLAM
    from denseslam_tpu_torch.ops import raycast as rc_ops
    scfg = tiny_test_config(width=w, height=h, baseline_m=0.3)
    scfg = dataclasses.replace(scfg, tsdf=dataclasses.replace(
        scfg.tsdf, voxel_size_m=0.06, trunc_dist_m=0.06 * 4,
        table_slots=1 << 17, max_visible_blocks=1 << 15,
        max_alloc_per_frame=1 << 15, max_depth_m=40.0))
    slam = DenseSLAM(scfg, device=dev)
    load_slam_checkpoint(ckpt, slam)
    color = rc_ops.render_preview(slam.raycast_view(np.asarray(
        slam.pose_history[-1][1], np.float32)), "color").cpu().numpy()
    x, y, w, h = rects["color"]
    color = png.resize_nearest(color, (w, h))
    pane = sheet[y:y + h, x:x + w]
    rec["sheet"] = dict(path=os.path.relpath(sheet_png, ROOT),
                        shape=list(sheet.shape), color_pane=[w, h],
                        pane_pixels_equal=float((pane == color).all(-1)
                                                .mean()),
                        frames=slam.frame)
    gates["sheet"] = bool(sheet.shape == (rects["sheet"][3],
                                          rects["sheet"][2], 3)
                          and np.array_equal(pane, color) and color.any())
    del slam
    gc.collect()
    torch.cuda.empty_cache()

    # (g) the dataset checks
    from denseslam_tpu_torch.tools import prepare_dataset
    rcs = [prepare_dataset.main(["validate", d])
           for d in (kitti, os.path.join(DEMO_DIR, "data"))]
    gates["validate"] = rcs == [0, 0]

    # every run: the card freed after it (its map's bytes from its own
    # summary); kernels only on the odo run
    mem = [r["after"] - r["before"] for r in runs_all]
    gates["memory_freed"] = all(
        freed(r, metrics(r["argv"][r["argv"].index("--metrics_json") + 1]))
        for r in runs_all)
    gates["kernels_only_on_odo"] = all(
        not any(r["launches"].values()) for r in runs_all
        if r is not odo[0])
    launches = dict(odo[0]["launches"])
    rec.update(runs=len(runs_all), memory_kept_bytes=mem,
               tool_seconds=tool_s, launches=launches, gpu=gpu)
    emit(rec)
    if not all(gates.values()):
        raise AssertionError(f"experiments gates failed: {gates}")
    return dict(launches=launches)


def run_vo_drift(dev, gpu):
    """A4's drift golden (tests/test_vo_numerics.py:185-238) on the port
    at its own size and with its own data: the flagship loop's first
    DRIFT_FRAMES frames (make_loop_trajectory(500, 18 m, 44 closure
    frames), loop_scene, 1226x370, fx 707.09, baseline 0.537 m) under its
    nuisance (gain 1 + 0.15 sin(2 pi t / 150), Gaussian noise of sigma 2.0
    from the key fold_in(PRNGKey(0), t) split in two, one per image),
    through open-loop frontend.vo_step with the default frontend and the
    RANSAC draws of the JAX frontend's key (PRNGKey(0), split once a
    frame); the JAX draws are made on the card by utils/threefry.py (the
    noise within a few float32 ulps of JAX's, the draws equal). Gates:
    the KITTI translation error over 10 and 15 m segments <
    DRIFT_T_ERR_PCT and the end-point error < DRIFT_END_PCT of the path;
    and every estimate_gain call of the drive (the exposure, in every
    stereo VO step) recomputed on the CPU from the same inputs gives the
    card's float32, bit for bit."""
    from denseslam_tpu_torch.config import (StereoConfig, TsdfConfig,
                                            tiny_test_config)
    from denseslam_tpu_torch.eval import traj_metrics
    from denseslam_tpu_torch.io import synthetic
    from denseslam_tpu_torch.models import frontend
    from denseslam_tpu_torch.ops import matching
    from denseslam_tpu_torch.utils import threefry
    from denseslam_tpu_torch.utils.camera import Intrinsics, StereoRig

    w, h = 1226, 370
    intr = Intrinsics(fx=707.09, fy=707.09, cx=(w - 1) / 2.0,
                      cy=(h - 1) / 2.0, width=w, height=h)
    cfg = dataclasses.replace(
        tiny_test_config(), rig=StereoRig(intr=intr, baseline_m=0.537),
        tsdf=TsdfConfig(table_slots=1 << 10),
        stereo=StereoConfig(max_disparity=64))
    gt_full = synthetic.make_loop_trajectory(500, radius_m=18.0,
                                             closure_frames=44)
    scene = synthetic.loop_scene(gt_full)
    gt = gt_full[:DRIFT_FRAMES]
    k = cfg.frontend.ransac_iters
    noise_key = threefry.prng_key(0, dev)
    vo_key = threefry.prng_key(0, dev)
    gain_fn, calls = matching.estimate_gain, []

    def recorded(*a, **kw):
        g = gain_fn(*a, **kw)
        calls.append(([x.clone() if torch.is_tensor(x) else x for x in a],
                      kw, g.clone()))
        return g

    matching.estimate_gain = recorded
    state = frontend.init_frontend(cfg, device=dev)
    est, t0 = [], time.perf_counter()
    try:
        for base in range(0, DRIFT_FRAMES, 16):
            hi = min(base + 16, DRIFT_FRAMES)
            lg, rg, _ = synthetic.render_stereo_trajectory(
                gt[base:hi], cfg.rig, scene, device=dev)
            for i in range(hi - base):
                t = base + i
                fi = torch.tensor(float(t), dtype=torch.float32, device=dev)
                g = 1.0 + 0.15 * torch.sin(2 * math.pi * fi / 150.0)
                kl, kr = threefry.split(threefry.fold_in(noise_key, t))
                left = torch.clamp(lg[i] * g + 2.0 * threefry.normal(
                    kl, (h, w)), 0, 255)
                right = torch.clamp(rg[i] * g + 2.0 * threefry.normal(
                    kr, (h, w)), 0, 255)
                vo_key, sub = threefry.split(vo_key)
                draws = threefry.randint(sub, (k, 3), 0, 2 ** 31 - 1)
                state, out = frontend.vo_step(state, left, right, cfg,
                                              raw=draws)
                est.append(out.T_wc.cpu().numpy().astype(np.float64))
    finally:
        matching.estimate_gain = gain_fn
    seconds = time.perf_counter() - t0
    gtl = [gt[i] for i in range(DRIFT_FRAMES)]
    kitti = traj_metrics.kitti_sequence_errors(est, gtl, lengths=(10, 15))
    path_m = float(np.sum(np.linalg.norm(np.diff(
        np.stack([T[:3, 3] for T in gtl]), axis=0), axis=1)))
    end_pct = float(np.linalg.norm(est[-1][:3, 3] - gtl[-1][:3, 3])) \
        / path_m * 100.0
    card = np.array([float(c[2]) for c in calls], np.float32)
    cpu = np.array([float(gain_fn(*[x.cpu() if torch.is_tensor(x) else x
                                     for x in a], **kw))
                    for a, kw, _ in calls], np.float32)
    emit(dict(phase="vo_drift", frames=DRIFT_FRAMES, path_m=path_m,
              t_err_pct=kitti["kitti_t_err_pct"],
              r_err_deg_per_m=kitti["kitti_r_err_deg_per_m"],
              end_pct=end_pct, seconds=seconds,
              exposure_calls=len(calls),
              exposure_equal=int((card == cpu).sum()),
              exposure_range=[float(card.min()), float(card.max())],
              gpu=gpu))
    gates = dict(t_err=kitti["kitti_t_err_pct"] < DRIFT_T_ERR_PCT,
                 end=end_pct < DRIFT_END_PCT,
                 exposure=len(calls) >= DRIFT_FRAMES - 1
                 and np.array_equal(card.view(np.int32), cpu.view(np.int32)))
    if not all(gates.values()):
        raise AssertionError(f"vo_drift gates failed: {gates}")


def profile_tick(cfg, dev, cap, out: str):
    """torch.profiler over the captured tick's four parts on the card,
    each run from the card's state before the tick: local_ba,
    detect_loop (retrieval + verification), optimize_graph, and
    apply_pose_updates of the tick's updates on the map and DB it found."""
    from denseslam_tpu_torch.io import convert
    from denseslam_tpu_torch.models.dense_slam import copy_db, copy_map
    from denseslam_tpu_torch.models.system import SLAMSystem

    sy = SLAMSystem(cfg, ba_every=4, loop_every=2, device=dev)
    state = convert.backend_state_to_numpy(cap.pre["backend"])
    before = cap.apply["before"]

    def backend_setup():
        convert.backend_state_from_numpy(state, sy.backend)
        return None

    def map_setup():
        sy.slam.submaps.active = copy_map(before["map"], sy.device)
        sy.slam.db = copy_db(before["db"], sy.device)
        return None

    parts = (
        ("tick_local_ba", backend_setup, lambda _: sy.backend.local_ba()),
        ("tick_detect_loop", backend_setup,
         lambda _: sy.backend.detect_loop()),
        ("tick_optimize_graph", backend_setup,
         lambda _: sy.backend.optimize_graph()),
        ("tick_apply_pose_updates", map_setup,
         lambda _: sy.slam.apply_pose_updates(
             cap.apply["ids"], cap.apply["poses"], enforce_budget=False)),
    )
    for part, setup, fn in parts:
        profile_part(part, 1, fn, None, out, setup=setup)


def throughput(cfg, dev, run, gpu, reps: int, rgbd_cfg, rgbd_fr,
               stereo_cfg, stereo_fr):
    """Frames/s on the host clock around work that ends in a synchronize:
    stereo + fusion over chunks 2-4 of the slice's frames, the fusion
    tail alone on bench.py's workload (10 rendered street frames fused
    over and over, 3 warm-up chunks, 12 timed), the RGB-D path over
    chunks 2-3 of its 48 frames, and the stereo main path over its 64
    frames (one call, VO + keyframe SGM + fusion). `reps` samples of
    each, taken in turns."""
    from denseslam_tpu_torch.io import synthetic
    from denseslam_tpu_torch.models import dense_slam
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    poses = synthetic.make_trajectory(CHUNK, step_m=0.8, yaw_rate=0.003)
    grays, depths = synthetic.render_trajectory(
        poses, cfg.rig.intr, synthetic.street_scene(), device=dev)
    T = torch.as_tensor(poses, device=dev)
    fids = torch.arange(CHUNK, dtype=torch.int32, device=dev)

    def fusion_fps():
        m = tsdf_ops.make_map(cfg.tsdf, device=dev)
        db = dense_slam.make_fusion_db(cfg, device=dev)
        warm, timed = 3, 12
        for i in range(warm):
            m, db = dense_slam.fuse_sequence(m, db, depths, grays, T,
                                             fids + i * CHUNK, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(timed):
            m, db = dense_slam.fuse_sequence(m, db, depths, grays, T,
                                             fids + (warm + i) * CHUNK, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if int(m.overflow) != 0:
            raise AssertionError(f"map overflow {int(m.overflow)}")
        return timed * CHUNK / dt

    samples = {"stereo_fusion": [], "fusion_tail": [], "rgbd": [],
               "stereo_path": []}
    for _ in range(reps):
        samples["stereo_fusion"].append(
            CHUNK * (N_CHUNKS - 1) / drive(cfg, dev, run)[2])
        samples["fusion_tail"].append(fusion_fps())
        samples["rgbd"].append(
            (RGBD_FRAMES - RGBD_CHUNK) / drive_rgbd(rgbd_cfg, rgbd_fr)[2])
        samples["stereo_path"].append(
            STEREO_FRAMES / drive_stereo(stereo_cfg, stereo_fr)[2])
    q = {k: np.percentile(v, [25, 50, 75]).tolist() for k, v in samples.items()}
    emit(dict(phase="throughput", unit="frames/s",
              stereo_fusion_fps=q["stereo_fusion"][1],
              fusion_tail_fps=q["fusion_tail"][1], rgbd_fps=q["rgbd"][1],
              stereo_path_fps=q["stereo_path"][1],
              quartiles=q, samples=samples, gpu=gpu))


def profile_part(part: str, frames: int, fn, state, out=None, setup=None):
    """Run `fn(state) -> state` once to warm up, then once under
    torch.profiler; with `setup`, each run starts from `setup()` (run
    outside the profiler). Device time is the sum of the kernels' own
    times; with `out`, the table goes to <out>/profile_<part>.txt. Prints
    and returns the record, and returns the state."""
    from torch.profiler import ProfilerActivity, profile

    if setup is not None:
        state = setup()
    state = fn(state)
    torch.cuda.synchronize()
    if setup is not None:
        state = setup()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = fn(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    kernels = [e for e in rows
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    attr = ("self_device_time_total"
            if kernels and hasattr(kernels[0], "self_device_time_total")
            else "self_cuda_time_total")
    kernels.sort(key=lambda e: -getattr(e, attr))
    device_ms = sum(getattr(e, attr) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    # the host waits for the card in these runtime calls (a value read
    # back, a blocking copy); not counted: the closing synchronize and the
    # one the profiler makes when it starts
    runtime = {e.key: e.count for e in rows if e.key.startswith("cuda")}
    syncs = sum(runtime.get(k, 0) for k in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize", "cudaMemcpy")) - 2
    if out:
        with open(os.path.join(out, f"profile_{part}.txt"), "w") as fh:
            fh.write(rows.table(sort_by="self_cuda_time_total", row_limit=60))
    rec = dict(phase="profile", part=part, frames=frames, wall_ms=wall_ms,
              device_ms=device_ms, device_busy_share=device_ms / wall_ms,
              launches=launches, host_syncs=syncs,
              scalar_reads=sum(e.count for e in rows
                               if e.key == "aten::_local_scalar_dense"),
              runtime_calls=runtime,
              per_frame=dict(device_ms=device_ms / frames,
                             launches=launches / frames,
                             host_syncs=syncs / frames),
              top=[dict(name=e.key[:80], ms=getattr(e, attr) / 1e3,
                        calls=e.count) for e in kernels[:8]])
    emit(rec)
    return state, rec


def profile_chunk(cfg, dev, run, out: str):
    """torch.profiler over one chunk (10 frames), three ways: stereo alone,
    fusion alone, and both."""
    from denseslam_tpu_torch.models import dense_slam
    from denseslam_tpu_torch.ops import stereo
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    m = tsdf_ops.make_map(cfg.tsdf, device=dev)
    db = dense_slam.make_fusion_db(cfg, device=dev)
    sl = slice(0, CHUNK)
    depth = run["depth"][sl]

    def depths():
        return torch.stack([stereo.compute_depth(
            run["lefts"][i], run["rights"][i], cfg.rig, cfg.stereo)[0]
            for i in range(CHUNK)])

    def fuse(m, db, d):
        return dense_slam.fuse_sequence(m, db, d, run["lefts"][sl],
                                        run["T"][sl], run["fids"][sl], cfg)

    parts = {"stereo": lambda st: (depths(), st)[1],
             "fusion": lambda st: fuse(*st, depth),
             "stereo_fusion": lambda st: fuse(*st, depths())}
    os.makedirs(out, exist_ok=True)
    state = (m, db)
    for part, fn in parts.items():
        state, _ = profile_part(part, CHUNK, fn, state, out)


def profile_rgbd_chunk(cfg, dev, fr, poses, out: str):
    """torch.profiler over the first RGB-D chunk (16 frames), three ways:
    the VO alone (rgbd_vo_step from a fresh state), the fusion alone
    (fuse_keyframe of the chunk's keyframes at the VO's poses `poses`), and
    process_sequence_rgbd."""
    from denseslam_tpu_torch.models import dense_slam, frontend
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    sl = slice(0, RGBD_CHUNK)
    g, d, fids, draws = (fr[k][sl] for k in ("grays", "depths", "fids",
                                              "draws"))
    kf = range(0, RGBD_CHUNK, cfg.pipeline.keyframe_every)

    def vo(state):
        st = frontend.init_frontend(cfg, device=dev)
        for i in range(RGBD_CHUNK):
            st, _ = frontend.rgbd_vo_step(st, g[i], d[i], cfg, raw=draws[i])
        return state

    def fusion(state):
        m, db = state
        for i in kf:
            m, db = dense_slam.fuse_keyframe(m, db, d[i], g[i], poses[i],
                                             fids[i], cfg)
        return m, db

    def both(state):
        m, db = state
        st = frontend.init_frontend(cfg, device=dev)
        _, m, db, _ = dense_slam.process_sequence_rgbd(st, m, db, g, d, fids,
                                                       cfg, draws=draws)
        return m, db

    state = (tsdf_ops.make_map(cfg.tsdf, device=dev),
             dense_slam.make_fusion_db(cfg, device=dev))
    for part, fn in (("rgbd_vo", vo), ("rgbd_fusion", fusion),
                     ("rgbd", both)):
        state, _ = profile_part(part, RGBD_CHUNK, fn, state, out)
    from denseslam_tpu_torch.models import frontend as fe
    profile_vo_stages(vo, "rgbd_vo_stages", RGBD_CHUNK, [
        (fe.feat_ops, "detect"), (fe.feat_ops, "bucket"),
        (fe.matching, "predict_uv"), (fe.matching, "match_temporal"),
        (fe.matching, "refine_temporal_subpix"),
        (fe.matching, "remove_outliers"),
        (fe.ransac, "estimate_stereo_motion")])


def profile_stereo_chunk(cfg, dev, fr, poses, out: str):
    """torch.profiler over the stereo main path's first 16 frames, three
    ways: the VO alone (vo_step from a fresh state), the keyframes alone
    (compute_depth + fuse_keyframe of the chunk's 4 keyframes at the VO's
    poses `poses`), and process_sequence; then the VO by stage."""
    from denseslam_tpu_torch.models import dense_slam, frontend
    from denseslam_tpu_torch.ops import stereo
    from denseslam_tpu_torch.ops import tsdf as tsdf_ops

    n = RGBD_CHUNK
    sub = {k: v[:n] for k, v in fr.items()}
    kf = range(0, n, cfg.pipeline.keyframe_every)

    def vo(state):
        st = frontend.init_frontend(cfg, device=dev)
        for i in range(n):
            st, _ = frontend.vo_step(st, sub["lefts"][i], sub["rights"][i],
                                     cfg, raw=sub["draws"][i])
        return state

    def keyframes(state):
        m, db = state
        for i in kf:
            d, _ = stereo.compute_depth(sub["lefts"][i], sub["rights"][i],
                                        cfg.rig, cfg.stereo)
            m, db = dense_slam.fuse_keyframe(m, db, d, sub["lefts"][i],
                                             poses[i], sub["fids"][i], cfg)
        return m, db

    def both(state):
        m, db = state
        st = frontend.init_frontend(cfg, device=dev)
        _, m, db, _ = dense_slam.process_sequence(
            st, m, db, sub["lefts"], sub["rights"], sub["fids"], cfg,
            draws=sub["draws"])
        return m, db

    state = (tsdf_ops.make_map(cfg.tsdf, device=dev),
             dense_slam.make_fusion_db(cfg, device=dev))
    for part, fn in (("stereo_vo", vo), ("stereo_keyframes", keyframes),
                     ("stereo_path", both)):
        state, _ = profile_part(part, n, fn, state, out)
    profile_vo_stages(vo, "stereo_vo_stages", n, [
        (frontend.feat_ops, "detect"), (frontend.feat_ops, "bucket"),
        (frontend.matching, "quad_match"),
        (frontend.matching, "remove_outliers"),
        (frontend.matching, "refine_quad_subpix"),
        (frontend.matching, "stereo_disparities"),
        (frontend.ransac, "estimate_stereo_motion"),
        (frontend.matching, "estimate_gain")])


def profile_vo_stages(vo, part: str, frames: int, stages):
    """The VO's device time and kernel launches by stage: one profiled run
    of `vo` (`frames` VO steps) with each stage function (module, name)
    wrapped in a profiler range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = [getattr(mod, name) for mod, name in stages]

    def labelled(name, fn):
        def run(*args, **kwargs):
            with record_function("vo." + name):
                return fn(*args, **kwargs)
        return run

    try:
        for (mod, name), fn in zip(stages, saved):
            setattr(mod, name, labelled(name, fn))
        vo(None)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            vo(None)
            torch.cuda.synchronize()
    finally:
        for (mod, name), fn in zip(stages, saved):
            setattr(mod, name, fn)

    def kernels_under(ev):
        ks = list(ev.kernels)
        for child in ev.cpu_children:
            ks += kernels_under(child)
        return ks

    by_stage = {}
    for ev in prof.events():
        if ev.name.startswith("vo."):
            ks = kernels_under(ev)
            acc = by_stage.setdefault(ev.name[3:], [0.0, 0])
            acc[0] += sum(k.duration for k in ks) / 1e3
            acc[1] += len(ks)
    emit(dict(phase="profile", part=part, frames=frames,
              per_frame={k: dict(device_ms=v[0] / frames,
                                 launches=v[1] / frames)
                         for k, v in by_stage.items()}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="profile one chunk of each path and one backend "
                    "tick; write the tables into DIR")
    ap.add_argument("--reps", type=int, default=1,
                    help="samples of each throughput number (median printed)")
    args = ap.parse_args(argv)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script drives "
              "the port on the GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from denseslam_tpu_torch import kernels

    gpu = gpu_line()
    dev = torch.device("cuda")
    emit(dict(phase="env", nvidia_smi=gpu, torch=torch.__version__,
              cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count()))
    t0 = time.perf_counter()
    built = kernels.build_all()
    emit(dict(phase="build", seconds_each=built,
              seconds_total=time.perf_counter() - t0))

    phase_s = {}

    def timed(name, fn, *a, **kw):
        t = time.perf_counter()
        r = fn(*a, **kw)
        phase_s[name] = time.perf_counter() - t
        return r

    cfg = slice_config()
    recs = [timed("kernel_B1", check_sampler, cfg, dev, gpu),
            timed("kernel_B3", check_sgm, cfg, dev, gpu)]
    final, recs[1]["per_launch"] = timed("kernel_P1", check_sgm_final, cfg,
                                         dev, gpu)
    timed("kernels_ragged", check_sgm_ragged, cfg, dev)
    recs.append(timed("kernel_CV", check_cost_volume, cfg, dev, gpu))
    run = timed("slice", run_slice, cfg, dev)
    timed("slice_cpu_reference", check_against_cpu, cfg, dev, run)
    sharded = timed("sharded", run_sharded, dev, gpu, run)

    rcfg = drive_config("rgbd")
    fr = rgbd_frames(rcfg, dev)
    recs.append(timed("kernel_B2", check_sampler_rgb, rcfg, dev, gpu, fr))
    rgbd = timed("rgbd", run_rgbd, rcfg, fr)
    timed("rgbd_cpu_reference", check_rgbd_against_cpu, rcfg, dev, fr)

    scfg = drive_config("stereo")
    sfr = stereo_frames(scfg, dev)
    stereo = timed("stereo", run_stereo, scfg, sfr)
    recs.append(final)
    timed("stereo_cpu_reference", check_stereo_against_cpu, scfg, dev, sfr)
    timed("render", run_render, scfg, dev, sfr, stereo, gpu, args.profile)

    system = timed("system", run_system, scfg, dev, gpu)
    timed("system_cpu_reference", check_system_against_cpu, scfg,
          system["capture"])
    timed("mesh", run_mesh, scfg, dev, system["system"], gpu)
    submaps = timed("submaps", run_submaps, scfg, dev, gpu, system["system"])
    timed("submaps_cpu_reference", check_submaps_against_cpu, scfg, dev,
          submaps)
    frame = timed("frame", run_frame, scfg, dev, gpu, args.profile)
    DRIVE_CHUNKS.clear()
    icp = timed("icp", run_icp, rcfg, dev, gpu)
    mcfg = drive_config("mono")
    mono = timed("mono", run_mono, mcfg, dev, gpu)
    timed("mono_cpu_reference", check_mono_against_cpu, mcfg, dev)
    mono_frame = timed("mono_frame", run_mono_frame, mcfg, dev, gpu)
    DRIVE_CHUNKS.clear()
    orb = timed("orb", run_orb, scfg, dev, sfr, gpu)
    bilinear = timed("bilinear", run_bilinear, cfg, dev, run)
    timed("tracks", run_tracks, scfg, dev, gpu)
    kitti, tum = timed("cli_datasets", cli_datasets)
    kitti_frames = timed("kitti_decode", decode_kitti, kitti, dev)
    jax_golden = timed("jax_golden", run_jax_golden, dev, gpu, kitti_frames)
    cli = timed("cli", run_cli, dev, gpu, kitti)
    cli_chunk = timed("cli_chunk", run_cli_chunk, dev, gpu, kitti,
                      kitti_frames)
    del kitti_frames
    cli_resume = timed("cli_resume", run_cli_resume, dev, gpu, kitti)
    cli_rgbd = timed("cli_rgbd", run_cli_rgbd, dev, gpu, tum)
    timed("cli_cpu_reference", run_cli_cpu_reference, dev, gpu, kitti)
    viewer = timed("viewer", run_viewer, dev, gpu, kitti, cli)
    tools = timed("tools", run_tools, dev, gpu, kitti)
    experiments = timed("experiments", run_experiments, dev, gpu, kitti)
    timed("vo_drift", run_vo_drift, dev, gpu)
    paths = dict(slice=run["launches"], rgbd=rgbd["launches"],
                 stereo=stereo["launches"], system=system["launches"],
                 submaps=submaps["launches"],
                 frame=frame["launches"], frame_vo=frame["vo_launches"],
                 icp=icp["launches"], mono=mono["launches"],
                 mono_frame=mono_frame["launches"], orb=orb["launches"],
                 bilinear=bilinear["launches"], cli=cli["launches"],
                 cli_chunk=cli_chunk["launches"],
                 cli_resume=cli_resume["launches"],
                 cli_rgbd=cli_rgbd["launches"], viewer=viewer["launches"],
                 jax_golden=jax_golden["launches"],
                 tools=tools["launches"],
                 experiments=experiments["launches"],
                 sharded=sharded["launches"])
    # kernel CV makes the volume of every SGM: as many launches as P1's
    cv_off = {k: (v["cost_volume"], v["sgm_final"]) for k, v in paths.items()
              if v["cost_volume"] != v["sgm_final"]}
    if cv_off:
        raise AssertionError(f"cost_volume launches differ from sgm_final's "
                             f"(path: cost_volume, sgm_final): {cv_off}")
    for rec in recs:
        rec["launches_by_path"] = {k: v[rec["name"]] for k, v in paths.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())

    timed("throughput", throughput, cfg, dev, run, gpu, args.reps, rcfg, fr,
          scfg, sfr)
    if args.profile:
        profile_chunk(cfg, dev, run, args.profile)
        profile_rgbd_chunk(rcfg, dev, fr, rgbd["stats"]["T_wc"],
                           args.profile)
        profile_stereo_chunk(scfg, dev, sfr, stereo["stats"]["T_wc"],
                             args.profile)
        profile_tick(scfg, dev, system["capture"], args.profile)
    emit(dict(phase="seconds", **phase_s,
              since_start=time.perf_counter() - t0))

    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "per_launch")
    emit({"kernels": [{k: rec[k] for k in keys if k in rec} for rec in recs]})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
