"""Scaling bench: fused frames/s per card on the global sharded map (port
of scripts/bench_scaling.py `main`).

One process per card, launched by torchrun (NCCL):

    torchrun --nproc_per_node 4 -m denseslam_tpu_torch.tools.bench_scaling

The map is the JAX script's: 1226x370 frames of the synthetic street,
0.06 m voxels, 2^17 slots and 8192 visible blocks, with decay and the
sliding window on, over the ranks. Ten frames 0.8 m apart are fused in
turn: one warm-up fuse, then `--frames` timed ones, each rank's fuse
synchronised with a block-count all-reduce at the end. Rank 0 prints one
JSON line. `--spawn N --backend gloo --device cpu` runs N local ranks
instead (its rate on the CPU is not a card's).

Not ported yet: the script's `--matrix-cpu` and `--matrix-pinned`
drivers (ROADMAP.md Queue A).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def bench(mesh, frames: int = 40, sampler: str = "gather") -> dict:
    """The timed fusion on this rank of `mesh`; returns its record."""
    from ..config import (SlideWindowParams, SystemConfig, TsdfConfig,
                          VoxelDecayParams)
    from ..io import synthetic
    from ..parallel.sharded_map import ShardedTsdf
    from ..utils.camera import Intrinsics, StereoRig

    dev = mesh.device
    intr = Intrinsics(fx=707.09, fy=707.09, cx=601.89, cy=183.11,
                      width=1226, height=370)
    rig = StereoRig(intr=intr, baseline_m=0.537)
    tsdf = TsdfConfig(voxel_size_m=0.06, trunc_dist_m=0.24,
                      table_slots=1 << 17, max_visible_blocks=1 << 13,
                      max_alloc_per_frame=1 << 13, max_depth_m=50.0,
                      raycast_steps=192, sampler=sampler)
    cfg = SystemConfig(
        rig=rig, tsdf=tsdf,
        decay=VoxelDecayParams(enabled=True, min_decay_age=30,
                               max_decay_weight=2),
        slide_window=SlideWindowParams(enabled=True, max_age=60))
    st = ShardedTsdf(cfg, mesh)
    m = st.make_map()
    n = 10
    poses = synthetic.make_trajectory(n, step_m=0.8, yaw_rate=0.003)
    grays, depths = synthetic.render_trajectory(poses, intr, device=dev)
    Ts = torch.as_tensor(poses, dtype=torch.float32, device=dev)

    m = st.fuse(m, depths[0], grays[0], Ts[0])      # warm-up
    blocks = st.num_blocks(m)
    t0 = time.perf_counter()
    for i in range(frames):
        m = st.fuse(m, depths[i % n], grays[i % n], Ts[i % n])
    blocks = st.num_blocks(m)                        # reads back: a barrier
    dt = time.perf_counter() - t0
    fps = frames / dt
    return {"metric": "sharded_fused_frames_per_s_per_chip",
            "value": round(fps / mesh.size, 3), "unit": "frames/s/chip",
            "n_chips": mesh.size, "n_processes": mesh.size,
            "total_fps": round(fps, 3), "blocks": int(blocks),
            "frames": frames, "seconds": dt, "sampler": sampler,
            "backend": mesh.backend, "device": str(dev),
            "overflow": int(m.overflow)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--sampler", default="gather",
                    choices=["gather", "pallas"],
                    help="the fusion sampler (pallas: the B1 kernel)")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--backend", default=None, help="nccl or gloo")
    ap.add_argument("--device", default=None,
                    help="cpu, cuda:0 (ranks share it), default cuda:rank")
    ap.add_argument("--spawn", type=int, default=0,
                    help="spawn this many local ranks (else torchrun's)")
    args = ap.parse_args(argv)
    from ..parallel import launch

    run = (args.frames, args.sampler)
    if args.spawn:
        backend = args.backend or ("nccl" if args.device is None else "gloo")
        rec = launch.run_local(bench, args.spawn, *run, backend=backend,
                               device=args.device)[0]
    else:
        launch.init_distributed(args.coordinator, args.num_processes,
                                args.process_id, backend=args.backend,
                                device=args.device)
        try:
            rec = bench(launch.global_map_mesh(
                None if args.device is None else torch.device(args.device)),
                *run)
            if not launch.is_coordinator():
                return 0
        finally:
            launch.shutdown_distributed()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
