"""Scaling bench: fused frames/s per card on the global sharded map (port
of scripts/bench_scaling.py).

One process per card, launched by torchrun (NCCL):

    torchrun --nproc_per_node 4 -m denseslam_tpu_torch.tools.bench_scaling

The map is the JAX script's: 1226x370 frames of the synthetic street,
0.06 m voxels, 2^17 slots and 8192 visible blocks, with decay and the
sliding window on, over the ranks. Ten frames 0.8 m apart are fused in
turn: one warm-up fuse, then `--frames` timed ones, each rank's fuse
synchronised with a block-count all-reduce at the end. Rank 0 prints one
JSON line. `--spawn N --backend gloo --device cpu` runs N local ranks
instead (its rate on the CPU is not a card's); with `--coordinator`,
`--num-processes P` and `--process-id I` it is node I of P such launchers,
N ranks each. `--scale` shrinks the frames and their intrinsics.

The script's localhost matrices run such launchers as subprocesses on the
CPU, one torch thread a rank, and write one JSON record (default under
build/; each cell's output beside it as a .log):

    python -m denseslam_tpu_torch.tools.bench_scaling --matrix-cpu
    python -m denseslam_tpu_torch.tools.bench_scaling --matrix-pinned

A JAX virtual device is a rank here and a JAX process a launcher, so the
records keep the script's keys: `--matrix-cpu` runs 1 launcher x 4 ranks,
1 x 8 and 2 x 4 (eff_fixed_total = 2x4 / 1x8, eff_weak = 2x4 / 1x4, per
rank); `--matrix-pinned` runs each launcher under `taskset` on its own
cores, A = 1 x 2 on {0,1}, B = 2 x 2 on {0,1} | {2,3}, C = 1 x 4 on
{0-3} (eff_weak_pinned = B / A, eff_fixed_pinned = B / C). Unlike JAX's
devices in one process, every rank is a process of its own, so the
launchers of a cell differ only in how their ranks meet the coordinator.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def bench(mesh, frames: int = 40, sampler: str = "gather",
          scale: float = 1.0) -> dict:
    """The timed fusion on this rank of `mesh`; returns its record."""
    from ..config import (SlideWindowParams, SystemConfig, TsdfConfig,
                          VoxelDecayParams)
    from ..io import synthetic
    from ..parallel.sharded_map import ShardedTsdf
    from ..utils.camera import Intrinsics, StereoRig

    dev = mesh.device
    intr = Intrinsics(fx=707.09, fy=707.09, cx=601.89, cy=183.11,
                      width=1226, height=370).scaled(scale)
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


def run_cell(ranks: int, frames: int, log: str, nodes: int = 1,
             cores=None, extra=(), port: int = 8476) -> dict:
    """One matrix cell: `nodes` launchers of `ranks` CPU ranks each (gloo),
    launcher i under `taskset -c cores[i]` when `cores` is given; returns
    rank 0's record. Every launcher's output goes to `log`."""
    cmd = [sys.executable, "-m", "denseslam_tpu_torch.tools.bench_scaling",
           "--spawn", str(ranks), "--backend", "gloo", "--device", "cpu",
           "--frames", str(frames), *extra]
    if nodes > 1:
        cmd += ["--coordinator", f"127.0.0.1:{port}",
                "--num-processes", str(nodes)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = []
    with open(log, "w") as f:
        for i in range(nodes):
            c = cmd + (["--process-id", str(i)] if nodes > 1 else [])
            if cores is not None:
                c = ["taskset", "-c", cores[i]] + c
            procs.append(subprocess.Popen(c, env=env, cwd=ROOT,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=1200)[0] for p in procs]
        f.write("".join(outs))
    for p in procs:
        if p.returncode != 0:
            raise RuntimeError(f"cell {nodes}x{ranks} failed (rc "
                               f"{p.returncode}); see {log}")
    line = [ln for ln in outs[0].splitlines() if ln.startswith("{")][-1]
    return json.loads(line)


def _write(rec: dict, out_json: str) -> None:
    print(json.dumps(rec), flush=True)
    with open(out_json, "w") as f:
        json.dump(rec, f, indent=1)


def run_matrix_cpu(frames: int, out_json: str, extra=()) -> dict:
    """The script's localhost matrix: 1 x 4, 1 x 8 and 2 x 4 (launchers x
    ranks), fused frames/s per rank and the two ratios."""
    base = os.path.splitext(out_json)[0]
    r1x4 = run_cell(4, frames, f"{base}_1x4.log", extra=extra)
    r1x8 = run_cell(8, frames, f"{base}_1x8.log", extra=extra)
    r2x4 = run_cell(4, frames, f"{base}_2x4.log", nodes=2, extra=extra)
    rec = {
        "metric": "cpu_mesh_scaling_matrix",
        "frames": frames,
        "fps_per_chip_1proc_4dev": r1x4["value"],
        "fps_per_chip_1proc_8dev": r1x8["value"],
        "fps_per_chip_2proc_4dev": r2x4["value"],
        "blocks_agree": (r1x4["blocks"] == r1x8["blocks"] ==
                         r2x4["blocks"]),
        "eff_fixed_total": round(r2x4["value"] / r1x8["value"], 3),
        "eff_weak": round(r2x4["value"] / r1x4["value"], 3),
        "note": "proc = a launcher of --spawn ranks, dev = a rank (one "
                "process, one torch thread, gloo on the CPU); the ranks "
                "share the host's cores, so eff_weak is a lower bound",
    }
    _write(rec, out_json)
    return rec


def run_matrix_pinned(frames: int, out_json: str, extra=()) -> dict:
    """The script's core-pinned matrix: each launcher (and so each of its
    ranks) on a disjoint core set by `taskset`."""
    base = os.path.splitext(out_json)[0]
    rA = run_cell(2, frames, f"{base}_A.log", cores=["0,1"], extra=extra)
    rC = run_cell(4, frames, f"{base}_C.log", cores=["0-3"], extra=extra)
    rB = run_cell(2, frames, f"{base}_B.log", nodes=2, cores=["0,1", "2,3"],
                  extra=extra, port=8477)
    rec = {
        "metric": "cpu_mesh_scaling_pinned",
        "frames": frames,
        "methodology": "taskset-pinned disjoint core sets per launcher: "
                       "A=1x2 ranks@{0,1}, B=2x2 ranks@{0,1}|{2,3}, "
                       "C=1x4 ranks@{0-3}; weak = B/A (per-launcher "
                       "resources constant), fixed = B/C (same total "
                       "resources); one torch thread a rank",
        "fps_per_chip_A_1proc_2dev": rA["value"],
        "fps_per_chip_B_2proc_2dev": rB["value"],
        "fps_per_chip_C_1proc_4dev": rC["value"],
        "blocks_agree": (rA["blocks"] == rC["blocks"] == rB["blocks"]),
        "eff_weak_pinned": round(rB["value"] / rA["value"], 3),
        "eff_fixed_pinned": round(rB["value"] / rC["value"], 3),
    }
    _write(rec, out_json)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--sampler", default="gather",
                    choices=["gather", "pallas"],
                    help="the fusion sampler (pallas: the B1 kernel)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="frame size and intrinsics scale (1: 1226x370)")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--backend", default=None, help="nccl or gloo")
    ap.add_argument("--device", default=None,
                    help="cpu, cuda:0 (ranks share it), default cuda:rank")
    ap.add_argument("--spawn", type=int, default=0,
                    help="spawn this many local ranks (else torchrun's)")
    ap.add_argument("--matrix-cpu", action="store_true",
                    help="run the localhost 1x4 / 1x8 / 2x4 matrix on the "
                    "CPU and write --json")
    ap.add_argument("--matrix-pinned", action="store_true",
                    help="run the taskset-pinned disjoint-core matrix on "
                    "the CPU and write --json")
    ap.add_argument("--json", default=None,
                    help="the matrix record (default build/SCALING_torch"
                    "[_pinned].json)")
    args = ap.parse_args(argv)
    if args.matrix_cpu or args.matrix_pinned:
        pinned = args.matrix_pinned
        out = args.json or os.path.join(
            ROOT, "build", "SCALING_torch_pinned.json" if pinned
            else "SCALING_torch.json")
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        extra = ["--scale", str(args.scale)] if args.scale != 1.0 else []
        (run_matrix_pinned if pinned else run_matrix_cpu)(
            args.frames, out, extra)
        return 0
    from ..parallel import launch

    run = (args.frames, args.sampler, args.scale)
    if args.spawn:
        backend = args.backend or ("nccl" if args.device is None else "gloo")
        node = args.process_id or 0
        recs = launch.run_local(bench, args.spawn, *run, backend=backend,
                                device=args.device,
                                coordinator=args.coordinator,
                                nnodes=args.num_processes or 1,
                                node_rank=node)
        if node != 0:
            return 0
        rec = recs[0]
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
