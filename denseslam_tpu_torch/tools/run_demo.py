"""One-command demo (port of scripts/run_demo.py): synthesize a sequence,
run the SLAM system on it, score everything.

It writes the fixture (make_synthetic_dataset, 320x240) into WORKDIR/data,
runs the command line in process with the JAX demo's flags (5 cm voxels,
10 m, 2^14 slots, voxel decay and the sliding window, every output:
trajectories, mesh, raycast depth dumps, memory log, metrics) into
WORKDIR/out, scores the trajectory against poses_gt.txt (ATE, RPE) into
trajectory_scores.json and the raycast dumps against depth_gt/
(eval_raycast_depth --no-crop) into depth_scores.json. It runs on the CUDA
card unless --device says otherwise.

Usage: python -m denseslam_tpu_torch.tools.run_demo [--workdir DIR]
       [--frames N] [--backend] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from . import common, eval_raycast_depth, make_synthetic_dataset


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "denseslam_demo"))
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--backend", action="store_true",
                    help="enable local BA + loop closing")
    ap.add_argument("--device", default=None,
                    help="torch device of the run (default: the card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    data = os.path.join(args.workdir, "data")
    out = os.path.join(args.workdir, "out")
    os.makedirs(out, exist_ok=True)

    make_synthetic_dataset.main([data, "--frames", str(args.frames)]
                                + common.device_args(args.device))

    cmd = [
        "--dataset_root", data,
        "--voxel_size", "0.05", "--max_depth", "10",
        "--table_slots_log2", "14", "--max_visible_log2", "12",
        "--voxel_decay", "--slide_window",
        "--save_trajectory", os.path.join(out, "traj_tum.txt"),
        "--save_kitti_trajectory", os.path.join(out, "traj_kitti.txt"),
        "--save_mesh", os.path.join(out, "scene.obj"),
        "--save_raycast_depth_dir", os.path.join(out, "raycast"),
        "--save_memory_log", os.path.join(out, "memory.txt"),
        "--metrics_json", os.path.join(out, "metrics.json"),
    ]
    if args.backend:
        cmd.append("--enable_backend")
    common.run_main(cmd, args.device)

    # score trajectory vs ground truth
    from ..eval import traj_metrics
    from ..io.trajectory import load_kitti

    est = load_kitti(os.path.join(out, "traj_kitti.txt"))
    gt = load_kitti(os.path.join(data, "poses_gt.txt"))[: len(est)]
    scores = dict(
        ate_rmse_m=traj_metrics.ate_rmse(est, gt), **traj_metrics.rpe(est, gt)
    )
    print("trajectory:", json.dumps(scores))
    with open(os.path.join(out, "trajectory_scores.json"), "w") as f:
        json.dump(scores, f)

    # score raycast depth vs GT dumps
    rc = eval_raycast_depth.main([
        os.path.join(out, "raycast"), os.path.join(data, "depth_gt"),
        "--no-crop", "--out", os.path.join(out, "depth_scores.json"),
    ])
    if rc != 0:
        raise SystemExit(f"eval_raycast_depth returned {rc}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
