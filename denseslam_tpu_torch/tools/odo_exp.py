"""Odometry accuracy over sequences (port of scripts/odo_exp.py): the
command line on each sequence folder, writing its KITTI trajectory
({name}_traj.txt) and summary ({name}_metrics.json); where the folder
holds poses_gt.txt, the trajectory is scored (ATE, RPE and the KITTI
segment errors). odo_summary.json holds every sequence's entry. Each run
is in this process and frees its map before the next; it runs on the CUDA
card unless --device says otherwise.

Usage: python -m denseslam_tpu_torch.tools.odo_exp SEQ_DIR [SEQ_DIR ...]
       --out OUT [--frames N] [--compute_depth] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from . import common


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seqs", nargs="+")
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--compute_depth", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the runs (default: the card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    from ..eval import traj_metrics
    from ..io.trajectory import load_kitti

    summary = {}
    for seq in args.seqs:
        name = os.path.basename(os.path.normpath(seq))
        traj_path = os.path.join(args.out, f"{name}_traj.txt")
        cmd = [
            "--dataset_root", seq,
            "--save_kitti_trajectory", traj_path,
            "--metrics_json", os.path.join(args.out, f"{name}_metrics.json"),
            "--quiet",
        ]
        if args.frames:
            cmd += ["--frame_limit", str(args.frames)]
        if args.compute_depth:
            cmd += ["--compute_depth"]
        common.run_main(cmd, args.device)
        entry = {"trajectory": traj_path}
        gt_path = os.path.join(seq, "poses_gt.txt")
        if os.path.exists(gt_path):
            est = load_kitti(traj_path)
            gt = load_kitti(gt_path)[: len(est)]
            entry["ate_rmse_m"] = traj_metrics.ate_rmse(est, gt)
            entry.update(traj_metrics.rpe(est, gt))
            entry.update(traj_metrics.kitti_sequence_errors(est, gt))
        summary[name] = entry
        print(name, json.dumps(entry, default=str))
    with open(os.path.join(args.out, "odo_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
