"""Fusion-frequency sweep (port of scripts/lowfreq_exp.py): the command
line fusing every k-th frame for each k, with its raycast depth dumps
(raycast_k{k}/) and summary (lowfreq_k{k}.json); lowfreq_sweep.json holds
the summaries with their k. Each run is in this process and frees its map
before the next; it runs on the CUDA card unless --device says otherwise.

Usage: python -m denseslam_tpu_torch.tools.lowfreq_exp DATASET_ROOT OUT_DIR
       [--ks 1 2 4] [--frames N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from . import common


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("out")
    ap.add_argument("--ks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the runs (default: the card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    results = []
    for k in args.ks:
        mj = os.path.join(args.out, f"lowfreq_k{k}.json")
        cmd = [
            "--dataset_root", args.root,
            "--keyframe_every", str(k),
            "--save_raycast_depth_dir", os.path.join(args.out, f"raycast_k{k}"),
            "--metrics_json", mj, "--quiet",
        ]
        if args.frames:
            cmd += ["--frame_limit", str(args.frames)]
        common.run_main(cmd, args.device)
        with open(mj) as f:
            m = json.load(f)
        m["keyframe_every"] = k
        results.append(m)
        print(f"k={k}: fps={m['fps']:.2f} blocks={m['final_blocks']}")
    with open(os.path.join(args.out, "lowfreq_sweep.json"), "w") as f:
        json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
