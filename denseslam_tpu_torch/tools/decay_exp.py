"""Voxel-decay parameter sweep (port of scripts/decay_exp.py): the command
line over a dataset for each (min_decay_age, max_decay_weight) pair, then
once without decay as the baseline, recording each run's memory curve
(memory_decay_a{age}_w{weight}.txt, memory_baseline.txt) and summary
({tag}.json, baseline.json); sweep.json holds the pairs' summaries. Each
run is in this process and frees its map before the next; it runs on the
CUDA card unless --device says otherwise.

Usage: python -m denseslam_tpu_torch.tools.decay_exp DATASET_ROOT OUT_DIR
       [--frames N] [--ages 10 20 30] [--weights 1 2 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

from . import common


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("out")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--ages", type=int, nargs="+", default=[10, 20, 30])
    ap.add_argument("--weights", type=float, nargs="+", default=[1, 2, 3])
    ap.add_argument("--device", default=None,
                    help="torch device of the runs (default: the card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    limit = ["--frame_limit", str(args.frames)] if args.frames else []

    results = []
    for age, wgt in itertools.product(args.ages, args.weights):
        tag = f"decay_a{age}_w{wgt:g}"
        mj = os.path.join(args.out, f"{tag}.json")
        common.run_main([
            "--dataset_root", args.root,
            "--voxel_decay", "--min_decay_age", str(age),
            "--max_decay_weight", str(wgt),
            "--save_memory_log", os.path.join(args.out, f"memory_{tag}.txt"),
            "--metrics_json", mj, "--quiet",
        ] + limit, args.device)
        with open(mj) as f:
            m = json.load(f)
        m.update(min_decay_age=age, max_decay_weight=wgt)
        results.append(m)
        print(f"{tag}: blocks={m['final_blocks']} "
              f"mem={m['final_memory_mb']:.1f}MB fps={m['fps']:.2f}")
    # baseline without decay
    common.run_main([
        "--dataset_root", args.root,
        "--save_memory_log", os.path.join(args.out, "memory_baseline.txt"),
        "--metrics_json", os.path.join(args.out, "baseline.json"), "--quiet",
    ] + limit, args.device)
    with open(os.path.join(args.out, "sweep.json"), "w") as f:
        json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
