"""The regularisation sweep over sequences (port of scripts/tracking_exp.py,
after the reference's tracking_basic_exp.sh): for every sequence folder and
every profile of PROFILES (none, decay, slide window, decay + slide
window) the command line with its memory log (memory_{seq}_{profile}.txt),
KITTI trajectory ({seq}_{profile}_traj.txt) and summary
({seq}_{profile}.json); sweep.json holds every summary with its sequence
and profile. The decay defaults are the reference's conservative ones for
mostly still sequences (age 300, weight 3). Each run is in this process
and frees its map before the next; it runs on the CUDA card unless
--device says otherwise.

Usage: python -m denseslam_tpu_torch.tools.tracking_exp SEQ_DIR [SEQ_DIR ...]
       --out OUT [--frames N] [--dataset_type kitti_tracking]
       [--min_decay_age 300] [--max_decay_weight 3] [--profiles ...]
       [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from . import common

PROFILES = {
    "none": [],
    "decay": ["--voxel_decay"],
    "slide": ["--slide_window"],
    "decay_slide": ["--voxel_decay", "--slide_window"],
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seqs", nargs="+")
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--dataset_type", default="kitti_tracking")
    ap.add_argument("--min_decay_age", type=int, default=300)
    ap.add_argument("--max_decay_weight", type=float, default=3.0)
    ap.add_argument("--profiles", nargs="+", default=list(PROFILES),
                    choices=list(PROFILES))
    ap.add_argument("--device", default=None,
                    help="torch device of the runs (default: the card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    results = []
    for seq in args.seqs:
        name = os.path.basename(os.path.normpath(seq))
        for prof in args.profiles:
            tag = f"{name}_{prof}"
            mj = os.path.join(args.out, f"{tag}.json")
            argv = [
                "--dataset_root", seq,
                "--dataset_type", args.dataset_type,
                "--min_decay_age", str(args.min_decay_age),
                "--max_decay_weight", str(args.max_decay_weight),
                "--save_memory_log", os.path.join(args.out, f"memory_{tag}.txt"),
                "--save_kitti_trajectory",
                os.path.join(args.out, f"{tag}_traj.txt"),
                "--metrics_json", mj, "--quiet",
            ] + PROFILES[prof]
            if args.frames:
                argv += ["--frame_limit", str(args.frames)]
            common.run_main(argv, args.device)
            with open(mj) as f:
                m = json.load(f)
            m.update(sequence=name, profile=prof)
            results.append(m)
            print(f"{tag}: blocks={m['final_blocks']} "
                  f"mem={m['final_memory_mb']:.1f}MB fps={m['fps']:.2f}")
    with open(os.path.join(args.out, "sweep.json"), "w") as f:
        json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
