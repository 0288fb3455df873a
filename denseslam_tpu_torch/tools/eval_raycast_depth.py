"""Score raycast-depth dumps against ground-truth depth maps (port of
scripts/eval_raycast_depth.py, without cv2).

Pairs the 16-bit PNG dumps (depth x 256) with the ground truth by file
name, applies the KITTI crop (unless --no-crop) and the valid mask, and
reports the mean over frames of MAE / RMSE / AbsRel / lg10 / SqRel and the
delta shares (eval/depth_metrics.py); --input-dir also scores the raw
input depth dumps. Prints the JSON ({"raycast": ..., "input": ...}, each
with its "frames") and writes it to --out; returns 1 when no file name is
in both folders.

Usage:
  python -m denseslam_tpu_torch.tools.eval_raycast_depth RAYCAST_DIR GT_DIR
      [--input-dir D] [--no-crop] [--out metrics.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..io import png


def load_depth_png(path: str) -> np.ndarray:
    """A depth PNG (x 256) in metres."""
    return png.read_png(path).astype(np.float32) / 256.0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("raycast_dir")
    ap.add_argument("gt_dir")
    ap.add_argument("--input-dir", default=None,
                    help="also score the raw input depth dumps")
    ap.add_argument("--no-crop", action="store_true")
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..eval import depth_metrics as dm

    names = sorted(
        n for n in os.listdir(args.raycast_dir)
        if n.endswith(".png") and os.path.exists(os.path.join(args.gt_dir, n))
    )
    if not names:
        print("no overlapping frames", file=sys.stderr)
        return 1

    def accumulate(src_dir):
        accs = []
        for n in names:
            pred = load_depth_png(os.path.join(src_dir, n))
            gt = load_depth_png(os.path.join(args.gt_dir, n))
            accs.append(dm.depth_metrics(pred, gt, crop=not args.no_crop))
        keys = [k for k in accs[0] if k != "n"]
        agg = {k: float(np.nanmean([a[k] for a in accs])) for k in keys}
        agg["frames"] = len(accs)
        return agg

    result = {"raycast": accumulate(args.raycast_dir)}
    if args.input_dir:
        result["input"] = accumulate(args.input_dir)
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
