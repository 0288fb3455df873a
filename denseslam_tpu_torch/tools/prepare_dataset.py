"""Dataset preparation and validation (port of scripts/prepare_dataset.py).

  validate  check a sequence folder against its layout (images, calib,
            depth or disparity, ground-truth poses) and report what is
            missing: 0 when nothing but notes, 1 otherwise.
  gt-poses  copy a KITTI odometry poses/<seq>.txt (3x4 rows) into
            SEQ_DIR/poses_gt.txt, the file the scoring tools read.
  synth     write the synthetic fixture sequence (make_synthetic_dataset)
            for smoke runs without external data, on the CUDA card unless
            --device says otherwise.

There is no fetch step: the tool reads and writes local folders only.

Usage:
  python -m denseslam_tpu_torch.tools.prepare_dataset validate ROOT
      [--dataset_type ...]
  python -m denseslam_tpu_torch.tools.prepare_dataset gt-poses POSES_TXT SEQ_DIR
  python -m denseslam_tpu_torch.tools.prepare_dataset synth OUT_DIR
      [--frames N] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

from . import common


def cmd_validate(args) -> int:
    from ..io.datasets import CONFIGS, DatasetType

    cfg = CONFIGS[DatasetType[args.dataset_type.upper()]]()
    root = args.root
    problems = []
    folders = dict(
        left_gray=cfg.left_gray_folder, right_gray=cfg.right_gray_folder,
        left_color=cfg.left_color_folder, right_color=cfg.right_color_folder,
        depth=cfg.depth_folder,
    )
    counts = {}
    for name, sub in folders.items():
        if not sub:
            continue
        p = os.path.join(root, sub)
        if not os.path.isdir(p):
            counts[name] = None
            continue
        counts[name] = len([f for f in os.listdir(p)
                            if f.endswith((".png", ".jpg", ".pfm"))])
    # gray and color folder pairs are alternatives (use_color flag)
    for side in ("left", "right"):
        g, c = counts.get(f"{side}_gray"), counts.get(f"{side}_color")
        if g is None and c is None:
            problems.append(f"missing {side} image folder "
                            f"({folders[side + '_gray']} or "
                            f"{folders[side + '_color']})")
        elif g is None or c is None:
            missing = (folders[f"{side}_gray"] if g is None
                       else folders[f"{side}_color"])
            problems.append(f"note: {missing} absent (ok unless the other "
                            "image mode is requested)")
    if counts.get("depth") is None:
        problems.append(f"missing depth folder {folders['depth']} "
                        "(ok with --compute_depth)")
    counts = {k: v for k, v in counts.items() if v is not None}
    if cfg.calibration_fname and not os.path.exists(
            os.path.join(root, cfg.calibration_fname)):
        problems.append(f"missing calibration {cfg.calibration_fname}")
    if cfg.timestamped and not any(
            os.path.exists(os.path.join(root, f))
            for f in ("associate.txt", "rgb.txt")):
        problems.append("missing associate.txt / rgb.txt timestamp index")
    if not os.path.exists(os.path.join(root, "poses_gt.txt")):
        problems.append("note: no poses_gt.txt (trajectory eval disabled)")
    n = {c for c in counts.values() if c}
    if len(n) > 1:
        problems.append(f"frame-count mismatch across folders: {counts}")
    print(f"{root}: {counts}")
    for p in problems:
        print("  !", p)
    hard = [p for p in problems if not p.startswith("note:")]
    print("OK" if not hard else f"{len(hard)} problem(s)")
    return 1 if hard else 0


def cmd_gt_poses(args) -> int:
    """KITTI odometry GT: poses/<seq>.txt (3x4 rows) -> SEQ_DIR/poses_gt.txt
    (the same rows)."""
    with open(args.poses_txt) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    out = os.path.join(args.seq_dir, "poses_gt.txt")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {len(lines)} poses -> {out}")
    return 0


def cmd_synth(args) -> int:
    from . import make_synthetic_dataset
    return make_synthetic_dataset.main(
        [args.out, "--frames", str(args.frames)]
        + common.device_args(args.device))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("validate")
    v.add_argument("root")
    v.add_argument("--dataset_type", default="kitti_odometry")
    g = sub.add_parser("gt-poses")
    g.add_argument("poses_txt")
    g.add_argument("seq_dir")
    s = sub.add_parser("synth")
    s.add_argument("out")
    s.add_argument("--frames", type=int, default=30)
    s.add_argument("--device", default=None,
                   help="torch device of the render (default: the card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return dict(validate=cmd_validate, **{"gt-poses": cmd_gt_poses},
                synth=cmd_synth)[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
