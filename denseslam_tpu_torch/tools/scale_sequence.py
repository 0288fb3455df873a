"""Offline dataset downscaling tool (port of scripts/scale_sequence.py,
without cv2; reference: scripts/scale_sequence.py — produce a
reduced-resolution copy of a sequence so the pipeline runs at low res).

The output is a self-consistent dataset directory: color/gray images are
area-resampled, depth maps are nearest-resampled (no value change),
disparity maps are nearest-resampled AND value-scaled by the factor
(disparity is measured in pixels), PFM disparities likewise, and KITTI
calib.txt P-matrices are rescaled (fx, fy, cx, cy, tx all multiply by the
factor, so the recovered baseline is unchanged). Images are PNG, read and
written by io/png.py with cv2's pixels and resizes (INTER_AREA,
INTER_NEAREST); a JPEG image is not read (the port has no JPEG decoder)
and is reported as skipped.

Usage:
  python -m denseslam_tpu_torch.tools.scale_sequence SRC_ROOT DST_ROOT \\
      --scale 0.5 [--dataset_type kitti_odometry]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..io import pfm, png
from ..io.datasets import CONFIGS, DatasetType

META_FILES = ("associate.txt", "rgb.txt", "depth.txt", "times.txt",
              "poses_gt.txt", "groundtruth.txt")


def scale_calib_kitti(src: str, dst: str, s: float) -> None:
    """Rescale all P0..P3 projection rows by s (pixel-unit entries only)."""
    out_lines = []
    with open(src) as f:
        for line in f:
            if ":" not in line:
                out_lines.append(line.rstrip("\n"))
                continue
            name, rest = line.split(":", 1)
            vals = rest.split()
            if name.strip().startswith("P") and len(vals) == 12:
                p = np.array([float(v) for v in vals]).reshape(3, 4)
                p[:2, :] *= s  # rows in pixel units: fx,0,cx,tx / 0,fy,cy,ty
                out_lines.append(
                    name + ": " + " ".join(f"{v:.12e}" for v in p.reshape(-1))
                )
            else:
                out_lines.append(line.rstrip("\n"))
    with open(dst, "w") as f:
        f.write("\n".join(out_lines) + "\n")


def resize(img: np.ndarray, s: float, nearest: bool) -> np.ndarray:
    """cv2.resize to round(w * s) x round(h * s), nearest or area."""
    h, w = img.shape[:2]
    size = (max(1, int(round(w * s))), max(1, int(round(h * s))))
    if nearest:
        return png.resize_nearest(img, size)
    return png.resize_area(img, size)


def process_folder(src: str, dst: str, s: float, kind: str) -> int:
    """kind: 'color' | 'depth' | 'disparity'. Returns files written."""
    if not os.path.isdir(src):
        return 0
    os.makedirs(dst, exist_ok=True)
    n = 0
    for fname in sorted(os.listdir(src)):
        sp, dp = os.path.join(src, fname), os.path.join(dst, fname)
        if fname.endswith(".pfm"):
            disp = np.asarray(pfm.read_pfm(sp), np.float32)
            out = resize(disp, s, nearest=True)
            if kind == "disparity":
                out = out * np.float32(s)
            pfm.write_pfm(dp, out)
            n += 1
            continue
        if fname.lower().endswith((".jpg", ".jpeg")):
            print(f"skipped {sp}: JPEG is not read")
            continue
        if not fname.lower().endswith(".png"):
            continue
        img = png.read_png(sp)
        if kind == "color":
            out = resize(img, s, nearest=False)
        elif kind == "depth":
            out = resize(img, s, nearest=True)
        else:  # disparity png: pixel-valued — scale values too
            vals = resize(img.astype(np.float32), s, nearest=True) * s
            out = np.clip(np.rint(vals), 0, np.iinfo(img.dtype).max).astype(
                img.dtype
            )
        png.write_png(dp, out)
        n += 1
    return n


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--scale", type=float, required=True)
    ap.add_argument(
        "--dataset_type",
        default="kitti_odometry",
        choices=[t.name.lower() for t in DatasetType],
    )
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    s = args.scale
    if not 0.0 < s <= 1.0:
        raise SystemExit("scale must be in (0, 1]")
    cfg = CONFIGS[DatasetType[args.dataset_type.upper()]]()

    total = 0
    for folder in (cfg.left_gray_folder, cfg.right_gray_folder,
                   cfg.left_color_folder, cfg.right_color_folder):
        if folder:
            total += process_folder(
                os.path.join(args.src, folder), os.path.join(args.dst, folder),
                s, "color")
    kind = "disparity" if cfg.depth_is_disparity else "depth"
    total += process_folder(
        os.path.join(args.src, cfg.depth_folder),
        os.path.join(args.dst, cfg.depth_folder), s, kind)

    calib = os.path.join(args.src, cfg.calibration_fname)
    if cfg.calibration_fname and os.path.exists(calib):
        scale_calib_kitti(
            calib, os.path.join(args.dst, cfg.calibration_fname), s)
    # TUM-style association / trajectory files copy through unchanged
    for meta in META_FILES:
        mp = os.path.join(args.src, meta)
        if os.path.exists(mp):
            with open(mp) as f:
                data = f.read()
            with open(os.path.join(args.dst, meta), "w") as f:
                f.write(data)
    print(f"wrote {total} images at scale {s} -> {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
