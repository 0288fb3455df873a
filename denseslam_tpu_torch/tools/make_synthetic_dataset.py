"""Render the analytic synthetic scene into a KITTI-odometry folder layout
(port of scripts/make_synthetic_dataset.py, without cv2): the fixture that
every experiment tool runs on without external data.

It writes the JAX script's files under its names: image_0/ and image_1/
(8-bit gray PNGs, the render truncated to uint8), disparity PFMs in
precomputed-depth/ (fx * B / depth, 0 where there is no depth), depth_gt/
(16-bit PNGs of depth x 256, clipped; what eval_raycast_depth scores
against), calib.txt (P0, P1) and poses_gt.txt (KITTI rows). The camera is
tiny_test_config(width, height, baseline)'s: fx = fy = 0.75 W, the
principal point at the image centre. Rendering runs on the CUDA card
unless --device says otherwise.

Usage: python -m denseslam_tpu_torch.tools.make_synthetic_dataset OUT_DIR
       [--frames N] [--width W --height H --baseline B] [--step S]
       [--yaw Y] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--baseline", type=float, default=0.3)
    ap.add_argument("--step", type=float, default=0.05)
    ap.add_argument("--yaw", type=float, default=0.004)
    ap.add_argument("--device", default=None,
                    help="torch device of the render (default: the card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..config import tiny_test_config
    from ..device import resolve_device
    from ..io import datasets, pfm, png, synthetic, trajectory
    from ..io.make_dataset import write_calib, write_depth_gt

    dev = resolve_device(args.device)
    cfg = tiny_test_config(width=args.width, height=args.height,
                           baseline_m=args.baseline)
    ds = datasets.kitti_odometry_config()
    gtdir = os.path.join(args.out, "depth_gt")
    for sub in (ds.left_gray_folder, ds.right_gray_folder, ds.depth_folder,
                "depth_gt"):
        os.makedirs(os.path.join(args.out, sub), exist_ok=True)
    poses = synthetic.make_trajectory(args.frames, step_m=args.step,
                                      yaw_rate=args.yaw)
    intr = cfg.rig.intr
    for i in range(args.frames):
        left, right, depth = (t.cpu().numpy() for t in synthetic.render_stereo(
            poses[i], cfg.rig, device=dev))
        name = f"{i:06d}"
        png.write_png(os.path.join(args.out, ds.left_gray_folder,
                                   name + ".png"), left.astype(np.uint8))
        png.write_png(os.path.join(args.out, ds.right_gray_folder,
                                   name + ".png"), right.astype(np.uint8))
        disp = np.where(depth > 0, intr.fx * cfg.rig.baseline_m
                        / np.maximum(depth, 1e-6), 0)
        pfm.write_pfm(os.path.join(args.out, ds.depth_folder, name + ".pfm"),
                      disp.astype(np.float32))
        write_depth_gt(os.path.join(gtdir, name + ".png"), depth)
    write_calib(os.path.join(args.out, "calib.txt"), intr,
                cfg.rig.baseline_m)
    trajectory.save_kitti(os.path.join(args.out, "poses_gt.txt"), list(poses))
    print(f"wrote {args.frames} frames to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
