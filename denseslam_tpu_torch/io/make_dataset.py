"""Write a synthetic sequence on disk in a dataset layout that
io/datasets.py reads (the counterpart of scripts/make_synthetic_dataset.py,
rendered by io/synthetic.py).

    python -m denseslam_tpu_torch.io.make_dataset OUT --frames N \\
        [--width W --height H] [--layout kitti|tum] [--scene ...] [--device cpu]

  kitti  KITTI odometry: image_0/, image_1/ (8-bit gray PNG), disparity
         PFMs in precomputed-depth/ (fx * B / depth, 0 where there is no
         depth), calib.txt with P0 / P1 (fx = fy = --fx, default 0.75 W;
         the principal point at the image centre; baseline --baseline).
  tum    TUM RGB-D: rgb/ (the gray render in three channels) and depth/
         (16-bit PNG, depth * 5000, 0 where invalid or past 13.1 m), both
         named by timestamp (10 s + 0.1 s a frame); the TUM reader takes the
         freiburg1 intrinsics (640 x 480) from the folder name, so this
         layout is rendered at them.

Both layouts also get the ground truth: poses.txt (KITTI rows) and
groundtruth.txt (TUM lines). The trajectory is --scene's: `default` and
`street` follow make_trajectory(N, --step_m, --yaw_rate); `loop` is the
first N frames of the loop drive make_loop_trajectory(500, radius 18 m,
76 closure frames) in loop_scene. Images are quantised to 8 bits by
truncation, after the optional nuisance: a gain of 1 + --gain sin(2 pi t /
150) and Gaussian photometric noise of sigma --noise on each image, and on
TUM depth --depth_noise relative noise and --holes of the pixels dropped,
all drawn by numpy from --seed. Rendering runs on the CUDA card unless
--device says otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

TUM_DEPTH_SCALE = 5000.0


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out")
    p.add_argument("--frames", type=int, required=True)
    p.add_argument("--width", type=int, default=None,
                   help="KITTI image width (default 1226)")
    p.add_argument("--height", type=int, default=None,
                   help="KITTI image height (default 370)")
    p.add_argument("--layout", default="kitti", choices=["kitti", "tum"])
    p.add_argument("--scene", default="default",
                   choices=["default", "street", "loop"])
    p.add_argument("--fx", type=float, default=None)
    p.add_argument("--baseline", type=float, default=0.3)
    p.add_argument("--step_m", type=float, default=0.06)
    p.add_argument("--yaw_rate", type=float, default=0.004)
    p.add_argument("--gain", type=float, default=0.0)
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--depth_noise", type=float, default=0.0)
    p.add_argument("--holes", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None)
    return p.parse_args(argv)


def _trajectory(args):
    from . import synthetic
    if args.scene == "loop":
        gt = synthetic.make_loop_trajectory(500, radius_m=18.0,
                                            closure_frames=76)
        if args.frames > len(gt):
            raise SystemExit(f"the loop drive has {len(gt)} frames")
        return gt[:args.frames], synthetic.loop_scene(gt)
    poses = synthetic.make_trajectory(args.frames, step_m=args.step_m,
                                      yaw_rate=args.yaw_rate)
    scene = (synthetic.street_scene() if args.scene == "street"
             else synthetic.default_scene())
    return poses, scene


def poses_and_scene(argv):
    """The true poses and the scene of the sequence that `argv` (the
    command line's arguments) describes, without rendering it."""
    return _trajectory(_args(argv))


def _nuisance(img: np.ndarray, t: int, args, rng) -> np.ndarray:
    """Gain ramp and photometric noise, then 8-bit truncation."""
    img = img * (1.0 + args.gain * np.sin(2 * np.pi * t / 150.0))
    if args.noise:
        img = img + args.noise * rng.standard_normal(img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_calib(path: str, intr, baseline_m: float) -> None:
    """KITTI's calib.txt with the rectified pair's P0 and P1 rows."""
    with open(path, "w") as f:
        f.write(f"P0: {intr.fx} 0 {intr.cx} 0  0 {intr.fy} {intr.cy} 0  "
                "0 0 1 0\n")
        f.write(f"P1: {intr.fx} 0 {intr.cx} {-intr.fx * baseline_m}  "
                f"0 {intr.fy} {intr.cy} 0  0 0 1 0\n")


def write_depth_gt(path: str, depth_m: np.ndarray) -> None:
    """Ground-truth depth as a 16-bit PNG of depth x 256, clipped, as
    scripts/make_synthetic_dataset.py writes it for the depth scorer."""
    from .png import write_png
    write_png(path, np.clip(depth_m * 256.0, 0, 65535).astype(np.uint16))


def _write_gt(out: str, poses: np.ndarray, stamps) -> None:
    from .trajectory import save_kitti, save_tum
    save_kitti(os.path.join(out, "poses.txt"), list(poses))
    save_tum(os.path.join(out, "groundtruth.txt"), list(zip(stamps, poses)))


def make_dataset(argv=None) -> str:
    """Write the sequence that `argv` (the command line's arguments)
    describes; returns its root."""
    args = _args(argv)
    from . import png, synthetic
    from .datasets import TUM_INTRINSICS, kitti_odometry_config
    from .pfm import write_pfm
    from ..device import resolve_device
    from ..utils.camera import Intrinsics, StereoRig

    dev = resolve_device(args.device)
    poses, scene = _trajectory(args)
    rng = np.random.default_rng(args.seed)
    out = args.out
    if args.layout == "tum":
        intr = TUM_INTRINSICS["fr1"]
        if (args.width or intr.width, args.height or intr.height) != (
                intr.width, intr.height):
            raise SystemExit("the TUM layout is rendered at the freiburg1 "
                             f"size {intr.width}x{intr.height}")
        for sub in ("rgb", "depth"):
            os.makedirs(os.path.join(out, sub), exist_ok=True)
        stamps = []
        for t in range(args.frames):
            gray, depth = synthetic.render_view(poses[t], intr, scene,
                                                device=dev)
            gray, depth = gray.cpu().numpy(), depth.cpu().numpy()
            img = _nuisance(gray, t, args, rng)
            d = depth * (1.0 + args.depth_noise * rng.standard_normal(
                depth.shape))
            d[(rng.random(depth.shape) < args.holes) | (depth <= 0)] = 0.0
            d16 = np.round(d * TUM_DEPTH_SCALE)
            d16 = np.where(d16 > 65535, 0, d16).astype(np.uint16)
            ts = 10.0 + 0.1 * t
            stamps.append(ts)
            png.write_png(os.path.join(out, "rgb", f"{ts:.6f}.png"),
                          np.repeat(img[..., None], 3, axis=-1))
            png.write_png(os.path.join(out, "depth", f"{ts:.6f}.png"), d16)
        _write_gt(out, poses, stamps)
        return out

    w, h = args.width or 1226, args.height or 370
    fx = args.fx if args.fx is not None else 0.75 * w
    intr = Intrinsics(fx=fx, fy=fx, cx=w / 2 - 0.5, cy=h / 2 - 0.5,
                      width=w, height=h)
    rig = StereoRig(intr=intr, baseline_m=args.baseline)
    ds = kitti_odometry_config()
    for sub in (ds.left_gray_folder, ds.right_gray_folder, ds.depth_folder):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    for t in range(args.frames):
        left, right, depth = synthetic.render_stereo_trajectory(
            poses[t:t + 1], rig, scene, device=dev)
        name = f"{t:06d}"
        for folder, img in ((ds.left_gray_folder, left),
                            (ds.right_gray_folder, right)):
            png.write_png(os.path.join(out, folder, name + ".png"),
                          _nuisance(img[0].cpu().numpy(), t, args, rng))
        d = depth[0].cpu().numpy()
        disp = np.where(d > 0, fx * args.baseline / np.maximum(d, 1e-6), 0)
        write_pfm(os.path.join(out, ds.depth_folder, name + ".pfm"),
                  disp.astype(np.float32))
    write_calib(os.path.join(out, "calib.txt"), intr, args.baseline)
    _write_gt(out, poses, [float(t) for t in range(args.frames)])
    return out


if __name__ == "__main__":
    make_dataset()
    sys.exit(0)
