"""Offline viewer: a run's map and trajectory in one contact sheet (port of
scripts/contact_sheet.py, without matplotlib; the headless stand-in for
the reference's GUI panes, DenseSLAMGUI.cpp:312-542).

Loads a checkpoint (io/checkpoint.py) into a DenseSLAM of
tiny_test_config(width, height, baseline) with the map flags given,
renders the map (DenseSLAM.raycast_view) at the last pose of its history
and draws 2 x 3 panes: the render's colour and normals (render_preview),
its depth under the Turbo colour table with a colour bar, the trajectory
in x-z, the memory curve of --memory-log (values x 100 = MB; blank
without one) and the run's stats (frames, keyframes, blocks, map MB). An
image pane wider than PANE_W pixels is shrunk to it by nearest
resampling. The sheet is drawn by io/plot.py and written as one PNG; it
renders on the CUDA card unless --device says otherwise.

Usage: python -m denseslam_tpu_torch.tools.contact_sheet CKPT.npz OUT.png
       [--memory-log memory.txt] [--voxel-size V] [--width W --height H]
       [--baseline B] [--max-depth D] [--table-log2 N] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, Tuple

import numpy as np

from ..io import plot, png

PANE_W = 480            # the widest an image pane is drawn
BAR_ROOM = 56           # room right of a pane for the depth colour bar
PLOT_H = 240            # the least height of the lower row's panes
PAD = plot.PAD
TITLE_H = plot.TITLE_H


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ckpt")
    ap.add_argument("out")
    ap.add_argument("--memory-log", default=None)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--baseline", type=float, default=0.3)
    ap.add_argument("--voxel-size", type=float, default=0.05)
    ap.add_argument("--max-depth", type=float, default=10.0)
    ap.add_argument("--table-log2", type=int, default=14)
    ap.add_argument("--device", default=None,
                    help="torch device of the render (default: the card)")
    return ap


def load_slam(args):
    """The DenseSLAM of the sheet's flags with the checkpoint loaded."""
    from ..config import tiny_test_config
    from ..device import resolve_device
    from ..io.checkpoint import load_slam_checkpoint
    from ..models.dense_slam import DenseSLAM

    cfg = tiny_test_config(width=args.width, height=args.height,
                           baseline_m=args.baseline)
    cfg = dataclasses.replace(
        cfg,
        tsdf=dataclasses.replace(
            cfg.tsdf, voxel_size_m=args.voxel_size,
            trunc_dist_m=args.voxel_size * 4,
            table_slots=1 << args.table_log2,
            max_visible_blocks=1 << (args.table_log2 - 2),
            max_alloc_per_frame=1 << (args.table_log2 - 2),
            max_depth_m=args.max_depth,
        ),
    )
    slam = DenseSLAM(cfg, device=resolve_device(args.device))
    load_slam_checkpoint(args.ckpt, slam)
    return slam


def last_pose(slam) -> np.ndarray:
    """The last pose of the run's history (the identity without one)."""
    if slam.pose_history:
        return np.asarray(slam.pose_history[-1][1], np.float32)
    return np.eye(4, dtype=np.float32)


def pane_size(w: int, h: int) -> Tuple[int, int]:
    """An image pane's (width, height): the image's, shrunk to PANE_W."""
    if w <= PANE_W:
        return w, h
    return PANE_W, max(1, int(round(h * PANE_W / w)))


def fit(img: np.ndarray) -> np.ndarray:
    """An image at its pane's size (nearest resampling when shrunk)."""
    size = pane_size(img.shape[1], img.shape[0])
    if size == (img.shape[1], img.shape[0]):
        return img
    return png.resize_nearest(img, size)


def layout(w: int, h: int) -> Dict[str, Tuple[int, int, int, int]]:
    """Where each pane of a sheet of w x h renders lies: the image panes'
    pixels (x, y, width, height), the lower panes' rectangles, and the
    whole sheet's size under "sheet"."""
    pw, ph = pane_size(w, h)
    cw = pw + 2 * PAD + BAR_ROOM
    top = PAD + TITLE_H + ph + PAD
    low = max(top, PLOT_H)
    rects = {name: (k * cw + PAD, PAD + TITLE_H, pw, ph)
             for k, name in enumerate(("color", "normal", "depth"))}
    rects.update({name: (k * cw, top, cw, low)
                  for k, name in enumerate(("trajectory", "memory",
                                            "stats"))})
    rects["sheet"] = (0, 0, 3 * cw, top + low)
    return rects


def sheet(slam, rc, memory_log=None) -> np.ndarray:
    """The contact sheet of `slam` and its render `rc` as an (H, W, 3)
    uint8 RGB image."""
    from ..ops import raycast as rc_ops

    def host(t):
        return t.cpu().numpy()

    h, w = rc.depth.shape
    rects = layout(w, h)
    img = np.full((rects["sheet"][3], rects["sheet"][2], 3), 255, np.uint8)

    def pane(name, title, pixels):
        x, y, _, _ = rects[name]
        plot.image_pane(img, x, y, fit(pixels), title)

    pane("color", "raycast color",
         host(rc_ops.render_preview(rc, rc_ops.PREVIEW_COLOR)))
    pane("normal", "normals",
         host(rc_ops.render_preview(rc, rc_ops.PREVIEW_NORMAL)))
    d = host(rc.depth).astype(np.float64)
    d = np.where(d > 0, d, np.nan)
    lo, hi = ((float(np.nanmin(d)), float(np.nanmax(d)))
              if np.isfinite(d).any() else (0.0, 1.0))
    pane("depth", "raycast depth (m)", plot.colorize(d, lo, hi))
    x, y, pw, ph = rects["depth"]
    plot.colorbar(img, x + pw + PAD, y, ph, lo, hi)

    traj = (np.stack([np.asarray(p[1])[:3, 3] for p in slam.pose_history])
            if slam.pose_history else np.zeros((1, 3)))
    tp = plot.Plot(img, rects["trajectory"], title="trajectory (x-z)",
                   equal=True)
    tp.add(traj[:, 0], traj[:, 2], plot.TAB10[0], markers=True)
    tp.draw()
    if memory_log and os.path.exists(memory_log):
        with open(memory_log) as f:
            vals = [float(ln) * 100 for ln in f if ln.strip()]
        mp = plot.Plot(img, rects["memory"], title="map memory (MB)")
        mp.add(range(len(vals)), vals, plot.TAB10[0])
        mp.draw()
    x, y, _, _ = rects["stats"]
    plot.text_block(img, x + 4 * PAD, y + 4 * PAD, [
        f"frames: {slam.frame}",
        f"keyframes: {slam.current_keyframes}",
        f"blocks: {slam.submaps.local_map_size(slam.submaps.active_idx)}",
        f"map memory: {slam.memory_bytes() / 1e6:.1f} MB"])
    return img


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    slam = load_slam(args)
    rc = slam.raycast_view(last_pose(slam))
    plot.write_rgb(args.out, sheet(slam, rc, args.memory_log))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
