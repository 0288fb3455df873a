"""Plot per-frame dense-map memory curves (port of scripts/memory_draw.py,
without matplotlib; reference: memoryDraw.py, the figure comparing the
baseline / decay / slide-window / decay + slide-window memory*.txt series).

One curve per log, in matplotlib's colour cycle: x the frame, y the line's
value x 100 (the memory.txt convention: one line per frame in units of 100
MB), labelled by the log's file name; grid lines, ticks, axis labels and a
legend to the right of the plot area. Each curve carries 8 markers along
it, staggered between the curves, so that curves that coincide (a profile
that never bites) each stay in sight. The figure is 1040x585 (the JAX
script's 8 x 4.5 in at 130 dpi), drawn by io/plot.py and written as a PNG
by io/png.py.

Usage: python -m denseslam_tpu_torch.tools.memory_draw out.png memory_a.txt
       [memory_b.txt ...]
"""

from __future__ import annotations

import os
import sys
from typing import List, Tuple

import numpy as np

from ..io import plot

FIG_W, FIG_H = 1040, 585
MARKS = 8               # markers along each curve


def read_log(path: str) -> List[float]:
    """A memory log's values, one per non-empty line (units of 100 MB)."""
    with open(path) as f:
        return [float(ln) for ln in f if ln.strip()]


def figure(paths: List[str]) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """The figure of the logs as an (H, W, 3) uint8 RGB image, and its
    plot area (x0, y0, x1, y1), the frame inclusive."""
    img = np.full((FIG_H, FIG_W, 3), 255, np.uint8)
    p = plot.Plot(img, (0, 0, FIG_W, FIG_H), xlabel="frame",
                  ylabel="dense map memory (MB)")
    logs = [read_log(path) for path in paths]
    for k, (path, vals) in enumerate(zip(paths, logs)):
        label = os.path.splitext(os.path.basename(path))[0]
        # MARKS marks a curve, the k-th curve's a (k + 0.5) / n step on
        step = (len(vals) - 1) / MARKS
        p.add(range(len(vals)), [v * 100 for v in vals],
              plot.TAB10[k % len(plot.TAB10)], label=label,
              mark_x=((np.arange(MARKS) + (k + 0.5) / len(paths)) * step
                      if len(vals) > 1 else None))
    return img, p.draw()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        return 1
    out = argv[0]
    img, _ = figure(argv[1:])
    plot.write_rgb(out, img)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
