"""Line plots, image panes and colour tables on numpy RGB images: the
port's stand-in for the matplotlib figures of scripts/memory_draw.py and
scripts/contact_sheet.py (tools/memory_draw.py, tools/contact_sheet.py).

A `Plot` fills a rectangle of an (H, W, 3) uint8 RGB image: a white
background, grid lines at the ticks, the series as anti-aliased polylines
(io/draw.py's Canvas, cv2's LINE_AA) with their middle pixels set to the
series' exact colour (`polyline_core`) and optional filled markers (on
its points, or along it at given x; drawn over all the lines), a black
frame, tick marks and labels, axis labels and a title (io/font.py), and a
legend to the right of the plot area. Its limits are the data's range
widened by 5% a side (matplotlib's margins), its ticks at 1, 2, 2.5 or 5
times a power of ten (matplotlib's MaxNLocator steps). `write_rgb` writes
such an image as a PNG (io/png.py takes BGR).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import font, png
from .draw import Canvas

WHITE = (255, 255, 255)
BLACK = (0, 0, 0)
GRID = (231, 231, 231)      # matplotlib's grid (#b0b0b0) at alpha 0.3 on white
# matplotlib's default colour cycle (tab10)
TAB10 = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
         (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
         (188, 189, 34), (23, 190, 207))
MARGIN = 0.05
TICK = 3                    # tick mark length, px
PAD = 4
TITLE_H = font.GLYPH_H + PAD  # a title's line above a pane
BAR_W = 12                  # colour bar width, px


def _turbo_table() -> np.ndarray:
    """Google's Turbo colour map through its published polynomial
    approximation (A. Mikhailov, 2019), tabulated at 256 points, uint8."""
    x = np.linspace(0.0, 1.0, 256)
    p = np.stack([x ** k for k in range(6)], axis=1)
    coef = np.array([
        [0.13572138, 4.61539260, -42.66032258, 132.13108234,
         -152.94239396, 59.28637943],
        [0.09140261, 2.19418839, 4.84296658, -14.18503333,
         4.27729857, 2.82956604],
        [0.10667330, 12.64194608, -60.58204836, 110.36276771,
         -89.90310912, 27.34824973]])
    rgb = np.clip(p @ coef.T, 0.0, 1.0)
    return np.round(rgb * 255.0).astype(np.uint8)


TURBO = _turbo_table()      # (256, 3) uint8 RGB


def colorize(values: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """(H, W) floats -> (H, W, 3) uint8 through TURBO over [lo, hi]; NaN
    (no value) is white, as matplotlib leaves it on a white figure."""
    v = np.asarray(values, np.float64)
    ok = np.isfinite(v)
    t = (np.where(ok, v, lo) - lo) / max(hi - lo, 1e-12)
    idx = np.clip(np.floor(t * len(TURBO)), 0, len(TURBO) - 1).astype(int)
    out = TURBO[idx]
    out[~ok] = WHITE
    return out


def nice_ticks(lo: float, hi: float, most: int = 6) -> Tuple[np.ndarray,
                                                             float]:
    """Ticks inside [lo, hi] at a step of 1, 2, 2.5 or 5 times a power of
    ten, at most `most` + 1 of them; returns (ticks, step)."""
    raw = (hi - lo) / most
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw)
    first = math.ceil(lo / step - 1e-9)
    last = math.floor(hi / step + 1e-9)
    return np.arange(first, last + 1) * step, step


def tick_label(v: float, step: float) -> str:
    """`v` with as many decimals as `step` needs."""
    d = max(0, -math.floor(math.log10(step) + 1e-9))
    while d < 12 and abs(step * 10 ** d - round(step * 10 ** d)) > 1e-6:
        d += 1
    s = f"{v:.{d}f}"
    return "0" if float(s) == 0 else s


def limits(vals: np.ndarray) -> Tuple[float, float]:
    """The data's range widened by MARGIN a side (a point: +-0.5, or
    +-5% of its size)."""
    lo, hi = float(np.min(vals)), float(np.max(vals))
    if hi - lo <= 1e-12 * max(abs(lo), abs(hi), 1.0):
        half = 0.05 * abs(lo) if lo else 0.5
        return lo - half, hi + half
    span = hi - lo
    return lo - MARGIN * span, hi + MARGIN * span


def fill(img: np.ndarray, x0: int, y0: int, x1: int, y1: int,
         color) -> None:
    """Set the pixels of [x0, x1) x [y0, y1) (clipped to the image)."""
    h, w = img.shape[:2]
    img[max(y0, 0):min(y1, h), max(x0, 0):min(x1, w)] = color


def frame(img: np.ndarray, x0: int, y0: int, x1: int, y1: int) -> None:
    """A black one-pixel rectangle on the pixels x0..x1, y0..y1
    inclusive."""
    fill(img, x0, y0, x1 + 1, y0 + 1, BLACK)
    fill(img, x0, y1, x1 + 1, y1 + 1, BLACK)
    fill(img, x0, y0, x0 + 1, y1 + 1, BLACK)
    fill(img, x1, y0, x1 + 1, y1 + 1, BLACK)


def centred(img: np.ndarray, x: int, w: int, y: int, s: str) -> None:
    """`s` centred over the columns [x, x + w), its top at y."""
    tw, _ = font.text_size(s)
    font.draw_text(img, x + (w - tw) // 2, y, s, BLACK)


def polyline_core(img: np.ndarray, u: np.ndarray, v: np.ndarray,
                  color) -> None:
    """Set the pixels nearest the polyline through the integer points
    (u, v) to `color`, one a step along each segment's major axis: the
    exact colour down the middle of an anti-aliased stroke."""
    h, w = img.shape[:2]
    for k in range(len(u) - 1):
        n = int(max(abs(u[k + 1] - u[k]), abs(v[k + 1] - v[k]))) + 1
        t = np.linspace(0.0, 1.0, n)
        x = np.rint(u[k] + t * (u[k + 1] - u[k])).astype(np.int64)
        y = np.rint(v[k] + t * (v[k + 1] - v[k])).astype(np.int64)
        ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        img[y[ok], x[ok]] = color


class Plot:
    """Line series in the rectangle (x, y, w, h) of `img`; `draw` renders
    them and returns the plot area (x0, y0, x1, y1), the frame's pixels
    inclusive."""

    def __init__(self, img: np.ndarray, rect: Tuple[int, int, int, int],
                 title: str = "", xlabel: str = "", ylabel: str = "",
                 equal: bool = False):
        self.img, self.rect = img, rect
        self.title, self.xlabel, self.ylabel = title, xlabel, ylabel
        self.equal = equal
        self.series: List[tuple] = []

    def add(self, x: Sequence[float], y: Sequence[float], color,
            label: str = "", markers: bool = False,
            mark_x: Optional[Sequence[float]] = None) -> None:
        """A series; with `markers`, a filled marker on each point, or with
        `mark_x` (x increasing) on the polyline at those x."""
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        marks = (x, y) if markers else None
        if mark_x is not None:
            mark_x = np.asarray(mark_x, np.float64)
            marks = (mark_x, np.interp(mark_x, x, y))
        self.series.append((x, y, tuple(color), label, marks))

    def _legend_width(self) -> int:
        labels = [s[3] for s in self.series if s[3]]
        if not labels:
            return 0
        return 2 * PAD + 20 + max(font.text_size(t)[0] for t in labels)

    def _area(self, yticks, ystep) -> Tuple[int, int, int, int]:
        x, y, w, h = self.rect
        ylab = max(font.text_size(tick_label(v, ystep))[0] for v in yticks)
        left = x + PAD + (font.GLYPH_H + PAD if self.ylabel else 0) + ylab \
            + PAD + TICK
        top = y + PAD + (font.GLYPH_H + PAD if self.title else 0)
        bottom = y + h - 1 - PAD - (font.GLYPH_H + PAD if self.xlabel
                                    else 0) - font.GLYPH_H - PAD - TICK
        right = x + w - 1 - PAD - self._legend_width() - PAD
        return left, top, right, bottom

    def draw(self) -> Tuple[int, int, int, int]:
        img = self.img
        x, y, w, h = self.rect
        fill(img, x, y, x + w, y + h, WHITE)
        if self.series:
            xlo, xhi = limits(np.concatenate([s[0] for s in self.series]))
            ylo, yhi = limits(np.concatenate([s[1] for s in self.series]))
        else:
            xlo, xhi, ylo, yhi = 0.0, 1.0, 0.0, 1.0
        area = self._area(*nice_ticks(ylo, yhi))
        if self.equal:
            # one data unit the same number of pixels along both axes
            ax0, ay0, ax1, ay1 = area
            upp = max((xhi - xlo) / (ax1 - ax0), (yhi - ylo) / (ay1 - ay0))
            xc, yc = (xlo + xhi) / 2, (ylo + yhi) / 2
            xlo, xhi = xc - upp * (ax1 - ax0) / 2, xc + upp * (ax1 - ax0) / 2
            ylo, yhi = yc - upp * (ay1 - ay0) / 2, yc + upp * (ay1 - ay0) / 2
        yticks, ystep = nice_ticks(ylo, yhi)
        area = self._area(yticks, ystep)
        xticks, xstep = nice_ticks(xlo, xhi,
                                   most=max(2, (area[2] - area[0]) // 80))
        ax0, ay0, ax1, ay1 = area

        def px(v):
            return np.rint(ax0 + (v - xlo) / (xhi - xlo) * (ax1 - ax0)
                           ).astype(np.int64)

        def py(v):
            return np.rint(ay1 - (v - ylo) / (yhi - ylo) * (ay1 - ay0)
                           ).astype(np.int64)

        for t in px(xticks):
            fill(img, t, ay0, t + 1, ay1, GRID)
        for t in py(yticks):
            fill(img, ax0, t, ax1, t + 1, GRID)
        cv = Canvas(img)
        for sx, sy, color, _, _ in self.series:
            u, v = px(sx), py(sy)
            keep = np.r_[True, (u[1:] != u[:-1]) | (v[1:] != v[:-1])]
            u, v = u[keep].tolist(), v[keep].tolist()
            for k in range(len(u) - 1):
                cv.line((u[k], v[k]), (u[k + 1], v[k + 1]), color)
        cv.render()
        # markers over every line, so that curves that coincide each show
        # at their own (staggered) points
        cv = Canvas(img)
        for sx, sy, color, _, marks in self.series:
            polyline_core(img, px(sx), py(sy), color)
            if marks is not None:
                for p in zip(px(marks[0]).tolist(), py(marks[1]).tolist()):
                    cv.circle(p, 2, color, filled=True)
        cv.render()
        frame(img, ax0, ay0, ax1, ay1)
        for t, lab in zip(px(xticks), xticks):
            fill(img, t, ay1 + 1, t + 1, ay1 + 1 + TICK, BLACK)
            s = tick_label(lab, xstep)
            tw, _ = font.text_size(s)
            font.draw_text(img, t - tw // 2, ay1 + TICK + PAD, s, BLACK)
        for t, lab in zip(py(yticks), yticks):
            fill(img, ax0 - TICK, t, ax0, t + 1, BLACK)
            s = tick_label(lab, ystep)
            tw, th = font.text_size(s)
            font.draw_text(img, ax0 - TICK - PAD - tw, t - th // 2, s, BLACK)
        if self.xlabel:
            centred(img, ax0, ax1 - ax0, y + h - PAD - font.GLYPH_H,
                    self.xlabel)
        if self.ylabel:
            tw, _ = font.text_size(self.ylabel)
            font.draw_text(img, x + PAD, (ay0 + ay1 - tw) // 2, self.ylabel,
                           BLACK, vertical=True)
        if self.title:
            centred(img, ax0, ax1 - ax0, y + PAD, self.title)
        ly = ay0 + PAD
        for _, _, color, label, _ in self.series:
            if not label:
                continue
            lx = ax1 + 2 * PAD
            fill(img, lx, ly + 2, lx + 16, ly + 5, color)
            font.draw_text(img, lx + 20, ly, label, BLACK)
            ly += font.GLYPH_H + PAD
        return area


def image_pane(img: np.ndarray, x: int, y: int, pane: np.ndarray,
               name: str) -> None:
    """Place the (h, w, 3) uint8 `pane` with its top left pixel at (x, y)
    and its title `name` above it."""
    centred(img, x, pane.shape[1], y - TITLE_H, name)
    ph, pw = pane.shape[:2]
    img[y:y + ph, x:x + pw] = pane


def colorbar(img: np.ndarray, x: int, y: int, h: int, lo: float,
             hi: float) -> None:
    """A vertical bar of TURBO, BAR_W wide, from lo (bottom) to hi (top),
    its ticks labelled on its right."""
    rows = np.linspace(1.0, 0.0, h)
    img[y:y + h, x:x + BAR_W] = TURBO[np.clip(
        np.floor(rows * len(TURBO)), 0, len(TURBO) - 1).astype(int)][:, None]
    frame(img, x, y, x + BAR_W - 1, y + h - 1)
    if hi <= lo:
        return
    ticks, step = nice_ticks(lo, hi, most=4)
    for t in ticks:
        r = int(round(y + (h - 1) * (hi - t) / (hi - lo)))
        fill(img, x + BAR_W, r, x + BAR_W + TICK, r + 1, BLACK)
        font.draw_text(img, x + BAR_W + TICK + 2, r - font.GLYPH_H // 2,
                       tick_label(t, step), BLACK)


def write_rgb(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as a PNG."""
    png.write_png(path, np.ascontiguousarray(img[..., ::-1]))


def read_rgb(path: str) -> np.ndarray:
    """A PNG as an (H, W, 3) uint8 RGB image."""
    return np.ascontiguousarray(png.read_png(path)[..., ::-1])


def text_block(img: np.ndarray, x: int, y: int, lines: Sequence[str]) -> None:
    """Lines of black text at twice the font's size, the first line's top
    left at (x, y)."""
    for k, s in enumerate(lines):
        font.draw_text(img, x, y + k * 2 * (font.GLYPH_H + PAD), s, BLACK,
                       scale=2)
