"""Anti-aliased drawing on numpy: the port's stand-in for cv2.line and
cv2.circle with lineType=cv2.LINE_AA on (H, W, 3) uint8 images, as the JAX
package's viewer (denseslam_tpu/io/viewer.py) draws its feature and
scene-flow overlays.

It follows cv2's fixed-point rules (imgproc/drawing.cpp): coordinates in
16.16 fixed point; a line is clipped to the image (clipLine), then walked
one pixel a step along its major axis, three pixels across it weighted by
cv2's 64-entry filter table, scaled by its slope correction and its
end-point table (LineAA), and each written pixel blended twice toward the
colour, ((c - v) * a + 127) >> 8 each time; a circle of radius r < 3 is
the 4-vertex polygon cv2 makes of it at a 90-degree step (ellipse2Poly),
its outline four such lines, and a filled one those four edges plus the
polygon's interior spans set to the colour (FillConvexPoly). Draws land in
call order: a pixel that two strokes touch is blended by the first, then
by the second.

The strokes are rasterised together: every stroke's pixels are computed at
once, then applied in rounds, round k blending each pixel's k-th write, so
that the order per pixel is the calls' order.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

# cv2's LineAA tables (imgproc/drawing.cpp FilterTable, SlopeCorrTable)
_FILTER = np.array([
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252,
    254, 254, 254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202,
    194, 185, 177, 168, 158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75,
    68, 62, 56, 50, 45, 40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8,
    7, 5, 5], np.int64)
_SLOPE_CORR = np.array([
    181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196,
    198, 201, 203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238,
    242, 246, 250, 254], np.int64)

def _tdiv(a, b):
    """C integer division (toward zero) of int64 arrays."""
    q = np.abs(a) // np.abs(b)
    return np.where((a < 0) != (b < 0), -q, q)


def _ftrunc(num, den):
    """(int64)((double)num / den) with num already a double product."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.trunc(num / np.where(den == 0, 1, den)).astype(np.int64)


def _clip(w: int, h: int, x1, y1, x2, y2):
    """cv2's clipLine on 16.16 segments against an image of w x h pixels:
    the clipped ends and whether any part is left."""
    right, bottom = (w << XY_SHIFT) - 1, (h << XY_SHIFT) - 1

    def code(x, y, full=True):
        c = (x < 0) * 1 + (x > right) * 2
        if full:
            c = c + (y < 0) * 4 + (y > bottom) * 8
        return c.astype(np.int64)

    c1, c2 = code(x1, y1), code(x2, y2)
    need = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = need & ((c1 & 12) != 0)
    a = np.where(c1 < 8, 0, bottom)
    x1 = np.where(m, x1 + _ftrunc((a - y1).astype(np.float64)
                                  * (x2 - x1).astype(np.float64),
                                  (y2 - y1).astype(np.float64)), x1)
    y1 = np.where(m, a, y1)
    c1 = np.where(m, code(x1, y1, False), c1)
    m = need & ((c2 & 12) != 0)
    a = np.where(c2 < 8, 0, bottom)
    x2 = np.where(m, x2 + _ftrunc((a - y2).astype(np.float64)
                                  * (x2 - x1).astype(np.float64),
                                  (y2 - y1).astype(np.float64)), x2)
    y2 = np.where(m, a, y2)
    c2 = np.where(m, code(x2, y2, False), c2)
    need = need & ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = need & (c1 != 0)
    a = np.where(c1 == 1, 0, right)
    y1 = np.where(m, y1 + _ftrunc((a - x1).astype(np.float64)
                                  * (y2 - y1).astype(np.float64),
                                  (x2 - x1).astype(np.float64)), y1)
    x1 = np.where(m, a, x1)
    c1 = np.where(m, 0, c1)
    m = need & (c2 != 0)
    a = np.where(c2 == 1, 0, right)
    y2 = np.where(m, y2 + _ftrunc((a - x2).astype(np.float64)
                                  * (y2 - y1).astype(np.float64),
                                  (x2 - x1).astype(np.float64)), y2)
    x2 = np.where(m, a, x2)
    c2 = np.where(m, 0, c2)
    return x1, y1, x2, y2, (c1 | c2) == 0


def _line_aa(w: int, h: int, p1, p2):
    """cv2's LineAA on N segments of 16.16 end points (int64 (N, 2)
    arrays). Returns the writes (segment, x, y, alpha) in cv2's order
    within each segment."""
    x1, y1, x2, y2, keep = _clip(w, h, p1[:, 0], p1[:, 1], p2[:, 0],
                                 p2[:, 1])
    seg = np.flatnonzero(keep)
    x1, y1, x2, y2 = x1[seg], y1[seg], x2[seg], y2[seg]
    dx, dy = x2 - x1, y2 - y1
    ax, ay = np.abs(dx), np.abs(dy)
    horiz = ax > ay
    # walk along the major axis from its smaller end
    swap = np.where(horiz, dx < 0, dy < 0)
    x1, x2 = np.where(swap, x2, x1), np.where(swap, x1, x2)
    y1, y2 = np.where(swap, y2, y1), np.where(swap, y1, y2)
    dy, dx = np.where(horiz & swap, -dy, dy), np.where(~horiz & swap, -dx, dx)
    major1 = np.where(horiz, x1, y1)          # along the walk
    minor1 = np.where(horiz, y1, x1)
    major2 = np.where(horiz, x2, y2) + XY_ONE
    step = _tdiv(np.where(horiz, dy, dx) << XY_SHIFT,
                 np.where(horiz, ax, ay) | 1)
    ecount = (major2 >> XY_SHIFT) - (major1 >> XY_SHIFT)
    j = -(major1 & (XY_ONE - 1))
    minor1 = minor1 + ((step * j) >> XY_SHIFT) + (XY_ONE >> 1)
    slope = (step >> (XY_SHIFT - 5)) & 0x3F
    slope = np.where(step < 0, slope ^ 0x3F, slope)
    i = (major1 >> (XY_SHIFT - 7)) & 0x78
    j = (major2 >> (XY_SHIFT - 7)) & 0x78
    slope = np.where(slope & 0x20, 0x100, _SLOPE_CORR[slope & 0x1F])
    t0 = slope << 7
    t1 = ((0x78 - i) | 4) * slope
    t2 = (j | 4) * slope
    ep = np.stack([
        np.zeros_like(slope),
        ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF,
        (t1 >> 8) & 0x1FF,
        ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF,
        ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1FF,
        ((t1 + t0) >> 8) & 0x1FF,
        (t2 >> 8) & 0x1FF,
        ((t2 + t0) >> 8) & 0x1FF,
        slope], axis=1)
    n = np.maximum(ecount + 1, 0)
    sid = np.repeat(np.arange(seg.size), n)
    s = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    e = ecount[sid] - s
    hz = horiz[sid]
    major = (major1[sid] >> XY_SHIFT) + s
    pos = minor1[sid] + s * step[sid]
    lim_major = np.where(hz, w, h)
    ok = (major >= 0) & (major < lim_major)
    sid, s, e, hz, major, pos = (a[ok] for a in (sid, s, e, hz, major, pos))
    cs = (((s >= 2) + 1) & (s | 2)) * 3 + (((e >= 2) + 1) & (e | 2))
    corr = ep[sid, cs]
    dist = (pos >> (XY_SHIFT - 5)) & 31
    base = (pos >> XY_SHIFT) - 1
    alphas = np.stack([(corr * _FILTER[dist + 32] >> 8) & 0xFF,
                       (corr * _FILTER[dist] >> 8) & 0xFF,
                       (corr * _FILTER[63 - dist] >> 8) & 0xFF], axis=1)
    across = base[:, None] + np.arange(3)[None, :]
    maj = np.repeat(major[:, None], 3, axis=1)
    hz3 = np.repeat(hz[:, None], 3, axis=1)
    xs = np.where(hz3, maj, across)
    ys = np.where(hz3, across, maj)
    inb = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    segs = np.repeat(seg[sid][:, None], 3, axis=1)
    return segs[inb], xs[inb], ys[inb], alphas[inb]


def _diamond(cx: int, cy: int, r: int) -> np.ndarray:
    """cv2's polygon of a circle of radius r < 3 (ellipse2Poly at a
    90-degree step): 5 vertices in 16.16, the last repeating the first."""
    pts = [(cx + r, cy), (cx, cy + r), (cx - r, cy), (cx, cy - r),
           (cx + r, cy)]
    return np.array(pts, np.int64) << XY_SHIFT


def _fill_spans(v: np.ndarray, w: int, h: int) -> List[Tuple[int, int, int]]:
    """cv2's FillConvexPoly interior for LINE_AA on 16.16 vertices v: the
    spans (y, x_first, x_last) it sets to the colour."""
    shift, delta = XY_SHIFT, 1 << XY_SHIFT >> 1
    delta1, delta2 = XY_ONE - 1, 0
    npts = len(v)
    vx, vy = [int(a) for a in v[:, 0]], [int(a) for a in v[:, 1]]
    imin = int(np.argmin(vy))
    xmin, xmax = (min(vx) + delta) >> shift, (max(vx) + delta) >> shift
    ymin, ymax = (min(vy) + delta) >> shift, (max(vy) + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return []
    ymax = min(ymax, h - 1)
    idx, di = [imin, imin], [1, npts - 1]
    ye, ex, edx = [ymin, ymin], [-XY_ONE, -XY_ONE], [0, 0]
    edges, y, spans = npts, ymin, []
    while True:
        if y < ymax or y == ymin:
            for k in range(2):
                if y < ye[k]:
                    continue
                idx0 = idx[k]
                nxt = idx0 + di[k]
                if nxt >= npts:
                    nxt -= npts
                while True:
                    go = edges > 0
                    edges -= 1
                    if not go:
                        break
                    ty = (vy[nxt] + delta) >> shift
                    if ty > y:
                        xs, xe = vx[idx0], vx[nxt]
                        ye[k] = ty
                        num, den = (xe - xs) * 2 + (ty - y), 2 * (ty - y)
                        q = abs(num) // den
                        edx[k] = -q if num < 0 else q
                        ex[k], idx[k] = xs, nxt
                        break
                    idx0 = nxt
                    nxt += di[k]
                    if nxt >= npts:
                        nxt -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if ex[0] > ex[1] else (0, 1)
            xx1 = (ex[left] + delta1) >> XY_SHIFT
            xx2 = (ex[right] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                spans.append((y, max(xx1, 0), min(xx2, w - 1)))
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        if y > ymax:
            break
    return spans


class Canvas:
    """Collects strokes on an (H, W, 3) uint8 image in call order, then
    rasterises them all at once (`render`)."""

    def __init__(self, img: np.ndarray):
        self.img = img
        self.h, self.w = img.shape[:2]
        self._segs: List[Tuple[int, ...]] = []    # x1, y1, x2, y2, order, bgr
        self._dots: List[Tuple[int, ...]] = []    # cx, cy, r, order, bgr
        self._order = 0

    def _segment(self, p1, p2, color) -> None:
        self._segs.append((*p1, *p2, self._order, *color))
        self._order += 1

    def line(self, p1, p2, color) -> None:
        """cv2.line(img, p1, p2, color, 1, cv2.LINE_AA), integer points."""
        self._segment((p1[0] << XY_SHIFT, p1[1] << XY_SHIFT),
                      (p2[0] << XY_SHIFT, p2[1] << XY_SHIFT), color)

    def circle(self, center, radius: int, color, filled: bool) -> None:
        """cv2.circle(img, center, radius, color, -1 if filled else 1,
        cv2.LINE_AA) for an integer center and radius 1 or 2."""
        if not 0 < radius < 3:
            raise ValueError("only radii 1 and 2 are rasterised")
        v = _diamond(int(center[0]), int(center[1]), radius).tolist()
        if filled:
            # FillConvexPoly: its edges from the last vertex round, then
            # the interior spans
            for a, b in zip([v[-1]] + v[:-1], v):
                self._segment(a, b, color)
            self._dots.append((int(center[0]), int(center[1]), radius,
                               self._order, *color))
            self._order += 1
        else:
            for a, b in zip(v[:-1], v[1:]):
                self._segment(a, b, color)

    def _span_writes(self):
        """The filled circles' interior pixels: (order, x, y, colour)."""
        d = np.array(self._dots, np.int64).reshape(-1, 7)
        out = []
        for r in np.unique(d[:, 2]):
            dr = d[d[:, 2] == r]
            inner = ((dr[:, 0] >= r + 1) & (dr[:, 0] < self.w - r - 1)
                     & (dr[:, 1] >= r + 1) & (dr[:, 1] < self.h - r - 1))
            # away from the border every centre has the same spans
            c0 = 2 * r + 2
            pat = np.array([(y - c0, x - c0)
                            for y, xa, xb in _fill_spans(
                                _diamond(c0, c0, int(r)), 4 * r + 5,
                                4 * r + 5)
                            for x in range(xa, xb + 1)], np.int64)
            di = dr[inner]
            k = pat.shape[0]
            out.append((np.repeat(di[:, 3], k),
                        (di[:, 0, None] + pat[None, :, 1]).reshape(-1),
                        (di[:, 1, None] + pat[None, :, 0]).reshape(-1),
                        np.repeat(di[:, 4:], k, axis=0)))
            for cx, cy, _, o, *c in dr[~inner].tolist():
                spans = _fill_spans(_diamond(cx, cy, int(r)), self.w, self.h)
                xs = [x for _, xa, xb in spans for x in range(xa, xb + 1)]
                ys = [y for y, xa, xb in spans for _ in range(xa, xb + 1)]
                out.append((np.full(len(xs), o, np.int64),
                            np.array(xs, np.int64), np.array(ys, np.int64),
                            np.tile(np.array(c, np.int64), (len(xs), 1))))
        return out

    def render(self) -> np.ndarray:
        """Apply every stroke in call order; returns the image."""
        img = self.img
        writes = []                   # (order, x, y, alpha or -1, colour)
        if self._segs:
            sg = np.array(self._segs, np.int64)
            seg, xs, ys, al = _line_aa(self.w, self.h, sg[:, 0:2],
                                       sg[:, 2:4])
            writes.append((sg[seg, 4], xs, ys, al, sg[seg, 5:8]))
        if self._dots:
            for o, xs, ys, c in self._span_writes():
                writes.append((o, xs, ys, np.full(xs.size, -1, np.int64), c))
        if not writes:
            return img
        order, xs, ys, al, col = (np.concatenate([wr[k] for wr in writes])
                                  for k in range(5))
        if xs.size == 0:
            return img
        pix = ys * self.w + xs
        # stable: a segment's own writes keep their order
        srt = np.lexsort((np.arange(order.size), order, pix))
        pix, al, col = pix[srt], al[srt], col[srt]
        first = np.r_[True, pix[1:] != pix[:-1]]
        start = np.maximum.accumulate(np.where(first, np.arange(pix.size), 0))
        rank = np.arange(pix.size) - start
        flat = img.reshape(-1, 3)
        for r in range(int(rank.max()) + 1):
            sel = rank == r
            p, a, c = pix[sel], al[sel, None], col[sel]
            v = flat[p].astype(np.int64)
            for _ in range(2):
                v = v + (((c - v) * a + 127) >> 8)
            flat[p] = np.where(a < 0, c, v).astype(np.uint8)
        return img
