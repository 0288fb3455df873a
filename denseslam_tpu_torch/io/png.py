"""PNG codec and the dataset reader's image operations, on numpy and the
standard library's zlib: the port's stand-in for what cv2 does for the JAX
package (denseslam_tpu/io/datasets.py, DenseSLAM.save_raycast_*).

  read_png        what cv2.imread(path, cv2.IMREAD_UNCHANGED) returns
                  (`decode_png` of a file's bytes):
                  (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA, uint8 or
                  uint16 (PNG's big-endian samples in host order); 8- and
                  16-bit, every row filter (None, Sub, Up, Average, Paeth);
                  no palette, no gray + alpha, no interlace.
  write_png       the same arrays (colour in BGR order, as cv2.imwrite
                  takes it), every row with filter 0; `encode_png` gives
                  the file's bytes (cv2.imencode(".png", ...)).
  bgr_to_gray     cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) bit for bit on
                  uint8 and uint16: the fixed-point weights 9798, 19235,
                  3735 (R, G, B) over 2^15, rounded.
  resize_area     cv2.resize(..., interpolation=cv2.INTER_AREA), shrinking
                  only: at whole-number factors the box mean, summed in
                  cv2's order (bit for bit); else cv2's table of partial-
                  pixel weights, summed in its order in float32; uint8
                  images as cv2 rounds them.
  resize_nearest  cv2.resize(..., interpolation=cv2.INTER_NEAREST).
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # PNG colour type -> channels


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of (H, 1 + stride) scanlines."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ft = int(rows[y, 0])
        line = rows[y, 1:]
        if ft == 0:
            cur = line.copy()
        elif ft == 1:       # Sub: a running sum per byte of the pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ft == 2:       # Up
            cur = line + prior
        elif ft in (3, 4):  # Average, Paeth: each byte needs its left one
            src, up = line.tolist(), prior.tolist()
            cur_l = [0] * stride
            for i in range(stride):
                a = cur_l[i - bpp] if i >= bpp else 0
                b = up[i]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                cur_l[i] = (src[i] + pred) & 0xFF
            cur = np.asarray(cur_l, np.uint8)
        else:
            raise ValueError(f"bad PNG row filter {ft}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG as cv2.imread(path, cv2.IMREAD_UNCHANGED) does."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """Decode a PNG file's bytes as cv2.imdecode(data,
    cv2.IMREAD_UNCHANGED) does."""
    if data[:8] != _SIGNATURE:
        raise IOError(f"not a PNG file: {path!r}")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if hdr is None:
        raise IOError(f"PNG without IHDR: {path!r}")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise IOError(f"unsupported PNG {path!r}: colour type {ctype}, "
                      f"{depth} bits, interlace {interlace}")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw.reshape(h, 1 + w * bpp), bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    img = px.reshape(h, w, ch)
    if ch == 1:
        return np.ascontiguousarray(img[..., 0])
    order = [2, 1, 0] if ch == 3 else [2, 1, 0, 3]    # RGB(A) -> BGR(A)
    return np.ascontiguousarray(img[..., order])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """The PNG file of (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA uint8
    or uint16 as bytes, as cv2.imencode(".png", img) gives its pixels (the
    rows filtered by filter 0)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        depth = 8
    elif img.dtype == np.uint16:
        depth = 16
    else:
        raise ValueError(f"a PNG takes uint8 or uint16, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        ctype = 0
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        ctype = 2 if img.shape[2] == 3 else 6
        img = img[..., [2, 1, 0] if ctype == 2 else [2, 1, 0, 3]]
    else:
        raise ValueError(f"bad PNG image shape {img.shape}")
    h, w = img.shape[:2]
    px = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = px.view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 3))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Encode (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA uint8 or uint16
    as cv2.imwrite does (its pixels; the rows filtered by filter 0)."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) of a uint8 or uint16 (H, W, 3)
    or (H, W, 4) image."""
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"bgr_to_gray: unsupported dtype {img.dtype}")
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15).astype(
        img.dtype)


def _inv_scales(src_hw, size) -> Tuple[float, float]:
    """cv2.resize's source pixels per destination pixel, x and y: the
    reciprocal of dsize / ssize, in double, as it computes them."""
    (sh, sw), (dw, dh) = src_hw, size
    return 1.0 / (dw / sw), 1.0 / (dh / sh)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size, interpolation=cv2.INTER_NEAREST); `size` is
    (width, height)."""
    sh, sw = img.shape[:2]
    fx, fy = _inv_scales((sh, sw), size)
    xs = np.minimum(np.floor(np.arange(size[0]) * fx).astype(np.int64),
                    sw - 1)
    ys = np.minimum(np.floor(np.arange(size[1]) * fy).astype(np.int64),
                    sh - 1)
    return np.ascontiguousarray(img[ys][:, xs])


def _area_tab(ssize: int, dsize: int, scale: float):
    """cv2's computeResizeAreaTab: (destination index, source index,
    weight) triples, the weights float32, in cv2's order."""
    tab = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            tab.append((dx, sx1 - 1, (sx1 - fsx1) / cell))
        for sx in range(sx1, sx2):
            tab.append((dx, sx, 1.0 / cell))
        if fsx2 - sx2 > 1e-3:
            tab.append((dx, sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
    return tab


def _weighted_passes(tab):
    """Group a weight table into passes: pass p holds the p-th entry of
    every destination index, so that summing pass after pass adds each
    destination's entries in the table's order."""
    passes, seen = [], {}
    for d, s, a in tab:
        p = seen.get(d, 0)
        seen[d] = p + 1
        if p == len(passes):
            passes.append(([], [], []))
        passes[p][0].append(d)
        passes[p][1].append(s)
        passes[p][2].append(a)
    return [(np.asarray(d), np.asarray(s), np.asarray(a, np.float32))
            for d, s, a in passes]


def _resize_area_fast(img: np.ndarray, ix: int, iy: int, dw: int,
                      dh: int) -> np.ndarray:
    """cv2's resizeAreaFast: the mean of each iy x ix box. Its scalar loop
    adds the box's pixels (row-major) four at a time, each four as
    ((a + b) + c) + d, onto the running sum; at 2 x 2 its vector path
    adds (a + b) + (c + d) instead, for every pixel of four channels and
    for the first multiple of 4 destination columns of one channel."""
    box = img[:dh * iy, :dw * ix].reshape((dh, iy, dw, ix) + img.shape[2:])
    vals = [box[:, sy, :, sx] for sy in range(iy) for sx in range(ix)]
    acc = np.zeros_like(vals[0])
    k = 0
    while k + 4 <= len(vals):
        acc = acc + (((vals[k] + vals[k + 1]) + vals[k + 2]) + vals[k + 3])
        k += 4
    for v in vals[k:]:
        acc = acc + v
    out = acc * np.float32(1.0 / (ix * iy))
    cn = 1 if img.ndim == 2 else img.shape[2]
    if (ix, iy) == (2, 2) and cn in (1, 4):
        vec = dw if cn == 4 else dw // 4 * 4
        pairs = ((vals[0] + vals[1]) + (vals[2] + vals[3])) * np.float32(0.25)
        out[:, :vec] = pairs[:, :vec]
    return out


def _resize_area_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2's INTER_AREA of a uint8 image: at whole-number factors the box
    sum in integers, (s + 2) >> 2 at 2 x 2 (its vector path) and else
    rounded from s * float32(1 / area) half to even; at other factors the
    float32 weights of resize_area, rounded half to even."""
    sh, sw = img.shape[:2]
    dw, dh = size
    fx, fy = _inv_scales((sh, sw), size)
    ix, iy = int(round(fx)), int(round(fy))
    eps = np.finfo(np.float64).eps
    if abs(fx - ix) < eps and abs(fy - iy) < eps and (dw, dh) != (sw, sh):
        box = img[:dh * iy, :dw * ix].astype(np.int64).reshape(
            (dh, iy, dw, ix) + img.shape[2:])
        total = box.sum(axis=(1, 3))
        if (ix, iy) == (2, 2):
            return ((total + 2) >> 2).astype(np.uint8)
        out = total.astype(np.float32) * np.float32(1.0 / (ix * iy))
    else:
        out = resize_area(img.astype(np.float32), size)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_area(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size, interpolation=cv2.INTER_AREA) of a float32 or
    uint8 (H, W) or (H, W, C) image to `size` = (width, height) no
    larger."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return _resize_area_u8(img, size)
    if img.dtype != np.float32:
        raise ValueError("resize_area takes float32 or uint8 images")
    sh, sw = img.shape[:2]
    dw, dh = size
    if (dw, dh) == (sw, sh):
        return img.copy()
    if dw > sw or dh > sh:
        raise NotImplementedError("resize_area only shrinks")
    fx, fy = _inv_scales((sh, sw), size)
    ix, iy = int(round(fx)), int(round(fy))
    eps = np.finfo(np.float64).eps
    if abs(fx - ix) < eps and abs(fy - iy) < eps:
        return _resize_area_fast(img, ix, iy, dw, dh)
    # cv2's resizeArea: each source row's horizontal sums (buf), then the
    # destination rows' weighted sums of them (sum), both in float32
    buf = np.zeros((sh, dw) + img.shape[2:], np.float32)
    for d, s, a in _weighted_passes(_area_tab(sw, dw, fx)):
        wa = a.reshape((1, -1) + (1,) * (img.ndim - 2))
        buf[:, d] = buf[:, d] + img[:, s] * wa
    out = np.zeros((dh, dw) + img.shape[2:], np.float32)
    for d, s, a in _weighted_passes(_area_tab(sh, dh, fy)):
        wa = a.reshape((-1, 1) + (1,) * (img.ndim - 2))
        out[d] = out[d] + buf[s] * wa
    return out
