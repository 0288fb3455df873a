"""Motion-JPEG video on numpy: the port's stand-in for
cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h)), which
the JAX package's viewer records its panes with.

  encode_jpeg   a baseline JFIF image of an (H, W, 3) BGR uint8 array:
                YCbCr with 4:2:0 chroma (2x2 means), the orthonormal 8x8
                DCT in float64, the quantisation tables of the JPEG
                standard's Annex K scaled to a quality as libjpeg scales
                them (95 by default, cv2's MJPG quality), and Annex K's
                Huffman tables.
  AviWriter     a RIFF AVI file of one MJPG video stream (`hdrl` with
                `avih`, `strl` with `strh` / `strf`; `movi` with one
                `00dc` chunk a frame; `idx1`), written frame by frame and
                completed by `release()`, as cv2.VideoWriter's methods
                are named.

The entropy coder is vectorised: the symbols of every block are laid out
by sort keys, their code words concatenated into one bit array and packed.
"""

from __future__ import annotations

import struct

import numpy as np

# Annex K quantisation tables, natural (row-major) order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64).reshape(8, 8)
_Q_CHROMA = np.full((8, 8), 99, np.int64)
_Q_CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                     [47, 66, 99, 99]]

# zigzag scan: position k of the scan -> index into the row-major block
_ZIGZAG = np.array(sorted(
    range(64), key=lambda i: (i // 8 + i % 8,
                              (i % 8) if (i // 8 + i % 8) % 2 == 0
                              else (i // 8))), np.int64)

# Annex K Huffman tables: code counts by length 1..16, then the symbols
_DC_BITS = {0: [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
            1: [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]}
_DC_VALS = {0: bytes(range(12)), 1: bytes(range(12))}
_AC_BITS = {0: [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125],
            1: [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119]}
_AC_VALS = {0: bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"),
            1: bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")}


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    c[0] /= np.sqrt(2.0)
    return c


_DCT = _dct_matrix()


def _codes(bits, vals):
    """Canonical Huffman codes: (code, length) of each symbol 0..255."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for n_len, count in enumerate(bits, start=1):
        for _ in range(count):
            code[vals[k]], length[vals[k]] = c, n_len
            c += 1
            k += 1
        c <<= 1
    return code, length


_HUFF = {(kind, t): _codes(bits[t], vals[t])
         for kind, bits, vals in (("dc", _DC_BITS, _DC_VALS),
                                  ("ac", _AC_BITS, _AC_VALS))
         for t in (0, 1)}


def quant_tables(quality: int):
    """libjpeg's jpeg_quality_scaling of the Annex K tables (baseline:
    clamped to 1..255)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (_Q_LUMA, _Q_CHROMA))


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) -> (H/8, W/8, 8, 8) blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _size(v: np.ndarray) -> np.ndarray:
    """The JPEG magnitude category (bit count) of each integer."""
    return np.where(v == 0, 0, np.frexp(np.abs(v).astype(np.float64))[1])


def _extra(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The appended bits of a value of category s."""
    return np.where(v >= 0, v, v + (1 << s) - 1)


def _scan(coefs: np.ndarray, comp: np.ndarray) -> bytes:
    """Entropy-code quantised blocks (N, 64) in zigzag order, blocks in
    scan order, `comp` (N,) the table set of each (0 luma, 1 chroma; the
    DC predictor runs per component id in comp)."""
    n = coefs.shape[0]
    # DC differences, predicted per component
    dc = coefs[:, 0]
    diff = np.empty(n, np.int64)
    for c in np.unique(comp):
        idx = np.flatnonzero(comp == c)
        diff[idx] = np.diff(dc[idx], prepend=0)
    tables = np.minimum(comp, 1)
    s_dc = _size(diff)
    keys_b, keys_z, keys_k = [np.arange(n)], [np.zeros(n, np.int64)], \
        [np.zeros(n, np.int64)]
    sym = [s_dc]
    val_bits, val_len = [_extra(diff, s_dc)], [s_dc]
    kind = [np.zeros(n, np.int64)]                  # 0 = DC, 1 = AC
    # AC: nonzero coefficients with their zero runs
    ac = coefs[:, 1:]
    b, z = np.nonzero(ac)
    z = z + 1
    v = ac[b, z - 1]
    first = np.r_[True, b[1:] != b[:-1]]
    prev = np.where(first, 0, np.r_[0, z[:-1]])
    run = z - prev - 1
    s = _size(v)
    nzrl = run // 16
    # ZRL symbols (0xF0) before a coefficient whose run exceeds 15
    zb = np.repeat(b, nzrl)
    zz = np.repeat(z, nzrl)
    zk = np.arange(nzrl.sum()) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
    keys_b += [zb, b]
    keys_z += [zz, z]
    keys_k += [zk, nzrl]
    sym += [np.full(zb.size, 0xF0, np.int64), ((run % 16) << 4) | s]
    val_bits += [np.zeros(zb.size, np.int64), _extra(v, s)]
    val_len += [np.zeros(zb.size, np.int64), s]
    kind += [np.ones(zb.size, np.int64), np.ones(b.size, np.int64)]
    # EOB where the block's last nonzero coefficient is not the 63rd
    last = np.zeros(n, np.int64)
    if b.size:
        last_b = np.r_[b[1:] != b[:-1], True]
        last[b[last_b]] = z[last_b]
    eb = np.flatnonzero(last < 63)
    keys_b.append(eb)
    keys_z.append(np.full(eb.size, 64, np.int64))
    keys_k.append(np.zeros(eb.size, np.int64))
    sym.append(np.zeros(eb.size, np.int64))
    val_bits.append(np.zeros(eb.size, np.int64))
    val_len.append(np.zeros(eb.size, np.int64))
    kind.append(np.ones(eb.size, np.int64))
    kb, kz, kk = (np.concatenate(a) for a in (keys_b, keys_z, keys_k))
    order = np.lexsort((kk, kz, kb))
    sym, vb, vl, knd = (np.concatenate(a)[order]
                        for a in (sym, val_bits, val_len, kind))
    tb = tables[kb[order]]
    code = np.empty(sym.size, np.int64)
    clen = np.empty(sym.size, np.int64)
    for k, name in ((0, "dc"), (1, "ac")):
        for t in (0, 1):
            m = (knd == k) & (tb == t)
            hc, hl = _HUFF[(name, t)]
            code[m], clen[m] = hc[sym[m]], hl[sym[m]]
    word = (code << vl) | vb
    wlen = clen + vl
    total = int(wlen.sum())
    pos = np.arange(total) - np.repeat(np.cumsum(wlen) - wlen, wlen)
    bits = (np.repeat(word, wlen) >> (np.repeat(wlen, wlen) - 1 - pos)) & 1
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """A baseline JFIF of an (H, W, 3) BGR (or (H, W) gray, stored as
    colour) uint8 image, 4:2:0."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    h, w = img.shape[:2]
    ph, pw = -h % 16, -w % 16
    px = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge").astype(
        np.float64)
    bl, gr, rd = px[..., 0], px[..., 1], px[..., 2]
    y = 0.299 * rd + 0.587 * gr + 0.114 * bl
    cb = -0.168736 * rd - 0.331264 * gr + 0.5 * bl + 128.0
    cr = 0.5 * rd - 0.418688 * gr - 0.081312 * bl + 128.0
    H, W = y.shape

    def sub(p):
        return p.reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3))

    qy, qc = quant_tables(quality)

    def coded(plane, q):
        b = _blocks(plane - 128.0)
        d = _DCT @ b @ _DCT.T
        return np.rint(d / q).astype(np.int64)

    cy = coded(y, qy)                               # (H/8, W/8, 8, 8)
    ccb, ccr = coded(sub(cb), qc), coded(sub(cr), qc)
    my, mx = H // 16, W // 16
    # MCU order: 4 luma blocks (2x2, row-major), then Cb, then Cr
    ly = cy.reshape(my, 2, mx, 2, 8, 8).transpose(0, 2, 1, 3, 4, 5)
    mcu = np.concatenate([ly.reshape(my, mx, 4, 64),
                          ccb.reshape(my, mx, 1, 64),
                          ccr.reshape(my, mx, 1, 64)], axis=2)
    blocks = mcu.reshape(-1, 64)[:, _ZIGZAG]
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
    scan = _scan(blocks, comp)
    dqt = b"".join(bytes([t]) + q.reshape(-1)[_ZIGZAG].astype(
        np.uint8).tobytes() for t, q in ((0, qy), (1, qc)))
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes(
        [1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = b"".join(
        bytes([cls << 4 | t]) + bytes(bits[t]) + vals[t]
        for t in (0, 1)
        for cls, bits, vals in ((0, _DC_BITS, _DC_VALS),
                                (1, _AC_BITS, _AC_VALS)))
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (b"\xff\xd8"
            + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
            + _segment(0xDB, dqt) + _segment(0xC0, sof)
            + _segment(0xC4, dht) + _segment(0xDA, sos) + scan
            + b"\xff\xd9")


class AviWriter:
    """An MJPG .avi written frame by frame: `write(img)` appends one
    (H, W, 3) BGR uint8 frame of the size given, `release()` writes the
    index and completes the headers."""

    def __init__(self, path: str, fps: float, size, quality: int = 95):
        self.path = path
        self.w, self.h = int(size[0]), int(size[1])
        self.fps = float(fps)
        self.quality = quality
        self._index = []                 # (offset from 'movi', length)
        self._max_chunk = 0
        self._f = open(path, "wb")
        self._f.write(self._headers())
        self._movi_at = self._f.tell() - 4          # the 'movi' fourcc

    def _headers(self, riff_size: int = 0) -> bytes:
        n = len(self._index)
        us = int(round(1e6 / self.fps))
        avih = struct.pack(
            "<IIIIIIIIII16x", us, self._max_chunk * int(round(self.fps)),
            0, 0x10, n, 0, 1, self._max_chunk, self.w, self.h)
        # the rate as dwRate / dwScale, in thousandths of a frame a second
        strh = (b"vidsMJPG" + struct.pack(
            "<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1000, int(round(self.fps * 1000)),
            0, n, self._max_chunk, 0xFFFFFFFF, 0, 0, 0, self.w, self.h))
        strf = struct.pack("<IiiHH4sIiiII", 40, self.w, self.h, 1, 24,
                           b"MJPG", self.w * self.h * 3, 0, 0, 0, 0)
        strl = (b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf))
        hdrl = (b"hdrl" + _chunk(b"avih", avih)
                + _chunk(b"LIST", strl))
        movi_size = 4 + sum(8 + ln + (ln & 1) for _, ln in self._index)
        return (b"RIFF" + struct.pack("<I", riff_size) + b"AVI "
                + _chunk(b"LIST", hdrl)
                + b"LIST" + struct.pack("<I", movi_size) + b"movi")

    def write(self, img: np.ndarray) -> None:
        img = np.asarray(img)
        if img.shape[:2] != (self.h, self.w):
            raise ValueError(f"frame {img.shape[:2]} is not "
                             f"{(self.h, self.w)}")
        data = encode_jpeg(img, self.quality)
        self._index.append((self._f.tell() - self._movi_at, len(data)))
        self._max_chunk = max(self._max_chunk, len(data))
        self._f.write(_chunk(b"00dc", data))

    def release(self) -> None:
        if self._f.closed:
            return
        idx = b"".join(b"00dc" + struct.pack("<III", 0x10, off, ln)
                       for off, ln in self._index)
        self._f.write(b"idx1" + struct.pack("<I", len(idx)) + idx)
        size = self._f.tell()
        self._f.seek(0)
        self._f.write(self._headers(size - 8))
        self._f.close()


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    """A RIFF chunk, padded to an even length."""
    return (fourcc + struct.pack("<I", len(body)) + body
            + (b"\x00" if len(body) & 1 else b""))
