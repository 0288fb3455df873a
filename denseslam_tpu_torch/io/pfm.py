"""Portable Float Map (PFM) read/write — pfmLib equivalent (a copy of
denseslam_tpu/io/pfm.py)
(reference: src/pfmLib/ImageIOpfm.{h,cpp}: ReadFilePFM/WriteFilePFM, used for
DispNet disparity maps).

Pure-python header parse + numpy payload; the byte-order and bottom-up row
order semantics follow the PFM spec exactly as the reference does.
"""

from __future__ import annotations

import numpy as np


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file -> float32 array (H, W) or (H, W, 3), top-down rows."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"not a PFM file: {path!r} (header {header!r})")
        # dims line (may contain comments per spec extensions)
        line = f.readline().strip()
        while line.startswith(b"#"):
            line = f.readline().strip()
        w, h = (int(x) for x in line.split())
        scale = float(f.readline().strip())
        little_endian = scale < 0
        data = np.frombuffer(
            f.read(w * h * channels * 4),
            dtype="<f4" if little_endian else ">f4",
        )
    img = data.reshape(h, w, channels) if channels == 3 else data.reshape(h, w)
    # PFM stores rows bottom-up
    img = np.flipud(img).astype(np.float32)
    if abs(scale) not in (0.0, 1.0):
        img = img * abs(scale)
    return np.ascontiguousarray(img)


def write_pfm(path: str, img: np.ndarray, scale: float = 1.0) -> None:
    """Write float32 array (H, W) or (H, W, 3) as little-endian PFM."""
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        header = b"Pf"
    elif img.ndim == 3 and img.shape[2] == 3:
        header = b"PF"
    else:
        raise ValueError(f"bad PFM shape {img.shape}")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{w} {h}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())   # negative = little-endian
        f.write(np.flipud(img).astype("<f4").tobytes())
