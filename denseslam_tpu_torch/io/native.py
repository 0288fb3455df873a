"""ctypes bindings for the native IO runtime (a copy of
denseslam_tpu/io/native.py over the same source, native/dsio.cpp).

PFM / PNG codecs and a multithreaded prefetching frame loader. The port
builds its own copy of the library, at first use, with
`g++ -O3 -std=c++17 -fPIC -shared -lz -lpthread` into `build/native/` at
the repo root (named by a digest of the source and the flags, as
kernels.py names its libraries); it never writes into `native/`. Without
`g++` or zlib's header the build raises, with the compiler's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "dsio.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
LD_FLAGS = ["-lz", "-lpthread"]

_lib: Optional[ctypes.CDLL] = None


def _lib_path() -> Path:
    text = SOURCE.read_bytes() + " ".join(CXX_FLAGS + LD_FLAGS).encode()
    return BUILD_DIR / f"libdsio_{hashlib.sha256(text).hexdigest()[:16]}.so"


def ensure_built(force: bool = False) -> str:
    """Build the library if it is missing; returns its path."""
    out = _lib_path()
    if force or not out.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("the native IO backend needs g++ to build "
                               f"{SOURCE}, and none was found")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp),
                               *LD_FLAGS], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed (rc "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return str(out)


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(ensure_built())
    lib.dsio_read_pfm.restype = ctypes.c_int
    lib.dsio_read_pfm.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.dsio_write_pfm.restype = ctypes.c_int
    lib.dsio_write_pfm.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.dsio_read_png.restype = ctypes.c_int
    lib.dsio_read_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.dsio_write_png.restype = ctypes.c_int
    lib.dsio_write_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.dsio_free.argtypes = [ctypes.c_void_p]
    lib.dsio_loader_create.restype = ctypes.c_void_p
    lib.dsio_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.dsio_loader_next.restype = ctypes.c_int
    lib.dsio_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.dsio_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def read_pfm(path: str) -> np.ndarray:
    lib = load_library()
    data = ctypes.POINTER(ctypes.c_float)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    ch = ctypes.c_int()
    rc = lib.dsio_read_pfm(path.encode(), ctypes.byref(data),
                           ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch))
    if rc != 0:
        raise IOError(f"dsio_read_pfm({path}) failed: {rc}")
    n = w.value * h.value * ch.value
    arr = np.ctypeslib.as_array(data, shape=(n,)).copy()
    lib.dsio_free(data)
    shape = (h.value, w.value) if ch.value == 1 else (h.value, w.value, ch.value)
    return arr.reshape(shape)


def write_pfm(path: str, img: np.ndarray) -> None:
    lib = load_library()
    img = np.ascontiguousarray(img, dtype=np.float32)
    ch = 1 if img.ndim == 2 else img.shape[2]
    rc = lib.dsio_write_pfm(
        path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        img.shape[1], img.shape[0], ch,
    )
    if rc != 0:
        raise IOError(f"dsio_write_pfm({path}) failed: {rc}")


def read_png(path: str) -> np.ndarray:
    """Returns uint16 array (H, W) or (H, W, C), channels in the file's
    RGB(A) order; 8-bit files widen to u16."""
    lib = load_library()
    data = ctypes.POINTER(ctypes.c_uint16)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    ch = ctypes.c_int()
    depth = ctypes.c_int()
    rc = lib.dsio_read_png(path.encode(), ctypes.byref(data), ctypes.byref(w),
                           ctypes.byref(h), ctypes.byref(ch), ctypes.byref(depth))
    if rc != 0:
        raise IOError(f"dsio_read_png({path}) failed: {rc}")
    n = w.value * h.value * ch.value
    arr = np.ctypeslib.as_array(data, shape=(n,)).copy()
    lib.dsio_free(data)
    shape = (h.value, w.value) if ch.value == 1 else (h.value, w.value, ch.value)
    return arr.reshape(shape)


def write_png(path: str, img: np.ndarray, bitdepth: Optional[int] = None) -> None:
    lib = load_library()
    if bitdepth is None:
        bitdepth = 16 if img.dtype == np.uint16 else 8
    img = np.ascontiguousarray(img, dtype=np.uint16)
    ch = 1 if img.ndim == 2 else img.shape[2]
    rc = lib.dsio_write_png(
        path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        img.shape[1], img.shape[0], ch, bitdepth,
    )
    if rc != 0:
        raise IOError(f"dsio_write_png({path}) failed: {rc}")


class PrefetchLoader:
    """Background-thread frame prefetcher over a list of image paths.

    Usage:
        with PrefetchLoader(paths, ahead=4) as ld:
            for frame in ld: ...   # frames are float32 np arrays
    """

    def __init__(self, paths: List[str], ahead: int = 4, threads: int = 2):
        self._lib = load_library()
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = self._lib.dsio_loader_create(arr, len(paths), ahead, threads)
        self._n = len(paths)

    def __iter__(self):
        while True:
            frame = self.next()
            if frame is None:
                return
            yield frame

    def next(self) -> Optional[np.ndarray]:
        data = ctypes.POINTER(ctypes.c_float)()
        w = ctypes.c_int()
        h = ctypes.c_int()
        ch = ctypes.c_int()
        rc = self._lib.dsio_loader_next(
            self._handle, ctypes.byref(data), ctypes.byref(w),
            ctypes.byref(h), ctypes.byref(ch),
        )
        if rc == 1:
            return None
        if rc != 0:
            raise IOError(f"prefetch decode failed: {rc}")
        n = w.value * h.value * ch.value
        arr = np.ctypeslib.as_array(data, shape=(n,)).copy()
        shape = (h.value, w.value) if ch.value == 1 else (h.value, w.value, ch.value)
        return arr.reshape(shape)

    def close(self) -> None:
        if self._handle:
            self._lib.dsio_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
