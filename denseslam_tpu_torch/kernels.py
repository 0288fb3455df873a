"""Build and bind the port's CUDA kernels (denseslam_tpu_torch/csrc/).

Each source is compiled by `nvcc` for sm_90a into its own shared library
with a plain C interface, at first use, into `build/kernels/` at the repo
root; all sources compile in parallel. The libraries are loaded with
ctypes: tensors pass as device pointers, the current CUDA stream as a
`c_void_p`, and every launch returns `cudaGetLastError()`, which raises
here when it is not 0.

`launch_counts` holds one plain integer per kernel, incremented where the
kernel is launched and nowhere else, so a run can show that its main path
went through the kernels.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

NVCC_FLAGS = [
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    # no FMA contraction: results are compared bit for bit with the
    # separate multiplies and adds of the reference
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# kernel name -> (source file, C entry point, argument codes). Codes:
# p = device pointer, i = int, f = float; the stream is appended.
KERNELS = {
    "tile_sample": ("tile_sample.cu", "tile_sample_launch", "piiiipppippp"),
    "tile_sample_rgb": ("tile_sample.cu", "tile_sample_rgb_launch",
                        "ppiiiipppipppp"),
    "sgm_path": ("sgm.cu", "sgm_path_launch", "ppppiiiiiiffi"),
    "sgm_final": ("sgm_final.cu", "sgm_final_launch", "ppppppppppiiiffi"),
    "cost_volume": ("cost_volume.cu", "cost_volume_launch",
                    "pppppppiiiifi"),
    "gn_normal": ("gn_normal.cu", "gn_normal_launch", "ppppiii"),
    "gn_update": ("gn_update.cu", "gn_update_launch", "pppii"),
    "fusion_geometry": ("fusion_geometry.cu", "fusion_geometry_launch",
                        "ppppppifffff"),
}

launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def reset_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _lib_path(src: str) -> Path:
    """The library of `src`, named by a digest of the source, the shared
    headers it may include and the flags."""
    text = b"".join(p.read_bytes() for p in
                    [CSRC / src, *sorted(CSRC.glob("*.cuh"))])
    text += " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(src).stem}_{digest}.so"


def build_all() -> Dict[str, float]:
    """Compile every kernel source that has no up-to-date library yet, all
    nvcc processes started together. Returns {source: seconds} for the
    ones built; the ptxas report of each lands beside it as `.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src in sorted({src for src, _, _ in KERNELS.values()}):
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       time.perf_counter(), tmp, out, log)
    built = {}
    for name, (proc, t0, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        built[name] = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(
                f"nvcc failed for {name} (rc {rc}):\n"
                + out.with_suffix(".log").read_text())
        os.replace(tmp, out)
    return built


def _entry(name: str):
    """The C entry point of kernel `name`, its library built and loaded at
    first use."""
    fn = _fns.get(name)
    if fn is not None:
        return fn
    src, fn_name, codes = KERNELS[name]
    path = _lib_path(src)
    if not path.exists():
        build_all()
    fn = getattr(ctypes.CDLL(str(path)), fn_name)
    types = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    fn.argtypes = [types[c] for c in codes] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _fns[name] = fn
    return fn


def check_tensor(t: torch.Tensor, name: str, dtype, shape,
                 device: Optional[torch.device] = None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of the given dtype and
    shape (and device, when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel `name` on the current stream of `device`; tensors pass
    as pointers (None as a null pointer). Raises on a launch error."""
    codes = KERNELS[name][2]
    fn = _entry(name)
    if len(args) != len(codes):
        raise TypeError(f"{name}: {len(args)} arguments, expected {len(codes)}")
    conv = []
    for code, a in zip(codes, args):
        if code == "p":
            conv.append(None if a is None else a.data_ptr())
        elif code == "i":
            conv.append(int(a))
        else:
            conv.append(float(a))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*conv, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    launch_counts[name] += 1
