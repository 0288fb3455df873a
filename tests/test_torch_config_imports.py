"""Port scaffolding, the import and device rules of denseslam_tpu_torch
(split from tests/test_torch_config.py): the package, the command line
and chip_smoke.py import no jax, no denseslam_tpu, no cv2 and no PIL;
a constructor without a device raises where there is no card; a kernel
wrapper given a tensor off the CPU launches or raises."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

from denseslam_tpu_torch import config as pcfg
from denseslam_tpu_torch import kernels
from denseslam_tpu_torch.models import dense_slam as pds
from denseslam_tpu_torch.ops import sampling as psm
from denseslam_tpu_torch.ops import sgm as psg
from denseslam_tpu_torch.ops import tsdf as pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import denseslam_tpu_torch\n"
        "import denseslam_tpu_torch.models.dense_slam, "
        "denseslam_tpu_torch.ops.stereo, denseslam_tpu_torch.io.convert, "
        "denseslam_tpu_torch.io.synthetic, "
        "denseslam_tpu_torch.eval.depth_metrics, "
        "denseslam_tpu_torch.ops.mono, denseslam_tpu_torch.ops.orb, "
        "denseslam_tpu_torch.ops.meshing, "
        "denseslam_tpu_torch.ops.reconstruction\n"
        "bad = [m for m in sys.modules if m in ('jax', 'denseslam_tpu') "
        "or m.startswith(('jax.', 'denseslam_tpu.'))]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr



def test_constructors_without_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pcfg.tiny_test_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.make_map(cfg.tsdf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pds.make_fusion_db(cfg)
    assert pt.make_map(cfg.tsdf, device="cpu").tsdf.device.type == "cpu"



def _imported_modules(path):
    names = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names



def test_port_sources_import_neither_jax_nor_the_jax_package():
    """Every import statement of the package and of chip_smoke.py, also
    the ones inside functions that the subprocess check never runs: no
    jax, no denseslam_tpu, and no cv2 or PIL (the port runs where
    neither is installed; io/png.py stands in for them)."""
    paths = glob.glob(os.path.join(ROOT, "denseslam_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(paths) > 10
    for path in paths:
        for name in _imported_modules(path):
            assert name.split(".")[0] not in ("jax", "denseslam_tpu", "cv2",
                                              "PIL"), (path, name)



def test_command_line_and_io_modules_import_no_jax_cv2_or_pil():
    """The command line and its IO modules exist, and importing them (and
    the command line's parser) loads none of jax, denseslam_tpu, cv2 or
    PIL."""
    mods = ["main", "io.datasets", "io.pfm", "io.png", "io.native",
            "io.trajectory", "io.checkpoint", "io.make_dataset",
            "utils.timing"]
    for m in mods:
        assert os.path.exists(os.path.join(
            ROOT, "denseslam_tpu_torch", *m.split(".")) + ".py"), m
    code = (
        "import sys\n"
        + "".join(f"import denseslam_tpu_torch.{m}\n" for m in mods)
        + "denseslam_tpu_torch.main.build_parser()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'denseslam_tpu', 'cv2', 'PIL')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr



def test_kernel_wrappers_raise_off_the_cpu_and_never_fall_back():
    """A tensor that is not on the CPU goes to the kernel or raises: here a
    meta tensor (no CUDA on this machine) must raise, and no launch counts."""
    before = dict(kernels.launch_counts)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        psm.sample_blocks(torch.empty((8, 16), dtype=torch.int32, **meta),
                          *(torch.empty((2, 512), **meta) for _ in range(3)),
                          16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        psg.sgm_aggregate(torch.empty((4, 6, 32), **meta), 8.0, 96.0)
    with pytest.raises(ValueError, match="dtype"):
        psg.sgm_aggregate(torch.empty((4, 6, 32), dtype=torch.float16, **meta),
                          8.0, 96.0)
    assert kernels.launch_counts == before

