"""Port scaffolding: the config copy, the state converters, the import rule
and the device rule of denseslam_tpu_torch."""

import ast
import dataclasses
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu import config as jcfg
from denseslam_tpu.models import dense_slam as jds
from denseslam_tpu.ops import tsdf as jt
from denseslam_tpu_torch import config as pcfg
from denseslam_tpu_torch import kernels
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import dense_slam as pds
from denseslam_tpu_torch.ops import sampling as psm
from denseslam_tpu_torch.ops import sgm as psg
from denseslam_tpu_torch.ops import tsdf as pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _classes(mod):
    return {n: c for n, c in vars(mod).items()
            if dataclasses.is_dataclass(c) and isinstance(c, type)}


def test_config_classes_match_field_for_field():
    j, p = _classes(jcfg), _classes(pcfg)
    assert set(j) == set(p)
    for name in j:
        jf = [(f.name, f.default) for f in dataclasses.fields(j[name])]
        pf = [(f.name, f.default) for f in dataclasses.fields(p[name])]
        # nested dataclass defaults compare by value
        norm = lambda fs: [(n, dataclasses.asdict(d) if dataclasses.is_dataclass(d)  # noqa: E731
                            else d) for n, d in fs]
        assert norm(jf) == norm(pf), name


@pytest.mark.parametrize("kw", [{}, {"width": 160, "height": 120, "baseline_m": 0.2}])
def test_tiny_config_and_config_from_dict(kw):
    j = jcfg.tiny_test_config(**kw)
    j = dataclasses.replace(
        j, tsdf=dataclasses.replace(j.tsdf, sampler="pallas",
                                    storage_dtype="bfloat16"),
        decay=jcfg.VoxelDecayParams(enabled=True))
    p = convert.config_from_dict(dataclasses.asdict(j))
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert p.rig.intr == tuple(j.rig.intr)
    assert dataclasses.asdict(pcfg.tiny_test_config(**kw)) == \
        dataclasses.asdict(jcfg.tiny_test_config(**kw))


def _filled_jax_state(storage):
    """A JAX map + DB with non-trivial content (one fused frame)."""
    from denseslam_tpu.io import synthetic
    cfg = jcfg.tiny_test_config()
    cfg = dataclasses.replace(
        cfg, tsdf=dataclasses.replace(cfg.tsdf, storage_dtype=storage),
        pipeline=dataclasses.replace(cfg.pipeline, fusion_db_capacity=3))
    T = jnp.eye(4, dtype=jnp.float32)
    gray, depth = synthetic.render_view(T, cfg.rig.intr)
    m, db = jds.fuse_keyframe(jt.make_map(cfg.tsdf), jds.make_fusion_db(cfg),
                              depth, gray, T, jnp.int32(7), cfg)
    return m, db


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_convert_round_trips_jax_state_bit_for_bit(storage):
    m, db = _filled_jax_state(storage)
    leaves = [np.asarray(x) for x in jax.tree.leaves(m)]
    pm = convert.map_state_from_numpy(leaves, device="cpu")
    assert pm.tsdf.dtype == pt.storage_dtype(
        pcfg.TsdfConfig(storage_dtype=storage))
    back = convert.map_state_to_numpy(pm)
    for a, b in zip(leaves, back):
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)       # bf16 arrives/leaves as its bits
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the uint16-bits form of a bf16 plane is read the same way
    if storage == "bfloat16":
        bits = [x.view(np.uint16) if x.dtype.name == "bfloat16" else x
                for x in leaves]
        pm2 = convert.map_state_from_numpy(bits, device="cpu")
        assert torch.equal(pm2.tsdf, pm.tsdf)

    dleaves = [np.asarray(x) for x in jax.tree.leaves(db)]
    pdb = convert.fusion_db_from_numpy(dleaves, device="cpu")
    assert pdb.quantized
    assert int(pdb.frame_id[0]) == 7 and bool(pdb.valid[0])
    for a, b in zip(dleaves, convert.fusion_db_to_numpy(pdb)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_fusion_db_replay_reads_match_jax():
    m, db = _filled_jax_state("float32")
    pdb = convert.fusion_db_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(db)], device="cpu")
    np.testing.assert_array_equal(np.asarray(jds.db_depth(db, 0)),
                                  pds.db_depth(pdb, 0).numpy())
    np.testing.assert_array_equal(np.asarray(jds.db_gray(db, 0)),
                                  pds.db_gray(pdb, 0).numpy())


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
