"""Port scaffolding: the config copy and the state converters of
denseslam_tpu_torch (the import and device rules are in
tests/test_torch_config_imports.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu import config as jcfg
from denseslam_tpu.models import dense_slam as jds
from denseslam_tpu.ops import tsdf as jt
from denseslam_tpu_torch import config as pcfg
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import dense_slam as pds
from denseslam_tpu_torch.ops import tsdf as pt


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


