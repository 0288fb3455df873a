"""The ported slice as a whole: synthetic street frames -> SGM depth ->
fuse_sequence with decay and the slide window on, at a tiny size, against
the JAX package on the same frames.

The JAX side runs jitted here (compute_depth vmapped, fuse_sequence as its
lax.scan), as the JAX drives run it. XLA then fuses each program and
contracts multiply-adds into FMAs, which the port (one rounding per op)
does not: that, not the algorithm, sets the tolerances below."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import (SlideWindowParams, StereoConfig,
                                  VoxelDecayParams, tiny_test_config)
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.models import dense_slam as jd
from denseslam_tpu.ops import stereo as jst
from denseslam_tpu.ops import tsdf as jt
from denseslam_tpu_torch.eval import depth_metrics as pdm
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.io import synthetic as ps
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.ops import stereo as pst
from denseslam_tpu_torch.ops import tsdf as pt

N = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread each spares the other test processes of a parallel run
    the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config(width=96, height=64, baseline_m=0.25)
    cfg = dataclasses.replace(
        cfg,
        stereo=StereoConfig(max_disparity=32, cost_dtype="bfloat16"),
        tsdf=dataclasses.replace(cfg.tsdf, sampler="pallas",
                                 storage_dtype="bfloat16", alloc_subsample=2,
                                 pallas_overflow_cap=8),
        decay=VoxelDecayParams(enabled=True, min_decay_age=1,
                               max_decay_weight=2),
        slide_window=SlideWindowParams(enabled=True, max_age=2),
        pipeline=dataclasses.replace(cfg.pipeline, fusion_db_capacity=2))
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    poses = js.make_trajectory(N, step_m=0.3, yaw_rate=0.01)
    lefts, rights, gt = js.render_stereo_trajectory(poses, cfg.rig,
                                                    js.street_scene())
    depth = jax.jit(jax.vmap(
        lambda a, b: jst.compute_depth(a, b, cfg.rig, cfg.stereo)[0]))(
            lefts, rights)
    m, db = jax.jit(lambda m, db: jd.fuse_sequence(
        m, db, depth, lefts, jnp.asarray(poses),
        jnp.arange(N, dtype=jnp.int32), cfg))(jt.make_map(cfg.tsdf),
                                              jd.make_fusion_db(cfg))
    jax_out = dict(lefts=np.asarray(lefts), rights=np.asarray(rights),
                   gt=np.asarray(gt), depth=np.asarray(depth),
                   map=[np.asarray(x) for x in jax.tree.leaves(m)],
                   db=[np.asarray(x) for x in jax.tree.leaves(db)])
    return cfg, pcfg, poses, jax_out


def _fuse_port(pcfg, poses, depth, grays):
    m = pt.make_map(pcfg.tsdf, device="cpu")
    db = pd.make_fusion_db(pcfg, device="cpu")
    return pd.fuse_sequence(m, db, depth, grays, torch.tensor(poses),
                            torch.arange(N, dtype=torch.int32), pcfg)


def test_render_stereo_trajectory_matches_jax(setup):
    """Depth within 1e-4 relative on >= 99.9% of pixels. Intensities
    within 0.1 (of 255) on >= 99.5% of pixels and within 5 on >= 99.9%:
    the finest texture octave amplifies FMA-sized differences in the hit
    point, and a lattice cell can flip where one crosses a cell boundary
    (observed 99.9% within 0.1, max 2.2)."""
    cfg, pcfg, poses, ref = setup
    lp, rp, dp = ps.render_stereo_trajectory(poses, pcfg.rig, ps.street_scene(),
                                             device="cpu")
    gt = ref["gt"]
    assert dp.shape == gt.shape and (gt > 0).all()
    assert (np.abs(dp.numpy() - gt) <= 1e-4 * gt).mean() >= 0.999
    for got, want in ((lp, ref["lefts"]), (rp, ref["rights"])):
        err = np.abs(got.numpy() - want)
        assert (err <= 0.1).mean() >= 0.995 and (err <= 5.0).mean() >= 0.999


def test_fusion_of_the_jax_depth_matches_jax(setup):
    """Fed the JAX depth: hash table, weights, colors, stamps, counters and
    the DB equal; bf16 tsdf within one bf16 ulp at |tsdf| <= 1 (2^-7) on
    <= 0.1% of voxels (FMA contraction in the JAX scan)."""
    cfg, pcfg, poses, ref = setup
    m, db = _fuse_port(pcfg, poses, torch.tensor(ref["depth"]),
                       torch.tensor(ref["lefts"]))
    got = convert.map_state_to_numpy(m)
    want = [a.view(np.uint16) if a.dtype.name == "bfloat16" else a
            for a in ref["map"]]
    for i, name in enumerate(["keys", "tsdf", "weight", "color", "alloc_frame",
                              "last_seen", "frame", "decayed_blocks",
                              "overflow"]):
        if name != "tsdf":
            assert np.array_equal(want[i], got[i]), name
    tj = ref["map"][1].astype(np.float32)
    tp = m.tsdf.to(torch.float32).numpy()
    assert np.abs(tj - tp).max() <= 2 ** -7
    assert (tj != tp).mean() <= 1e-3
    assert int(pt.num_allocated_blocks(m)) > 0 and int(m.decayed_blocks) >= 0
    for a, b in zip(ref["db"], convert.fusion_db_to_numpy(db)):
        assert np.array_equal(a, b)


def test_slice_end_to_end_from_port_depth(setup):
    """The port's own depth: validity agrees on >= 99% of pixels and depth
    within 1% on >= 98% of pixels valid in both, and both score the same
    against the rendered depth (AbsRel and d1.25 within 0.01); the fused
    maps allocate
    the same blocks up to a 5% Jaccard gap and their total weight agrees
    within 2%."""
    cfg, pcfg, poses, ref = setup
    lp, rp = torch.tensor(ref["lefts"]), torch.tensor(ref["rights"])
    depth = torch.stack([pst.compute_depth(lp[i], rp[i], pcfg.rig,
                                           pcfg.stereo)[0] for i in range(N)])
    dj, dp = ref["depth"], depth.numpy()
    assert ((dj > 0) == (dp > 0)).mean() >= 0.99
    both = (dj > 0) & (dp > 0)
    assert (np.abs(dj[both] - dp[both]) <= 1e-2 * dj[both]).mean() >= 0.98
    qp = pdm.depth_metrics(dp, ref["gt"])
    qj = pdm.depth_metrics(dj, ref["gt"])
    assert abs(qp["absrel"] - qj["absrel"]) <= 0.01, (qp, qj)
    assert abs(qp["d1_25"] - qj["d1_25"]) <= 0.01, (qp, qj)

    m, _ = _fuse_port(pcfg, poses, depth, lp)
    kj = set(ref["map"][0][ref["map"][0] != 2 ** 30].tolist())
    kp = set(m.table.keys[m.table.valid].tolist())
    assert len(kj & kp) / len(kj | kp) >= 0.95
    wj = ref["map"][2].astype(np.float32).sum()
    wp = float(m.weight.to(torch.float32).sum())
    assert abs(wj - wp) <= 0.02 * wj
