"""ops/tsdf.py port vs the JAX map passes on rendered frames (split from
tests/test_torch_tsdf.py, whose frames, 0.7 s of JAX rendering, this file
renders once more): integrate then deintegrate for both samplers, the
decay and sliding-window passes on their own, the memory accounting, the
sequence-end decay catch-up and reset.

JAX's `integrate` and `deintegrate` run jitted (`_integrate`, the
programs whose order the port copies), as in tests/test_torch_tsdf.py;
the port reproduces every leaf of the map BIT FOR BIT (tolerance: none)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.ops import tsdf as jt
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.ops import tsdf as pt
from test_torch_tsdf import (_assert_maps_equal, _integrate,  # noqa: F401
                             frames, one_torch_thread)


@pytest.mark.parametrize("sampler", ["gather", "pallas"])
def test_integrate_then_deintegrate_restores_the_map(frames, sampler):
    """tsdf.py:316-318: de-integration replaying the same view and pose is
    integrate's exact inverse; the port's deintegrate also equals JAX's."""
    cfg, poses, grays, depths = frames
    cfg = dataclasses.replace(cfg, tsdf=dataclasses.replace(cfg.tsdf,
                                                            sampler=sampler))
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    intr, tc = cfg.rig.intr, cfg.tsdf
    T, d = jnp.asarray(poses[0]), jnp.asarray(depths[0])
    col = jt.pack_gray(jnp.asarray(grays[0]))
    m0, s, k = jt.allocate_for_frame(jt.make_map(tc), d, T, intr, tc)
    m1 = _integrate(intr, tc)(m0, s, k, d, col, T)
    m2 = _integrate(intr, tc, -1)(m1, s, k, d, col, T)

    Tp, dp = torch.tensor(poses[0]), torch.tensor(depths[0])
    colp = pt.pack_gray(torch.tensor(grays[0]))
    mp, sp, kp = pt.allocate_for_frame(pt.make_map(pcfg.tsdf, device="cpu"),
                                       dp, Tp, pcfg.rig.intr, pcfg.tsdf)
    w0, t0 = mp.weight.clone(), mp.tsdf.clone()
    mp = pt.integrate(mp, sp, kp, dp, colp, Tp, pcfg.rig.intr, pcfg.tsdf)
    assert (mp.weight > 0).any()
    _assert_maps_equal(m1, mp)
    mp = pt.deintegrate(mp, sp, kp, dp, colp, Tp, pcfg.rig.intr, pcfg.tsdf)
    _assert_maps_equal(m2, mp)
    assert torch.equal(mp.weight, w0) and torch.equal(mp.tsdf, t0)



def test_decay_and_slide_window_passes_match_jax(frames):
    """decay / slide_window on their own (the non-fused tail branches)."""
    cfg, poses, grays, depths = frames
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    intr, tc = cfg.rig.intr, cfg.tsdf
    T, d = jnp.asarray(poses[0]), jnp.asarray(depths[0])
    m, s, k = jt.allocate_for_frame(jt.make_map(tc), d, T, intr, tc)
    m = _integrate(intr, tc)(m, s, k, d, None, T)
    m = m._replace(frame=jnp.int32(5),
                   weight=m.weight * jnp.asarray(
                       np.random.default_rng(1).integers(1, 4, (1, 512)),
                       jnp.float32))
    mp = convert.map_state_from_numpy([np.asarray(x) for x in
                                       jax.tree.leaves(m)], device="cpu")
    _assert_maps_equal(jt.decay(m, 2, 3), pt.decay(mp, 2, 3))
    mp = convert.map_state_from_numpy([np.asarray(x) for x in
                                       jax.tree.leaves(m)], device="cpu")
    _assert_maps_equal(jt.slide_window(m, 4), pt.slide_window(mp, 4))



def test_used_memory_decay_catchup_and_reset_match_jax(frames):
    """ops/tsdf.py used_memory_bytes, decay_catchup (the sequence-end decay
    that ignores the age gate) and reset (a fresh map) against JAX's."""
    cfg, poses, grays, depths = frames
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    intr, tc = cfg.rig.intr, cfg.tsdf
    T, d = jnp.asarray(poses[0]), jnp.asarray(depths[0])
    m, s, k = jt.allocate_for_frame(jt.make_map(tc), d, T, intr, tc)
    m = _integrate(intr, tc)(m, s, k, d, None, T)
    m = m._replace(frame=jnp.int32(1),
                   weight=m.weight * jnp.asarray(
                       np.random.default_rng(2).integers(1, 4, (1, 512)),
                       jnp.float32))

    def port(m):
        return convert.map_state_from_numpy(
            [np.asarray(x) for x in jax.tree.leaves(m)], device="cpu")

    mp = port(m)
    assert int(pt.used_memory_bytes(mp)) == int(jt.used_memory_bytes(m)) > 0
    assert int(pt.used_memory_bytes(mp, 8)) == int(jt.used_memory_bytes(m, 8))
    caught = jt.decay_catchup(m, 2)
    _assert_maps_equal(caught, pt.decay_catchup(port(m), 2))
    assert int(caught.decayed_blocks) >= 0
    _assert_maps_equal(jt.reset(m, tc), pt.reset(port(m), pcfg.tsdf))

