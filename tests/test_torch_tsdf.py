"""ops/tsdf.py port vs the JAX fusion tail on rendered frames:
allocate_for_frame -> integrate -> decay_and_slide -> advance_frame, for
both samplers and both storage dtypes, true-RGB and bilinear fusion,
and integrate/deintegrate.

The JAX functions run eagerly (op by op), as tests/test_sampling.py runs
them, so no XLA fusion contracts their multiply-adds; the port then
reproduces every leaf of the map BIT FOR BIT — keys, tsdf, weight, color,
stamps and counters (tolerance: none)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import tiny_test_config
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.ops import tsdf as jt
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.ops import tsdf as pt


@pytest.fixture(scope="module")
def frames():
    cfg = tiny_test_config(width=96, height=72)
    poses = js.make_trajectory(3, step_m=0.1, yaw_rate=0.02)
    grays, depths = js.render_trajectory(poses, cfg.rig.intr)
    return cfg, poses, np.asarray(grays), np.asarray(depths)


def _leaves(m_jax):
    out = []
    for x in jax.tree.leaves(m_jax):
        a = np.asarray(x)
        out.append(a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
    return out


def _assert_maps_equal(m_jax, m_port):
    names = ["keys", "tsdf", "weight", "color", "alloc_frame", "last_seen",
             "frame", "decayed_blocks", "overflow"]
    for n, a, b in zip(names, _leaves(m_jax), convert.map_state_to_numpy(m_port)):
        assert np.array_equal(a, b), n


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("sampler", ["gather", "pallas"])
def test_fusion_tail_matches_jax_bit_for_bit(frames, sampler, storage):
    cfg, poses, grays, depths = frames
    cfg = dataclasses.replace(cfg, tsdf=dataclasses.replace(
        cfg.tsdf, sampler=sampler, storage_dtype=storage,
        # a small cap so the pallas path exercises the over-cap accounting
        pallas_overflow_cap=2))
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    intr, tc = cfg.rig.intr, cfg.tsdf
    m = jt.make_map(tc)
    mp = pt.make_map(pcfg.tsdf, device="cpu")
    for f in range(2):
        T, d, g = jnp.asarray(poses[f + 1]), jnp.asarray(depths[f]), grays[f]
        m, s, k = jt.allocate_for_frame(m, d, T, intr, tc)
        m = jt.integrate(m, s, k, d, jt.pack_gray(jnp.asarray(g)), T, intr, tc)
        m = jt.decay_and_slide(m, 2, 1, 1)
        m = jt.advance_frame(m)

        Tp, dp = torch.tensor(poses[f + 1]), torch.tensor(depths[f])
        mp, sp, kp = pt.allocate_for_frame(mp, dp, Tp, pcfg.rig.intr, pcfg.tsdf)
        np.testing.assert_array_equal(np.asarray(s), sp.numpy())
        mp = pt.integrate(mp, sp, kp, dp, pt.pack_gray(torch.tensor(g)), Tp,
                          pcfg.rig.intr, pcfg.tsdf)
        mp = pt.decay_and_slide(mp, 2, 1, 1)
        mp = pt.advance_frame(mp)
        _assert_maps_equal(m, mp)
    assert int(mp.decayed_blocks) > 0 or int(pt.num_allocated_blocks(mp)) > 0


@pytest.mark.parametrize("sampler", ["gather", "pallas"])
def test_true_rgb_fusion_matches_jax_bit_for_bit(frames, sampler):
    """gray_color_fusion=False: the pallas sampler runs kernel B2's plain
    version with its cap rule (a cap of 2 so the fallback colour gather
    runs), the gather sampler samples raw depth and gathers colour apart.
    Every leaf of the map equals the op-by-op JAX fusion, on 2 frames of a
    random RGB image, and de-integration restores tsdf and weight."""
    cfg, poses, grays, depths = frames
    cfg = dataclasses.replace(cfg, tsdf=dataclasses.replace(
        cfg.tsdf, sampler=sampler, gray_color_fusion=False,
        pallas_overflow_cap=2))
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    intr, tc = cfg.rig.intr, cfg.tsdf
    rgb = np.random.default_rng(9).integers(0, 256, (3,) + grays.shape[1:])
    col = jt.pack_rgb(*(jnp.asarray(c, jnp.float32) for c in rgb))
    colp = pt.pack_rgb(*(torch.tensor(c, dtype=torch.float32) for c in rgb))
    m = jt.make_map(tc)
    mp = pt.make_map(pcfg.tsdf, device="cpu")
    for f in range(2):
        T, d = jnp.asarray(poses[f + 1]), jnp.asarray(depths[f])
        m, s, k = jt.allocate_for_frame(m, d, T, intr, tc)
        m = jt.integrate(m, s, k, d, col, T, intr, tc)
        Tp, dp = torch.tensor(poses[f + 1]), torch.tensor(depths[f])
        mp, sp, kp = pt.allocate_for_frame(mp, dp, Tp, pcfg.rig.intr, pcfg.tsdf)
        mp = pt.integrate(mp, sp, kp, dp, colp, Tp, pcfg.rig.intr, pcfg.tsdf)
        _assert_maps_equal(m, mp)
    rgb_planes = pt.unpack_rgb(mp.color[mp.weight > 0])
    assert not torch.equal(rgb_planes[0], rgb_planes[1])   # true colour
    if sampler == "pallas":
        assert int(mp.overflow) == int(m.overflow)
    w0 = mp.weight.clone()
    mp = pt.deintegrate(mp, sp, kp, dp, colp, Tp, pcfg.rig.intr, pcfg.tsdf)
    _assert_maps_equal(jt.deintegrate(m, s, k, d, col, T, intr, tc), mp)
    assert (mp.weight < w0).any()


@pytest.mark.parametrize("gray", [True, False])
@pytest.mark.parametrize("sampler", ["gather", "pallas"])
def test_bilinear_fusion_matches_jax_bit_for_bit(frames, sampler, gray,
                                                  monkeypatch):
    """bilinear_fusion=True: the edge-aware bilinear depth sample and a
    nearest-pixel colour gather, under either sampler (the tile sampler
    B1 / B2 is bypassed, as in the JAX version, so it must not be called),
    with luminance or true-RGB colour, on 2 frames and a de-integration:
    every leaf of the map equals the op-by-op JAX fusion."""
    cfg, poses, grays, depths = frames
    cfg = dataclasses.replace(cfg, tsdf=dataclasses.replace(
        cfg.tsdf, sampler=sampler, bilinear_fusion=True,
        gray_color_fusion=gray))
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    intr, tc = cfg.rig.intr, cfg.tsdf

    def refuse(*a, **k):
        raise AssertionError("bilinear fusion called the tile sampler")

    monkeypatch.setattr(pt.sampling, "tile_sample", refuse)
    monkeypatch.setattr(pt.sampling, "tile_sample_rgb", refuse)
    rgb = np.random.default_rng(3).integers(0, 256, (3,) + grays.shape[1:])
    m = jt.make_map(tc)
    mp = pt.make_map(pcfg.tsdf, device="cpu")
    for f in range(2):
        T, d = jnp.asarray(poses[f + 1]), jnp.asarray(depths[f])
        col = (jt.pack_gray(jnp.asarray(grays[f])) if gray else
               jt.pack_rgb(*(jnp.asarray(c, jnp.float32) for c in rgb)))
        m, s, k = jt.allocate_for_frame(m, d, T, intr, tc)
        m = jt.integrate(m, s, k, d, col, T, intr, tc)
        Tp, dp = torch.tensor(poses[f + 1]), torch.tensor(depths[f])
        colp = torch.tensor(np.asarray(col))
        mp, sp, kp = pt.allocate_for_frame(mp, dp, Tp, pcfg.rig.intr,
                                           pcfg.tsdf)
        mp = pt.integrate(mp, sp, kp, dp, colp, Tp, pcfg.rig.intr, pcfg.tsdf)
        _assert_maps_equal(m, mp)
    assert (mp.weight > 0).sum() > 1000
    mp = pt.deintegrate(mp, sp, kp, dp, colp, Tp, pcfg.rig.intr, pcfg.tsdf)
    _assert_maps_equal(jt.deintegrate(m, s, k, d, col, T, intr, tc), mp)


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
    m1 = jt.integrate(m0, s, k, d, col, T, intr, tc)
    m2 = jt.deintegrate(m1, s, k, d, col, T, intr, tc)

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
    m = jt.integrate(m, s, k, d, None, T, intr, tc)
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
    m = jt.integrate(m, s, k, d, None, T, intr, tc)
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
