"""The renderers of the port (ops/splat.py, ops/raycast.py, the point
samplers of ops/tsdf.py, utils/image.py and `DenseSLAM.raycast_view`)
against the JAX package, on a map fused from 3 frames of the synthetic
scene at 160x120 (tiny_test_config, 48 sphere-trace steps), the same
map on both sides. This file holds the point samplers and the splat
renderer; tests/test_torch_render_views.py the raycast, refinement,
normals, hole filling and `raycast_view`; tests/test_torch_render_preview.py
the previews and depth PNGs; tests/test_torch_render_image.py the image
ops. The first three share this file's scene fixture (made once a file).

Tolerances, and why:
  * point samplers, `_fill_holes`, `refine_depth`, `_normals_soA`, the
    splat z-buffer keys and outputs, `raycast` and `raycast_view` with
    each renderer, against JAX run op by op (`jax.disable_jit`): equal,
    bit for bit. (The port's square roots are correctly rounded on the
    CPU, utils/numerics.py `sqrt`.)
  * against jitted JAX, which contracts multiply-adds into FMAs: the
    z-buffer keys equal on >= 99.5% of pixels (a voxel within an FMA
    rounding of a pixel edge or a depth bucket moves; all equal on this
    map), depth within 1e-5 m wherever both hit (exact on 74% of them,
    1.9e-6 at most), mask equal on >= 99.5%.
  * `bilateral_filter_depth`: XLA's and torch's float32 `exp` differ by
    ulps: within 1e-6 m.
  * the other image ops: equal, except `downsample2`'s 4-term means and
    the colour `bilinear_sample` (rtol 1e-6: their order of summation).
  * previews: equal (the gray shading within 1 level: a 3-term dot).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.core import ClosedJaxpr, jaxpr_as_fun

from denseslam_tpu.config import tiny_test_config
from denseslam_tpu.ops import raycast as jrc
from denseslam_tpu.ops import splat as jsp
from denseslam_tpu.ops import tsdf as jt
from denseslam_tpu.utils import lie as jl
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.io import synthetic as ps
from denseslam_tpu_torch.ops import splat as psp
from denseslam_tpu_torch.ops import tsdf as pt

SPLAT = jsp.SplatConfig(max_blocks=1024, max_voxels=1 << 16)
# the pipeline's bleed override (config.SplatParams)
SPLAT_BLEED = SPLAT._replace(bleed_rel=0.15, bleed_abs=0.5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are small: one thread each spares the other
    test processes of a parallel run the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def scene():
    """The map of 3 frames of the default scene, rendered and fused by the
    port (both held to JAX's in tests/test_torch_{slice,tsdf}.py) and
    carried to JAX as numpy; a view off the fused poses."""
    cfg = tiny_test_config(width=160, height=120)
    # 48 sphere-trace steps end every ray of this view (96 hit no more)
    cfg = dataclasses.replace(cfg, tsdf=dataclasses.replace(
        cfg.tsdf, raycast_steps=48))
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    poses = ps.make_trajectory(3, step_m=0.1, yaw_rate=0.0)
    grays, depths = ps.render_trajectory(poses, pcfg.rig.intr, device="cpu")
    intr, tc = pcfg.rig.intr, pcfg.tsdf
    pm = pt.make_map(tc, device="cpu")
    for i in range(3):
        T = torch.tensor(poses[i])
        pm, slots, mask = pt.allocate_for_frame(pm, depths[i], T, intr, tc)
        pm = pt.integrate(pm, slots, mask, depths[i], pt.pack_gray(grays[i]),
                          T, intr, tc)
        pm = pt.advance_frame(pm)
    m = jax.tree.unflatten(jax.tree.structure(jt.make_map(cfg.tsdf)),
                           [jnp.asarray(x)
                            for x in convert.map_state_to_numpy(pm)])
    # a view off the fused poses: moved back, aside and turned a little
    T = poses[0] @ np.asarray(jl.se3_exp(
        jnp.array([0.03, -0.02, -0.2, 0.01, 0.02, 0.0], jnp.float32)))
    return dict(cfg=cfg, pcfg=pcfg, m=m, pm=pm, T=T.astype(np.float32),
                depth=depths[0].numpy())


def _near_surface_points(s, n=4000, seed=0):
    """World points around the fused surface of the first view, and a few
    in free space and outside the map."""
    rng = np.random.default_rng(seed)
    intr = s["cfg"].rig.intr
    d = s["depth"]
    v, u = np.nonzero(d > 0)
    k = rng.choice(len(v), n)
    z = d[v[k], u[k]] + rng.normal(0, 0.1, n)
    pc = np.stack([(u[k] - intr.cx) / intr.fx * z,
                   (v[k] - intr.cy) / intr.fy * z, z], -1)
    pc[:100] = rng.uniform(-20, 20, (100, 3))
    return pc.astype(np.float32)      # the first view is at the origin


def _op_by_op(fn, *args):
    """fn(*args) in JAX, op by op: its jaxpr evaluated under disable_jit,
    so that every call shares one cache of compiled primitives. (A scan in
    the jaxpr would still run compiled: use disable_jit around the Python
    function for those.)"""
    cj = jax.make_jaxpr(fn)(*args)
    with jax.disable_jit():
        out = jaxpr_as_fun(cj)(*jax.tree.leaves(args))
    return jax.tree.unflatten(jax.tree.structure(jax.eval_shape(fn, *args)),
                              out)


def _jax_splat(s, sc, op_by_op):
    """JAX's splat_render at the scene's view, with its scatter-min
    z-buffer (the function's first scatter, cut out of its jaxpr) as an
    extra output: (keys, Raycast), op by op or jitted, computed once."""
    cache = s.setdefault("jax_splat", {})
    if (sc, op_by_op) in cache:
        return cache[sc, op_by_op]
    intr, tc = s["cfg"].rig.intr, s["cfg"].tsdf
    T = jnp.asarray(s["T"])
    cj = jax.make_jaxpr(lambda m, T: jsp.splat_render(m, T, intr, tc, sc))(
        s["m"], T)
    eqn = next(e for e in cj.jaxpr.eqns
               if e.primitive.name == "scatter-min")
    fn = jaxpr_as_fun(ClosedJaxpr(cj.jaxpr.replace(
        outvars=list(eqn.outvars) + list(cj.jaxpr.outvars)), cj.consts))
    args = jax.tree.leaves((s["m"], T))
    if op_by_op:
        with jax.disable_jit():
            out = fn(*args)
    else:
        out = jax.jit(fn)(*args)
    out = [np.asarray(x) for x in out]
    cache[sc, op_by_op] = (out[0], jrc.Raycast(*out[1:]))
    return cache[sc, op_by_op]


SAMPLERS = {
    "xyz": (lambda mod, m, p, c: mod.sample_tsdf_xyz(m, p[:, 0], p[:, 1],
                                                     p[:, 2], c)),
    "nearest": (lambda mod, m, p, c: mod.sample_tsdf_nearest(m, p, c)),
    "color": (lambda mod, m, p, c: mod.sample_color_xyz(m, p[:, 0], p[:, 1],
                                                        p[:, 2], c)),
    "trilinear": (lambda mod, m, p, c: mod.sample_tsdf_trilinear(m, p, c)),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_point_samplers_match_jax(scene, name):
    s = scene
    pts = _near_surface_points(s)
    want = _op_by_op(lambda m, p: SAMPLERS[name](jt, m, p, s["cfg"].tsdf),
                     s["m"], jnp.asarray(pts))
    got = SAMPLERS[name](pt, s["pm"], torch.tensor(pts), s["pcfg"].tsdf)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    if name != "color":
        assert (got[1] > 0).float().mean() > 0.3      # most points observed


@pytest.mark.parametrize("op_by_op", [True, False], ids=["op_by_op", "jit"])
def test_splat_zbuffer_keys_match_jax(scene, op_by_op):
    s = scene
    want = _jax_splat(s, SPLAT_BLEED, op_by_op)[0]
    got = psp.splat_zbuffer(s["pm"], torch.tensor(s["T"]),
                            s["pcfg"].rig.intr, s["pcfg"].tsdf,
                            psp.SplatConfig(*SPLAT_BLEED))[0].numpy()
    won = want != np.iinfo(np.int32).max
    assert won.mean() > 0.3
    if op_by_op:
        np.testing.assert_array_equal(got, want)
    else:
        assert (got == want).mean() >= 0.995


@pytest.mark.parametrize("sc", [SPLAT, SPLAT_BLEED], ids=["fill", "bleed"])
def test_splat_render_matches_jax_op_by_op(scene, sc):
    s = scene
    want = _jax_splat(s, sc, True)[1]
    got = psp.splat_render(s["pm"], torch.tensor(s["T"]), s["pcfg"].rig.intr,
                           s["pcfg"].tsdf, psp.SplatConfig(*sc))
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name), name)


def test_splat_render_matches_jitted_jax(scene):
    s = scene
    want = _jax_splat(s, SPLAT_BLEED, False)[1]
    got = psp.splat_render(s["pm"], torch.tensor(s["T"]), s["pcfg"].rig.intr,
                           s["pcfg"].tsdf, psp.SplatConfig(*SPLAT_BLEED))
    dw, dg = want.depth, got.depth.numpy()
    assert (want.mask == got.mask.numpy()).mean() >= 0.995
    both = (dw > 0) & (dg > 0)
    assert both.mean() > 0.5
    np.testing.assert_allclose(dg[both], dw[both], rtol=0, atol=1e-5)


