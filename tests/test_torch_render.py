"""The renderers of the port (ops/splat.py, ops/raycast.py, the point
samplers of ops/tsdf.py, utils/image.py and `DenseSLAM.raycast_view`)
against the JAX package, on a map fused from 3 frames of the synthetic
scene at 160x120 (tiny_test_config, 48 sphere-trace steps), the same
map on both sides.

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
from denseslam_tpu.models import dense_slam as jd
from denseslam_tpu.ops import raycast as jrc
from denseslam_tpu.ops import splat as jsp
from denseslam_tpu.ops import tsdf as jt
from denseslam_tpu.utils import image as jim
from denseslam_tpu.utils import lie as jl
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.io import synthetic as ps
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.ops import raycast as prc
from denseslam_tpu_torch.ops import splat as psp
from denseslam_tpu_torch.ops import tsdf as pt
from denseslam_tpu_torch.utils import image as pim

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


@pytest.mark.parametrize("bleed", [(0.0, 0.0), (0.15, 0.5)],
                         ids=["fill", "bleed"])
def test_fill_holes_matches_jax(bleed):
    """An odd-sized depth image with holes and far-behind outliers."""
    rng = np.random.default_rng(3)
    d = rng.uniform(2.0, 6.0, (61, 83)).astype(np.float32)
    d[rng.random(d.shape) < 0.4] = 0.0
    d[rng.random(d.shape) < 0.05] = 30.0
    want = _op_by_op(lambda x: jsp._fill_holes(x, 3, *bleed), jnp.asarray(d))
    got = psp._fill_holes(torch.tensor(d), 3, *bleed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() > 0).mean() > (d > 0).mean()


@pytest.mark.parametrize("prune", [0.0, 0.3], ids=["refine", "prune"])
def test_refine_depth_matches_jax(scene, prune):
    s = scene
    T = s["T"]
    rc = psp.splat_render(s["pm"], torch.tensor(T), s["pcfg"].rig.intr,
                          s["pcfg"].tsdf, psp.SplatConfig(*SPLAT_BLEED))
    want = _op_by_op(
        lambda m, d, k, T: jsp.refine_depth(m, d, k, T, s["cfg"].rig.intr,
                                            s["cfg"].tsdf, steps=2,
                                            prune_sdf=prune),
        s["m"], jnp.asarray(rc.depth.numpy()), jnp.asarray(rc.mask.numpy()),
        jnp.asarray(T))
    got = psp.refine_depth(s["pm"], rc.depth, rc.mask, torch.tensor(T),
                           s["pcfg"].rig.intr, s["pcfg"].tsdf, steps=2,
                           prune_sdf=prune)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kept = (got > 0).float().mean() / rc.mask.float().mean()
    assert (kept < 1.0) if prune else (kept == 1.0)


def _jax_raycast(s):
    """JAX's raycast at the scene's view, op by op (the scan as a Python
    loop under disable_jit), computed once."""
    if "jax_raycast" not in s:
        with jax.disable_jit():
            s["jax_raycast"] = jrc.raycast(s["m"], jnp.asarray(s["T"]),
                                           s["cfg"].rig.intr, s["cfg"].tsdf)
    return s["jax_raycast"]


def test_raycast_matches_jax(scene):
    s = scene
    want = _jax_raycast(s)
    got = prc.raycast(s["pm"], torch.tensor(s["T"]), s["pcfg"].rig.intr,
                      s["pcfg"].tsdf)
    assert got.mask.float().mean() > 0.5
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)


def test_normals_soA_matches_jax():
    rng = np.random.default_rng(4)
    p = rng.normal(size=(3, 30, 40)).astype(np.float32)
    mask = rng.random((30, 40)) < 0.8
    want = _op_by_op(jrc._normals_soA, *map(jnp.asarray, p),
                     jnp.asarray(mask))
    got = prc._normals_soA(*map(torch.tensor, p), torch.tensor(mask))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("kind", ["depth", "raycast_depth", "normal",
                                  "color", "gray"])
def test_render_preview_matches_jax(scene, kind):
    s = scene
    rc = prc.raycast(s["pm"], torch.tensor(s["T"]), s["pcfg"].rig.intr,
                     s["pcfg"].tsdf)
    want = np.asarray(jrc.render_preview(
        jrc.Raycast(*(jnp.asarray(x.numpy()) for x in rc)), kind))
    got = prc.render_preview(rc, kind).numpy()
    if kind == "gray":
        assert np.abs(got.astype(int) - want).max() <= 1
    else:
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        prc.render_preview(rc, "sketch")


def test_png16_round_trip():
    rng = np.random.default_rng(5)
    d = rng.uniform(-1.0, 300.0, (20, 30)).astype(np.float32)
    want = np.asarray(jrc.depth_to_png16(jnp.asarray(d)))
    got = prc.depth_to_png16(torch.tensor(d))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        prc.png16_to_depth(got).numpy(),
        np.asarray(jrc.png16_to_depth(jnp.asarray(want))))


@pytest.mark.parametrize("renderer,refine,prune", [
    ("splat", 0, 0.0), ("splat", 2, 0.3), ("raycast", 0, 0.0)],
    ids=["splat", "splat_refine_prune", "raycast"])
def test_raycast_view_matches_jax(scene, renderer, refine, prune):
    """DenseSLAM.raycast_view and get_preview with each renderer, the JAX
    side run op by op."""
    s = scene

    def cfg_of(c):
        return dataclasses.replace(c, pipeline=dataclasses.replace(
            c.pipeline, renderer=renderer, splat_refine=refine,
            splat_prune_sdf=prune), splat=dataclasses.replace(
            c.splat, max_blocks=1024, max_voxels=1 << 16))

    jslam = jd.DenseSLAM(cfg_of(s["cfg"]))
    jslam.submaps.active = s["m"]
    pslam = pd.DenseSLAM(cfg_of(s["pcfg"]), device="cpu")
    pslam.submaps.active = s["pm"]
    if renderer == "raycast":
        # JAX's raycast_view with this renderer is raycast() of the map
        want = _jax_raycast(s)
    else:
        want = _op_by_op(jslam.raycast_view, jnp.asarray(s["T"]))
    # what get_preview returns, without a second render
    want_preview = np.asarray(jrc.render_preview(want, "normal"))
    got = pslam.raycast_view(s["T"])
    assert got.mask.float().mean() > 0.4
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_array_equal(
        pslam.get_preview("normal", torch.tensor(s["T"])).numpy(),
        want_preview)


def test_bilateral_filter_depth_matches_jax():
    rng = np.random.default_rng(6)
    d = rng.uniform(2.0, 4.0, (40, 50)).astype(np.float32)
    d[:, 25:] += 1.0                                   # an edge to keep
    d[rng.random(d.shape) < 0.1] = 0.0
    want = np.asarray(jax.jit(jim.bilateral_filter_depth)(jnp.asarray(d)))
    got = pim.bilateral_filter_depth(torch.tensor(d)).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got[:, 20:24] - d[:, 20:24]).max() < 0.5   # edge kept


def _image_op_cases():
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, (24, 32)).astype(np.float32)
    rgb = rng.uniform(0, 255, (24, 32, 3)).astype(np.float32)
    depth = rng.uniform(1, 3, (24, 32)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.2] = 0.0
    uv = np.stack([rng.uniform(-3, 35, 200), rng.uniform(-3, 27, 200)],
                  -1).astype(np.float32)
    return {
        "bilinear_sample": ("bilinear_sample", (img, uv), 0),
        "bilinear_sample_rgb": ("bilinear_sample", (rgb, uv), 1e-6),
        "nearest_sample": ("nearest_sample", (rgb, uv), 0),
        "depth_bilinear_sample": ("depth_bilinear_sample", (depth, uv), 0),
        "downsample2": ("downsample2", (rgb,), 1e-6),
        "downsample2_depth": ("downsample2_depth", (depth,), 0),
        "gradient_xy": ("gradient_xy", (img,), 0),
        "rgb_to_gray": ("rgb_to_gray", (rgb,), 0),
    }


@pytest.mark.parametrize("case", sorted(_image_op_cases()))
def test_image_ops_match_jax(case):
    fn, args, rtol = _image_op_cases()[case]
    with jax.disable_jit():
        want = getattr(jim, fn)(*map(jnp.asarray, args))
    got = getattr(pim, fn)(*map(torch.tensor, args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(want, got):
        if rtol:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
