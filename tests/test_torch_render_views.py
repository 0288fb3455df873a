"""The port's raycast, depth refinement, normals, hole filling and
`DenseSLAM.raycast_view` against the JAX package run op by op, on the
map of tests/test_torch_render.py (split from that file; its scene
fixture, the port's fusion of 3 frames at 160x120, is made once more
here). Tolerances: equal, bit for bit (see tests/test_torch_render.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.models import dense_slam as jd
from denseslam_tpu.ops import raycast as jrc
from denseslam_tpu.ops import splat as jsp
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.ops import raycast as prc
from denseslam_tpu_torch.ops import splat as psp
from test_torch_render import (SPLAT_BLEED, _op_by_op,  # noqa: F401
                               one_torch_thread, scene)


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

