"""Stereo port vs the JAX stereo ops: the cost volume, WTA/LR/uniqueness
and compute_depth, and the camera helpers (the SGM aggregation alone is in
tests/test_torch_stereo_sgm.py). The JAX Pallas SGM runs in interpret
mode."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import StereoConfig, tiny_test_config
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.ops import stereo as jst
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.ops import stereo as pst


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread each spares the other test processes of a parallel run
    the oversubscribed cores (the exact FMAs' float64 passes are memory
    bound)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_test_config(width=80, height=48, baseline_m=0.25)
    cfg = dataclasses.replace(cfg, stereo=StereoConfig(max_disparity=16))
    left, right, depth_gt = js.render_stereo(jnp.eye(4, dtype=jnp.float32),
                                             cfg.rig)
    return cfg, left, right, np.asarray(depth_gt)


def test_cost_volume_within_f32_tolerance(pair):
    """The box filters are cumsum differences and the two frameworks sum in
    a different order: atol 1e-3 on costs of up to ~255 (observed 8e-5)."""
    cfg, left, right, _ = pair
    ref = np.asarray(jst.cost_volume(left, right, cfg.stereo))
    got = pst.cost_volume(torch.tensor(np.asarray(left)),
                          torch.tensor(np.asarray(right)),
                          convert.config_from_dict(
                              dataclasses.asdict(cfg)).stereo).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(ref, got, rtol=0, atol=1e-3)


@pytest.mark.parametrize("cost_dtype", ["float32", "bfloat16"])
def test_disparity_from_cost_exact_on_the_same_volume(pair, cost_dtype):
    """Given the same volume, SGM + WTA + subpixel + LR check + uniqueness
    gate agree exactly (argmin takes the first index on ties in both)."""
    cfg, left, right, _ = pair
    sc = dataclasses.replace(cfg.stereo, cost_dtype=cost_dtype)
    cv = jst.cost_volume(left, right, sc)
    if cost_dtype == "bfloat16":
        cv = cv.astype(jnp.bfloat16)
    dj, vj = jst.disparity_from_cost(jst.sgm_aggregate(cv, sc), sc, raw_cost=cv)
    ct = torch.tensor(np.asarray(cv.astype(jnp.float32)))
    if cost_dtype == "bfloat16":
        ct = ct.to(torch.bfloat16)
    psc = convert.config_from_dict(dataclasses.asdict(cfg)).stereo
    psc = dataclasses.replace(psc, cost_dtype=cost_dtype)
    dp, vp = pst.disparity_from_cost(pst.sgm_aggregate(ct, psc), psc,
                                     raw_cost=ct)
    np.testing.assert_array_equal(np.asarray(dj), dp.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vp.numpy())


@pytest.mark.parametrize("cost_dtype", ["float32", "bfloat16"])
def test_compute_depth_agrees_with_jax(pair, cost_dtype):
    """End to end from the image pair. The cost volumes differ in the last
    bits (see above), which can flip a near-tie: validity must agree on
    >= 99% of pixels and depth within 0.1% on >= 99% of the pixels valid
    in both (observed: 100% and >= 99.9%)."""
    cfg, left, right, gt = pair
    sc = dataclasses.replace(cfg.stereo, cost_dtype=cost_dtype)
    dj, vj = jst.compute_depth(left, right, cfg.rig, sc)
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    dp, vp = pst.compute_depth(torch.tensor(np.asarray(left)),
                               torch.tensor(np.asarray(right)), pcfg.rig,
                               dataclasses.replace(pcfg.stereo,
                                                   cost_dtype=cost_dtype))
    dj, vj, dp, vp = np.asarray(dj), np.asarray(vj), dp.numpy(), vp.numpy()
    assert (vj == vp).mean() >= 0.99
    both = vj & vp
    assert both.mean() > 0.5
    rel = np.abs(dj[both] - dp[both]) / dj[both]
    assert (rel <= 1e-3).mean() >= 0.99


def test_camera_helpers_match_jax():
    """backproject, project and disparity_to_depth: the same elementwise
    f32 ops in the same order. XLA:CPU's division can round one ulp away
    from torch's (observed 1.2e-7 relative on a quarter of the points), so
    the tolerance is two f32 ulps: rtol 2.4e-7."""
    from denseslam_tpu.utils import camera as jcam
    from denseslam_tpu_torch.utils import camera as pcam
    cfg = tiny_test_config()
    intr = cfg.rig.intr
    prig = pcam.StereoRig(pcam.Intrinsics(*intr), cfg.rig.baseline_m)
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.0, 20.0, (intr.height, intr.width)).astype(np.float32)
    pts = np.array(jcam.backproject(jnp.asarray(depth), intr))
    np.testing.assert_allclose(
        pts, pcam.backproject(torch.tensor(depth), prig.intr).numpy(),
        rtol=2.4e-7, atol=0)
    pts[0, :5, 2] = 0.0                       # the behind-the-camera guard
    uv, z = jcam.project(jnp.asarray(pts), intr)
    uvp, zp = pcam.project(torch.tensor(pts), prig.intr)
    np.testing.assert_allclose(np.asarray(uv), uvp.numpy(), rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(np.asarray(z), zp.numpy())
    disp = rng.uniform(-1.0, 60.0, (intr.height, intr.width)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jcam.disparity_to_depth(jnp.asarray(disp), cfg.rig)),
        pcam.disparity_to_depth(torch.tensor(disp), prig).numpy(),
        rtol=2.4e-7, atol=0)
