"""ops/features.py port (the gradient stack) vs the JAX feature ops on
rendered street frames with photometric noise, at 160x120.

The JAX side runs jitted. The port builds every response map from shifted
copies in the JAX order, so detection and bucketing agree EXACTLY: uv,
cls, score and valid are equal (tolerance: none). The descriptor's L2
norm sums in another order: desc within atol 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import tiny_test_config
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.ops import features as jf
from denseslam_tpu_torch import config as pc
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.ops import features as pf

W, H = 160, 120


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread each spares the other test processes of a parallel run
    the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images():
    cfg = tiny_test_config(width=W, height=H, baseline_m=0.537)
    poses = js.make_trajectory(2, step_m=0.25, yaw_rate=0.003)
    g, _ = js.render_trajectory(poses, cfg.rig.intr, js.street_scene())
    g = np.asarray(g)
    rng = np.random.default_rng(3)
    noisy = np.clip(g + 2.0 * rng.normal(size=g.shape), 0, 255)
    return cfg, noisy.astype(np.float32)


@pytest.mark.parametrize("bucket_px", [50, 25])
def test_detect_and_bucket_match_jax(images, bucket_px):
    cfg, grays = images
    fc = dataclasses.replace(cfg.frontend, max_features=256,
                             bucket_w=bucket_px, bucket_h=bucket_px)
    pfc = pc.FrontendConfig(**dataclasses.asdict(fc))
    run = jax.jit(lambda g: jf.bucket(jf.detect(g, fc), W, H, fc))
    for g in grays:
        want = run(jnp.asarray(g))
        got = pf.bucket(pf.detect(torch.tensor(g), pfc), W, H, pfc)
        assert int(got.valid.sum()) > 40
        for name in ("uv", "cls", "score", "valid"):
            np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                          getattr(got, name).numpy(), name)
        np.testing.assert_allclose(np.asarray(want.desc), got.desc.numpy(),
                                   rtol=0, atol=1e-6)


def test_response_maps_and_gradients_equal(images):
    """The shift-accumulate filters and Sobel derivatives: exact against
    the op-by-op JAX ops. (Jitted, XLA contracts the Sobel taps' multiply-
    adds into FMAs — up to 1.5e-5 apart; the blob and corner taps are
    powers of two, whose products are exact, so the responses and hence
    detection stay exact under jit too.)"""
    _, grays = images
    g = grays[0]
    kern = jf._filter_kernels()
    for k in kern:
        np.testing.assert_array_equal(
            np.asarray(jax.jit(lambda x, k=k: jf._conv2same(x, k))(
                jnp.asarray(g))),
            pf._conv2same(torch.tensor(g), k).numpy())
    du, dv = jf.sobel_gradients(jnp.asarray(g))
    pdu, pdv = pf.sobel_gradients(torch.tensor(g))
    np.testing.assert_array_equal(np.asarray(du), pdu.numpy())
    np.testing.assert_array_equal(np.asarray(dv), pdv.numpy())


def test_bucket_ranks_ties_like_lexsort():
    """Equal scores in one cell: jnp.lexsort keeps index order, and so do
    the port's two stable sorts; the per-cell cap cuts at the same rows."""
    rng = np.random.default_rng(0)
    n = 64
    uv = rng.uniform(50, 100, (n, 2)).astype(np.float32)
    uv[:20] = [10.0, 10.0]                         # alone in their cell
    score = rng.integers(0, 4, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    fc = pc.FrontendConfig()
    feats = [uv, np.zeros(n, np.int32), np.zeros((n, 32), np.float32),
             score, valid]
    want = jf.bucket(jf.Features(*map(jnp.asarray, feats)), 100, 100, fc)
    got = pf.bucket(convert.features_from_numpy(feats, device="cpu"),
                    100, 100, fc)
    np.testing.assert_array_equal(np.asarray(want.valid), got.valid.numpy())
    assert int(got.valid[:20].sum()) == fc.max_per_bucket
