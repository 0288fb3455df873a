"""The port's image ops (utils/image.py) against the JAX package (split
from tests/test_torch_render.py, whose map these do not use):
`bilateral_filter_depth` within 1e-6 m (XLA's and torch's float32 `exp`
differ by ulps); the other ops equal, except `downsample2`'s 4-term means
and the colour `bilinear_sample` (rtol 1e-6: their order of
summation)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.utils import image as jim
from denseslam_tpu_torch.utils import image as pim
from test_torch_render import one_torch_thread  # noqa: F401


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

