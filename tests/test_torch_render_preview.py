"""The port's previews and 16-bit depth PNGs (ops/raycast.py
`render_preview`, `depth_to_png16`, `png16_to_depth`) against the JAX
package, on the map of tests/test_torch_render.py (split from that file;
its scene fixture, the port's fusion of 3 frames at 160x120, is made once
more here): equal, the gray shading within 1 level (a 3-term dot)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.ops import raycast as jrc
from denseslam_tpu_torch.ops import raycast as prc
from test_torch_render import one_torch_thread, scene  # noqa: F401


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

