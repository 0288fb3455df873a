"""Kernel 1's plain version (ops/sampling.py of the port) vs the JAX tile
sampler + its XLA gather fallback + the scatter back into the samples
(denseslam_tpu/ops/tsdf.py:361-374). The JAX kernel runs in interpret
mode. Tolerance: none — d_mm, gray, fits and the overflow count must be
equal, including when more blocks overflow than the fallback cap takes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.ops import sampling as jsm
from denseslam_tpu_torch.ops import sampling as psm


def _jax_post_fallback(combo, u, v, z, w, h, cap):
    """The JAX integrate's sampler composition, verbatim."""
    c, uj, vj, zj = map(jnp.asarray, (combo, u, v, z))
    d_mm, gray, fits, over = jsm.tile_sample(c, uj, vj, zj, w, h,
                                             interpret=True)
    sel, d_o, g_o, ok_o = jsm.gather_fallback(c, uj, vj, zj, w, h, over, cap)
    d_mm = d_mm.at[sel].set(jnp.where(ok_o, d_o, d_mm[sel]))
    gray = gray.at[sel].set(jnp.where(ok_o, g_o, gray[sel]))
    fits = fits.at[sel].set(fits[sel] | ok_o)
    return (np.asarray(d_mm), np.asarray(gray), np.asarray(fits),
            int(np.sum(np.asarray(over))))


def _image(rng, h, w):
    d = rng.integers(0, 60000, (h, w))
    d[rng.random((h, w)) < 0.05] = 0
    return ((d << 8) | rng.integers(0, 256, (h, w))).astype(np.int32)


def _blocks(rng, h, w, nblk, n_wide):
    """Clustered per-block footprints; the first `n_wide` blocks (then
    every third) are too wide or too tall for the (64, 256) tile, and a
    few voxels fall outside the image or behind the camera."""
    ou = rng.integers(-20, w - 30, (nblk, 1))
    ov = rng.integers(-10, h - 30, (nblk, 1))
    u = (ou + rng.uniform(0, 40, (nblk, 512))).astype(np.float32)
    v = (ov + rng.uniform(0, 40, (nblk, 512))).astype(np.float32)
    wide = [i for i in range(nblk) if i < n_wide or i % 3 == 0]
    for i in wide:
        if i % 2:
            u[i] = rng.uniform(-5, min(w, psm.TILE_W + 90), 512)
        else:
            v[i] = rng.uniform(-5, min(h, psm.TILE_H + 40), 512)
    # exact .5 ties exercise round-half-even
    u[1, :64] = np.floor(u[1, :64]) + 0.5
    z = rng.uniform(0.5, 5.0, (nblk, 512)).astype(np.float32)
    z[:, ::17] = 0.0
    z[2] = 1e-3                      # whole block gated out (z > 1e-3 fails)
    return u, v, z


@pytest.mark.parametrize("h,w,nblk,cap", [
    (96, 200, 16, 4),       # overflow count well above the cap
    (120, 300, 24, 512),    # every overflow block rescued
    (70, 130, 8, 0),        # no rescue at all
])
def test_tile_sample_equals_jax_post_fallback(h, w, nblk, cap):
    rng = np.random.default_rng(h + w)
    combo = _image(rng, h, w)
    u, v, z = _blocks(rng, h, w, nblk, n_wide=3)
    ref = _jax_post_fallback(combo, u, v, z, w, h, cap)
    got = psm.tile_sample(*(torch.tensor(a) for a in (combo, u, v, z)),
                          w, h, cap)
    assert ref[3] == int(got[3]) and ref[3] > 0
    for r, g in zip(ref[:3], got[:3]):
        np.testing.assert_array_equal(r, g.numpy())


def test_tile_sample_no_overflow_matches_direct_indexing():
    """The tests/test_sampling.py case: footprints inside the tile."""
    rng = np.random.default_rng(0)
    h, w, nblk = 96, 200, 16
    combo = _image(rng, h, w)
    ou = rng.integers(0, w - 40, (nblk, 1))
    ov = rng.integers(0, h - 40, (nblk, 1))
    u = (ou + rng.uniform(0, 39, (nblk, 512))).astype(np.float32)
    v = (ov + rng.uniform(0, 39, (nblk, 512))).astype(np.float32)
    z = np.ones((nblk, 512), np.float32)
    ref = _jax_post_fallback(combo, u, v, z, w, h, 4)
    d_mm, gray, ok, n_over = psm.tile_sample(
        *(torch.tensor(a) for a in (combo, u, v, z)), w, h, 4)
    assert ref[3] == 0 and int(n_over) == 0
    np.testing.assert_array_equal(ref[0], d_mm.numpy())
    np.testing.assert_array_equal(ref[1], gray.numpy())
    np.testing.assert_array_equal(ref[2], ok.numpy())
    px = combo[np.round(v).astype(int), np.round(u).astype(int)]
    np.testing.assert_array_equal(d_mm.numpy(), (px >> 8).astype(np.float32))
