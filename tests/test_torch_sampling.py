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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread each spares the other test processes of a parallel run
    the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _jax_rgb_post_fallback(d_mm_img, rgb, u, v, z, w, h, cap):
    """The JAX integrate's true-RGB sampler composition, verbatim
    (denseslam_tpu/ops/tsdf.py:342-386): kernel B2, the depth fallback
    from the gray-less combo image, and the fallback colour gather from
    the ungated packed colour image."""
    r8, g8, b8 = (jnp.asarray(c) for c in rgb)
    d = jnp.asarray(d_mm_img)
    color_packed = r8 | (g8 << 8) | (b8 << 16)
    img1 = jnp.where(d > 0, d | (r8 << 16), 0)
    img2 = jnp.where(d > 0, g8 | (b8 << 8), 0)
    uj, vj, zj = map(jnp.asarray, (u, v, z))
    d_mm, cr, cg, cb, fits, over = jsm.tile_sample_rgb(
        img1, img2, uj, vj, zj, w, h, interpret=True)
    combo_fb = jnp.where(d > 0, d << 8, 0)
    sel, d_o, _, ok_o = jsm.gather_fallback(combo_fb, uj, vj, zj, w, h,
                                            over, cap)
    d_mm = d_mm.at[sel].set(jnp.where(ok_o, d_o, d_mm[sel]))
    fits = fits.at[sel].set(fits[sel] | ok_o)
    ui = jnp.clip(jnp.round(uj[sel]).astype(jnp.int32), 0, w - 1)
    vi = jnp.clip(jnp.round(vj[sel]).astype(jnp.int32), 0, h - 1)
    cp = color_packed.reshape(-1)[vi * w + ui]
    out = [d_mm]
    for plane, shift in ((cr, 0), (cg, 8), (cb, 16)):
        got = ((cp >> shift) & 0xFF).astype(jnp.float32)
        out.append(plane.at[sel].set(jnp.where(ok_o, got, plane[sel])))
    return ([np.asarray(a) for a in out] + [np.asarray(fits)],
            int(np.sum(np.asarray(over))), (img1, img2, color_packed))


@pytest.mark.parametrize("h,w,nblk,cap", [
    (96, 200, 16, 4),       # overflow count well above the cap
    (120, 300, 24, 512),    # every overflow block rescued
    (70, 130, 8, 0),        # no rescue at all
])
def test_tile_sample_rgb_equals_jax_post_fallback(h, w, nblk, cap):
    """Kernel B2's plain version and the cap rule: d_mm, r, g, b, ok and
    the overflow count equal JAX's post-fallback samples everywhere — the
    rescued blocks' colour too where the depth is 0 (those voxels never
    update the map, but the samples are reproduced as they are)."""
    rng = np.random.default_rng(h * w)
    d_mm = rng.integers(0, 60000, (h, w)).astype(np.int32)
    d_mm[rng.random((h, w)) < 0.05] = 0
    rgb = [rng.integers(0, 256, (h, w)).astype(np.int32) for _ in range(3)]
    u, v, z = _blocks(rng, h, w, nblk, n_wide=3)
    ref, n_over, images = _jax_rgb_post_fallback(d_mm, rgb, u, v, z, w, h,
                                                 cap)
    img1, img2, cp = (torch.tensor(np.asarray(a)) for a in images)
    got = psm.tile_sample_rgb(img1, img2, cp, *map(torch.tensor, (u, v, z)),
                              w, h, cap)
    assert n_over == int(got[5]) and n_over > 0
    for name, r, g in zip(("d_mm", "r", "g", "b", "ok"), ref, got[:5]):
        np.testing.assert_array_equal(r, g.numpy(), name)
    # the tiling is kernel 1's: the same flags and overflow
    a = psm.sample_blocks_rgb(img1, img2, *map(torch.tensor, (u, v, z)), w, h)
    b = psm.sample_blocks(img1, *map(torch.tensor, (u, v, z)), w, h)
    assert torch.equal(a[2], b[1]) and torch.equal(a[3], b[2])


def test_rgb_kernel_wrapper_raises_off_the_cpu_and_never_falls_back():
    """Kernel B2's wrapper: a tensor off the CPU goes to the kernel or
    raises (a meta tensor here, with no card), and nothing is counted."""
    from denseslam_tpu_torch import kernels
    before = dict(kernels.launch_counts)
    img = torch.empty((8, 16), dtype=torch.int32, device="meta")
    uvz = [torch.empty((2, 512), device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="CUDA"):
        psm.sample_blocks_rgb(img, img, *uvz, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        psm.tile_sample_rgb(img, img, img, *uvz, 16, 8, 4)
    assert kernels.launch_counts == before
    assert kernels.KERNELS["tile_sample_rgb"][0] == \
        kernels.KERNELS["tile_sample"][0]          # one source, one build
