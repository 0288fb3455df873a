"""Fusion image sampler: kernel 1 (csrc/tile_sample.cu) and its plain
PyTorch version.

Replaces the Pallas tile sampler of the JAX package
(denseslam_tpu/ops/sampling.py `_kernel`, launched by `_tile_sample_call`)
together with its XLA `gather_fallback`. For every visible 8^3 block and
each of its 512 voxels, the nearest pixel (round half to even) of the
packed image `(d_mm << 8) | gray` is sampled. The JAX kernel DMAs one
aligned (64, 256) image tile per block; a block whose footprint does not
fit its tile is flagged `overflow`, and only the first
`pallas_overflow_cap` such blocks (in block order) get their out-of-tile
voxels from the fallback gather. `tile_sample` reproduces that composition
exactly, cap included.

On the card a voxel reads its pixel straight from the image (1.8 MB at
KITTI size, resident in L2), so no tile is staged; the kernel still
computes each block's tile origin and overflow flag the way `_tiling`
does, because the overflow semantics depend on them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels

BLOCK_VOL = 512
TILE_H = 64
TILE_W = 256
ALIGN_V = 8
ALIGN_U = 128

FLAG_IN_TILE = 1     # in bounds and inside the block's aligned tile
FLAG_IN_BOUNDS = 2   # inside the image with z > 1e-3


def padded_extent(height: int, width: int) -> Tuple[int, int]:
    """The JAX kernel's padded image extent (`_pad_image`): tile origins are
    clipped against it, so the overflow test depends on it."""
    hp = max(-(-height // ALIGN_V) * ALIGN_V, TILE_H)
    wp = max(-(-width // ALIGN_U) * ALIGN_U, TILE_W)
    return hp, wp


def round_i32(x: torch.Tensor) -> torch.Tensor:
    """Round half to even (`jnp.round`) and convert to int32. Values beyond
    +-2^30 only occur far outside the image and are clamped so the
    conversion stays defined."""
    return torch.round(x).clamp_(-(2 ** 30), 2 ** 30).to(torch.int32)


def sample_blocks_plain(combo, u, v, z, width: int, height: int):
    """Plain PyTorch version of kernel 1. combo: (H, W) int32 packed image;
    u, v, z: (V, 512) f32. Returns (sample int32 (V, 512) — the pixel where
    in bounds, else 0; flags uint8 (V, 512) — FLAG_IN_TILE | FLAG_IN_BOUNDS;
    overflow bool (V,))."""
    hp, wp = padded_extent(height, width)
    ui = round_i32(u)
    vi = round_i32(v)
    inb = (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height) & (z > 1e-3)
    big = 1 << 28
    u_min = torch.where(inb, ui, big).amin(dim=1)
    v_min = torch.where(inb, vi, big).amin(dim=1)
    u_max = torch.where(inb, ui, -big).amax(dim=1)
    v_max = torch.where(inb, vi, -big).amax(dim=1)
    any_in = u_min <= u_max
    u0 = torch.clamp(torch.where(any_in, u_min, 0) & ~(ALIGN_U - 1),
                     0, wp - TILE_W)
    v0 = torch.clamp(torch.where(any_in, v_min, 0) & ~(ALIGN_V - 1),
                     0, hp - TILE_H)
    overflow = any_in & (((u_max - u0) >= TILE_W) | ((v_max - v0) >= TILE_H))
    tu = ui - u0[:, None]
    tv = vi - v0[:, None]
    fits = inb & (tu >= 0) & (tu < TILE_W) & (tv >= 0) & (tv < TILE_H)
    uc = ui.clamp(0, width - 1)
    vc = vi.clamp(0, height - 1)
    got = combo.reshape(-1)[(vc * width + uc).long()]
    sample = torch.where(inb, got, 0)
    flags = fits.to(torch.uint8) | (inb.to(torch.uint8) << 1)
    return sample, flags, overflow


def sample_blocks(combo, u, v, z, width: int, height: int):
    """Kernel 1. CPU tensors take `sample_blocks_plain`; CUDA tensors launch
    csrc/tile_sample.cu (or raise)."""
    if combo.device.type == "cpu":
        return sample_blocks_plain(combo, u, v, z, width, height)
    nblk = u.shape[0]
    kernels.check_tensor(combo, "combo", torch.int32, (height, width))
    for name, t in (("u", u), ("v", v), ("z", z)):
        kernels.check_tensor(t, name, torch.float32, (nblk, BLOCK_VOL),
                             combo.device)
    hp, wp = padded_extent(height, width)
    sample = torch.empty((nblk, BLOCK_VOL), dtype=torch.int32,
                         device=combo.device)
    flags = torch.empty((nblk, BLOCK_VOL), dtype=torch.uint8,
                        device=combo.device)
    overflow = torch.empty((nblk,), dtype=torch.bool, device=combo.device)
    if nblk:
        kernels.launch(
            "tile_sample", combo.device,
            combo, height, width, hp, wp, u, v, z, nblk,
            sample, flags, overflow)
    return sample, flags, overflow


def apply_overflow_cap(sample, flags, overflow, cap: int):
    """The JAX fallback's cap rule (`gather_fallback` + tsdf.py:364-374):
    the first `cap` overflow blocks in block order keep every in-bounds
    voxel; the rest keep only their in-tile voxels.

    Returns (d_mm f32, gray f32, ok bool, n_overflow int32 ())."""
    rank = torch.cumsum(overflow.to(torch.int32), dim=0) - 1
    rescued = overflow & (rank < cap)
    in_tile = (flags & FLAG_IN_TILE) != 0
    in_bounds = (flags & FLAG_IN_BOUNDS) != 0
    ok = in_tile | (in_bounds & rescued[:, None])
    zero = torch.zeros_like(sample)
    d_mm = torch.where(ok, sample >> 8, zero).to(torch.float32)
    gray = torch.where(ok, sample & 0xFF, zero).to(torch.float32)
    n_over = overflow.to(torch.int32).sum().to(torch.int32)
    return d_mm, gray, ok, n_over


def tile_sample(combo, u, v, z, width: int, height: int, cap: int):
    """Nearest-pixel packed sample per voxel with the JAX tile sampler's
    post-fallback semantics: equals JAX `tile_sample` followed by
    `gather_fallback(..., cap)` and its scatter back, bit for bit.

    Returns (d_mm f32 (V, 512), gray f32 (V, 512), ok bool (V, 512),
    n_overflow int32 ())."""
    sample, flags, overflow = sample_blocks(combo, u, v, z, width, height)
    return apply_overflow_cap(sample, flags, overflow, cap)
