"""Fusion image samplers: kernel 1 and kernel B2 (both in
csrc/tile_sample.cu) and their plain PyTorch versions.

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

Kernel B2 (`tile_sample_rgb`) replaces the true-RGB variant
(`_kernel_rgb`, launched by `_tile_sample_rgb_call`), which runs when
`gray_color_fusion=False`: the same tiling over two packed images,
`d_mm | r << 16` and `g | b << 8`, giving `d_mm << 8 | r` and `g << 8 | b`.
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


def _tiling_plain(u, v, z, width: int, height: int):
    """Per-voxel nearest pixel and bounds, per-block tile origin, in-tile
    flags and overflow, as `_tiling` of the JAX package computes them.
    Returns (ui, vi, inb, flags uint8 (V, 512), overflow bool (V,))."""
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
    flags = fits.to(torch.uint8) | (inb.to(torch.uint8) << 1)
    return ui, vi, inb, flags, overflow


def _pixel_index(ui, vi, width: int, height: int) -> torch.Tensor:
    return (vi.clamp(0, height - 1) * width + ui.clamp(0, width - 1)).long()


def sample_blocks_plain(combo, u, v, z, width: int, height: int):
    """Plain PyTorch version of kernel 1. combo: (H, W) int32 packed image;
    u, v, z: (V, 512) f32. Returns (sample int32 (V, 512) — the pixel where
    in bounds, else 0; flags uint8 (V, 512) — FLAG_IN_TILE | FLAG_IN_BOUNDS;
    overflow bool (V,))."""
    ui, vi, inb, flags, overflow = _tiling_plain(u, v, z, width, height)
    got = combo.reshape(-1)[_pixel_index(ui, vi, width, height)]
    return torch.where(inb, got, 0), flags, overflow


def sample_blocks_rgb_plain(img1, img2, u, v, z, width: int, height: int):
    """Plain PyTorch version of kernel B2. img1 = d_mm | r << 16 and
    img2 = g | b << 8, int32 (H, W). Returns (out1 = d_mm << 8 | r,
    out2 = g << 8 | b — int32 (V, 512), 0 where out of bounds; flags;
    overflow), tiled as kernel 1 tiles."""
    ui, vi, inb, flags, overflow = _tiling_plain(u, v, z, width, height)
    flat = _pixel_index(ui, vi, width, height)
    a = img1.reshape(-1)[flat]
    b = img2.reshape(-1)[flat]
    out1 = ((a & 0xFFFF) << 8) | ((a >> 16) & 0xFF)
    out2 = ((b & 0xFF) << 8) | ((b >> 8) & 0xFF)
    return torch.where(inb, out1, 0), torch.where(inb, out2, 0), flags, overflow


def _check_inputs(images, u, v, z, width: int, height: int) -> None:
    nblk = u.shape[0]
    for i, img in enumerate(images):
        kernels.check_tensor(img, f"image {i}", torch.int32, (height, width),
                             images[0].device)
    for name, t in (("u", u), ("v", v), ("z", z)):
        kernels.check_tensor(t, name, torch.float32, (nblk, BLOCK_VOL),
                             images[0].device)


def sample_blocks(combo, u, v, z, width: int, height: int):
    """Kernel 1. CPU tensors take `sample_blocks_plain`; CUDA tensors launch
    csrc/tile_sample.cu (or raise)."""
    if combo.device.type == "cpu":
        return sample_blocks_plain(combo, u, v, z, width, height)
    _check_inputs((combo,), u, v, z, width, height)
    nblk = u.shape[0]
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


def sample_blocks_rgb(img1, img2, u, v, z, width: int, height: int):
    """Kernel B2. CPU tensors take `sample_blocks_rgb_plain`; CUDA tensors
    launch the `tile_sample_rgb` entry of csrc/tile_sample.cu (or raise)."""
    if img1.device.type == "cpu":
        return sample_blocks_rgb_plain(img1, img2, u, v, z, width, height)
    _check_inputs((img1, img2), u, v, z, width, height)
    nblk = u.shape[0]
    hp, wp = padded_extent(height, width)
    dev = img1.device
    out1 = torch.empty((nblk, BLOCK_VOL), dtype=torch.int32, device=dev)
    out2 = torch.empty((nblk, BLOCK_VOL), dtype=torch.int32, device=dev)
    flags = torch.empty((nblk, BLOCK_VOL), dtype=torch.uint8, device=dev)
    overflow = torch.empty((nblk,), dtype=torch.bool, device=dev)
    if nblk:
        kernels.launch(
            "tile_sample_rgb", dev,
            img1, img2, height, width, hp, wp, u, v, z, nblk,
            out1, out2, flags, overflow)
    return out1, out2, flags, overflow


def _cap_ok(flags, overflow, cap: int):
    """The JAX fallback's cap rule (`gather_fallback` + tsdf.py:364-374):
    the first `cap` overflow blocks in block order keep every in-bounds
    voxel; the rest keep only their in-tile voxels. Returns (ok (V, 512),
    n_overflow int32 ())."""
    rank = torch.cumsum(overflow.to(torch.int32), dim=0) - 1
    rescued = overflow & (rank < cap)
    in_tile = (flags & FLAG_IN_TILE) != 0
    in_bounds = (flags & FLAG_IN_BOUNDS) != 0
    ok = in_tile | (in_bounds & rescued[:, None])
    return ok, overflow.to(torch.int32).sum().to(torch.int32)


def apply_overflow_cap(sample, flags, overflow, cap: int):
    """Kernel 1's samples under the cap rule (`_cap_ok`).

    Returns (d_mm f32, gray f32, ok bool, n_overflow int32 ())."""
    ok, n_over = _cap_ok(flags, overflow, cap)
    got = torch.where(ok, sample, 0)
    return (got >> 8).to(torch.float32), (got & 0xFF).to(torch.float32), \
        ok, n_over


def apply_overflow_cap_rgb(out1, out2, flags, overflow, cap: int,
                           color_packed, u, v, width: int, height: int):
    """Kernel B2's samples under the cap rule (`_cap_ok`). As in the JAX
    integrate (tsdf.py:375-386), the rescued blocks take their colour from
    one compacted gather of the UNGATED packed colour image (r | g << 8 |
    b << 16), also where the depth is 0.

    Returns (d_mm, r, g, b f32 (V, 512), ok bool, n_overflow int32 ())."""
    ok, n_over = _cap_ok(flags, overflow, cap)
    o1 = torch.where(ok, out1, 0)
    o2 = torch.where(ok, out2, 0)
    d_mm = (o1 >> 8).to(torch.float32)
    r = (o1 & 0xFF).to(torch.float32)
    g = (o2 >> 8).to(torch.float32)
    b = (o2 & 0xFF).to(torch.float32)
    ncap = min(cap, overflow.shape[0])
    if ncap:
        # the first `cap` rows with the overflow blocks first: the rescued
        # ones are exactly those of them that overflow
        sel = torch.argsort((~overflow).to(torch.int32), stable=True)[:ncap]
        ok_o = ((flags[sel] & FLAG_IN_BOUNDS) != 0) & overflow[sel][:, None]
        cp = color_packed.reshape(-1)[_pixel_index(
            round_i32(u[sel]), round_i32(v[sel]), width, height)]
        for plane, shift in ((r, 0), (g, 8), (b, 16)):
            got = ((cp >> shift) & 0xFF).to(torch.float32)
            plane[sel] = torch.where(ok_o, got, plane[sel])
    return d_mm, r, g, b, ok, n_over


def tile_sample(combo, u, v, z, width: int, height: int, cap: int):
    """Nearest-pixel packed sample per voxel with the JAX tile sampler's
    post-fallback semantics: equals JAX `tile_sample` followed by
    `gather_fallback(..., cap)` and its scatter back, bit for bit.

    Returns (d_mm f32 (V, 512), gray f32 (V, 512), ok bool (V, 512),
    n_overflow int32 ())."""
    sample, flags, overflow = sample_blocks(combo, u, v, z, width, height)
    return apply_overflow_cap(sample, flags, overflow, cap)


def tile_sample_rgb(img1, img2, color_packed, u, v, z, width: int,
                    height: int, cap: int):
    """The true-RGB sample per voxel with the JAX tile sampler's
    post-fallback semantics: equals JAX `tile_sample_rgb` followed by
    `gather_fallback(..., cap)`, the fallback colour gather and their
    scatter back (tsdf.py:342-386), bit for bit.

    img1 = d_mm | r << 16, img2 = g | b << 8 (0 where depth is 0);
    color_packed = r | g << 8 | b << 16, ungated. Returns (d_mm, r, g, b
    f32 (V, 512), ok bool (V, 512), n_overflow int32 ())."""
    out1, out2, flags, overflow = sample_blocks_rgb(img1, img2, u, v, z,
                                                    width, height)
    return apply_overflow_cap_rgb(out1, out2, flags, overflow, cap,
                                  color_packed, u, v, width, height)
