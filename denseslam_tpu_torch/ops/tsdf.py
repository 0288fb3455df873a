"""Voxel-hashed TSDF volume: allocate / integrate / de-integrate / decay /
sliding window (port of denseslam_tpu/ops/tsdf.py).

A block is 8x8x8 voxels stored flat as 512 lanes of a slot-indexed pool;
block identity is a packed int32 key (ops/hash.py). All per-voxel math is
structure-of-arrays, in the JAX version's op order, so that keys, samples
and updates agree with the reference.

The JAX package donates the map to each step and gets a new one back.
Here every function that changes the map updates its tensors IN PLACE and
returns the map (with new 0-d counters); use the returned map, and clone a
map first where the old state is still needed.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import TsdfConfig
from ..device import resolve_device
from .. import kernels
from ..utils import image, lie, numerics
from ..utils.numerics import fma, true_div
from ..utils.camera import Intrinsics
from . import hash as vhash
from . import sampling

BLOCK = 8
BLOCK_VOL = BLOCK * BLOCK * BLOCK  # 512


def _voxel_off_xyz(device):
    """Three (512,) int32 tensors: voxel offsets within a block, x fastest."""
    idx = torch.arange(BLOCK_VOL, dtype=torch.int32, device=device)
    return idx % BLOCK, (idx // BLOCK) % BLOCK, idx // (BLOCK * BLOCK)


# -- packed RGB helpers ------------------------------------------------------

def pack_rgb(r, g, b) -> torch.Tensor:
    """Float [0,255] channels -> packed int32 (r | g<<8 | b<<16)."""
    ri = torch.clamp(r, 0, 255).to(torch.int32)
    gi = torch.clamp(g, 0, 255).to(torch.int32)
    bi = torch.clamp(b, 0, 255).to(torch.int32)
    return ri | (gi << 8) | (bi << 16)


def unpack_rgb(p: torch.Tensor):
    return (
        (p & 0xFF).to(torch.float32),
        ((p >> 8) & 0xFF).to(torch.float32),
        ((p >> 16) & 0xFF).to(torch.float32),
    )


def pack_gray(gray: torch.Tensor) -> torch.Tensor:
    return pack_rgb(gray, gray, gray)


class MapState(NamedTuple):
    """One submap's TSDF volume (the same fields, in the same order, as the
    JAX MapState; scalars are 0-d int32 tensors on the map's device)."""
    table: vhash.HashTable          # packed-key table (S,)
    tsdf: torch.Tensor              # f32|bf16 (S, 512), init +1
    weight: torch.Tensor            # f32|bf16 (S, 512)
    color: torch.Tensor             # i32 (S, 512) packed RGB
    alloc_frame: torch.Tensor       # i32 (S,)
    last_seen: torch.Tensor         # i32 (S,)
    frame: torch.Tensor             # i32 ()
    decayed_blocks: torch.Tensor    # i32 ()
    overflow: torch.Tensor          # i32 ()

    @property
    def num_slots(self) -> int:
        return self.tsdf.shape[0]


_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def storage_dtype(cfg: TsdfConfig) -> torch.dtype:
    return _STORAGE[cfg.storage_dtype]


def make_map(cfg: TsdfConfig, device=None) -> MapState:
    """Fresh map on `device` (None = the CUDA card; raises without one)."""
    dev = resolve_device(device)
    s = cfg.table_slots
    sd = storage_dtype(cfg)

    def scalar():
        return torch.zeros((), dtype=torch.int32, device=dev)

    return MapState(
        table=vhash.make_table(s, dev),
        tsdf=torch.ones((s, BLOCK_VOL), dtype=sd, device=dev),
        weight=torch.zeros((s, BLOCK_VOL), dtype=sd, device=dev),
        color=torch.zeros((s, BLOCK_VOL), dtype=torch.int32, device=dev),
        alloc_frame=torch.zeros((s,), dtype=torch.int32, device=dev),
        last_seen=torch.zeros((s,), dtype=torch.int32, device=dev),
        frame=scalar(),
        decayed_blocks=scalar(),
        overflow=scalar(),
    )


def num_allocated_blocks(m: MapState) -> torch.Tensor:
    return m.table.valid.to(torch.int32).sum()


def used_memory_bytes(m: MapState, voxel_bytes: int = 16) -> torch.Tensor:
    """ITMVoxel-equivalent accounting (InfiniTamDriver.h:333-352): the
    allocated blocks times a block's voxels times `voxel_bytes`."""
    return num_allocated_blocks(m) * (voxel_bytes * BLOCK_VOL)


def reset(m: MapState, cfg: TsdfConfig) -> MapState:
    """ITMDenseMapper::ResetScene equivalent: a fresh map on m's device."""
    return make_map(cfg, m.tsdf.device)


def _check_supported(cfg: TsdfConfig) -> None:
    if cfg.sampler not in ("gather", "pallas"):
        raise ValueError(f"unknown sampler {cfg.sampler!r}")


# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------

def touched_block_keys(depth: torch.Tensor, T_wc: torch.Tensor,
                       intr: Intrinsics, cfg: TsdfConfig,
                       row0: Optional[int] = None) -> torch.Tensor:
    """Packed keys of blocks in the truncation band of each depth sample —
    (k*H*W/s^2,) int32, EMPTY_KEY where invalid.

    row0: when given, `depth` is an already subsampled row slab whose first
    row is subsampled row `row0` of the image (the sharded map's exchange
    allocation divides key generation across ranks by slabs)."""
    s = cfg.alloc_subsample
    if row0 is None:
        if s > 1:
            depth = depth[::s, ::s]
        row0 = 0
    h, w = depth.shape
    dev = depth.device
    mu = cfg.trunc_dist_m
    block_m = cfg.block_size_m
    inv_block = 1.0 / block_m
    v = (torch.arange(h, dtype=torch.float32, device=dev)[:, None]
         + float(row0)) * float(s)
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :] * float(s)
    dirx = true_div(u - intr.cx, intr.fx).expand(h, w)
    diry = true_div(v - intr.cy, intr.fy).expand(h, w)
    valid = (depth > cfg.min_depth_m) & (depth < cfg.max_depth_m)

    k = max(3, math.ceil(2.0 * mu / block_m) + 2)
    R = T_wc[:3, :3]
    t = T_wc[:3, 3]

    keys = []
    for i in range(k):
        d = depth + (-mu + 2.0 * mu * i / (k - 1))
        pcx = dirx * d
        pcy = diry * d
        pcz = d
        wx = R[0, 0] * pcx + R[0, 1] * pcy + R[0, 2] * pcz + t[0]
        wy = R[1, 0] * pcx + R[1, 1] * pcy + R[1, 2] * pcz + t[1]
        wz = R[2, 0] * pcx + R[2, 1] * pcy + R[2, 2] * pcz + t[2]
        bx = _floor_i32(wx * inv_block)
        by = _floor_i32(wy * inv_block)
        bz = _floor_i32(wz * inv_block)
        keys.append(vhash.pack_xyz(bx, by, bz, valid).reshape(-1))
    return torch.cat(keys, dim=0)


def _floor_i32(x: torch.Tensor) -> torch.Tensor:
    """floor -> int32; far-out values (invalid pixels only) are clamped so
    the conversion stays defined — they pack to EMPTY_KEY either way."""
    return torch.floor(x).clamp_(-(2 ** 30), 2 ** 30).to(torch.int32)


def allocate_for_frame(m: MapState, depth: torch.Tensor, T_wc: torch.Tensor,
                       intr: Intrinsics, cfg: TsdfConfig, key_filter=None):
    """Allocate blocks touched by this frame; returns (map, visible_slots
    (max_visible_blocks,), visible_mask). `key_filter` (keys -> keys), when
    given, maps the blocks this table must not own to EMPTY_KEY: the
    sharded map's ownership seam (parallel/sharded_map.py)."""
    keys = touched_block_keys(depth, T_wc, intr, cfg)
    if key_filter is not None:
        keys = key_filter(keys)
    uniq, umask, total = vhash.unique_keys(keys, cfg.max_visible_blocks)
    return allocate_keys(m, uniq, umask, total, cfg)


def allocate_keys(m: MapState, uniq: torch.Tensor, umask: torch.Tensor,
                  total: torch.Tensor, cfg: TsdfConfig):
    """Insert pre-deduplicated keys; clears freshly claimed rows and stamps
    alloc_frame / last_seen. Updates the map in place."""
    table, slots, fresh = vhash.insert_keys(m.table, uniq, umask,
                                            cfg.probe_len)
    live = umask & (slots >= 0)
    n = slots.shape[0]
    ones = torch.ones((n, BLOCK_VOL), dtype=m.tsdf.dtype, device=slots.device)
    vhash.masked_set_(m.tsdf, slots, ones, fresh)
    vhash.masked_set_(m.weight, slots, torch.zeros_like(ones), fresh)
    vhash.masked_set_(m.color, slots,
                      torch.zeros((n, BLOCK_VOL), dtype=torch.int32,
                                  device=slots.device), fresh)
    frame_b = m.frame.expand(n)
    vhash.masked_set_(m.alloc_frame, slots, frame_b, fresh)
    vhash.masked_set_(m.last_seen, slots, frame_b, live)

    dropped = torch.clamp(total - cfg.max_visible_blocks, min=0)
    failed = (umask & (slots < 0)).to(torch.int32).sum()
    m = m._replace(table=table,
                   overflow=(m.overflow + dropped + failed).to(torch.int32))
    return m, torch.where(live, slots, torch.full_like(slots, -1)), live


# ---------------------------------------------------------------------------
# Integrate / de-integrate
# ---------------------------------------------------------------------------

def _f32(x: float) -> float:
    """x rounded to float32: the constant jitted JAX computes with."""
    return float(torch.tensor(x, dtype=torch.float32))


def fusion_geometry_plain(bkeys: torch.Tensor, R: torch.Tensor,
                          t: torch.Tensor, vsz: float, intr: Intrinsics):
    """Kernel PJ's plain version: (u, v, z) of every voxel of the blocks
    `bkeys` (V,) seen from the camera (R, t) = T_cw, each (V, 512), in the
    order jitted XLA:CPU computes the JAX version (`process_sequence`'s
    scan, read from `tests/_torch_golden.py --dump`): its simplifier
    folds the voxel size into the rotation, a_ij = R_ij vsz (rounded),
    over the exact voxel centres h = (8 b + o) + 0.5; the rows are then
    px = fma(hz, a02, fma(hx, a00, hy a01)) + t0 (the first product of
    the sum contracted, as LLVM does with two single-use products), and
    u = fma(px / zc, fx, cx), zc = pz where |pz| > 1e-9 else 1e-9. Every
    FMA through `numerics.fma`."""
    dev = bkeys.device
    bx, by, bz = vhash.unpack_xyz(bkeys)
    ox, oy, oz = _voxel_off_xyz(dev)
    h = [((b[:, None] * BLOCK + o[None, :]).to(torch.float32) + 0.5)
         for b, o in ((bx, ox), (by, oy), (bz, oz))]
    a = R * numerics.constant((_f32(vsz),), torch.float32, dev)[0]
    hx, hz = h[0].double(), h[2].double()   # converted once for the rows
    p = [fma(hz, a[i, 2], fma(hx, a[i, 0], h[1] * a[i, 1])) + t[i]
         for i in range(3)]
    pz = p[2]
    zc = torch.where(pz.abs() > 1e-9, pz, torch.full_like(pz, 1e-9))
    f32 = (torch.float32, dev)
    k = numerics.constant((_f32(intr.fx), _f32(intr.cx), _f32(intr.fy),
                           _f32(intr.cy)), *f32)
    u = fma(p[0] / zc, k[0], k[1])
    v = fma(p[1] / zc, k[2], k[3])
    return u, v, pz


def fusion_geometry(bkeys: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                    vsz: float, intr: Intrinsics):
    """(u, v, z), each (V, 512), of the blocks `bkeys` (V,) int32 under
    (R (3, 3), t (3,)) = T_cw, in jitted XLA:CPU's order
    (`fusion_geometry_plain`): kernel PJ (csrc/fusion_geometry.cu) for
    CUDA tensors, one launch; the plain version for CPU ones."""
    if bkeys.device.type == "cpu":
        # a row is a function of its key alone, and the rows past the
        # visible set all repeat one key: each distinct key once
        uniq, inv = torch.unique(bkeys, return_inverse=True)
        return tuple(x[inv] for x in fusion_geometry_plain(uniq, R, t, vsz,
                                                            intr))
    n = bkeys.shape[0]
    dev = bkeys.device
    kernels.check_tensor(bkeys, "bkeys", torch.int32, (n,))
    kernels.check_tensor(R, "R", torch.float32, (3, 3), dev)
    kernels.check_tensor(t, "t", torch.float32, (3,), dev)
    u, v, z = torch.empty((3, n, BLOCK_VOL), dtype=torch.float32,
                          device=dev).unbind(0)
    if n:
        kernels.launch("fusion_geometry", dev, bkeys, R, t, u, v, z, n,
                       _f32(vsz), _f32(intr.fx), _f32(intr.fy),
                       _f32(intr.cx), _f32(intr.cy))
    return u, v, z


def _fusion_geometry(m: MapState, visible_slots, visible_mask, T_wc,
                     intr: Intrinsics, cfg: TsdfConfig):
    """Camera-frame voxel positions for the visible set, SoA: returns
    (u, v, z) each (V, 512) and the safe slot index per row."""
    T_cw = lie.inv_T(T_wc)
    safe = torch.where(visible_mask, visible_slots,
                       torch.zeros_like(visible_slots))
    bkeys = m.table.keys[safe.long()]
    u, v, z = fusion_geometry(bkeys.contiguous(), T_cw[:3, :3].contiguous(),
                              T_cw[:3, 3].contiguous(), cfg.voxel_size_m,
                              intr)
    return u, v, z, safe


def _depth_mm(depth: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(depth * 1000.0), 0, 65535).to(torch.int32)


def _quantized_combo(depth: torch.Tensor, color_packed) -> torch.Tensor:
    """The packed (d_mm << 8 | gray) image both samplers read; 0 where the
    depth is invalid."""
    d_mm = _depth_mm(depth)
    if color_packed is not None:
        g8 = torch.clamp(color_packed & 0xFF, 0, 255)
    else:
        g8 = torch.zeros_like(d_mm)
    return torch.where(depth > 0, (d_mm << 8) | g8, torch.zeros_like(d_mm))


def rgb_images(depth: torch.Tensor, color_packed: torch.Tensor):
    """The two packed images kernel B2 reads: (d_mm | r << 16, g | b << 8),
    0 where the depth is invalid."""
    d_mm = _depth_mm(depth)
    r8, g8, b8 = (c.to(torch.int32) for c in unpack_rgb(color_packed))
    zero = torch.zeros_like(d_mm)
    return (torch.where(depth > 0, d_mm | (r8 << 16), zero),
            torch.where(depth > 0, g8 | (b8 << 8), zero))


def _bilinear_soA(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear sample of (H, W) img at SoA coords: (value, in bounds, the
    (v0, u0) corner, the corners' min and max)."""
    h, w = img.shape
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    # clamped in float first, so that the cast is defined far outside
    u0i = image._to_i32(u0, -1, w)
    v0i = image._to_i32(v0, -1, h)
    inb = (u0i >= 0) & (u0i < w - 1) & (v0i >= 0) & (v0i < h - 1)
    flat = img.reshape(-1)
    base = (torch.clamp(v0i, 0, h - 2) * w
            + torch.clamp(u0i, 0, w - 2)).long()
    p00 = flat[base]
    p01 = flat[base + 1]
    p10 = flat[base + w]
    p11 = flat[base + w + 1]
    # the sum of the four weighted corners as jitted XLA:CPU contracts it:
    # each "+ a * b" an FMA over the rounded first factor, the first two
    # terms fma(p00 (1 - du), 1 - dv, p01 du (1 - dv))
    val = fma(p00 * (1 - du), 1 - dv, p01 * du * (1 - dv))
    val = fma(p10 * (1 - du), dv, val)
    val = fma(p11 * du, dv, val)
    cmin = torch.minimum(torch.minimum(p00, p01), torch.minimum(p10, p11))
    cmax = torch.maximum(torch.maximum(p00, p01), torch.maximum(p10, p11))
    return val, inb, p00, cmin, cmax


def _depth_sample_soA(depth: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                      max_gap_m: float):
    """Edge-aware bilinear depth sample: the bilinear value where the four
    corners are valid and within max_gap_m of each other, else the (v0, u0)
    corner. Returns (depth, valid), 0 where invalid."""
    val, inb, nn, cmin, cmax = _bilinear_soA(depth, u, v)
    smooth = (cmin > 0) & ((cmax - cmin) < max_gap_m)
    out = torch.where(smooth, val, nn)
    ok = inb & (out > 0)
    return torch.where(ok, out, torch.zeros_like(out)), ok


def _sample(u, v, z, visible_mask, depth, color_packed, intr, cfg, m):
    """Per-voxel depth (m) and colour samples -> (d_samp, d_valid, colour,
    map). The colour is the luminance (V, 512), an (r, g, b) triple in
    true-RGB mode (`gray_color_fusion=False`) or with `bilinear_fusion`, or
    None without an image."""
    rgb_mode = color_packed is not None and not cfg.gray_color_fusion
    if cfg.bilinear_fusion:
        # edge-aware bilinear depth, with either sampler (the tile sampler
        # reads nearest pixels only, so it is bypassed); nearest-pixel
        # colour from the packed image
        d_samp, d_valid = _depth_sample_soA(depth, u, v,
                                            max_gap_m=cfg.trunc_dist_m)
        colour = None
        if color_packed is not None:
            flat = (sampling.round_i32(v).clamp(0, intr.height - 1)
                    * intr.width
                    + sampling.round_i32(u).clamp(0, intr.width - 1)).long()
            colour = unpack_rgb(color_packed.reshape(-1)[flat])
        return d_samp, d_valid, colour, m
    if cfg.sampler == "pallas":
        # kernel 1 (or B2 in true-RGB mode) with the JAX tile sampler's
        # post-fallback semantics; overflow blocks beyond the fallback cap
        # lose their out-of-tile samples and are counted like dropped
        # allocations
        z_gated = torch.where(visible_mask[:, None], z, torch.zeros_like(z))
        if rgb_mode:
            img1, img2 = rgb_images(depth, color_packed)
            d_mm, cr, cg, cb, fits, n_over = sampling.tile_sample_rgb(
                img1, img2, color_packed, u, v, z_gated, intr.width,
                intr.height, cfg.pallas_overflow_cap)
            colour = (cr, cg, cb)
        else:
            combo = _quantized_combo(depth, color_packed)
            d_mm, gray, fits, n_over = sampling.tile_sample(
                combo, u, v, z_gated, intr.width, intr.height,
                cfg.pallas_overflow_cap)
            colour = gray if color_packed is not None else None
        m = m._replace(overflow=(m.overflow + torch.clamp(
            n_over - cfg.pallas_overflow_cap, min=0)).to(torch.int32))
        d_samp = d_mm * 1e-3
        d_valid = fits & (d_samp > 0)
        d_samp = torch.where(d_valid, d_samp, torch.zeros_like(d_samp))
        return d_samp, d_valid, colour, m

    # "gather": nearest sample, one gather per voxel (ITM's choice)
    ui = sampling.round_i32(u)
    vi = sampling.round_i32(v)
    inb = (ui >= 0) & (ui < intr.width) & (vi >= 0) & (vi < intr.height)
    flat = (vi.clamp(0, intr.height - 1) * intr.width
            + ui.clamp(0, intr.width - 1)).long()
    colour = None
    if color_packed is not None and not rgb_mode:
        # depth (mm) and luminance packed into one gather
        got = _quantized_combo(depth, color_packed).reshape(-1)[flat]
        d_samp = (got >> 8).to(torch.float32) * 1e-3
        colour = (got & 0xFF).to(torch.float32)
    else:
        d_samp = depth.reshape(-1)[flat]
        if rgb_mode:
            # raw depth, colour by a separate gather of the packed image
            colour = unpack_rgb(color_packed.reshape(-1)[flat])
    d_valid = inb & (d_samp > 0)
    d_samp = torch.where(d_valid, d_samp, torch.zeros_like(d_samp))
    return d_samp, d_valid, colour, m


def integrate(m: MapState, visible_slots, visible_mask, depth,
              color_packed: Optional[torch.Tensor], T_wc,
              intr: Intrinsics, cfg: TsdfConfig, sign: float = 1.0) -> MapState:
    """TSDF fusion over the visible block set, in place. sign=+1
    integrates, -1 de-integrates (the exact inverse when replayed with the
    identical view and pose)."""
    _check_supported(cfg)
    mu = cfg.trunc_dist_m
    u, v, z, safe = _fusion_geometry(m, visible_slots, visible_mask, T_wc,
                                     intr, cfg)
    d_samp, d_valid, colour, m = _sample(
        u, v, z, visible_mask, depth, color_packed, intr, cfg, m)

    sdf = d_samp - z
    upd = (visible_mask[:, None] & d_valid & (z > 1e-3)
           & (sdf > -mu) & (d_samp > cfg.min_depth_m))
    # jitted XLA:CPU turns a division by a constant into a multiply by its
    # float32 reciprocal (`numerics.recip`)
    eta = torch.clamp(sdf * numerics.recip(mu), -1.0, 1.0)

    zero = torch.zeros_like(sdf)
    if cfg.weights.depth_weighting:
        wp = cfg.weights
        dist = torch.clamp(d_samp * numerics.recip(wp.max_distance), 0.0,
                           1.0)
        w_new = torch.clamp(wp.max_new_w * (1.0 - dist), min=1.0)
    else:
        w_new = torch.ones_like(sdf)
    w_new = torch.where(upd, w_new, zero)

    safe_l = safe.long()
    old_t = m.tsdf[safe_l].to(torch.float32)
    old_w = m.weight[safe_l].to(torch.float32)

    # the running averages' numerators as jitted XLA:CPU contracts them:
    # old * old_w + sample * w is fma(old, old_w, sample * w) (of two
    # products LLVM folds the first, or the one of fewer uses: the colour
    # channels share one sample product); `numerics.fma` on every device
    if sign > 0:
        new_w = torch.clamp(old_w + w_new, max=cfg.max_weight)
        num = fma(old_t, old_w, eta * w_new)
        new_t = torch.where(new_w > 0, num / torch.clamp(new_w, min=1e-6),
                            torch.ones_like(num))
    else:
        new_w = torch.clamp(old_w - w_new, min=0.0)
        num = fma(old_t, old_w, -(eta * w_new))
        new_t = torch.where(new_w > 1e-6, num / torch.clamp(new_w, min=1e-6),
                            torch.ones_like(num))

    vhash.masked_set_(m.tsdf, visible_slots, new_t.to(m.tsdf.dtype),
                      visible_mask)
    vhash.masked_set_(m.weight, visible_slots, new_w.to(m.weight.dtype),
                      visible_mask)

    if color_packed is not None and sign > 0:
        # nearest-pixel colour, weight-led running average per channel
        cr, cg, cb = colour if isinstance(colour, tuple) else (colour,) * 3
        c_upd = upd & (sdf.abs() < 0.5 * mu)
        cw = torch.where(c_upd, w_new, zero)
        orr, og, ob = unpack_rgb(m.color[safe_l])
        tot = torch.clamp(old_w + cw, min=1e-6)
        old_c = torch.stack([orr, og, ob])
        new_c = torch.stack([cr, cg, cb]) * cw
        nr, ng, nb = (fma(old_c, old_w, new_c) / tot).unbind(0)
        vhash.masked_set_(m.color, visible_slots, pack_rgb(nr, ng, nb),
                          visible_mask)
    return m


def deintegrate(m, visible_slots, visible_mask, depth, color_packed, T_wc,
                intr, cfg):
    return integrate(m, visible_slots, visible_mask, depth, color_packed,
                     T_wc, intr, cfg, sign=-1.0)


# ---------------------------------------------------------------------------
# Map regularisation: decay & sliding window
# ---------------------------------------------------------------------------

def decay(m: MapState, max_decay_weight: float, min_decay_age: int,
          force_all: bool = False,
          only_mask: Optional[torch.Tensor] = None) -> MapState:
    """Voxel GC: zero voxels with weight <= max_decay_weight in blocks older
    than min_decay_age; reclaim blocks left empty. In place."""
    age = m.frame - m.alloc_frame
    eligible = m.table.valid
    if not force_all:
        eligible = eligible & (age >= min_decay_age)
    if only_mask is not None:
        eligible = eligible & only_mask
    kill = eligible[:, None] & (m.weight <= max_decay_weight) & (m.weight > 0)
    m.weight.masked_fill_(kill, 0.0)
    empty = eligible & (m.weight <= 0.0).all(dim=-1)
    return _free_blocks(m, empty, kill, empty.to(torch.int32).sum())


def decay_catchup(m: MapState, max_decay_weight: float) -> MapState:
    """Run decay once ignoring age — sequence-end catch-up. In place."""
    return decay(m, max_decay_weight, 0, force_all=True)


def slide_window(m: MapState, max_age: int,
                 by_last_seen: bool = False) -> MapState:
    """Evict blocks whose age exceeds the window. In place."""
    ref_frame = m.last_seen if by_last_seen else m.alloc_frame
    old = m.table.valid & ((m.frame - ref_frame) > max_age)
    return _free_blocks(m, old)


def decay_and_slide(m: MapState, max_decay_weight: float, min_decay_age: int,
                    max_age: int) -> MapState:
    """slide_window() then decay() in one pool pass (the fuse_keyframe tail
    order); decayed_blocks counts only blocks decay frees after the slide
    already evicted its set. In place."""
    age = m.frame - m.alloc_frame
    eligible = m.table.valid & (age >= min_decay_age)
    kill = eligible[:, None] & (m.weight <= max_decay_weight) & (m.weight > 0)
    m.weight.masked_fill_(kill, 0.0)
    empty = eligible & (m.weight <= 0.0).all(dim=-1)
    old = m.table.valid & (age > max_age)
    return _free_blocks(m, empty | old, kill,
                        (empty & ~old).to(torch.int32).sum())


def decay_defusion_part(m: MapState) -> MapState:
    """Reclaim the blocks of a correction replay's working set (blocks
    touched this frame, last_seen == frame) that de-integration left
    empty; surviving weights are never zeroed. In place."""
    touched = m.last_seen == m.frame
    return decay(m, 0.0, 0, force_all=True, only_mask=touched)


def slide_window_defusion_part(m: MapState, max_age: int,
                               occupancy_floor: float = 0.02) -> MapState:
    """Evict the stale near-empty blocks of a correction replay's working
    set: blocks touched this frame, older than max_age, with fewer than
    `occupancy_floor` of their voxels weighted (the residue a de-fuse at
    the old pose leaves where the re-fuse did not cover). In place."""
    occ = (m.weight > 0).to(torch.float32).mean(dim=-1)
    touched = (m.last_seen == m.frame) & (occ < occupancy_floor)
    old = m.table.valid & touched & ((m.frame - m.alloc_frame) > max_age)
    return _free_blocks(m, old)


def _free_blocks(m: MapState, drop: torch.Tensor, kill=None,
                 decayed=None) -> MapState:
    """Free the blocks in `drop` (S,) and reset their rows (plus the voxels
    in `kill`, if given) to free space, in place; count `decayed`."""
    gone = drop[:, None]
    m.tsdf.masked_fill_(gone if kill is None else (gone | kill), 1.0)
    m.weight.masked_fill_(gone, 0.0)
    m.color.masked_fill_(gone, 0)
    m.table.keys.masked_fill_(drop, vhash.EMPTY_KEY)
    if decayed is not None:
        m = m._replace(
            decayed_blocks=(m.decayed_blocks + decayed).to(torch.int32))
    return m


def advance_frame(m: MapState) -> MapState:
    return m._replace(frame=(m.frame + 1).to(torch.int32))



# ---------------------------------------------------------------------------
# Block-row transfer (the swap path's compact form of a map)
# ---------------------------------------------------------------------------

def gather_block_rows(m: MapState, slots: torch.Tensor):
    """The rows of the slot indices `slots` (Npad,) of every per-slot
    plane: keys, tsdf, weight, color, alloc_frame, last_seen. The form in
    which a submap crosses the host boundary: the pool is mostly empty
    slots at street scale, so only allocated rows travel."""
    s = slots.long()
    return (m.table.keys[s], m.tsdf[s], m.weight[s], m.color[s],
            m.alloc_frame[s], m.last_seen[s])


def rebuild_from_rows(inv_perm: torch.Tensor, keys_r, tsdf_r, weight_r,
                      color_r, af_r, ls_r, frame, decayed_blocks,
                      overflow) -> MapState:
    """Inverse of `gather_block_rows`: the full pool from compact rows
    (Npad,) through one gather per plane. `inv_perm` (S,) maps each slot
    to its row; the value Npad selects a sentinel empty row appended to
    the rows, so unallocated slots read free space and no scatter runs.
    On the device of `inv_perm`."""
    dev = inv_perm.device
    inv = inv_perm.long()

    def plane(rows, fill, dtype):
        rows = rows.to(dev)
        pad = torch.full((1,) + tuple(rows.shape[1:]), fill, dtype=dtype,
                         device=dev)
        return torch.cat([rows, pad])[inv]

    def scalar(x):
        return torch.as_tensor(x, dtype=torch.int32).to(
            dev, copy=True).reshape(())

    return MapState(
        table=vhash.HashTable(keys=plane(keys_r, vhash.EMPTY_KEY,
                                         torch.int32)),
        tsdf=plane(tsdf_r, 1, tsdf_r.dtype),
        weight=plane(weight_r, 0, weight_r.dtype),
        color=plane(color_r, 0, torch.int32),
        alloc_frame=plane(af_r, 0, torch.int32),
        last_seen=plane(ls_r, 0, torch.int32),
        frame=scalar(frame),
        decayed_blocks=scalar(decayed_blocks),
        overflow=scalar(overflow),
    )

# ---------------------------------------------------------------------------
# Voxel sampling (the renderers' and refinement's point lookups) — SoA
# ---------------------------------------------------------------------------

def _voxel_lookup(m: MapState, px, py, pz, cfg: TsdfConfig):
    """The voxel holding each SoA world point (any common shape): its flat
    index into the (S * 512) pool and whether its block is allocated, both
    flat."""
    inv_v = 1.0 / cfg.voxel_size_m
    vx = _floor_i32(px * inv_v)
    vy = _floor_i32(py * inv_v)
    vz = _floor_i32(pz * inv_v)
    bx, by, bz = vx >> 3, vy >> 3, vz >> 3
    keys = vhash.pack_xyz(bx, by, bz)
    slots = vhash.lookup_keys(m.table, keys.reshape(-1), cfg.probe_len)
    lidx = ((vx - (bx << 3)) + (vy - (by << 3)) * BLOCK
            + (vz - (bz << 3)) * (BLOCK * BLOCK)).reshape(-1)
    found = slots >= 0
    flat = torch.where(found, slots, torch.zeros_like(slots)) * BLOCK_VOL + lidx
    return flat.long(), found


def sample_tsdf_xyz(m: MapState, px, py, pz, cfg: TsdfConfig):
    """Nearest-voxel TSDF sample at SoA world coords (any common shape).
    Returns (sdf, weight); sdf = +1, w = 0 where unallocated."""
    flat, found = _voxel_lookup(m, px, py, pz, cfg)
    sdf = m.tsdf.reshape(-1)[flat].to(torch.float32)
    wgt = m.weight.reshape(-1)[flat].to(torch.float32)
    sdf = torch.where(found, sdf, torch.ones_like(sdf)).reshape(px.shape)
    wgt = torch.where(found, wgt, torch.zeros_like(wgt)).reshape(px.shape)
    return sdf, wgt


def sample_tsdf_nearest(m: MapState, pts_w: torch.Tensor, cfg: TsdfConfig):
    """(..., 3) form of `sample_tsdf_xyz`."""
    return sample_tsdf_xyz(m, pts_w[..., 0], pts_w[..., 1], pts_w[..., 2], cfg)


def sample_color_xyz(m: MapState, px, py, pz, cfg: TsdfConfig):
    """Nearest-voxel packed colour sample; returns (r, g, b) floats, 0
    where unallocated."""
    flat, found = _voxel_lookup(m, px, py, pz, cfg)
    packed = m.color.reshape(-1)[flat]
    packed = torch.where(found, packed, torch.zeros_like(packed))
    return unpack_rgb(packed.reshape(px.shape))


def sample_tsdf_trilinear_xyz(m: MapState, px, py, pz, cfg: TsdfConfig):
    """Trilinear TSDF sample from the 8 nearest voxel centres; returns
    (sdf, the least of their weights)."""
    vsz = cfg.voxel_size_m
    gx = true_div(px, vsz) - 0.5
    gy = true_div(py, vsz) - 0.5
    gz = true_div(pz, vsz) - 0.5
    g0x, g0y, g0z = torch.floor(gx), torch.floor(gy), torch.floor(gz)
    fx, fy, fz = gx - g0x, gy - g0y, gz - g0z
    acc, wmin = 0.0, None
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                s, w = sample_tsdf_xyz(m, (g0x + dx + 0.5) * vsz,
                                       (g0y + dy + 0.5) * vsz,
                                       (g0z + dz + 0.5) * vsz, cfg)
                wt = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                      * (fz if dz else 1 - fz))
                acc = acc + s * wt
                wmin = w if wmin is None else torch.minimum(wmin, w)
    return acc, wmin


def sample_tsdf_trilinear(m: MapState, pts_w: torch.Tensor, cfg: TsdfConfig):
    """(..., 3) form of `sample_tsdf_trilinear_xyz`."""
    return sample_tsdf_trilinear_xyz(m, pts_w[..., 0], pts_w[..., 1],
                                     pts_w[..., 2], cfg)
