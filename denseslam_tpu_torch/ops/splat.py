"""Forward surface-splat renderer (port of denseslam_tpu/ops/splat.py):
the default renderer of `DenseSLAM.raycast_view` and of the ICP model.

Instead of marching every ray through the voxel pool, it walks the
frustum-visible allocated blocks densely, projects their near-surface
voxels forward into the image and resolves occlusion with one scatter-min
z-buffer. Every sort carries one int32 whose low bits are the payload
(slot id, voxel id), and the z-buffer key packs quantised depth over the
compact voxel index, so the per-pixel minimum elects the nearest voxel
with ties to the lowest index: the min over int32 keys does not depend on
the order of the scatter, and the keys equal the JAX version's.

No function here reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import TsdfConfig
from ..utils.camera import Intrinsics
from ..utils.numerics import sqrt, true_div
from . import hash as vhash
from . import raycast as rc_ops
from . import tsdf as tsdf_ops

_I32_MAX = 2 ** 31 - 1


class SplatConfig(NamedTuple):
    """Static caps of the splat pipeline (the JAX SplatConfig's fields and
    defaults; config.SplatParams holds the pipeline's values)."""
    max_blocks: int = 2048        # frustum-visible block cap
    max_voxels: int = 1 << 19     # near-surface voxel cap
    surface_eta: float = 0.8      # |tsdf| threshold for "near surface"
    z_bits: int = 12              # z-buffer depth quantisation bits
    fill_levels: int = 3          # pull-push hole-fill pyramid depth
    # a hit deeper than the min-pooled neighbourhood depth `up` by more
    # than up * bleed_rel + bleed_abs is background bleeding between a
    # near surface's splats, and takes the neighbourhood's depth; both 0
    # disable the override
    bleed_rel: float = 0.0
    bleed_abs: float = 0.0


def _fill_holes(depth: torch.Tensor, levels: int, bleed_rel: float = 0.0,
                bleed_abs: float = 0.0) -> torch.Tensor:
    """Pull-push hole fill: misses (0) take the min-pooled depth of the
    coarser levels; with bleed_rel / bleed_abs > 0, hits far behind that
    depth are overridden too."""
    if levels <= 0:
        return depth
    inf = torch.full((), float("inf"), device=depth.device)
    pyr = [depth]
    d = depth
    for _ in range(levels):
        h2, w2 = d.shape[0] // 2, d.shape[1] // 2
        d4 = d[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2)
        big = torch.where(d4 > 0, d4, inf)
        dmin = big.amin(dim=3).amin(dim=1)
        d = torch.where(torch.isfinite(dmin), dmin, torch.zeros_like(dmin))
        pyr.append(d)
    suppress = bleed_rel > 0.0 or bleed_abs > 0.0
    for lv in range(levels - 1, -1, -1):
        tgt = pyr[lv]
        up = pyr[lv + 1].repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
        # odd sizes: repeat the last row / column (edge padding)
        if tgt.shape[0] > up.shape[0]:
            up = torch.cat([up, up[-1:].expand(tgt.shape[0] - up.shape[0], -1)])
        if tgt.shape[1] > up.shape[1]:
            up = torch.cat([up, up[:, -1:].expand(-1, tgt.shape[1]
                                                  - up.shape[1])], dim=1)
        keep = tgt > 0
        if suppress:
            keep = keep & ~((up > 0)
                            & (tgt > up * (1.0 + bleed_rel) + bleed_abs))
        pyr[lv] = torch.where(keep, tgt, up)
    return pyr[0]


def _bits(n: int) -> int:
    return max(1, int(n - 1).bit_length())


def splat_render(m: tsdf_ops.MapState, T_wc: torch.Tensor, intr: Intrinsics,
                 cfg: TsdfConfig, sc: SplatConfig = SplatConfig()
                 ) -> rc_ops.Raycast:
    """Render depth, points, normals and colour of map `m` from camera
    pose T_wc by forward splatting; the same contract as
    `raycast.raycast` (depth 0 = miss; image-space normals)."""
    zbuf, zsurf, col = splat_zbuffer(m, T_wc, intr, cfg, sc)
    h, w = intr.height, intr.width
    n_pix = h * w
    cvox_bits = _bits(zsurf.shape[0])

    # winner recovery: gathers by the elected voxel index
    win = zbuf[:n_pix]
    won = win != _I32_MAX
    wv = torch.where(won, win & ((1 << cvox_bits) - 1), 0).long()
    dflat = torch.where(won, zsurf[wv], 0.0)
    cflat = torch.where(won, col[wv], 0)

    depth = _fill_holes(dflat.reshape(h, w), sc.fill_levels, sc.bleed_rel,
                        sc.bleed_abs)
    hit = depth > 0
    pts = depth_points(depth, hit, T_wc, intr)
    nx, ny, nz, _ = rc_ops._normals_soA(*pts, hit)
    zero = torch.zeros_like(depth)
    color = [torch.where(hit, c, zero)
             for c in tsdf_ops.unpack_rgb(cflat.reshape(h, w))]
    return rc_ops.Raycast(depth=depth, points=torch.stack(pts, dim=-1),
                          normals=torch.stack([nx, ny, nz], dim=-1),
                          mask=hit, color=torch.stack(color, dim=-1))


def splat_zbuffer(m: tsdf_ops.MapState, T_wc: torch.Tensor, intr: Intrinsics,
                  cfg: TsdfConfig, sc: SplatConfig = SplatConfig()):
    """The z-buffer of `splat_render`: (keys (H*W + 1,) int32, with
    _I32_MAX where no voxel landed and a dummy last slot; each compact
    voxel's surface depth zsurf; its packed colour)."""
    h, w = intr.height, intr.width
    n_pix = h * w
    vsz = cfg.voxel_size_m
    block_m = cfg.block_size_m
    s = m.num_slots
    dev = T_wc.device
    # a general 4x4 inverse, as JAX's; `inv_ex` skips the singularity
    # check, which would read a flag back to the host
    T_cw = torch.linalg.inv_ex(T_wc).inverse
    Rcw = T_cw[:3, :3]
    tcw = T_cw[:3, 3]

    # ---- 1. frustum-visible allocated blocks ------------------------------
    bx, by, bz = vhash.unpack_xyz(m.table.keys)
    cxw = (bx.to(torch.float32) + 0.5) * block_m
    cyw = (by.to(torch.float32) + 0.5) * block_m
    czw = (bz.to(torch.float32) + 0.5) * block_m
    pcx = Rcw[0, 0] * cxw + Rcw[0, 1] * cyw + Rcw[0, 2] * czw + tcw[0]
    pcy = Rcw[1, 0] * cxw + Rcw[1, 1] * cyw + Rcw[1, 2] * czw + tcw[1]
    pcz = Rcw[2, 0] * cxw + Rcw[2, 1] * cyw + Rcw[2, 2] * czw + tcw[2]
    marg = 0.87 * block_m  # half block diagonal
    zok = (pcz > cfg.min_depth_m - marg) & (pcz < cfg.max_depth_m + marg)
    zs = torch.clamp(pcz, min=1e-3)
    uc = pcx / zs * intr.fx + intr.cx
    vc = pcy / zs * intr.fy + intr.cy
    pad = true_div(marg, zs) * intr.fx
    inim = (uc > -pad) & (uc < w - 1 + pad) & (vc > -pad) & (vc < h - 1 + pad)
    bmask = m.table.valid & zok & inim

    # ---- 2. block compaction: identity-in-key sort ------------------------
    slot_bits = _bits(s)
    iota = torch.arange(s, dtype=torch.int32, device=dev)
    bkey = torch.where(bmask, iota, torch.full_like(iota, 1 << slot_bits))
    rows = torch.sort(bkey).values[: sc.max_blocks]
    rmask = rows < (1 << slot_bits)
    rows = torch.where(rmask, rows, torch.zeros_like(rows)).long()

    # ---- 3. row reads of the compact visible set --------------------------
    ct = m.tsdf[rows].to(torch.float32)              # (V, 512)
    cw_ = m.weight[rows].to(torch.float32)
    cc = m.color[rows]
    ckeys = torch.where(rmask, m.table.keys[rows],
                        torch.full_like(rows, vhash.EMPTY_KEY,
                                        dtype=torch.int32))

    # ---- 4. near-surface voxel compaction ---------------------------------
    near = rmask[:, None] & (cw_ > 0) & (ct.abs() < sc.surface_eta)
    nv = sc.max_blocks * tsdf_ops.BLOCK_VOL
    vox_bits = _bits(nv)
    vid = torch.arange(near.numel(), dtype=torch.int32,
                       device=dev).reshape(near.shape)
    vkey = torch.where(near, vid, torch.full_like(vid, 1 << vox_bits))
    cvox = torch.sort(vkey.reshape(-1)).values[: sc.max_voxels]
    vmask = cvox < (1 << vox_bits)
    cvox = torch.where(vmask, cvox, torch.zeros_like(cvox))
    vrow = (cvox >> 9).long()                         # block row in the set
    voff = cvox & 511
    cvox = cvox.long()

    sdf = ct.reshape(-1)[cvox]
    col = cc.reshape(-1)[cvox]
    gx, gy, gz = vhash.unpack_xyz(ckeys[vrow])
    ox, oy, oz = voff & 7, (voff >> 3) & 7, voff >> 6
    B = tsdf_ops.BLOCK
    wx = ((gx * B + ox).to(torch.float32) + 0.5) * vsz
    wy = ((gy * B + oy).to(torch.float32) + 0.5) * vsz
    wz = ((gz * B + oz).to(torch.float32) + 0.5) * vsz

    # ---- 5. project + z-buffer scatter-min --------------------------------
    px = Rcw[0, 0] * wx + Rcw[0, 1] * wy + Rcw[0, 2] * wz + tcw[0]
    py = Rcw[1, 0] * wx + Rcw[1, 1] * wy + Rcw[1, 2] * wz + tcw[1]
    pz = Rcw[2, 0] * wx + Rcw[2, 1] * wy + Rcw[2, 2] * wz + tcw[2]
    # surface point: the voxel centre pushed along the viewing ray by
    # sdf * mu; the z-test keeps the nearest estimate
    zray = sqrt(px * px + py * py + pz * pz)
    corr = sdf * cfg.trunc_dist_m * (pz / torch.clamp(zray, min=1e-6))
    zsurf = pz + corr
    zc = torch.clamp(pz, min=1e-6)
    uf = torch.round(px / zc * intr.fx + intr.cx)
    vf = torch.round(py / zc * intr.fy + intr.cy)
    # bounds tested in float: a float out of int32's range (or NaN) casts
    # to different integers on the card and on the CPU, and in range the
    # test equals JAX's on the cast values
    ok = (vmask & (zsurf > cfg.min_depth_m) & (zsurf < cfg.max_depth_m)
          & (uf >= 0) & (uf < w) & (vf >= 0) & (vf < h))
    ui = torch.where(ok, uf, torch.zeros_like(uf)).to(torch.int32)
    vi = torch.where(ok, vf, torch.zeros_like(vf)).to(torch.int32)
    pix = torch.where(ok, vi * w + ui, torch.full_like(ui, n_pix))

    n_vox = zsurf.shape[0]
    cvox_bits = _bits(n_vox)
    z_bits = min(sc.z_bits, 31 - cvox_bits)
    if z_bits < 8:
        raise ValueError(
            f"max_voxels {n_vox} leaves z_bits={z_bits} < 8 in the packed "
            "int32 z-buffer key; lower max_voxels")
    zscale = (1 << z_bits) / cfg.max_depth_m
    # truncation toward zero, then the clip, as the JAX cast; max - 2 keeps
    # every valid key below the miss sentinel. Masked voxels' keys are
    # replaced below, so only their cast must stay defined.
    zq = torch.where(ok, zsurf * zscale, torch.zeros_like(zsurf))
    zq = torch.clamp(zq.to(torch.int32), 0, (1 << z_bits) - 2)
    vidx = torch.arange(n_vox, dtype=torch.int32, device=dev)
    key = torch.where(ok, (zq << cvox_bits) | vidx,
                      torch.full_like(vidx, _I32_MAX))
    zbuf = torch.full((n_pix + 1,), _I32_MAX, dtype=torch.int32, device=dev)
    zbuf.scatter_reduce_(0, pix.long(), key, "amin", include_self=True)
    return zbuf, zsurf, col


def depth_points(depth: torch.Tensor, mask: torch.Tensor, T_wc: torch.Tensor,
                 intr: Intrinsics):
    """World points (px, py, pz) of a depth image seen from T_wc, 0 where
    `mask` is False."""
    h, w = depth.shape
    vv, uu = rc_ops.pixel_grid(h, w, depth.device)
    cx_ = true_div(uu - intr.cx, intr.fx) * depth
    cy_ = true_div(vv - intr.cy, intr.fy) * depth
    R = T_wc[:3, :3]
    t = T_wc[:3, 3]
    px = R[0, 0] * cx_ + R[0, 1] * cy_ + R[0, 2] * depth + t[0]
    py = R[1, 0] * cx_ + R[1, 1] * cy_ + R[1, 2] * depth + t[1]
    pz = R[2, 0] * cx_ + R[2, 1] * cy_ + R[2, 2] * depth + t[2]
    z0 = torch.zeros_like(px)
    return (torch.where(mask, px, z0), torch.where(mask, py, z0),
            torch.where(mask, pz, z0))


def refine_depth(m: tsdf_ops.MapState, depth: torch.Tensor,
                 mask: torch.Tensor, T_wc: torch.Tensor, intr: Intrinsics,
                 cfg: TsdfConfig, steps: int = 2,
                 prune_sdf: float = 0.0) -> torch.Tensor:
    """Sub-voxel refinement of a splat depth (H, W) with hit mask:
    `steps` sphere-tracing corrections d += sdf * mu from trilinear TSDF
    samples. prune_sdf > 0 also drops the pixels whose refined point
    samples unobserved space or |tsdf| > prune_sdf (what the hole fill
    fabricated in disocclusions)."""
    h, w = depth.shape
    mu = cfg.trunc_dist_m
    vv, uu = rc_ops.pixel_grid(h, w, depth.device)
    dirx_c = true_div(uu - intr.cx, intr.fx)
    diry_c = true_div(vv - intr.cy, intr.fy)
    R = T_wc[:3, :3]
    t = T_wc[:3, 3]
    d = depth
    sdf = torch.zeros_like(depth)
    wmin = torch.zeros_like(depth)
    for _ in range(steps):
        cx = dirx_c * d
        cy = diry_c * d
        px = R[0, 0] * cx + R[0, 1] * cy + R[0, 2] * d + t[0]
        py = R[1, 0] * cx + R[1, 1] * cy + R[1, 2] * d + t[1]
        pz = R[2, 0] * cx + R[2, 1] * cy + R[2, 2] * d + t[2]
        sdf, wmin = tsdf_ops.sample_tsdf_trilinear_xyz(m, px, py, pz, cfg)
        ok = mask & (wmin > 0) & (sdf.abs() < 1.0)
        d = torch.where(ok, torch.clamp(d + sdf * mu, min=cfg.min_depth_m), d)
    if prune_sdf > 0:
        mask = mask & (wmin > 0) & (sdf.abs() < prune_sdf)
    return torch.where(mask, d, torch.zeros_like(d))
