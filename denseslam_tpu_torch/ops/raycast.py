"""TSDF raycasting (port of denseslam_tpu/ops/raycast.py): a bounded-step
sphere trace with every ray of the image in flight, the image-space
normals both renderers share, and the preview and 16-bit PNG depth
conversions.

The JAX version's `lax.scan` over `raycast_steps` is a Python loop of the
same step here: all H*W rays advance together, a ray that is done keeps
its state, a hash miss jumps most of a block and near the surface the
step follows the sampled SDF. No function here reads a value back to the
host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import TsdfConfig
from ..utils.camera import Intrinsics
from ..utils.numerics import sqrt, true_div
from . import tsdf as tsdf_ops


class Raycast(NamedTuple):
    depth: torch.Tensor    # (H, W) m in the raycast camera, 0 = miss
    points: torch.Tensor   # (H, W, 3) world-frame surface points
    normals: torch.Tensor  # (H, W, 3) world-frame normals (0 where miss)
    mask: torch.Tensor     # (H, W) hit mask
    color: torch.Tensor    # (H, W, 3) volume colour at the hit


def pixel_grid(h: int, w: int, device):
    """(v, u) pixel coordinates, each an (H, W) float32 tensor."""
    v = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    u = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return v.expand(h, w), u.expand(h, w)


def raycast(m: tsdf_ops.MapState, T_wc: torch.Tensor, intr: Intrinsics,
            cfg: TsdfConfig) -> Raycast:
    """Render depth, points, normals and colour of map `m` from camera
    pose T_wc: `raycast_steps` steps of the sphere trace, then one
    trilinear secant refinement of each hit."""
    h, w = intr.height, intr.width
    mu = cfg.trunc_dist_m
    block_m = cfg.block_size_m
    dev = T_wc.device

    vv, uu = pixel_grid(h, w, dev)
    dcx = true_div(uu.reshape(-1) - intr.cx, intr.fx)
    dcy = true_div(vv.reshape(-1) - intr.cy, intr.fy)
    R = T_wc[:3, :3]
    t = T_wc[:3, 3]
    dx = R[0, 0] * dcx + R[0, 1] * dcy + R[0, 2]
    dy = R[1, 0] * dcx + R[1, 1] * dcy + R[1, 2]
    dz = R[2, 0] * dcx + R[2, 1] * dcy + R[2, 2]
    norm = sqrt(dx * dx + dy * dy + dz * dz)
    inv_n = true_div(1.0, torch.clamp(norm, min=1e-9))
    ux, uy, uz = dx * inv_n, dy * inv_n, dz * inv_n

    n = h * w
    t_cur = torch.full((n,), cfg.min_depth_m, dtype=torch.float32, device=dev)
    t_max = cfg.max_depth_m * norm
    prev_sdf = torch.ones((n,), dtype=torch.float32, device=dev)
    prev_alloc = torch.zeros((n,), dtype=torch.bool, device=dev)
    prev_t = t_cur
    hit_t = torch.zeros((n,), dtype=torch.float32, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    half_voxel = torch.full((), cfg.voxel_size_m * 0.5, device=dev)
    jump = torch.full((), block_m * 0.8, device=dev)
    for _ in range(cfg.raycast_steps):
        px = t[0] + ux * t_cur
        py = t[1] + uy * t_cur
        pz = t[2] + uz * t_cur
        sdf, wgt = tsdf_ops.sample_tsdf_xyz(m, px, py, pz, cfg)
        allocated = wgt > 0.0
        # a crossing needs both samples observed: entering a negative
        # region straight from unallocated space is a back-side phantom
        crossed = (allocated & prev_alloc & (prev_sdf > 0.0) & (sdf <= 0.0)
                   & ~done)
        denom = prev_sdf - sdf
        frac = torch.where(denom.abs() > 1e-6,
                           prev_sdf / torch.clamp(denom, min=1e-6),
                           torch.full_like(denom, 0.5))
        t_surf = prev_t + (t_cur - prev_t) * frac
        hit_t = torch.where(crossed, t_surf, hit_t)
        done = done | crossed | (t_cur > t_max)
        adv = torch.where(allocated, torch.maximum(sdf * mu, half_voxel),
                          jump)
        prev_sdf = torch.where(allocated, sdf, torch.ones_like(sdf))
        prev_alloc = allocated | done
        prev_t = torch.where(done, prev_t, t_cur)
        t_cur = torch.where(done, t_cur, t_cur + adv)

    hit = hit_t > 0.0
    px = t[0] + ux * hit_t
    py = t[1] + uy * hit_t
    pz = t[2] + uz * hit_t

    # one trilinear secant refinement: x' = x - sdf(x) * mu * dir
    sdf_tri, _ = tsdf_ops.sample_tsdf_trilinear_xyz(m, px, py, pz, cfg)
    zero = torch.zeros_like(sdf_tri)
    corr = torch.where(hit, sdf_tri * mu, zero)
    px = px - ux * corr
    py = py - uy * corr
    pz = pz - uz * corr

    # depth in the raycast camera: the z-row of T_cw applied to the point
    depth = R[0, 2] * (px - t[0]) + R[1, 2] * (py - t[1]) + R[2, 2] * (pz - t[2])
    depth = torch.where(hit, depth, zero).reshape(h, w)
    hit2 = depth > 0

    pxi = torch.where(hit, px, zero).reshape(h, w)
    pyi = torch.where(hit, py, zero).reshape(h, w)
    pzi = torch.where(hit, pz, zero).reshape(h, w)
    nx, ny, nz, _ = _normals_soA(pxi, pyi, pzi, hit2)

    cr, cg, cb = tsdf_ops.sample_color_xyz(m, px, py, pz, cfg)
    color = [torch.where(hit, c, zero).reshape(h, w) for c in (cr, cg, cb)]
    return Raycast(depth=depth,
                   points=torch.stack([pxi, pyi, pzi], dim=-1),
                   normals=torch.stack([nx, ny, nz], dim=-1),
                   mask=hit2, color=torch.stack(color, dim=-1))


def _normals_soA(px, py, pz, mask):
    """Image-space normals from cross products of the central differences
    of the point planes; 0 where a 4-neighbour misses."""
    def ddx(a):
        d = torch.roll(a, -1, dims=1) - torch.roll(a, 1, dims=1)
        d[:, 0] = 0.0
        d[:, -1] = 0.0
        return d

    def ddy(a):
        d = torch.roll(a, -1, dims=0) - torch.roll(a, 1, dims=0)
        d[0, :] = 0.0
        d[-1, :] = 0.0
        return d

    ax, ay, az = ddy(px), ddy(py), ddy(pz)
    bx, by, bz = ddx(px), ddx(py), ddx(pz)
    nx = ay * bz - az * by
    ny = az * bx - ax * bz
    nz = ax * by - ay * bx
    nn = sqrt(nx * nx + ny * ny + nz * nz)
    inv = true_div(1.0, torch.clamp(nn, min=1e-9))
    ok = (mask
          & torch.roll(mask, -1, dims=1) & torch.roll(mask, 1, dims=1)
          & torch.roll(mask, -1, dims=0) & torch.roll(mask, 1, dims=0)
          & (nn > 1e-9))
    z = torch.zeros_like(nx)
    return (torch.where(ok, nx * inv, z), torch.where(ok, ny * inv, z),
            torch.where(ok, nz * inv, z), ok)


# ---------------------------------------------------------------------------
# Previews and saved depth
# ---------------------------------------------------------------------------

PREVIEW_DEPTH = "depth"
PREVIEW_GRAY = "gray"
PREVIEW_COLOR = "color"
PREVIEW_NORMAL = "normal"
PREVIEW_RAYCAST_DEPTH = "raycast_depth"


def render_preview(rc: Raycast, kind: str,
                   view_dir_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A displayable image of a render: float depth, or uint8 normals,
    colour or Lambert-shaded gray."""
    if kind in (PREVIEW_RAYCAST_DEPTH, PREVIEW_DEPTH):
        return rc.depth
    zero = torch.zeros((), dtype=torch.float32, device=rc.depth.device)
    if kind == PREVIEW_NORMAL:
        img = (rc.normals * 0.5 + 0.5) * 255.0
        return torch.where(rc.mask[..., None], img, zero).to(torch.uint8)
    if kind == PREVIEW_COLOR:
        return torch.clamp(rc.color, 0.0, 255.0).to(torch.uint8)
    if kind == PREVIEW_GRAY:
        if view_dir_w is None:
            view_dir_w = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                                      device=rc.depth.device)
        lam = (rc.normals * view_dir_w).sum(dim=-1).abs()
        img = lam * 220.0 + 20.0
        return torch.where(rc.mask, img, zero).to(torch.uint8)
    raise ValueError(f"unknown preview kind {kind}")


def depth_to_png16(depth_m: torch.Tensor) -> torch.Tensor:
    """Depth (m) -> the 16-bit PNG convention depth * 256, as int32 values
    in [0, 65535] (torch has no uint16 arithmetic on every device)."""
    return torch.clamp(torch.round(depth_m * 256.0), 0, 65535).to(torch.int32)


def png16_to_depth(png: torch.Tensor) -> torch.Tensor:
    return true_div(png.to(torch.float32), 256.0)
