"""Image ops: sampling, pyramids, filters (port of
denseslam_tpu/utils/image.py): the bilateral depth filter of the fusion
preprocessing, the edge-aware depth sampler of the depth post-processing,
and the resampling helpers. All vectorised; none reads a value back to the
host.
"""

from __future__ import annotations

import torch


def _corners(img: torch.Tensor, u0: torch.Tensor, v0: torch.Tensor):
    """The four pixels (v0, u0), (v0, u0 + 1), (v0 + 1, u0), (v0 + 1, u0 + 1)
    of integer corner coords already clipped into the image."""
    u0, v0 = u0.long(), v0.long()
    return img[v0, u0], img[v0, u0 + 1], img[v0 + 1, u0], img[v0 + 1, u0 + 1]


def _to_i32(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Integral x as int32, clamped into [lo, hi] in float first (NaN to
    lo) so that the cast is defined on every device. With lo = -1 and hi
    = the image size, bounds tests on the result agree with the JAX
    version's on its unclamped cast."""
    return torch.clamp(torch.nan_to_num(x, nan=lo), lo, hi).to(torch.int32)


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor,
                    valid_fill: float = 0.0):
    """Sample img (H, W) or (H, W, C) at float pixel coords uv (..., 2).
    Returns (values, mask): mask marks samples whose 4 taps lie inside."""
    h, w = img.shape[:2]
    u, v = uv[..., 0], uv[..., 1]
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    u0i = _to_i32(u0, -1, w)
    v0i = _to_i32(v0, -1, h)
    mask = (u0i >= 0) & (u0i < w - 1) & (v0i >= 0) & (v0i < h - 1)
    p00, p01, p10, p11 = _corners(img, torch.clamp(u0i, 0, w - 2),
                                  torch.clamp(v0i, 0, h - 2))
    if img.dim() == 3:
        du, dv = du[..., None], dv[..., None]
    out = (p00 * (1 - du) * (1 - dv) + p01 * du * (1 - dv)
           + p10 * (1 - du) * dv + p11 * du * dv)
    mvec = mask[..., None] if img.dim() == 3 else mask
    return torch.where(mvec, out, valid_fill), mask


def nearest_sample(img: torch.Tensor, uv: torch.Tensor,
                   valid_fill: float = 0.0):
    """Nearest-neighbour sample; returns (values, mask)."""
    h, w = img.shape[:2]
    ui = _to_i32(torch.round(uv[..., 0]), -1, w)
    vi = _to_i32(torch.round(uv[..., 1]), -1, h)
    mask = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    out = img[torch.clamp(vi, 0, h - 1).long(), torch.clamp(ui, 0, w - 1).long()]
    mvec = mask[..., None] if img.dim() == 3 else mask
    return torch.where(mvec, out, torch.full((), valid_fill, dtype=out.dtype,
                                             device=out.device)), mask


def depth_bilinear_sample(depth: torch.Tensor, uv: torch.Tensor,
                          max_gap_m: float = 0.1):
    """Bilinear depth sampling that refuses to interpolate across edges:
    a sample is bilinear only where its four corners are all valid (> 0)
    and within max_gap_m of each other, else the (v0, u0) corner's.
    Returns (depth, valid)."""
    h, w = depth.shape
    u, v = uv[..., 0], uv[..., 1]
    u0i = _to_i32(torch.floor(u), -1, w)
    v0i = _to_i32(torch.floor(v), -1, h)
    inb = (u0i >= 0) & (u0i < w - 1) & (v0i >= 0) & (v0i < h - 1)
    p00, p01, p10, p11 = _corners(depth, torch.clamp(u0i, 0, w - 2),
                                  torch.clamp(v0i, 0, h - 2))
    corners = torch.stack([p00, p01, p10, p11], dim=-1)
    all_valid = (corners > 0).all(dim=-1)
    spread = corners.amax(dim=-1) - corners.amin(dim=-1)
    smooth = all_valid & (spread < max_gap_m)
    # the JAX version subtracts the int32 corner (promoted to f32) from the
    # coordinate; in range that is the float floor
    du = u - u0i.to(torch.float32)
    dv = v - v0i.to(torch.float32)
    bil = (p00 * (1 - du) * (1 - dv) + p01 * du * (1 - dv)
           + p10 * (1 - du) * dv + p11 * du * dv)
    out = torch.where(smooth, bil, p00)
    valid = inb & (out > 0)
    return torch.where(valid, out, 0.0), valid


def bilateral_filter_depth(depth: torch.Tensor, radius: int = 2,
                           sigma_space: float = 1.5,
                           sigma_depth_m: float = 0.03) -> torch.Tensor:
    """Edge-preserving depth smoothing over a (2r+1)^2 window (wrapping at
    the borders, as the JAX version's roll does). Invalid (0) pixels stay
    invalid and do not contribute."""
    valid = depth > 0
    acc = torch.zeros_like(depth)
    wacc = torch.zeros_like(depth)
    inv2ss = 1.0 / (2.0 * sigma_space * sigma_space)
    inv2sd = 1.0 / (2.0 * sigma_depth_m * sigma_depth_m)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            shifted = torch.roll(depth, (dy, dx), dims=(0, 1))
            svalid = torch.roll(valid, (dy, dx), dims=(0, 1))
            dd = shifted - depth
            wgt = torch.where(
                svalid & valid,
                torch.exp(-(dx * dx + dy * dy) * inv2ss - dd * dd * inv2sd),
                0.0)
            acc = acc + wgt * shifted
            wacc = wacc + wgt
    out = torch.where(wacc > 1e-6, acc / torch.clamp(wacc, min=1e-6), 0.0)
    return torch.where(valid, out, 0.0)


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x box downsample of (H, W) or (H, W, C); H and W must be even. The
    four pixels are summed in row-major order, as XLA reduces them, so the
    means equal the JAX version's bit for bit."""
    h, w = img.shape[:2]
    r = img.reshape(h // 2, 2, w // 2, 2, *img.shape[2:])
    return (((r[:, 0, :, 0] + r[:, 0, :, 1]) + r[:, 1, :, 0])
            + r[:, 1, :, 1]) / 4.0


def downsample2_depth(depth: torch.Tensor) -> torch.Tensor:
    """2x depth downsample averaging only the valid pixels."""
    h, w = depth.shape
    r = depth.reshape(h // 2, 2, w // 2, 2)
    v = (r > 0).to(depth.dtype)
    s = (r * v).sum(dim=(1, 3))
    c = v.sum(dim=(1, 3))
    return torch.where(c > 0, s / torch.clamp(c, min=1.0), 0.0)


def gradient_xy(img: torch.Tensor) -> torch.Tensor:
    """Central-difference gradients; returns (H, W, 2) [gx, gy]."""
    gx = 0.5 * (torch.roll(img, -1, dims=1) - torch.roll(img, 1, dims=1))
    gy = 0.5 * (torch.roll(img, -1, dims=0) - torch.roll(img, 1, dims=0))
    gx[:, 0] = 0.0
    gx[:, -1] = 0.0
    gy[0, :] = 0.0
    gy[-1, :] = 0.0
    return torch.stack([gx, gy], dim=-1)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) float or uint8 -> (H, W) float32 grayscale."""
    rgbf = rgb.to(torch.float32)
    return rgbf[..., 0] * 0.299 + rgbf[..., 1] * 0.587 + rgbf[..., 2] * 0.114
