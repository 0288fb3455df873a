"""Pinhole camera model + projection utilities (port of
denseslam_tpu/utils/camera.py). Intrinsics are static Python numbers that
define array shapes; the functions run on the device of their tensors."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .numerics import true_div


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int   # static python int — defines array shapes
    height: int  # static python int

    def k_matrix(self, device=None) -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=device)

    def scaled(self, s: float) -> "Intrinsics":
        """Intrinsics for an image resized by factor s (the dataset
        reader's input_scale); the size truncates, as int() does."""
        return Intrinsics(
            self.fx * s, self.fy * s, self.cx * s, self.cy * s,
            int(self.width * s), int(self.height * s),
        )


class StereoRig(NamedTuple):
    """Rectified stereo rig: intrinsics + baseline in meters."""
    intr: Intrinsics
    baseline_m: float


def _iota(h: int, w: int, axis: int, device) -> torch.Tensor:
    if axis == 0:
        return torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    return torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)


def backproject(depth: torch.Tensor, intr: Intrinsics) -> torch.Tensor:
    """Depth map (H, W) in meters -> camera-frame points (H, W, 3)."""
    h, w = depth.shape
    v = _iota(h, w, 0, depth.device)
    u = _iota(h, w, 1, depth.device)
    x = true_div(u - intr.cx, intr.fx) * depth
    y = true_div(v - intr.cy, intr.fy) * depth
    return torch.stack([x, y, depth], dim=-1)


def project(pts: torch.Tensor, intr: Intrinsics) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame points (..., 3) -> pixel coords (..., 2) and depth (...,)."""
    z = pts[..., 2]
    safe_z = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    u = pts[..., 0] / safe_z * intr.fx + intr.cx
    v = pts[..., 1] / safe_z * intr.fy + intr.cy
    return torch.stack([u, v], dim=-1), z


def in_bounds(uv: torch.Tensor, intr: Intrinsics,
              margin: float = 0.0) -> torch.Tensor:
    """Mask of pixel coords inside the image."""
    u, v = uv[..., 0], uv[..., 1]
    return ((u >= margin) & (u <= intr.width - 1 - margin)
            & (v >= margin) & (v <= intr.height - 1 - margin))


def disparity_to_depth(disp: torch.Tensor, rig: StereoRig,
                       min_depth_m: float = 0.05,
                       max_depth_m: float = 50.0) -> torch.Tensor:
    """d = f*B / disp with min/max clamping to 0 (invalid)."""
    fb = rig.intr.fx * rig.baseline_m
    valid = disp > 1e-3
    zero = torch.zeros_like(disp)
    depth = torch.where(valid, true_div(fb, torch.clamp(disp, min=1e-3)), zero)
    keep = valid & (depth >= min_depth_m) & (depth <= max_depth_m)
    return torch.where(keep, depth, zero)


def depth_m_to_mm_i16(depth_m: torch.Tensor) -> torch.Tensor:
    """Float meters -> int16 millimeters, saturating."""
    mm = torch.round(depth_m * 1000.0)
    return torch.clamp(mm, 0, 32767).to(torch.int16)


def depth_mm_i16_to_m(depth_mm: torch.Tensor) -> torch.Tensor:
    return depth_mm.to(torch.float32) * 1e-3
