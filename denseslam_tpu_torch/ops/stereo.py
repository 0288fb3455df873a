"""Dense stereo depth: ZSAD cost volume + semi-global aggregation + WTA
(port of denseslam_tpu/ops/stereo.py).

The cost volume is (H, W, D) with disparity contiguous, as in the JAX
package. Its per-disparity slabs are computed as one batched (D, H, W)
pass — each slab's arithmetic is the JAX per-slab loop's — and the
right-view argmin of the LR check reads the sheared volume
cost_R(x, d) = cost_L(x + d, d) as a strided view instead of D column
shifts. Path aggregation is kernel 2 (ops/sgm.py); on the card the last
direction and the WTA maps are kernel 4, which never writes the summed
volume (ops/sgm.py `sgm_wta`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import StereoConfig
from ..utils.camera import StereoRig, disparity_to_depth
from .sgm import _BIG, WtaMaps, sgm_wta, wta_maps
from .sgm import sgm_aggregate as _sgm_aggregate


def _box_along(x: torch.Tensor, dim: int, r: int) -> torch.Tensor:
    """1-D box sum of width 2r+1 along `dim` via padded cumsum (the JAX
    version's edge / zero pads)."""
    n = x.shape[dim]
    c = torch.cumsum(x, dim=dim)
    edge = c.narrow(dim, n - 1, 1)
    upper = torch.cat([c] + [edge] * r, dim=dim).narrow(dim, r, n)
    zshape = list(c.shape)
    zshape[dim] = r + 1
    lower = torch.cat([c.new_zeros(zshape), c], dim=dim).narrow(dim, 0, n)
    return upper - lower


def _box_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable box sum over the last two dims via padded cumsum."""
    return _box_along(_box_along(img, -1, radius), -2, radius)


def cost_volume(left: torch.Tensor, right: torch.Tensor,
                cfg: StereoConfig) -> torch.Tensor:
    """(H, W, D) zero-mean SAD matching cost, f32. Invalid (no overlap) =
    large."""
    h, w = left.shape
    r = cfg.patch_radius
    area = (2 * r + 1) ** 2
    nd = cfg.max_disparity
    lm = left - _box_filter(left, r) / area
    rm = right - _box_filter(right, r) / area
    shifted = rm.new_zeros((nd, h, w))
    for d in range(min(nd, w)):
        shifted[d, :, d:] = rm[:, :w - d]
    c = _box_filter(torch.abs(lm[None] - shifted), r) / area
    col = torch.arange(w, device=left.device)
    disp = torch.arange(nd, device=left.device)
    invalid = col[None, None, :] < disp[:, None, None]
    c = c.masked_fill(invalid, _BIG)
    return c.permute(1, 2, 0).contiguous()


def sgm_aggregate(cost: torch.Tensor, cfg: StereoConfig) -> torch.Tensor:
    """4-path semi-global aggregation (kernel 2 on the card)."""
    return _sgm_aggregate(cost, cfg.sgm_p1, cfg.sgm_p2, cfg.sgm_backend)


def _disparity_from_maps(maps: WtaMaps, d: int, cfg: StereoConfig):
    """Parabolic subpixel + left-right consistency + validity gates, then
    the uniqueness gate where the maps carry its terms."""
    best, cmin, c0, c2 = maps.best, maps.cmin, maps.c0, maps.c2
    h, w = best.shape
    denom = c0 - 2.0 * cmin + c2
    sub = torch.where(denom.abs() > 1e-6, 0.5 * (c0 - c2) / denom,
                      torch.zeros_like(denom))
    disp = best.to(torch.float32) + torch.clamp(sub, -0.5, 0.5)

    col = torch.arange(w, dtype=torch.int32, device=best.device)[None, :]
    xl = torch.clamp(col - best, 0, w - 1)
    rd = torch.gather(maps.best_r, 1, xl.long())
    consistent = (best - rd).abs() <= cfg.lr_check_px

    valid = consistent & (cmin < 1e3) & (best > 0) & (best < d - 1)
    if maps.c_at is not None:
        valid = valid & (maps.c_at <= cfg.uniq_ratio * maps.second)
    return torch.where(valid, disp, torch.zeros_like(disp)), valid


def disparity_from_cost(cost: torch.Tensor, cfg: StereoConfig,
                        raw_cost: torch.Tensor = None):
    """WTA + parabolic subpixel + left-right consistency (+ raw-cost
    uniqueness gate when `raw_cost` is given and cfg.uniq_ratio > 0) of a
    summed volume. Returns (disp (H, W) f32, valid (H, W) bool)."""
    gate = raw_cost is not None and cfg.uniq_ratio > 0
    maps = wta_maps(cost, raw_cost if gate else None)
    return _disparity_from_maps(maps, cost.shape[-1], cfg)


def disparity(cost: torch.Tensor, cfg: StereoConfig):
    """SGM (when cfg.use_sgm) + WTA of a raw (H, W, D) volume in its own
    dtype, without the summed volume: on the card kernel 2 three times and
    kernel 4 once, on the CPU their plain versions. Returns (disp (H, W)
    f32, valid (H, W) bool)."""
    if not cfg.use_sgm:
        return disparity_from_cost(cost, cfg, raw_cost=cost)
    maps = sgm_wta(cost, cfg.sgm_p1, cfg.sgm_p2, cfg.sgm_backend,
                   unique=cfg.uniq_ratio > 0)
    return _disparity_from_maps(maps, cost.shape[-1], cfg)


def compute_depth(left: torch.Tensor, right: torch.Tensor, rig: StereoRig,
                  cfg: StereoConfig,
                  min_depth_m: float = 0.05,
                  max_depth_m: float = 60.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full stereo pipeline: gray pair (H, W) f32 -> (depth_m, valid)."""
    cost = cost_volume(left, right, cfg)
    if cfg.cost_dtype == "bfloat16":
        cost = cost.to(torch.bfloat16)
    disp, valid = disparity(cost, cfg)
    depth = disparity_to_depth(disp, rig, min_depth_m, max_depth_m)
    return depth, valid & (depth > 0)
