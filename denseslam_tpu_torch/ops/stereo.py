"""Dense stereo depth: ZSAD cost volume + semi-global aggregation + WTA
(port of denseslam_tpu/ops/stereo.py).

The cost volume is (H, W, D) with disparity contiguous, as in the JAX
package. Its per-disparity slabs are computed as one batched (D, H, W)
pass — each slab's arithmetic is the JAX per-slab loop's — and the
right-view argmin of the LR check reads the sheared volume
cost_R(x, d) = cost_L(x + d, d) as a strided view instead of D column
shifts. Path aggregation is kernel 2 (ops/sgm.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import StereoConfig
from ..utils.camera import StereoRig, disparity_to_depth
from .sgm import sgm_aggregate as _sgm_aggregate

_BIG = 1e4


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


def _disparity_from_maps(best, cmin, c0, c2, best_r, d: int,
                         cfg: StereoConfig):
    """Parabolic subpixel + left-right consistency + validity gates."""
    h, w = best.shape
    denom = c0 - 2.0 * cmin + c2
    sub = torch.where(denom.abs() > 1e-6, 0.5 * (c0 - c2) / denom,
                      torch.zeros_like(denom))
    disp = best.to(torch.float32) + torch.clamp(sub, -0.5, 0.5)

    col = torch.arange(w, dtype=torch.int32, device=best.device)[None, :]
    xl = torch.clamp(col - best, 0, w - 1)
    rd = torch.gather(best_r, 1, xl.long())
    consistent = (best - rd).abs() <= cfg.lr_check_px

    valid = consistent & (cmin < 1e3) & (best > 0) & (best < d - 1)
    return torch.where(valid, disp, torch.zeros_like(disp)), valid


def _right_argmin(cost: torch.Tensor) -> torch.Tensor:
    """argmin_d cost_L(x + d, d) per right-view pixel, first index on ties,
    0 where no sheared value is below the invalid marker — the JAX
    version's running strict-< argmin over D column shifts."""
    h, w, d = cost.shape
    big = torch.full((), _BIG, dtype=cost.dtype, device=cost.device)
    padded = torch.cat([cost, big.expand(h, d, d)], dim=1).contiguous()
    sheared = padded.as_strided((h, w, d), ((w + d) * d, d, d + 1))
    idx = torch.argmin(sheared, dim=-1).to(torch.int32)
    val = torch.gather(sheared, 2, idx.long()[..., None])[..., 0]
    return torch.where(val < big, idx, torch.zeros_like(idx))


def _pick(cost: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor):
    """cost[..., idx] as f32 where ok, else 0."""
    d = cost.shape[-1]
    g = torch.gather(cost, 2, idx.clamp(0, d - 1).long()[..., None])[..., 0]
    return torch.where(ok, g.to(torch.float32), torch.zeros((), device=cost.device))


def disparity_from_cost(cost: torch.Tensor, cfg: StereoConfig,
                        raw_cost: torch.Tensor = None):
    """WTA + parabolic subpixel + left-right consistency (+ raw-cost
    uniqueness gate when `raw_cost` is given and cfg.uniq_ratio > 0).
    Returns (disp (H, W) f32, valid (H, W) bool)."""
    h, w, d = cost.shape
    best = torch.argmin(cost, dim=-1).to(torch.int32)
    cmin = cost.amin(dim=-1).to(torch.float32)
    c0 = _pick(cost, best - 1, best > 0)
    c2 = _pick(cost, best + 1, best < d - 1)
    best_r = _right_argmin(cost)

    disp, valid = _disparity_from_maps(best, cmin, c0, c2, best_r, d, cfg)
    if raw_cost is not None and cfg.uniq_ratio > 0:
        c_at = _pick(raw_cost, best, torch.ones_like(valid))
        lane = torch.arange(d, dtype=torch.int32, device=cost.device)
        far = (lane - best[..., None]).abs() > 2
        big = torch.full((), _BIG, dtype=raw_cost.dtype, device=cost.device)
        second = torch.where(far, raw_cost, big).amin(dim=-1).to(torch.float32)
        unique = c_at <= cfg.uniq_ratio * second
        disp = torch.where(unique, disp, torch.zeros_like(disp))
        valid = valid & unique
    return disp, valid


def compute_depth(left: torch.Tensor, right: torch.Tensor, rig: StereoRig,
                  cfg: StereoConfig,
                  min_depth_m: float = 0.05,
                  max_depth_m: float = 60.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full stereo pipeline: gray pair (H, W) f32 -> (depth_m, valid)."""
    cost = cost_volume(left, right, cfg)
    if cfg.cost_dtype == "bfloat16":
        cost = cost.to(torch.bfloat16)
    raw = cost
    if cfg.use_sgm:
        cost = sgm_aggregate(cost, cfg)
    disp, valid = disparity_from_cost(cost, cfg, raw_cost=raw)
    depth = disparity_to_depth(disp, rig, min_depth_m, max_depth_m)
    return depth, valid & (depth > 0)
