"""Dense stereo depth: ZSAD cost volume + semi-global aggregation + WTA
(port of denseslam_tpu/ops/stereo.py).

The cost volume is (H, W, D) with disparity contiguous, as in the JAX
package, and equals the jitted JAX function's bit for bit: its window sums
add in XLA:CPU's order (`scan16`) and it takes jitted XLA's two rewrites
(a multiply by the reciprocal area, one FMA for the zero-mean images). On
the card it is kernel CV (csrc/cost_volume.cu); on the CPU its plain
version, `cost_volume_plain`, whose per-disparity slabs are one batched
(D, H, W) pass. The right-view argmin of the LR check reads the sheared
volume cost_R(x, d) = cost_L(x + d, d) as a strided view instead of D
column shifts. Path aggregation is kernel 2 (ops/sgm.py); on the card the
last direction and the WTA maps are kernel 4, which never writes the
summed volume (ops/sgm.py `sgm_wta`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from ..config import StereoConfig
from ..utils import numerics
from ..utils.camera import StereoRig, disparity_to_depth
from .sgm import _BIG, WtaMaps, sgm_wta, wta_maps
from .sgm import sgm_aggregate as _sgm_aggregate

_BASE = 16
# kernel CV scans the block totals of a line in two levels of 16 and keeps
# a ring of 2r + 2 sums a column in shared memory (csrc/cost_volume.cu)
_CV_MAX_LINE = _BASE * 256
_CV_MAX_RADIUS = 31


def scan16(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The inclusive cumulative sum of float32 `x` along `dim`, in the order
    jitted XLA:CPU adds `jnp.cumsum`: its reduce-window rewrite of the
    cumulative sum into a blocked scan of base 16 (found by probing
    `jax.jit(jnp.cumsum)`; bases 8 to 256 other than 16 do not match). The
    line is cut into blocks of 16, zero-padded at the end; each block is
    summed left to right from 0; the block totals are scanned the same
    way, recursively; each block's exclusive carry (0 for the first) is
    added last. Built from elementwise adds only, so every device rounds
    it alike; `torch.cumsum` matches neither this nor a sequential sum."""
    dim = dim % x.dim()
    n = x.shape[dim]
    m = -(-n // _BASE)
    pad = list(x.shape)
    pad[dim] = m * _BASE
    s = x.new_zeros(pad)
    s.narrow(dim, 0, n).copy_(x)
    s = s.view(x.shape[:dim] + (m, _BASE) + x.shape[dim + 1:])
    s.select(dim + 1, 0).add_(0.0)
    for k in range(1, _BASE):
        s.select(dim + 1, k).add_(s.select(dim + 1, k - 1))
    if m > 1:
        tot = scan16(s.select(dim + 1, _BASE - 1), dim)
        carry = torch.cat([torch.zeros_like(tot.narrow(dim, 0, 1)),
                           tot.narrow(dim, 0, m - 1)], dim=dim)
        s.add_(carry.unsqueeze(dim + 1))
    return s.view(pad).narrow(dim, 0, n)


def _box_along(x: torch.Tensor, dim: int, r: int) -> torch.Tensor:
    """1-D box sum of width 2r+1 along `dim` via padded cumsum (the JAX
    version's edge / zero pads), the cumsum in XLA's order (`scan16`)."""
    n = x.shape[dim]
    c = scan16(x, dim)
    edge = c.narrow(dim, n - 1, 1)
    upper = torch.cat([c] + [edge] * r, dim=dim).narrow(dim, r, n)
    zshape = list(c.shape)
    zshape[dim] = r + 1
    lower = torch.cat([c.new_zeros(zshape), c], dim=dim).narrow(dim, 0, n)
    return upper - lower


def _box_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable box sum over the last two dims via padded cumsum."""
    return _box_along(_box_along(img, -1, radius), -2, radius)


def _reciprocal_area(r: int) -> float:
    """float32(1 / area), the quotient rounded once to float32 (an exact
    Python float): jitted XLA multiplies by it instead of dividing."""
    return float(torch.ones(()) / float((2 * r + 1) ** 2))


def cost_volume_plain(left: torch.Tensor, right: torch.Tensor,
                      cfg: StereoConfig,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of kernel CV: the (H, W, D) zero-mean SAD
    cost as jitted XLA computes `denseslam_tpu/ops/stereo.py`
    `cost_volume`, in `dtype` (bf16 rounded from f32). XLA turns each
    `/ area` into `* rcp` and contracts `img - box / area` into
    fma(-box, rcp, img) (`numerics.fma`)."""
    h, w = left.shape
    r = cfg.patch_radius
    nd = cfg.max_disparity
    rcp = _reciprocal_area(r)
    rcp_t = torch.tensor(rcp, dtype=torch.float32, device=left.device)
    lm = numerics.fma(-_box_filter(left, r), rcp_t, left)
    rm = numerics.fma(-_box_filter(right, r), rcp_t, right)
    # |lm - shift_d(rm)|, the shifted image 0 where x < d (lm - 0 is lm)
    ad = lm.expand(nd, h, w).clone()
    for d in range(min(nd, w)):
        torch.sub(lm[:, d:], rm[:, :w - d], out=ad[d, :, d:])
    c = _box_filter(ad.abs_(), r).mul_(rcp)
    out = torch.empty((h, w, nd), dtype=dtype, device=left.device)
    out.copy_(c.permute(1, 2, 0))
    col = torch.arange(w, device=left.device)
    disp = torch.arange(nd, device=left.device)
    return out.masked_fill_(col[:, None] < disp[None, :], _BIG)


def cost_volume(left: torch.Tensor, right: torch.Tensor, cfg: StereoConfig,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(H, W, D) zero-mean SAD matching cost in `dtype` (f32 or bf16).
    Invalid (no overlap) = large. Kernel CV for CUDA tensors, written once
    in `dtype`; the plain version for CPU ones."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cost dtype {dtype}: expected f32 or bf16")
    if left.device.type == "cpu":
        return cost_volume_plain(left, right, cfg, dtype)
    h, w = left.shape
    r, nd = cfg.patch_radius, cfg.max_disparity
    if max(h, w) > _CV_MAX_LINE or not 0 <= r <= _CV_MAX_RADIUS:
        raise ValueError(f"cost volume {h}x{w}, radius {r}: kernel CV takes "
                         f"lines up to {_CV_MAX_LINE} and radii up to "
                         f"{_CV_MAX_RADIUS}")
    dev = left.device
    kernels.check_tensor(left, "left", torch.float32, (h, w))
    kernels.check_tensor(right, "right", torch.float32, (h, w), dev)
    m1 = -(-w // _BASE)
    f32 = dict(dtype=torch.float32, device=dev)
    lmrm = torch.empty((2, h, w), **f32)
    # the images' row box sums, transposed (each column a row of it)
    rowbox = torch.empty((2, w, h), **f32)
    # the block carries along the images' rows, then along their columns
    # (one buffer for both), and along the volume's rows
    icar = torch.empty((max(h * m1, w * -(-h // _BASE)), 2), **f32)
    vcar = torch.empty((h, m1, nd), **f32)
    out = torch.empty((h, w, nd), dtype=dtype, device=dev)
    kernels.launch("cost_volume", dev, left, right, lmrm, rowbox, icar, vcar,
                   out, h, w, nd, r, _reciprocal_area(r),
                   int(dtype == torch.bfloat16))
    return out


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
    dtype = torch.bfloat16 if cfg.cost_dtype == "bfloat16" else torch.float32
    cost = cost_volume(left, right, cfg, dtype)
    disp, valid = disparity(cost, cfg)
    depth = disparity_to_depth(disp, rig, min_depth_m, max_depth_m)
    return depth, valid & (depth > 0)
