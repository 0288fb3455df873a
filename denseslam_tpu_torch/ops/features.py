"""Sparse feature extraction (port of denseslam_tpu/ops/features.py): the
gradient stack (blob / corner filter responses, NMS, per-class top-k
selection with parabolic subpixel refinement, 32-dim Sobel descriptors),
the ORB stack's adapter (ops/orb.py) and bucketing.

Every response map is built from shifted copies accumulated in the JAX
version's fixed order (not `conv2d`, whose summation order differs), so
responses, NMS survivors and the selected features agree with the
reference exactly (tests/test_torch_features.py). Selection ties keep the
lower index, as `lax.top_k` and `jnp.lexsort` do: every sort here is a
stable one.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import FrontendConfig
from ..utils import numerics

# 4 feature classes (blob max/min, corner max/min); class equality gates
# matching
NUM_CLASSES = 4


def _filter_kernels() -> np.ndarray:
    """(2, 5, 5): blob (center-surround) and checkerboard (corner) masks."""
    blob = np.array(
        [
            [-1, -1, -1, -1, -1],
            [-1, 1, 1, 1, -1],
            [-1, 1, 8, 1, -1],
            [-1, 1, 1, 1, -1],
            [-1, -1, -1, -1, -1],
        ],
        dtype=np.float32,
    ) / 16.0
    corner = np.array(
        [
            [-1, -1, 0, 1, 1],
            [-1, -1, 0, 1, 1],
            [0, 0, 0, 0, 0],
            [1, 1, 0, -1, -1],
            [1, 1, 0, -1, -1],
        ],
        dtype=np.float32,
    ) / 16.0
    return np.stack([blob, corner])


class Features(NamedTuple):
    uv: torch.Tensor       # f32 (N, 2) pixel coords
    cls: torch.Tensor      # i32 (N,) feature class 0..3
    desc: torch.Tensor     # f32 (N, 32) gradient descriptor
    score: torch.Tensor    # f32 (N,) detector response magnitude
    valid: torch.Tensor    # bool (N,)


def _conv2same(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """2D cross-correlation, SAME zero padding, single channel: shifted
    copies times the taps, accumulated row-major (zero taps skipped)."""
    kh, kw = k.shape
    ph, pw = kh // 2, kw // 2
    h, w = img.shape
    pad = F.pad(img, (pw, pw, ph, ph))
    out = None
    for i in range(kh):
        for j in range(kw):
            c = float(k[i, j])
            if c == 0.0:
                continue
            term = c * pad[i:i + h, j:j + w]
            out = term if out is None else out + term
    return out


def _sep_conv(img: torch.Tensor, kx: np.ndarray, ky: np.ndarray) -> torch.Tensor:
    """Separable cross-correlation: 1D horizontal (kx) then vertical (ky)."""
    h, w = img.shape
    rx = len(kx) // 2
    padx = F.pad(img, (rx, rx, 0, 0))
    tmp = None
    for j, c in enumerate(np.asarray(kx, np.float32)):
        if float(c) == 0.0:
            continue
        t = float(c) * padx[:, j:j + w]
        tmp = t if tmp is None else tmp + t
    ry = len(ky) // 2
    pady = F.pad(tmp, (0, 0, ry, ry))
    out = None
    for i, c in enumerate(np.asarray(ky, np.float32)):
        if float(c) == 0.0:
            continue
        t = float(c) * pady[i:i + h, :]
        out = t if out is None else out + t
    return out


_SMOOTH5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
_DERIV5 = np.array([-1.0, -2.0, 0.0, 2.0, 1.0], np.float32) / 6.0


def sobel_gradients(gray: torch.Tensor):
    """Smoothed Sobel derivatives (du, dv), separable."""
    du = _sep_conv(gray, _DERIV5, _SMOOTH5)
    dv = _sep_conv(gray, _SMOOTH5, _DERIV5)
    return du, dv


# 16 sparse sample offsets (dv, du) in an 11x11 neighbourhood
_DESC_OFFSETS = np.array(
    [
        [-5, -1], [-5, 1],
        [-3, -4], [-3, 0], [-3, 4],
        [-1, -2], [-1, 2],
        [0, -5], [0, 5],
        [1, -2], [1, 2],
        [3, -4], [3, 0], [3, 4],
        [5, -1], [5, 1],
    ],
    dtype=np.int32,
)


@functools.lru_cache(maxsize=None)
def _desc_offsets(device: torch.device) -> torch.Tensor:
    """The offsets on `device`, copied there once (a host-to-card copy
    waits for the card)."""
    return torch.as_tensor(_DESC_OFFSETS, device=device)


def desc_dim(cfg: FrontendConfig) -> int:
    """Descriptor width of the configured feature stack."""
    return 256 if cfg.feature_type == "orb" else 32


def detect(gray: torch.Tensor, cfg: FrontendConfig) -> Features:
    """Detect up to cfg.max_features features with descriptors, with the
    configured stack (cfg.feature_type: gradient | orb)."""
    if cfg.feature_type == "orb":
        return _detect_orb(gray, cfg)
    return _detect_gradient(gray, cfg)


def _detect_orb(gray: torch.Tensor, cfg: FrontendConfig) -> Features:
    """ORB pyramid detection in the common Features struct, padded with
    invalid rows to cfg.max_features."""
    from . import orb

    f = orb.detect_pyramid(gray, cfg.max_features, levels=cfg.orb_levels,
                           thresh=cfg.orb_thresh)
    c = orb.to_common(f)
    pad = cfg.max_features - c.uv.shape[0]
    if pad > 0:
        c = Features(*(F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad))
                       for x in c))
    return c


def _stable_topk(x: torch.Tensor, k: int):
    """`lax.top_k`: the k largest values, ties in index order."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _detect_gradient(gray: torch.Tensor, cfg: FrontendConfig) -> Features:
    """Filter-bank detection: the budget is split evenly over the 4
    classes; each class keeps its top responses among the NMS survivors."""
    h, w = gray.shape
    dev = gray.device
    kernels = _filter_kernels()
    blob = _conv2same(gray, kernels[0])
    corner = _conv2same(gray, kernels[1])
    du, dv = sobel_gradients(gray)

    cap = cfg.max_features
    per_class = cap // NUM_CLASSES
    r = cfg.nms_radius
    neg = -3.4e38
    inf = float("inf")

    def nms_mask(resp):
        # separable (2r+1)-window max via shifted maxima
        mx = resp
        padx = F.pad(resp, (r, r, 0, 0), value=neg)
        for j in range(2 * r + 1):
            mx = torch.maximum(mx, padx[:, j:j + w])
        pady = F.pad(mx, (0, 0, r, r), value=neg)
        my = mx
        for i in range(2 * r + 1):
            my = torch.maximum(my, pady[i:i + h, :])
        return (resp >= my) & (resp >= cfg.nms_tau)

    border = torch.zeros((h, w), dtype=torch.bool, device=dev)
    border[8:h - 8, 8:w - 8] = True

    # two-stage exact top-k: NMS survivors are > r apart, so an
    # (r+1)x(r+1) tile holds at most one; reduce tiles, then sort tiles
    ts = r + 1
    hp_ = -(-h // ts) * ts
    wp_ = -(-w // ts) * ts
    n_tiles = (hp_ // ts) * (wp_ // ts)

    feats_uv, feats_cls, feats_score, feats_valid = [], [], [], []
    for ci, resp in enumerate([blob, -blob, corner, -corner]):
        ok = nms_mask(resp) & border
        scores = torch.where(ok, resp, -inf)
        sp = F.pad(scores, (0, wp_ - w, 0, hp_ - h), value=-inf)
        tiles = sp.reshape(hp_ // ts, ts, wp_ // ts, ts)
        tiles = tiles.permute(0, 2, 1, 3).reshape(n_tiles, ts * ts)
        tmax = tiles.amax(dim=1)
        targ = torch.argmax(tiles, dim=1).to(torch.int32)   # first max
        if n_tiles < per_class:
            tmax = F.pad(tmax, (0, per_class - n_tiles), value=-inf)
            targ = F.pad(targ, (0, per_class - n_tiles))
        top, tidx = _stable_topk(tmax, per_class)
        tidx = torch.clamp(tidx, max=n_tiles - 1)
        ia = targ[tidx]
        ui = (tidx % (wp_ // ts)) * ts + ia % ts
        vi = (tidx // (wp_ // ts)) * ts + ia // ts
        # parabolic subpixel refinement on the response map
        uic = torch.clamp(ui, 1, w - 2)
        vic = torch.clamp(vi, 1, h - 2)
        rc = resp[vic, uic]
        rl = resp[vic, uic - 1]
        rr = resp[vic, uic + 1]
        rt = resp[vic - 1, uic]
        rb = resp[vic + 1, uic]
        den_u = rl - 2.0 * rc + rr
        den_v = rt - 2.0 * rc + rb
        du_sub = torch.where(den_u.abs() > 1e-6, 0.5 * (rl - rr) / den_u, 0.0)
        dv_sub = torch.where(den_v.abs() > 1e-6, 0.5 * (rt - rb) / den_v, 0.0)
        u = ui.to(torch.float32) + torch.clamp(du_sub, -0.5, 0.5)
        v = vi.to(torch.float32) + torch.clamp(dv_sub, -0.5, 0.5)
        feats_uv.append(torch.stack([u, v], dim=-1))
        feats_cls.append(torch.full((per_class,), ci, dtype=torch.int32,
                                    device=dev))
        fin = torch.isfinite(top)
        feats_score.append(torch.where(fin, top, 0.0))
        feats_valid.append(fin)

    uv = torch.cat(feats_uv, dim=0)
    cls = torch.cat(feats_cls, dim=0)
    score = torch.cat(feats_score, dim=0)
    valid = torch.cat(feats_valid, dim=0)
    desc = describe(du, dv, uv)
    return Features(uv=uv, cls=cls, desc=desc, score=score, valid=valid)


def describe(du: torch.Tensor, dv: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """The 32-dim gradient descriptor at integer (truncated) feature
    locations, L2-normalised. The squares are summed as jitted XLA sums
    them (a chain of FMAs, `numerics.fma_dot`) and the root is correctly
    rounded, so every device gives JAX's descriptor."""
    h, w = du.shape
    offs = _desc_offsets(du.device)
    ui = torch.clamp(uv[:, 0].to(torch.int32), 0, w - 1)
    vi = torch.clamp(uv[:, 1].to(torch.int32), 0, h - 1)
    us = torch.clamp(ui[:, None] + offs[None, :, 1], 0, w - 1).long()
    vs = torch.clamp(vi[:, None] + offs[None, :, 0], 0, h - 1).long()
    desc = torch.cat([du[vs, us], dv[vs, us]], dim=-1)    # (N, 32)
    n = numerics.sqrt(numerics.fma_dot(desc, desc))[:, None]
    return desc / torch.clamp(n, min=1e-6)


def bucket(feats: Features, width: int, height: int,
           cfg: FrontendConfig) -> Features:
    """Spatially uniform thinning: keep the strongest max_per_bucket
    features of each bucket_w x bucket_h cell."""
    bw = (width + cfg.bucket_w - 1) // cfg.bucket_w
    ui = feats.uv[:, 0].to(torch.int32)
    vi = feats.uv[:, 1].to(torch.int32)
    cell = (torch.div(vi, cfg.bucket_h, rounding_mode="floor") * bw
            + torch.div(ui, cfg.bucket_w, rounding_mode="floor"))
    key = torch.where(feats.valid, cell, 2 ** 30)
    n = feats.uv.shape[0]
    # jnp.lexsort((-score, key)): key first, then -score, then index —
    # two stable sorts, the secondary key first
    o1 = torch.argsort(-feats.score, stable=True)
    order = o1[torch.argsort(key[o1], stable=True)]
    sorted_cell = key[order]
    same_as_prev = torch.cat([torch.zeros((1,), dtype=torch.bool,
                                          device=key.device),
                              sorted_cell[1:] == sorted_cell[:-1]])
    idxs = torch.arange(n, dtype=torch.int32, device=key.device)
    run_start = torch.cummax(torch.where(same_as_prev, 0, idxs), dim=0).values
    ranks = torch.empty_like(idxs)
    ranks[order] = idxs - run_start
    keep = feats.valid & (ranks < cfg.max_per_bucket)
    return feats._replace(valid=keep)
