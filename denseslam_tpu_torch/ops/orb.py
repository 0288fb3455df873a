"""ORB-style features: oriented FAST + steered binary descriptors (port of
denseslam_tpu/ops/orb.py).

  * the FAST segment test for every pixel at once: the 16 circle taps are
    `torch.roll` shifts, the contiguous-9 test an AND over 9 rotations of
    the tap axis and an OR over the 16 starts;
  * NMS by a (2r+1)-window max (`max_pool2d`, padded with -inf) and a
    top-k whose ties keep the lower index, as `lax.top_k` breaks them;
  * orientation by intensity centroid, the moments summed in the JAX
    version's order;
  * the BRIEF pair pattern from a fixed numpy seed, steered per keypoint
    and rounded half to even;
  * descriptors pack to (N, 8) int64 words holding the JAX version's
    uint32 words (values in [0, 2^32)): torch's uint32 supports few
    operations. Hamming distance is XOR + a SWAR popcount, word by word.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.image import downsample2
from .features import Features, _stable_topk

# 16-point Bresenham circle of radius 3 (dy, dx), clockwise.
_CIRCLE = np.array(
    [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
     (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)],
    dtype=np.int32,
)

N_PAIRS = 256
_PATCH = 15  # descriptor patch half-size


def _brief_pattern() -> np.ndarray:
    """(256, 4) [ay, ax, by, bx] gaussian pairs, fixed seed."""
    rng = np.random.default_rng(42)
    p = rng.normal(0.0, _PATCH / 2.5, (N_PAIRS, 4))
    return np.clip(p, -_PATCH, _PATCH).astype(np.float32)


_PATTERN = _brief_pattern()


@functools.lru_cache(maxsize=None)
def _pattern(device: torch.device) -> torch.Tensor:
    """The pattern on `device`, copied there once (a host-to-card copy
    waits for the card)."""
    return torch.as_tensor(_PATTERN, device=device)


@functools.lru_cache(maxsize=None)
def _shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


class OrbFeatures(NamedTuple):
    uv: torch.Tensor       # f32 (N, 2)
    angle: torch.Tensor    # f32 (N,) radians
    desc: torch.Tensor     # i64 (N, 8) packed 256-bit descriptors, 32 a word
    score: torch.Tensor    # f32 (N,)
    valid: torch.Tensor    # bool (N,)


def fast_score(gray: torch.Tensor, thresh: float = 18.0,
               arc: int = 9) -> torch.Tensor:
    """FAST corner response: 0 where not a corner, else the sum of
    |tap - centre| over the 16 taps."""
    taps = [torch.roll(gray, (-int(dy), -int(dx)), dims=(0, 1))
            for dy, dx in _CIRCLE]
    t = torch.stack(taps, dim=0)                     # (16, H, W)
    brighter = t > gray[None] + thresh
    darker = t < gray[None] - thresh

    def has_arc(m):
        # run[s] = m[s] & m[s + 1] & ... & m[s + arc - 1], indices mod 16
        run = m
        for k in range(1, arc):
            run = run & torch.roll(m, -k, dims=0)
        return run.any(dim=0)

    corner = has_arc(brighter) | has_arc(darker)
    strength = (t[0] - gray).abs()
    for i in range(1, 16):                           # the JAX sum's order
        strength = strength + (t[i] - gray).abs()
    return torch.where(corner, strength, 0.0)


def orientation(gray: torch.Tensor, uv: torch.Tensor,
                radius: int = 7) -> torch.Tensor:
    """Intensity-centroid angle at integer keypoint locations."""
    h, w = gray.shape
    ui = torch.clamp(uv[:, 0].to(torch.int32), radius, w - 1 - radius)
    vi = torch.clamp(uv[:, 1].to(torch.int32), radius, h - 1 - radius)
    flat = gray.reshape(-1)
    base = (vi * w + ui).long()
    m10 = 0.0
    m01 = 0.0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx * dx + dy * dy > radius * radius:
                continue
            val = flat[base + (dy * w + dx)]
            m10 = m10 + dx * val
            m01 = m01 + dy * val
    return torch.atan2(m01, m10)


def describe(gray: torch.Tensor, uv: torch.Tensor,
             angle: torch.Tensor) -> torch.Tensor:
    """Steered-BRIEF descriptors -> (N, 8) int64 words."""
    h, w = gray.shape
    ca = torch.cos(angle)[:, None]
    sa = torch.sin(angle)[:, None]
    pat = _pattern(gray.device)
    ay, ax, by, bx = (pat[:, i][None] for i in range(4))
    rax = ca * ax - sa * ay
    ray = sa * ax + ca * ay
    rbx = ca * bx - sa * by
    rby = sa * bx + ca * by
    u = uv[:, 0][:, None]
    v = uv[:, 1][:, None]

    def pix(x, hi):
        return torch.clamp(torch.round(x).to(torch.int32), 0, hi - 1)

    ua, va = pix(u + rax, w), pix(v + ray, h)
    ub, vb = pix(u + rbx, w), pix(v + rby, h)
    flat = gray.reshape(-1)
    bits = (flat[(va * w + ua).long()]
            < flat[(vb * w + ub).long()]).to(torch.int64)     # (N, 256)
    words = bits.reshape(-1, 8, 32) << _shifts(gray.device)
    return words.sum(dim=-1)                                  # (N, 8)


def detect(gray: torch.Tensor, max_features: int = 512,
           thresh: float = 18.0, nms_radius: int = 4,
           border: int = 19) -> OrbFeatures:
    """Single-scale oriented-FAST + steered-BRIEF extraction."""
    h, w = gray.shape
    score = fast_score(gray, thresh)
    k = 2 * nms_radius + 1
    mx = F.max_pool2d(score[None, None], k, stride=1,
                      padding=nms_radius)[0, 0]
    inb = torch.zeros((h, w), dtype=torch.bool, device=gray.device)
    inb[border:h - border, border:w - border] = True
    ok = (score >= mx) & (score > 0) & inb
    flat_scores = torch.where(ok, score, float("-inf")).reshape(-1)
    top, idx = _stable_topk(flat_scores, max_features)
    ui = idx % w
    vi = idx // w
    # parabolic subpixel refinement on the FAST response map
    uic = torch.clamp(ui, 1, w - 2)
    vic = torch.clamp(vi, 1, h - 2)
    rc = score[vic, uic]
    rl = score[vic, uic - 1]
    rr = score[vic, uic + 1]
    rt = score[vic - 1, uic]
    rb = score[vic + 1, uic]
    den_u = rl - 2.0 * rc + rr
    den_v = rt - 2.0 * rc + rb
    du_sub = torch.where(den_u.abs() > 1e-6, 0.5 * (rl - rr) / den_u, 0.0)
    dv_sub = torch.where(den_v.abs() > 1e-6, 0.5 * (rt - rb) / den_v, 0.0)
    u = ui.to(torch.float32) + torch.clamp(du_sub, -0.5, 0.5)
    v = vi.to(torch.float32) + torch.clamp(dv_sub, -0.5, 0.5)
    uv = torch.stack([u, v], dim=-1)
    valid = torch.isfinite(top) & (top > 0)
    ang = orientation(gray, uv)
    desc = describe(gray, uv, ang)
    return OrbFeatures(uv=uv, angle=ang, desc=desc,
                       score=torch.where(valid, top, 0.0), valid=valid)


def detect_pyramid(gray: torch.Tensor, max_features: int = 512,
                   levels: int = 3, scale: float = 0.5,
                   thresh: float = 18.0) -> OrbFeatures:
    """Multi-scale detection: max_features // levels a level, on exact 2x
    box-downsampled levels, coordinates mapped to level 0 (`scale` is
    fixed at 0.5 and kept for the JAX signature)."""
    per_level = max_features // levels
    feats = []
    img = gray
    factor = 1.0
    for lv in range(levels):
        f = detect(img, per_level, thresh)
        feats.append(f._replace(uv=f.uv * factor))
        if lv + 1 < levels:
            hh = (img.shape[0] // 2) * 2
            ww = (img.shape[1] // 2) * 2
            img = downsample2(img[:hh, :ww])
            factor *= 2.0
    return OrbFeatures(*(torch.cat([getattr(f, name) for f in feats])
                         for name in OrbFeatures._fields))


def unpack_desc(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) packed words -> (N, 256) float in {-1/16, +1/16}: unit
    vectors whose squared distance is Hamming / 64, so ORB runs through
    the generic matching cost."""
    bits = ((desc[:, :, None] >> _shifts(desc.device)) & 1).to(torch.float32)
    return (bits * 2.0 - 1.0).reshape(desc.shape[0], 8 * 32) / 16.0


def to_common(f: OrbFeatures) -> Features:
    """OrbFeatures -> the system-wide `Features` struct (single class 0)."""
    n = f.uv.shape[0]
    return Features(uv=f.uv,
                    cls=torch.zeros((n,), dtype=torch.int32,
                                    device=f.uv.device),
                    desc=unpack_desc(f.desc), score=f.score, valid=f.valid)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int64 holding a 32-bit word."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na, 8) x (Nb, 8) packed words -> (Na, Nb) int32 Hamming distances,
    a word at a time (one (Na, Nb) int64 plane live, not eight)."""
    d = None
    for i in range(a.shape[1]):
        c = _popcount32(a[:, i, None] ^ b[None, :, i])
        d = c if d is None else d + c
    return d.to(torch.int32)


def match(fa: OrbFeatures, fb: OrbFeatures, max_dist: int = 64) -> torch.Tensor:
    """Mutual-NN Hamming matching: (Na,) index into b, -1 unmatched."""
    d = hamming_matrix(fa.desc, fb.desc)
    d = torch.where(fa.valid[:, None] & fb.valid[None, :], d, 10_000)
    fwd = torch.argmin(d, dim=1)
    bwd = torch.argmin(d, dim=0)
    best = torch.gather(d, 1, fwd[:, None])[:, 0]
    ok = (best <= max_dist) & (bwd[fwd] == torch.arange(d.shape[0],
                                                        device=d.device))
    return torch.where(ok, fwd, -1)
