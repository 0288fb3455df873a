"""Descriptor matching (port of denseslam_tpu/ops/matching.py): the
squared-L2 cost matrix as one matmul, mutual nearest neighbours, the
stereo match along the epipolar band and the circular quad match, the
motion-prior gate, neighbourhood flow consensus, the photometric gain of
matched patches, and subpixel refinement by bilinear patch correlation
(the quad's legs, or the temporal leg alone).

Scalar divisions divide by (or of) a 0-d tensor (`utils/numerics.py`), so
they round once on every device as JAX's do. The cost matrices are
float32 matmuls (TF32 off); they sum in another order than XLA:CPU, so a
near-tie argmin can pick the other neighbour (tests/test_torch_matching.py
and tests/test_torch_vo.py state the agreement rates).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import FrontendConfig
from ..utils.numerics import fma, fma_dot, recip, sum_seq, true_div
from .features import Features

_INF = 1e9


def _pair_cost(a: Features, b: Features) -> torch.Tensor:
    """Squared L2 descriptor distance (Na, Nb)."""
    dots = a.desc @ b.desc.T
    na = (a.desc * a.desc).sum(dim=-1)
    nb = (b.desc * b.desc).sum(dim=-1)
    return na[:, None] + nb[None, :] - 2.0 * dots


def _gated_cost(a: Features, b: Features, max_du: float, max_dv: float,
                du_range: Optional[Tuple[float, float]] = None
                ) -> torch.Tensor:
    """Masked cost matrix: class equality, validity and spatial gates;
    du_range (lo, hi) also bounds u_a - u_b (stereo: the disparity)."""
    cost = _pair_cost(a, b)
    du = a.uv[:, 0][:, None] - b.uv[:, 0][None, :]
    dv = a.uv[:, 1][:, None] - b.uv[:, 1][None, :]
    ok = (a.valid[:, None] & b.valid[None, :]
          & (a.cls[:, None] == b.cls[None, :])
          & (du.abs() <= max_du) & (dv.abs() <= max_dv))
    if du_range is not None:
        ok = ok & (du >= du_range[0]) & (du <= du_range[1])
    return torch.where(ok, cost, _INF)


def mutual_nn(cost: torch.Tensor) -> torch.Tensor:
    """Mutual nearest neighbour: (Na,) index into b, -1 when unmatched.
    argmin keeps the first minimum, as jnp.argmin does."""
    fwd = torch.argmin(cost, dim=1)
    bwd = torch.argmin(cost, dim=0)
    best = torch.gather(cost, 1, fwd[:, None])[:, 0]
    rows = torch.arange(cost.shape[0], device=cost.device)
    ok = (best < _INF * 0.5) & (bwd[fwd] == rows)
    return torch.where(ok, fwd, -1).to(torch.int32)


class QuadMatches(NamedTuple):
    """Circularly-consistent quad matches, indexed by current-left feature."""
    idx_lc: torch.Tensor  # i32 (M,) index into curr-left features
    idx_rc: torch.Tensor  # i32 (M,)
    idx_lp: torch.Tensor  # i32 (M,)
    idx_rp: torch.Tensor  # i32 (M,)
    uv_lc: torch.Tensor   # f32 (M, 2)
    uv_rc: torch.Tensor
    uv_lp: torch.Tensor
    uv_rp: torch.Tensor
    valid: torch.Tensor   # bool (M,)


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum of a 1-D tensor as jitted XLA:CPU adds it (its tree
    reduction rewrite): windows of 32, the input zero-padded evenly at
    both ends to whole windows, each summed left to right; the window sums
    reduced so again while more than 32 remain; the rest left to right.
    Each add is its own elementwise op, so the card and the CPU round
    alike; a float32 sum in torch's order parts from XLA's by an ulp."""
    while x.numel() > 32:
        pad = -x.numel() % 32
        x = F.pad(x, (pad // 2, pad - pad // 2)).reshape(-1, 32)
        acc = x[:, 0]
        for j in range(1, 32):
            acc = acc + x[:, j]
        x = acc
    acc = x[0]
    for j in range(1, x.numel()):
        acc = acc + x[j]
    return acc


def estimate_gain(img_a: torch.Tensor, img_b: torch.Tensor,
                  uv_a: torch.Tensor, uv_b: torch.Tensor,
                  valid: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Photometric gain of b relative to a over matched patches: the ratio
    of the (2r+1)^2 patch sums over the valid matches, 1 where a's sum is
    0. Positions truncate toward zero, then clip to the interior; the
    patch taps are summed in the JAX loop order, and the two sums over
    the matches in XLA's order (`xla_sum`), the same on every device."""
    h, w = img_a.shape

    def patch_sum(img, uv):
        ui = torch.clamp(uv[:, 0].to(torch.int32), radius, w - 1 - radius)
        vi = torch.clamp(uv[:, 1].to(torch.int32), radius, h - 1 - radius)
        flat = img.reshape(-1)
        acc = 0.0
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                acc = acc + flat[((vi + dy) * w + (ui + dx)).long()]
        return acc

    vf = valid.to(torch.float32)
    num = xla_sum(vf * patch_sum(img_b, uv_b))
    den = xla_sum(vf * patch_sum(img_a, uv_a))
    return torch.where(den > 1e-6, num / torch.clamp(den, min=1e-6), 1.0)


def flow_consensus(uv: torch.Tensor, flow_u: torch.Tensor,
                   flow_v: torch.Tensor, disp: Optional[torch.Tensor],
                   valid: torch.Tensor, k: int, tol_flow: float,
                   tol_disp: float, min_support: int) -> torch.Tensor:
    """Neighbourhood flow-consensus inlier mask (M,): a match survives when
    >= min_support of its k nearest matched neighbours in the image agree
    in flow (and disparity) within tolerance. k rounds of argmin-extract,
    as the JAX version does."""
    m = uv.shape[0]
    d2 = (uv * uv).sum(dim=-1)
    dist = d2[:, None] + d2[None, :] - 2.0 * (uv @ uv.T)
    ok = valid[:, None] & valid[None, :]
    dist = torch.where(ok, dist, _INF)
    eye = torch.eye(m, dtype=torch.bool, device=uv.device)
    dist = torch.where(eye, _INF, dist)
    support = torch.zeros((m,), dtype=torch.int32, device=uv.device)
    for round_i in range(k):
        nbr = torch.argmin(dist, dim=1)
        best = torch.gather(dist, 1, nbr[:, None])[:, 0]
        nbr_ok = best < _INF * 0.5
        du = (flow_u - flow_u[nbr]).abs()
        dv = (flow_v - flow_v[nbr]).abs()
        agree = nbr_ok & (du <= tol_flow) & (dv <= tol_flow)
        if disp is not None:
            agree = agree & ((disp - disp[nbr]).abs() <= tol_disp)
        support = support + agree.to(torch.int32)
        if round_i + 1 < k:
            dist = dist.scatter(1, nbr[:, None], _INF)
    return valid & (support >= min_support)


def remove_outliers(q: QuadMatches, cfg: FrontendConfig) -> QuadMatches:
    """Flow + disparity consensus over quad matches."""
    if not cfg.outlier_removal:
        return q
    keep = flow_consensus(
        q.uv_lc,
        q.uv_lc[:, 0] - q.uv_lp[:, 0],
        q.uv_lc[:, 1] - q.uv_lp[:, 1],
        q.uv_lc[:, 0] - q.uv_rc[:, 0],
        q.valid,
        k=cfg.outlier_knn,
        tol_flow=cfg.outlier_flow_tol_px,
        tol_disp=cfg.outlier_disp_tol_px,
        min_support=cfg.outlier_min_support,
    )
    return q._replace(valid=keep)


def _bilinear_patches(img: torch.Tensor, uv: torch.Tensor, half: int,
                      ext: int = 0, scale: Optional[torch.Tensor] = None,
                      ext_v: Optional[int] = None) -> torch.Tensor:
    """Bilinear-sampled square patches around subpixel centers: (M, Sv, Su)
    with S = 2*(half+ext)+1, sampled at uv + scale * integer offsets."""
    h, w = img.shape
    flat = img.reshape(-1)
    dev = img.device
    if scale is None:
        # unit stride: one gather of the (Sv+1, Su+1) integer super-patch;
        # the four bilinear corners are shifted slices of it
        ev = ext if ext_v is None else ext_v
        su_ = 2 * (half + ext) + 1
        sv_ = 2 * (half + ev) + 1
        u0f = torch.floor(uv[:, 0])
        v0f = torch.floor(uv[:, 1])
        fu = (uv[:, 0] - u0f)[:, None, None]
        fv = (uv[:, 1] - v0f)[:, None, None]
        co = torch.arange(su_ + 1, dtype=torch.int32, device=dev) - (half + ext)
        ro = torch.arange(sv_ + 1, dtype=torch.int32, device=dev) - (half + ev)
        vi = torch.clamp(v0f.to(torch.int32)[:, None] + ro[None, :], 0, h - 1)
        ui = torch.clamp(u0f.to(torch.int32)[:, None] + co[None, :], 0, w - 1)
        sup = flat[(vi[:, :, None] * w + ui[:, None, :]).long()]
        p00 = sup[:, :-1, :-1]
        p01 = sup[:, :-1, 1:]
        p10 = sup[:, 1:, :-1]
        p11 = sup[:, 1:, 1:]
        return _bilinear_sum(p00, p01, p10, p11, fu, fv)
    offs = torch.arange(-(half + ext), half + ext + 1, dtype=torch.float32,
                        device=dev)
    sc = scale[:, None, None]
    n = offs.numel()
    # uv + sc * offs, one FMA as jitted XLA:CPU contracts it
    su = fma(sc, offs[None, None, :], uv[:, 0, None, None]).expand(-1, n, n)
    sv = fma(sc, offs[None, :, None], uv[:, 1, None, None]).expand(-1, n, n)
    su = torch.clamp(su, 0.0, w - 1.001)    # border samples degrade to clamp
    sv = torch.clamp(sv, 0.0, h - 1.001)
    u0 = torch.floor(su).to(torch.int32)
    v0 = torch.floor(sv).to(torch.int32)
    fu = su - u0
    fv = sv - v0
    idx = (v0 * w + u0).long()
    p00 = flat[idx]
    p01 = flat[idx + 1]
    p10 = flat[idx + w]
    p11 = flat[idx + w + 1]
    return _bilinear_sum(p00, p01, p10, p11, fu, fv, scaled=True)


def _bilinear_sum(p00, p01, p10, p11, fu, fv, scaled: bool = False):
    """p00 (1 - fu)(1 - fv) + p01 fu (1 - fv) + p10 (1 - fu) fv + p11 fu fv
    as jitted XLA:CPU contracts it: each "+ a * b" an FMA over the rounded
    first factor; of the first two terms LLVM folds the first on the unit
    grid, fma(p00 (1 - fu), 1 - fv, p01 fu (1 - fv)), and the second on
    the scaled one. Each FMA is an exact `fma`: on these integer-valued
    images a float64 sum rounded to float32 (`fma_twice`) meets float32
    midpoints often enough to part the 160x120 golden's poses."""
    a0, b0 = p00 * (1 - fu), 1 - fv
    a1, b1 = p01 * fu, 1 - fv
    if scaled:
        a0, b0, a1, b1 = a1, b1, a0, b0
    val = fma(a0, b0, a1 * b1)
    val = fma(p10 * (1 - fu), fv, val)
    return fma(p11 * fu, fv, val)


def _patch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the trailing (S, S) dims as jitted XLA takes it: the
    S*S values summed left to right in row-major order, times
    float32(1 / S^2)."""
    rcp = float(torch.ones(()) / float(x.shape[-2] * x.shape[-1]))
    return sum_seq(x.flatten(-2)) * rcp


# the patch size whose summation order was read from the golden's program
ROW_ORDER_PATCH = 9


def _zssd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Zero-mean SSD of patches a (M, S, S) against b (..., M, S, S) ->
    (..., M), in jitted XLA's order (the means by `_patch_mean`, taken
    for a and every b in one pass), so every device gives JAX's cost. The
    squares are summed as `process_sequence`'s refinement sums them at
    S = 9 (`_row_vector_ssd`, read from `tests/_torch_golden.py --dump`;
    the 160x120 golden holds it). That order depends on S (the row's
    lanes), and no other size's was read: there the squares go in one
    chain of FMAs, the order of `_zssd` jitted alone."""
    means = _patch_mean(torch.cat([a[None], b.reshape(-1, *a.shape)]))
    am = a - means[0][:, None, None]
    bm = b - means[1:].reshape(b.shape[:-2])[..., None, None]
    if a.shape[-1] == ROW_ORDER_PATCH:
        return _row_vector_ssd(am - bm)
    d = (am - bm).flatten(-2)
    return fma_dot(d, d)


def _row_vector_ssd(d: torch.Tensor) -> torch.Tensor:
    """The sum of d^2 over the trailing (9, 9) dims as the refinement's
    fused reduction in `process_sequence` has it (the reduction is marked
    reassociable and LLVM vectorizes each row in eight lanes): row by row,
    lane 0 a chain of FMAs from the total of the rows before over the
    row's columns 0 and 8, lanes 1-7 the squares of columns 1-7, then the
    lanes halved (l + 4, l + 2, l + 1) into the new total."""
    total = torch.zeros(d.shape[:-2], dtype=d.dtype, device=d.device)
    for row in d.unbind(-2):
        sq = row[..., 1:8] * row[..., 1:8]
        lane0 = fma(row[..., 0], row[..., 0], total)
        lane0 = fma(row[..., 8], row[..., 8], lane0)
        lanes = torch.cat([lane0[..., None], sq], dim=-1)
        lanes = lanes[..., :4] + lanes[..., 4:]
        lanes = lanes[..., :2] + lanes[..., 2:]
        total = lanes[..., 0] + lanes[..., 1]
    return total


def _parabolic(c_m, c_0, c_p):
    """Subpixel offset of a quadratic through 3 cost samples, clipped."""
    den = c_m - 2.0 * c_0 + c_p
    off = torch.where(den.abs() > 1e-9, 0.5 * (c_m - c_p) / den, 0.0)
    return torch.clamp(off, -0.6, 0.6)


def _refine_leg(anchor: torch.Tensor, img: torch.Tensor, uv: torch.Tensor,
                half: int, search: int, du_only: bool) -> torch.Tensor:
    """Correlate `anchor` patches (M, S, S) against `img` on a bilinear grid
    around `uv` (integer shifts within +-search); return refined uv."""
    r = search
    s = 2 * half + 1
    ext = _bilinear_patches(img, uv, half, ext=r, ext_v=0 if du_only else r)
    n_dv = 1 if du_only else (2 * r + 1)
    # every shift's window at once: (n_dv, 2r+1, M, S, S)
    wins = torch.stack([torch.stack([ext[:, dy:dy + s, dx:dx + s]
                                     for dx in range(2 * r + 1)])
                        for dy in range(n_dv)])
    c = _zssd(anchor, wins).permute(2, 0, 1)            # (M, n_dv, 2r+1)
    m = c.shape[0]
    flatc = c.reshape(m, -1)
    best = torch.argmin(flatc, dim=-1)
    by = best // (2 * r + 1)
    bx = best % (2 * r + 1)
    # clamp to the interior so the parabolic neighbours exist
    bx_i = torch.clamp(bx, 1, 2 * r - 1)
    rows = torch.gather(c, 1, by[:, None, None].expand(-1, 1, c.shape[2]))[:, 0, :]
    cx0 = torch.gather(rows, 1, bx_i[:, None] - 1)[:, 0]
    cx1 = torch.gather(rows, 1, bx_i[:, None])[:, 0]
    cx2 = torch.gather(rows, 1, bx_i[:, None] + 1)[:, 0]
    du = bx_i.to(torch.float32) - r + _parabolic(cx0, cx1, cx2)
    if du_only:
        dv = torch.zeros_like(du)
    else:
        by_i = torch.clamp(by, 1, 2 * r - 1)
        cols = torch.gather(c, 2, bx_i[:, None, None].expand(-1, c.shape[1], 1))[:, :, 0]
        cy0 = torch.gather(cols, 1, by_i[:, None] - 1)[:, 0]
        cy1 = torch.gather(cols, 1, by_i[:, None])[:, 0]
        cy2 = torch.gather(cols, 1, by_i[:, None] + 1)[:, 0]
        dv = by_i.to(torch.float32) - r + _parabolic(cy0, cy1, cy2)
    # flat cost surface (textureless patch): keep the original position
    spread = flatc.amax(dim=-1) - flatc.amin(dim=-1)
    flat_ok = spread > 1e-3
    du = torch.where(flat_ok, du, 0.0)
    dv = torch.where(flat_ok, dv, 0.0)
    return uv + torch.stack([du, dv], dim=-1)


def _valid_first(valid: torch.Tensor, cap: int) -> torch.Tensor:
    """The first `cap` row indices with the valid rows first, in index order
    (`jnp.argsort(~valid, stable=True)[:cap]`)."""
    return torch.argsort((~valid).to(torch.int32), stable=True)[:cap]


def _pred_scale(uv: torch.Tensor, disp: torch.Tensor, T_pred: torch.Tensor,
                rig) -> torch.Tensor:
    """The predicted per-feature scale z_curr / z_prev of previous-frame
    patches at `uv` with disparity `disp` (positive) under the motion
    prior, clipped to [0.75, 1.3]: the anchor is resampled at it
    (forward-motion compensation)."""
    intr = rig.intr
    # as jitted XLA:CPU has it: / fx a multiply by its float32 reciprocal,
    # and the row of T_pred two FMAs over its first product, then + t
    z_p = true_div(intr.fx * rig.baseline_m, disp)
    x_p = (uv[:, 0] - intr.cx) * recip(intr.fx) * z_p
    y_p = (uv[:, 1] - intr.cy) * recip(intr.fy) * z_p
    z_c = fma(T_pred[2, 2], z_p, fma(T_pred[2, 0], x_p, T_pred[2, 1] * y_p))
    z_c = z_c + T_pred[2, 3]
    return torch.clamp(z_c / torch.clamp(z_p, min=0.5), 0.75, 1.3)


def refine_quad_subpix(q: QuadMatches, img_lp: torch.Tensor,
                       img_rp: torch.Tensor, img_lc: torch.Tensor,
                       img_rc: torch.Tensor, cfg: FrontendConfig,
                       T_pred: Optional[torch.Tensor] = None,
                       rig=None) -> QuadMatches:
    """Subpixel refinement of the quads' positions by patch correlation on
    the images, over the first refine_cap valid-compacted rows:

      rp <- 1-D u-search in img_rp, anchored to the lp patch;
      lc <- 2-D search in img_lc, anchored to the lp patch;
      rc <- 1-D u-search in img_rc, anchored to the refined lc patch.

    refine_mode="temporal" runs the lc leg only; the stereo partners keep
    their detector positions. With (T_pred, rig) the lc leg's anchor is
    resampled at the predicted per-feature scale."""
    half = cfg.refine_patch // 2
    r = cfg.refine_search
    cap = min(cfg.refine_cap, q.uv_lc.shape[0])
    order = _valid_first(q.valid, cap)
    temporal_only = cfg.refine_mode == "temporal"
    uv_lp, uv_rp0 = q.uv_lp[order], q.uv_rp[order]
    uv_lc0, uv_rc0 = q.uv_lc[order], q.uv_rc[order]

    if temporal_only:
        uv_rp = uv_rp0
    else:
        anchor_p = _bilinear_patches(img_lp, uv_lp, half)
        # rectified partners search along the row of their left anchor
        c_rp = torch.stack([uv_rp0[:, 0], uv_lp[:, 1]], dim=-1)
        uv_rp = _refine_leg(anchor_p, img_rp, c_rp, half, r, du_only=True)
    if T_pred is not None and rig is not None:
        disp = torch.clamp(uv_lp[:, 0] - uv_rp[:, 0], min=0.5)
        scale = _pred_scale(uv_lp, disp, T_pred, rig)
        anchor_t = _bilinear_patches(img_lp, uv_lp, half, scale=scale)
    elif temporal_only:
        anchor_t = _bilinear_patches(img_lp, uv_lp, half)
    else:
        anchor_t = anchor_p
    uv_lc = _refine_leg(anchor_t, img_lc, uv_lc0, half, r, du_only=False)
    if temporal_only:
        return q._replace(uv_lc=_set_rows(q.uv_lc, order, uv_lc))
    anchor_c = _bilinear_patches(img_lc, uv_lc, half)
    c_rc = torch.stack([uv_rc0[:, 0], uv_lc[:, 1]], dim=-1)
    uv_rc = _refine_leg(anchor_c, img_rc, c_rc, half, r, du_only=True)
    return q._replace(uv_rp=_set_rows(q.uv_rp, order, uv_rp),
                      uv_lc=_set_rows(q.uv_lc, order, uv_lc),
                      uv_rc=_set_rows(q.uv_rc, order, uv_rc))


def _set_rows(x: torch.Tensor, rows: torch.Tensor, val: torch.Tensor):
    """x.at[rows].set(val) out of place (rows are distinct)."""
    out = x.clone()
    out[rows] = val
    return out


def refine_temporal_subpix(img_prev: torch.Tensor, img_curr: torch.Tensor,
                           uv_prev: torch.Tensor, uv_curr: torch.Tensor,
                           valid: torch.Tensor, cfg: FrontendConfig,
                           disp_prev: Optional[torch.Tensor] = None,
                           T_pred: Optional[torch.Tensor] = None,
                           rig=None) -> torch.Tensor:
    """2D temporal-leg refinement for single-image sensors: anchor at the
    previous frame's position, correlate in the current frame; only the
    first refine_cap valid-compacted rows run. Returns refined uv_curr.

    With (disp_prev, T_pred, rig) the anchor is resampled at the predicted
    per-feature scale z_curr / z_prev (forward-motion compensation)."""
    m = uv_curr.shape[0]
    cap = min(cfg.refine_cap, m)
    order = _valid_first(valid, cap)
    half = cfg.refine_patch // 2
    if disp_prev is not None and T_pred is not None and rig is not None:
        uv_p = uv_prev[order]
        disp = torch.clamp(disp_prev[order], min=0.5)
        scale = _pred_scale(uv_p, disp, T_pred, rig)
        scale = torch.where(disp_prev[order] > 0.5, scale, 1.0)
        anchor = _bilinear_patches(img_prev, uv_p, half, scale=scale)
    else:
        anchor = _bilinear_patches(img_prev, uv_prev[order], half)
    ref = _refine_leg(anchor, img_curr, uv_curr[order], half,
                      cfg.refine_search, du_only=False)
    ref = torch.where(valid[order][:, None], ref, uv_curr[order])
    return _set_rows(uv_curr, order, ref)


def predict_uv(uv: torch.Tensor, disp: torch.Tensor, T_pred: torch.Tensor,
               fx: float, fy: float, cx: float, cy: float,
               baseline_m: float, right: bool = False):
    """Project previous features into the current frame under a motion
    prior. Returns (uv_pred (N, 2), ok (N,))."""
    ok = disp > 0.5
    d = torch.clamp(disp, min=0.5)
    z = true_div(fx * baseline_m, d)
    x = true_div(uv[:, 0] - cx, fx) * z
    y = true_div(uv[:, 1] - cy, fy) * z
    if right:
        x = x + baseline_m
    R = T_pred[:3, :3]
    t = T_pred[:3, 3]
    px = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0]
    py = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1]
    pz = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2]
    if right:
        px = px - baseline_m
    ok = ok & (pz > 0.1)
    zs = torch.clamp(pz, min=0.1)
    up = px / zs * fx + cx
    vp = py / zs * fy + cy
    return torch.stack([up, vp], dim=-1), ok


def match_temporal(a: Features, b: Features, cfg: FrontendConfig,
                   uv_pred_b: Optional[torch.Tensor] = None,
                   pred_ok_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Curr -> prev matches within the motion gate; (Na,) idx / -1. With a
    motion prior, admissible pairs are the union of the wide gate and a
    tight predictive_gate_px window around each prediction."""
    cost = _pair_cost(a, b)
    base_ok = (a.valid[:, None] & b.valid[None, :]
               & (a.cls[:, None] == b.cls[None, :]))
    du = a.uv[:, 0][:, None] - b.uv[:, 0][None, :]
    dv = a.uv[:, 1][:, None] - b.uv[:, 1][None, :]
    ok = (base_ok & (du.abs() <= cfg.match_radius_px)
          & (dv.abs() <= cfg.match_radius_px))
    if uv_pred_b is not None:
        dup = a.uv[:, 0][:, None] - uv_pred_b[:, 0][None, :]
        dvp = a.uv[:, 1][:, None] - uv_pred_b[:, 1][None, :]
        g = cfg.predictive_gate_px
        near = (dup.abs() <= g) & (dvp.abs() <= g)
        ok = ok | (base_ok & pred_ok_b[None, :] & near)
    return mutual_nn(torch.where(ok, cost, _INF))


def match_stereo(a: Features, b: Features,
                 cfg: FrontendConfig) -> torch.Tensor:
    """Left -> right matches along the epipolar band, disparity in
    [0, 256]; (Na,) idx / -1."""
    return mutual_nn(_gated_cost(a, b, 256.0, cfg.stereo_band_px,
                                 (0.0, 256.0)))


def stereo_disparities(a: Features, b: Features, m: torch.Tensor):
    """Per-feature disparity from the left <-> right mutual match `m`
    (`match_stereo(a, b, cfg)`; the VO passes quad_match's lc -> rc
    match): (disp_a, disp_b), aligned to each feature array, -1 where
    unmatched or not positive."""
    du = a.uv[:, 0] - b.uv[torch.clamp(m, min=0).long(), 0]
    ok = (m >= 0) & (du > 0)
    disp_a = torch.where(ok, du, -1.0)
    nb = b.uv.shape[0]
    # JAX: .at[tgt].set(disp_a, mode="drop") into nb + 1 slots; the
    # unmatched rows all write -1 into slot nb, which is cut off
    tgt = torch.where(ok, m, nb).long()
    disp_b = torch.full((nb + 1,), -1.0, device=du.device)
    return disp_a, disp_b.index_put_((tgt,), disp_a)[:nb]


def quad_match(left_curr: Features, right_curr: Features,
               left_prev: Features, right_prev: Features,
               cfg: FrontendConfig, disp_lp: Optional[torch.Tensor] = None,
               disp_rp: Optional[torch.Tensor] = None,
               T_pred: Optional[torch.Tensor] = None,
               rig=None) -> QuadMatches:
    """Circular consistency: lc -> rc -> rp -> lp must close on lc -> lp.
    With (disp_lp, disp_rp, T_pred, rig) the temporal legs also admit pairs
    near the motion prior's predictions."""
    n = left_curr.uv.shape[0]
    pred_lp = pred_rp = ok_lp = ok_rp = None
    if T_pred is not None and disp_lp is not None and rig is not None:
        intr = rig.intr
        pred_lp, ok_lp = predict_uv(left_prev.uv, disp_lp, T_pred, intr.fx,
                                    intr.fy, intr.cx, intr.cy, rig.baseline_m)
        pred_rp, ok_rp = predict_uv(right_prev.uv, disp_rp, T_pred, intr.fx,
                                    intr.fy, intr.cx, intr.cy, rig.baseline_m,
                                    right=True)

    i_rc = match_stereo(left_curr, right_curr, cfg)                 # lc -> rc
    m_rc_rp = match_temporal(right_curr, right_prev, cfg, pred_rp, ok_rp)
    m_rp_lp = mutual_nn(_gated_cost(right_prev, left_prev, 256.0,
                                    cfg.stereo_band_px, (-256.0, 0.0)))
    m_lc_lp = match_temporal(left_curr, left_prev, cfg, pred_lp, ok_lp)

    def follow(idx, m):
        return torch.where(idx >= 0, m[torch.clamp(idx, min=0).long()], -1)

    def take(f: Features, idx):
        return f.uv[torch.clamp(idx, min=0).long()]

    i_rp = follow(i_rc, m_rc_rp)
    i_lp = follow(i_rp, m_rp_lp)
    closes = (i_lp >= 0) & (i_lp == m_lc_lp)
    valid = closes & left_curr.valid & (i_rc >= 0) & (i_rp >= 0)
    return QuadMatches(
        idx_lc=torch.arange(n, dtype=torch.int32, device=left_curr.uv.device),
        idx_rc=i_rc, idx_lp=i_lp, idx_rp=i_rp,
        uv_lc=left_curr.uv, uv_rc=take(right_curr, i_rc),
        uv_lp=take(left_prev, i_lp), uv_rp=take(right_prev, i_rp),
        valid=valid)
