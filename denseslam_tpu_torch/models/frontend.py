"""Sparse VO frontend as a state machine (port of
denseslam_tpu/models/frontend.py): the state, `init_frontend`, the stereo
step `vo_step`, the RGB-D step `rgbd_vo_step` and the monocular step
`mono_vo_step`.

The state carries the RANSAC draws' threefry key (utils/threefry.py), as
the JAX state does: `init_frontend` makes `PRNGKey(seed)`, and each step
splits it once and draws its hypotheses from the second half, so the port
draws what the JAX package draws. The key lives on the host, whatever the
state's device; a step may be handed its draws (`raw`) instead, and still
splits the key. No function here reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import SystemConfig
from ..device import resolve_device
from ..ops import features as feat_ops
from ..ops import matching, mono, ransac
from ..utils import lie, threefry
from ..utils.numerics import fma_dot, sqrt, true_div


class FrontendState(NamedTuple):
    feats_l: feat_ops.Features   # previous-frame left features
    feats_r: feat_ops.Features   # previous-frame right features
    disp_l: torch.Tensor         # (N,) prev-left disparity, -1 invalid
    disp_r: torch.Tensor         # (N,) prev-right disparity, -1 invalid
    T_wc: torch.Tensor           # current camera-to-world estimate
    T_delta_prev: torch.Tensor   # last inter-frame motion
    initialized: torch.Tensor    # bool () has a previous frame
    prior_ok: torch.Tensor       # bool () last RANSAC succeeded
    key: torch.Tensor            # (2,) threefry key of the draws, on the host
    frame: torch.Tensor          # i32 () frame counter
    img_l: torch.Tensor          # (H, W) previous left image
    img_r: torch.Tensor          # (H, W) previous right image
    exposure: torch.Tensor       # f32 () exposure compensation


class VOOutput(NamedTuple):
    T_wc: torch.Tensor
    T_delta: torch.Tensor        # prev-cam -> curr-cam
    num_inliers: torch.Tensor
    num_quads: torch.Tensor
    tracking_ok: torch.Tensor    # bool ()
    flow_uv_prev: torch.Tensor   # (M, 2)
    flow_uv_curr: torch.Tensor   # (M, 2)
    flow_valid: torch.Tensor     # (M,)


def _empty_features(cfg: SystemConfig, dev) -> feat_ops.Features:
    n = cfg.frontend.max_features
    return feat_ops.Features(
        uv=torch.zeros((n, 2), dtype=torch.float32, device=dev),
        cls=torch.zeros((n,), dtype=torch.int32, device=dev),
        desc=torch.zeros((n, feat_ops.desc_dim(cfg.frontend)),
                         dtype=torch.float32, device=dev),
        score=torch.zeros((n,), dtype=torch.float32, device=dev),
        valid=torch.zeros((n,), dtype=torch.bool, device=dev),
    )


def init_frontend(cfg: SystemConfig, T_init: Optional[torch.Tensor] = None,
                  device=None, seed: int = 0) -> FrontendState:
    """Fresh state on `device` (None = the CUDA card; raises without one),
    its key `PRNGKey(seed)`."""
    dev = resolve_device(device)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    n = cfg.frontend.max_features
    h, w = cfg.rig.intr.height, cfg.rig.intr.width
    return FrontendState(
        feats_l=_empty_features(cfg, dev),
        feats_r=_empty_features(cfg, dev),
        disp_l=torch.full((n,), -1.0, device=dev),
        disp_r=torch.full((n,), -1.0, device=dev),
        T_wc=eye if T_init is None else T_init.to(dev, torch.float32),
        T_delta_prev=eye,
        initialized=torch.zeros((), dtype=torch.bool, device=dev),
        prior_ok=torch.zeros((), dtype=torch.bool, device=dev),
        key=threefry.prng_key(seed),
        frame=torch.zeros((), dtype=torch.int32, device=dev),
        img_l=torch.zeros((h, w), dtype=torch.float32, device=dev),
        img_r=torch.zeros((h, w), dtype=torch.float32, device=dev),
        exposure=torch.ones((), dtype=torch.float32, device=dev),
    )


def _split_draws(state: FrontendState, raw: Optional[torch.Tensor],
                 cfg: SystemConfig, dev, size: int = 3):
    """The step's `key, sub = split(state.key)` and its draws: `raw` when
    given, else `randint(sub, (K, size), 0, 2^31 - 1)` on `dev`."""
    key, sub = threefry.split(state.key)
    if raw is None:
        raw = ransac.draw_hypotheses(sub, cfg.frontend.ransac_iters, dev,
                                     size)
    return key, raw


def _advance(state: FrontendState, uv_prev: torch.Tensor,
             uv_curr: torch.Tensor, valid: torch.Tensor,
             res: ransac.VOResult, **new) -> Tuple[FrontendState, VOOutput]:
    """The steps' common tail: the RANSAC motion where it holds, else the
    constant-velocity fallback (identity on the first frame); the pose;
    the next state from `new` (feats_l, feats_r, disp_l, disp_r, key,
    img_l, img_r, exposure) and the output, whose flow is the matches
    uv_prev -> uv_curr where valid."""
    dev = state.T_wc.device
    use_est = state.initialized & res.ok
    T_delta = torch.where(use_est, res.T_delta, state.T_delta_prev)
    T_delta = torch.where(state.initialized, T_delta,
                          torch.eye(4, dtype=torch.float32, device=dev))
    # a chain of 4 FMAs an entry, as jitted XLA:CPU forms the 4x4 product
    # (a matmul goes to cuBLAS on the card and rounds otherwise)
    T_wc = fma_dot(state.T_wc[:, :, None], lie.inv_T(T_delta)[None, :, :],
                   dim=-2)
    new_state = FrontendState(
        T_wc=T_wc, T_delta_prev=T_delta,
        initialized=torch.ones((), dtype=torch.bool, device=dev),
        prior_ok=use_est, frame=(state.frame + 1).to(torch.int32), **new)
    out = VOOutput(
        T_wc=T_wc,
        T_delta=T_delta,
        num_inliers=res.num_inliers,
        num_quads=valid.to(torch.int32).sum().to(torch.int32),
        tracking_ok=use_est | ~state.initialized,
        flow_uv_prev=uv_prev,
        flow_uv_curr=uv_curr,
        flow_valid=valid & state.initialized,
    )
    return new_state, out


def vo_step(state: FrontendState, left: torch.Tensor, right: torch.Tensor,
            cfg: SystemConfig, raw: Optional[torch.Tensor] = None,
            budget_scale: Optional[float] = None
            ) -> Tuple[FrontendState, VOOutput]:
    """One frame of stereo VO: both images scaled by the running exposure,
    features of each, the circular quad match (gated around the motion
    prior while the last RANSAC held), flow consensus, subpixel refinement,
    the per-feature stereo disparities for the next frame's prior, RANSAC
    and the exposure update from this frame's matched patches. `raw`: the
    RANSAC draws (K, 3), else drawn from the state's key (see
    `_split_draws`); `budget_scale`: the
    PD controller's RANSAC budget (see `estimate_stereo_motion`)."""
    fc = cfg.frontend
    intr = cfg.rig.intr
    if fc.gain_normalization:
        left = left * state.exposure
        right = right * state.exposure
    f_lc = feat_ops.detect(left, fc)
    f_rc = feat_ops.detect(right, fc)
    f_lc = feat_ops.bucket(f_lc, intr.width, intr.height, fc)

    if fc.use_motion_prior_gate:
        # the tight predictive gate only while the prior is trusted
        trusted = state.initialized & state.prior_ok
        q = matching.quad_match(
            f_lc, f_rc, state.feats_l, state.feats_r, fc,
            disp_lp=torch.where(trusted, state.disp_l, -1.0),
            disp_rp=torch.where(trusted, state.disp_r, -1.0),
            T_pred=state.T_delta_prev, rig=cfg.rig)
    else:
        q = matching.quad_match(f_lc, f_rc, state.feats_l, state.feats_r, fc)
    q = matching.remove_outliers(q, fc)
    if fc.subpixel_refine:
        # frame 0's previous images are zeros, but no quad is valid then
        q = matching.refine_quad_subpix(q, state.img_l, state.img_r, left,
                                        right, fc, T_pred=state.T_delta_prev,
                                        rig=cfg.rig)
    if fc.use_motion_prior_gate:
        # q.idx_rc is quad_match's lc -> rc stereo match
        disp_lc, disp_rc = matching.stereo_disparities(f_lc, f_rc, q.idx_rc)
    else:
        disp_lc = torch.full((f_lc.uv.shape[0],), -1.0, device=left.device)
        disp_rc = disp_lc
    key, raw = _split_draws(state, raw, cfg, left.device)
    res = ransac.estimate_stereo_motion(q, cfg.rig, fc, raw=raw,
                                        T_init=state.T_delta_prev,
                                        budget_scale=budget_scale)

    exposure = state.exposure
    if fc.gain_normalization:
        # residual gain of this (compensated) frame against the previous
        g = matching.estimate_gain(state.img_l, left, q.uv_lp, q.uv_lc,
                                   q.valid & state.initialized)
        g = torch.clamp(g, 0.7, 1.4)
        exposure = torch.clamp(state.exposure / g, 0.25, 4.0)
    return _advance(state, q.uv_lp, q.uv_lc, q.valid, res, feats_l=f_lc,
                    feats_r=f_rc, disp_l=disp_lc, disp_r=disp_rc, key=key,
                    img_l=left, img_r=right, exposure=exposure)


def virtual_disparity(feats: feat_ops.Features, depth: torch.Tensor,
                      cfg: SystemConfig) -> torch.Tensor:
    """The disparity fx * B / Z each valid feature would have on the rig,
    Z the depth image's at its nearest pixel; -1 where Z <= 0.1 m."""
    intr = cfg.rig.intr
    ui = torch.clamp(torch.round(feats.uv[:, 0]).to(torch.int32), 0,
                     intr.width - 1)
    vi = torch.clamp(torch.round(feats.uv[:, 1]).to(torch.int32), 0,
                     intr.height - 1)
    z = depth.reshape(-1)[(vi * intr.width + ui).long()]
    return torch.where(feats.valid & (z > 0.1),
                       true_div(intr.fx * cfg.rig.baseline_m,
                                torch.clamp(z, min=0.1)), -1.0)


def rgbd_vo_step(state: FrontendState, gray: torch.Tensor,
                 depth: torch.Tensor, cfg: SystemConfig,
                 raw: Optional[torch.Tensor] = None
                 ) -> Tuple[FrontendState, VOOutput]:
    """One frame of RGB-D VO: the depth image synthesises virtual right-view
    observations (disparity = fx * B / Z at each feature), so temporal
    matching, flow consensus and the 4-way-reprojection RANSAC run as on
    the stereo quad problem. `raw`: the RANSAC draws, as in `vo_step`."""
    fc = cfg.frontend
    intr = cfg.rig.intr
    f_lc = feat_ops.detect(gray, fc)
    f_lc = feat_ops.bucket(f_lc, intr.width, intr.height, fc)

    disp_lc = virtual_disparity(f_lc, depth, cfg)

    if fc.use_motion_prior_gate:
        trusted = state.initialized & state.prior_ok
        pred, pok = matching.predict_uv(
            state.feats_l.uv, torch.where(trusted, state.disp_l, -1.0),
            state.T_delta_prev, intr.fx, intr.fy, intr.cx, intr.cy,
            cfg.rig.baseline_m)
        m = matching.match_temporal(f_lc, state.feats_l, fc, pred, pok)
    else:
        m = matching.match_temporal(f_lc, state.feats_l, fc)

    n = f_lc.uv.shape[0]
    i_lc = torch.arange(n, dtype=torch.int32, device=gray.device)
    ok = (m >= 0) & f_lc.valid & (disp_lc > 0.5)
    mi = torch.clamp(m, min=0).long()
    disp_lp = state.disp_l[mi]
    ok = ok & (disp_lp > 0.5)
    uv_lp = state.feats_l.uv[mi]
    uv_lc_m = f_lc.uv
    if fc.subpixel_refine:
        # temporal leg only: the right views are virtual
        uv_lc_m = matching.refine_temporal_subpix(
            state.img_l, gray, uv_lp, f_lc.uv, ok, fc,
            disp_prev=disp_lp, T_pred=state.T_delta_prev, rig=cfg.rig)
    zc = torch.zeros_like(disp_lc)
    q = matching.QuadMatches(
        idx_lc=i_lc, idx_rc=i_lc, idx_lp=m, idx_rp=m,
        uv_lc=uv_lc_m,
        uv_rc=uv_lc_m - torch.stack([disp_lc, zc], dim=-1),
        uv_lp=uv_lp,
        uv_rp=uv_lp - torch.stack([disp_lp, zc], dim=-1),
        valid=ok,
    )
    q = matching.remove_outliers(q, fc)
    key, raw = _split_draws(state, raw, cfg, gray.device)
    res = ransac.estimate_stereo_motion(q, cfg.rig, fc, raw=raw,
                                        T_init=state.T_delta_prev)
    return _advance(state, q.uv_lp, q.uv_lc, q.valid, res, feats_l=f_lc,
                    feats_r=state.feats_r, disp_l=disp_lc,
                    disp_r=state.disp_r, key=key, img_l=gray,
                    img_r=state.img_r, exposure=state.exposure)


def mono_vo_step(state: FrontendState, left: torch.Tensor,
                 cfg: SystemConfig, raw: Optional[torch.Tensor] = None
                 ) -> Tuple[FrontendState, VOOutput]:
    """One frame of monocular VO: features of the image, temporal matching
    against the previous frame's, subpixel refinement of the temporal leg,
    flow consensus, 8-point RANSAC (`raw` (K, 8): its draws, else drawn
    from the state's key, see ops/mono.py) and the ground-plane metric
    scale. Where the ground gives no scale, the previous frame's speed is
    kept (1 on the first motion). The right features and disparities stay
    as they are.

    Inherited from the JAX package (denseslam_tpu/config.py
    `refine_cap`): the refinement runs before consensus, on the first
    refine_cap valid rows, a cap sized for the stereo quads; matches past
    it keep their detector positions."""
    fc = cfg.frontend
    intr = cfg.rig.intr
    f_lc = feat_ops.detect(left, fc)
    f_lc = feat_ops.bucket(f_lc, intr.width, intr.height, fc)

    m = matching.match_temporal(f_lc, state.feats_l, fc)      # curr -> prev
    valid = (m >= 0) & f_lc.valid
    uv_prev = state.feats_l.uv[torch.clamp(m, min=0).long()]
    uv_curr = f_lc.uv
    if fc.subpixel_refine:
        uv_curr = matching.refine_temporal_subpix(
            state.img_l, left, uv_prev, uv_curr, valid, fc)
    if fc.outlier_removal:
        valid = matching.flow_consensus(
            uv_curr, uv_curr[:, 0] - uv_prev[:, 0],
            uv_curr[:, 1] - uv_prev[:, 1], None, valid, k=fc.outlier_knn,
            tol_flow=fc.outlier_flow_tol_px, tol_disp=fc.outlier_disp_tol_px,
            min_support=fc.outlier_min_support)

    key, raw = _split_draws(state, raw, cfg, left.device, size=8)
    res = mono.estimate_mono_motion(uv_prev, uv_curr, valid, intr, fc,
                                    raw=raw)
    sc = mono.estimate_scale_ground(res.T_delta, uv_prev, uv_curr,
                                    res.inliers, intr, fc.camera_height_m,
                                    fc.camera_pitch_rad)
    t_prev = state.T_delta_prev[:3, 3]
    prev_speed = sqrt((t_prev * t_prev).sum())
    scale_fb = torch.where(state.initialized & (prev_speed > 1e-6),
                           prev_speed, 1.0)
    T_est = mono.apply_scale(res.T_delta,
                             torch.where(sc.ok, sc.scale, scale_fb))
    return _advance(state, uv_prev, uv_curr, valid,
                    res._replace(T_delta=T_est), feats_l=f_lc,
                    feats_r=state.feats_r, disp_l=state.disp_l,
                    disp_r=state.disp_r, key=key, img_l=left,
                    img_r=state.img_r,
                    exposure=state.exposure)
