"""The pipeline's device programs (port of part of
denseslam_tpu/models/dense_slam.py): the fused-keyframe DB,
`fuse_keyframe` / `fuse_sequence`, and the throughput paths
`process_sequence` (stereo VO + keyframe-gated SGM + fusion) and
`process_sequence_rgbd`.

The JAX package donates map and DB to each step; here both are updated in
place and returned.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import SystemConfig
from ..device import resolve_device
from ..ops import features as feat_ops
from ..ops import ransac
from ..ops import stereo as stereo_ops
from ..ops import tsdf as tsdf_ops
from . import frontend as fe
from .backend import signature_device


class FusionDB(NamedTuple):
    """Ring buffer of fused keyframes — the de-fusion replay source.

    Quantized storage is mm depth + 8-bit gray, as in the JAX package
    (there u16 + u8). Depth is held as int32 here, because uint16 tensors
    do not support the indexing and casts the DB needs on every backend;
    io/convert.py casts at the boundary."""
    depth: torch.Tensor     # i32 mm (C, H, W)  (f32 m when not quantized)
    gray: torch.Tensor      # u8 (C, H, W)      (f32 when not quantized)
    T_fused: torch.Tensor   # f32 (C, 4, 4) pose used at fusion time
    frame_id: torch.Tensor  # i32 (C,) global frame number, -1 = empty
    valid: torch.Tensor     # bool (C,)
    head: torch.Tensor      # i32 () next write slot

    @property
    def quantized(self) -> bool:
        return self.depth.dtype == torch.int32


def make_fusion_db(cfg: SystemConfig, device=None) -> FusionDB:
    """Empty DB on `device` (None = the CUDA card; raises without one)."""
    dev = resolve_device(device)
    c = cfg.pipeline.fusion_db_capacity
    h, w = cfg.rig.intr.height, cfg.rig.intr.width
    quant = cfg.pipeline.fusion_db_quantized
    return FusionDB(
        depth=torch.zeros((c, h, w), dtype=torch.int32 if quant else torch.float32,
                          device=dev),
        gray=torch.zeros((c, h, w), dtype=torch.uint8 if quant else torch.float32,
                         device=dev),
        T_fused=torch.eye(4, dtype=torch.float32, device=dev).repeat(c, 1, 1),
        frame_id=torch.full((c,), -1, dtype=torch.int32, device=dev),
        valid=torch.zeros((c,), dtype=torch.bool, device=dev),
        head=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _depth_mm(depth: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(depth * 1e3), 0, 65535)


def db_quantize_depth(db: FusionDB, depth: torch.Tensor) -> torch.Tensor:
    """Depth as fusion must consume it for the DB replay to be exact:
    mm-rounded when the DB is quantized, identity otherwise."""
    if db.quantized:
        return _depth_mm(depth).to(torch.float32) * 1e-3
    return depth


def db_depth(db: FusionDB, slot) -> torch.Tensor:
    """Replay-side depth of a DB slot (dequantized)."""
    d = db.depth[slot]
    if db.quantized:
        return d.to(torch.float32) * 1e-3
    return d


def db_gray(db: FusionDB, slot) -> torch.Tensor:
    return db.gray[slot].to(torch.float32)


def db_push(db: FusionDB, depth, gray, T_wc, frame_id) -> FusionDB:
    """Record one fused frame at `head`, in place."""
    # a (1,) index tensor: indexing with the 0-d head would read it back
    # to the host
    i = db.head.long().reshape(1)
    if db.quantized:
        depth = _depth_mm(depth).to(torch.int32)
        # pack_gray truncates to int, so u8 truncation replays exactly
        gray = torch.clamp(gray, 0, 255).to(torch.uint8)
    db.depth.index_copy_(0, i, depth.to(db.depth.dtype)[None])
    db.gray.index_copy_(0, i, gray.to(db.gray.dtype)[None])
    db.T_fused.index_copy_(0, i, T_wc.to(db.T_fused.dtype)[None])
    db.frame_id.index_copy_(0, i, torch.as_tensor(
        frame_id, dtype=torch.int32, device=db.frame_id.device).reshape(1))
    db.valid.index_fill_(0, i, True)
    return db._replace(head=((db.head + 1) % db.depth.shape[0]).to(torch.int32))


def fuse_keyframe(m: tsdf_ops.MapState, db: FusionDB, depth, gray, T_wc,
                  frame_id, cfg: SystemConfig) -> Tuple[tsdf_ops.MapState, FusionDB]:
    """allocate -> integrate -> DB record -> slide-window / decay ->
    advance. In place on map and DB."""
    intr = cfg.rig.intr
    tc = cfg.tsdf
    if cfg.pipeline.bilateral_filter:
        raise NotImplementedError(
            "pipeline.bilateral_filter is not ported yet (ROADMAP.md Queue A, A8)")
    depth = db_quantize_depth(db, depth)
    color = tsdf_ops.pack_gray(gray) if tc.fuse_color else None
    m, slots, mask = tsdf_ops.allocate_for_frame(m, depth, T_wc, intr, tc)
    m = tsdf_ops.integrate(m, slots, mask, depth, color, T_wc, intr, tc)
    db = db_push(db, depth, gray, T_wc, frame_id)
    if cfg.slide_window.enabled and cfg.decay.enabled:
        m = tsdf_ops.decay_and_slide(
            m, cfg.decay.max_decay_weight, cfg.decay.min_decay_age,
            cfg.slide_window.max_age)
    elif cfg.slide_window.enabled:
        m = tsdf_ops.slide_window(m, cfg.slide_window.max_age)
    elif cfg.decay.enabled:
        m = tsdf_ops.decay(m, cfg.decay.max_decay_weight,
                           cfg.decay.min_decay_age)
    return tsdf_ops.advance_frame(m), db


def fuse_sequence(m: tsdf_ops.MapState, db: FusionDB, depths, grays, T_wcs,
                  frame_ids, cfg: SystemConfig):
    """Fuse a batch of keyframes (N, H, W) in order: the JAX version's
    `lax.scan` over the frame axis, as a Python loop."""
    for i in range(depths.shape[0]):
        m, db = fuse_keyframe(m, db, depths[i], grays[i], T_wcs[i],
                              frame_ids[i], cfg)
    return m, db


def _virtual_right_features(feats_l: feat_ops.Features,
                            disp: torch.Tensor) -> feat_ops.Features:
    """Virtual right-view features from per-feature (virtual) disparity:
    the RGB-D sensor's depth in the backend's stereo currency."""
    ok = disp > 0.5
    uv_r = feats_l.uv - torch.stack(
        [torch.clamp(disp, min=0.5), torch.zeros_like(disp)], dim=-1)
    return feats_l._replace(uv=uv_r, valid=feats_l.valid & ok)


def _stack_features(fs) -> feat_ops.Features:
    return feat_ops.Features(*(torch.stack(x) for x in zip(*fs)))


def _sequence_draws(draws: Optional[torch.Tensor],
                    generator: Optional[torch.Generator], n: int,
                    cfg: SystemConfig, dev) -> torch.Tensor:
    """(n, K, 3) RANSAC draws on `dev`: `draws`, or drawn from
    `generator`, all at once."""
    if draws is None:
        if generator is None:
            raise ValueError("a sequence needs `draws` or a torch.Generator")
        draws = torch.stack([ransac.draw_hypotheses(
            cfg.frontend.ransac_iters, generator) for _ in range(n)])
    return draws.to(dev)


def _frame_stats(vo: fe.VOOutput, is_kf: torch.Tensor,
                 fe_state: fe.FrontendState, feats_r: feat_ops.Features):
    return dict(T_wc=vo.T_wc, tracking_ok=vo.tracking_ok,
                num_inliers=vo.num_inliers, fused=is_kf,
                feats_l=fe_state.feats_l, feats_r=feats_r,
                sig=signature_device(fe_state.feats_l))


def _stack_stats(per_frame) -> dict:
    stats = {}
    for key in per_frame[0]:
        vals = [f[key] for f in per_frame]
        stats[key] = (_stack_features(vals)
                      if isinstance(vals[0], feat_ops.Features)
                      else torch.stack(vals))
    return stats


def process_sequence(fe_state: fe.FrontendState, m: tsdf_ops.MapState,
                     db: FusionDB, lefts: torch.Tensor, rights: torch.Tensor,
                     frame_ids: torch.Tensor, cfg: SystemConfig,
                     draws: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
    """Stereo throughput path: per frame `vo_step`, then, on keyframes
    where tracking holds, SGM depth of the pair (`compute_depth`: on the
    card kernel 2 three times and kernel 4 once) and `fuse_keyframe` of it
    with the left image as gray. lefts / rights (N, H, W), frame_ids (N,)
    int32; draws and generator as in `process_sequence_rgbd`.

    The JAX version is one `lax.scan` with a `lax.cond` on the keyframe
    test; here that test is the one value read back to the host per frame.

    Returns (fe_state, map, db, stats): stats hold T_wc, tracking_ok,
    num_inliers, fused, feats_l, feats_r and sig, stacked over frames."""
    draws = _sequence_draws(draws, generator, lefts.shape[0], cfg,
                            lefts.device)
    every = cfg.pipeline.keyframe_every
    per_frame = []
    for i in range(lefts.shape[0]):
        left, right, fid = lefts[i], rights[i], frame_ids[i]
        fe_state, vo = fe.vo_step(fe_state, left, right, cfg, raw=draws[i])
        is_kf = vo.tracking_ok & (torch.remainder(fid, every) == 0)
        if bool(is_kf):                  # the frame's one host read
            depth, _ = stereo_ops.compute_depth(left, right, cfg.rig,
                                                cfg.stereo)
            m, db = fuse_keyframe(m, db, depth, left, vo.T_wc, fid, cfg)
        per_frame.append(_frame_stats(vo, is_kf, fe_state, fe_state.feats_r))
    return fe_state, m, db, _stack_stats(per_frame)


def process_sequence_rgbd(fe_state: fe.FrontendState, m: tsdf_ops.MapState,
                          db: FusionDB, grays: torch.Tensor,
                          depths: torch.Tensor, frame_ids: torch.Tensor,
                          cfg: SystemConfig,
                          draws: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None):
    """RGB-D throughput path: per frame `rgbd_vo_step`, then, on keyframes
    where tracking holds, `fuse_keyframe` of the sensor depth (no stereo
    matcher runs). grays / depths (N, H, W), frame_ids (N,) int32.

    draws (N, K, 3) are the per-frame RANSAC draws; when None they are
    drawn, all at once, from `generator` (K = cfg.frontend.ransac_iters).
    Draws that are not on the frames' device are copied there once; a copy
    from the host waits for the card, so keep them (or the generator) on
    the card.

    Returns (fe_state, map, db, stats) as `process_sequence` does, with
    the virtual right-view features as feats_r."""
    draws = _sequence_draws(draws, generator, grays.shape[0], cfg,
                            grays.device)
    every = cfg.pipeline.keyframe_every
    per_frame = []
    for i in range(grays.shape[0]):
        g, d, fid = grays[i], depths[i], frame_ids[i]
        fe_state, vo = fe.rgbd_vo_step(fe_state, g, d, cfg, raw=draws[i])
        is_kf = vo.tracking_ok & (torch.remainder(fid, every) == 0)
        if bool(is_kf):                  # the frame's one host read
            m, db = fuse_keyframe(m, db, d, g, vo.T_wc, fid, cfg)
        per_frame.append(_frame_stats(
            vo, is_kf, fe_state,
            _virtual_right_features(fe_state.feats_l, fe_state.disp_l)))
    return fe_state, m, db, _stack_stats(per_frame)
