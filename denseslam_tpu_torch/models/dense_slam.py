"""The dense pipeline (port of part of denseslam_tpu/models/dense_slam.py):
the fused-keyframe DB, depth post-processing, `fuse_keyframe` /
`fuse_sequence`, the throughput paths `process_sequence` (stereo VO +
keyframe-gated SGM + fusion), `process_sequence_rgbd` and
`process_sequence_mono`, online correction (`online_correction`,
`online_correction_delta`, `purge_culled`), the `SubmapManager` (submaps
with estimated global poses, host swapping under a memory budget,
deferred corrections) and the host-side `DenseSLAM`: the per-frame
`process_frame` (stereo, RGB-D or mono VO, or ICP against a render of
the map), the renderers behind `raycast_view` and `raycast_composite`,
the mesh export `save_mesh`, the raycast dumps `save_raycast_depth` /
`save_raycast_rgb`, and what the chunk path of models/system.py uses.

The JAX package donates map and DB to each step; here both are updated in
place and returned. Where the JAX version branches on a device value
inside a program (`lax.cond` per DB slot), the port reads the values the
branch needs back to the host once and loops there.
"""

from __future__ import annotations

import dataclasses
import warnings
from functools import partial
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import SystemConfig
from ..device import resolve_device
from ..io import png
from ..ops import features as feat_ops
from ..ops import hash as vhash
from ..ops import icp as icp_ops
from ..ops import meshing
from ..ops import posegraph
from ..ops import ransac
from ..ops import raycast as rc_ops
from ..ops import splat as splat_ops
from ..ops import stereo as stereo_ops
from ..ops import tsdf as tsdf_ops
from ..utils import lie, threefry
from ..utils.camera import backproject, project
from ..utils.image import (bilateral_filter_depth, depth_bilinear_sample,
                           rgb_to_gray)
from ..utils.timing import TIMERS
from . import frontend as fe
from .backend import _stack_features, signature_device, upload


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


def depth_postprocess(depth_curr: torch.Tensor, T_curr: torch.Tensor,
                      depth_prev: torch.Tensor, T_prev: torch.Tensor,
                      cfg: SystemConfig) -> torch.Tensor:
    """Cross-frame consistency cull: zero the pixels of depth_curr, in the
    lower `filter_area` of the image, whose depth seen from the previous
    fused frame differs from that frame's (edge-aware bilinear) depth by
    more than `filter_threshold` relative."""
    intr = cfg.rig.intr
    pp = cfg.postprocess
    pts_c = backproject(depth_curr, intr)
    T_rel = lie.inv_T(T_prev) @ T_curr
    pts_p = lie.transform_points(T_rel, pts_c.reshape(-1, 3)).reshape(
        pts_c.shape)
    uv, z = project(pts_p, intr)
    d_prev, ok = depth_bilinear_sample(depth_prev, uv, max_gap_m=0.3)
    rel = (d_prev - z).abs() / torch.clamp(z, min=1e-3)
    disagree = ok & (z > 0) & (rel > pp.filter_threshold)
    h = depth_curr.shape[0]
    rows = torch.arange(h, device=depth_curr.device)[:, None]
    in_area = rows >= int(h * (1.0 - pp.filter_area))
    return torch.where(disagree & in_area, 0.0, depth_curr)


def fuse_keyframe(m: tsdf_ops.MapState, db: FusionDB, depth, gray, T_wc,
                  frame_id, cfg: SystemConfig) -> Tuple[tsdf_ops.MapState, FusionDB]:
    """(bilateral filter ->) allocate -> integrate -> DB record ->
    slide-window / decay -> advance. In place on map and DB."""
    intr = cfg.rig.intr
    tc = cfg.tsdf
    if cfg.pipeline.bilateral_filter:
        depth = bilateral_filter_depth(depth)
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


def _sequence_draws(draws: Optional[torch.Tensor],
                    fe_state: fe.FrontendState, n: int, cfg: SystemConfig,
                    dev, size: int = 3) -> torch.Tensor:
    """(n, K, size) RANSAC draws on `dev` (size 8 for mono): `draws`, or
    the draws the frontend's key makes on the next n steps (each step
    splits it once and draws from the second half), made on the host and
    copied once."""
    if draws is None:
        key, out = fe_state.key, []
        for _ in range(n):
            key, sub = threefry.split(key)
            out.append(ransac.draw_hypotheses(
                sub, cfg.frontend.ransac_iters, size=size))
        draws = torch.stack(out)
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
                     draws: Optional[torch.Tensor] = None):
    """Stereo throughput path: per frame `vo_step`, then, on keyframes
    where tracking holds, SGM depth of the pair (`compute_depth`: on the
    card kernel 2 three times and kernel 4 once) and `fuse_keyframe` of it
    with the left image as gray. lefts / rights (N, H, W), frame_ids (N,)
    int32; draws as in `process_sequence_rgbd`.

    The JAX version is one `lax.scan` with a `lax.cond` on the keyframe
    test; here that test is the one value read back to the host per frame.

    Returns (fe_state, map, db, stats): stats hold T_wc, tracking_ok,
    num_inliers, fused, feats_l, feats_r and sig, stacked over frames."""
    draws = _sequence_draws(draws, fe_state, lefts.shape[0], cfg,
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
                          draws: Optional[torch.Tensor] = None):
    """RGB-D throughput path: per frame `rgbd_vo_step`, then, on keyframes
    where tracking holds, `fuse_keyframe` of the sensor depth (no stereo
    matcher runs). grays / depths (N, H, W), frame_ids (N,) int32.

    draws (N, K, 3) are the per-frame RANSAC draws; when None they are
    the ones the frontend state's key makes, as in the JAX scan (K =
    cfg.frontend.ransac_iters). Draws that are not on the frames' device
    are copied there once. The key advances one split a frame either
    way.

    Returns (fe_state, map, db, stats) as `process_sequence` does, with
    the virtual right-view features as feats_r."""
    draws = _sequence_draws(draws, fe_state, grays.shape[0], cfg,
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


def process_sequence_mono(fe_state: fe.FrontendState, m: tsdf_ops.MapState,
                          db: FusionDB, grays: torch.Tensor,
                          depths: torch.Tensor, frame_ids: torch.Tensor,
                          cfg: SystemConfig,
                          draws: Optional[torch.Tensor] = None):
    """Monocular throughput path: per frame `mono_vo_step` (8-point RANSAC
    and the ground-plane scale; the depth never feeds the estimator), then,
    on keyframes where tracking holds, `fuse_keyframe` of the SUPPLIED
    depth. The backend's stereo currency is a virtual disparity sampled
    from that depth at the feature positions (feats_r). grays / depths
    (N, H, W), frame_ids (N,) int32; draws (N, K, 8), or drawn from the
    state's key as `process_sequence_rgbd` does.

    Returns (fe_state, map, db, stats) as `process_sequence` does."""
    draws = _sequence_draws(draws, fe_state, grays.shape[0], cfg,
                            grays.device, size=8)
    every = cfg.pipeline.keyframe_every
    per_frame = []
    for i in range(grays.shape[0]):
        g, d, fid = grays[i], depths[i], frame_ids[i]
        fe_state, vo = fe.mono_vo_step(fe_state, g, cfg, raw=draws[i])
        is_kf = vo.tracking_ok & (torch.remainder(fid, every) == 0)
        if bool(is_kf):                  # the frame's one host read
            m, db = fuse_keyframe(m, db, d, g, vo.T_wc, fid, cfg)
        f_l = fe_state.feats_l
        per_frame.append(_frame_stats(vo, is_kf, fe_state,
                                      _virtual_right_features(
                                          f_l, fe.virtual_disparity(
                                              f_l, d, cfg))))
    return fe_state, m, db, _stack_stats(per_frame)


# ---------------------------------------------------------------------------
# Online correction
# ---------------------------------------------------------------------------

def _topk_slots(scores: torch.Tensor, k: int):
    """The k highest-scoring slots, ties to the lower index as lax.top_k
    breaks them, and their scores, read back in one transfer."""
    idx = torch.sort(scores, descending=True, stable=True).indices[:k]
    h = torch.stack([idx.to(torch.float32), scores[idx]]).cpu().numpy()
    return [int(i) for i in h[0]], h[1]


def _replay(m: tsdf_ops.MapState, db: FusionDB, slot: int,
            T_new: Optional[torch.Tensor], cfg: SystemConfig,
            key_filter=None, tsdf_cfg=None):
    """De-integrate DB slot `slot`'s frame at the pose it was fused at and,
    given T_new, re-integrate it there. In place; returns the map."""
    intr = cfg.rig.intr
    tc = tsdf_cfg if tsdf_cfg is not None else cfg.tsdf
    depth = db_depth(db, slot)
    color = tsdf_ops.pack_gray(db_gray(db, slot))
    T_old = db.T_fused[slot]
    m, s, k = tsdf_ops.allocate_for_frame(m, depth, T_old, intr, tc,
                                          key_filter=key_filter)
    m = tsdf_ops.deintegrate(m, s, k, depth, color, T_old, intr, tc)
    if T_new is not None:
        m, s, k = tsdf_ops.allocate_for_frame(m, depth, T_new, intr, tc,
                                              key_filter=key_filter)
        m = tsdf_ops.integrate(m, s, k, depth, color, T_new, intr, tc)
    return m


def online_correction(m: tsdf_ops.MapState, db: FusionDB,
                      opt_T: torch.Tensor, opt_valid: torch.Tensor,
                      cfg: SystemConfig, key_filter=None, tsdf_cfg=None):
    """De-fuse / re-fuse the worst-drift fused keyframes: score each DB
    slot's fused pose against its optimised pose `opt_T` (C, 4, 4) where
    `opt_valid` (C,); when at least start_correction_num slots drift past
    min_error, replay up to correction_num of them, worst first, then run
    the defusion-part GC. In place on map and DB; returns (map, db,
    number re-fused).

    key_filter / tsdf_cfg: the sharded map's ownership seam. Each rank
    replays only the blocks it owns, into its local table; the scoring
    reads only the DB, which every rank holds whole, so the ranks agree
    on which frames to replay without a message."""
    oc = cfg.correction
    err = lie.pose_error_weighted(db.T_fused, opt_T)
    stale = db.valid & opt_valid & (err > oc.min_error)
    do_correct = stale.to(torch.int32).sum() >= oc.start_correction_num
    scores = torch.where(stale & do_correct, err, -1.0)
    slots, worst = _topk_slots(scores, oc.correction_num)
    num = 0
    for slot, score in zip(slots, worst):
        if score > 0.0:
            m = _replay(m, db, slot, opt_T[slot], cfg, key_filter,
                        tsdf_cfg)
            db.T_fused[slot] = opt_T[slot]
            num += 1
    if num:
        # the replay's own GC: reclaim the blocks it emptied and evict stale
        # low-weight leftovers at the old poses
        if cfg.decay.enabled:
            m = tsdf_ops.decay_defusion_part(m)
        if cfg.slide_window.enabled:
            m = tsdf_ops.slide_window_defusion_part(
                m, cfg.slide_window.max_age)
    return m, db, num


def purge_culled(m: tsdf_ops.MapState, db: FusionDB, culled: torch.Tensor,
                 cfg: SystemConfig, key_filter=None, tsdf_cfg=None):
    """De-fuse the DB entries whose keyframe the backend culled (C,) and
    drop them, up to correction_num per call. In place; returns (map, db).
    key_filter / tsdf_cfg: the ownership seam (see online_correction)."""
    scores = torch.where(db.valid & culled, 1.0, -1.0)
    slots, run = _topk_slots(scores, cfg.correction.correction_num)
    for slot, score in zip(slots, run):
        if score > 0.0:
            m = _replay(m, db, slot, None, cfg, key_filter, tsdf_cfg)
            db.valid[slot] = False
            db.frame_id[slot] = -1
    return m, db


# ---------------------------------------------------------------------------
# Submaps and the host-side pipeline
# ---------------------------------------------------------------------------

def online_correction_delta(m: tsdf_ops.MapState, db: FusionDB,
                            opt_T: torch.Tensor, opt_valid: torch.Tensor,
                            cfg: SystemConfig, key_filter=None,
                            tsdf_cfg=None):
    """`online_correction` plus the mask (S,) of pool rows whose content it
    changed, found by comparing the pool before and after: it covers every
    mutation, the replay and its GC alike, and feeds the delta respill.
    The correction works in place, so the keys and the tsdf, weight and
    colour planes are copied first (about 0.8 GB at the drive's pool).
    The alloc_frame / last_seen stamps are left out: they change on every
    visible slot of every replayed frame, and folding them in would make
    the delta most of the pool. key_filter / tsdf_cfg as in
    `online_correction`."""
    before = (m.table.keys.clone(), m.tsdf.clone(), m.weight.clone(),
              m.color.clone())
    m, db, num = online_correction(m, db, opt_T, opt_valid, cfg, key_filter,
                                   tsdf_cfg)
    changed = ((m.table.keys != before[0])
               | (m.tsdf != before[1]).any(dim=-1)
               | (m.weight != before[2]).any(dim=-1)
               | (m.color != before[3]).any(dim=-1))
    return m, db, num, changed


def _composite_transform(rc: rc_ops.Raycast,
                         D: torch.Tensor) -> rc_ops.Raycast:
    """Map a submap render's points and normals through its alignment
    delta D (4, 4)."""
    pts = lie.transform_points(D, rc.points.reshape(-1, 3)).reshape(
        rc.points.shape)
    pts = torch.where(rc.mask[..., None], pts, 0.0)
    nrm = (rc.normals.reshape(-1, 3) @ D[:3, :3].T).reshape(rc.normals.shape)
    return rc._replace(points=pts, normals=nrm)


def _composite_merge(best: rc_ops.Raycast, rc: rc_ops.Raycast,
                     D: torch.Tensor) -> rc_ops.Raycast:
    """Delta-transform `rc` and merge it into `best` by minimum depth."""
    rc = _composite_transform(rc, D)
    closer = rc.mask & (~best.mask | (rc.depth < best.depth))
    return rc_ops.Raycast(
        depth=torch.where(closer, rc.depth, best.depth),
        points=torch.where(closer[..., None], rc.points, best.points),
        normals=torch.where(closer[..., None], rc.normals, best.normals),
        mask=best.mask | rc.mask,
        color=torch.where(closer[..., None], rc.color, best.color),
    )


def _map_leaves(m: tsdf_ops.MapState) -> List[torch.Tensor]:
    return [m.table.keys] + [getattr(m, f) for f in m._fields[1:]]


def copy_map(m: tsdf_ops.MapState, device) -> tsdf_ops.MapState:
    """A copy of map `m` on `device` that shares no storage with it (on the
    CPU, `.to("cpu")` would return the tensor itself)."""
    return m._replace(
        table=vhash.HashTable(keys=m.table.keys.to(device, copy=True)),
        **{f: getattr(m, f).to(device, copy=True) for f in m._fields[1:]})


def copy_db(db: FusionDB, device) -> FusionDB:
    """A copy of fusion DB `db` on `device` that shares no storage with it."""
    return FusionDB(*(t.to(device, copy=True) for t in db))


def _pose_np(T) -> np.ndarray:
    """A (4, 4) pose, tensor or array, as a float32 numpy array."""
    if isinstance(T, torch.Tensor):
        return T.detach().to("cpu", torch.float32).numpy()
    return np.asarray(T, np.float32)


def _pad_rows(a: torch.Tensor, slots: torch.Tensor, npad: int, fill):
    """The rows `slots` (n,) of host tensor `a`, then rows of `fill` up to
    npad."""
    out = torch.full((npad,) + tuple(a.shape[1:]), fill, dtype=a.dtype)
    out[:slots.numel()] = a[slots]
    return out


def _expand_rows(rows, slots: torch.Tensor, s: int, frame, decayed,
                 overflow) -> tsdf_ops.MapState:
    """The full host pool of S slots from compact host rows: row i of each
    plane into slot slots[i], free space elsewhere (the ordinary MapState
    that every consumer reads)."""
    n = slots.numel()
    bv = tsdf_ops.BLOCK_VOL
    full = tsdf_ops.MapState(
        table=vhash.HashTable(keys=torch.full((s,), vhash.EMPTY_KEY,
                                              dtype=torch.int32)),
        tsdf=torch.ones((s, bv), dtype=rows[1].dtype),
        weight=torch.zeros((s, bv), dtype=rows[2].dtype),
        color=torch.zeros((s, bv), dtype=torch.int32),
        alloc_frame=torch.zeros((s,), dtype=torch.int32),
        last_seen=torch.zeros((s,), dtype=torch.int32),
        frame=frame, decayed_blocks=decayed, overflow=overflow)
    for plane, r in zip(_map_leaves(full)[:6], rows):
        plane[slots] = r[:n]
    return full


class SubmapManager:
    """Registry of the submaps (reference surface: createNewLocalMap /
    setEstimatedGlobalPose / getLocalMap / numLocalMaps), each with its
    own map and fusion DB, on `device` or spilled to the host.

    Per submap: `spawn_poses[i]`, the camera pose at spawn (a record);
    `global_poses[i]`, its current estimated global anchor pose, moved by
    the inter-submap pose graph (`optimize_alignment`), so that
    `delta(i) = global_poses[i] @ inv(spawn_poses[i])` is the rigid
    correction of its content at composite-render time; `anchor_frames[i]`,
    the frame it was spawned at; `pending_corrections[i]`, frame id ->
    (latest optimised pose, its drift): corrections deferred while the
    submap is inactive (replay de-fuses at the DB's fused pose, so only a
    frame's latest pose matters); `dirty[i]`: its device content changed
    since its last restore.

    Swapping (ITMSwappingEngine::SaveToGlobalMemory): a spilled submap's
    map and DB are CPU tensors, and `is_on_host` reads an explicit flag,
    because on the CPU a tensor's device cannot tell host from device.
    Host and device copies never share storage: every evict and restore
    copies. A restore keeps the host copy as a clean cache, so an
    untouched submap evicts for free, and `mark_dirty(changed_slots=...)`
    keeps it and re-sends only those rows (the delta respill). Transfers
    cross in the compact form of `gather_block_rows`, padded to a multiple
    of `_SPILL_GRAN` rows; a pool whose rows pad to all S slots crosses
    whole."""

    _SPILL_GRAN = 4096          # row-count bucket of a compacted transfer

    def __init__(self, cfg: SystemConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._copy_stream = None
        self.num_evictions = 0
        self.num_restores = 0
        self.num_ghost_renders = 0
        self.num_delta_spills = 0
        self.num_async_spills = 0
        # parallel/sharded_map.py ShardedTsdf of a sharded active map
        self.sharded = None
        self._reset()
        self.create_new(np.eye(4, dtype=np.float32), anchor_frame_id=0)

    def _reset(self) -> None:
        """Empty the registry (state loading rebuilds it)."""
        self.maps: List[tsdf_ops.MapState] = []
        self.dbs: List[FusionDB] = []
        self.global_poses: List[np.ndarray] = []
        self.spawn_poses: List[np.ndarray] = []
        self.anchor_frames: List[int] = []
        self.pending_corrections: List[dict] = []
        self.dirty: List[bool] = []
        self._on_host: List[bool] = []
        # the clean-restore cache: (host map, host db) kept after a restore
        self._spill_cache: List[Optional[tuple]] = []
        # the rows changed since that restore (delta respill), or None
        self._delta_rows: List[Optional[np.ndarray]] = []
        # idx -> async spill in flight: (host tensors, event, slots, S)
        self._inflight: dict = {}

    def _append(self, m: tsdf_ops.MapState, db: FusionDB, T_global, T_spawn,
                anchor_frame_id: int, on_host: bool) -> int:
        self.maps.append(m)
        self.dbs.append(db)
        self.global_poses.append(np.asarray(T_global))
        self.spawn_poses.append(np.asarray(T_spawn))
        self.anchor_frames.append(int(anchor_frame_id))
        self.pending_corrections.append({})
        self.dirty.append(True)
        self._on_host.append(bool(on_host))
        self._spill_cache.append(None)
        self._delta_rows.append(None)
        return len(self.maps) - 1

    def create_new(self, T_global, anchor_frame_id: int = -1,
                   map_state: Optional[tsdf_ops.MapState] = None,
                   async_spill: bool = False, enforce: bool = True) -> int:
        """A fresh submap (map and DB on the device) anchored at
        `T_global`, now the active one; `map_state` replaces the fresh
        pool (a sharded DenseSLAM spawns a fresh shard). A spawn is when
        the device footprint grows by a pool and a DB, so the budget is
        checked, unless `enforce` is False (the chunk path enforces after
        its tick, so that no spill queues behind the tick). Returns its
        index."""
        T = _pose_np(T_global)
        m = (map_state if map_state is not None
             else tsdf_ops.make_map(self.cfg.tsdf, self.device))
        idx = self._append(m, make_fusion_db(self.cfg, self.device), T, T,
                           anchor_frame_id, on_host=False)
        if enforce:
            self.enforce_memory_budget(async_spill=async_spill)
        return idx

    def delta(self, idx: int) -> np.ndarray:
        """Rigid correction of submap `idx`'s content: the optimised anchor
        pose relative to the spawn-time anchor pose."""
        G = torch.tensor(np.asarray(self.global_poses[idx], np.float32))
        S = torch.tensor(np.asarray(self.spawn_poses[idx], np.float32))
        return (G @ lie.inv_T(S)).numpy()

    def optimize_alignment(self, anchor_meas: dict) -> None:
        """Relax every submap's global pose against (a) optimised anchor
        poses from the backend (`anchor_meas`: submap idx -> (4, 4)),
        weight 5, and (b) the spawn-chain odometry between consecutive
        submaps, weight 0.5, only where one of the two lacks an anchor
        measurement (the chain holds the drift the anchors correct). Node 0
        is the fixed world anchor and submap i node i + 1, in a graph of
        the backend's caps, as the loop-closure graph has."""
        s = len(self.maps)
        if s == 0 or (not anchor_meas and s < 2):
            return
        edges = [(0, idx + 1, np.asarray(T, np.float32), 5.0)
                 for idx, T in anchor_meas.items()]
        for i in range(s - 1):
            if i in anchor_meas and (i + 1) in anchor_meas:
                continue
            Si, Sj = (torch.tensor(np.asarray(self.spawn_poses[k],
                                              np.float32))
                      for k in (i, i + 1))
            edges.append((i + 1, i + 2, (lie.inv_T(Si) @ Sj).numpy(), 0.5))
        if not edges:
            return
        dev = self.device
        g = posegraph.make_graph(self.cfg.backend, dev)
        n, e = s + 1, len(edges)
        poses = np.stack([np.eye(4, dtype=np.float32)]
                         + [np.asarray(p, np.float32)
                            for p in self.global_poses])
        T_wc, valid = g.T_wc.clone(), g.node_valid.clone()
        T_wc[:n] = upload(poses, dev)
        valid[:n] = True
        ei, ej, T_ij, w = (g.edge_i.clone(), g.edge_j.clone(),
                           g.T_ij.clone(), g.edge_weight.clone())
        ei[:e] = upload(np.array([x[0] for x in edges], np.int64), dev)
        ej[:e] = upload(np.array([x[1] for x in edges], np.int64), dev)
        T_ij[:e] = upload(np.stack([x[2] for x in edges]), dev)
        w[:e] = upload(np.array([x[3] for x in edges], np.float32), dev)
        g = posegraph.optimize(
            g._replace(T_wc=T_wc, node_valid=valid, edge_i=ei, edge_j=ej,
                       T_ij=T_ij, edge_weight=w), self.cfg.backend)
        opt = g.T_wc[1:n].cpu().numpy()
        for i in range(s):
            self.global_poses[i] = opt[i]

    @property
    def num_local_maps(self) -> int:
        return len(self.maps)

    @property
    def active_idx(self) -> int:
        return len(self.maps) - 1

    @property
    def active(self) -> tsdf_ops.MapState:
        return self.maps[-1]

    @active.setter
    def active(self, m: tsdf_ops.MapState) -> None:
        self.maps[-1] = m

    def set_estimated_global_pose(self, idx: int, T: np.ndarray) -> None:
        self.global_poses[idx] = np.asarray(T)

    # -- host spill ------------------------------------------------------

    def _npad(self, n: int, s: int) -> int:
        g = self._SPILL_GRAN
        return min(((max(n, 1) + g - 1) // g) * g, s)

    @staticmethod
    def _alloc_slots(m: tsdf_ops.MapState) -> torch.Tensor:
        """The allocated slots of `m`, ascending, as CPU int64 (the keys
        are read back once)."""
        keys = m.table.keys.to("cpu")
        return torch.nonzero(keys != vhash.EMPTY_KEY).flatten()

    @staticmethod
    def _gather(m: tsdf_ops.MapState, slots: torch.Tensor, npad: int):
        """`gather_block_rows` of `m`, on its device, at `slots` padded to
        npad rows (the pad rows read slot 0)."""
        pad = torch.zeros((npad,), dtype=torch.int64)
        pad[:slots.numel()] = slots
        return tsdf_ops.gather_block_rows(m, pad.to(m.tsdf.device))

    def _stage(self, tensors) -> Tuple[List[torch.Tensor], Optional[object]]:
        """Start copying `tensors` to the host. On the card: into pinned
        staging buffers, on a side stream that waits for the current one,
        with the tensors marked as used by it (so the caching allocator
        hands out none of their memory while the copy runs); returns the
        buffers and an event that completes with the copy. On the CPU:
        copies, made now, and no event."""
        if self.device.type != "cuda":
            return [t.clone() for t in tensors], None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        side = self._copy_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        out = []
        with torch.cuda.stream(side):
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(side)
                out.append(h)
            ev = torch.cuda.Event()
            ev.record(side)
        return out, ev

    def _land(self, idx: int) -> None:
        """Install the host copy of submap `idx`'s async spill once the copy
        has completed: the pool re-expanded from the staged rows, the DB
        copied out of the staging buffers (only those are pinned)."""
        staged, ev, slots, s = self._inflight.pop(idx)
        if ev is not None:
            ev.synchronize()
        self.maps[idx] = _expand_rows(staged[:6], slots, s, *staged[6:9])
        self.dbs[idx] = FusionDB(*(t.clone() for t in staged[9:]))
        self._on_host[idx] = True
        self._spill_cache[idx] = None
        self._delta_rows[idx] = None

    def _join(self, idx: int) -> None:
        if idx in self._inflight:
            self._land(idx)

    def finalize_spills(self) -> None:
        """Land every async spill in flight."""
        for idx in list(self._inflight):
            self._land(idx)

    def evict_to_host_async(self, idx: int) -> bool:
        """Start a compacted spill of submap `idx` whose copy runs on a side
        stream while the caller goes on (the reference's swapping engine
        has a CUDA stream of its own); it lands at `finalize_spills` or at
        the submap's next evict or restore, and the submap counts as
        resident until then. The cheap cases (a clean cache, delta rows)
        and a pool that does not compact take the sync path. Returns True
        when a copy was started.

        Inherited from the JAX package (denseslam_tpu/models/dense_slam.py
        `evict_to_host_async`): the host copy is the snapshot taken here,
        at dispatch, so a device-side change to the submap between this
        call and the landing is lost."""
        if idx in self._inflight:
            return True
        if self.is_on_host(idx):
            return False
        if self._spill_cache[idx] is not None:
            self.evict_to_host(idx)
            return False
        m, db = self.maps[idx], self.dbs[idx]
        s = m.num_slots
        slots = self._alloc_slots(m)
        npad = self._npad(slots.numel(), s)
        if npad >= s:
            self.evict_to_host(idx)
            return False
        # the DB stays live until the landing: copy it now, on the current
        # stream, so that the spill is the dispatch-time snapshot
        payload = (self._gather(m, slots, npad)
                   + (m.frame, m.decayed_blocks, m.overflow)
                   + tuple(t.clone() for t in db))
        staged, ev = self._stage(payload)
        self._inflight[idx] = (staged, ev, slots, s)
        self.num_evictions += 1
        self.num_async_spills += 1
        return True

    def evict_to_host(self, idx: int) -> None:
        """Spill submap `idx` to the host now: free when it is an untouched
        restore, only the delta rows when `mark_dirty` named them, else the
        compacted pool (the whole pool when it does not compact)."""
        self._join(idx)
        if self.is_on_host(idx):
            return
        if not self.dirty[idx] and self._spill_cache[idx] is not None:
            self.maps[idx], self.dbs[idx] = self._spill_cache[idx]
            self._spill_cache[idx] = None
            self._on_host[idx] = True
            self.num_evictions += 1
            return
        if (self.dirty[idx] and self._spill_cache[idx] is not None
                and self._delta_rows[idx] is not None):
            self._evict_delta(idx)
            return
        m = self.maps[idx]
        s = m.num_slots
        slots = self._alloc_slots(m)
        npad = self._npad(slots.numel(), s)
        cpu = torch.device("cpu")
        if npad < s:
            rows = [t.to(cpu, copy=True) for t in self._gather(m, slots, npad)]
            self.maps[idx] = _expand_rows(
                rows, slots, s, *(t.to(cpu, copy=True) for t in
                                  (m.frame, m.decayed_blocks, m.overflow)))
        else:
            self.maps[idx] = copy_map(m, cpu)
        self.dbs[idx] = copy_db(self.dbs[idx], cpu)
        self._spill_cache[idx] = None
        self._on_host[idx] = True
        self.num_evictions += 1

    def _evict_delta(self, idx: int) -> None:
        """Evict a submap whose changes since its restore are the rows in
        `_delta_rows`: only those rows cross, with the (S,) stamp planes
        whole (they change on every visible slot of a replayed frame) and
        the DB's poses and flags (a replay never changes the stored
        frames), merged into copies of the cached host planes."""
        slots = torch.as_tensor(np.asarray(self._delta_rows[idx]),
                                dtype=torch.int64)
        m, db = self.maps[idx], self.dbs[idx]
        host_m, host_db = self._spill_cache[idx]
        if slots.numel():
            cpu = torch.device("cpu")
            rows = self._gather(m, slots, self._npad(slots.numel(),
                                                     m.num_slots))[:4]
            (keys_r, tsdf_r, w_r, c_r, af, ls, fr, dec, ovf, dbT, dbf, dbv,
             dbh) = (t.to(cpu, copy=True) for t in rows + (
                 m.alloc_frame, m.last_seen, m.frame, m.decayed_blocks,
                 m.overflow, db.T_fused, db.frame_id, db.valid, db.head))
            n = slots.numel()

            def merge(plane, r):
                out = plane.clone()
                out[slots] = r[:n]
                return out

            self.maps[idx] = tsdf_ops.MapState(
                table=vhash.HashTable(keys=merge(host_m.table.keys, keys_r)),
                tsdf=merge(host_m.tsdf, tsdf_r),
                weight=merge(host_m.weight, w_r),
                color=merge(host_m.color, c_r),
                alloc_frame=af, last_seen=ls, frame=fr, decayed_blocks=dec,
                overflow=ovf)
            self.dbs[idx] = host_db._replace(T_fused=dbT, frame_id=dbf,
                                             valid=dbv, head=dbh)
            self.num_delta_spills += 1
        else:
            self.maps[idx], self.dbs[idx] = host_m, host_db
        self._spill_cache[idx] = None
        self._delta_rows[idx] = None
        self._on_host[idx] = True
        self.num_evictions += 1

    def restore_to_device(self, idx: int) -> None:
        """Bring spilled submap `idx` back: its allocated rows cross and
        `rebuild_from_rows` rebuilds the pool on the device; the host copy
        stays as the clean cache."""
        self._join(idx)
        if not self.is_on_host(idx):
            return
        m, db = self.maps[idx], self.dbs[idx]
        dev = self.device
        s = m.num_slots
        slots = self._alloc_slots(m)
        n = slots.numel()
        npad = self._npad(n, s)
        if npad < s:
            inv = torch.full((s,), npad, dtype=torch.int64)
            inv[slots] = torch.arange(n)
            fills = (vhash.EMPTY_KEY, 1, 0, 0, 0, 0)
            rows = [_pad_rows(a, slots, npad, f).to(dev)
                    for a, f in zip(_map_leaves(m)[:6], fills)]
            self.maps[idx] = tsdf_ops.rebuild_from_rows(
                inv.to(dev), *rows, m.frame, m.decayed_blocks, m.overflow)
        else:
            self.maps[idx] = copy_map(m, dev)
        self.dbs[idx] = copy_db(db, dev)
        self._spill_cache[idx] = (m, db)
        self._on_host[idx] = False
        self.dirty[idx] = False
        self.num_restores += 1

    def mark_dirty(self, idx: int,
                   changed_slots: Optional[np.ndarray] = None) -> None:
        """Submap `idx`'s device content changed, so its clean cache is
        stale, unless `changed_slots` names every row that changed: then
        the cache stays valid for the other rows and the next evict sends
        only those."""
        self.dirty[idx] = True
        if changed_slots is not None and self._spill_cache[idx] is not None:
            prev = self._delta_rows[idx]
            self._delta_rows[idx] = (np.asarray(changed_slots) if prev is None
                                     else np.union1d(prev, changed_slots))
            return
        self._spill_cache[idx] = None
        self._delta_rows[idx] = None

    def ghost_render_state(self, idx: int,
                           slots: np.ndarray) -> tsdf_ops.MapState:
        """A transient render-only device state of spilled submap `idx`:
        only the rows `slots` (its in-view blocks) cross, as f16 tsdf and u8
        weight rounded up, with every key (probe chains must stay whole).
        The splat renderer reads weight only as an observed mask (w > 0),
        which rounding up keeps; colour reads zero, so a ghost serves depth,
        not colour. The host copy stays authoritative: nothing is marked
        resident or dirty."""
        m = self.maps[idx]
        dev = self.device
        s = m.num_slots
        sl = torch.as_tensor(np.asarray(slots), dtype=torch.int64)
        n = sl.numel()
        npad = self._npad(n, s)
        pad = torch.zeros((npad,), dtype=torch.int64)
        pad[:n] = sl
        inv = torch.full((s,), npad, dtype=torch.int64)
        inv[sl] = torch.arange(n)
        inv = inv.to(dev)
        tsdf_r = m.tsdf[pad].to(torch.float32).to(torch.float16)
        w_r = torch.ceil(torch.clamp(m.weight[pad].to(torch.float32), 0,
                                     255)).to(torch.uint8)
        sd = m.tsdf.dtype
        bv = tsdf_ops.BLOCK_VOL
        tsdf_p = torch.cat([tsdf_r.to(dev).to(sd),
                            torch.ones((1, bv), dtype=sd, device=dev)])
        w_p = torch.cat([w_r.to(dev).to(sd),
                         torch.zeros((1, bv), dtype=sd, device=dev)])

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)

        return tsdf_ops.MapState(
            table=vhash.HashTable(keys=m.table.keys.to(dev, copy=True)),
            tsdf=tsdf_p[inv], weight=w_p[inv], color=zeros(s, bv),
            alloc_frame=zeros(s), last_seen=zeros(s),
            frame=m.frame.to(dev, torch.int32, copy=True),
            decayed_blocks=zeros(), overflow=zeros())

    def is_on_host(self, idx: int) -> bool:
        return self._on_host[idx]

    def demote_to_host(self, idx: int, m: tsdf_ops.MapState) -> None:
        """Replace submap `idx` by the host map `m` (CPU tensors) and move
        its DB to the host: the sharded spawn's demotion of the old active
        shard, which starts its life as an inactive submap spilled."""
        self.maps[idx] = m
        self.dbs[idx] = copy_db(self.dbs[idx], torch.device("cpu"))
        self._on_host[idx] = True
        self._spill_cache[idx] = None
        self._delta_rows[idx] = None

    # -- the memory-budget policy ------------------------------------------

    def submap_device_bytes(self, idx: int) -> int:
        """Device bytes of submap `idx` (0 on the host): pool, hash table
        and fusion DB, each allocated whole. The port's DB depth is int32,
        so a submap holds more bytes than in the JAX package."""
        if self.is_on_host(idx):
            return 0
        return sum(t.numel() * t.element_size()
                   for t in _map_leaves(self.maps[idx]) + list(self.dbs[idx]))

    def device_memory_bytes(self) -> int:
        return sum(self.submap_device_bytes(i) for i in range(len(self.maps)))

    def committed_memory_bytes(self) -> int:
        """Device bytes that would cost a transfer to reclaim: the active
        submap and the dirty residents (a clean resident evicts free)."""
        last = len(self.maps) - 1
        return sum(self.submap_device_bytes(i) for i in range(last + 1)
                   if i == last or self.dirty[i])

    def enforce_memory_budget(self, async_spill: bool = False) -> List[int]:
        """Spill the oldest non-active dirty residents until the committed
        bytes fit `pipeline.map_memory_budget_mb` (< 0: no budget; the
        active submap is never spilled); with `async_spill`, start one async
        spill and stop (its bytes free only when it lands). Then drop clean
        residents, oldest first, for free until the device bytes fit too.
        Returns the indices evicted."""
        budget_mb = self.cfg.pipeline.map_memory_budget_mb
        if budget_mb < 0 or len(self.maps) < 2:
            return []
        budget = int(budget_mb * 1e6)
        evicted: List[int] = []
        for idx in range(len(self.maps) - 1):
            if self.committed_memory_bytes() <= budget:
                break
            if not self.is_on_host(idx) and self.dirty[idx]:
                if async_spill:
                    self.evict_to_host_async(idx)
                else:
                    self.evict_to_host(idx)
                evicted.append(idx)
                if async_spill:
                    break
        if self.device_memory_bytes() > budget:
            for idx in range(len(self.maps) - 1):
                if self.device_memory_bytes() <= budget:
                    break
                if (not self.is_on_host(idx) and not self.dirty[idx]
                        and self._spill_cache[idx] is not None):
                    self.evict_to_host(idx)
                    evicted.append(idx)
        return evicted

    def drop_clean_cache(self) -> int:
        """Free every clean resident's device copy (a free evict). Returns
        the number dropped."""
        n = 0
        for idx in range(len(self.maps) - 1):
            if (not self.is_on_host(idx) and not self.dirty[idx]
                    and self._spill_cache[idx] is not None):
                self.evict_to_host(idx)
                n += 1
        return n

    @property
    def num_active_local_maps(self) -> int:
        """Device-resident submaps (reference: numActiveLocalMaps)."""
        return sum(1 for i in range(len(self.maps)) if not self.is_on_host(i))

    def local_map_size(self, idx: int) -> int:
        """Allocated blocks of submap `idx` (counted where it lives; a
        sharded active map over all its ranks)."""
        if self.sharded is not None and idx == self.active_idx:
            return self.sharded.num_blocks(self.maps[idx])
        return int(tsdf_ops.num_allocated_blocks(self.maps[idx]))

    def should_start_new(self, visible_blocks: int, threshold: float,
                         size: Optional[int] = None) -> bool:
        """A new submap when the visible share of the active map's blocks
        falls below `threshold` (< 0 disables); `size`, the active map's
        allocated blocks, when the caller has read it already."""
        if threshold < 0:
            return False
        if size is None:
            size = self.local_map_size(self.active_idx)
        if size == 0:
            return False
        return visible_blocks / size < threshold


def _pose_tensor(T, device) -> torch.Tensor:
    """A (4, 4) pose, tensor or array, as float32 on `device`."""
    if isinstance(T, torch.Tensor):
        return T.to(device, torch.float32)
    return upload(np.asarray(T, np.float32), device)


class DenseSLAM:
    """Host-side state of the dense pipeline: the frontend state, the
    submaps (`SubmapManager`: the active one, whose fusion DB is `db`, and
    the earlier ones, on the card or spilled to the host), the frame
    counter and the pose history. `process_frame` runs one frame
    (odometry, keyframe-gated depth, post-processing, fusion, the
    new-submap policy); the chunk path of models/system.py runs the
    throughput scans on the same state; backend pose updates flow into
    the map through `apply_pose_updates` (the active submap corrected at
    once, the others deferred until they are used, the submaps' global
    poses relaxed from their anchor keyframes); `raycast_view` renders the
    active map with the configured renderer (`pipeline.renderer`:
    "splat", the default, else the sphere-traced raycast) and
    `raycast_composite` every submap under its alignment; `save_mesh`
    writes the active submap's mesh. On `device` (None = the CUDA card;
    raises without one). The RANSAC draws come from the frontend state's
    threefry key, `PRNGKey(seed)` at the start, as in the JAX package,
    unless `process_frame` is handed them.
    `process_frame` times its stages on utils/timing.py's TIMERS
    (`frontend`, `stereo_depth`, `fusion`); `fusion_ms` holds each fused
    keyframe's fusion time.

    `mesh` (parallel/mesh.py `MapMesh`, one process per rank) shards the
    active map over the ranks (parallel/sharded_map.py): fusion,
    correction, purge, decay and the raycast run on each rank's shard, on
    the mesh's device. Every rank runs the rest (odometry, depth, the
    DB, the earlier submaps) in full and takes the values that reach the
    map from rank 0: the pose and tracking flag of each frame, a
    keyframe's depth and image, the backend's poses and culls. A spawn
    demotes the old shard through `gather_to_single` to a whole submap on
    the host."""

    def __init__(self, cfg: SystemConfig, mesh=None, device=None,
                 seed: int = 0):
        if cfg.correction.enabled and cfg.tsdf.storage_dtype == "bfloat16":
            warnings.warn(
                "online correction replays de-integration against a "
                "bfloat16-quantised map: the de-fuse/re-fuse inverse is "
                "approximate (~1/256 tsdf error per correction) instead of "
                "exact. Use float32 storage when correction fidelity "
                "matters.", stacklevel=2)
        self.cfg = cfg
        self._sharded = None
        if mesh is not None:
            from ..parallel.mesh import MapMesh
            from ..parallel.sharded_map import ShardedTsdf
            if not isinstance(mesh, MapMesh):
                raise TypeError("mesh must be a parallel.mesh.MapMesh "
                                f"(the map axis), not {type(mesh).__name__}")
            device = mesh.device if device is None else device
            self._sharded = ShardedTsdf(cfg, mesh)
        self.device = resolve_device(device)
        self.fe_state = fe.init_frontend(cfg, device=self.device, seed=seed)
        self.submaps = SubmapManager(cfg, self.device)
        if self._sharded is not None:
            self.submaps.sharded = self._sharded
            self.submaps.maps[0] = self._sharded.make_map()
        self.frame = 0
        self.current_keyframes = 0
        self.pose_history: List[Tuple[int, np.ndarray]] = []
        self.last_fused_depth: Optional[torch.Tensor] = None
        self.last_fused_T: Optional[torch.Tensor] = None
        self._fusion_laps = []
        # (uv_prev, uv_curr, valid) of the last VO step's matches, tensors
        # on the device, for the viewer's scene-flow pane (moved to the
        # host only when a viewer draws it); reference:
        # VisoSparseSFProvider::GetFlow
        self.last_flow: Optional[Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]] = None
        self._splat_cfg = splat_ops.SplatConfig(
            **dataclasses.asdict(cfg.splat))

    @property
    def db(self) -> FusionDB:
        return self.submaps.dbs[self.submaps.active_idx]

    @db.setter
    def db(self, value: FusionDB) -> None:
        self.submaps.dbs[self.submaps.active_idx] = value

    # -- per-frame ---------------------------------------------------------

    def process_frame(self, left: torch.Tensor,
                      right: Optional[torch.Tensor] = None,
                      depth: Optional[torch.Tensor] = None,
                      timestamp: Optional[float] = None,
                      pose_override=None, budget_scale: float = 1.0,
                      draws: Optional[torch.Tensor] = None) -> dict:
        """Process one stereo (RGB-D, mono) frame: odometry, then on
        keyframes where tracking holds the depth (the given one, else SGM
        of the pair), the cross-frame cull when `postprocess.enabled`, and
        fusion. Images are (H, W) gray or (H, W, 3) colour tensors on the
        system's device. Returns the frame's telemetry.

        Odometry: `pose_override` (a (4, 4) pose) replaces it; else mono
        VO (sensor="mono": 8-point RANSAC and the ground-plane scale; a
        frame given no depth only tracks, and fuses nothing), RGB-D VO
        (sensor="rgbd") or stereo VO with the PD controller's
        `budget_scale`, each drawing its RANSAC hypotheses from `draws`
        ((K, 8) for mono, else (K, 3)) or the frontend state's key; with
        use_external_odometry=False ICP of the depth against a render of
        the map at the last fused pose. The JAX version runs SGM on every
        frame that has a right image; here it runs only where the depth is
        used (ICP, or a keyframe), which gives the same results. Two values
        are read back per frame: the odometry's flags, then the pose and
        block count."""
        cfg = self.cfg
        p = cfg.pipeline
        if left.dim() == 3:
            left = rgb_to_gray(left)
        if right is not None and right.dim() == 3:
            right = rgb_to_gray(right)

        TIMERS.tic("frontend")
        if pose_override is not None:
            T_wc = _pose_tensor(pose_override, self.device)
            self.fe_state = self.fe_state._replace(T_wc=T_wc)
            tracking_ok, vo_stats = True, {}
        elif p.sensor == "mono" or p.use_external_odometry:
            if p.sensor == "mono":
                self.fe_state, vo = fe.mono_vo_step(self.fe_state, left, cfg,
                                                    raw=draws)
            elif p.sensor == "rgbd":
                if depth is None:
                    raise ValueError("rgbd VO needs a depth image")
                self.fe_state, vo = fe.rgbd_vo_step(self.fe_state, left,
                                                    depth, cfg, raw=draws)
            else:
                if right is None:
                    raise ValueError("stereo VO needs a right image")
                self.fe_state, vo = fe.vo_step(self.fe_state, left, right,
                                               cfg, raw=draws,
                                               budget_scale=budget_scale)
            T_wc = vo.T_wc
            self.last_flow = (vo.flow_uv_prev, vo.flow_uv_curr,
                              vo.flow_valid)
            s = torch.stack([vo.tracking_ok.to(torch.float32),
                             vo.num_inliers.to(torch.float32),
                             vo.num_quads.to(torch.float32)]).cpu().numpy()
            tracking_ok = bool(s[0])
            vo_stats = dict(num_inliers=int(s[1]), num_quads=int(s[2]))
        else:
            # internal odometry: ICP against a render of the active map
            T_prev = (self.last_fused_T if self.last_fused_T is not None
                      else torch.eye(4, dtype=torch.float32,
                                     device=self.device))
            if depth is None:
                if right is None:
                    raise ValueError("need depth or a right image")
                depth, _ = stereo_ops.compute_depth(left, right, cfg.rig,
                                                    cfg.stereo)
            if self.frame == 0:
                T_wc, tracking_ok, vo_stats = T_prev, True, {}
            else:
                rc = self._render(self.submaps.active, T_prev)
                res = icp_ops.track(depth, rc.points, rc.normals, rc.mask,
                                    T_prev, T_prev, cfg.rig.intr)
                T_wc = res.T_wc
                s = torch.stack([res.converged.to(torch.float32),
                                 res.rmse]).cpu().numpy()
                tracking_ok = bool(s[0])
                vo_stats = dict(icp_rmse=float(s[1]))
        if self._sharded is not None:
            # rank 0's pose and flag decide what every rank fuses
            T_rep, tracking_ok = self._sharded.replicate_pose(T_wc,
                                                              tracking_ok)
            if self.fe_state.T_wc is T_wc:
                self.fe_state = self.fe_state._replace(T_wc=T_rep)
            T_wc = T_rep
        TIMERS.toc("frontend", sync=T_wc)

        fused = False
        if ((depth is not None or right is not None) and tracking_ok
                and self.frame % p.keyframe_every == 0):
            if depth is None:
                TIMERS.tic("stereo_depth")
                depth, _ = stereo_ops.compute_depth(left, right, cfg.rig,
                                                    cfg.stereo)
                TIMERS.toc("stereo_depth", sync=depth)
            if cfg.postprocess.enabled and self.last_fused_depth is not None:
                depth = depth_postprocess(depth, T_wc, self.last_fused_depth,
                                          self.last_fused_T, cfg)
            TIMERS.tic("fusion")
            if self._sharded is not None:
                # the mm-quantised depth, so that the DB replay is exact;
                # rank 0's depth and image
                depth, left = self._sharded.replicate(
                    db_quantize_depth(self.db, depth), left)
                m = self._sharded.fuse(self.submaps.active, depth, left,
                                       T_wc)
                self.db = db_push(self.db, depth, left, T_wc, self.frame)
            else:
                m, self.db = fuse_keyframe(self.submaps.active, self.db,
                                           depth, left, T_wc, self.frame,
                                           cfg)
            self.submaps.active = m
            TIMERS.toc("fusion", sync=m.tsdf)
            self._fusion_laps.append(TIMERS.last_lap("fusion"))
            self.last_fused_depth = depth
            self.last_fused_T = T_wc
            self.current_keyframes += 1
            fused = True
            self.maybe_spawn_submap(T_wc)

        # pose and block count in one read-back
        nb = tsdf_ops.num_allocated_blocks(self.submaps.active)
        if self._sharded is not None:
            nb = self._sharded.mesh.all_reduce(nb)
        pose_nb = torch.cat([T_wc.reshape(-1).to(torch.float32),
                             nb.to(torch.float32)[None]]).cpu().numpy()
        return self._finish_frame_record(pose_nb, fused, tracking_ok,
                                         vo_stats)

    def _finish_frame_record(self, pose_nb, fused, tracking_ok, vo_stats):
        T_np = pose_nb[:16].reshape(4, 4)
        nb = int(pose_nb[16])
        self.pose_history.append((self.frame, T_np))
        self.frame += 1
        return dict(T_wc=T_np, fused=fused, tracking_ok=tracking_ok,
                    frame=self.frame - 1, num_blocks=nb,
                    memory_bytes=nb * 16 * tsdf_ops.BLOCK_VOL, **vo_stats)

    # -- rendering ---------------------------------------------------------

    def _render(self, m: tsdf_ops.MapState,
                T_wc: torch.Tensor) -> rc_ops.Raycast:
        """Render map `m` from T_wc with the configured renderer; splat
        renders refine their depth by `splat_refine` sphere-tracing steps
        (pruning by `splat_prune_sdf`) and rebuild points and normals."""
        cfg = self.cfg
        intr = cfg.rig.intr
        if self._sharded is not None and m is self.submaps.active:
            # the sharded active map: each rank renders its shard and the
            # renders combine by nearest depth
            return self._sharded.raycast(m, T_wc)
        if cfg.pipeline.renderer != "splat":
            return rc_ops.raycast(m, T_wc, intr, cfg.tsdf)
        rc = splat_ops.splat_render(m, T_wc, intr, cfg.tsdf, self._splat_cfg)
        refine = cfg.pipeline.splat_refine
        if refine > 0:
            d = splat_ops.refine_depth(m, rc.depth, rc.mask, T_wc, intr,
                                       cfg.tsdf, steps=refine,
                                       prune_sdf=cfg.pipeline.splat_prune_sdf)
            mask = d > 0
            pts = splat_ops.depth_points(d, mask, T_wc, intr)
            nx, ny, nz, _ = rc_ops._normals_soA(*pts, mask)
            rc = rc._replace(depth=d, mask=mask,
                             points=torch.stack(pts, dim=-1),
                             normals=torch.stack([nx, ny, nz], dim=-1))
        return rc

    def raycast_view(self, T_wc=None) -> rc_ops.Raycast:
        """Render the active map from T_wc (a (4, 4) pose; default the
        frontend's current pose)."""
        T = (self.fe_state.T_wc if T_wc is None
             else _pose_tensor(T_wc, self.device))
        return self._render(self.submaps.active, T)

    def get_preview(self, kind: str, T_wc=None) -> torch.Tensor:
        return rc_ops.render_preview(self.raycast_view(T_wc), kind)

    def _spawn_stats(self, m: tsdf_ops.MapState) -> Tuple[int, int]:
        """The blocks of `m` seen by its last fused frame and its allocated
        blocks, read back together."""
        v = torch.stack([
            ((m.last_seen == m.frame - 1) & m.table.valid).sum(),
            tsdf_ops.num_allocated_blocks(m)])
        if self._sharded is not None and m is self.submaps.active:
            v = self._sharded.mesh.all_reduce(v)
        v = v.cpu()
        return int(v[0]), int(v[1])

    def maybe_spawn_submap(self, T_wc, defer_enforce: bool = False) -> bool:
        """The new-submap policy (reference: shouldStartNewLocalMap and
        createNewLocalMap): spawn a submap anchored at T_wc when the share
        of the active map's blocks that its last fused frame saw falls
        below `pipeline.new_submap_threshold` (< 0, the default, disables
        it, before any device work). The per-frame path checks after every
        fused keyframe, the chunk path once a chunk. The old submap keeps
        its fusion DB. A spawn enforces the memory budget unless
        `defer_enforce`. Returns True if a submap was started."""
        thr = self.cfg.pipeline.new_submap_threshold
        if thr < 0:
            return False
        visible, size = self._spawn_stats(self.submaps.active)
        if not self.submaps.should_start_new(visible, thr, size=size):
            return False
        if self._sharded is not None:
            # only the active map is sharded: the old shard becomes a whole
            # submap spilled to the host, and a fresh shard starts
            sm = self.submaps
            sm.demote_to_host(sm.active_idx, self._sharded.gather_to_single(
                sm.active, as_numpy=True))
            sm.create_new(_pose_np(T_wc), anchor_frame_id=self.frame,
                          map_state=self._sharded.make_map())
        else:
            self.submaps.create_new(_pose_np(T_wc),
                                    anchor_frame_id=self.frame,
                                    enforce=not defer_enforce)
        if not defer_enforce:
            self.submaps.enforce_memory_budget()
        return True

    def restore_submap(self, si: int, force_replay: bool = False) -> int:
        """Restore submap `si` to the card and replay the corrections
        deferred while it was inactive, so that it looks as if it had been
        corrected in place. The replay runs when a pending pose moved by
        more than `correction.inactive_min_error`, or with `force_replay`;
        below that the stash stays pending (a later trigger or the
        sequence-end flush replays it), so a transient eval restore pays no
        correction. A replay that re-fuses marks the submap dirty with the
        rows it changed (the delta respill). Returns the number of
        re-fused frames (each launches the sampler twice)."""
        self.submaps.restore_to_device(si)
        pend = self.submaps.pending_corrections[si]
        if not pend:
            return 0
        if not (force_replay or any(
                err > self.cfg.correction.inactive_min_error
                for _, err in pend.values())):
            return 0
        db_i = self.submaps.dbs[si]
        db_ids = db_i.frame_id.cpu().numpy()
        opt_T = np.tile(np.eye(4, dtype=np.float32), (db_ids.shape[0], 1, 1))
        opt_valid = np.zeros(db_ids.shape[0], bool)
        for slot, fid in enumerate(db_ids):
            if int(fid) in pend:
                opt_T[slot] = pend[int(fid)][0]
                opt_valid[slot] = True
        pend.clear()
        if not opt_valid.any():
            return 0
        m, db, num, changed = online_correction_delta(
            self.submaps.maps[si], db_i, upload(opt_T, self.device),
            upload(opt_valid, self.device), self.cfg)
        self.submaps.maps[si] = m
        self.submaps.dbs[si] = db
        if num > 0:
            self.submaps.mark_dirty(
                si, changed_slots=torch.nonzero(changed).flatten()
                .cpu().numpy())
        return num

    def flush_deferred_corrections(self) -> int:
        """Sequence-end replay of every deferred correction, those below
        the replay trigger too, so the finished map carries the whole
        correction history. Returns the number of submaps flushed.

        Inherited from the JAX package (denseslam_tpu/models/dense_slam.py
        `flush_deferred_corrections`): the memory budget is enforced once,
        after the loop, so every flushed submap is on the card at the same
        moment."""
        n = 0
        for si in range(self.submaps.num_local_maps):
            if self.submaps.pending_corrections[si]:
                self.restore_submap(si, force_replay=True)
                n += 1
        if n:
            self.submaps.enforce_memory_budget()
        return n

    def apply_pose_updates(self, frame_ids: np.ndarray, poses: np.ndarray,
                           enforce_budget: bool = True) -> int:
        """Feed backend-optimised poses (frame_ids (n,), poses (n, 4, 4)).
        With more than one submap, those whose anchor keyframe moved get a
        global-pose measurement and the inter-submap graph is relaxed
        (`optimize_alignment`). Online correction then runs on the active
        submap; an inactive submap's frames that drifted past
        `correction.min_error` are stashed, the latest pose per frame, for
        `restore_submap` (correcting inactive pools live costs a replay
        per tick and deferring coalesces ticks). Returns the number of
        re-fused keyframes."""
        if self._sharded is not None:
            frame_ids, poses = self._sharded.replicate_host(
                np.asarray(frame_ids), np.asarray(poses))
        lut = {int(f): i for i, f in enumerate(frame_ids)}
        sm = self.submaps
        if sm.num_local_maps > 1:
            anchor_meas = {si: poses[lut[af]]
                           for si, af in enumerate(sm.anchor_frames)
                           if af in lut}
            if anchor_meas:
                sm.optimize_alignment(anchor_meas)
        if not self.cfg.correction.enabled:
            return 0
        num = 0
        for si in range(sm.num_local_maps):
            db = sm.dbs[si]
            # the DB's index in one read-back (none for a spilled one)
            c = db.frame_id.shape[0]
            h = torch.cat([db.frame_id.to(torch.float32),
                           db.valid.to(torch.float32),
                           db.T_fused.reshape(-1)]).cpu().numpy()
            db_ids = h[:c].astype(np.int64)
            db_valid = h[c:2 * c] > 0.5
            if si != sm.active_idx:
                pend = sm.pending_corrections[si]
                T_f = h[2 * c:].reshape(c, 4, 4)
                for slot, fid in enumerate(db_ids):
                    if not db_valid[slot] or int(fid) not in lut:
                        continue
                    T_opt = poses[lut[int(fid)]]
                    err = lie.pose_error_weighted_np(T_f[slot], T_opt)
                    if err > self.cfg.correction.min_error:
                        pend[int(fid)] = (np.asarray(T_opt, np.float32), err)
                continue
            opt_T = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
            opt_valid = np.zeros(c, bool)
            for slot, fid in enumerate(db_ids):
                if int(fid) in lut:
                    opt_T[slot] = poses[lut[int(fid)]]
                    opt_valid[slot] = True
            if not opt_valid.any():
                continue
            # only the active map is sharded; the others replay whole
            correct = (self._sharded.correct
                       if self._sharded is not None and si == sm.active_idx
                       else partial(online_correction, cfg=self.cfg))
            m, db, n = correct(sm.maps[si], db, upload(opt_T, self.device),
                               upload(opt_valid, self.device))
            sm.maps[si] = m
            sm.dbs[si] = db
            if n > 0:
                sm.mark_dirty(si)
            num += n
        if enforce_budget:
            sm.enforce_memory_budget()
        return num

    def purge_keyframes(self, culled_frame_ids: np.ndarray) -> None:
        """Remove the fused keyframes the backend culled."""
        db_ids = self.db.frame_id.cpu().numpy()
        culled = upload(np.isin(db_ids, culled_frame_ids), self.device)
        if self._sharded is not None:
            m, db = self._sharded.purge(self.submaps.active, self.db, culled)
        else:
            m, db = purge_culled(self.submaps.active, self.db, culled,
                                 self.cfg)
        self.submaps.active = m
        self.db = db

    def decay_catchup(self) -> None:
        """Sequence-end decay: min_decay_age passes ignoring the age gate."""
        if not self.cfg.decay.enabled:
            return
        w = self.cfg.decay.max_decay_weight
        for _ in range(self.cfg.decay.min_decay_age):
            if self._sharded is not None:
                self.submaps.active = self._sharded.decay_catchup_step(
                    self.submaps.active, w)
            else:
                self.submaps.active = tsdf_ops.decay_catchup(
                    self.submaps.active, w)

    def _inview_slots(self, idx: int, T_wc) -> np.ndarray:
        """The allocated slots of submap `idx` whose block centres, moved by
        the submap's alignment delta, project into the camera at T_wc
        within max_depth: host-side float64 numpy on the unpacked keys, no
        device work for a spilled submap. The frustum pad grows as a
        block's extent (half-diagonal 0.87 * block size) projects up close,
        with a 16 px floor."""
        keys = self.submaps.maps[idx].table.keys.cpu().numpy()
        alloc = np.flatnonzero(keys != vhash.EMPTY_KEY).astype(np.int32)
        if alloc.size == 0:
            return alloc
        ks = keys[alloc]
        half = int(vhash.PACK_HALF)
        mask = (1 << int(vhash.PACK_BITS)) - 1
        bx = (ks & mask) - half
        by = ((ks >> int(vhash.PACK_BITS)) & mask) - half
        bz = ((ks >> (2 * int(vhash.PACK_BITS))) & mask) - half
        bs = tsdf_ops.BLOCK * self.cfg.tsdf.voxel_size_m
        P = (np.stack([bx, by, bz], -1).astype(np.float64) + 0.5) * bs
        M = np.linalg.inv(_pose_np(T_wc).astype(np.float64)) @ np.asarray(
            self.submaps.delta(idx), np.float64)
        pc = P @ M[:3, :3].T + M[:3, 3]
        z = pc[:, 2]
        ok = (z > 0.2 - bs) & (z < self.cfg.tsdf.max_depth_m + 2 * bs)
        intr = self.cfg.rig.intr
        u = pc[:, 0] / np.maximum(z, 0.2) * intr.fx + intr.cx
        v = pc[:, 1] / np.maximum(z, 0.2) * intr.fy + intr.cy
        pad = np.maximum(intr.fx * 0.87 * bs / np.maximum(z, 0.2), 16.0)
        ok &= ((u > -pad) & (u < intr.width + pad)
               & (v > -pad) & (v < intr.height + pad))
        return alloc[ok]

    def _spilled_submap_in_view(self, idx: int, T_wc,
                                min_blocks: int = 2) -> bool:
        """The composite's visibility gate: at least `min_blocks` blocks in
        view (a false positive costs one restore, a false negative a hole
        in the composite)."""
        return self._inview_slots(idx, T_wc).size >= min_blocks

    def raycast_composite(self, T_wc=None, respill: bool = True,
                          ghost: bool = False) -> rc_ops.Raycast:
        """Render every submap from T_wc (default: the frontend's pose)
        under its current alignment delta D (the camera inv(D) @ T_wc sees
        the submap's content as T_wc sees it moved by D) and merge the
        renders by minimum depth, so that pose-graph updates realign the
        composite. A spilled submap with no block in view is skipped; one
        in view is restored (its deferred corrections replayed) and, with
        `respill`, spilled again after its render; respill=False leaves it
        resident for a burst of renders (re-enforce the budget after it).
        With `ghost`, a spilled submap is rendered from
        `ghost_render_state` instead, unless a deferred correction past
        the replay trigger forces the restore; ghosts render depth, not
        colour. An inactive resident with deferred corrections replays
        them first."""
        T = (self.fe_state.T_wc if T_wc is None
             else _pose_tensor(T_wc, self.device))
        if self._sharded is not None:
            (T,) = self._sharded.replicate(T)
        sm = self.submaps
        best: Optional[rc_ops.Raycast] = None
        for idx in range(sm.num_local_maps):
            respill_this = False
            m = None
            if sm.is_on_host(idx):
                slots = self._inview_slots(idx, T)
                if slots.size < 2:
                    continue
                trigger = any(err > self.cfg.correction.inactive_min_error
                              for _, err in
                              sm.pending_corrections[idx].values())
                if ghost and not trigger and self._sharded is None:
                    m = sm.ghost_render_state(idx, slots)
                    sm.num_ghost_renders += 1
                else:
                    self.restore_submap(idx)
                    respill_this = respill
            elif idx != sm.active_idx and sm.pending_corrections[idx]:
                self.restore_submap(idx)
            D = upload(sm.delta(idx), self.device)
            rc = self._render(sm.maps[idx] if m is None else m,
                              lie.inv_T(D) @ T)
            best = (_composite_transform(rc, D) if best is None
                    else _composite_merge(best, rc, D))
            if respill_this:
                sm.evict_to_host(idx)
        if best is None:
            raise RuntimeError("no submap to render")
        return best

    def memory_bytes(self) -> int:
        """Used map bytes (16 per voxel of every allocated block) of every
        submap, on the card or the host."""
        blocks = sum(self.submaps.local_map_size(i)
                     for i in range(self.submaps.num_local_maps))
        return blocks * 16 * tsdf_ops.BLOCK_VOL

    def memory_report(self) -> dict:
        """Used map bytes by where the submaps live, the card bytes of the
        whole pools and DBs (`device_memory_bytes`) and the committed part
        of them (the active submap and dirty residents), in MB, and the
        submap counts."""
        sm = self.submaps
        dev_used = host_used = 0
        for i in range(sm.num_local_maps):
            b = sm.local_map_size(i) * 16 * tsdf_ops.BLOCK_VOL
            if sm.is_on_host(i):
                host_used += b
            else:
                dev_used += b
        return dict(
            used_device_mb=round(dev_used / 1e6, 1),
            used_host_mb=round(host_used / 1e6, 1),
            hbm_footprint_mb=round(sm.device_memory_bytes() / 1e6, 1),
            hbm_committed_mb=round(sm.committed_memory_bytes() / 1e6, 1),
            submaps=sm.num_local_maps,
            submaps_on_host=sum(1 for i in range(sm.num_local_maps)
                                if sm.is_on_host(i)))

    def save_mesh(self, path: str) -> int:
        """Marching-tetrahedra OBJ export of the active submap (the
        reference's SaveCurrSceneToMesh, ops/meshing.py); a sharded one is
        first gathered into one table (`gather_to_single`), since each
        shard hashes modulo its own slot count. Returns the triangle
        count."""
        m = self.submaps.active
        if self._sharded is not None:
            m = self._sharded.gather_to_single(m)
        tris = meshing.extract_mesh(m, self.cfg.tsdf)
        meshing.save_obj(path, tris)
        return int(tris.shape[0])

    def save_raycast_depth(self, path: str, T_wc=None) -> None:
        """16-bit PNG of the render at T_wc (default the current pose),
        depth * 256 (reference: DenseSlam.cpp:573-603)."""
        rc = self.raycast_view(T_wc)
        png.write_png(path, rc_ops.depth_to_png16(rc.depth).cpu().numpy()
                      .astype(np.uint16))

    def save_raycast_rgb(self, path: str, T_wc=None) -> None:
        """The render's colour preview, or its shaded gray preview when no
        colour was fused (reference: DenseSlam.cpp:605-636). Its channels
        go to the file as the JAX version's cv2.imwrite puts them: as BGR."""
        rc = self.raycast_view(T_wc)
        img = rc_ops.render_preview(rc, rc_ops.PREVIEW_COLOR).cpu().numpy()
        if img.max() == 0:
            img = rc_ops.render_preview(rc, rc_ops.PREVIEW_GRAY).cpu().numpy()
        png.write_png(path, img)

    @property
    def fusion_ms(self) -> List[float]:
        """Each fused keyframe's fusion time in `process_frame` (read from
        the `fusion` timer's events)."""
        return [lap.ms() for lap in self._fusion_laps]

    def mean_fusion_ms(self) -> float:
        ms = self.fusion_ms
        return float(np.mean(ms)) if ms else 0.0

    @property
    def current_pose(self) -> np.ndarray:
        return self.fe_state.T_wc.cpu().numpy()

    def trajectory(self) -> List[Tuple[int, np.ndarray]]:
        return list(self.pose_history)
