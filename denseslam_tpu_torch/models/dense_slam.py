"""The dense pipeline (port of part of denseslam_tpu/models/dense_slam.py):
the fused-keyframe DB, depth post-processing, `fuse_keyframe` /
`fuse_sequence`, the throughput paths `process_sequence` (stereo VO +
keyframe-gated SGM + fusion) and `process_sequence_rgbd`, online
correction (`online_correction`, `purge_culled`) and the host-side
`DenseSLAM` with its single-submap `SubmapManager`: the per-frame
`process_frame` (stereo or RGB-D VO, or ICP against a render of the map),
the renderers behind `raycast_view`, and what the chunk path of
models/system.py uses.

The JAX package donates map and DB to each step; here both are updated in
place and returned. Where the JAX version branches on a device value
inside a program (`lax.cond` per DB slot), the port reads the values the
branch needs back to the host once and loops there.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import SystemConfig
from ..device import resolve_device
from ..ops import features as feat_ops
from ..ops import icp as icp_ops
from ..ops import ransac
from ..ops import raycast as rc_ops
from ..ops import splat as splat_ops
from ..ops import stereo as stereo_ops
from ..ops import tsdf as tsdf_ops
from ..utils import lie
from ..utils.camera import backproject, project
from ..utils.image import (bilateral_filter_depth, depth_bilinear_sample,
                           rgb_to_gray)
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
            T_new: Optional[torch.Tensor], cfg: SystemConfig):
    """De-integrate DB slot `slot`'s frame at the pose it was fused at and,
    given T_new, re-integrate it there. In place; returns the map."""
    intr, tc = cfg.rig.intr, cfg.tsdf
    depth = db_depth(db, slot)
    color = tsdf_ops.pack_gray(db_gray(db, slot))
    T_old = db.T_fused[slot]
    m, s, k = tsdf_ops.allocate_for_frame(m, depth, T_old, intr, tc)
    m = tsdf_ops.deintegrate(m, s, k, depth, color, T_old, intr, tc)
    if T_new is not None:
        m, s, k = tsdf_ops.allocate_for_frame(m, depth, T_new, intr, tc)
        m = tsdf_ops.integrate(m, s, k, depth, color, T_new, intr, tc)
    return m


def online_correction(m: tsdf_ops.MapState, db: FusionDB,
                      opt_T: torch.Tensor, opt_valid: torch.Tensor,
                      cfg: SystemConfig):
    """De-fuse / re-fuse the worst-drift fused keyframes: score each DB
    slot's fused pose against its optimised pose `opt_T` (C, 4, 4) where
    `opt_valid` (C,); when at least start_correction_num slots drift past
    min_error, replay up to correction_num of them, worst first, then run
    the defusion-part GC. In place on map and DB; returns (map, db,
    number re-fused)."""
    oc = cfg.correction
    err = lie.pose_error_weighted(db.T_fused, opt_T)
    stale = db.valid & opt_valid & (err > oc.min_error)
    do_correct = stale.to(torch.int32).sum() >= oc.start_correction_num
    scores = torch.where(stale & do_correct, err, -1.0)
    slots, worst = _topk_slots(scores, oc.correction_num)
    num = 0
    for slot, score in zip(slots, worst):
        if score > 0.0:
            m = _replay(m, db, slot, opt_T[slot], cfg)
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
                 cfg: SystemConfig):
    """De-fuse the DB entries whose keyframe the backend culled (C,) and
    drop them, up to correction_num per call. In place; returns (map, db)."""
    scores = torch.where(db.valid & culled, 1.0, -1.0)
    slots, run = _topk_slots(scores, cfg.correction.correction_num)
    for slot, score in zip(slots, run):
        if score > 0.0:
            m = _replay(m, db, slot, None, cfg)
            db.valid[slot] = False
            db.frame_id[slot] = -1
    return m, db


# ---------------------------------------------------------------------------
# Submaps and the host-side pipeline
# ---------------------------------------------------------------------------

def _check_supported(cfg: SystemConfig, mesh) -> None:
    p = cfg.pipeline
    if p.new_submap_threshold >= 0 or p.map_memory_budget_mb >= 0:
        raise NotImplementedError(
            "more than one submap (new_submap_threshold >= 0) and the map "
            "memory budget are not ported yet (ROADMAP.md Queue A, A7)")
    if mesh is not None:
        raise NotImplementedError(
            "a sharded map is not ported yet (ROADMAP.md Queue A, A10)")
    if p.sensor == "mono":
        raise NotImplementedError(
            "sensor='mono' is not ported yet (ROADMAP.md Queue A, A8)")


class SubmapManager:
    """The single-submap registry the chunk path reads (the JAX
    SubmapManager holds many submaps, spills them to the host and defers
    their corrections; that is ROADMAP.md Queue A, A7): one active map and
    its fusion DB, on `device`."""

    def __init__(self, cfg: SystemConfig, device=None):
        dev = resolve_device(device)
        self.cfg = cfg
        self.maps: List[tsdf_ops.MapState] = [tsdf_ops.make_map(cfg.tsdf, dev)]
        self.dbs: List[FusionDB] = [make_fusion_db(cfg, dev)]
        # deferred corrections of inactive submaps: none with one submap
        self.pending_corrections: List[dict] = [{}]
        self.dirty: List[bool] = [True]

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

    def mark_dirty(self, idx: int) -> None:
        self.dirty[idx] = True

    def finalize_spills(self) -> None:
        """No spill is ever in flight: there is no memory budget."""

    def enforce_memory_budget(self, async_spill: bool = False) -> List[int]:
        """No budget (map_memory_budget_mb < 0): nothing to evict."""
        return []

    def local_map_size(self, idx: int) -> int:
        return int(tsdf_ops.num_allocated_blocks(self.maps[idx]))


def _pose_tensor(T, device) -> torch.Tensor:
    """A (4, 4) pose, tensor or array, as float32 on `device`."""
    if isinstance(T, torch.Tensor):
        return T.to(device, torch.float32)
    return upload(np.asarray(T, np.float32), device)


class DenseSLAM:
    """Host-side state of the dense pipeline: the frontend state, one
    submap and its fusion DB, the frame counter and the pose history.
    `process_frame` runs one frame (odometry, keyframe-gated depth,
    post-processing and fusion); the chunk path of models/system.py runs
    the throughput scans on the same state; backend pose updates flow into
    the map through `apply_pose_updates`; `raycast_view` renders the map
    with the configured renderer (`pipeline.renderer`: "splat", the
    default, else the sphere-traced raycast). On `device` (None = the
    CUDA card; raises without one). The per-frame RANSAC draws come from
    `generator`, seeded by `seed`, unless `process_frame` is handed them.

    Not ported: more than one submap and the memory budget (ROADMAP.md
    Queue A, A7), a sharded map (A10) and sensor="mono" (A8); those
    options raise NotImplementedError."""

    def __init__(self, cfg: SystemConfig, mesh=None, device=None,
                 seed: int = 0):
        _check_supported(cfg, mesh)
        if cfg.correction.enabled and cfg.tsdf.storage_dtype == "bfloat16":
            warnings.warn(
                "online correction replays de-integration against a "
                "bfloat16-quantised map: the de-fuse/re-fuse inverse is "
                "approximate (~1/256 tsdf error per correction) instead of "
                "exact. Use float32 storage when correction fidelity "
                "matters.", stacklevel=2)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.fe_state = fe.init_frontend(cfg, device=self.device)
        self.submaps = SubmapManager(cfg, self.device)
        self.frame = 0
        self.current_keyframes = 0
        self.pose_history: List[Tuple[int, np.ndarray]] = []
        self.last_fused_depth: Optional[torch.Tensor] = None
        self.last_fused_T: Optional[torch.Tensor] = None
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
        """Process one stereo (or RGB-D) frame: odometry, then on keyframes
        where tracking holds the depth (the given one, else SGM of the
        pair), the cross-frame cull when `postprocess.enabled`, and
        fusion. Images are (H, W) gray or (H, W, 3) colour tensors on the
        system's device. Returns the frame's telemetry.

        Odometry: `pose_override` (a (4, 4) pose) replaces it; else RGB-D
        VO (sensor="rgbd") or stereo VO with the PD controller's
        `budget_scale`, both drawing their RANSAC hypotheses from `draws`
        (K, 3) or the system's generator; with use_external_odometry=False
        ICP of the depth against a render of the map at the last fused
        pose. The JAX version runs SGM on every frame that has a right
        image; here it runs only where the depth is used (ICP, or a
        keyframe), which gives the same results. Two values are read back
        per frame: the odometry's flags, then the pose and block count."""
        cfg = self.cfg
        p = cfg.pipeline
        if left.dim() == 3:
            left = rgb_to_gray(left)
        if right is not None and right.dim() == 3:
            right = rgb_to_gray(right)

        if pose_override is not None:
            T_wc = _pose_tensor(pose_override, self.device)
            self.fe_state = self.fe_state._replace(T_wc=T_wc)
            tracking_ok, vo_stats = True, {}
        elif p.use_external_odometry:
            if draws is None:
                draws = ransac.draw_hypotheses(cfg.frontend.ransac_iters,
                                               self.generator)
            if p.sensor == "rgbd":
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

        fused = False
        if ((depth is not None or right is not None) and tracking_ok
                and self.frame % p.keyframe_every == 0):
            if depth is None:
                depth, _ = stereo_ops.compute_depth(left, right, cfg.rig,
                                                    cfg.stereo)
            if cfg.postprocess.enabled and self.last_fused_depth is not None:
                depth = depth_postprocess(depth, T_wc, self.last_fused_depth,
                                          self.last_fused_T, cfg)
            m, self.db = fuse_keyframe(self.submaps.active, self.db, depth,
                                       left, T_wc, self.frame, cfg)
            self.submaps.active = m
            self.last_fused_depth = depth
            self.last_fused_T = T_wc
            self.current_keyframes += 1
            fused = True
            self.maybe_spawn_submap(T_wc)

        # pose and block count in one read-back
        pose_nb = torch.cat([
            T_wc.reshape(-1).to(torch.float32),
            tsdf_ops.num_allocated_blocks(self.submaps.active)
            .to(torch.float32)[None]]).cpu().numpy()
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

    def maybe_spawn_submap(self, T_wc, defer_enforce: bool = False) -> bool:
        """The new-submap policy; new_submap_threshold < 0 (the only value
        the port accepts) disables it."""
        return False

    def flush_deferred_corrections(self) -> int:
        """Sequence-end replay of deferred corrections: with one submap
        nothing is ever deferred. Returns the number of submaps flushed."""
        return 0

    def apply_pose_updates(self, frame_ids: np.ndarray, poses: np.ndarray,
                           enforce_budget: bool = True) -> int:
        """Feed backend-optimised poses (frame_ids (n,), poses (n, 4, 4))
        to online correction of the active submap. Returns the number of
        re-fused keyframes."""
        if not self.cfg.correction.enabled:
            return 0
        lut = {int(f): i for i, f in enumerate(frame_ids)}
        si = self.submaps.active_idx
        db = self.submaps.dbs[si]
        db_ids = db.frame_id.cpu().numpy()
        opt_T = np.tile(np.eye(4, dtype=np.float32), (db_ids.shape[0], 1, 1))
        opt_valid = np.zeros(db_ids.shape[0], bool)
        for slot, fid in enumerate(db_ids):
            if int(fid) in lut:
                opt_T[slot] = poses[lut[int(fid)]]
                opt_valid[slot] = True
        if not opt_valid.any():
            return 0
        m, db, num = online_correction(
            self.submaps.maps[si], db, upload(opt_T, self.device),
            upload(opt_valid, self.device), self.cfg)
        self.submaps.maps[si] = m
        self.submaps.dbs[si] = db
        if num > 0:
            self.submaps.mark_dirty(si)
        if enforce_budget:
            self.submaps.enforce_memory_budget()
        return num

    def purge_keyframes(self, culled_frame_ids: np.ndarray) -> None:
        """Remove the fused keyframes the backend culled."""
        db_ids = self.db.frame_id.cpu().numpy()
        culled = upload(np.isin(db_ids, culled_frame_ids), self.device)
        m, db = purge_culled(self.submaps.active, self.db, culled, self.cfg)
        self.submaps.active = m
        self.db = db

    def decay_catchup(self) -> None:
        """Sequence-end decay: min_decay_age passes ignoring the age gate."""
        if not self.cfg.decay.enabled:
            return
        w = self.cfg.decay.max_decay_weight
        for _ in range(self.cfg.decay.min_decay_age):
            self.submaps.active = tsdf_ops.decay(self.submaps.active, w, 0,
                                                 force_all=True)

    def memory_bytes(self) -> int:
        """Used map bytes (16 per voxel of every allocated block)."""
        blocks = sum(self.submaps.local_map_size(i)
                     for i in range(self.submaps.num_local_maps))
        return blocks * 16 * tsdf_ops.BLOCK_VOL

    @property
    def current_pose(self) -> np.ndarray:
        return self.fe_state.T_wc.cpu().numpy()

    def trajectory(self) -> List[Tuple[int, np.ndarray]]:
        return list(self.pose_history)
