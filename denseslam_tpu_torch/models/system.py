"""The whole SLAM system (port of denseslam_tpu/models/system.py): the
dense pipeline, frame by frame (`process_frame`: one frame, and a backend
tick on every fused keyframe) or a chunk at a time (`process_chunk`: the
chunk scan, `process_sequence`, or `process_sequence_rgbd` /
`process_sequence_mono` for sensor="rgbd" / "mono", then keyframe
registration and one backend tick per chunk);
the tick runs loop detection and pose-graph relaxation, local BA and
keyframe culling, and its optimised poses flow back into the map through
online correction. Also the PD controller on the RANSAC budget, which the
per-frame path feeds with its wall time.

RANSAC draws are an argument of both entry points (the port's seam: the
parity tests hand them the JAX draws); without them they come from the
pipeline's `torch.Generator`, seeded by `seed`. The JAX version's `warmup`
compiles its device programs ahead of the drive; nothing here compiles,
and it is not ported.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Optional

import numpy as np
import torch

from ..config import SystemConfig
from .backend import Backend, _feature_row, upload
from .dense_slam import (DenseSLAM, process_sequence, process_sequence_mono,
                         process_sequence_rgbd)


class PDController:
    """PD control of a latency-coupled budget (gains kp, kd; the scale
    moves within [lo, hi] to hold `target_ms`)."""

    def __init__(self, kp: float, kd: float, target_ms: float,
                 lo: float = 0.25, hi: float = 1.0):
        self.kp, self.kd = kp, kd
        self.target = target_ms
        self.lo, self.hi = lo, hi
        self.prev_err = 0.0
        self.scale = 1.0

    def update(self, measured_ms: float) -> float:
        err = (self.target - measured_ms) / self.target
        d = err - self.prev_err
        self.prev_err = err
        self.scale = float(np.clip(self.scale + self.kp * err * 0.1
                                   + self.kd * d, self.lo, self.hi))
        return self.scale


def _orth(T):
    """Project the rotation part back onto SO(3) (float64 SVD): the chain
    composes f32 products every keyframe and `_inv_se3` takes R^T as the
    inverse, so any scale or skew in R would compound hop by hop."""
    U, _, Vt = np.linalg.svd(np.asarray(T[:3, :3], np.float64))
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = (U @ Vt).astype(np.float32)
    out[:3, 3] = T[:3, 3]
    return out


def _inv_se3(T):
    R, t = T[:3, :3], T[:3, 3]
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out


class SLAMSystem:
    """DenseSLAM + Backend on `device` (None = the CUDA card; raises
    without one). `verify_draws` is the backend's seam for loop
    verification draws (models/backend.py)."""

    def __init__(self, cfg: SystemConfig, seed: int = 0,
                 ba_every: int = 4, loop_every: int = 1,
                 reloc_after: int = 3, device=None,
                 verify_draws: Optional[Callable[[int], torch.Tensor]] = None):
        self.cfg = cfg
        self.slam = DenseSLAM(cfg, device=device, seed=seed)
        self.device = self.slam.device
        self.backend = Backend(cfg, device=self.device,
                               verify_draws=verify_draws)
        self.ba_every = ba_every
        self.loop_every = loop_every
        self.reloc_after = reloc_after   # lost frames before relocalizing
        self.pd = PDController(cfg.frontend.pd_kp, cfg.frontend.pd_kd,
                               cfg.frontend.target_frame_ms)
        self.num_loops = 0
        self.num_corrections = 0
        self.num_relocs = 0
        self.num_culled = 0
        self._lost_streak = 0
        self._tick_count = 0
        self.phase_s = defaultdict(float)   # wall seconds per phase
        # raw scan pose of the last registered keyframe (relative chaining)
        self._chain_scan = None
        # relocalization: a qualifying lost streak arms `_reloc_pending`;
        # `_lost_anchor_nkf` counts the keyframes that existed when the
        # streak began (later ones carry the blackout's drift)
        self._reloc_pending = False
        self._lost_anchor_nkf = 0
        self._reloc_extra = None
        self._prefetched = None    # (frame0, n, stats) from prefetch_chunk

    def _dispatch_scan(self, lefts, rights, draws=None):
        """Run the chunk scan on the current state and advance the state.
        Returns (frame0, n, stats) with stats on the device."""
        t0 = time.perf_counter()
        n = lefts.shape[0]
        slam = self.slam
        # rgbd and mono take the depths in `rights`; mono's VO ignores
        # them, fusion and the backend's currency consume them
        seq = {"rgbd": process_sequence_rgbd,
               "mono": process_sequence_mono}.get(self.cfg.pipeline.sensor,
                                                   process_sequence)
        frame0 = int(slam.frame)
        fids = torch.arange(frame0, frame0 + n, dtype=torch.int32,
                            device=lefts.device)
        st, m, db, stats = seq(slam.fe_state, slam.submaps.active, slam.db,
                               lefts, rights, fids, self.cfg, draws=draws)
        slam.fe_state = st
        slam.submaps.active = m
        slam.db = db
        slam.frame = frame0 + n
        self.phase_s["scan_dispatch"] += time.perf_counter() - t0
        return frame0, n, stats

    def prefetch_chunk(self, lefts, rights, draws=None) -> None:
        """Run the NEXT chunk's scan ahead of between-chunk host work; the
        next `process_chunk` call must pass the same batch."""
        if self._prefetched is not None:
            raise RuntimeError("prefetch_chunk called twice without an "
                               "intervening process_chunk")
        self._prefetched = self._dispatch_scan(lefts, rights, draws)

    def process_chunk(self, lefts, rights, draws=None) -> dict:
        """Run a frame batch (lefts, rights (N, H, W); for sensor="rgbd" or
        "mono", grays and depths) through the chunk scan, register every
        fused keyframe with the backend by relative chaining, relocalize
        after a lost streak, run ONE backend tick for the chunk and
        re-anchor the chunk's history and the frontend once. `draws`
        (N, K, 3), (N, K, 8) for mono, are the scan's RANSAC draws
        (default: from the frontend state's key, as in the JAX package).

        Returns the last frame's telemetry and the chunk's tracking flags."""
        t0 = time.perf_counter()
        slam = self.slam
        if self._prefetched is not None:
            frame0, n, stats = self._prefetched
            self._prefetched = None
            if n != lefts.shape[0]:
                raise ValueError(
                    f"prefetched chunk has {n} frames, caller passed "
                    f"{lefts.shape[0]}: prefetch_chunk/process_chunk must "
                    "receive the same batch")
        else:
            frame0, n, stats = self._dispatch_scan(lefts, rights, draws)

        # ONE read-back: poses, flags and the keyframes' retrieval sketches
        tf = time.perf_counter()
        sig_shape = stats["sig"].shape
        h = torch.cat([stats["T_wc"].reshape(-1),
                       stats["fused"].to(torch.float32),
                       stats["tracking_ok"].to(torch.float32),
                       stats["sig"].reshape(-1)]).cpu().numpy()
        T_all = h[:16 * n].reshape(n, 4, 4)
        fused_flags = h[16 * n:17 * n] > 0.5
        ok_frames = h[17 * n:18 * n] > 0.5
        sigs = h[18 * n:].reshape(sig_shape)
        self.phase_s["scan_wait_fetch"] += time.perf_counter() - tf
        t_sw = time.perf_counter()
        slam.submaps.finalize_spills()
        self.phase_s["spill_wait"] += time.perf_counter() - t_sw
        fused_any = bool(fused_flags.any())

        # register every fused keyframe by RELATIVE CHAINING: the previous
        # keyframe's current (post-BA) stored pose times the raw scan
        # motion since it; scan poses predate the tick, and registering them
        # as absolutes would turn the optimisation delta into false motion
        t_reg = time.perf_counter()
        j_last = None          # scan index of the last registered keyframe
        kf_before = [self.backend.num_keyframes] * (n + 1)
        for j in range(n):
            kf_before[j + 1] = kf_before[j]
            if fused_flags[j]:
                fid = int(frame0 + j)
                if self._chain_scan is None or not self.backend.keyframes:
                    T_reg = _orth(T_all[j])
                else:
                    rel = _inv_se3(_orth(self._chain_scan)) @ _orth(T_all[j])
                    T_reg = _orth(
                        np.asarray(self.backend.keyframes[-1].T_wc,
                                   np.float32) @ rel)
                self.backend.add_keyframe(
                    fid, T_reg, _feature_row(stats["feats_l"], j),
                    _feature_row(stats["feats_r"], j), sig=sigs[j])
                self._chain_scan = np.asarray(T_all[j], np.float32)
                j_last = j
                kf_before[j + 1] += 1
        self.phase_s["register"] += time.perf_counter() - t_reg

        # ---- lost-streak accounting + relocalization ---------------------
        t_rl = time.perf_counter()
        streak = self._lost_streak
        for i in range(n):
            if not ok_frames[i] and not (frame0 == 0 and i == 0):
                if streak == 0:
                    self._lost_anchor_nkf = kf_before[i]
                streak += 1
                if self.reloc_after and streak >= self.reloc_after:
                    self._reloc_pending = True
            else:
                streak = 0
        self._lost_streak = streak

        if (self._reloc_pending and self.reloc_after
                and self.backend.num_keyframes):
            T_rec = self.backend.relocalize(_feature_row(stats["feats_l"], n - 1),
                                            _feature_row(stats["feats_r"], n - 1))
            if T_rec is not None:
                self._apply_reloc(T_rec, T_all, j_last)
        D_extra = self._reloc_extra
        self.phase_s["reloc"] += time.perf_counter() - t_rl

        if fused_any and j_last is not None:
            t_sp = time.perf_counter()
            anchor = np.asarray(self.backend.keyframes[-1].T_wc, np.float32)
            slam.maybe_spawn_submap(anchor, defer_enforce=True)
            self.phase_s["spawn"] += time.perf_counter() - t_sp

        # ---- ONE backend tick for the whole chunk ------------------------
        t_tk = time.perf_counter()
        if fused_any:
            self._chunk_tick()
        self.phase_s["tick"] += time.perf_counter() - t_tk
        t_sp = time.perf_counter()
        slam.submaps.enforce_memory_budget(async_spill=True)
        self.phase_s["spawn"] += time.perf_counter() - t_sp

        # ---- the tick's (and a relocalization's) world-side correction,
        # applied to the chunk's history and the frontier in one re-anchor
        D_run = np.eye(4, dtype=np.float32)
        if j_last is not None:
            fid_last = int(frame0 + j_last)
            T_stored = next(
                (np.asarray(k.T_wc, np.float32)
                 for k in reversed(self.backend.keyframes)
                 if k.frame_id == fid_last), None)
            if T_stored is not None:
                D_run = _orth(T_stored @ _inv_se3(_orth(T_all[j_last])))
        elif D_extra is not None:
            D_run = D_extra
        self._reloc_extra = None

        for j in range(n):
            slam.pose_history.append((int(frame0 + j), D_run @ T_all[j]))
        T_last = _orth(slam.pose_history[-1][1])
        if not np.allclose(D_run, np.eye(4), atol=1e-7):
            slam.fe_state = slam.fe_state._replace(
                T_wc=upload(T_last, self.device))
            if self._chain_scan is not None:
                self._chain_scan = _orth(D_run @ self._chain_scan)

        return dict(
            T_wc=T_last,
            tracking_ok=bool(ok_frames[1:].all()),
            tracking_ok_frames=ok_frames,
            fused=fused_any,
            frames=n,
            chunk_ms=(time.perf_counter() - t0) * 1000.0,
            num_loops=self.num_loops,
            num_corrections=self.num_corrections,
            num_relocs=self.num_relocs,
            ba_ms=self.backend.last_ba_ms,
        )

    def _apply_reloc(self, T_rec, T_all, j_last) -> None:
        """Correct the drift-suspect keyframes (registered since the lost
        streak began) and the frontier by the relocalized pose `T_rec` of
        the chunk's last frame."""
        n = T_all.shape[0]
        if j_last is not None:
            C_pre = _orth(np.asarray(self.backend.keyframes[-1].T_wc,
                                     np.float32) @ _inv_se3(_orth(T_all[j_last])))
        else:
            C_pre = np.eye(4, dtype=np.float32)
        est_last = _orth(C_pre @ T_all[n - 1])
        D_reloc = _orth(_orth(np.asarray(T_rec, np.float32))
                        @ _inv_se3(est_last))
        # a common world-side delta leaves intra-group relative edges as
        # they are
        kfs = self.backend.keyframes
        a0 = min(self._lost_anchor_nkf, len(kfs))
        for idx in range(a0, len(kfs)):
            kfs[idx] = kfs[idx]._replace(T_wc=_orth(D_reloc @ kfs[idx].T_wc))
        # the one odometry edge spanning the blackout encoded the constant-
        # velocity guess: recompute it from the corrected poses, low weight
        if 0 < a0 < len(kfs):
            fa, fb = kfs[a0 - 1].frame_id, kfs[a0].frame_id
            Ta = _orth(np.asarray(kfs[a0 - 1].T_wc, np.float32))
            Tb = _orth(np.asarray(kfs[a0].T_wc, np.float32))
            self.backend.odom_edges = [
                e for e in self.backend.odom_edges
                if not (e[0] == fa and e[1] == fb)]
            self.backend.odom_edges.append((fa, fb, _inv_se3(Ta) @ Tb, 0.3))
        # the motion prior across the jump is garbage
        fe_state = self.slam.fe_state
        self.slam.fe_state = fe_state._replace(
            T_delta_prev=torch.eye(4, dtype=torch.float32,
                                   device=self.device),
            prior_ok=torch.zeros((), dtype=torch.bool, device=self.device))
        self.num_relocs += 1
        self._reloc_pending = False
        self._lost_streak = 0
        if j_last is None:
            # no keyframe of this chunk anchors the correction: fold it
            # into the frontier through the history path
            self._reloc_extra = D_reloc

    def _chunk_tick(self) -> None:
        """One loop detection (every `loop_every` ticks), one local BA with
        culling, and ONE merged correction pass for the chunk."""
        updates: dict = {}
        t0 = time.perf_counter()
        self._tick_count += 1
        if (self.loop_every and self._tick_count % self.loop_every == 0
                and self.backend.detect_loop() is not None):
            self.num_loops += 1
            t_g = time.perf_counter()
            ids, opt = self.backend.optimize_graph()
            self.phase_s["dl_graph"] += time.perf_counter() - t_g
            for f, p in zip(ids, opt):
                updates[int(f)] = p
        self.phase_s["tick_loop"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        if self.ba_every and self.backend.num_keyframes >= 2:
            res = self.backend.local_ba()
            if res is not None:
                ids, opt = res
                for f, p in zip(ids, opt):   # BA refines on top of the
                    updates[int(f)] = p      # relaxed poses: later wins
                culled = self.backend.cull_redundant()
                if culled:
                    self.slam.purge_keyframes(np.asarray(culled))
                    self.num_culled += len(culled)
        self.phase_s["tick_ba"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        if updates:
            ids = np.fromiter(updates.keys(), np.int64, len(updates))
            poses = np.stack([updates[int(f)] for f in ids])
            self.num_corrections += self.slam.apply_pose_updates(
                ids, poses, enforce_budget=False)
        self.phase_s["tick_apply"] += time.perf_counter() - t0

    def process_frame(self, left, right=None, depth=None,
                      timestamp: Optional[float] = None,
                      draws: Optional[torch.Tensor] = None) -> dict:
        """Run one frame through `DenseSLAM.process_frame` at the PD
        controller's RANSAC budget; relocalize after `reloc_after` lost
        frames; register a fused keyframe with the backend and run its
        tick, whose optimisation moves the frontend pose at once. `draws`
        (K, 3), (K, 8) for mono: the frame's RANSAC draws (default: from
        the frontend state's key).
        The frame's wall time feeds the PD controller."""
        if self._prefetched is not None:
            raise RuntimeError("a prefetched chunk is pending: call "
                               "process_chunk before process_frame")
        t0 = time.perf_counter()
        slam = self.slam
        out = slam.process_frame(left, right, depth=depth,
                                 timestamp=timestamp,
                                 budget_scale=self.pd.scale, draws=draws)

        # relocalization after a sustained loss: the constant-velocity
        # fallback alone never re-locks
        if out["tracking_ok"]:
            self._lost_streak = 0
        else:
            self._lost_streak += 1
            if (self.reloc_after and self._lost_streak >= self.reloc_after
                    and self.backend.num_keyframes):
                st = slam.fe_state
                T = self.backend.relocalize(st.feats_l, st.feats_r)
                if T is not None:
                    T = np.asarray(T, np.float32)
                    slam.fe_state = st._replace(
                        T_wc=upload(T, self.device),
                        T_delta_prev=torch.eye(4, dtype=torch.float32,
                                               device=self.device),
                        prior_ok=torch.zeros((), dtype=torch.bool,
                                             device=self.device))
                    slam.pose_history[-1] = (slam.pose_history[-1][0], T)
                    out["T_wc"] = T
                    out["relocalized"] = True
                    self.num_relocs += 1
                    self._lost_streak = 0

        if out["fused"]:
            st = slam.fe_state
            self.backend.add_keyframe(out["frame"], out["T_wc"], st.feats_l,
                                      st.feats_r)
            self._chain_scan = None     # per-frame registration breaks the
            self._backend_tick()        # chunk path's scan chain

        frame_ms = (time.perf_counter() - t0) * 1000.0
        out["frame_ms"] = frame_ms
        out["budget_scale"] = self.pd.update(frame_ms)
        out["num_loops"] = self.num_loops
        out["num_corrections"] = self.num_corrections
        out["ba_ms"] = self.backend.last_ba_ms
        return out

    def _backend_tick(self, resync: bool = True) -> np.ndarray:
        """The per-frame path's keyframe-rate backend work: loop closing
        every `loop_every` keyframes, local BA (and culling) every
        `ba_every`; the optimised poses re-fuse the map and, with
        `resync`, move the frontend pose. Returns the world-side delta
        applied to it."""
        D = np.eye(4, dtype=np.float32)
        be = self.backend
        nkf = be.num_keyframes
        if self.loop_every and nkf % self.loop_every == 0:
            if be.detect_loop() is not None:
                self.num_loops += 1
                T_before = be.keyframes[-1].T_wc.copy()
                ids, opt = be.optimize_graph()
                self.num_corrections += self.slam.apply_pose_updates(ids, opt)
                if resync:
                    D = self._resync_pose(T_before) @ D
        if self.ba_every and nkf >= 2 and nkf % self.ba_every == 0:
            T_before = be.keyframes[-1].T_wc.copy()
            res = be.local_ba()
            if res is not None:
                ids, opt = res
                self.num_corrections += self.slam.apply_pose_updates(ids, opt)
                if resync:
                    D = self._resync_pose(T_before) @ D
                culled = be.cull_redundant()
                if culled:
                    self.slam.purge_keyframes(np.asarray(culled))
                    self.num_culled += len(culled)
        return D

    def _resync_pose(self, T_before: np.ndarray) -> np.ndarray:
        """Move the frontend pose by the world-side delta the backend
        applied to the last keyframe (T_before -> its stored pose): a no-op
        when the optimiser left it, the overwrite when the frontend is at
        the keyframe. Returns the delta."""
        eye = np.eye(4, dtype=np.float32)
        if not self.backend.keyframes:
            return eye
        last = self.backend.keyframes[-1]
        delta = (np.asarray(last.T_wc, np.float32)
                 @ _inv_se3(np.asarray(T_before, np.float32)))
        if np.allclose(delta, eye, atol=1e-7):
            return eye
        st = self.slam.fe_state
        self.slam.fe_state = st._replace(
            T_wc=upload(delta, self.device) @ st.T_wc)
        return delta

    def finish(self) -> None:
        """Sequence end: land in-flight spills, replay deferred corrections,
        then the decay catch-up."""
        self.slam.submaps.finalize_spills()
        self.slam.flush_deferred_corrections()
        self.slam.decay_catchup()

    def memory_bytes(self) -> int:
        return self.slam.memory_bytes()

    def trajectory(self):
        return self.slam.trajectory()

    def keyframe_trajectory(self):
        return self.backend.keyframe_poses()
