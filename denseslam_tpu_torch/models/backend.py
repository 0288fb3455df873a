"""Sparse mapping backend: keyframe window BA, loop closure, pose graph
(port of denseslam_tpu/models/backend.py).

A host-side keyframe registry around three device programs:
`build_window_problem` (stacked (K, N) features -> BAProblem by stereo
triangulation and descriptor association), `ops/ba.py` `solve` and
`ops/posegraph.py` `optimize`. Retrieval scores a keyframe's descriptor
sketch (`_signature`) against a sketch buffer on the device; each
shortlisted candidate is verified geometrically by the stereo VO's RANSAC.

Each verification draws its RANSAC hypotheses from a threefry key made of
the query and candidate indices, as the JAX version does
(`PRNGKey(qi * 31 + ci)`; relocalization: `7000 + num_keyframes * 31 +
ci`), through utils/threefry.py; a caller may hand in `verify_draws(seed)`
for that seed instead.

Host reads: one for the window solve (costs, poses and observation mask
in one transfer), one per retrieval and one per verification batch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import SystemConfig
from ..device import resolve_device
from ..ops import ba, matching, posegraph, ransac
from ..ops.features import Features
from ..utils import lie, threefry
from ..utils.numerics import true_div

_SIG_M = 256     # descriptors retained per keyframe sketch
_SIG_TAU = 0.85  # cosine above which a descriptor pair counts as a match


class Keyframe(NamedTuple):
    frame_id: int
    T_wc: np.ndarray          # (4, 4) f32
    feats_l: Features         # on the backend's device
    feats_r: Features
    signature: np.ndarray     # (_SIG_M, D) retrieval sketch


def upload(a, device) -> torch.Tensor:
    """A host array on `device`; to the card through pinned memory without
    waiting for it."""
    t = torch.tensor(np.asarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _feature_row(f: Features, k: int) -> Features:
    return Features(*(x[k] for x in f))


# ---------------------------------------------------------------------------
# Window BA problem construction
# ---------------------------------------------------------------------------

def build_window_problem(feats_l: Features, feats_r: Features,
                         T_wc: torch.Tensor, cfg: SystemConfig,
                         fixed: Optional[torch.Tensor] = None) -> ba.BAProblem:
    """Triangulate landmarks from each keyframe's stereo matches (the
    strongest max_landmarks / K per keyframe) and associate them across
    the window by descriptor and projection gating. feats_* are stacked
    (K, N, ...); fixed (K,) is the gauge mask (default: keyframe 0)."""
    rig = cfg.rig
    intr = rig.intr
    K = T_wc.shape[0]
    dev = T_wc.device
    per_kf = cfg.backend.max_landmarks // K

    stereo_idx = torch.stack([
        matching.match_stereo(_feature_row(feats_l, k),
                              _feature_row(feats_r, k), cfg.frontend)
        for k in range(K)]).long()                          # (K, N)

    # landmark selection: the strongest stereo-matched features per keyframe
    has_st = stereo_idx >= 0
    sidx = torch.clamp(stereo_idx, min=0)
    disp = feats_l.uv[..., 0] - torch.gather(feats_r.uv[..., 0], 1, sidx)
    good = feats_l.valid & has_st & (disp > 1.0)
    sel_score = torch.where(good, feats_l.score, float("-inf"))
    # ties keep the lower index, as lax.top_k does
    host_idx = torch.sort(sel_score, dim=1, descending=True,
                          stable=True).indices[:, :per_kf]  # (K, per_kf)
    host_ok = torch.gather(good, 1, host_idx)

    def take(x, idx):
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    uv_l = take(feats_l.uv, host_idx)
    ridx = torch.gather(stereo_idx, 1, host_idx)
    uv_r = take(feats_r.uv, torch.clamp(ridx, min=0))
    desc = take(feats_l.desc, host_idx)
    cls = torch.gather(feats_l.cls, 1, host_idx)

    d = torch.clamp(uv_l[..., 0] - uv_r[..., 0], min=1e-3)
    z = true_div(intr.fx * rig.baseline_m, d)
    x = (uv_l[..., 0] - intr.cx) * rig.baseline_m / d
    y = (uv_l[..., 1] - intr.cy) * rig.baseline_m / d * (intr.fx / intr.fy)
    pts_w = lie.transform_points(T_wc, torch.stack([x, y, z], dim=-1))

    L = K * per_kf
    pts_w = pts_w.reshape(L, 3)
    desc = desc.reshape(L, desc.shape[-1])
    cls = cls.reshape(L)
    point_valid = (host_ok & (z > 0.2) & (z < 80.0)).reshape(L)

    # association: landmark descriptors against every keyframe's features
    T_cw = lie.inv_T(T_wc)
    d2 = (desc * desc).sum(dim=-1)
    obs, mask = [], []
    for k in range(K):
        fl = _feature_row(feats_l, k)
        pc = lie.transform_points(T_cw[k], pts_w)
        zc = torch.clamp(pc[:, 2], min=1e-6)
        pu = pc[:, 0] / zc * intr.fx + intr.cx
        pv = pc[:, 1] / zc * intr.fy + intr.cy
        in_img = ((pc[:, 2] > 0.2) & (pu >= 0) & (pu < intr.width)
                  & (pv >= 0) & (pv < intr.height))
        cost = (d2[:, None] + (fl.desc * fl.desc).sum(dim=-1)[None, :]
                - 2.0 * desc @ fl.desc.T)
        du = pu[:, None] - fl.uv[None, :, 0]
        dv = pv[:, None] - fl.uv[None, :, 1]
        gate = (point_valid[:, None] & in_img[:, None] & fl.valid[None, :]
                & (cls[:, None] == fl.cls[None, :])
                & (du.abs() < 12.0) & (dv.abs() < 12.0))
        midx = matching.mutual_nn(torch.where(gate, cost, 1e9)).long()
        ok = midx >= 0
        m0 = torch.clamp(midx, min=0)
        uv = fl.uv[m0]
        rmatch = stereo_idx[k][m0]
        has_r = ok & (rmatch >= 0)
        ur = feats_r.uv[k][torch.clamp(rmatch, min=0), 0]
        obs.append(torch.stack([uv[:, 0], uv[:, 1],
                                torch.where(has_r, ur, -1.0)], dim=-1))
        mask.append(ok)
    obs = torch.stack(obs, dim=1)                          # (L, K, 3)
    mask = torch.stack(mask, dim=1)                        # (L, K)

    # landmarks need >= 2 observations to constrain anything
    point_valid = point_valid & (mask.to(torch.int32).sum(dim=1) >= 2)
    if fixed is None:
        fixed = torch.arange(K, device=dev) == 0
    return ba.BAProblem(T_wc=T_wc, points_w=pts_w, obs=obs,
                        obs_mask=mask & point_valid[:, None], fixed=fixed,
                        point_valid=point_valid)


# ---------------------------------------------------------------------------
# Backend: host orchestration
# ---------------------------------------------------------------------------

class Backend:
    """Keyframe registry, window BA, culling, loop closure and pose graph.

    `device` (None = the CUDA card; raises without one) holds the
    keyframes' features, the sketch buffer and the solves. `verify_draws`
    maps a verification's seed to its (k, 3) RANSAC draws; without it they
    are `randint(PRNGKey(seed), (k, 3), 0, 2^31 - 1)`, JAX's draws."""

    def __init__(self, cfg: SystemConfig, device=None,
                 verify_draws: Optional[Callable[[int], torch.Tensor]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.keyframes: List[Keyframe] = []
        self.last_ba_ms: float = 0.0     # window build + solve + read-back
        self.ba_rejects: int = 0         # diverged / non-improving solves
        self.pg_rejects: int = 0
        # pose-graph edges keyed by frame id: (fid_i, fid_j, T_ij, weight)
        self.odom_edges: List[Tuple[int, int, np.ndarray, float]] = []
        self.loop_edges: List[Tuple[int, int, np.ndarray, float]] = []
        self.loop_log: List[dict] = []
        self.cull_margins: List[float] = []
        self.phase_s: dict = {}
        # the last BA window's observation mask: cull_redundant's evidence
        self._last_window_ids: Optional[np.ndarray] = None
        self._last_window_mask: Optional[np.ndarray] = None
        self.verify_draws = verify_draws
        # verification runs half the VO's hypothesis budget (at least 64)
        self._verify_cfg = dataclasses.replace(
            cfg.frontend,
            ransac_iters=max(64, cfg.frontend.ransac_iters // 2))
        cap = cfg.backend.retrieval_capacity
        if cap % 128:
            raise ValueError("retrieval_capacity must be a multiple of 128")
        self._sig_cap = cap
        self._sig_buf: Optional[torch.Tensor] = None   # (cap, M, D), lazy
        self._sig_valid = np.zeros(cap, bool)
        self._sig_slot: dict = {}                      # frame_id -> slot
        self._sig_next = 0
        self._sig_free: List[int] = []

    # -- keyframe registry -------------------------------------------------

    def add_keyframe(self, frame_id: int, T_wc: np.ndarray,
                     feats_l: Features, feats_r: Features,
                     sig: Optional[np.ndarray] = None) -> int:
        """Register a keyframe; `sig` is its retrieval sketch (computed from
        feats_l when None) and an odometry edge joins it to the last one."""
        if sig is None:
            sig = _signature(feats_l)
        T_wc = np.asarray(T_wc, np.float32)
        kf = Keyframe(frame_id, T_wc, feats_l, feats_r, np.asarray(sig))
        if self.keyframes:
            prev = np.asarray(self.keyframes[-1].T_wc, np.float32)
            T_rel = np.eye(4, dtype=np.float32)
            T_rel[:3, :3] = prev[:3, :3].T @ T_wc[:3, :3]
            T_rel[:3, 3] = prev[:3, :3].T @ (T_wc[:3, 3] - prev[:3, 3])
            self.odom_edges.append(
                (self.keyframes[-1].frame_id, frame_id, T_rel, 1.0))
        self.keyframes.append(kf)
        self._sig_push(frame_id, kf.signature)
        return len(self.keyframes) - 1

    def _sig_push(self, frame_id: int, sig: np.ndarray) -> None:
        if self._sig_free:
            slot = self._sig_free.pop()
        elif self._sig_next < self._sig_cap:
            slot = self._sig_next
            self._sig_next += 1
        else:       # capacity exhausted: newest keyframes go unindexed
            return  # (retrieval takes the host path for them)
        if self._sig_buf is None:
            m, d = sig.shape
            self._sig_buf = torch.zeros((self._sig_cap, m, d),
                                        dtype=torch.float32, device=self.device)
        self._sig_buf[slot] = upload(np.asarray(sig, np.float32), self.device)
        self._sig_valid[slot] = True
        self._sig_slot[frame_id] = slot

    def _scores_for(self, q_sig: np.ndarray,
                    cands: List[Keyframe]) -> np.ndarray:
        """Retrieval scores of a query sketch against candidate keyframes:
        on the device when every candidate has a slot, else on the host."""
        if (self._sig_buf is not None
                and all(k.frame_id in self._sig_slot for k in cands)):
            scores = _retrieval_scores_device(
                upload(np.asarray(q_sig, np.float32), self.device),
                self._sig_buf, upload(self._sig_valid, self.device),
                chunk=128).cpu().numpy()
            return np.array([scores[self._sig_slot[k.frame_id]]
                             for k in cands], np.float32)
        sigs = np.stack([k.signature for k in cands])
        return _retrieval_scores(q_sig, sigs)

    @property
    def num_keyframes(self) -> int:
        return len(self.keyframes)

    def keyframe_poses(self) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.array([k.frame_id for k in self.keyframes], np.int64)
        poses = (np.stack([k.T_wc for k in self.keyframes])
                 if self.keyframes else np.zeros((0, 4, 4)))
        return ids, poses

    def _draws(self, seed: int) -> torch.Tensor:
        k = self._verify_cfg.ransac_iters
        if self.verify_draws is not None:
            return upload(np.asarray(self.verify_draws(seed)), self.device)
        return ransac.draw_hypotheses(threefry.prng_key(seed), k,
                                      self.device)

    def _verify(self, q_l: Features, q_r: Features, cands: List[Keyframe],
                seeds: List[int]):
        """Geometric verification of the query against each candidate,
        read back in one transfer: (T_rel (n, 4, 4), inliers (n,), ok (n,))."""
        outs = [_verify_loop(q_l, q_r, c.feats_l, c.feats_r, self._draws(s),
                             self.cfg.rig, self._verify_cfg)
                for c, s in zip(cands, seeds)]
        n = len(outs)
        packed = torch.cat([torch.stack([o[0] for o in outs]).reshape(-1),
                            torch.stack([o[1] for o in outs]).float(),
                            torch.stack([o[2] for o in outs]).float()])
        h = packed.cpu().numpy()
        return (h[:16 * n].reshape(n, 4, 4), h[16 * n:17 * n].astype(np.int64),
                h[17 * n:] > 0.5)

    # -- local BA ----------------------------------------------------------

    def window_problem(self) -> Tuple[ba.BAProblem, int]:
        """The BA problem of the newest window_keyframes keyframes, padded
        to the static K with EMPTY gauge-fixed entries in front
        (duplicated keyframes would double-count their observations), and
        the number of padding entries."""
        K = self.cfg.backend.window_keyframes
        window = self.keyframes[-K:]
        pad = K - len(window)
        from .frontend import _empty_features
        empty = _empty_features(self.cfg, self.device)
        fl = _stack_features([empty] * pad + [kf.feats_l for kf in window])
        fr = _stack_features([empty] * pad + [kf.feats_r for kf in window])
        T = upload(np.stack([np.eye(4, dtype=np.float32)] * pad
                            + [kf.T_wc for kf in window]), self.device)
        fixed = torch.arange(K, device=self.device) <= pad
        return build_window_problem(fl, fr, T, self.cfg, fixed=fixed), pad

    def local_ba(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Bundle-adjust the most recent window; updates stored poses.
        Returns (frame_ids, optimized_poses) for the window, or None."""
        if len(self.keyframes) < 2:
            return None
        window = self.keyframes[-self.cfg.backend.window_keyframes:]
        if len(window) < 2:
            return None
        # last_ba_ms covers build + solve + the packed read-back
        t0 = time.perf_counter()
        problem, pad = self.window_problem()
        res = ba.solve(problem, self.cfg.rig, self.cfg.backend)
        # ONE read-back: costs (divergence guard), optimised poses and the
        # window's observation mask (cull_redundant's covisibility evidence)
        h = torch.cat([res.initial_cost.reshape(1), res.final_cost.reshape(1),
                       res.T_wc.reshape(-1),
                       problem.obs_mask.reshape(-1).float()]).cpu().numpy()
        self.last_ba_ms = (time.perf_counter() - t0) * 1000.0
        c0, c1 = float(h[0]), float(h[1])
        K = pad + len(window)
        opt_all = h[2:2 + 16 * K].reshape(K, 4, 4)
        mask = h[2 + 16 * K:].reshape(-1, K) > 0.5
        # reject diverged / non-improving solves rather than poison the
        # stored poses (plain GN can step uphill on a bad linearisation)
        if not np.isfinite(c1) or c1 > c0 * 1.05 + 1e-6:
            self.ba_rejects += 1
            return None
        opt = opt_all[pad:]
        if not np.isfinite(opt).all():
            self.ba_rejects += 1
            return None
        # a refinement: a window keyframe moving metres in one solve is
        # divergence (large corrections come from the pose graph)
        move = np.linalg.norm(
            opt[:, :3, 3] - np.stack([kf.T_wc for kf in window])[:, :3, 3],
            axis=1)
        if move.max() > 2.0:
            self.ba_rejects += 1
            return None
        base = len(self.keyframes) - len(window)
        for i, kf in enumerate(window):
            self.keyframes[base + i] = kf._replace(T_wc=opt[i])
        ids = np.array([kf.frame_id for kf in window], np.int64)
        self._last_window_ids = ids
        self._last_window_mask = mask[:, pad:]
        return ids, opt

    # -- keyframe culling --------------------------------------------------

    def cull_redundant(self, min_frac: float = 0.9,
                       min_obs: int = 20,
                       near_dist_m: float = 0.15,
                       near_rot_deg: float = 3.0,
                       min_frac_near: float = 0.5) -> List[int]:
        """Cull at most ONE redundant keyframe of the last BA window: one
        whose observed landmarks are >= `min_frac` co-observed by >= 3 other
        keyframes, or one that sits within (`near_dist_m`, `near_rot_deg`)
        of another window keyframe with >= `min_frac_near` co-observed. The
        newest keyframe, the first one and loop-edge keyframes are never
        culled. Returns the culled frame ids. Like the JAX version, a near
        candidate sets `best_frac` low, so a later keyframe above it can
        take the cull."""
        if self._last_window_mask is None or len(self.keyframes) < 4:
            return []
        mask = self._last_window_mask            # (L, k) bool
        ids = self._last_window_ids
        k = mask.shape[1]
        if k < 3:
            return []
        loop_fids = {f for e in self.loop_edges for f in (e[0], e[1])}
        first_fid = self.keyframes[0].frame_id
        obs_per_lm = mask.sum(axis=1)
        kf_by_id = {kf.frame_id: kf for kf in self.keyframes}
        poses = [kf_by_id.get(int(f)) for f in ids]
        cos_thresh = np.cos(np.radians(near_rot_deg))
        best_j, best_frac = None, min_frac
        margin = 0.0        # best redundancy fraction seen, threshold-free
        for j in range(k - 1):                   # never the newest
            fid = int(ids[j])
            if fid == first_fid or fid in loop_fids:
                continue
            col = mask[:, j]
            n = int(col.sum())
            if n < min_obs:
                continue
            frac = float((col & (obs_per_lm >= 4)).sum()) / n
            margin = max(margin, frac)
            near = False
            if poses[j] is not None and frac >= min_frac_near:
                Tj = np.asarray(poses[j].T_wc, np.float64)
                for i in range(k):
                    if i == j or poses[i] is None:
                        continue
                    Ti = np.asarray(poses[i].T_wc, np.float64)
                    if np.linalg.norm(Ti[:3, 3] - Tj[:3, 3]) > near_dist_m:
                        continue
                    cosang = (np.trace(Ti[:3, :3].T @ Tj[:3, :3]) - 1) / 2
                    if cosang >= cos_thresh:
                        near = True
                        break
            if near and best_j is None:
                best_j, best_frac = j, frac
            if frac >= best_frac:
                best_j, best_frac = j, frac
        self.cull_margins.append(round(margin, 3))
        if best_j is None:
            return []
        fid = int(ids[best_j])
        self._remove_keyframe(fid)
        self._last_window_mask = None            # evidence is stale now
        return [fid]

    def _remove_keyframe(self, fid: int) -> None:
        idx = next(i for i, kf in enumerate(self.keyframes)
                   if kf.frame_id == fid)
        self.keyframes.pop(idx)
        slot = self._sig_slot.pop(fid, None)
        if slot is not None:
            self._sig_valid[slot] = False
            self._sig_free.append(slot)
        # splice odometry through the removed node: a->c + c->b => a->b
        in_e = [e for e in self.odom_edges if e[1] == fid]
        out_e = [e for e in self.odom_edges if e[0] == fid]
        self.odom_edges = [
            e for e in self.odom_edges if fid not in (e[0], e[1])]
        if in_e and out_e:
            a, _, T_ac, wa = in_e[0]
            _, b, T_cb, wb = out_e[0]
            self.odom_edges.append((a, b, T_ac @ T_cb, min(wa, wb)))
        self.loop_edges = [
            e for e in self.loop_edges if fid not in (e[0], e[1])]

    # -- loop closure ------------------------------------------------------

    def detect_loop(self, min_gap: int = 10,
                    min_similarity: float = 0.06,
                    min_inliers: int = 40,
                    top_k: int = 3) -> Optional[Tuple[int, int]]:
        """Try to close a loop for the newest keyframe: retrieval proposes
        the top_k candidates above min_similarity, all are verified in one
        batch, and the first that passes adds a loop edge. Returns
        (query_idx, candidate_idx) or None."""
        if len(self.keyframes) < min_gap + 2:
            return None
        qi = len(self.keyframes) - 1
        q = self.keyframes[qi]
        t0 = time.perf_counter()
        sims = self._scores_for(q.signature, self.keyframes[: qi - min_gap])
        self.phase_s["dl_scores"] = self.phase_s.get("dl_scores", 0.0) + (
            time.perf_counter() - t0)
        ranked = np.argsort(-sims)
        log = dict(
            query=int(q.frame_id),
            sim_best=round(float(sims[ranked[0]]), 4) if len(ranked) else None,
            sim_second=(round(float(sims[ranked[1]]), 4)
                        if len(ranked) > 1 else None),
            thresh=min_similarity, accepted=None, inliers=0,
        )
        self.loop_log.append(log)
        order = [int(ci) for ci in ranked[:top_k]
                 if sims[ci] >= min_similarity]
        if not order:
            return None
        # verify every shortlisted candidate (padded by repeating the
        # first), then pick the first passing one from one read-back
        t0 = time.perf_counter()
        padded = order + [order[0]] * (top_k - len(order))
        T_rel, n_inl, ok = self._verify(
            q.feats_l, q.feats_r, [self.keyframes[ci] for ci in padded],
            [qi * 31 + ci for ci in padded])
        self.phase_s["dl_verify"] = self.phase_s.get("dl_verify", 0.0) + (
            time.perf_counter() - t0)
        for k, ci in enumerate(order):
            log["inliers"] = max(log["inliers"], int(n_inl[k]))
            if not bool(ok[k]) or int(n_inl[k]) < min_inliers:
                continue
            cand = self.keyframes[ci]
            log["accepted"] = int(cand.frame_id)
            # T_rel maps candidate-frame points to the query frame; the
            # edge cand -> query is its inverse
            T_ij = lie.inv_T(torch.from_numpy(T_rel[k].copy())).numpy()
            self.loop_edges.append((cand.frame_id, q.frame_id, T_ij, 10.0))
            return qi, ci
        return None

    def relocalize(self, feats_l: Features, feats_r: Features,
                   min_similarity: float = 0.04,
                   min_inliers: int = 30,
                   top_k: int = 5) -> Optional[np.ndarray]:
        """Recover a lost camera against the keyframe database: sketch
        retrieval plus the loop verifier. Returns T_wc or None."""
        if not self.keyframes:
            return None
        sig = _signature(feats_l)
        sims = self._scores_for(sig, self.keyframes)
        order = [int(ci) for ci in np.argsort(-sims)[:top_k]
                 if sims[ci] >= min_similarity]
        if not order:
            return None
        padded = order + [order[0]] * (top_k - len(order))
        nkf = len(self.keyframes)
        T_rel, n_inl, ok = self._verify(
            feats_l, feats_r, [self.keyframes[ci] for ci in padded],
            [7000 + nkf * 31 + ci for ci in padded])
        for k, ci in enumerate(order):
            if not bool(ok[k]) or int(n_inl[k]) < min_inliers:
                continue
            cand = self.keyframes[ci]
            # p_query = T_rel p_cand  =>  T_wq = T_wc_cand inv(T_rel)
            return (torch.from_numpy(np.asarray(cand.T_wc, np.float32))
                    @ lie.inv_T(torch.from_numpy(T_rel[k].copy()))).numpy()
        return None

    def optimize_graph(self) -> Tuple[np.ndarray, np.ndarray]:
        """Pose-graph relaxation over the newest max_pg_nodes keyframes;
        updates stored poses. Returns (frame_ids, optimized_poses)."""
        bc = self.cfg.backend
        n = min(len(self.keyframes), bc.max_pg_nodes)
        kfs = self.keyframes[-n:]
        pos = {kf.frame_id: i for i, kf in enumerate(kfs)}
        edges = [(pos[i], pos[j], T, w)
                 for (i, j, T, w) in self.odom_edges + self.loop_edges
                 if i in pos and j in pos][:bc.max_pg_edges]
        T_wc = np.tile(np.eye(4, dtype=np.float32), (bc.max_pg_nodes, 1, 1))
        T_wc[:n] = np.stack([k.T_wc for k in kfs])
        ei = np.zeros(bc.max_pg_edges, np.int64)
        ej = np.zeros(bc.max_pg_edges, np.int64)
        Tij = np.tile(np.eye(4, dtype=np.float32), (bc.max_pg_edges, 1, 1))
        w = np.zeros(bc.max_pg_edges, np.float32)
        for e, (i, j, T, wt) in enumerate(edges):
            ei[e], ej[e], Tij[e], w[e] = i, j, T, wt
        g = posegraph.make_graph(bc, self.device)
        g = g._replace(
            T_wc=upload(T_wc, self.device),
            node_valid=torch.arange(bc.max_pg_nodes, device=self.device) < n,
            edge_i=upload(ei, self.device), edge_j=upload(ej, self.device),
            T_ij=upload(Tij, self.device), edge_weight=upload(w, self.device))
        g = posegraph.optimize(g, bc)
        opt = g.T_wc[:n].cpu().numpy()
        ids = np.array([k.frame_id for k in kfs], np.int64)
        if not np.isfinite(opt).all():       # diverged relaxation: keep
            self.pg_rejects += 1             # the odometry poses
            return ids, np.stack([k.T_wc for k in kfs])
        offset = len(self.keyframes) - n
        for i, kf in enumerate(kfs):
            self.keyframes[offset + i] = kf._replace(T_wc=opt[i])
        return ids, opt


def _signature(feats: Features) -> np.ndarray:
    """Place-recognition sketch on the host: the _SIG_M strongest valid
    descriptors, unit-normalised, as an (_SIG_M, D) matrix (rows zero when
    absent). Retrieval scores it by set overlap (`_retrieval_scores`)."""
    d = feats.desc.detach().cpu().numpy()
    v = feats.valid.detach().cpu().numpy()
    s = np.where(v, feats.score.detach().cpu().numpy(), -np.inf)
    idx = np.argsort(-s)[:_SIG_M]
    d = d[idx]
    ok = v[idx]
    n = np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(n > 1e-6, d / np.maximum(n, 1e-6), 0.0) * ok[:, None]
    out = np.zeros((_SIG_M, d.shape[1]), np.float32)
    out[: d.shape[0]] = d
    return out


def signature_device(feats: Features) -> torch.Tensor:
    """`_signature` on the device: the _SIG_M strongest valid descriptors,
    unit-normalised, as an (_SIG_M, D) matrix (rows zero when absent).
    Ties in score keep the lower index, as `lax.top_k` does."""
    k = min(_SIG_M, feats.score.shape[0])
    s = torch.where(feats.valid, feats.score, float("-inf"))
    idx = torch.sort(s, descending=True, stable=True).indices[:k]
    d = feats.desc[idx]
    ok = feats.valid[idx]
    n = torch.sqrt((d * d).sum(dim=1, keepdim=True))
    d = torch.where(n > 1e-6, d / torch.clamp(n, min=1e-6), 0.0) * ok[:, None]
    if k < _SIG_M:
        d = torch.nn.functional.pad(d, (0, 0, 0, _SIG_M - k))
    return d.to(torch.float32)


def _retrieval_scores_device(q: torch.Tensor, buf: torch.Tensor,
                             valid: torch.Tensor, *, chunk: int,
                             tau: float = _SIG_TAU) -> torch.Tensor:
    """Set-overlap retrieval scores on the device: (M, D) query sketch
    against the (CAP, M, D) sketch buffer -> (CAP,) scores, -1 at empty
    slots; one batched matmul per `chunk` candidates."""
    cap = buf.shape[0]
    qv = torch.sqrt((q * q).sum(dim=1)) > 0.5
    nq = torch.clamp(qv.to(torch.int32).sum(), min=1).to(torch.float32)
    out = []
    for c0 in range(0, cap, chunk):
        sim = torch.einsum("md,nkd->nmk", q, buf[c0:c0 + chunk])
        hit = (sim.amax(dim=2) > tau) & qv[None, :]
        out.append(hit.to(torch.int32).sum(dim=1).to(torch.float32) / nq)
    return torch.where(valid, torch.cat(out), -1.0)


def _retrieval_scores(q_sig: np.ndarray, sigs: np.ndarray,
                      tau: float = _SIG_TAU) -> np.ndarray:
    """Set-overlap scores on the host: one query sketch (M, D) against
    candidate sketches (N, M, D) -> (N,) fraction of query descriptors
    strongly matched in each candidate."""
    valid = np.linalg.norm(q_sig, axis=1) > 0.5
    nq = max(int(valid.sum()), 1)
    sim = np.einsum("md,nkd->nmk", q_sig, sigs, optimize=True)
    return (sim.max(axis=2) > tau)[:, valid].sum(axis=1) / nq


def _stack_features(fs: List[Features]) -> Features:
    return Features(*(torch.stack(x) for x in zip(*fs)))


def _verify_loop(q_l: Features, q_r: Features, c_l: Features,
                 c_r: Features, raw: torch.Tensor, rig, fcfg):
    """Geometric verification: the candidate as 'prev', the query as
    'curr', the stereo RANSAC solver on their quad matches with draws
    `raw`. Returns (T_delta, num_inliers, ok)."""
    q = matching.quad_match(q_l, q_r, c_l, c_r, fcfg)
    res = ransac.estimate_stereo_motion(q, rig, fcfg, raw=raw)
    return res.T_delta, res.num_inliers, res.ok
