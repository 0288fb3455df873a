"""Sharded voxel-block TSDF map over the ranks of a map axis (port of
denseslam_tpu/parallel/sharded_map.py).

Each rank holds an independent local map of table_slots / N slots and
owns the blocks whose supertile (4^3 blocks) hashes to it (`owner_of_keys`),
so:

  * allocation and integration need no message in the "replicated" mode:
    every rank computes the frame's touched-block keys, keeps the ones it
    owns, and fuses them with its own kernels (B1, csrc/tile_sample.cu, as
    JAX runs the Pallas sampler inside shard_map). The "exchange" mode (the
    default) divides the key generation by row slabs and routes each
    slab's unique keys to their owners with one all_to_all;
  * the raycast: each rank renders its own blocks, and the nearest surface
    is a MIN all-reduce of the hit depths (a miss is 1e9); the colour of
    the rank that won is combined by a MAX all-reduce;
  * decay, the sliding window and correction replay are rank-local; the
    counters are summed over the ranks.

What JAX replicates (the frame, the pose, the fusion DB, the correction's
poses) every rank holds whole. The entry points take them from rank 0
(`broadcast`) before they touch the map, so that ranks whose own values
differ in a last bit still build one map.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ..config import SystemConfig, TsdfConfig
from ..ops import hash as vhash
from ..ops import raycast as rc_ops
from ..ops import splat as splat_ops
from ..ops import tsdf as tsdf_ops
from ..utils.camera import Intrinsics
from ..utils.numerics import true_div
from .mesh import MapMesh

SUPER_SHIFT = 2  # supertile = 4x4x4 blocks

_OWNER_P1 = -1640531527  # 2654435761 as wrapped int32
_OWNER_P2 = 40503
_OWNER_P3 = 1597334677


def owner_of_keys(keys: torch.Tensor, n_devices: int) -> torch.Tensor:
    """The rank owning each packed block key: a hash of the block's
    supertile (not the slot hash, so that shards stay balanced), with
    int32 wrap-around multiplies (formed in int64 and wrapped)."""
    x, y, z = vhash.unpack_xyz(keys)

    def mul(a, p):
        return vhash.wrap_i32((a >> SUPER_SHIFT).to(torch.int64) * p)

    h = mul(x, _OWNER_P1) ^ mul(y, _OWNER_P2) ^ mul(z, _OWNER_P3)
    h = h ^ (h >> 8)
    return (h & (2 ** 30 - 1)) % n_devices


def owner_of(bcoords: torch.Tensor, n_devices: int) -> torch.Tensor:
    """Coord-space `owner_of_keys` of (..., 3) block coordinates."""
    return owner_of_keys(vhash.pack_coords(bcoords), n_devices)


def local_tsdf_config(cfg: TsdfConfig, n_devices: int) -> TsdfConfig:
    """A rank's table config: the slots divided over the ranks."""
    assert cfg.table_slots % n_devices == 0
    return dataclasses.replace(cfg, table_slots=cfg.table_slots // n_devices)


def make_sharded_map(cfg: TsdfConfig, mesh: MapMesh) -> tsdf_ops.MapState:
    """This rank's shard of a fresh map: a local map of table_slots / N
    slots on the rank's device (frame and counters the same on every
    rank)."""
    return tsdf_ops.make_map(local_tsdf_config(cfg, mesh.size), mesh.device)


def _owner_filter(mesh: MapMesh):
    """keys -> keys: this rank's blocks, EMPTY_KEY elsewhere."""
    def kf(keys):
        return torch.where(owner_of_keys(keys, mesh.size) == mesh.rank, keys,
                           vhash.EMPTY_KEY)
    return kf


def _sum_counters(m, mesh: MapMesh, old_overflow, old_decayed):
    """The counters accumulate every rank's delta, so that they stay the
    same on all ranks."""
    d = mesh.all_reduce(torch.stack([m.overflow - old_overflow,
                                     m.decayed_blocks - old_decayed]))
    return m._replace(overflow=(old_overflow + d[0]).to(torch.int32),
                      decayed_blocks=(old_decayed + d[1]).to(torch.int32))


def _alloc_exchange(m, depth, T_wc, *, local_cfg: TsdfConfig,
                    intr: Intrinsics, mesh: MapMesh):
    """Owner-routed allocation. Each rank key-gens its own row slab of the
    subsampled depth (slabs of ceil(hs / N) rows, the last ones shifted
    back so that they overlap at the tail), dedupes it, routes the unique
    keys to their owners as one (N, cap) all_to_all, dedupes what it
    received and inserts it. The owned block set equals the replicated
    path's: every key reaches its owner, duplicates collapse."""
    n = mesh.size
    s = local_cfg.alloc_subsample
    dsub = depth[::s, ::s] if s > 1 else depth
    hs = dsub.shape[0]
    slab = max(1, -(-hs // n))
    row0 = min(mesh.rank * slab, hs - slab)
    keys = tsdf_ops.touched_block_keys(dsub[row0:row0 + slab], T_wc, intr,
                                       local_cfg, row0=row0)
    cap = local_cfg.max_visible_blocks
    uniq, umask, _ = vhash.unique_keys(keys, cap)
    owner = owner_of_keys(uniq, n)
    buckets = torch.stack([
        torch.where(umask & (owner == d), uniq, vhash.EMPTY_KEY)
        for d in range(n)])
    recv = mesh.all_to_all(buckets)
    uniq2, umask2, total2 = vhash.unique_keys(recv.reshape(-1), cap)
    return tsdf_ops.allocate_keys(m, uniq2, umask2, total2, local_cfg)


def _fuse_local(m, depth, gray, T_wc, *, local_cfg: TsdfConfig,
                intr: Intrinsics, mesh: MapMesh, decay_params=None,
                slide_params=None, alloc_mode: str = "exchange"):
    """One rank's fusion of a frame into its shard."""
    old_overflow, old_decayed = m.overflow.clone(), m.decayed_blocks.clone()
    if alloc_mode == "exchange" and mesh.size > 1:
        m, slots, live = _alloc_exchange(m, depth, T_wc, local_cfg=local_cfg,
                                         intr=intr, mesh=mesh)
    else:
        m, slots, live = tsdf_ops.allocate_for_frame(
            m, depth, T_wc, intr, local_cfg, key_filter=_owner_filter(mesh))
    color = tsdf_ops.pack_gray(gray)
    m = tsdf_ops.integrate(m, slots, live, depth, color, T_wc, intr,
                           local_cfg)
    if slide_params is not None and slide_params.enabled:
        m = tsdf_ops.slide_window(m, slide_params.max_age)
    if decay_params is not None and decay_params.enabled:
        m = tsdf_ops.decay(m, decay_params.max_decay_weight,
                           decay_params.min_decay_age)
    m = _sum_counters(m, mesh, old_overflow, old_decayed)
    return tsdf_ops.advance_frame(m)


def _correct_local(m, db, opt_T, opt_valid, *, cfg: SystemConfig,
                   local_cfg: TsdfConfig, mesh: MapMesh):
    """One rank's online correction: the scoring reads the DB, which every
    rank holds whole, so all ranks replay the same frames, each into the
    blocks it owns; only the counters cross ranks."""
    from ..models.dense_slam import online_correction
    old_overflow, old_decayed = m.overflow.clone(), m.decayed_blocks.clone()
    m, db, num = online_correction(m, db, opt_T, opt_valid, cfg,
                                   key_filter=_owner_filter(mesh),
                                   tsdf_cfg=local_cfg)
    return _sum_counters(m, mesh, old_overflow, old_decayed), db, num


def _purge_local(m, db, culled, *, cfg: SystemConfig, local_cfg: TsdfConfig,
                 mesh: MapMesh):
    """One rank's purge of the culled keyframes."""
    from ..models.dense_slam import purge_culled
    old_overflow, old_decayed = m.overflow.clone(), m.decayed_blocks.clone()
    m, db = purge_culled(m, db, culled, cfg, key_filter=_owner_filter(mesh),
                         tsdf_cfg=local_cfg)
    return _sum_counters(m, mesh, old_overflow, old_decayed), db


def _decay_local(m, max_decay_weight: float, *, mesh: MapMesh,
                 force_all: bool, min_decay_age: int):
    """One rank's decay pass (per slot: only the freed-block counter
    crosses ranks)."""
    old = m.decayed_blocks.clone()
    m = tsdf_ops.decay(m, max_decay_weight, min_decay_age,
                       force_all=force_all)
    d = mesh.all_reduce(m.decayed_blocks - old)
    return m._replace(decayed_blocks=(old + d).to(torch.int32))


def _raycast_local(m, T_wc, *, local_cfg: TsdfConfig, intr: Intrinsics,
                   mesh: MapMesh, splat_params=None) -> rc_ops.Raycast:
    """Each rank renders the blocks it owns (the splat renderer when
    configured, else the marching raycast); the MIN all-reduce of the hit
    depths recovers the nearest surface, and points and normals come from
    that combined depth."""
    if splat_params is not None:
        # in-shard bleed suppression stays off: a rank sees only its own
        # blocks, and the true foreground may be another rank's; the MIN
        # combine already keeps the nearest hit
        sc = splat_ops.SplatConfig(
            max_blocks=splat_params.max_blocks,
            max_voxels=splat_params.max_voxels,
            surface_eta=splat_params.surface_eta,
            z_bits=splat_params.z_bits,
            fill_levels=splat_params.fill_levels)
        rc = splat_ops.splat_render(m, T_wc, intr, local_cfg, sc)
    else:
        rc = rc_ops.raycast(m, T_wc, intr, local_cfg)
    big = 1e9
    d = torch.where(rc.mask, rc.depth, big)
    d_min = mesh.all_reduce(d, "min")
    hit = d_min < big * 0.5
    depth = torch.where(hit, d_min, 0.0)
    # the winner's colour: kept where this rank won, then MAX-combined
    # (one rank wins each pixel; the others give zeros)
    mine = hit & ((d - d_min).abs() < 1e-6)
    color = mesh.all_reduce(torch.where(mine[..., None], rc.color, 0.0),
                            "max")
    h, w = depth.shape
    dev = depth.device
    vv = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    uu = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    cx = true_div(uu - intr.cx, intr.fx) * depth
    cy = true_div(vv - intr.cy, intr.fy) * depth
    R = T_wc[:3, :3]
    t = T_wc[:3, 3]
    px = R[0, 0] * cx + R[0, 1] * cy + R[0, 2] * depth + t[0]
    py = R[1, 0] * cx + R[1, 1] * cy + R[1, 2] * depth + t[1]
    pz = R[2, 0] * cx + R[2, 1] * cy + R[2, 2] * depth + t[2]
    px, py, pz = (torch.where(hit, a, 0.0) for a in (px, py, pz))
    nx, ny, nz, _ = rc_ops._normals_soA(px, py, pz, hit)
    return rc_ops.Raycast(depth=depth, points=torch.stack([px, py, pz], -1),
                          normals=torch.stack([nx, ny, nz], -1), mask=hit,
                          color=color)


class ShardedTsdf:
    """The sharded map's facade, mirroring the single-chip MapState ops:
    `fuse`, `raycast`, `correct`, `purge`, `decay_catchup_step` take this
    rank's shard (`make_map`) and return it; what JAX replicates is taken
    from rank 0 first."""

    def __init__(self, cfg: SystemConfig, mesh: MapMesh):
        self.cfg = cfg
        self.mesh = mesh
        self.n = mesh.size
        self.local_cfg = local_tsdf_config(cfg.tsdf, self.n)
        self._splat = (cfg.splat if cfg.pipeline.renderer == "splat"
                       else None)

    def replicate(self, *xs):
        """Rank 0's tensors `xs` on every rank."""
        return tuple(self.mesh.broadcast(x) for x in xs)

    def replicate_pose(self, T_wc: torch.Tensor, ok: bool):
        """Rank 0's pose (4, 4) and flag, in one message."""
        v = torch.cat([T_wc.reshape(-1).to(torch.float32),
                       torch.tensor([float(ok)], device=T_wc.device)])
        v = self.mesh.broadcast(v)
        return v[:16].reshape(4, 4).to(T_wc.dtype), bool(v[16].item() > 0.5)

    def replicate_host(self, *xs):
        """Rank 0's host values `xs` on every rank."""
        return self.mesh.broadcast_object(xs)

    def make_map(self) -> tsdf_ops.MapState:
        return make_sharded_map(self.cfg.tsdf, self.mesh)

    def fuse(self, m, depth, gray, T_wc):
        """Fuse one frame (depth, gray (H, W), T_wc (4, 4), rank 0's)."""
        depth, gray, T_wc = self.replicate(depth, gray, T_wc)
        return _fuse_local(m, depth, gray, T_wc, local_cfg=self.local_cfg,
                           intr=self.cfg.rig.intr, mesh=self.mesh,
                           decay_params=self.cfg.decay,
                           slide_params=self.cfg.slide_window,
                           alloc_mode=self.cfg.pipeline.parallel_alloc)

    def raycast(self, m, T_wc) -> rc_ops.Raycast:
        """The whole map's render from T_wc (rank 0's), the same on every
        rank."""
        (T_wc,) = self.replicate(T_wc)
        return _raycast_local(m, T_wc, local_cfg=self.local_cfg,
                              intr=self.cfg.rig.intr, mesh=self.mesh,
                              splat_params=self._splat)

    def correct(self, m, db, opt_T, opt_valid):
        """Online correction against rank 0's optimised poses; returns
        (map, db, number re-fused)."""
        opt_T, opt_valid = self.replicate(opt_T, opt_valid)
        return _correct_local(m, db, opt_T, opt_valid, cfg=self.cfg,
                              local_cfg=self.local_cfg, mesh=self.mesh)

    def purge(self, m, db, culled):
        (culled,) = self.replicate(culled)
        return _purge_local(m, db, culled, cfg=self.cfg,
                            local_cfg=self.local_cfg, mesh=self.mesh)

    def decay_catchup_step(self, m, max_decay_weight: float):
        """One sequence-end decay pass with the age gate off."""
        return _decay_local(m, float(max_decay_weight), mesh=self.mesh,
                            force_all=True, min_decay_age=0)

    def gather_to_single(self, m: tsdf_ops.MapState,
                         as_numpy: bool = False) -> tsdf_ops.MapState:
        """The whole map as a probe-consistent single-table MapState of
        table_slots slots on every rank (on the host with `as_numpy`,
        else on the rank's device). A shard hashes keys modulo its local
        slot count, so its slots are wrong for the full table: the valid
        blocks of all ranks, in rank and slot order, are re-probed into a
        fresh table on the host, round by round, the first pending key
        claiming a free slot.

        Inherited from the JAX package (denseslam_tpu/parallel/
        sharded_map.py:412-417): a block still unplaced after probe_len
        rounds is dropped, with only a warning."""
        cpu = torch.device("cpu")
        idx = torch.nonzero(m.table.valid).flatten()
        rows = [t.index_select(0, idx) for t in
                (m.table.keys, m.tsdf, m.weight, m.color, m.alloc_frame,
                 m.last_seen)]
        parts = [torch.cat([p.to(cpu) for p in self.mesh.all_gather_rows(r)])
                 for r in rows]
        keys = parts[0].numpy()
        cfg = self.cfg.tsdf
        S = cfg.table_slots
        h = vhash.hash_key(parts[0], S).numpy().astype(np.int64)
        new_keys = np.full(S, vhash.EMPTY_KEY, np.int32)
        slot_of = np.full(len(keys), -1, np.int64)
        pending = np.ones(len(keys), bool)
        for r in range(cfg.probe_len):
            ids = np.flatnonzero(pending)
            if ids.size == 0:
                break
            cand = (h[ids] + r) & (S - 1)
            free = new_keys[cand] == vhash.EMPTY_KEY
            ids, cand = ids[free], cand[free]
            # the first pending key per free slot wins this round (keys
            # are unique over the ranks: ownership admits no duplicate)
            _, first = np.unique(cand, return_index=True)
            win, wc = ids[first], cand[first]
            new_keys[wc] = keys[win]
            slot_of[win] = wc
            pending[win] = False
        dropped = int(pending.sum())
        if dropped:
            warnings.warn(f"gather_to_single: {dropped} blocks exceeded "
                          f"probe_len={cfg.probe_len} and were dropped",
                          stacklevel=2)
        ok = torch.from_numpy(np.flatnonzero(slot_of >= 0))
        dst = torch.from_numpy(slot_of[slot_of >= 0])
        bv = tsdf_ops.BLOCK_VOL
        sd = m.tsdf.dtype

        def scat(init, src):
            init[dst] = src[ok]
            return init

        out = tsdf_ops.MapState(
            table=vhash.HashTable(keys=torch.from_numpy(new_keys)),
            tsdf=scat(torch.ones((S, bv), dtype=sd), parts[1]),
            weight=scat(torch.zeros((S, bv), dtype=sd), parts[2]),
            color=scat(torch.zeros((S, bv), dtype=torch.int32), parts[3]),
            alloc_frame=scat(torch.zeros((S,), dtype=torch.int32), parts[4]),
            last_seen=scat(torch.zeros((S,), dtype=torch.int32), parts[5]),
            frame=m.frame.to(cpu, copy=True),
            decayed_blocks=m.decayed_blocks.to(cpu, copy=True),
            overflow=m.overflow.to(cpu, copy=True))
        if as_numpy:
            return out
        dev = self.mesh.device
        return out._replace(
            table=vhash.HashTable(keys=out.table.keys.to(dev)),
            **{f: getattr(out, f).to(dev) for f in out._fields[1:]})

    def num_blocks(self, m) -> int:
        """Allocated blocks over all ranks."""
        return int(self.mesh.all_reduce(
            tsdf_ops.num_allocated_blocks(m).to(torch.int64)))

    def memory_bytes(self, m, voxel_bytes: int = 16) -> int:
        return self.num_blocks(m) * voxel_bytes * tsdf_ops.BLOCK_VOL
