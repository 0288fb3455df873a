"""Carry state across from the JAX package, as numpy arrays, and back.

A map is the sequence of its leaves in the JAX `MapState` order —
table.keys, tsdf, weight, color, alloc_frame, last_seen, frame,
decayed_blocks, overflow — the order io/checkpoint.py of the JAX package
writes. A fusion DB is depth, gray, T_fused, frame_id, valid, head.
Features are uv, cls, desc, score, valid; a frontend state is the leaves
of the JAX `FrontendState` (`jax.tree.leaves` order), its PRNG key as the
two uint32 words that the port's threefry key holds.

bf16 planes arrive as `ml_dtypes.bfloat16` arrays or as their uint16 bits
and are reinterpreted bit for bit; they leave as uint16 bits (the
checkpoint's on-disk convention). The DB's u16 depth is held as int32 in
the port (see models/dense_slam.py FusionDB).

Every `*_to_numpy` returns copies: the port changes its state in place.
The host-side state of the system travels as plain dicts of numpy values
(`*_state_to_numpy` / `*_state_from_numpy`):
  backend  keyframes (frame_id, T_wc, feats_l and feats_r as feature
           leaves, signature), odom_edges and loop_edges as (fid_i, fid_j,
           T_ij, weight), the sketch buffer's slots (sig_valid, sig_slot,
           sig_next, sig_free; the buffer itself is rebuilt from the
           keyframes' signatures, and a freed slot scores -1 either way),
           the last BA window's evidence and the reject counters;
  slam     every submap (map and DB leaves, where it lives, global and
           spawn poses, anchor frame, deferred corrections, dirty flag),
           frontend state leaves (with a PRNG key in the JAX order), frame
           counter and pose history;
  system   both of the above and the system's counters and chaining state.
`backend_state_to_numpy` and `submap_state_to_numpy` read the JAX
package's Backend and SubmapManager as well (the attribute names are the
same and their arrays go through numpy).
"""

from __future__ import annotations

import dataclasses
import typing
from typing import List, Mapping, Sequence

import numpy as np
import torch

from ..config import SystemConfig
from ..device import resolve_device
from ..models.backend import Backend, Keyframe, upload
from ..models.dense_slam import DenseSLAM, FusionDB
from ..models.frontend import FrontendState
from ..ops.features import Features
from ..ops.hash import HashTable
from ..ops.tsdf import MapState
from ..utils.camera import Intrinsics, StereoRig


def _bf16_from_numpy(a: np.ndarray, dev) -> torch.Tensor:
    bits = np.ascontiguousarray(a).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)


def _plane_from_numpy(a, dev) -> torch.Tensor:
    """A tsdf / weight plane: bf16 (ml_dtypes or uint16 bits) or f32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        return _bf16_from_numpy(a, dev)
    return torch.tensor(a, dtype=torch.float32, device=dev)


def _np(x) -> np.ndarray:
    """A numpy copy of a tensor (the port changes its state in place) or
    of any array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.asarray(x)


def _plane_to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return _np(t.view(torch.int16)).view(np.uint16)
    return _np(t)


def _array(x) -> np.ndarray:
    """A numpy copy of an array, bf16 as its uint16 bits."""
    a = np.array(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _i32(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)


def map_state_from_numpy(leaves: Sequence, device=None) -> MapState:
    """JAX MapState leaves (numpy) -> port MapState on `device`."""
    dev = resolve_device(device)
    keys, tsdf, weight, color, af, ls, frame, dec, ovf = leaves
    return MapState(
        table=HashTable(keys=_i32(keys, dev)),
        tsdf=_plane_from_numpy(tsdf, dev),
        weight=_plane_from_numpy(weight, dev),
        color=_i32(color, dev),
        alloc_frame=_i32(af, dev),
        last_seen=_i32(ls, dev),
        frame=_i32(frame, dev),
        decayed_blocks=_i32(dec, dev),
        overflow=_i32(ovf, dev),
    )


def map_state_to_numpy(m: MapState) -> List[np.ndarray]:
    """Port MapState -> leaves in the JAX order (bf16 as uint16 bits)."""
    ints = lambda t: _np(t).astype(np.int32)  # noqa: E731
    return [ints(m.table.keys), _plane_to_numpy(m.tsdf),
            _plane_to_numpy(m.weight), ints(m.color), ints(m.alloc_frame),
            ints(m.last_seen), ints(m.frame), ints(m.decayed_blocks),
            ints(m.overflow)]


def fusion_db_from_numpy(leaves: Sequence, device=None) -> FusionDB:
    """JAX FusionDB leaves (numpy) -> port FusionDB on `device`."""
    dev = resolve_device(device)
    depth, gray, T_fused, frame_id, valid, head = (np.asarray(x) for x in leaves)
    if depth.dtype == np.uint16:
        depth_t = torch.tensor(depth.astype(np.int32), device=dev)
        gray_t = torch.tensor(gray.astype(np.uint8), device=dev)
    else:
        depth_t = torch.tensor(depth, dtype=torch.float32, device=dev)
        gray_t = torch.tensor(gray, dtype=torch.float32, device=dev)
    return FusionDB(
        depth=depth_t, gray=gray_t,
        T_fused=torch.tensor(T_fused, dtype=torch.float32, device=dev),
        frame_id=_i32(frame_id, dev),
        valid=torch.tensor(valid, dtype=torch.bool, device=dev),
        head=_i32(head, dev),
    )


def fusion_db_to_numpy(db: FusionDB) -> List[np.ndarray]:
    """Port FusionDB -> leaves in the JAX order and dtypes."""
    depth = _np(db.depth)
    if db.quantized:
        depth = depth.astype(np.uint16)
    return [depth, _np(db.gray), _np(db.T_fused),
            _np(db.frame_id).astype(np.int32), _np(db.valid),
            _np(db.head).astype(np.int32)]


_FEATURE_DTYPES = (torch.float32, torch.int32, torch.float32, torch.float32,
                   torch.bool)


def features_from_numpy(leaves: Sequence, device=None) -> Features:
    """JAX Features leaves (uv, cls, desc, score, valid) -> port Features."""
    dev = resolve_device(device)
    return Features(*(torch.tensor(np.asarray(a), dtype=dt, device=dev)
                      for a, dt in zip(leaves, _FEATURE_DTYPES)))


def features_to_numpy(f: Features) -> List[np.ndarray]:
    return [_np(t) for t in f]


# FrontendState's fields after the two feature sets, in the JAX order
# (the key is the threefry key's two uint32 words, held on the host)
_STATE_DTYPES = (("disp_l", torch.float32), ("disp_r", torch.float32),
                 ("T_wc", torch.float32), ("T_delta_prev", torch.float32),
                 ("initialized", torch.bool), ("prior_ok", torch.bool),
                 ("key", torch.int64), ("frame", torch.int32),
                 ("img_l", torch.float32), ("img_r", torch.float32),
                 ("exposure", torch.float32))
_KEY_AT = 16


def frontend_state_from_numpy(leaves: Sequence, device=None) -> FrontendState:
    """JAX FrontendState leaves (numpy) -> port state on `device`, its key
    on the host."""
    dev = resolve_device(device)
    leaves = list(leaves)
    return FrontendState(
        feats_l=features_from_numpy(leaves[:5], dev),
        feats_r=features_from_numpy(leaves[5:10], dev),
        **{name: torch.tensor(np.asarray(a).astype(np.int64) if name == "key"
                              else np.asarray(a), dtype=dt,
                              device="cpu" if name == "key" else dev)
           for (name, dt), a in zip(_STATE_DTYPES, leaves[10:])})


def frontend_state_to_numpy(st) -> List[np.ndarray]:
    """FrontendState (the port's or the JAX package's) -> JAX leaves, the
    key as uint32 words."""
    rest = [_np(getattr(st, name)) for name, _ in _STATE_DTYPES]
    rest[_KEY_AT - 10] = rest[_KEY_AT - 10].astype(np.uint32)
    return features_to_numpy(st.feats_l) + features_to_numpy(st.feats_r) + rest


def _rig(v) -> StereoRig:
    if isinstance(v, Mapping):
        intr, base = v["intr"], v["baseline_m"]
    else:
        intr, base = v
    intr = Intrinsics(**intr) if isinstance(intr, Mapping) else Intrinsics(*intr)
    return StereoRig(intr=intr, baseline_m=base)


def _build(cls, value):
    if not dataclasses.is_dataclass(cls):
        return value
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(value) - names
    if unknown:
        raise KeyError(f"{cls.__name__}: fields the port lacks: {sorted(unknown)}")
    kwargs = {}
    for name, v in value.items():
        kwargs[name] = _rig(v) if name == "rig" else _build(hints[name], v)
    return cls(**kwargs)


def config_from_dict(d: Mapping) -> SystemConfig:
    """`dataclasses.asdict` of a JAX `SystemConfig` -> the port's."""
    return _build(SystemConfig, d)


def _edges(edges) -> list:
    return [(int(i), int(j), np.asarray(T, np.float32), float(w))
            for i, j, T, w in edges]


def backend_state_to_numpy(be) -> dict:
    """A Backend's host state (the port's or the JAX package's)."""
    mask = be._last_window_mask
    return dict(
        keyframes=[dict(frame_id=int(k.frame_id),
                        T_wc=np.asarray(k.T_wc, np.float32),
                        feats_l=[_np(x) for x in k.feats_l],
                        feats_r=[_np(x) for x in k.feats_r],
                        signature=np.asarray(k.signature, np.float32))
                   for k in be.keyframes],
        odom_edges=_edges(be.odom_edges), loop_edges=_edges(be.loop_edges),
        sig_valid=np.asarray(be._sig_valid, bool),
        sig_slot={int(f): int(s) for f, s in be._sig_slot.items()},
        sig_next=int(be._sig_next), sig_free=[int(s) for s in be._sig_free],
        last_window_ids=(None if be._last_window_ids is None
                         else np.asarray(be._last_window_ids)),
        last_window_mask=None if mask is None else np.asarray(mask),
        ba_rejects=int(be.ba_rejects), pg_rejects=int(be.pg_rejects))


def backend_state_from_numpy(state: Mapping, be: Backend) -> Backend:
    """Load `state` into the port's Backend `be` (on its device)."""
    dev = be.device
    be.keyframes = [Keyframe(k["frame_id"], np.asarray(k["T_wc"], np.float32),
                             features_from_numpy(k["feats_l"], dev),
                             features_from_numpy(k["feats_r"], dev),
                             np.asarray(k["signature"], np.float32))
                    for k in state["keyframes"]]
    be.odom_edges = _edges(state["odom_edges"])
    be.loop_edges = _edges(state["loop_edges"])
    be._sig_valid = np.array(state["sig_valid"], bool)
    be._sig_slot = dict(state["sig_slot"])
    be._sig_next = int(state["sig_next"])
    be._sig_free = list(state["sig_free"])
    be._sig_buf = None
    sigs = {k.frame_id: k.signature for k in be.keyframes}
    if sigs:
        m, d = next(iter(sigs.values())).shape
        buf = np.zeros((be._sig_cap, m, d), np.float32)
        for fid, slot in be._sig_slot.items():
            buf[slot] = sigs[fid]
        be._sig_buf = upload(buf, dev)
    be._last_window_ids = state["last_window_ids"]
    be._last_window_mask = state["last_window_mask"]
    be.ba_rejects = state["ba_rejects"]
    be.pg_rejects = state["pg_rejects"]
    return be


def submap_state_to_numpy(sm, i: int) -> dict:
    """Submap `i` of a SubmapManager (the port's or the JAX package's):
    its map and DB leaves, where it lives, its global and spawn poses, its
    anchor frame, its deferred corrections (frame id -> (pose, drift)) and
    its dirty flag."""
    if isinstance(sm.maps[i], MapState):
        m, db = map_state_to_numpy(sm.maps[i]), fusion_db_to_numpy(sm.dbs[i])
    else:
        m = [_array(x) for x in (sm.maps[i].table.keys,) + tuple(
            sm.maps[i])[1:]]
        db = [np.array(x) for x in sm.dbs[i]]
    return dict(map=m, db=db, on_host=bool(sm.is_on_host(i)),
                global_pose=np.asarray(sm.global_poses[i], np.float32),
                spawn_pose=np.asarray(sm.spawn_poses[i], np.float32),
                anchor_frame=int(sm.anchor_frames[i]),
                pending={int(f): (np.asarray(T, np.float32), float(e))
                         for f, (T, e) in
                         sm.pending_corrections[i].items()},
                dirty=bool(sm.dirty[i]))


def slam_state_to_numpy(slam) -> dict:
    """A DenseSLAM's state (the port's or the JAX package's): every submap
    (`submap_state_to_numpy`), the frontend state in the JAX leaf order,
    the frame counter and the pose history."""
    sm = slam.submaps
    return dict(submaps=[submap_state_to_numpy(sm, i)
                         for i in range(sm.num_local_maps)],
                fe_state=frontend_state_to_numpy(slam.fe_state),
                frame=int(slam.frame),
                pose_history=[(int(f), np.asarray(T, np.float32))
                              for f, T in slam.pose_history])


def slam_state_from_numpy(state: Mapping, slam: DenseSLAM) -> DenseSLAM:
    """Load `state` into the port's DenseSLAM `slam`: submaps on its
    device, spilled ones as CPU tensors."""
    dev = slam.device
    sm = slam.submaps
    sm.finalize_spills()
    sm._reset()
    for e in state["submaps"]:
        where = torch.device("cpu") if e["on_host"] else dev
        i = sm._append(map_state_from_numpy(e["map"], where),
                       fusion_db_from_numpy(e["db"], where),
                       e["global_pose"], e["spawn_pose"], e["anchor_frame"],
                       e["on_host"])
        sm.pending_corrections[i] = {
            int(f): (np.asarray(T, np.float32), float(err))
            for f, (T, err) in e["pending"].items()}
        sm.dirty[i] = bool(e["dirty"])
    slam.fe_state = frontend_state_from_numpy(state["fe_state"], dev)
    slam.frame = int(state["frame"])
    slam.pose_history = [(int(f), np.asarray(T, np.float32))
                         for f, T in state["pose_history"]]
    return slam


_SYSTEM_FIELDS = ("num_loops", "num_corrections", "num_relocs", "num_culled",
                  "_lost_streak", "_tick_count", "_chain_scan",
                  "_reloc_pending", "_lost_anchor_nkf")


def system_state_to_numpy(system) -> dict:
    """The port's SLAMSystem state."""
    return dict(backend=backend_state_to_numpy(system.backend),
                slam=slam_state_to_numpy(system.slam),
                **{f: getattr(system, f) for f in _SYSTEM_FIELDS})


def system_state_from_numpy(state: Mapping, system):
    """Load `state` into the port's SLAMSystem `system`."""
    backend_state_from_numpy(state["backend"], system.backend)
    slam_state_from_numpy(state["slam"], system.slam)
    for f in _SYSTEM_FIELDS:
        setattr(system, f, state[f])
    return system
