"""Carry state across from the JAX package, as numpy arrays, and back.

A map is the sequence of its leaves in the JAX `MapState` order —
table.keys, tsdf, weight, color, alloc_frame, last_seen, frame,
decayed_blocks, overflow — the order io/checkpoint.py of the JAX package
writes. A fusion DB is depth, gray, T_fused, frame_id, valid, head.
Features are uv, cls, desc, score, valid; a frontend state is the leaves
of the JAX `FrontendState` (`jax.tree.leaves` order), whose PRNG key the
port does not keep.

bf16 planes arrive as `ml_dtypes.bfloat16` arrays or as their uint16 bits
and are reinterpreted bit for bit; they leave as uint16 bits (the
checkpoint's on-disk convention). The DB's u16 depth is held as int32 in
the port (see models/dense_slam.py FusionDB).
"""

from __future__ import annotations

import dataclasses
import typing
from typing import List, Mapping, Sequence

import numpy as np
import torch

from ..config import SystemConfig
from ..device import resolve_device
from ..models.dense_slam import FusionDB
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


def _plane_to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    return t.detach().cpu().numpy()


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
    ints = lambda t: t.detach().cpu().numpy().astype(np.int32)  # noqa: E731
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
    cpu = lambda t: t.detach().cpu().numpy()  # noqa: E731
    depth = cpu(db.depth)
    gray = cpu(db.gray)
    if db.quantized:
        depth = depth.astype(np.uint16)
    return [depth, gray, cpu(db.T_fused), cpu(db.frame_id).astype(np.int32),
            cpu(db.valid), cpu(db.head).astype(np.int32)]


_FEATURE_DTYPES = (torch.float32, torch.int32, torch.float32, torch.float32,
                   torch.bool)


def features_from_numpy(leaves: Sequence, device=None) -> Features:
    """JAX Features leaves (uv, cls, desc, score, valid) -> port Features."""
    dev = resolve_device(device)
    return Features(*(torch.tensor(np.asarray(a), dtype=dt, device=dev)
                      for a, dt in zip(leaves, _FEATURE_DTYPES)))


def features_to_numpy(f: Features) -> List[np.ndarray]:
    return [t.detach().cpu().numpy() for t in f]


# FrontendState's fields after the two feature sets, in the JAX order;
# the JAX state has its PRNG key between prior_ok and frame
_STATE_DTYPES = (("disp_l", torch.float32), ("disp_r", torch.float32),
                 ("T_wc", torch.float32), ("T_delta_prev", torch.float32),
                 ("initialized", torch.bool), ("prior_ok", torch.bool),
                 ("frame", torch.int32), ("img_l", torch.float32),
                 ("img_r", torch.float32), ("exposure", torch.float32))
_KEY_AT = 16


def frontend_state_from_numpy(leaves: Sequence, device=None) -> FrontendState:
    """JAX FrontendState leaves (numpy, key included) -> port state; the
    key is dropped (the port takes its RANSAC draws as an argument)."""
    dev = resolve_device(device)
    leaves = list(leaves)
    rest = leaves[10:_KEY_AT] + leaves[_KEY_AT + 1:]
    return FrontendState(
        feats_l=features_from_numpy(leaves[:5], dev),
        feats_r=features_from_numpy(leaves[5:10], dev),
        **{name: torch.tensor(np.asarray(a), dtype=dt, device=dev)
           for (name, dt), a in zip(_STATE_DTYPES, rest)})


def frontend_state_to_numpy(st: FrontendState, key) -> List[np.ndarray]:
    """Port state -> JAX FrontendState leaves, with `key` (numpy) in the
    key's place."""
    rest = [getattr(st, name).detach().cpu().numpy()
            for name, _ in _STATE_DTYPES]
    leaves = features_to_numpy(st.feats_l) + features_to_numpy(st.feats_r)
    return leaves + rest[:6] + [np.asarray(key)] + rest[6:]


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
