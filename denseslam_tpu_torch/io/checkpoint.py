"""System checkpoint/resume (port of denseslam_tpu/io/checkpoint.py), in
the JAX package's own `.npz` layout, so that a checkpoint written by
either package resumes in the other:

  meta/num_submaps, meta/global_poses, meta/spawn_poses,
  meta/anchor_frames     the submaps' registry;
  map/{i}, db/{i}        submap 0's map and fusion-DB leaves, by leaf index
                         in the JAX order (io/convert.py); map{s}/{i},
                         db{s}/{i} for submap s >= 1; a bf16 plane as its
                         uint16 bits under `{key}:bf16`; the DB's depth as
                         the JAX package's uint16;
  meta/pend_frames{s}, meta/pend_poses{s}, meta/pend_errs{s}
                         corrections deferred for submap s;
  fe/{i}                 the frontend state's leaves in the JAX order, its
                         threefry key among them, so that a resumed run
                         draws what an uninterrupted one would;
  meta/frame, meta/keyframes, meta/pose_frames, meta/pose_mats
                         the frame counter, the fused-keyframe count and
                         the pose history.

Loading puts every submap on the system's device; a plane written under
another storage_dtype converts through float (values, not bits), as the
JAX loader does.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import convert


def _put(flat: Dict[str, np.ndarray], prefix: str,
         leaves: List[np.ndarray], bf16: set) -> None:
    for i, arr in enumerate(leaves):
        flat[f"{prefix}/{i}" + (":bf16" if i in bf16 else "")] = arr


def _get(data, prefix: str) -> List[np.ndarray]:
    out, i = [], 0
    while True:
        key = f"{prefix}/{i}"
        if key in data:
            out.append(data[key])
        elif key + ":bf16" in data:
            out.append(data[key + ":bf16"].view(np.uint16))
        else:
            return out
        i += 1


def save_slam_checkpoint(path: str, slam) -> None:
    """Serialise a DenseSLAM's dynamic state: every submap with its fusion
    DB and alignment poses, the frontend state and the history."""
    sm = slam.submaps
    sm.finalize_spills()
    s = sm.num_local_maps
    flat: Dict[str, np.ndarray] = {
        "meta/num_submaps": np.asarray(s),
        "meta/global_poses": np.stack(sm.global_poses),
        "meta/spawn_poses": np.stack(sm.spawn_poses),
        "meta/anchor_frames": np.asarray(sm.anchor_frames),
    }
    for si in range(s):
        sfx = "" if si == 0 else str(si)
        e = convert.submap_state_to_numpy(sm, si)
        bf16 = {i for i, t in ((1, sm.maps[si].tsdf), (2, sm.maps[si].weight))
                if t.dtype == torch.bfloat16}
        _put(flat, "map" + sfx, e["map"], bf16)
        _put(flat, "db" + sfx, e["db"], set())
        pend = e["pending"]
        if pend:
            fids = sorted(pend)
            flat[f"meta/pend_frames{si}"] = np.asarray(fids, np.int64)
            flat[f"meta/pend_poses{si}"] = np.stack([pend[f][0] for f in fids])
            flat[f"meta/pend_errs{si}"] = np.asarray(
                [pend[f][1] for f in fids], np.float64)
    _put(flat, "fe", convert.frontend_state_to_numpy(slam.fe_state), set())
    flat["meta/frame"] = np.asarray(slam.frame)
    flat["meta/keyframes"] = np.asarray(slam.current_keyframes)
    if slam.pose_history:
        flat["meta/pose_frames"] = np.asarray([p[0] for p in slam.pose_history])
        flat["meta/pose_mats"] = np.stack([p[1] for p in slam.pose_history])
    np.savez_compressed(path, **flat)


def _as_storage(m, dtype: torch.dtype):
    """Map `m` with its tsdf and weight planes in `dtype` (through float)."""
    if m.tsdf.dtype == dtype:
        return m
    return m._replace(tsdf=m.tsdf.to(torch.float32).to(dtype),
                      weight=m.weight.to(torch.float32).to(dtype))


def load_slam_checkpoint(path: str, slam) -> None:
    """Restore into a freshly-constructed DenseSLAM with the same config."""
    with np.load(path, allow_pickle=False) as npz:
        data = dict(npz)
    s = int(data.get("meta/num_submaps", 1))
    eye = np.eye(4, dtype=np.float32)
    submaps = []
    for si in range(s):
        sfx = "" if si == 0 else str(si)
        if f"meta/pend_frames{si}" in data:
            fids = data[f"meta/pend_frames{si}"]
            errs = data.get(f"meta/pend_errs{si}", np.full(len(fids), np.inf))
            pending = {int(f): (T, float(e)) for f, T, e in
                       zip(fids, data[f"meta/pend_poses{si}"], errs)}
        else:
            pending = {}
        poses = "meta/global_poses" in data
        submaps.append(dict(
            map=_get(data, "map" + sfx), db=_get(data, "db" + sfx),
            on_host=False, dirty=True, pending=pending,
            global_pose=data["meta/global_poses"][si] if poses else eye,
            spawn_pose=data["meta/spawn_poses"][si] if poses else eye,
            anchor_frame=(int(data["meta/anchor_frames"][si]) if poses
                          else (0 if si == 0 else -1))))
    history = []
    if "meta/pose_frames" in data:
        history = list(zip(data["meta/pose_frames"], data["meta/pose_mats"]))
    convert.slam_state_from_numpy(
        dict(submaps=submaps, fe_state=_get(data, "fe"),
             frame=int(data["meta/frame"]), pose_history=history), slam)
    dtype = (torch.bfloat16 if slam.cfg.tsdf.storage_dtype == "bfloat16"
             else torch.float32)
    sm = slam.submaps
    for si in range(s):
        sm.maps[si] = _as_storage(sm.maps[si], dtype)
    slam.current_keyframes = int(data["meta/keyframes"])
