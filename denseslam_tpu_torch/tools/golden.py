"""Digests of a stereo chunk's result, and the check of a run against a
golden record of them.

The golden of the stereo main path (tests/golden/stereo_chunk_jax.npz) is
made by the JAX package's `process_sequence` over the first 64 frames of
the flagship loop drive (tests/_torch_golden.py); `chip_smoke.py`
`jax_golden` holds the port's run on the card against it. Both sides
build their record with `run_record`, so each digest has one definition:

  inputs   the sha256 of each decoded frame: the left then the right
           image as float32 bytes;
  frames   T_wc (N, 4, 4) float32, tracking_ok, fused, num_inliers;
  depth    the fused keyframes' frame ids and the sha256 of each one's
           mm-quantised depth in the fusion DB, as uint16 (the port holds
           that plane as int32);
  map      frame, decayed_blocks, overflow; the valid blocks' slots, keys,
           alloc_frame and last_seen in slot order; per block its weight
           sum (int64), tsdf sum (float64) and the sha256 of its voxels
           (tsdf and weight as float32, colour as int32).

A run's record may also hold `replay_*`: the map digest of its fusion DB's
keyframes fused anew at the golden's poses (`replay_map`), which holds the
fusion alone to the golden (REPLAY_BLOCK_SHARE); the drive's own map is
fused at the run's own poses (DRIVE_BLOCK_SHARE).

A record is a flat dict of numpy arrays (what `np.savez` writes) plus
`meta`, a JSON-able dict. Maps and DBs arrive as numpy leaves in the JAX
order (io/convert.py `map_state_to_numpy`, `fusion_db_to_numpy`, or
`jax.tree.leaves` of the JAX package's states).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Mapping, Sequence

import numpy as np

EMPTY_KEY = 2 ** 30          # ops/hash.py: a free slot
BLOCK_VOL = 512

# the gates (tests/test_torch_stereo_path.py's tolerances)
POSE_T_M = 1e-4              # translation, m
POSE_R = 1e-5                # rotation entries
TSDF_SUM = BLOCK_VOL * 5e-5  # a block's tsdf sum: 5e-5 a voxel
# Blocks within the per-block tolerances (weight sum equal, tsdf sum
# within TSDF_SUM), two documented tie tolerances in place of 99.9%:
#
# The replay (the run's keyframe depths fused at the golden's poses):
# jitted XLA contracts the voxel projection into FMAs (u = fma(px / z, fx,
# cx) over FMA chains of the rotation rows, in an order that moves with
# the fused program), where the port rounds every op. From the same
# inputs the projections part in their last bits on 24-70% of voxels, and
# a voxel whose projection lies within that of a pixel edge rounds to the
# other pixel (6 voxels of keyframe 60 of the flagship chunk), or one
# within it of the truncation edge (sdf = -mu) is fused on one side only.
# Each fails its block: 99.491% of the chunk's blocks are within on the
# card (weights equal on 99.797%); all of them at 160x120. The replay's
# block keys, slots and stamps all equal the golden's.
REPLAY_BLOCK_SHARE = 0.99
# The drive's own map: its poses also part from JAX's in the last bits
# from frame 1 (the VO's Gauss-Newton normal equations, ops/ransac.py
# `_gn_refine`, are summed exactly in float64 where jitted XLA sums them
# in FMA chains), by up to 6.7e-5 m after the flagship chunk's 64 frames,
# inside POSE_T_M; each voxel's projection moves by that, and the same
# near-ties part many more voxels: 94.447% of the blocks are within on
# the card (weights equal on 96.918%); 99.66% at 160x120 over 8 frames.
# A block whose voxels' back-projections lie that close to a block edge
# is allocated on one side only: one block of 9832 in the flagship chunk.
DRIVE_BLOCK_SHARE = 0.9
DRIVE_KEY_SHARE = 0.999


class GoldenMismatch(AssertionError):
    """A run that fails one or more gates; `.report` holds every measured
    difference and `.failed` the gates that failed."""

    def __init__(self, failed, report):
        super().__init__(f"gates failed: {failed}; {report}")
        self.failed = failed
        self.report = report


def _sha(a: np.ndarray) -> bytes:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).digest()


def _f32(a) -> np.ndarray:
    """A tsdf / weight plane as float32: bf16 arrives as ml_dtypes
    bfloat16 or as its uint16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.uint32)
        return (bits << 16).view(np.float32)
    return a.astype(np.float32)


def input_digest(lefts: Sequence, rights: Sequence) -> np.ndarray:
    """(N, 32) uint8: the sha256 of each frame's left and right images as
    float32 bytes, left first."""
    out = np.zeros((len(lefts), 32), np.uint8)
    for i, (l, r) in enumerate(zip(lefts, rights)):
        h = hashlib.sha256(np.ascontiguousarray(l, np.float32).tobytes())
        h.update(np.ascontiguousarray(r, np.float32).tobytes())
        out[i] = np.frombuffer(h.digest(), np.uint8)
    return out


def depth_digest(db_leaves: Sequence) -> dict:
    """The fusion DB's keyframes in frame order: their frame ids and the
    sha256 of each mm-quantised depth as uint16."""
    depth, _, _, frame_id, valid = (np.asarray(x) for x in db_leaves[:5])
    if not np.issubdtype(depth.dtype, np.integer):
        raise ValueError("the fusion DB does not hold mm-quantised depth")
    slots = np.flatnonzero(valid)
    slots = slots[np.argsort(frame_id[slots], kind="stable")]
    shas = np.zeros((len(slots), 32), np.uint8)
    for k, s in enumerate(slots):
        shas[k] = np.frombuffer(_sha(depth[s].astype(np.uint16)), np.uint8)
    return dict(depth_frame=frame_id[slots].astype(np.int32),
                depth_sha=shas)


def map_digest(map_leaves: Sequence) -> dict:
    """The map's counters and, per valid block in slot order, its slot,
    key, stamps, weight sum (int64), tsdf sum (float64) and voxel
    sha256."""
    keys, tsdf, weight, color, af, ls, frame, dec, ovf = map_leaves
    keys = np.asarray(keys).astype(np.int32)
    slots = np.flatnonzero(keys != EMPTY_KEY)
    t = _f32(tsdf)[slots]
    w = _f32(weight)[slots]
    c = np.asarray(color).astype(np.int32)[slots]
    wsum = w.astype(np.float64).sum(axis=1)
    if not np.array_equal(wsum, np.rint(wsum)):
        raise ValueError("the map holds weights that are not whole")
    shas = np.zeros((len(slots), 32), np.uint8)
    for k in range(len(slots)):
        h = hashlib.sha256(t[k].tobytes())
        h.update(w[k].tobytes())
        h.update(c[k].tobytes())
        shas[k] = np.frombuffer(h.digest(), np.uint8)
    return dict(
        map_counters=np.array([int(np.asarray(frame)), int(np.asarray(dec)),
                               int(np.asarray(ovf))], np.int64),
        block_slot=slots.astype(np.int32), block_key=keys[slots],
        block_alloc_frame=np.asarray(af).astype(np.int32)[slots],
        block_last_seen=np.asarray(ls).astype(np.int32)[slots],
        block_weight_sum=wsum.astype(np.int64),
        block_tsdf_sum=t.astype(np.float64).sum(axis=1),
        block_sha=shas)


def run_record(stats: Mapping, map_leaves: Sequence, db_leaves: Sequence,
               inputs: np.ndarray) -> dict:
    """A run's record: `stats` as process_sequence returns them (numpy),
    the final map's and fusion DB's leaves, and `input_digest`'s
    array."""
    rec = dict(inputs=np.asarray(inputs, np.uint8),
               T_wc=np.asarray(stats["T_wc"], np.float32),
               tracking_ok=np.asarray(stats["tracking_ok"], bool),
               fused=np.asarray(stats["fused"], bool),
               num_inliers=np.asarray(stats["num_inliers"]).astype(np.int32))
    rec.update(depth_digest(db_leaves))
    rec.update(map_digest(map_leaves))
    return rec


def replay_map(db, lefts, T_wc, cfg):
    """The fusion DB's keyframes fused anew, in frame order, into a fresh
    map at the poses T_wc (indexed by frame id, numpy): the drive's fusion
    with its poses taken from elsewhere. `db` and `lefts` (the drive's
    left images) are the port's tensors; returns the port's map."""
    import torch

    from ..models import dense_slam as pd
    from ..ops import tsdf as pt

    dev = lefts.device
    m = pt.make_map(cfg.tsdf, device=dev)
    fresh = pd.make_fusion_db(cfg, device=dev)
    frame = db.frame_id.cpu().numpy()
    for s in sorted(np.flatnonzero(db.valid.cpu().numpy()),
                    key=lambda s: frame[s]):
        f = int(frame[s])
        m, fresh = pd.fuse_keyframe(
            m, fresh, pd.db_depth(db, int(s)), lefts[f],
            torch.as_tensor(np.asarray(T_wc[f], np.float32), device=dev),
            torch.tensor(f, dtype=torch.int32, device=dev), cfg)
    return m


def config_json(cfg) -> dict:
    """A SystemConfig of either package as plain JSON values (tuples and
    named tuples become lists), the form the golden's meta holds."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def save(path: str, record: Mapping, meta: Mapping) -> None:
    np.savez_compressed(path, meta=np.array(json.dumps(meta, sort_keys=True)),
                        **record)


def load(path: str) -> dict:
    with np.load(path) as z:
        rec = {k: z[k] for k in z.files if k != "meta"}
        rec["meta"] = json.loads(str(z["meta"]))
    return rec


def _first(mask: np.ndarray):
    idx = np.flatnonzero(mask)
    return int(idx[0]) if len(idx) else None


def _check_map(golden: Mapping, run: Mapping, prefix: str,
               key_share: float, share: float, rep: dict) -> list:
    """The map gates of `run`'s digest under `prefix` against the golden's
    map: counters equal; the blocks held in the same slot under the same
    key with the same stamps on at least `key_share` of the blocks of the
    larger map; and those also within the per-block tolerances on at
    least `share` of them. Fills `rep`; returns the gates that failed."""
    failed, name = [], prefix + "map"
    r = {k[len(prefix):]: v for k, v in run.items() if k.startswith(prefix)}
    rep[f"{name}_counters"] = r["map_counters"].tolist()
    if not np.array_equal(r["map_counters"], golden["map_counters"]):
        failed.append(f"{name}_counters")

    def ids(d):
        return d["block_slot"].astype(np.int64) << 32 | d["block_key"].view(
            np.uint32)

    _, g_at, r_at = np.intersect1d(ids(golden), ids(r), assume_unique=True,
                                   return_indices=True)
    n = max(len(golden["block_slot"]), len(r["block_slot"]), 1)
    same = ((golden["block_alloc_frame"][g_at] == r["block_alloc_frame"][r_at])
            & (golden["block_last_seen"][g_at] == r["block_last_seen"][r_at]))
    sha = (golden["block_sha"][g_at] == r["block_sha"][r_at]).all(axis=1)
    w_eq = golden["block_weight_sum"][g_at] == r["block_weight_sum"][r_at]
    dts = np.abs(golden["block_tsdf_sum"][g_at] - r["block_tsdf_sum"][r_at])
    within = same & w_eq & (dts <= TSDF_SUM)
    rep[f"{name}_blocks"] = int(len(r["block_slot"]))
    rep[f"{name}_blocks_same_key_slot_stamps"] = int(same.sum())
    rep[f"{name}_blocks_equal_by_sha_share"] = float(sha.sum() / n)
    rep[f"{name}_blocks_weight_equal_share"] = float(w_eq.sum() / n)
    rep[f"{name}_blocks_within_share"] = float(within.sum() / n)
    rep[f"{name}_max_block_tsdf_sum_diff"] = (float(dts.max()) if len(dts)
                                              else 0.0)
    if same.sum() < key_share * n:
        failed.append(f"{name}_keys")
    if within.sum() < share * n:
        failed.append(f"{name}_blocks")
    return failed


def check(golden: Mapping, run: Mapping) -> dict:
    """Every measured difference between a run's record and the golden,
    and which gates failed. Raises GoldenMismatch when any gate fails;
    returns the report when none does. Gates: inputs equal; tracking,
    fused and inlier counts equal on every frame; poses within POSE_T_M
    in translation and POSE_R in rotation entries; the same keyframes
    with equal depth; equal map counters; the same block keys in the same
    slots with the same stamps on DRIVE_KEY_SHARE of the blocks, and per
    block the weight sum equal and the tsdf sum within TSDF_SUM on
    DRIVE_BLOCK_SHARE of them; where the run holds a replay, its counters
    equal, its block keys, slots and stamps all the golden's, and its
    blocks within the tolerances on REPLAY_BLOCK_SHARE of them."""
    rep, failed = {}, []
    n = len(golden["T_wc"])

    same_inputs = (run["inputs"].shape == golden["inputs"].shape
                   and bool((run["inputs"] == golden["inputs"]).all()))
    rep["inputs_equal"] = same_inputs
    if not same_inputs:
        rep["inputs_first_differing_frame"] = (
            _first((run["inputs"] != golden["inputs"]).any(axis=1))
            if run["inputs"].shape == golden["inputs"].shape else 0)
        failed.append("inputs")
        raise GoldenMismatch(failed, rep)
    if len(run["T_wc"]) != n:
        raise GoldenMismatch(["frames"], dict(rep, frames=len(run["T_wc"]),
                                              golden_frames=n))

    part = np.zeros(n, bool)
    for name in ("tracking_ok", "fused", "num_inliers"):
        off = run[name] != golden[name]
        rep[f"{name}_differing_frames"] = int(off.sum())
        part |= off
        if off.any():
            failed.append(name)
    dt = np.abs(run["T_wc"][:, :3, 3].astype(np.float64)
                - golden["T_wc"][:, :3, 3]).max(axis=1)
    dr = np.abs(run["T_wc"][:, :3, :3].astype(np.float64)
                - golden["T_wc"][:, :3, :3]).max(axis=(1, 2))
    rep["pose_diff_m_by_frame"] = dt.tolist()
    rep["max_pose_diff_m"] = float(dt.max())
    rep["max_rotation_diff"] = float(dr.max())
    rep["poses_bit_equal_frames"] = int((
        run["T_wc"].view(np.int32) == golden["T_wc"].view(np.int32)
    ).all(axis=(1, 2)).sum())
    rep["first_frame_pose_bits_differ"] = _first(
        (run["T_wc"].view(np.int32)
         != golden["T_wc"].view(np.int32)).any(axis=(1, 2)))
    off = (dt > POSE_T_M) | (dr > POSE_R)
    part |= off
    if off.any():
        failed.append("poses")

    same_kf = np.array_equal(run["depth_frame"], golden["depth_frame"])
    rep["keyframes"] = int(len(golden["depth_frame"]))
    if same_kf:
        eq = (run["depth_sha"] == golden["depth_sha"]).all(axis=1)
        rep["keyframe_depth_equal"] = int(eq.sum())
        bad = golden["depth_frame"][~eq]
        if len(bad):
            part[bad.min()] = True
            failed.append("keyframe_depth")
    else:
        rep["keyframe_frames"] = run["depth_frame"].tolist()
        failed.append("keyframe_depth")
    rep["first_parting_frame"] = _first(part)

    failed += _check_map(golden, run, "", DRIVE_KEY_SHARE,
                         DRIVE_BLOCK_SHARE, rep)
    if "replay_block_slot" in run:
        failed += _check_map(golden, run, "replay_", 1.0,
                             REPLAY_BLOCK_SHARE, rep)
    rep["failed"] = failed
    if failed:
        raise GoldenMismatch(failed, rep)
    return rep
