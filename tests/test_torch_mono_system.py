"""The whole system in monocular mode (models/system.py `SLAMSystem` with
sensor="mono": the chunk scan `process_sequence_mono`, keyframe
registration with the virtual right features, the backend tick, online
correction) against the JAX package's `SLAMSystem`, over two chunks of 8
street frames at 160x120, the configuration of tests/test_torch_system.py
with the mono drive's sensor model (photometric noise 2.0, a gain ramp,
1% relative depth noise, 5% holes) and the estimator settings of
tests/test_torch_mono.py (512 features, a 0.5 px Sampson threshold).

Both systems draw each frame's 8-point hypotheses from their frontend's
key (the port through utils/threefry.py); nothing is handed in.
Tolerances, and why:
  * tracking flags, fused keyframes, keyframe ids and every counter
    (loops, corrections, culled, BA rejects, odometry edges) equal;
  * keyframe poses, the pose history and the frontend pose within 1e-4 m
    (translation) and 1e-4 (rotation entries), as for the stereo system;
  * the map: hash tables, stamps and counters equal; weights, colours and
    tsdf equal on all but 1e-3 of the voxel pool (weights differ on 1.1e-5
    and 9.5e-6 of it, colours on 3.3e-5 and 2.6e-5), tsdf within 5e-4:
    the 1e-4 m pose tolerance over the 0.2 m truncation band (the second
    chunk's keyframe poses differ by 2.5e-5 m, which moves the re-fused
    tsdf by up to 1.25e-4).
Where the two estimators pick different hypotheses on a frame (a
degenerate or tied winner, tests/test_torch_mono.py `_frame_held`), every
later pose moves; this drive has no such frame.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import (OnlineCorrectionParams, SlideWindowParams,
                                  VoxelDecayParams, tiny_test_config)
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.models import system as jsys
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import system as psys

CHUNK = 8
N_CHUNKS = 2
K = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are small: one thread each spares the other
    test processes of a parallel run the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config():
    cfg = tiny_test_config(width=160, height=120, baseline_m=0.537)
    return dataclasses.replace(
        cfg,
        frontend=dataclasses.replace(cfg.frontend, max_features=512,
                                     ransac_iters=K, bucket_w=16,
                                     bucket_h=16, ransac_thresh_px=0.5),
        tsdf=dataclasses.replace(cfg.tsdf, alloc_subsample=2,
                                 sampler="gather", storage_dtype="float32"),
        decay=VoxelDecayParams(enabled=True, min_decay_age=4,
                               max_decay_weight=2),
        slide_window=SlideWindowParams(enabled=True, max_age=8),
        correction=OnlineCorrectionParams(enabled=True, correction_num=5,
                                          start_correction_num=1,
                                          min_error=0.001),
        backend=dataclasses.replace(
            cfg.backend, window_keyframes=4, max_landmarks=256,
            max_pg_nodes=32, max_pg_edges=64, retrieval_capacity=128),
        pipeline=dataclasses.replace(cfg.pipeline, fusion_db_capacity=8,
                                     keyframe_every=2, sensor="mono"))


def _frames(cfg, rng):
    n = CHUNK * N_CHUNKS
    poses = js.make_trajectory(n, step_m=0.25, yaw_rate=0.003)
    g, d = js.render_trajectory(poses, cfg.rig.intr, js.street_scene())
    g, d = np.asarray(g), np.asarray(d)
    gain = 1.0 + 0.15 * np.sin(2 * np.pi * np.arange(n) / 150.0)
    g = np.clip(g * gain[:, None, None] + 2.0 * rng.normal(size=g.shape),
                0, 255).astype(np.float32)
    dn = d * (1.0 + 0.01 * rng.normal(size=d.shape))
    holes = rng.random(d.shape) < 0.05
    d = np.where(holes | (d <= 0) | (d > cfg.tsdf.max_depth_m), 0.0,
                 dn).astype(np.float32)
    return g, d


def _snapshot(system, out, jax_side):
    slam = system.slam
    if jax_side:
        # copies: the next chunk's scan donates the JAX map's buffers
        m = [np.array(x) for x in jax.tree.leaves(slam.submaps.active)]
        T_fe = np.asarray(slam.fe_state.T_wc)
    else:
        m = convert.map_state_to_numpy(slam.submaps.active)
        T_fe = slam.fe_state.T_wc.numpy()
    ids, poses = system.keyframe_trajectory()
    return dict(
        ok=np.asarray(out["tracking_ok_frames"]), fused=out["fused"],
        ids=ids, poses=poses, T_fe=T_fe,
        history=np.stack([T for _, T in slam.pose_history]),
        counters=(system.num_loops, system.num_corrections,
                  system.num_culled, system.backend.ba_rejects,
                  len(system.backend.odom_edges)),
        map=m)


@pytest.fixture(scope="module")
def runs():
    cfg = _config()
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    grays, depths = _frames(cfg, np.random.default_rng(7))
    jsystem = jsys.SLAMSystem(cfg, seed=0, ba_every=1, loop_every=1)
    psystem = psys.SLAMSystem(pcfg, seed=0, ba_every=1, loop_every=1,
                              device="cpu")
    snaps = []
    for c in range(N_CHUNKS):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        jo = jsystem.process_chunk(jnp.asarray(grays[sl]),
                                   jnp.asarray(depths[sl]))
        po = psystem.process_chunk(torch.tensor(grays[sl]),
                                   torch.tensor(depths[sl]))
        snaps.append((_snapshot(psystem, po, False),
                      _snapshot(jsystem, jo, True)))
    return snaps, psystem, jsystem


def _assert_pose_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[..., :3, 3], want[..., :3, 3], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[..., :3, :3], want[..., :3, :3], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("chunk", range(N_CHUNKS))
def test_mono_process_chunk_matches_jax(runs, chunk):
    got, want = runs[0][chunk]
    np.testing.assert_array_equal(got["ok"], want["ok"])
    assert got["ok"].all() and got["fused"] == want["fused"]
    np.testing.assert_array_equal(got["ids"], want["ids"])
    assert len(got["ids"]) == 4 * (chunk + 1)
    assert got["counters"] == want["counters"]
    _assert_pose_close(got["poses"], want["poses"])
    _assert_pose_close(got["history"], want["history"])
    _assert_pose_close(got["T_fe"], want["T_fe"])


@pytest.mark.parametrize("chunk", range(N_CHUNKS))
def test_mono_map_matches_jax(runs, chunk):
    got, want = (s["map"] for s in runs[0][chunk])
    names = ["keys", "tsdf", "weight", "color", "alloc_frame", "last_seen",
             "frame", "decayed_blocks", "overflow"]
    for name, a, b in zip(names, want, got):
        if name not in ("tsdf", "weight", "color"):
            np.testing.assert_array_equal(b, a, name)
    assert (got[2] > 0).sum() > 2000
    differ = ((want[2] != got[2]) | (want[3] != got[3])
              | (np.abs(want[1] - got[1]) > 5e-4))
    assert differ.mean() <= 1e-3, differ.mean()


def test_mono_backend_tick_corrected_the_map(runs):
    """The ticks ran local BA on the mono keyframes (their virtual right
    features give it landmarks) and re-fused keyframes; every keyframe
    after the first has its odometry edge."""
    got, _ = runs[0][-1]
    _, corrections, _, _, edges = got["counters"]
    assert corrections >= 1 and edges == len(got["ids"]) - 1
    assert runs[1].backend.last_ba_ms is not None
