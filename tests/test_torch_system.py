"""The whole system on the chunk path (models/system.py `SLAMSystem`:
the chunk scan, keyframe registration, the backend tick, online
correction) against the JAX package's `SLAMSystem`, over two chunks of 8
street frames at 160x120: `tiny_test_config` with 256 features, 32 RANSAC
hypotheses, 32 disparities, a keyframe every 2 frames, the gather sampler,
f32 storage, decay, a sliding window, online correction (a low min_error,
so that the window BA's moves re-fuse keyframes), and the backend cut to a
4-keyframe window, 256 landmarks, 32 graph nodes, 64 edges and 128
retrieval slots; BA on every tick.

Frames: the stereo street under the stereo drive's nuisance, drawn with
numpy. Nothing is handed in: both systems draw each frame's RANSAC
hypotheses from their frontend's threefry key (PRNGKey(0), split once a
frame) and each verification's from PRNGKey(qi * 31 + ci), the port
through utils/threefry.py; the frontend keys are equal after each chunk.
Tolerances, and why:
  * tracking flags, fused keyframes, keyframe ids and every counter
    (loops, corrections, culled, BA rejects) equal;
  * keyframe poses, the pose history and the frontend pose within 1e-4 m
    (translation) and 1e-4 (rotation entries): the VO's descriptor and
    exposure sums, then the BA's einsums, round in another order;
  * the map: hash tables, stamps and counters equal; weights, colours and
    tsdf (5e-5) equal on all but 1e-3 of the voxel pool (observed 9.0e-5
    and 1.4e-4 after the two chunks; poses within 7.6e-6): the scan's
    keyframe depth and the correction's poses differ in the last bits (see
    tests/test_torch_stereo_path.py), and a voxel within an FMA of a pixel
    edge samples the next pixel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import (OnlineCorrectionParams, SlideWindowParams,
                                  StereoConfig, VoxelDecayParams,
                                  tiny_test_config)
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.models import system as jsys
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.models import system as psys

CHUNK = 8
N_CHUNKS = 2
K = 32


def _config():
    cfg = tiny_test_config(width=160, height=120, baseline_m=0.537)
    return dataclasses.replace(
        cfg,
        frontend=dataclasses.replace(cfg.frontend, max_features=256,
                                     ransac_iters=K, bucket_w=25,
                                     bucket_h=25),
        stereo=StereoConfig(max_disparity=32),
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
                                     keyframe_every=2))


def _frames(cfg, rng):
    n = CHUNK * N_CHUNKS
    poses = js.make_trajectory(n, step_m=0.25, yaw_rate=0.003)
    lefts, rights, _ = js.render_stereo_trajectory(poses, cfg.rig,
                                                   js.street_scene())
    gain = 1.0 + 0.15 * np.sin(2 * np.pi * np.arange(n) / 150.0)

    def nuisance(g):
        g = np.asarray(g) * gain[:, None, None]
        return np.clip(g + 2.0 * rng.normal(size=g.shape), 0,
                       255).astype(np.float32)

    return nuisance(lefts), nuisance(rights)


def _snapshot(system, out, jax_side):
    slam = system.slam
    if jax_side:
        # copies: the next chunk's scan donates the JAX map's buffers
        m = [np.array(x) for x in jax.tree.leaves(slam.submaps.active)]
        T_fe = np.asarray(slam.fe_state.T_wc)
        key = np.asarray(slam.fe_state.key)
    else:
        m = convert.map_state_to_numpy(slam.submaps.active)
        T_fe = slam.fe_state.T_wc.numpy()
        key = slam.fe_state.key.numpy().astype(np.uint32)
    ids, poses = system.keyframe_trajectory()
    return dict(
        ok=np.asarray(out["tracking_ok_frames"]), fused=out["fused"],
        ids=ids, poses=poses, T_fe=T_fe, key=key,
        history=np.stack([T for _, T in slam.pose_history]),
        counters=(system.num_loops, system.num_corrections,
                  system.num_culled, system.backend.ba_rejects,
                  len(system.backend.odom_edges)),
        map=m)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread each spares the other test processes of a parallel run
    the oversubscribed cores (the exact FMAs' float64 passes are memory
    bound)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    cfg = _config()
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    lefts, rights = _frames(cfg, np.random.default_rng(7))
    jsystem = jsys.SLAMSystem(cfg, seed=0, ba_every=1, loop_every=1)
    # JAX's fresh frontend state holds disp_l weakly typed and the chunk
    # scan returns it strongly typed: the same values, strongly typed from
    # the start, compile the scan once instead of once a chunk
    st = jsystem.slam.fe_state
    jsystem.slam.fe_state = st._replace(
        disp_l=jnp.asarray(np.asarray(st.disp_l)))
    psystem = psys.SLAMSystem(pcfg, seed=0, ba_every=1, loop_every=1,
                              device="cpu")
    snaps = []
    for c in range(N_CHUNKS):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        jo = jsystem.process_chunk(jnp.asarray(lefts[sl]),
                                   jnp.asarray(rights[sl]))
        po = psystem.process_chunk(torch.tensor(lefts[sl]),
                                   torch.tensor(rights[sl]))
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
def test_process_chunk_matches_jax(runs, chunk):
    got, want = runs[0][chunk]
    np.testing.assert_array_equal(got["ok"], want["ok"])
    assert got["ok"].all() and got["fused"] == want["fused"]
    np.testing.assert_array_equal(got["ids"], want["ids"])
    assert len(got["ids"]) == 4 * (chunk + 1)
    assert got["counters"] == want["counters"]
    _assert_pose_close(got["poses"], want["poses"])
    _assert_pose_close(got["history"], want["history"])
    _assert_pose_close(got["T_fe"], want["T_fe"])
    np.testing.assert_array_equal(got["key"], want["key"])


def test_backend_tick_corrected_the_map(runs):
    """The tick ran BA on both chunks and re-fused keyframes."""
    got, _ = runs[0][-1]
    loops, corrections, culled, rejects, _ = got["counters"]
    assert corrections >= 1 and rejects == 0


@pytest.mark.parametrize("chunk", range(N_CHUNKS))
def test_map_matches_jax(runs, chunk):
    got, want = (s["map"] for s in runs[0][chunk])
    names = ["keys", "tsdf", "weight", "color", "alloc_frame", "last_seen",
             "frame", "decayed_blocks", "overflow"]
    for name, a, b in zip(names, want, got):
        if name not in ("tsdf", "weight", "color"):
            np.testing.assert_array_equal(b, a, name)
    assert (got[2] > 0).sum() > 2000
    differ = ((want[2] != got[2]) | (want[3] != got[3])
              | (np.abs(want[1] - got[1]) > 5e-5))
    assert differ.mean() <= 1e-3, differ.mean()


def test_finish_and_state_round_trip(runs):
    """finish() runs the decay catch-up on both; the port's state carried
    to numpy and back into a fresh system reads back equal."""
    _, psystem, jsystem = runs
    psystem.finish()
    jsystem.finish()
    got = convert.map_state_to_numpy(psystem.slam.submaps.active)
    want = [np.asarray(x) for x in jax.tree.leaves(jsystem.slam.submaps.active)]
    np.testing.assert_array_equal(got[0], want[0])
    assert psystem.memory_bytes() == jsystem.memory_bytes()
    state = convert.system_state_to_numpy(psystem)
    fresh = convert.system_state_from_numpy(
        state, psys.SLAMSystem(psystem.cfg, device="cpu"))
    back = convert.system_state_to_numpy(fresh)
    [sub_b], [sub_s] = back["slam"]["submaps"], state["slam"]["submaps"]
    for a, b in zip(sub_b["map"], sub_s["map"]):
        np.testing.assert_array_equal(a, b)
    assert back["num_corrections"] == state["num_corrections"]
    assert ([k["frame_id"] for k in back["backend"]["keyframes"]]
            == [k["frame_id"] for k in state["backend"]["keyframes"]])


UNPORTED = {
    "mesh": lambda c: pd.DenseSLAM(c, mesh=object(), device="cpu"),
}


@pytest.mark.parametrize("option", sorted(UNPORTED))
def test_unported_options_raise(option):
    """Every option of the JAX DenseSLAM is ported now; `mesh` takes a
    parallel/mesh.py MapMesh (the map axis over torch.distributed), and
    anything else fails at once."""
    pcfg = convert.config_from_dict(dataclasses.asdict(_config()))
    with pytest.raises(TypeError, match="MapMesh"):
        UNPORTED[option](pcfg)
