"""The JAX golden of the stereo main path (tests/golden/*.npz, made by
tests/_torch_golden.py) and the port's digests and check
(denseslam_tpu_torch/tools/golden.py), on the CPU:

  (a) the generator's restatement of scripts/long_drive_eval.py's stereo
      configuration is the port's `drive_config("stereo")` (and its small
      variant), and each committed golden was made for it and for
      chip_smoke.py's dataset arguments;
  (b) `map_digest` of a JAX map equals that of the same map carried into
      the port and back (io/convert.py), in float32 and bfloat16 storage;
  (c) `check` accepts a copy of the full golden and rejects a copy with a
      pose moved by 2e-4 m, one keyframe depth changed, one block dropped
      (from the replay, whose keys must all be the golden's) or one input
      changed;
  (d) the port's `process_sequence` meets the 160x120 golden on the CPU,
      over the same 8 frames written by io/make_dataset.py and decoded by
      the port's reader, with the RANSAC draws from the frontend's key:
      every gate of `check`, the replay at the golden's poses included.
      At this size the drive's own map keeps 99.66% of its blocks within
      the per-block tolerances (its poses part from JAX's by 2.0e-6 m by
      the last keyframe) and the replay all of them.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_golden as gen
from denseslam_tpu.ops import tsdf as jt
from denseslam_tpu_torch.io import convert, datasets
from denseslam_tpu_torch.io.make_dataset import make_dataset
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.models import frontend as pfe
from denseslam_tpu_torch.ops import tsdf as pt
from denseslam_tpu_torch.tools import golden
from denseslam_tpu_torch.tools.long_drive_eval import drive_config


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are small: one thread each spares the other
    test processes of a parallel run the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_config(tiny):
    if tiny:
        return drive_config("stereo", width=160, height=120, small=True)
    return drive_config("stereo")


@pytest.mark.parametrize("tiny", [False, True], ids=["full", "tiny"])
def test_golden_was_made_for_the_drive_configuration(tiny):
    want = golden.config_json(_port_config(tiny))
    jcfg = gen.jax_drive_config(small=tiny)
    assert golden.config_json(convert.config_from_dict(
        dataclasses.asdict(jcfg))) == want
    g = golden.load(gen.GOLDEN_TINY if tiny else gen.GOLDEN)
    meta = g["meta"]
    assert meta["config"] == golden.config_json(jcfg)
    assert golden.config_json(convert.config_from_dict(meta["config"])) == want
    assert meta["kitti_args"] == gen.kitti_args(tiny)
    assert meta["tiny"] == tiny and meta["frames"] == len(g["T_wc"])
    if not tiny:
        import chip_smoke            # on the path once kitti_args has run
        assert meta["kitti_args"] == chip_smoke.CLI_KITTI_ARGS
        assert (meta["frames"], g["fused"].sum()) == (64, 16)
        assert meta["config"]["rig"][0][4:] == [1226, 370]


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_map_digest_survives_the_carry_into_the_port(storage):
    rng = np.random.default_rng(3)
    tc = dataclasses.replace(gen.jax_drive_config(small=True).tsdf,
                             table_slots=256, storage_dtype=storage)
    m = jt.make_map(tc)
    s = tc.table_slots
    keys = np.full(s, golden.EMPTY_KEY, np.int32)
    held = rng.choice(s, 40, replace=False)
    keys[held] = rng.integers(0, 1 << 29, 40)
    m = m._replace(
        table=m.table._replace(keys=jnp.asarray(keys)),
        tsdf=jnp.asarray(rng.uniform(-1, 1, (s, 512)), m.tsdf.dtype),
        weight=jnp.asarray(rng.integers(0, 30, (s, 512)), m.weight.dtype),
        color=jnp.asarray(rng.integers(0, 1 << 24, (s, 512)), jnp.int32),
        alloc_frame=jnp.asarray(rng.integers(0, 9, s), jnp.int32),
        last_seen=jnp.asarray(rng.integers(0, 9, s), jnp.int32),
        frame=jnp.int32(9), decayed_blocks=jnp.int32(2),
        overflow=jnp.int32(1))
    want = golden.map_digest([np.asarray(x) for x in jax.tree.leaves(m)])
    pm = convert.map_state_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(m)], device="cpu")
    got = golden.map_digest(convert.map_state_to_numpy(pm))
    assert sorted(got) == sorted(want) and len(want["block_slot"]) == 40
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
    assert want["map_counters"].tolist() == [9, 2, 1]


def _moved_pose(r):
    r["T_wc"][40, 0, 3] += np.float32(2e-4)


def _changed_depth(r):
    r["depth_sha"][5, 0] ^= 1


def _dropped_block(r):
    for k in [k for k in r if k.startswith(("block_", "replay_block_"))]:
        r[k] = np.delete(r[k], 123, axis=0)


def _changed_input(r):
    r["inputs"][17, 3] ^= 1


@pytest.mark.parametrize("edit,gate", [
    (None, None), (_moved_pose, "poses"), (_changed_depth, "keyframe_depth"),
    (_dropped_block, "replay_map_keys"), (_changed_input, "inputs")],
    ids=["unchanged", "pose", "depth", "block", "input"])
def test_check_rejects_each_change_to_a_golden(edit, gate):
    g = golden.load(gen.GOLDEN)
    run = {k: v for k, v in g.items() if k != "meta"}
    run.update({"replay_" + k: v for k, v in run.items()
                if k.startswith(("block_", "map_"))})
    run = copy.deepcopy(run)
    if edit is None:
        rep = golden.check(g, run)
        assert rep["failed"] == [] and rep["max_pose_diff_m"] == 0.0
        assert rep["map_blocks_equal_by_sha_share"] == 1.0
        return
    edit(run)
    with pytest.raises(golden.GoldenMismatch) as e:
        golden.check(g, run)
    assert gate in e.value.failed


def test_port_meets_the_tiny_golden(tmp_path):
    g = golden.load(gen.GOLDEN_TINY)
    cfg = _port_config(True)
    root = make_dataset([str(tmp_path / "kitti")] + g["meta"]["kitti_args"]
                        + ["--device", "cpu"])
    frames = list(datasets.Input(root, datasets.kitti_odometry_config()))
    lefts = torch.stack([torch.as_tensor(f["left"]) for f in frames])
    rights = torch.stack([torch.as_tensor(f["right"]) for f in frames])
    st = pfe.init_frontend(cfg, device="cpu")
    m = pt.make_map(cfg.tsdf, device="cpu")
    db = pd.make_fusion_db(cfg, device="cpu")
    _, m, db, stats = pd.process_sequence(
        st, m, db, lefts, rights,
        torch.arange(len(frames), dtype=torch.int32), cfg)
    run = golden.run_record(
        {k: stats[k].numpy()
         for k in ("T_wc", "tracking_ok", "fused", "num_inliers")},
        convert.map_state_to_numpy(m), convert.fusion_db_to_numpy(db),
        golden.input_digest(lefts.numpy(), rights.numpy()))
    replay = golden.replay_map(db, lefts, g["T_wc"], cfg)
    run.update({"replay_" + k: v for k, v in golden.map_digest(
        convert.map_state_to_numpy(replay)).items()})
    rep = golden.check(g, run)
    assert rep["inputs_equal"] and rep["keyframes"] == 2
    assert rep["max_pose_diff_m"] <= golden.POSE_T_M
    assert rep["replay_map_blocks_within_share"] == 1.0
    assert rep["map_blocks"] > 1000
