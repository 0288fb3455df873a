"""The port's submaps against the JAX package on the same numpy inputs
(split from tests/test_torch_submaps_parity.py, whose per-frame drive
this file shares, made once a test run: tests/_torch_shared.py): the
state carried across (`io/convert.py`) at two stages of the drive, the
block-row transfer (`gather_block_rows` / `rebuild_from_rows`), the
composite merge and the host-side frustum filter `_inview_slots`. The
ops: bit for bit (the row gathers run op by op, the composite merge
against its jitted JAX form), and `_inview_slots` the same slot set from
the same state (float64 numpy on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.models import dense_slam as jd
from denseslam_tpu.ops import raycast as jrc
from denseslam_tpu.ops import tsdf as jt
from denseslam_tpu.utils import lie as jl
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.ops import raycast as prc
from denseslam_tpu_torch.ops import tsdf as pt
from test_torch_submaps_parity import (_config, drive,  # noqa: F401
                                       one_torch_thread)


@pytest.mark.parametrize("stage", ["two_submaps", "updates"])
def test_state_round_trip_from_jax(drive, stage):
    """A JAX multi-submap state (submaps on the host and on the device,
    deferred corrections) loaded into the port and read back, bit for
    bit."""
    want = drive["stages"][stage]["jstate"]
    pslam = pd.DenseSLAM(drive["pcfg"], device="cpu")
    convert.slam_state_from_numpy(want, pslam)
    assert any(pslam.submaps.is_on_host(i)
               for i in range(pslam.submaps.num_local_maps))
    got = convert.slam_state_to_numpy(pslam)
    assert len(got["submaps"]) == len(want["submaps"]) >= 2
    for a, b in zip(want["submaps"], got["submaps"]):
        for x, y in zip(a["map"] + a["db"], b["map"] + b["db"]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(y, x)
        for k in ("on_host", "anchor_frame", "dirty"):
            assert a[k] == b[k]
        for k in ("global_pose", "spawn_pose"):
            np.testing.assert_array_equal(b[k], a[k])
        assert sorted(a["pending"]) == sorted(b["pending"])
        for f, (T, e) in a["pending"].items():
            np.testing.assert_array_equal(b["pending"][f][0], T)
            assert b["pending"][f][1] == e
    for x, y in zip(want["fe_state"], got["fe_state"]):
        np.testing.assert_array_equal(y, x)



def test_block_rows_match_jax(drive):
    """gather_block_rows and rebuild_from_rows on the same map and slots,
    bit for bit."""
    leaves = drive["stages"]["drive"]["jstate"]["submaps"][0]["map"]
    jm = jax.tree.unflatten(jax.tree.structure(jt.make_map(
        _config().tsdf)), [jnp.asarray(x) for x in leaves])
    pm = convert.map_state_from_numpy(leaves, "cpu")
    keys = leaves[0]
    slots = np.flatnonzero(keys != 2 ** 30).astype(np.int32)
    n, s = slots.size, keys.size
    npad = n + 7
    pad = np.zeros(npad, np.int32)
    pad[:n] = slots
    rj = jt.gather_block_rows(jm, jnp.asarray(pad))
    rp = pt.gather_block_rows(pm, torch.tensor(pad))
    for a, b in zip(rj, rp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    inv = np.full(s, npad, np.int32)
    inv[slots] = np.arange(n, dtype=np.int32)
    scal = (leaves[6], leaves[7], leaves[8])
    bj = jt.rebuild_from_rows(jnp.asarray(inv), *rj, *scal)
    bp = pt.rebuild_from_rows(torch.tensor(inv), *rp, *(torch.tensor(x)
                                                       for x in scal))
    for a, b in zip(jax.tree.leaves(bj), convert.map_state_to_numpy(bp)):
        np.testing.assert_array_equal(b, np.asarray(a))
    for a, b in zip(leaves, convert.map_state_to_numpy(bp)):
        np.testing.assert_array_equal(b, a)



def _raycast_pair(rng, h=12, w=16):
    depth = rng.uniform(0.5, 5.0, (h, w)).astype(np.float32)
    mask = rng.uniform(size=(h, w)) < 0.7
    depth[~mask] = 0.0
    pts = rng.normal(0, 3, (h, w, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (h, w, 3)).astype(np.float32)
    col = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    arrs = (depth, pts, nrm, mask, col)
    return (jrc.Raycast(*(jnp.asarray(a) for a in arrs)),
            prc.Raycast(*(torch.tensor(a) for a in arrs)))



def test_composite_merge_matches_jax():
    """_composite_transform and _composite_merge against the JAX functions
    jitted, as the JAX DenseSLAM runs them: bit for bit. (Its 3x3 dots are
    an FMA chain there, as in torch's CPU matmul; run op by op, XLA:CPU's
    dot rounds the three-term sums another way, on about half of them.)"""
    rng = np.random.default_rng(2)
    bj, bp = _raycast_pair(rng)
    rj, rp = _raycast_pair(rng)
    D = jl.se3_exp_np(np.array([0.3, -0.1, 0.2, 0.05, -0.2, 0.1]))
    fj = jax.jit(jd._composite_transform)(bj, jnp.asarray(D))
    mj = jax.jit(jd._composite_merge)(fj, rj, jnp.asarray(D))
    fp = pd._composite_transform(bp, torch.tensor(D))
    mp = pd._composite_merge(fp, rp, torch.tensor(D))
    for a, b in zip(tuple(fj) + tuple(mj), tuple(fp) + tuple(mp)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))



def test_inview_slots_match_jax(drive):
    """The frustum filter of every submap from the same state (the JAX
    drive's, loaded into the port), at three poses: the same slots."""
    hits = 0
    for want, got in drive["inview"]:
        np.testing.assert_array_equal(got, want)
        hits += want.size
    assert hits > 0

