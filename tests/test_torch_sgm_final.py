"""Kernel 4's plain version (ops/sgm.py `sgm_final_plain`, the last SGM
direction fused with the WTA tail) against the TPU kernels it replaces and
against the JAX stereo tail.

  * Both probe kernels, scripts/probes/exp_fused_sgm.py and
    exp_fused_loop.py `make_kernel`, run in Pallas interpret mode on an
    (8, 32, 32) integer-valued f32 volume with p1 = 10, p2 = 120 (the
    probes' constants), 4 grid steps of 8 columns, the last 2 columns zero
    padding (w_real = 30): every map equals the plain version's on the 30
    real columns. A zero carry stays zero through zero-cost columns, so
    the pad does not change the real columns' recurrence.
  * The port's SGM + WTA without a summed volume (ops/stereo.py
    `disparity`, which `compute_depth` runs on every device: `sgm_wta`,
    three directions, then `sgm_final`) against JAX
    `disparity_from_cost(sgm_aggregate(cost), raw_cost=cost)` on the cost
    volume of a rendered stereo pair, both backends: f32 exact; bf16
    exact too here, held to >= 99.5% of pixels agreeing (XLA on the CPU
    may keep bf16 intermediates of the aggregation in f32, see
    tests/test_torch_stereo.py).
  * The tie rule and the no-candidate-below-BIG rule of the right-view
    argmin on a hand-built volume, against a numpy transcription of the
    reference loop (denseslam_tpu/ops/stereo.py:206-218), in f32 and bf16
    (BIG is 9984 in bf16)."""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from denseslam_tpu.config import StereoConfig, tiny_test_config
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.ops import stereo as jst
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.ops import sgm as psg
from denseslam_tpu_torch.ops import stereo as pst

ROOT = Path(__file__).resolve().parent.parent
H, WP, D, WC, N = 8, 32, 32, 8, 4
W_REAL = WP - 2
P1, P2 = 10.0, 120.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread each spares the other test processes of a parallel run
    the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_probe(name):
    """Import a probe script as a module; the probes point jax's compilation
    cache at a fixed directory and extend sys.path when imported, and both
    are put back."""
    saved_cache = jax.config.jax_compilation_cache_dir
    saved_path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", ROOT / "scripts" / "probes" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved_cache)
        sys.path[:] = saved_path
    return mod


def _run_probe(kern, cost, acc):
    """The probes' pallas_call (their `run`), in interpret mode: 4 grid
    steps right to left over (H, 8, D) column blocks; maps are (W_p, H)."""
    blk3 = pl.BlockSpec((H, WC, D), lambda j: (0, N - 1 - j, 0))
    mspec = pl.BlockSpec((WC, H), lambda j: (N - 1 - j, 0))
    i32 = jax.ShapeDtypeStruct((WP, H), jnp.int32)
    f32 = jax.ShapeDtypeStruct((WP, H), jnp.float32)
    out = pl.pallas_call(
        kern, grid=(N,), in_specs=[blk3, blk3], out_specs=(mspec,) * 5,
        out_shape=(i32, f32, f32, f32, i32),
        scratch_shapes=[pltpu.VMEM((H, D), cost.dtype),
                        pltpu.VMEM((H, D), jnp.float32),
                        pltpu.VMEM((H, D), jnp.int32)],
        interpret=True)(cost, acc)
    return [np.asarray(o).T for o in out]            # (H, W_p)


@pytest.fixture(scope="module")
def padded_volume():
    rng = np.random.default_rng(7)
    cost = rng.integers(0, 200, (H, WP, D)).astype(np.float32)
    acc = rng.integers(0, 600, (H, WP, D)).astype(np.float32)
    cost[:, W_REAL:] = 0.0
    acc[:, W_REAL:] = 0.0
    maps = psg.sgm_final_plain(torch.tensor(cost[:, :W_REAL]),
                               torch.tensor(acc[:, :W_REAL]), None, P1, P2,
                               "pallas", unique=False)
    return cost, acc, maps


@pytest.mark.parametrize("probe,args", [
    ("exp_fused_sgm", ("full", WC)),
    ("exp_fused_loop", ("loop_full", WC, W_REAL)),
])
def test_plain_equals_probe_kernel(padded_volume, probe, args):
    cost, acc, maps = padded_volume
    kern = _load_probe(probe).make_kernel(*args)
    got = _run_probe(kern, jnp.asarray(cost), jnp.asarray(acc))
    for name, a in zip(("best", "cmin", "c0", "c2", "best_r"), got):
        b = getattr(maps, name).numpy()
        np.testing.assert_array_equal(a[:, :W_REAL], b, err_msg=name)
    assert maps.c_at is None and maps.second is None
    assert len(np.unique(maps.best.numpy())) > 10


@pytest.fixture(scope="module")
def pair_volume():
    cfg = tiny_test_config(width=80, height=48, baseline_m=0.25)
    sc = StereoConfig(max_disparity=32)
    left, right, _ = js.render_stereo(jnp.eye(4, dtype=jnp.float32), cfg.rig)
    pcfg = convert.config_from_dict(dataclasses.asdict(
        dataclasses.replace(cfg, stereo=sc)))
    return sc, pcfg.stereo, jst.cost_volume(left, right, sc)


@pytest.mark.parametrize("cost_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_fused_tail_matches_jax_disparity(pair_volume, backend, cost_dtype):
    sc, psc, cv = pair_volume
    sc = dataclasses.replace(sc, sgm_backend=backend)
    psc = dataclasses.replace(psc, sgm_backend=backend)
    if cost_dtype == "bfloat16":
        cv = cv.astype(jnp.bfloat16)
    dj, vj = jst.disparity_from_cost(jst.sgm_aggregate(cv, sc), sc,
                                     raw_cost=cv)
    ct = torch.tensor(np.asarray(cv.astype(jnp.float32)))
    if cost_dtype == "bfloat16":
        ct = ct.to(torch.bfloat16)
    dp, vp = pst.disparity(ct, psc)
    dj, vj, dp, vp = np.asarray(dj), np.asarray(vj), dp.numpy(), vp.numpy()
    assert vp.mean() > 0.3
    if cost_dtype == "float32":
        np.testing.assert_array_equal(dj, dp)
        np.testing.assert_array_equal(vj, vp)
    else:
        assert (vj == vp).mean() >= 0.995
        assert (dj == dp).mean() >= 0.995
    # the fused route and the volume route of the port agree exactly
    dv, vv = pst.disparity_from_cost(psg.sgm_aggregate(ct, psc.sgm_p1,
                                                       psc.sgm_p2, backend),
                                     psc, raw_cost=ct)
    np.testing.assert_array_equal(dv.numpy(), dp)
    np.testing.assert_array_equal(vv.numpy(), vp)


def _reference_best_r(final: np.ndarray, big: float) -> np.ndarray:
    """denseslam_tpu/ops/stereo.py:206-218 in numpy: D column shifts with a
    running strict-< argmin from BIG."""
    h, w, d = final.shape
    val = np.full((h, w), big, np.float32)
    arg = np.zeros((h, w), np.int32)
    for dd in range(min(d, w)):
        slab = np.concatenate([final[:, dd:, dd],
                               np.full((h, dd), big, np.float32)], axis=1)
        better = slab < val
        val = np.where(better, slab, val)
        arg = np.where(better, dd, arg)
    return arg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_right_argmin_ties_and_no_candidate(dtype):
    """final(x_r + d, d): x_r = 1 has equal minima at d = 2 and d = 4 (the
    smaller wins); every candidate of x_r = 4 equals BIG in the cost dtype
    (none is below it: 0); the rows' WTA has a tie at d = 3 and 7. With a
    zero raw volume the right-to-left path is 0, so sgm_final sees acc as
    the summed volume."""
    w = 6
    big = float(torch.tensor(1e4, dtype=dtype).float())
    fin = np.full((2, w, D), 500.0, np.float32)
    fin[:, :, 3] = fin[:, :, 7] = 7.0
    fin[0, 3, 2] = fin[0, 5, 4] = 5.0          # x_r = 1 at d = 2 and 4
    for dd in range(w - 4):                    # x_r = 4: candidates d = 0, 1
        fin[1, 4 + dd, dd] = big
    acc = torch.tensor(fin).to(dtype)
    maps = psg.sgm_final_plain(torch.zeros_like(acc), acc, None, 8.0, 96.0,
                               "pallas", unique=False)
    want = _reference_best_r(acc.float().numpy(), big)
    np.testing.assert_array_equal(maps.best_r.numpy(), want)
    assert want[0, 1] == 2 and want[1, 4] == 0
    np.testing.assert_array_equal(maps.best.numpy(),
                                  np.argmin(acc.float().numpy(), axis=-1))
    assert maps.best[0, 0] == 3 and maps.best[0, 3] == 2
