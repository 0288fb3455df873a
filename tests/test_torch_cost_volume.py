"""The port's fixed-order arithmetic against jitted JAX, bit for bit: the
cost volume (kernel CV's plain version, ops/stereo.py), its cumulative sum
`scan16` and FMA (`utils/numerics.py` `fma`), `compute_depth` end to end,
and the three VO ops that used to round differently on the card and the
CPU (`describe`'s norm, `_gn_jacobian`'s product, `_zssd`).

The reference is the jitted JAX function: under `jit`, XLA:CPU adds a
cumsum as a base-16 blocked scan, multiplies by the reciprocal area
instead of dividing, contracts `img - box / area` into one FMA, and
reduces short rows and small matmuls as chains of FMAs. Eager JAX rounds
otherwise; tests/test_torch_stereo.py keeps its tolerance against it."""

import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import StereoConfig, tiny_test_config
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.ops import features as jfeat
from denseslam_tpu.ops import matching as jmatch
from denseslam_tpu.ops import ransac as jransac
from denseslam_tpu.ops import stereo as jst
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.ops import features as pfeat
from denseslam_tpu_torch.ops import matching as pmatch
from denseslam_tpu_torch.ops import ransac as pransac
from denseslam_tpu_torch.ops import stereo as pst
from denseslam_tpu_torch.utils import numerics


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("axis", [-1, -2])
def test_scan16_equals_jitted_cumsum(axis):
    """Lengths 1-40 (one block and past it), 255-257 (two levels of block
    totals) and 1226 (the KITTI width), on values that make every carry
    round."""
    cumsum = jax.jit(lambda x: jnp.cumsum(x, axis=axis))
    rng = np.random.default_rng(16)
    for n in [*range(1, 41), 255, 256, 257, 1226]:
        shape = (3, n) if axis == -1 else (n, 3)
        x = rng.uniform(0, 255, shape).astype(np.float32)
        _bits_equal(cumsum(x), pst.scan16(torch.tensor(x), axis).numpy())


def _round_f32(v: Fraction) -> np.float32:
    """The float32 nearest to the exact value v, ties to even."""
    x = np.float32(float(v))
    best = None
    for c in (np.nextafter(x, np.float32(-np.inf)), x,
              np.nextafter(x, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - v)
        if (best is None or d < best[0] or (d == best[0]
                                           and int(c.view(np.int32)) % 2 == 0)):
            best = (d, c)
    return best[1]


def test_fma_is_correctly_rounded():
    """numerics.fma against the exact rational value rounded once: random
    triples, and triples whose float64 sum lands on a float32 midpoint
    (1 + 2^-24 + 2^-60 and its mirrors), where float64 arithmetic alone
    rounds twice to the wrong neighbour."""
    rng = np.random.default_rng(5)
    a = (rng.normal(size=3000) * 2.0 ** rng.integers(-20, 20, 3000))
    b = (rng.normal(size=3000) * 2.0 ** rng.integers(-20, 20, 3000))
    c = (rng.normal(size=3000) * 2.0 ** rng.integers(-40, 40, 3000))
    hard_a, hard_b = 1 + 2.0 ** -12, (1 - 2.0 ** -12 + 2.0 ** -24) * 2.0 ** -24
    for sa, sc, scale in ((1, 1, 1.0), (-1, -1, 1.0), (1, 1, 2.0 ** 30),
                          (-1, -1, 2.0 ** -30)):
        a = np.append(a, sa * hard_a)
        b = np.append(b, hard_b * scale)
        c = np.append(c, sc * scale)
    a, b, c = (x.astype(np.float32) for x in (a, b, c))
    got = numerics.fma(torch.tensor(a), torch.tensor(b), torch.tensor(c))
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    _bits_equal(want, got.numpy())
    twice = (torch.tensor(a).double() * torch.tensor(b).double()
             + torch.tensor(c).double()).float().numpy()
    assert (twice != want).sum() == 4        # the midpoint triples


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_test_config(width=80, height=48, baseline_m=0.25)
    cfg = dataclasses.replace(cfg, stereo=StereoConfig(max_disparity=16))
    left, right, _ = js.render_stereo(jnp.eye(4, dtype=jnp.float32), cfg.rig)
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    return cfg, pcfg, left, right


@pytest.mark.parametrize("cost_dtype", ["float32", "bfloat16"])
def test_cost_volume_equals_jitted_jax(pair, cost_dtype):
    """The test pair, and a 37x301 pair whose lengths are not multiples of
    16, at 32 disparities; the bf16 volume is the f32 one rounded to
    nearest even, as compute_depth casts it."""
    cfg, pcfg, left, right = pair
    tall = tiny_test_config(width=301, height=37, baseline_m=0.25)
    l2, r2, _ = js.render_stereo(jnp.eye(4, dtype=jnp.float32), tall.rig)
    jdt = jnp.bfloat16 if cost_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if cost_dtype == "bfloat16" else torch.float32
    for (lj, rj), sc in (((left, right), cfg.stereo),
                         ((l2, r2), StereoConfig(max_disparity=32))):
        ref = jax.jit(lambda a, b: jst.cost_volume(a, b, sc).astype(jdt))(
            lj, rj)
        psc = dataclasses.replace(pcfg.stereo,
                                  max_disparity=sc.max_disparity)
        got = pst.cost_volume(torch.tensor(np.asarray(lj)),
                              torch.tensor(np.asarray(rj)), psc, tdt)
        assert got.dtype == tdt
        _bits_equal(ref.astype(jnp.float32), got.float().numpy())


@pytest.mark.parametrize("cost_dtype", ["float32", "bfloat16"])
def test_compute_depth_equals_jitted_jax(pair, cost_dtype):
    cfg, pcfg, left, right = pair
    sc = dataclasses.replace(cfg.stereo, cost_dtype=cost_dtype)
    dj, vj = jax.jit(lambda a, b: jst.compute_depth(a, b, cfg.rig, sc))(
        left, right)
    dp, vp = pst.compute_depth(torch.tensor(np.asarray(left)),
                               torch.tensor(np.asarray(right)), pcfg.rig,
                               dataclasses.replace(pcfg.stereo,
                                                   cost_dtype=cost_dtype))
    assert vp.float().mean() > 0.3
    _bits_equal(dj, dp.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vp.numpy())


def test_describe_equals_jitted_jax():
    """The 32-term norm is a chain of FMAs under jit; the descriptors
    equal JAX's on every element."""
    rng = np.random.default_rng(32)
    du = (rng.normal(size=(60, 80)) * 40).astype(np.float32)
    dv = (rng.normal(size=(60, 80)) * 40).astype(np.float32)
    uv = rng.uniform(-2, 82, (500, 2)).astype(np.float32)
    want = jax.jit(jfeat.describe)(du, dv, uv)
    got = pfeat.describe(torch.tensor(du), torch.tensor(dv), torch.tensor(uv))
    _bits_equal(want, got.numpy())


def test_gn_jacobian_equals_jitted_jax():
    """J_p @ dp_dxi: each entry a chain of 3 FMAs under jit."""
    cfg = tiny_test_config(width=160, height=120, baseline_m=0.537)
    prig = convert.config_from_dict(dataclasses.asdict(cfg)).rig
    rng = np.random.default_rng(6)
    p = np.stack([rng.uniform(-10, 10, 4000), rng.uniform(-3, 3, 4000),
                  rng.uniform(0.5, 60, 4000)], -1).astype(np.float32)
    p = p.reshape(8, 500, 3)          # batched as the hypotheses are
    want = jax.jit(lambda q: jransac._gn_jacobian(q, cfg.rig))(p)
    got = pransac._gn_jacobian(torch.tensor(p), prig)
    _bits_equal(want, got.numpy())


def test_zssd_equals_jitted_jax():
    """The patch means (a left-to-right sum times 1/S^2) and the sum of
    squares (a chain of FMAs) at 7x7 patches (`refine_patch` 7), for every
    shift of a leg at once as the port batches them. At the default 9x9
    the port sums the squares in `process_sequence`'s row order, which
    `_zssd` jitted alone does not take; the 160x120 golden holds that one
    (tests/test_torch_golden.py)."""
    rng = np.random.default_rng(9)
    anchor = rng.uniform(0, 255, (300, 7, 7)).astype(np.float32)
    wins = rng.uniform(0, 255, (5, 5, 300, 7, 7)).astype(np.float32)
    zssd = jax.jit(jmatch._zssd)
    want = np.stack([[np.asarray(zssd(anchor, w)) for w in row]
                     for row in wins])
    got = pmatch._zssd(torch.tensor(anchor), torch.tensor(wins))
    _bits_equal(want, got.numpy())
