"""The stereo VO in jitted XLA:CPU's order (denseslam_tpu_torch/ops/ransac.py),
against jitted JAX.

`_reproject_residuals` equals the jitted JAX function bit for bit: under
`jit`, XLA:CPU computes `p @ R.T` as a chain of 3 FMAs from 0, adds t
apart, and contracts each `q * f + c` of the projection into one FMA.

`_gn_refine` equals it bit for bit too: its normal equations in XLA:CPU's
lanes and panels (kernel GN's plain version, `numerics.gn_normal`), the
damping one FMA, the solve with XLA's FMAs and simplified last unknown,
and the update with glibc's sin and cos and two FMAs a Rodrigues sum
(tests/test_torch_gn_normal.py holds each step alone). The JAX programs
take every input as an argument, as `process_sequence` does: XLA folds
constants with its evaluator, which rounds otherwise.

The fixed orders are elementwise, so they give the same bits whatever
the layout of the data, as they do on the card and the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import tiny_test_config
from denseslam_tpu.ops import ransac as jransac
from denseslam_tpu.utils import lie as jlie
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.ops import ransac as pransac

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """Points in front of the camera, seen after a known motion with 0.5 px
    of noise and 10% outliers; the rig of the tiny config."""
    cfg = tiny_test_config(width=160, height=120, baseline_m=0.537)
    prig = convert.config_from_dict(dataclasses.asdict(cfg)).rig
    rig, intr = cfg.rig, cfg.rig.intr
    rng = np.random.default_rng(14)
    n = 512
    T = np.asarray(jlie.se3_exp(jnp.array([0.05, -0.02, 0.4, 0.01, -0.02,
                                           0.005], jnp.float32)))
    pts = np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n),
                    rng.uniform(2, 40, n)], -1).astype(np.float32)
    pc = pts @ T[:3, :3].T + T[:3, 3]
    v = pc[:, 1] / pc[:, 2] * intr.fy + intr.cy
    obs_l = np.stack([pc[:, 0] / pc[:, 2] * intr.fx + intr.cx, v], -1)
    obs_r = np.stack([(pc[:, 0] - rig.baseline_m) / pc[:, 2] * intr.fx
                      + intr.cx, v], -1)
    obs_l = (obs_l + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    obs_r = (obs_r + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    obs_l[:n // 10] += rng.normal(0, 30, (n // 10, 2)).astype(np.float32)
    sel = rng.integers(0, n, (64, 3))
    return dict(cfg=cfg, rig=rig, prig=prig, pts=pts, obs_l=obs_l,
                obs_r=obs_r, sel=sel, rng=rng)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_reproject_residuals_equals_jitted_jax(scene):
    """One pose over all points (the refit), K poses over all points (the
    vote's count, vmapped) and K poses over 3 points each (the hypotheses'
    Gauss-Newton, vmapped): residuals and points bit for bit."""
    s, rig, prig = scene, scene["rig"], scene["prig"]
    rng = s["rng"]
    Ts = np.stack([np.asarray(jlie.se3_exp(jnp.asarray(
        rng.normal(size=6).astype(np.float32) * 0.2))) for _ in range(32)])
    pts, ol, orr = s["pts"], s["obs_l"], s["obs_r"]
    sel = s["sel"][:32]

    def one(T, p, a, b):
        return jransac._reproject_residuals(T, p, a, b, rig)

    cases = (
        (jax.jit(one), (Ts[0], pts, ol, orr)),
        (jax.jit(jax.vmap(one, in_axes=(0, None, None, None))),
         (Ts, pts, ol, orr)),
        (jax.jit(jax.vmap(one)), (Ts, pts[sel], ol[sel], orr[sel])),
    )
    for fn, args in cases:
        want = fn(*args)
        got = pransac._reproject_residuals(*map(torch.tensor, args), prig)
        for w, g in zip(want, got):
            _bits_equal(w, g.numpy())


@pytest.mark.parametrize("batch", ["hypotheses", "refit"])
def test_gn_refine_within_conditioning_of_jitted_jax(scene, batch):
    """The hypotheses: 64 three-point solves from the identity, vmapped as
    estimate_stereo_motion's `solve_one`, gn_iters steps. The refit: all
    points with the inliers' edge weights, refine_iters steps from a
    hypothesis. Each solution bit for bit jitted JAX's."""
    s, rig, prig = scene, scene["rig"], scene["prig"]
    fc = s["cfg"].frontend
    pts, ol, orr, sel = s["pts"], s["obs_l"], s["obs_r"], s["sel"]
    eye = np.eye(4, dtype=np.float32)
    if batch == "hypotheses":
        want = np.asarray(jax.jit(jax.vmap(
            lambda T, p, a, b: jransac._gn_refine(
                T, p, a, b, jnp.ones(3, jnp.float32), rig, fc.gn_iters),
            in_axes=(None, 0, 0, 0)))(eye, pts[sel], ol[sel], orr[sel]))
        got = pransac._gn_refine(
            torch.tensor(eye).expand(len(sel), 4, 4), torch.tensor(pts[sel]),
            torch.tensor(ol[sel]), torch.tensor(orr[sel]),
            torch.ones(len(sel), 3), prig, fc.gn_iters).numpy()
    else:
        w = np.ones(len(pts), np.float32)
        w[:len(pts) // 10] = 0.0
        cx = rig.intr.cx
        w = (w / (np.abs(ol[:, 0] - cx) / abs(cx) + 0.05)).astype(np.float32)
        T0 = np.asarray(jlie.se3_exp(jnp.array([0.04, -0.01, 0.35, 0.0, 0.0,
                                                0.0], jnp.float32)))
        want = np.asarray(jax.jit(lambda *a: jransac._gn_refine(
            *a, rig, fc.refine_iters))(T0, pts, ol, orr, w))[None]
        got = pransac._gn_refine(
            torch.tensor(T0), torch.tensor(pts), torch.tensor(ol),
            torch.tensor(orr), torch.tensor(w), prig,
            fc.refine_iters).numpy()[None]
    assert np.all(np.isfinite(got))
    _bits_equal(want, got)


def test_fixed_orders_same_bits_on_two_layouts(scene):
    """The residuals and both Gauss-Newton batches from contiguous inputs
    and from transposed copies of the same values: equal bit for bit."""
    s, prig, fc = scene, scene["prig"], scene["cfg"].frontend
    sel = s["sel"]
    w = torch.rand(len(s["pts"]), generator=torch.Generator().manual_seed(2))

    def transposed(x):
        return x.transpose(-1, -2).contiguous().transpose(-1, -2)

    def run(lay):
        pts, ol, orr = (lay(torch.tensor(s[k]))
                        for k in ("pts", "obs_l", "obs_r"))
        eye = lay(torch.eye(4)).expand(len(sel), 4, 4)
        T_hyp = pransac._gn_refine(eye, pts[sel], ol[sel], orr[sel],
                                   torch.ones(len(sel), 3), prig,
                                   fc.gn_iters)
        r, p = pransac._reproject_residuals(T_hyp, pts, ol, orr, prig)
        T_ref = pransac._gn_refine(lay(T_hyp[0].clone()), pts, ol, orr,
                                   lay(w[:, None])[:, 0], prig,
                                   fc.refine_iters)
        return T_hyp, r, p, T_ref

    for a, b in zip(run(lambda x: x), run(transposed)):
        assert not torch.isnan(a).any()
        _bits_equal(a.numpy(), b.numpy())


def test_fma_chain_redoes_inexact_midpoints():
    """`numerics.fma_chain` (kernel GN's plain version) equals a chain of
    exact FMAs where its float64 sums land on float32 midpoints without
    being exact: terms 2^-24 (1 - 2^-30), a float32 product, onto 1 + 2^-23
    round to 1 + 2^-23 once, but to 1 + 2^-22 through a float64 sum.
    Mostly zero terms in between, so many steps of one chain are redone."""
    from denseslam_tpu_torch.utils import numerics

    rng = np.random.default_rng(5)
    steps, cols = 300, 7
    hit = rng.random((steps, cols)) < 0.05
    x = np.where(hit, 2.0 ** -24 * (1 + 2.0 ** -15), 0.0)
    x = (x * rng.choice([-1.0, 1.0], (steps, cols))).astype(np.float32)
    y = np.where(hit, 1 - 2.0 ** -15, 0.0).astype(np.float32)
    terms = torch.tensor(x).double() * torch.tensor(y).double()
    init = torch.full((cols,), 1 + 2.0 ** -23)
    acc, twice = init, init
    for k in range(steps):                   # one exact FMA a step
        acc = numerics.fma(torch.tensor(x[k]), torch.tensor(y[k]), acc)
        twice = (terms[k] + twice.double()).float()
    got = numerics.fma_chain(terms, init)
    assert not torch.equal(twice, acc)       # the float64 sums part
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  acc.numpy().view(np.int32))
