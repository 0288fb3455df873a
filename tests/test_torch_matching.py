"""ops/matching.py port (the temporal half) vs the JAX matching ops on the
features of two rendered street frames at 160x120, with photometric noise
and sensor depth.

The JAX side runs jitted, and both sides get the same features (JAX's,
as numpy). Tolerances, and why:
  * match_temporal, flow_consensus: >= 99% of rows agree. Their cost and
    distance matrices are float32 matmuls that XLA:CPU and torch sum in
    another order, so a near-tie argmin may pick the other neighbour.
  * refine_temporal_subpix: atol 1e-3 px. The ZSSD sums and the bilinear
    weights round differently (XLA contracts FMAs).
  * predict_uv: atol 1e-3 px (FMA contraction in the projection).
  * mutual_nn on integer costs, ties included: exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import tiny_test_config
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.ops import features as jf
from denseslam_tpu.ops import matching as jm
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.ops import matching as pm

W, H = 160, 120


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread each spares the other test processes of a parallel run
    the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_test_config(width=W, height=H, baseline_m=0.537)
    fc = dataclasses.replace(cfg.frontend, max_features=256, bucket_w=25,
                             bucket_h=25)
    cfg = dataclasses.replace(cfg, frontend=fc)
    poses = js.make_trajectory(2, step_m=0.25, yaw_rate=0.003)
    g, d = js.render_trajectory(poses, cfg.rig.intr, js.street_scene())
    rng = np.random.default_rng(11)
    g = np.clip(np.asarray(g) + 2.0 * rng.normal(size=g.shape), 0,
                255).astype(np.float32)
    det = jax.jit(lambda x: jf.bucket(jf.detect(x, fc), W, H, fc))
    feats = [[np.asarray(a) for a in det(jnp.asarray(x))] for x in g]
    d = np.asarray(d)
    ui = np.clip(np.round(feats[0][0][:, 0]).astype(int), 0, W - 1)
    vi = np.clip(np.round(feats[0][0][:, 1]).astype(int), 0, H - 1)
    z = d[0][vi, ui]
    disp = np.where(feats[0][4] & (z > 0.1),
                    cfg.rig.intr.fx * cfg.rig.baseline_m / np.maximum(z, 0.1),
                    -1.0).astype(np.float32)
    T_pred = (np.linalg.inv(poses[1]) @ poses[0]).astype(np.float32)
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    return dict(cfg=cfg, pfc=pcfg.frontend, prig=pcfg.rig, grays=g,
                feats=feats, disp_prev=disp, T_pred=T_pred)


def _jfeats(leaves):
    return jf.Features(*map(jnp.asarray, leaves))


def _pfeats(leaves):
    return convert.features_from_numpy(leaves, device="cpu")


def _agree(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


@pytest.mark.parametrize("prior", [False, True])
def test_match_temporal_agrees(pair, prior):
    cfg, fc = pair["cfg"], pair["cfg"].frontend
    intr = cfg.rig.intr
    fcur, fprev = pair["feats"][1], pair["feats"][0]
    args = (pair["disp_prev"], pair["T_pred"], intr.fx, intr.fy, intr.cx,
            intr.cy, cfg.rig.baseline_m)
    if prior:
        pj = jax.jit(lambda uv, d, T: jm.predict_uv(uv, d, T, *args[2:]))
        pred_j, ok_j = pj(jnp.asarray(fprev[0]), jnp.asarray(args[0]),
                          jnp.asarray(args[1]))
        pred_p, ok_p = pm.predict_uv(torch.tensor(fprev[0]),
                                     torch.tensor(args[0]),
                                     torch.tensor(args[1]), *args[2:])
        np.testing.assert_allclose(np.asarray(pred_j), pred_p.numpy(),
                                   rtol=0, atol=1e-3)
        np.testing.assert_array_equal(np.asarray(ok_j), ok_p.numpy())
        assert ok_p.any()
        want = jax.jit(lambda a, b, p, o: jm.match_temporal(a, b, fc, p, o))(
            _jfeats(fcur), _jfeats(fprev), pred_j, ok_j)
        got = pm.match_temporal(_pfeats(fcur), _pfeats(fprev), pair["pfc"],
                                pred_p, ok_p)
    else:
        want = jax.jit(lambda a, b: jm.match_temporal(a, b, fc))(
            _jfeats(fcur), _jfeats(fprev))
        got = pm.match_temporal(_pfeats(fcur), _pfeats(fprev), pair["pfc"])
    assert (got >= 0).sum() > 50
    assert _agree(want, got.numpy()) >= 0.99


def test_mutual_nn_exact_with_ties():
    """Integer costs, many ties: the first minimum wins on both sides."""
    cost = np.random.default_rng(2).integers(0, 6, (40, 50)).astype(
        np.float32)
    cost[3] = 1e9                                  # a row with no candidate
    np.testing.assert_array_equal(np.asarray(jm.mutual_nn(jnp.asarray(cost))),
                                  pm.mutual_nn(torch.tensor(cost)).numpy())


def _matched(pair):
    fcur, fprev = pair["feats"][1], pair["feats"][0]
    m = np.asarray(jax.jit(lambda a, b: jm.match_temporal(
        a, b, pair["cfg"].frontend))(_jfeats(fcur), _jfeats(fprev)))
    ok = m >= 0
    return fcur[0], fprev[0][np.maximum(m, 0)], ok


@pytest.mark.parametrize("with_disp", [False, True])
def test_flow_consensus_agrees(pair, with_disp):
    fc = pair["cfg"].frontend
    uv_c, uv_p, ok = _matched(pair)
    fu, fv = uv_c[:, 0] - uv_p[:, 0], uv_c[:, 1] - uv_p[:, 1]
    disp = (np.random.default_rng(1).uniform(0, 20, len(ok)).astype(
        np.float32) if with_disp else None)
    kw = dict(k=fc.outlier_knn, tol_flow=fc.outlier_flow_tol_px,
              tol_disp=fc.outlier_disp_tol_px,
              min_support=fc.outlier_min_support)
    want = jax.jit(lambda *a: jm.flow_consensus(*a, **kw))(
        *(None if a is None else jnp.asarray(a)
          for a in (uv_c, fu, fv, disp, ok)))
    got = pm.flow_consensus(*(None if a is None else torch.tensor(a)
                              for a in (uv_c, fu, fv, disp, ok)), **kw)
    assert got.any() and (~got.numpy() & ok).any()
    assert _agree(want, got.numpy()) >= 0.99


@pytest.mark.parametrize("scaled", [False, True])
def test_refine_temporal_subpix_agrees(pair, scaled):
    cfg, fc = pair["cfg"], pair["cfg"].frontend
    uv_c, uv_p, ok = _matched(pair)
    g_prev, g_cur = pair["grays"]
    disp = np.full(len(ok), 3.0, np.float32)
    disp[::5] = -1.0                               # no depth: unscaled rows
    kw = {}
    if scaled:
        kw = dict(disp_prev=disp, T_pred=pair["T_pred"])
    want = jax.jit(lambda a, b, c, d, e, *x: jm.refine_temporal_subpix(
        a, b, c, d, e, fc, *x, rig=cfg.rig if scaled else None))(
            *map(jnp.asarray, (g_prev, g_cur, uv_p, uv_c, ok)),
            *map(jnp.asarray, kw.values()))
    got = pm.refine_temporal_subpix(
        *map(torch.tensor, (g_prev, g_cur, uv_p, uv_c, ok)), pair["pfc"],
        **{k: torch.tensor(v) for k, v in kw.items()},
        rig=pair["prig"] if scaled else None)
    moved = np.abs(got.numpy() - uv_c).max(axis=1) > 1e-3
    assert moved.sum() > 10 and not moved[~ok].any()
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=0,
                               atol=1e-3)
