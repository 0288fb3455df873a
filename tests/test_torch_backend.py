"""The port's backend (ops/ba.py, ops/posegraph.py, models/backend.py)
against the JAX package on the CPU, from the same numpy inputs (the Lie
helpers and the edge Jacobians are in tests/test_torch_backend_lie.py).

Tolerances, and why:
  * `ba.solve` on tests/test_backend_ops.py's problems and
    `posegraph.optimize` on its ring graph: poses within 1e-4 m and
    1e-4 rad (einsum and solve sums in another order).
  * `build_window_problem` on the revisit's window: landmark validity and
    the observation mask exact; observations within 1e-4 px, landmarks
    within 1e-4 m.
  * `Backend` on the 14-keyframe revisit of tests/test_backend_model.py
    (320x240, 512 features, backend caps cut to a 4-keyframe window, 256
    landmarks, 32 graph nodes, 64 edges, 128 retrieval slots), the port
    drawing JAX's verification samples from their keys: the retrieval
    scores within
    one descriptor's share (1/nq; a cosine at the 0.85 threshold can flip
    with the summation order), the detected loop and its edge (1e-4),
    the local BA poses (1e-4 m / 1e-4 rad), the culled keyframes and the
    relaxed graph's poses (1e-4 m / 1e-4 rad) equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import BackendConfig, tiny_test_config
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.models import backend as jbe
from denseslam_tpu.ops import ba as jba
from denseslam_tpu.ops import features as jfeat
from denseslam_tpu.ops import posegraph as jpg
from denseslam_tpu.utils import lie as jl
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import backend as pbe
from denseslam_tpu_torch.ops import ba as pba
from denseslam_tpu_torch.ops import posegraph as ppg
from test_backend_ops import _ring_graph, make_ba_problem


def _t(a):
    return torch.tensor(np.asarray(a))


def _assert_poses(got, want, atol=1e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got[..., :3, 3], want[..., :3, 3], atol=atol,
                               rtol=0)
    Rd = np.swapaxes(want[..., :3, :3], -1, -2) @ got[..., :3, :3]
    skew = (Rd - np.swapaxes(Rd, -1, -2)) / 2
    ang = np.linalg.norm(np.stack([skew[..., 2, 1], skew[..., 0, 2],
                                   skew[..., 1, 0]], -1), axis=-1)
    assert ang.max() <= atol, ang.max()


@functools.lru_cache(maxsize=None)
def _jax_ba_solver(rig, backend):
    return jax.jit(lambda p: jba.solve(p, rig, backend))


def _port_ba_problem(p):
    return pba.BAProblem(*(_t(x) for x in p))


@pytest.mark.parametrize("noisy", [False, True])
def test_ba_solve_matches_jax(noisy):
    cfg = tiny_test_config(width=320, height=240, baseline_m=0.2)
    rng = np.random.default_rng(0)
    problem, _, _ = make_ba_problem(rng, noise_px=0.3 if noisy else 0.0,
                                    rig=cfg.rig)
    if noisy:          # 5% gross outliers, as test_ba_with_noise_and_outliers
        obs = np.array(problem.obs)
        n_out = int(0.05 * np.asarray(problem.obs_mask).sum())
        li = rng.integers(0, obs.shape[0], n_out)
        ki = rng.integers(0, obs.shape[1], n_out)
        obs[li, ki, :2] += rng.normal(0, 30, (n_out, 2))
        problem = problem._replace(obs=jnp.asarray(obs))
    want = _jax_ba_solver(cfg.rig, cfg.backend)(problem)
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    got = pba.solve(_port_ba_problem(problem), pcfg.rig, pcfg.backend)
    _assert_poses(got.T_wc.numpy(), want.T_wc)
    np.testing.assert_allclose(got.points_w.numpy(), np.asarray(want.points_w),
                               atol=1e-4, rtol=0)
    assert int(got.num_obs) == int(want.num_obs)
    np.testing.assert_allclose(float(got.initial_cost),
                               float(want.initial_cost), rtol=1e-5)
    assert float(got.final_cost) < float(got.initial_cost)


def _port_graph(g):
    return ppg.PoseGraph(*(_t(x) for x in g))._replace(
        edge_i=_t(g.edge_i).long(), edge_j=_t(g.edge_j).long())


def test_posegraph_optimize_matches_jax():
    cfg = BackendConfig(max_pg_nodes=16, max_pg_edges=32, pg_iters=25)
    g, _ = _ring_graph(cfg, rng=np.random.default_rng(0))
    want = jax.jit(lambda g: jpg.optimize(g, cfg))(g)
    got = ppg.optimize(_port_graph(g), cfg)
    _assert_poses(got.T_wc.numpy(), want.T_wc)
    np.testing.assert_allclose(float(ppg.total_error(got)),
                               float(jpg.total_error(want)), rtol=1e-3,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# The Backend on a 14-keyframe revisit
# ---------------------------------------------------------------------------

def _revisit_config():
    cfg = tiny_test_config(width=320, height=240, baseline_m=0.25)
    return dataclasses.replace(
        cfg, frontend=dataclasses.replace(cfg.frontend, max_features=512),
        backend=dataclasses.replace(
            cfg.backend, window_keyframes=4, max_landmarks=256,
            max_pg_nodes=32, max_pg_edges=64, retrieval_capacity=128))


def _revisit_poses():
    """A wander-and-return path like tests/test_backend_model.py
    `test_loop_detection_on_revisit` (14 poses, then the start again), its
    return leg on other steps: retracing the outbound steps exactly would
    make keyframes 12 and 14 the same view, and two landmarks at one
    feature tie within rounding in the association."""
    poses = [np.eye(4, dtype=np.float32)]
    for i in range(1, 14):
        xi = ([0.05, 0, 0.1, 0, 0.02, 0] if i < 7
              else [-0.04, 0, -0.12, 0, -0.025, 0])
        poses.append(poses[-1] @ jl.se3_exp_np(np.asarray(xi, np.float32)))
    poses.append(poses[0].copy())
    return np.stack(poses).astype(np.float32)


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
def revisit():
    """Both backends fed the same keyframes (features detected by JAX, at
    poses perturbed by a seeded twist), then, on each: detect_loop,
    local_ba, cull_redundant and optimize_graph, in the order of a chunk
    tick; every step's result is kept."""
    cfg = _revisit_config()
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    poses = _revisit_poses()
    rng = np.random.default_rng(4)
    noisy = poses.copy()
    for i in range(1, len(poses)):
        noisy[i] = poses[i] @ jl.se3_exp_np(np.r_[rng.normal(0, 0.02, 3),
                                                  rng.normal(0, 0.006, 3)])
    detect = jax.jit(lambda g: jfeat.detect(g, cfg.frontend))
    jb = jbe.Backend(cfg)
    pb = pbe.Backend(pcfg, device="cpu")
    for i, T in enumerate(poses):
        left, right, _ = js.render_stereo(jnp.asarray(T), cfg.rig)
        fl, fr = detect(left), detect(right)
        jb.add_keyframe(i, noisy[i], fl, fr)
        pb.add_keyframe(i, noisy[i],
                        convert.features_from_numpy(list(fl), "cpu"),
                        convert.features_from_numpy(list(fr), "cpu"))
    out = {}
    q = jb.keyframes[-1]
    cands = jb.keyframes[:-9]
    out["scores"] = (pb._scores_for(q.signature, pb.keyframes[:-9]),
                     jb._scores_for(q.signature, cands),
                     jbe._retrieval_scores(q.signature,
                                           np.stack([k.signature
                                                     for k in cands])))
    K = cfg.backend.window_keyframes
    fixed = jnp.arange(K) == 0
    w = jb.keyframes[-K:]
    stack = jbe._stack_features
    T = np.stack([k.T_wc for k in w])
    out["problem"] = (
        pbe.build_window_problem(
            pbe._stack_features([k.feats_l for k in pb.keyframes[-K:]]),
            pbe._stack_features([k.feats_r for k in pb.keyframes[-K:]]),
            _t(T), pcfg, fixed=_t(fixed)),
        jb._build(stack([k.feats_l for k in w]), stack([k.feats_r for k in w]),
                  jnp.asarray(T), fixed=fixed))
    # a chunk tick's order: loop, graph, BA, cull
    out["loop"] = (pb.detect_loop(min_gap=8, min_inliers=30),
                   jb.detect_loop(min_gap=8, min_inliers=30))
    out["graph"] = (pb.optimize_graph(), jb.optimize_graph())
    out["ba"] = (pb.local_ba(), jb.local_ba())
    # a low redundancy bar, so that the window's best keyframe (0.34 of
    # its landmarks co-observed) is culled
    out["cull"] = (pb.cull_redundant(min_frac=0.3),
                   jb.cull_redundant(min_frac=0.3))
    out["backends"] = (pb, jb)
    return out


def test_retrieval_scores_match_jax(revisit):
    got, want, host = revisit["scores"]
    q = revisit["backends"][1].keyframes[-1].signature
    nq = max(int((np.linalg.norm(q, axis=1) > 0.5).sum()), 1)
    np.testing.assert_allclose(got, want, atol=1.0 / nq + 1e-6, rtol=0)
    np.testing.assert_allclose(got, host, atol=1.0 / nq + 1e-6, rtol=0)
    assert got.max() >= 0.06


def test_detect_loop_matches_jax(revisit):
    got, want = revisit["loop"]
    pb, jb = revisit["backends"]
    assert want is not None and got == want
    assert len(pb.loop_edges) == len(jb.loop_edges) == 1
    (pi, pj, pT, pw), (ji, jj, jT, jw) = pb.loop_edges[0], jb.loop_edges[0]
    assert (pi, pj, pw) == (ji, jj, jw)
    _assert_poses(pT, jT)
    assert pb.loop_log == jb.loop_log


def test_build_window_problem_matches_jax(revisit):
    got, want = revisit["problem"]
    np.testing.assert_array_equal(got.point_valid.numpy(),
                                  np.asarray(want.point_valid))
    np.testing.assert_array_equal(got.obs_mask.numpy(),
                                  np.asarray(want.obs_mask))
    assert got.obs_mask.sum() > 100
    m = np.asarray(want.obs_mask)
    np.testing.assert_allclose(got.obs.numpy()[m], np.asarray(want.obs)[m],
                               atol=1e-4, rtol=0)
    v = np.asarray(want.point_valid)
    np.testing.assert_allclose(got.points_w.numpy()[v],
                               np.asarray(want.points_w)[v], atol=1e-4, rtol=0)


def test_local_ba_matches_jax(revisit):
    got, want = revisit["ba"]
    pb, jb = revisit["backends"]
    assert want is not None and got is not None
    np.testing.assert_array_equal(got[0], want[0])
    _assert_poses(got[1], want[1])
    assert pb.ba_rejects == jb.ba_rejects == 0


def test_cull_redundant_matches_jax(revisit):
    """The same cull as the JAX package, including the defect the port
    inherits from its `cull_redundant` (denseslam_tpu/models/backend.py
    :439-442): a near candidate sets best_frac to its own, lower, share,
    so a later keyframe co-observed at least as much takes the cull from
    it. Matched, not fixed: equality is the check."""
    got, want = revisit["cull"]
    pb, jb = revisit["backends"]
    if want:           # the window's evidence is dropped after a cull
        assert pb._last_window_mask is jb._last_window_mask is None
    assert got == want and len(want) == 1
    assert pb.cull_margins == jb.cull_margins
    assert [k.frame_id for k in pb.keyframes] == [k.frame_id
                                                  for k in jb.keyframes]
    assert [e[:2] for e in pb.odom_edges] == [e[:2] for e in jb.odom_edges]


def test_optimize_graph_matches_jax(revisit):
    (pids, popt), (jids, jopt) = revisit["graph"]
    np.testing.assert_array_equal(pids, jids)
    _assert_poses(popt, jopt)


def test_backend_state_round_trip(revisit):
    """convert carries the backend's state across: the JAX backend's state
    loaded into a fresh port backend reads back equal, and scores the
    query as the JAX backend does."""
    pb, jb = revisit["backends"]
    state = convert.backend_state_to_numpy(jb)
    fresh = convert.backend_state_from_numpy(
        state, pbe.Backend(pb.cfg, device="cpu"))
    back = convert.backend_state_to_numpy(fresh)
    assert [k["frame_id"] for k in back["keyframes"]] == [
        k["frame_id"] for k in state["keyframes"]]
    for a, b in zip(back["keyframes"], state["keyframes"]):
        np.testing.assert_array_equal(a["T_wc"], b["T_wc"])
        for x, y in zip(a["feats_l"] + a["feats_r"], b["feats_l"] + b["feats_r"]):
            np.testing.assert_array_equal(x, y)
    assert back["sig_slot"] == state["sig_slot"]
    assert back["sig_free"] == state["sig_free"]
    q = jb.keyframes[-1].signature
    np.testing.assert_allclose(fresh._scores_for(q, fresh.keyframes[:-9]),
                               jb._scores_for(q, jb.keyframes[:-9]),
                               atol=0.01)
