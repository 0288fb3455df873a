"""The monocular sensor mode of the port vs the JAX package, at 160x120:
`mono_vo_step` frame by frame, `process_sequence_mono` over 6 frames and
the inherited `refine_cap` (the functions of ops/mono.py and the mono
`DenseSLAM.process_frame` are in tests/test_torch_mono_ops.py).

Frames: the synthetic street under the mono drive's sensor model of
scripts/long_drive_eval.py (photometric noise 2.0, a gain ramp, 1%
relative depth noise, 5% holes), drawn with numpy. The JAX side draws
each frame's 8-point hypotheses from its key; the port is handed the same
draws. Tolerances, and why:
  * per frame and over the sequence: poses within 1e-4 m (translation)
    and 1e-5 (rotation entries), tracking, keyframe decisions and inlier
    counts equal, features exact (virtual right uv within 1e-4 px): the
    float32 matmuls and reductions of matching sum in another order than
    XLA:CPU, and LAPACK's SVDs differ in the last bits. Held on the
    frames where both estimators pick the same non-degenerate hypothesis
    (`_frame_held`), and over the sequence until the first frame where
    they do not.
  * the map: bit for bit JAX's fusion (jitted `integrate`, the program
    whose order the port copies) of the frames the port fused at the
    poses it estimated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import (SlideWindowParams, VoxelDecayParams,
                                  tiny_test_config)
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.models import dense_slam as jd
from denseslam_tpu.models import frontend as jfe
from denseslam_tpu.ops import features as jf
from denseslam_tpu.ops import mono as jm
from denseslam_tpu.ops import tsdf as jt
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.models import frontend as pfe
from denseslam_tpu_torch.ops import mono as pm
from denseslam_tpu_torch.ops import tsdf as pt

N = 6
K = 32
MAP_LEAVES = ["keys", "tsdf", "weight", "color", "alloc_frame", "last_seen",
              "frame", "decayed_blocks", "overflow"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are small: one thread each spares the other
    test processes of a parallel run the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**frontend):
    cfg = tiny_test_config(width=160, height=120, baseline_m=0.537)
    fc = dict(max_features=512, ransac_iters=K, bucket_w=16, bucket_h=16,
              ransac_thresh_px=0.5)
    return dataclasses.replace(
        cfg,
        frontend=dataclasses.replace(cfg.frontend, **{**fc, **frontend}),
        tsdf=dataclasses.replace(cfg.tsdf, sampler="gather",
                                 alloc_subsample=2),
        decay=VoxelDecayParams(enabled=True, min_decay_age=1,
                               max_decay_weight=2),
        slide_window=SlideWindowParams(enabled=True, max_age=2),
        pipeline=dataclasses.replace(cfg.pipeline, fusion_db_capacity=4,
                                     keyframe_every=2, sensor="mono"))


def _port_config(cfg):
    return convert.config_from_dict(dataclasses.asdict(cfg))


def _frames(cfg, rng, n=N):
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
    return poses, g, d


def _draws(key):
    """The (K, 8) draws the JAX frontend makes from state key `key`."""
    return np.asarray(jax.random.randint(
        jax.random.split(key)[1], (K, 8), 0, jnp.iinfo(jnp.int32).max))


def _assert_pose_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[..., :3, 3], want[..., :3, 3], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[..., :3, :3], want[..., :3, :3], rtol=0,
                               atol=1e-5)


def _leaves(st):
    return [np.asarray(x) for x in jax.tree.leaves(st)]


# -- the drive: JAX's process_sequence_mono frame by frame ---------------------

@pytest.fixture(scope="module")
def ref():
    """The JAX drive: process_sequence_mono jitted once for a 1-frame chunk
    and called frame by frame, so the frontend state after every frame is
    at hand; the draws are the ones its key gives each frame."""
    cfg = _config()
    poses, grays, depths = _frames(cfg, np.random.default_rng(0))
    fids = np.arange(N, dtype=np.int32)
    seq = jax.jit(lambda st, m, db, g, d, f: jd.process_sequence_mono(
        st, m, db, g, d, f, cfg))
    st, m, db = jax.tree.map(lambda x: x.astype(x.dtype), (
        jfe.init_frontend(cfg, seed=0), jt.make_map(cfg.tsdf),
        jd.make_fusion_db(cfg)))
    states, stats, draws = [st], [], []
    for i in range(N):
        draws.append(_draws(st.key))
        st, m, db, s = seq(st, m, db, *(jnp.asarray(a[i:i + 1])
                                        for a in (grays, depths, fids)))
        states.append(st)
        stats.append(jax.tree.map(lambda x: np.asarray(x)[0], s))
    return dict(cfg=cfg, pcfg=_port_config(cfg), poses=poses, grays=grays,
                depths=depths, fids=fids, draws=np.stack(draws),
                states=states,
                stats=jax.tree.map(lambda *x: np.stack(x), *stats))


def _winner(cfg, draws, uv_prev, uv_curr, valid, port):
    """The hypothesis the estimator picks from this flow and whether it is
    degenerate (a repeated draw: its 8x9 system's smallest singular value
    s8 < 1e-6, so its nullspace is 2-D and E is whichever vector of it the
    SVD returns), recomputed on the flow with the package's own functions
    (JAX op by op, or the port)."""
    fc, intr = cfg.frontend, cfg.rig.intr
    sel = np.argsort(~valid, kind="stable")[draws % max(int(valid.sum()), 8)]
    thresh = (fc.ransac_thresh_px / intr.fx) ** 2
    if port:
        t = [torch.tensor(a) for a in (uv_prev, uv_curr)]
        xp, yp = pm._normalize(t[0], intr)
        xc, yc = pm._normalize(t[1], intr)
        s = torch.tensor(sel)
        d = pm._sampson(pm._eight_point(xp[s], yp[s], xc[s], yc[s]),
                        xp, yp, xc, yc).numpy()
    else:
        xp, yp = jm._normalize(jnp.asarray(uv_prev), intr)
        xc, yc = jm._normalize(jnp.asarray(uv_curr), intr)
        E = jax.vmap(jm._eight_point)(xp[sel], yp[sel], xc[sel], yc[sel])
        d = np.asarray(jax.vmap(lambda e: jm._sampson(e, xp, yp, xc, yc))(E))
    counts = ((d < thresh) & valid).sum(-1)
    w = int(np.argmax(counts))
    a = np.stack([np.asarray(v)[sel[w]].astype(np.float64)
                  for v in (xp, yp, xc, yc)], -1)
    a = np.stack([a[:, 2] * a[:, 0], a[:, 2] * a[:, 1], a[:, 2],
                  a[:, 3] * a[:, 0], a[:, 3] * a[:, 1], a[:, 3], a[:, 0],
                  a[:, 1], np.ones(8)], -1)
    return w, counts, np.linalg.svd(a, compute_uv=False)[7] < 1e-6


def _frame_held(cfg, draws, flow):
    """Whether both packages' estimators pick the same, non-degenerate
    hypothesis from this flow; where they do not, the divergence must be
    one of the two the reference itself shows between its jitted and
    op-by-op runs (ROADMAP.md Queue C): a degenerate winner, or a winner
    whose lead is one borderline inlier."""
    wj, cj, dj = _winner(cfg, draws, *flow, port=False)
    wp, cp, dp = _winner(cfg, draws, *flow, port=True)
    if wj == wp and not dj:
        return True
    assert dj or dp or abs(int(cj[wj]) - int(cj[wp])) <= 1, (wj, wp)
    return False


def test_mono_vo_step_per_frame_with_jax_draws(ref):
    """Each frame starts from the JAX state, carried across by
    io/convert.py: the features equal JAX's; where both packages'
    estimators pick the same non-degenerate hypothesis from the step's
    flow (all but at most 2 of the 6 frames), the motion, the inlier
    count and the next state's pose do too (the flow itself is held to
    JAX's in `test_refine_cap_applies_to_mono_before_consensus_inherited`)."""
    pcfg, want = ref["pcfg"], ref["stats"]
    held = 0
    for i in range(N):
        st = convert.frontend_state_from_numpy(_leaves(ref["states"][i]),
                                               device="cpu")
        new, out = pfe.mono_vo_step(st, torch.tensor(ref["grays"][i]), pcfg,
                                    raw=torch.tensor(ref["draws"][i]))
        nxt = ref["states"][i + 1]
        for a, b in zip(nxt.feats_l, new.feats_l):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-6)
        flow = [x.numpy() for x in (out.flow_uv_prev, out.flow_uv_curr,
                                    out.flow_valid)]
        # mono keeps the right-view state as it was
        assert torch.equal(new.disp_l, st.disp_l)
        if i > 0 and not _frame_held(ref["cfg"], ref["draws"][i], flow):
            continue
        held += 1
        _assert_pose_close(out.T_wc, want["T_wc"][i])
        _assert_pose_close(new.T_delta_prev, nxt.T_delta_prev)
        assert int(out.num_inliers) == int(want["num_inliers"][i])
        assert bool(out.tracking_ok) == bool(want["tracking_ok"][i])
        assert bool(new.prior_ok) == bool(nxt.prior_ok)
    assert held >= N - 2


@pytest.fixture(scope="module")
def port_run(ref):
    pcfg = ref["pcfg"]
    st = pfe.init_frontend(pcfg, device="cpu")
    m = pt.make_map(pcfg.tsdf, device="cpu")
    db = pd.make_fusion_db(pcfg, device="cpu")
    return pd.process_sequence_mono(
        st, m, db, torch.tensor(ref["grays"]), torch.tensor(ref["depths"]),
        torch.tensor(ref["fids"]), pcfg, draws=torch.tensor(ref["draws"]))


def _held_prefix(ref, stats):
    """The number of leading frames of the port's sequence whose poses are
    within 1e-4 of JAX's, at least 3: a frame whose estimators diverge
    (as `test_mono_vo_step_per_frame_with_jax_draws` explains each one)
    moves every later pose."""
    got, want = stats["T_wc"].numpy(), ref["stats"]["T_wc"]
    close = [np.allclose(got[i], want[i], rtol=0, atol=1e-4)
             for i in range(N)] + [False]
    n = close.index(False)
    assert n >= 3
    return n


def test_process_sequence_mono_matches_jax(ref, port_run):
    """The sequence against JAX's: stats, features, virtual right features
    and retrieval sketches of every frame while the trajectories agree
    (`_held_prefix`: frames 0-2 of this drive; frame 3's winners part, as
    the per-frame test explains). The map is held by
    `test_process_sequence_mono_fusion_is_exact`."""
    stats = port_run[3]
    want = ref["stats"]
    assert set(stats) == set(want)
    n = _held_prefix(ref, stats)
    _assert_pose_close(stats["T_wc"][:n], want["T_wc"][:n])
    for name in ("tracking_ok", "num_inliers", "fused"):
        np.testing.assert_array_equal(stats[name][:n].numpy(),
                                      want[name][:n], name)
    assert stats["fused"].sum() >= 2 and stats["tracking_ok"].all()
    for key in ("feats_l", "feats_r"):
        for name, a, b in zip(("uv", "cls", "desc", "score", "valid"),
                              want[key], stats[key]):
            tol = 1e-4 if (key, name) == ("feats_r", "uv") else 1e-6
            np.testing.assert_allclose(b[:n].numpy(), a[:n], rtol=0,
                                       atol=tol, err_msg=f"{key}.{name}")
    np.testing.assert_allclose(stats["sig"][:n].numpy(), want["sig"][:n],
                               atol=1e-6)


def test_process_sequence_mono_fusion_is_exact(ref, port_run):
    """The port's map equals the JAX fusion of the frames it fused, at the
    poses it estimated, bit for bit (fuse_keyframe's steps, each jitted on
    its own, as tests/test_torch_rgbd.py does); its virtual right
    features equal JAX's disparity formula on its features and the
    supplied depth."""
    _, m, _, stats = port_run
    cfg = ref["cfg"]
    intr, tc = cfg.rig.intr, cfg.tsdf
    alloc = jax.jit(lambda m, d, T: jt.allocate_for_frame(m, d, T, intr, tc))
    integ = jax.jit(lambda m, s, k, d, c, T: jt.integrate(
        m, s, k, d, c, T, intr, tc))
    tail = jax.jit(lambda m: jt.advance_frame(jt.decay_and_slide(
        m, cfg.decay.max_decay_weight, cfg.decay.min_decay_age,
        cfg.slide_window.max_age)))
    mj, db = jt.make_map(tc), jd.make_fusion_db(cfg)
    for i in np.flatnonzero(stats["fused"].numpy()):
        d = jd.db_quantize_depth(db, jnp.asarray(ref["depths"][i]))
        T = jnp.asarray(stats["T_wc"][i].numpy())
        col = jt.pack_gray(jnp.asarray(ref["grays"][i]))
        mj, s, k = alloc(mj, d, T)
        mj = tail(integ(mj, s, k, d, col, T))
    for name, a, b in zip(MAP_LEAVES, jax.tree.leaves(mj),
                          convert.map_state_to_numpy(m)):
        np.testing.assert_array_equal(np.asarray(a), b, name)
    for i in range(N):
        fl = jf.Features(*(jnp.asarray(x[i].numpy())
                           for x in stats["feats_l"]))
        uv, valid = fl.uv, fl.valid
        ui = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0,
                      intr.width - 1)
        vi = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0,
                      intr.height - 1)
        z = jnp.asarray(ref["depths"][i]).reshape(-1)[vi * intr.width + ui]
        disp = jnp.where(valid & (z > 0.1), intr.fx * cfg.rig.baseline_m
                         / jnp.maximum(z, 0.1), -1.0)
        f = jd._virtual_right_features(fl, disp)
        np.testing.assert_array_equal(stats["feats_r"].uv[i].numpy(),
                                      np.asarray(f.uv))
        np.testing.assert_array_equal(stats["feats_r"].valid[i].numpy(),
                                      np.asarray(f.valid))


def test_mono_tracks_the_street_with_ground_scale(ref, port_run):
    """The metric scale comes from the ground plane: the final position is
    within 25% of the distance travelled (tests/test_mono.py's bound)."""
    T = port_run[3]["T_wc"][-1].numpy()
    gt = ref["poses"][-1]
    travelled = np.linalg.norm(gt[:3, 3])
    assert np.linalg.norm(T[:3, 3] - gt[:3, 3]) < 0.25 * travelled


@pytest.fixture(scope="module")
def cap_step():
    """mono_vo_step jitted at refine_cap=8 without flow consensus, over
    two street frames from a fresh state: the states, JAX's step output
    on frame 1 and that frame's draws."""
    cfg = _config(refine_cap=8, outlier_removal=False)
    _, grays, depths = _frames(cfg, np.random.default_rng(1), n=2)
    step = jax.jit(lambda s, g: jfe.mono_vo_step(s, g, cfg))

    def strong(tree):       # both calls hit the one compile
        return jax.tree.map(lambda x: x.astype(x.dtype), tree)

    st0 = strong(jfe.init_frontend(cfg, seed=0))
    st, _ = step(st0, jnp.asarray(grays[0]))
    st = strong(st)
    draws = _draws(st.key)
    _, want = step(st, jnp.asarray(grays[1]))
    return dict(cfg=cfg, pcfg=_port_config(cfg), grays=grays, depths=depths,
                st1=st, draws0=_draws(st0.key), draws=draws, want=want)


def test_refine_cap_applies_to_mono_before_consensus_inherited(cap_step):
    """Inherited from the JAX package (denseslam_tpu/config.py refine_cap,
    ROADMAP.md Queue C): mono_vo_step refines the temporal leg before flow
    consensus, over the first refine_cap valid matches only; with a cap of
    8 the matches past it keep their detector positions, on both
    packages."""
    c = cap_step
    pst = convert.frontend_state_from_numpy(_leaves(c["st1"]), device="cpu")
    new, got = pfe.mono_vo_step(pst, torch.tensor(c["grays"][1]), c["pcfg"],
                                raw=torch.tensor(c["draws"]))
    want = c["want"]
    np.testing.assert_array_equal(got.flow_valid.numpy(),
                                  np.asarray(want.flow_valid))
    np.testing.assert_allclose(got.flow_uv_curr.numpy(),
                               np.asarray(want.flow_uv_curr), rtol=0,
                               atol=1e-4)
    valid = got.flow_valid.numpy()
    rows = np.flatnonzero(valid)
    assert rows.size > 16
    moved = (got.flow_uv_curr.numpy() != new.feats_l.uv.numpy()).any(-1)
    assert moved[rows[:8]].any()
    assert not moved[rows[8:]].any()


def test_dense_slam_last_flow_matches_jax_mono(cap_step):
    """DenseSLAM.last_flow (the viewer's scene-flow pane): None on a fresh
    system; after frame 1 of the mono path the JAX step's (flow_uv_prev,
    flow_uv_curr, flow_valid), flags equal, positions within the 1e-4 px
    of the test above."""
    c = cap_step
    slam = pd.DenseSLAM(c["pcfg"], device="cpu", seed=0)
    assert slam.last_flow is None
    for i, d in enumerate((c["draws0"], c["draws"])):
        slam.process_frame(torch.tensor(c["grays"][i]),
                           depth=torch.tensor(c["depths"][i]),
                           draws=torch.tensor(d))
    want = c["want"]
    got = slam.last_flow
    assert len(got) == 3 and int(got[2].sum()) > 16
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want.flow_valid))
    for g, w in zip(got[:2], (want.flow_uv_prev, want.flow_uv_curr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)


