"""The ORB feature stack of the port (ops/orb.py, `features.detect` with
feature_type="orb") vs the JAX package at 160x120: every function of
ops/orb.py, the common-struct adapter, one stereo `vo_step` pair on ORB
features with JAX's draws (as tests/test_orb_backend.py drives it), and
the backend's retrieval signature of an ORB keyframe.

Frames: the synthetic street as a stereo pair under the stereo drive's
nuisance (gain ramp, photometric noise 2.0), drawn with numpy. The JAX
functions run op by op.
Tolerances, and why:
  * the FAST response, NMS survivors, keypoint positions, scores, validity
    and every descriptor word exact (the 2x box pyramid sums its four
    pixels in XLA's order, utils/image.py `downsample2`); the descriptor
    bits that agree: 100% on these frames, >= 99.9% required, since the
    steered sample offsets round cos / sin of an angle that may differ;
  * the orientation within 1e-6 rad: torch's `atan2` and XLA's differ by
    an ulp;
  * Hamming distances and mutual matches exact;
  * the unpacked +-1/16 descriptors exact;
  * the vo_step pair: poses within 1e-4 m (translation) and 1e-5
    (rotation entries), the inlier count equal, as for the gradient
    features (tests/test_torch_vo.py);
  * the signature within 1e-6 (its row norms are float32 sums).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import tiny_test_config
from denseslam_tpu.io import synthetic as js
from denseslam_tpu.models import backend as jbe
from denseslam_tpu.models import frontend as jfe
from denseslam_tpu.ops import features as jf
from denseslam_tpu.ops import orb as jo
from denseslam_tpu.utils import lie as jl
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import backend as pbe
from denseslam_tpu_torch.models import frontend as pfe
from denseslam_tpu_torch.ops import features as pf
from denseslam_tpu_torch.ops import orb as po

W, H = 160, 120
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
    cfg = tiny_test_config(width=W, height=H, baseline_m=0.537)
    return dataclasses.replace(cfg, frontend=dataclasses.replace(
        cfg.frontend, feature_type="orb", max_features=256, ransac_iters=K,
        bucket_w=25, bucket_h=25))


@pytest.fixture(scope="module")
def frames():
    """Two street frames as stereo pairs (left, right), with the stereo
    drive's gain ramp and photometric noise."""
    cfg = _config()
    poses = js.make_trajectory(2, step_m=0.25, yaw_rate=0.003)
    lefts, rights, _ = js.render_stereo_trajectory(poses, cfg.rig,
                                                   js.street_scene())
    rng = np.random.default_rng(0)
    gain = 1.0 + 0.15 * np.sin(2 * np.pi * np.arange(2) / 150.0)

    def nuisance(g):
        g = np.asarray(g) * gain[:, None, None]
        return np.clip(g + 2.0 * rng.normal(size=g.shape), 0,
                       255).astype(np.float32)

    return cfg, nuisance(lefts), nuisance(rights)


def _bits(words):
    """(N, 8) descriptor words -> (N, 256) bits."""
    w = np.asarray(words).astype(np.uint32)
    return (w[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1


def _assert_orb_equal(want, got):
    for name in ("uv", "score", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_allclose(got.angle.numpy(), np.asarray(want.angle),
                               rtol=0, atol=1e-6)
    assert got.desc.dtype == torch.int64
    share = (_bits(want.desc) == _bits(got.desc.numpy())).mean()
    assert share >= 0.999, share
    np.testing.assert_array_equal(got.desc.numpy(),
                                  np.asarray(want.desc).astype(np.int64))


def test_fast_score_matches_jax(frames):
    _, lefts, _ = frames
    want = np.asarray(jo.fast_score(jnp.asarray(lefts[0])))
    got = po.fast_score(torch.tensor(lefts[0])).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 500


def test_orientation_and_describe_match_jax(frames):
    """On the same keypoints: the angle within 1e-6 rad; steered BRIEF
    given the same angles exact."""
    _, lefts, _ = frames
    rng = np.random.default_rng(2)
    uv = np.stack([rng.uniform(20, W - 20, 64), rng.uniform(20, H - 20, 64)],
                  -1).astype(np.float32)
    g, u = jnp.asarray(lefts[0]), jnp.asarray(uv)
    ang = np.asarray(jo.orientation(g, u))
    got = po.orientation(torch.tensor(lefts[0]), torch.tensor(uv)).numpy()
    np.testing.assert_allclose(got, ang, rtol=0, atol=1e-6)
    want = np.asarray(jo.describe(g, u, jnp.asarray(ang)))
    got = po.describe(torch.tensor(lefts[0]), torch.tensor(uv),
                      torch.tensor(ang)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.fixture(scope="module")
def pyramids(frames):
    """detect_pyramid (300 features; its levels run `detect`) of the left
    and the right image of frame 0 in both packages."""
    _, lefts, rights = frames
    imgs = (lefts[0], rights[0])
    return ([jo.detect_pyramid(jnp.asarray(x), 300) for x in imgs],
            [po.detect_pyramid(torch.tensor(x), 300) for x in imgs])


@pytest.mark.parametrize("image", ["left", "right"])
def test_detect_pyramid_matches_jax(pyramids, image):
    i = ["left", "right"].index(image)
    _assert_orb_equal(pyramids[0][i], pyramids[1][i])
    assert int(pyramids[1][i].valid.sum()) > 50


def test_hamming_and_match_match_jax(pyramids):
    """Left against right of frame 0, and left against itself."""
    fj, fp = pyramids
    for b in (0, 1):
        want = np.asarray(jo.hamming_matrix(fj[0].desc, fj[b].desc))
        got = po.hamming_matrix(fp[0].desc, fp[b].desc)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(jo.match(fj[0], fj[b]))
        got = po.match(fp[0], fp[b]).numpy()
        np.testing.assert_array_equal(got, want)
    assert (po.match(fp[0], fp[1]) >= 0).sum() >= 1
    # the embedding: exact, unit norm, squared distance = Hamming / 64
    c = po.to_common(fp[0])
    np.testing.assert_array_equal(c.desc.numpy(),
                                  np.asarray(jo.to_common(fj[0]).desc))
    v = c.valid
    d2 = ((c.desc[v][:, None] - c.desc[v][None]) ** 2).sum(-1)
    ham = po.hamming_matrix(fp[0].desc[v], fp[0].desc[v]).to(torch.float32)
    assert torch.equal(d2, ham / 64.0)


def test_features_detect_orb_matches_jax(frames):
    """features.detect with feature_type="orb": the pyramid in the common
    struct, padded with invalid rows to max_features."""
    cfg, lefts, _ = frames
    fc = cfg.frontend
    pfc = convert.config_from_dict(dataclasses.asdict(cfg)).frontend
    want = jf.detect(jnp.asarray(lefts[0]), fc)
    got = pf.detect(torch.tensor(lefts[0]), pfc)
    assert got.desc.shape == (fc.max_features, pf.desc_dim(pfc)) == (256, 256)
    for name, a, b in zip(jf.Features._fields, want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
    assert not got.valid[fc.max_features // 3 * 3:].any()
    norms = got.desc[got.valid].norm(dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-6)


def test_orb_vo_step_pair_matches_jax():
    """tests/test_orb_backend.py `test_orb_vo_tracks_small_motion` on both
    packages at 160x120 (256 features, 32 hypotheses): two stereo frames of
    the default scene, the second 0.09 m on; the port is given JAX's state
    after frame 0 and JAX's draws. JAX's vo_step runs jitted on the ORB
    features the port detects (their parity with JAX's detection, op by
    op, is held above; ORB detection under jit compiles for a minute): its
    `features.detect` hands them in, in the order vo_step asks for them."""
    cfg = dataclasses.replace(
        tiny_test_config(width=W, height=H, baseline_m=0.25),
        frontend=_config().frontend)
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    T1 = jl.se3_exp(jnp.asarray([0.04, 0.0, 0.08, 0.0, 0.01, 0.0],
                                jnp.float32))
    imgs = [js.render_stereo(T, cfg.rig)[:2] for T in (jnp.eye(4), T1)]

    def step(st, left, right, f_left, f_right):
        given = [f_left, f_right]
        detect = jf.detect
        jf.detect = lambda img, fc: given.pop(0)
        try:
            return jfe.vo_step(st, left, right, cfg)
        finally:
            jf.detect = detect

    step = jax.jit(step)
    feats = [[jf.Features(*(jnp.asarray(a.numpy()) for a in pf.detect(
        torch.tensor(np.asarray(x)), pcfg.frontend))) for x in pair]
        for pair in imgs]
    # strong types, so that both frames hit the one compile
    def strong(tree):
        return jax.tree.map(lambda x: x.astype(x.dtype), tree)

    st, _ = step(strong(jfe.init_frontend(cfg)), *imgs[0], *feats[0])
    st = strong(st)
    draws = np.asarray(jax.random.randint(
        jax.random.split(st.key)[1], (K, 3), 0, jnp.iinfo(jnp.int32).max))
    nxt, want = step(st, *imgs[1], *feats[1])
    pst = convert.frontend_state_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(st)], device="cpu")
    new, got = pfe.vo_step(pst, *(torch.tensor(np.asarray(x))
                                  for x in imgs[1]), pcfg,
                           raw=torch.tensor(draws))
    for a, b in zip(nxt.feats_l, new.feats_l):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert bool(got.tracking_ok) and bool(want.tracking_ok)
    assert int(got.num_inliers) == int(want.num_inliers) >= 6
    for g, w in ((got.T_wc, want.T_wc), (new.T_delta_prev,
                                          nxt.T_delta_prev)):
        np.testing.assert_allclose(g[:3, 3].numpy(), np.asarray(w)[:3, 3],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(g[:3, :3].numpy(), np.asarray(w)[:3, :3],
                                   rtol=0, atol=1e-5)
    assert float(jl.pose_error_weighted(jnp.asarray(got.T_wc.numpy()),
                                        T1)) < 0.05


def test_orb_keyframe_signature_matches_jax(frames):
    """The backend's retrieval sketch of an ORB keyframe, on the host and
    on the device, equals JAX's: (64, 256) unit rows."""
    cfg, lefts, _ = frames
    pfc = convert.config_from_dict(dataclasses.asdict(cfg)).frontend
    fj = jf.detect(jnp.asarray(lefts[0]), cfg.frontend)
    fp = pf.detect(torch.tensor(lefts[0]), pfc)
    want = np.asarray(jbe._signature(fj))
    assert want.shape[1] == 256
    np.testing.assert_allclose(pbe._signature(fp), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pbe.signature_device(fp).numpy(),
                               np.asarray(jbe.signature_device(fj)), rtol=0,
                               atol=1e-6)
