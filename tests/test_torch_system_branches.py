"""Branches of the port's `SLAMSystem` (models/system.py) that the parity
files do not reach, each the counterpart of a JAX package test in
tests/test_system.py, run on the port alone at that test's image size
(`tiny_test_config` at 320x240; the frontend cut to 256 features and 64
hypotheses, 48 disparities):

  * chunk-mode relocalization after a blackout (test_system.py:159-199):
    a chunk of blank frames arms a pending relocalization; a chunk that
    revisits a known view relocks it, the keyframes registered since the
    loss began are corrected (each within the JAX test's 0.3 m of the
    revisited pose) and those before it are not moved, and the pose is
    within the JAX test's 0.15 m. The scan draws the JAX frontend's
    RANSAC hypotheses and the backend the JAX verification draws, `7000 +
    num_keyframes * 31 + ci` for the relocalization (models/backend.py
    `relocalize`), from JAX's keys (utils/threefry.py);
  * `prefetch_chunk` against plain `process_chunk` (test_system.py:
    238-270), a keyframe every 2 frames: the trajectory, the keyframe
    poses and the backend's counters equal bit for bit (the JAX test
    allows 1e-6);
  * the RGB-D chunk scan through `SLAMSystem` (test_system.py:293-322):
    tracking on > 70% of frames, >= 3 keyframes whose virtual right
    features (> 20 valid) feed BA, the trajectory within 0.15 m.
"""

import dataclasses

import numpy as np
import pytest
import torch

from denseslam_tpu_torch.config import (OnlineCorrectionParams, StereoConfig,
                                        tiny_test_config)
from denseslam_tpu_torch.io import synthetic
from denseslam_tpu_torch.models.system import SLAMSystem


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread each spares the other test processes of a parallel run
    the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**pipeline):
    """tiny_test_config at 320x240 with the frontend cut to 256 features
    and 64 RANSAC hypotheses (at 50 px buckets of 8 this image holds at
    most 280) and 48 disparities, as test_system.py's make_cfg has: the
    plain SGM and the padded feature arrays set the CPU time."""
    cfg = tiny_test_config(width=320, height=240, baseline_m=0.25)
    return dataclasses.replace(
        cfg,
        frontend=dataclasses.replace(cfg.frontend, max_features=256,
                                     ransac_iters=64),
        stereo=StereoConfig(max_disparity=48),
        pipeline=dataclasses.replace(cfg.pipeline, **pipeline))


def test_chunk_mode_relocalization_after_blackout():
    cfg = _config(fusion_db_capacity=8)
    k = cfg.frontend.ransac_iters
    sys_ = SLAMSystem(cfg, ba_every=0, loop_every=0, reloc_after=2,
                      device="cpu")
    chunk = 4
    poses = synthetic.make_trajectory(8, step_m=0.1, yaw_rate=0.0)
    lefts, rights, _ = synthetic.render_stereo_trajectory(poses, cfg.rig,
                                                          device="cpu")
    # phase 1: two clean chunks build the keyframe DB
    for i in range(0, 8, chunk):
        out = sys_.process_chunk(lefts[i:i + chunk], rights[i:i + chunk])
    assert out["tracking_ok"]
    assert sys_.backend.num_keyframes >= 6
    # phase 2: a blackout chunk (featureless frames) arms the pending
    # relocalization; blank features cannot verify, so none yet
    blanks = torch.zeros_like(lefts[:chunk])
    out = sys_.process_chunk(blanks, blanks)
    assert not out["tracking_ok"]
    assert sys_._reloc_pending
    assert sys_.num_relocs == 0
    anchor = sys_._lost_anchor_nkf
    before = [np.array(kf.T_wc) for kf in sys_.backend.keyframes]
    assert anchor == len(before)     # blank frames register no keyframe
    # phase 3: revisit a known view -> the chunk-path relocalization relocks
    l2, r2, _ = synthetic.render_stereo_trajectory(
        np.stack([poses[1]] * chunk), cfg.rig, device="cpu")
    out = sys_.process_chunk(l2, r2)
    assert sys_.num_relocs >= 1
    assert not sys_._reloc_pending
    err = np.linalg.norm(np.asarray(out["T_wc"])[:3, 3] - poses[1][:3, 3])
    assert err < 0.15, err
    # the drift-suspect keyframes were pulled back: the last stored one
    # sits near the revisited pose, not where the blackout coast left it
    kfs = sys_.backend.keyframes
    kf_err = np.linalg.norm(np.asarray(kfs[-1].T_wc)[:3, 3]
                            - poses[1][:3, 3])
    assert kf_err < 0.3, kf_err
    # ... as is every keyframe registered since the loss began, and none
    # before it moved
    assert len(kfs) > anchor
    for i, T in enumerate(before):
        np.testing.assert_array_equal(np.asarray(kfs[i].T_wc), T)
    for kf in kfs[anchor:]:
        e = np.linalg.norm(np.asarray(kf.T_wc)[:3, 3] - poses[1][:3, 3])
        assert e < 0.3, e


def test_prefetch_chunk_matches_unprefetched():
    cfg = _config(fusion_db_capacity=8, keyframe_every=2)
    n, chunk = 12, 4
    poses = synthetic.make_trajectory(n, step_m=0.12, yaw_rate=0.02)
    lefts, rights, _ = synthetic.render_stereo_trajectory(poses, cfg.rig,
                                                          device="cpu")

    def drive(prefetch: bool):
        s = SLAMSystem(cfg, ba_every=2, loop_every=0, device="cpu")
        for i in range(0, n, chunk):
            s.process_chunk(lefts[i:i + chunk], rights[i:i + chunk])
            if prefetch and i + chunk < n:
                s.prefetch_chunk(lefts[i + chunk:i + 2 * chunk],
                                 rights[i + chunk:i + 2 * chunk])
        return s

    s_a, s_b = drive(False), drive(True)
    ta = np.stack([T for _, T in s_a.trajectory()])
    tb = np.stack([T for _, T in s_b.trajectory()])
    assert ta.shape == (n, 4, 4)
    np.testing.assert_array_equal(ta, tb)
    ia, pa = s_a.keyframe_trajectory()
    ib, pb = s_b.keyframe_trajectory()
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(pa, pb)
    assert s_a.backend.num_keyframes == s_b.backend.num_keyframes > 0
    assert ((s_a.num_loops, s_a.num_corrections, s_a.backend.ba_rejects)
            == (s_b.num_loops, s_b.num_corrections, s_b.backend.ba_rejects))


def test_rgbd_chunk_mode_tracks_and_registers():
    cfg = dataclasses.replace(
        _config(sensor="rgbd", keyframe_every=2),
        correction=OnlineCorrectionParams(
            enabled=True, correction_num=3, start_correction_num=2,
            min_error=0.005))
    sys_ = SLAMSystem(cfg, ba_every=2, loop_every=0, device="cpu")
    n = 12
    poses = synthetic.make_trajectory(n, step_m=0.05, yaw_rate=0.003)
    grays, depths = synthetic.render_trajectory(poses, cfg.rig.intr,
                                                device="cpu")
    sys_.process_chunk(grays[:6], depths[:6])
    out = sys_.process_chunk(grays[6:], depths[6:])
    okf = np.asarray(out["tracking_ok_frames"])
    assert okf[1:].mean() > 0.7, f"rgbd chunk tracking lost: {okf}"
    assert sys_.backend.num_keyframes >= 3
    # virtual right features are present (BA needs the disparity)
    kf = sys_.backend.keyframes[-1]
    assert int(np.asarray(kf.feats_r.valid).sum()) > 20
    est = {f: T for f, T in sys_.slam.pose_history}
    errs = [float(np.linalg.norm(est[i][:3, 3] - poses[i][:3, 3]))
            for i in range(n) if i in est]
    assert len(errs) == n and max(errs) < 0.15, errs
