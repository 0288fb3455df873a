"""The port draws what the JAX package draws, from JAX's keys, with
nothing handed in (utils/threefry.py):

  * the frontend's RANSAC hypotheses: `init_frontend`'s PRNGKey(seed),
    split once a step, `randint(sub, (K, 3))` for the stereo and RGB-D
    steps and (K, 8) for the mono one, over 8 steps, through the steps
    themselves and through the chunk scan's `_sequence_draws`, bit for
    bit; the backend's verification draws from PRNGKey(qi * 31 + ci) and
    PRNGKey(7000 + n * 31 + ci), bit for bit;
  * the drive tool's nuisance: `fold_in(PRNGKey(0), s0)` per 32-frame
    batch, split 2 ways (stereo) or 3 (depth sensors), with the formulas
    of scripts/long_drive_eval.py:229-251, on the same rendered frames:
    the dropped pixels equal, the images and depths within 3 float32
    ulps of their values and equal on at least 99% of them (threefry's
    normal is within 3 ulps of JAX's sample; observed at 96x48: 99.8%
    equal, 5 values 3 ulps apart);
  * the tool's per-frame branch for the depth sensors passes the depth as
    the right image, as scripts/long_drive_eval.py:386-387 does: an
    inherited defect, named here. With --sensor rgbd --chunk 0 both
    packages raise "rgbd VO needs a depth image"; with mono the depth
    image goes to SGM as a right view and the drive fuses nothing;
  * the frontend's key travels in a checkpoint (moved here from
    tests/test_torch_cli.py, whose module fixture it does not use).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import tiny_test_config
from denseslam_tpu_torch.io import convert
from denseslam_tpu_torch.models import dense_slam as pd
from denseslam_tpu_torch.models import frontend as pfe
from denseslam_tpu_torch.models.backend import Backend
from denseslam_tpu_torch.ops import ransac as pransac
from denseslam_tpu_torch.tools import long_drive_eval as ptool
from denseslam_tpu_torch.utils import threefry

I32 = int(jnp.iinfo(jnp.int32).max)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_step_draws(seed, n, k, size):
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (k, size), 0, I32)))
    return np.stack(out), np.asarray(key)


@pytest.mark.parametrize("seed", [0, 5])
def test_frontend_draws_equal_jax_over_8_steps(seed):
    from denseslam_tpu.models import frontend as jfe
    cfg = tiny_test_config()
    pcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    k = pcfg.frontend.ransac_iters
    st = pfe.init_frontend(pcfg, device="cpu", seed=seed)
    np.testing.assert_array_equal(
        st.key.numpy(), np.asarray(jfe.init_frontend(cfg, seed=seed).key))
    for size in (3, 8):
        want, key = _jax_step_draws(seed, 8, k, size)
        got, s = [], st
        for _ in range(8):
            nk, raw = pfe._split_draws(s, None, pcfg, "cpu", size)
            got.append(raw.numpy())
            s = s._replace(key=nk)
        np.testing.assert_array_equal(np.stack(got), want)
        np.testing.assert_array_equal(s.key.numpy(), key)
        np.testing.assert_array_equal(
            pd._sequence_draws(None, st, 8, pcfg, "cpu", size).numpy(), want)


def test_backend_verification_draws_equal_jax():
    cfg = convert.config_from_dict(dataclasses.asdict(tiny_test_config()))
    be = Backend(cfg, device="cpu")
    k = be._verify_cfg.ransac_iters
    for seed in (0, 3 * 31 + 1, 7000 + 14 * 31 + 4):
        np.testing.assert_array_equal(
            be._draws(seed).numpy(),
            np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (k, 3), 0,
                                          I32)))


def _ulps(a, b):
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b))
                                      .astype(np.float32))


def _jax_nuisance(stereo, frames, lo, hi, cfg):
    """scripts/long_drive_eval.py:229-251 on frames (N, H, W) pairs, per
    32-frame batch keyed fold_in(PRNGKey(0), s0)."""
    key0, outs = jax.random.PRNGKey(0), []
    for s0 in range(lo, hi, 32):
        s1 = min(s0 + 32, hi)
        a, b = (jnp.asarray(f[s0 - lo:s1 - lo]) for f in frames)
        tt = jnp.float32(s0) + jnp.arange(s1 - s0, dtype=jnp.float32)
        g = (1.0 + 0.15 * jnp.sin(2 * jnp.pi * tt / 150.0))[:, None, None]
        key = jax.random.fold_in(key0, s0)
        if stereo:
            kl, kr = jax.random.split(key)
            nl = 2.0 * jax.random.normal(kl, a.shape, jnp.float32)
            nr = 2.0 * jax.random.normal(kr, b.shape, jnp.float32)
            outs.append((jnp.clip(a * g + nl, 0, 255),
                         jnp.clip(b * g + nr, 0, 255)))
        else:
            kl, kd, kh = jax.random.split(key, 3)
            nl = 2.0 * jax.random.normal(kl, a.shape, jnp.float32)
            gray = jnp.clip(a * g + nl, 0, 255)
            dn = b * (1.0 + 0.01 * jax.random.normal(kd, b.shape,
                                                      jnp.float32))
            holes = jax.random.uniform(kh, b.shape) < 0.05
            outs.append((gray, jnp.where(
                holes | (b <= 0) | (b > cfg.tsdf.max_depth_m), 0.0, dn)))
    return [np.concatenate([np.asarray(o[i]) for o in outs]) for i in (0, 1)]


@pytest.mark.parametrize("stereo", [True, False])
def test_drive_nuisance_equals_the_jax_script(stereo):
    from denseslam_tpu_torch.io import synthetic
    cfg = ptool.drive_config("stereo" if stereo else "rgbd", 96, 48, 4, 60,
                             30, -1.0, -1.0, small=True)
    gt, scene = ptool.system_setup(40, 0, 18.0, 0, None)
    lo, hi = 30, 40          # two batches: 30-61 cut at 40 starts at 30
    if stereo:
        clean = synthetic.render_stereo_trajectory(gt[lo:hi], cfg.rig, scene,
                                                   device="cpu")[:2]
        got = ptool.system_chunk(cfg, gt, scene, lo, hi,
                                 threefry.prng_key(0), "cpu")
    else:
        clean = synthetic.render_trajectory(gt[lo:hi], cfg.rig.intr, scene,
                                            device="cpu")
        got = ptool.depth_chunk(cfg, gt, scene, lo, hi, threefry.prng_key(0),
                                "cpu")
    want = _jax_nuisance(stereo, [c.numpy() for c in clean], lo, hi, cfg)
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape
        np.testing.assert_array_equal(g == 0, w == 0)
        u = _ulps(g, w)
        assert u.max() <= 3 and (u == 0).mean() >= 0.99


def test_depth_sensor_per_frame_branch_is_inherited(tmp_path):
    """rgbd: the JAX DenseSLAM and the port's tool raise alike; mono: the
    port's per-frame drive fuses nothing."""
    from denseslam_tpu.models.dense_slam import DenseSLAM as JaxSLAM
    jcfg = tiny_test_config()
    jcfg = dataclasses.replace(jcfg, pipeline=dataclasses.replace(
        jcfg.pipeline, sensor="rgbd"))
    z = jnp.zeros((jcfg.rig.intr.height, jcfg.rig.intr.width), jnp.float32)
    with pytest.raises(ValueError, match="rgbd VO needs a depth image"):
        JaxSLAM(jcfg).process_frame(z, z)
    flags = ["--cpu", "--width", "96", "--height", "48", "--frames", "4",
             "--closure", "0", "--chunk", "0", "--decay-min-age", "1"]
    with pytest.raises(ValueError, match="rgbd VO needs a depth image"):
        ptool.main(flags + ["--sensor", "rgbd", "--out",
                            str(tmp_path / "r.md")])
    out = tmp_path / "m.json"
    assert ptool.main(flags + ["--sensor", "mono", "--json", str(out),
                               "--out", str(tmp_path / "m.md")]) == 0
    import json
    rec = json.loads(out.read_text())
    assert rec["keyframes"] >= 1 and rec["final_map_mb"] == 0.0


def test_checkpoint_restores_the_generator(tmp_path):
    """The frontend's threefry key travels in the checkpoint: a resumed
    DenseSLAM draws what an uninterrupted one would, and the key is the
    JAX package's (PRNGKey(5) split once)."""
    from denseslam_tpu_torch.config import tiny_test_config
    from denseslam_tpu_torch.io.checkpoint import (load_slam_checkpoint,
                                                   save_slam_checkpoint)
    from denseslam_tpu_torch.models.dense_slam import DenseSLAM
    from denseslam_tpu_torch.utils import threefry

    cfg = tiny_test_config()
    a = DenseSLAM(cfg, device="cpu", seed=5)
    a.fe_state = a.fe_state._replace(key=threefry.split(a.fe_state.key)[0])
    save_slam_checkpoint(str(tmp_path / "g.npz"), a)
    b = DenseSLAM(cfg, device="cpu", seed=0)
    load_slam_checkpoint(str(tmp_path / "g.npz"), b)
    np.testing.assert_array_equal(
        b.fe_state.key.numpy(),
        np.asarray(jax.random.split(jax.random.PRNGKey(5))[0]))
    assert torch.equal(pransac.draw_hypotheses(b.fe_state.key, 8),
                       pransac.draw_hypotheses(a.fe_state.key, 8))
