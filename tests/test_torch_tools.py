"""The port's tools (denseslam_tpu_torch/tools/) against the JAX package's
scripts.

  * scale_sequence: a KITTI sequence (gray PNGs, disparity PFMs, calib.txt)
    and a TUM one (colour PNGs, 16-bit depth PNGs, timestamps), both
    written by io/make_dataset.py, shrunk by the port's tool in process
    and by scripts/scale_sequence.py in a subprocess: the same files, the
    decoded images and PFMs equal bit for bit (cv2's INTER_AREA and
    INTER_NEAREST), calib.txt and the copied text files equal byte for
    byte; at 0.5 (cv2's 2 x 2 integer path) and at 0.3 (its float32
    table);
  * long_drive_eval: the drive on the CPU at 160x120 over 4 frames of the
    loop (the decay catch-up cut to 1 pass), in chunks of 2 with
    --prefetch and --blackout, and per frame with the mono sensor: the
    JSON record's keys equal those of the JAX script's
    records (results_long_drive.json, results_mono.json), the history
    line appended, the RESULTS block written;
  * utils/threefry.py against jax.random (the reproduction of the JAX
    golden's data that chip_smoke.py's `vo_drift` makes on the card):
    keys, fold_in, split, random bits, uniform and randint bit for bit;
    normal within 3 float32 ulps on all but 1e-4 of the samples, which
    fall on the other side of the erf_inv polynomial's switch at w = 5
    (within 2e-3: the two log1p's round differently there);
  * importing the viewer, its codecs and the tools loads none of jax,
    denseslam_tpu or cv2.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from denseslam_tpu_torch.io import pfm, png
from denseslam_tpu_torch.io.make_dataset import make_dataset
from denseslam_tpu_torch.tools import long_drive_eval, scale_sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread each spares the other test processes of a parallel run
    the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    base = tmp_path_factory.mktemp("seqs")
    kitti, tum = str(base / "kitti"), str(base / "tum")
    make_dataset([kitti, "--frames", "2", "--width", "96", "--height", "64",
                  "--device", "cpu"])
    make_dataset([tum, "--frames", "2", "--layout", "tum", "--device", "cpu"])
    return dict(kitti_odometry=kitti, tum=tum, base=base)


def _tree(root):
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in files]
    return sorted(out)


@pytest.mark.parametrize("kind,scale", [("kitti_odometry", 0.5),
                                        ("kitti_odometry", 0.3),
                                        ("tum", 0.5)])
def test_scale_sequence_equals_the_jax_script(sequences, kind, scale):
    src = sequences[kind]
    out = sequences["base"] / f"{kind}_{scale}"
    port, ref = str(out / "port"), str(out / "jax")
    args = [src, "--scale", str(scale), "--dataset_type", kind]
    assert scale_sequence.main([args[0], port] + args[1:]) == 0
    r = subprocess.run([sys.executable, "scripts/scale_sequence.py",
                        args[0], ref] + args[1:], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    files = _tree(ref)
    assert files == _tree(port)
    images = [f for f in files if f.endswith((".png", ".pfm"))]
    assert len(images) >= 4
    for f in files:
        a, b = os.path.join(ref, f), os.path.join(port, f)
        if f.endswith(".png"):
            x, y = png.read_png(a), png.read_png(b)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
            full = png.read_png(os.path.join(src, f))
            assert x.shape[:2] == (max(1, round(full.shape[0] * scale)),
                                   max(1, round(full.shape[1] * scale)))
        elif f.endswith(".pfm"):
            assert np.array_equal(pfm.read_pfm(a), pfm.read_pfm(b)), f
        else:
            assert open(a, "rb").read() == open(b, "rb").read(), f


@pytest.mark.parametrize("flags,record", [
    (["--chunk", "2", "--prefetch", "--blackout", "2:1"],
     "results_long_drive.json"),
    (["--sensor", "mono", "--chunk", "0", "--render-chunk", "2"],
     "results_mono.json")])
def test_long_drive_eval_record_keys(tmp_path, flags, record):
    out = str(tmp_path / "rec.json")
    results = str(tmp_path / "RESULTS.md")
    argv = ["--cpu", "--width", "160", "--height", "120", "--frames", "4",
            "--closure", "0", "--depth-eval-every", "1",
            "--decay-min-age", "1", "--json", out, "--out", results] + flags
    assert long_drive_eval.main(argv) == 0
    got = json.load(open(out))
    want = json.load(open(os.path.join(ROOT, record)))
    assert set(got) == set(want)
    assert set(got["memory"]) == set(want["memory"])
    assert got["frames"] == 4 and got["backend"] == "cpu"
    assert got["depth_per_frame"] is not None
    assert set(got["depth_per_frame"]) == set(want["depth_per_frame"])
    assert len(got["depth_per_frame"]["frame"]) >= 1
    hist = open(str(tmp_path / "rec_history.jsonl")).read().splitlines()
    assert len(hist) == 1 and set(json.loads(hist[0])) == set(got)
    assert "## Long-drive validation" in open(results).read()


def test_tools_and_viewer_import_no_jax_or_cv2():
    mods = ["io.viewer", "io.draw", "io.mjpeg", "tools.scale_sequence",
            "tools.long_drive_eval"]
    code = (
        "import sys\n"
        + "".join(f"import denseslam_tpu_torch.{m}\n" for m in mods)
        + "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'denseslam_tpu', 'cv2', 'PIL')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 1])
def test_threefry_equals_jax_random(seed):
    import jax
    import jax.numpy as jnp

    from denseslam_tpu_torch.utils import threefry as tf

    jk, pk = jax.random.PRNGKey(seed), tf.prng_key(seed)

    def same(a, b):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy().astype(np.int64))

    same(jk, pk)
    for d in (0, 5, 95, 2 ** 31 + 7):
        same(jax.random.fold_in(jk, d), tf.fold_in(pk, d))
    for n in (2, 3):
        same(jax.random.split(jk, n), tf.split(pk, n))
    sh = (37, 53)
    same(jax.random.bits(jk, sh, jnp.uint32), tf.random_bits(pk, sh))
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(jk, sh)),
                                  tf.uniform(pk, sh).numpy())
    for lo, hi in ((0, 2 ** 31 - 1), (-5, 17), (100, 70000)):
        same(jax.random.randint(jk, (64, 3), lo, hi),
             tf.randint(pk, (64, 3), lo, hi))
    want = np.asarray(jax.random.normal(jk, (370, 1226)))
    got = tf.normal(pk, (370, 1226)).numpy()
    err = np.abs(got - want)
    ulps = err / np.spacing(np.abs(want))
    assert (ulps <= 3).mean() >= 1 - 1e-4 and err.max() <= 2e-3
