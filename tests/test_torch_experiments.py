"""The port's experiment tools (denseslam_tpu_torch/tools/) against the JAX
package's scripts (scripts/), on the CPU.

  * the sweeps and the demo (tracking_exp, decay_exp, lowfreq_exp,
    odo_exp, run_demo): each JAX script loaded by path with
    `denseslam_tpu.main.main` replaced by a recorder, and the port's tool
    with `denseslam_tpu_torch.main.main` replaced by the same recorder,
    into the same folder in turn. The recorder writes a summary with the
    JAX summary's keys and, where asked, a KITTI trajectory; the demo's
    fixture and scorer steps are recorded too (the JAX script's
    subprocesses, the port's in-process calls). The argv lists are equal
    (the port's without `--device cpu`), and so are the JSON records the
    tools write (sweep.json, lowfreq_sweep.json, odo_summary.json,
    trajectory_scores.json). No JAX program is compiled;
  * the fixture: scripts/make_synthetic_dataset.py in a subprocess and
    the port's tool on the CPU at 96x64 over 2 frames write the same file
    names; calib.txt and poses_gt.txt equal byte for byte; the 8-bit
    images and the 16-bit depth_gt PNGs within 1 level on every pixel and
    equal on >= 99.5% of them (measured: 99.93% on the worst image); the
    disparity PFMs zero at the same pixels and within 1e-4 relative
    elsewhere (measured: 9.9e-6). The two renderers round the scene's
    float32 depth and texture apart in the last bits, and truncation to
    an integer level moves a value that sits on a boundary by one. Then
    prepare_dataset validate and gt-poses print and write the same on
    both fixtures;
  * eval_raycast_depth: the JAX script (it reads the PNGs with cv2, the
    oracle here) and the port's tool on the same 16-bit PNGs made from a
    seed write the same JSON text, with and without --no-crop and with
    --input-dir; both return 1 when no frame overlaps;
  * one real run on the CPU: tracking_exp's four profiles over 3 frames of
    the port's fixture at 96x64 (a 2^10-slot table added to the argv),
    then memory_draw on their logs and contact_sheet on the checkpoint
    that the `none` run wrote: a memory log and a trajectory of 3 lines a
    profile, decay + slide window ending with no more blocks than none,
    every map of the sweep collected when the tool returns, the figure's
    series colours inside its plot area, the sheet's colour pane equal
    to render_preview of the loaded map;
  * importing every new tool loads none of jax, denseslam_tpu, cv2 or
    matplotlib;
  * a tool asked for the card on a machine without one raises.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

from denseslam_tpu_torch.io import pfm, plot, png
from denseslam_tpu_torch.io.trajectory import load_kitti, save_kitti
from denseslam_tpu_torch.tools import (contact_sheet, eval_raycast_depth,
                                       make_synthetic_dataset, memory_draw,
                                       prepare_dataset, tracking_exp)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEPS = ("tracking_exp", "decay_exp", "lowfreq_exp", "odo_exp", "run_demo")
# the keys of the JAX command line's summary (denseslam_tpu/main.py:428)
SUMMARY_KEYS = ("frames", "fps", "mean_fusion_ms", "final_blocks",
                "final_memory_mb", "num_submaps", "num_device_submaps",
                "device_memory_mb", "submap_evictions", "submap_restores")
SMALL_MAP = ["--table_slots_log2", "10", "--max_visible_log2", "8",
             "--voxel_size", "0.05", "--max_depth", "10"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread each spares the other test processes of a parallel run
    the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root):
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in files]
    return sorted(out)


def _strip_device(argv):
    argv = list(argv)
    if "--device" in argv:
        i = argv.index("--device")
        del argv[i:i + 2]
    return argv


class Recorder:
    """Stands in for a command line's main(argv): records the argv and
    writes what the tools read back, made from the call's index and its
    flags."""

    def __init__(self):
        self.calls = []

    def __call__(self, argv=None):
        argv = _strip_device(argv)
        self.calls.append(argv)
        k = len(self.calls)

        def flag(name):
            return argv[argv.index(name) + 1] if name in argv else None

        limit = flag("--frame_limit")
        frames = int(limit) if limit else 5
        summary = dict(frames=frames, fps=10.0 / k, mean_fusion_ms=1.5 * k,
                       final_blocks=100 + 7 * k + len(argv),
                       final_memory_mb=0.25 * k, num_submaps=1,
                       num_device_submaps=1, device_memory_mb=64.0 + k,
                       submap_evictions=0, submap_restores=0)
        assert set(summary) == set(SUMMARY_KEYS)
        if flag("--metrics_json"):
            with open(flag("--metrics_json"), "w") as f:
                json.dump(summary, f)
        if flag("--save_kitti_trajectory"):
            save_kitti(flag("--save_kitti_trajectory"),
                       _poses(frames, 0.01 * k))
        return 0


def _poses(n, wobble=0.0):
    out = []
    for i in range(n):
        T = np.eye(4)
        T[:3, 3] = (wobble * np.sin(i), 0.02 * wobble * i, 0.5 * i)
        out.append(T)
    return out


def _helper_step(name, argv, calls):
    """The demo's fixture and scorer steps: record them and write what the
    demo reads next (poses_gt.txt, the scores' file)."""
    argv = _strip_device(argv)
    calls.append((name, argv))
    if name == "make_synthetic_dataset":
        os.makedirs(argv[0], exist_ok=True)
        save_kitti(os.path.join(argv[0], "poses_gt.txt"),
                   _poses(int(argv[argv.index("--frames") + 1])))
    else:
        with open(argv[argv.index("--out") + 1], "w") as f:
            json.dump({"raycast": {"frames": 1}}, f)
    return 0


def _sweep_argv(name, base):
    seq = os.path.join(base, "seq")
    out = os.path.join(base, "out")
    return {
        "tracking_exp": [seq, "--out", out, "--frames", "3",
                         "--dataset_type", "kitti_odometry",
                         "--min_decay_age", "30", "--max_decay_weight", "2"],
        "decay_exp": [seq, out, "--frames", "3"],
        "lowfreq_exp": [seq, out, "--ks", "1", "4"],
        "odo_exp": [seq, os.path.join(base, "seq2"), "--out", out,
                    "--frames", "4", "--compute_depth"],
        "run_demo": ["--workdir", base, "--frames", "6", "--backend"],
    }[name]


RECORDS = {"tracking_exp": "sweep.json", "decay_exp": "sweep.json",
           "lowfreq_exp": "lowfreq_sweep.json",
           "odo_exp": "odo_summary.json",
           "run_demo": "trajectory_scores.json"}


@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_argv_and_records_equal_the_jax_scripts(tmp_path, monkeypatch,
                                                      name):
    import denseslam_tpu.main as jax_main

    import denseslam_tpu_torch.main as port_main

    base = str(tmp_path / "run")
    argv = _sweep_argv(name, base)
    out = os.path.join(base, "out")

    def fresh():
        shutil.rmtree(base, ignore_errors=True)
        os.makedirs(os.path.join(base, "seq"))
        save_kitti(os.path.join(base, "seq", "poses_gt.txt"), _poses(5))
        os.makedirs(os.path.join(base, "seq2"))   # no ground truth

    runs = {}
    for side in ("jax", "port"):
        fresh()
        rec, steps = Recorder(), []
        if side == "jax":
            monkeypatch.setattr(jax_main, "main", rec)

            def fake_run(cmd, check=False, **kw):
                _helper_step(os.path.basename(cmd[1])[:-3], cmd[2:], steps)
                return subprocess.CompletedProcess(cmd, 0)

            monkeypatch.setattr(subprocess, "run", fake_run)
            monkeypatch.setattr(sys, "argv", [name + ".py"] + argv)
            _jax_script(name).main()
            monkeypatch.undo()
        else:
            monkeypatch.setattr(port_main, "main", rec)
            for helper in ("make_synthetic_dataset", "eval_raycast_depth"):
                mod = __import__(f"denseslam_tpu_torch.tools.{helper}",
                                 fromlist=["main"])
                monkeypatch.setattr(
                    mod, "main",
                    lambda a, _h=helper: _helper_step(_h, a, steps))
            mod = __import__(f"denseslam_tpu_torch.tools.{name}",
                             fromlist=["main"])
            assert mod.main(argv + ["--device", "cpu"]) == 0
            monkeypatch.undo()
        with open(os.path.join(out, RECORDS[name])) as f:
            record = f.read()
        runs[side] = (rec.calls, steps, record)

    (jcalls, jsteps, jrec), (pcalls, psteps, prec) = runs["jax"], runs["port"]
    assert len(jcalls) >= 2 if name != "run_demo" else len(jcalls) == 1
    assert pcalls == jcalls
    assert psteps == jsteps
    assert prec == jrec
    if name == "run_demo":
        assert [s[0] for s in psteps] == ["make_synthetic_dataset",
                                          "eval_raycast_depth"]
    if name == "odo_exp":
        rec = json.loads(prec)
        assert "ate_rmse_m" in rec["seq"] and "ate_rmse_m" not in rec["seq2"]


def test_fixture_equals_the_jax_script(tmp_path, capsys):
    ref, port = str(tmp_path / "jax"), str(tmp_path / "port")
    args = ["--frames", "2", "--width", "96", "--height", "64"]
    r = subprocess.run([sys.executable, "scripts/make_synthetic_dataset.py",
                        ref] + args, cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    assert make_synthetic_dataset.main([port] + args
                                       + ["--device", "cpu"]) == 0
    files = _tree(ref)
    assert files == _tree(port)
    assert {"calib.txt", "poses_gt.txt", "depth_gt/000001.png",
            "image_0/000001.png", "image_1/000001.png",
            "precomputed-depth/000001.pfm"} <= set(files)
    for f in files:
        a, b = os.path.join(ref, f), os.path.join(port, f)
        if f.endswith(".txt"):
            assert open(a, "rb").read() == open(b, "rb").read(), f
        elif f.endswith(".pfm"):
            x, y = pfm.read_pfm(a), pfm.read_pfm(b)
            assert x.shape == (64, 96)
            assert np.array_equal(x > 0, y > 0), f
            pos = x > 0
            assert (np.abs(x - y)[pos] / x[pos]).max() <= 1e-4, f
        else:
            x, y = png.read_png(a), png.read_png(b)
            assert x.dtype == y.dtype == (
                np.uint16 if f.startswith("depth_gt") else np.uint8), f
            d = np.abs(x.astype(np.int64) - y.astype(np.int64))
            assert d.max() <= 1 and (d == 0).mean() >= 0.995, f

    # prepare_dataset on both fixtures: the same report, return codes and
    # poses_gt.txt copy
    jax_prep = _jax_script("prepare_dataset")
    for cmd in (["validate"], ["gt-poses"]):
        said = []
        for side, root in (("jax", ref), ("port", port)):
            extra = ([os.path.join(root, "poses_gt.txt"), root]
                     if cmd == ["gt-poses"] else [root])
            capsys.readouterr()
            if side == "jax":
                old = sys.argv
                sys.argv = ["prepare_dataset.py"] + cmd + extra
                try:
                    rc = jax_prep.main()
                finally:
                    sys.argv = old
            else:
                rc = prepare_dataset.main(cmd + extra)
            said.append((rc, capsys.readouterr().out.replace(root, "ROOT")))
        assert said[0] == said[1] and said[0][0] == 0, said
    assert open(os.path.join(ref, "poses_gt.txt")).read() == open(
        os.path.join(port, "poses_gt.txt")).read()


def test_eval_raycast_depth_equals_the_jax_script(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    dirs = {k: str(tmp_path / k) for k in ("raycast", "gt", "input", "none")}
    for d in dirs.values():
        os.makedirs(d)
    h, w = 120, 400
    for i in range(4):
        gt = rng.uniform(2.0, 40.0, (h, w))
        gt[rng.random((h, w)) < 0.3] = 0.0
        pred = gt * rng.uniform(0.8, 1.25, (h, w))
        pred[rng.random((h, w)) < 0.2] = 0.0
        inp = gt + rng.normal(0.0, 0.3, (h, w))
        for key, dm in (("raycast", pred), ("input", inp), ("gt", gt)):
            if (key, i) in (("raycast", 3), ("gt", 0)):
                continue        # frames that only one side has
            png.write_png(os.path.join(dirs[key], f"{i:06d}.png"),
                          np.clip(np.round(dm * 256), 0, 65535)
                          .astype(np.uint16))
    png.write_png(os.path.join(dirs["none"], "000009.png"),
                  np.ones((h, w), np.uint16))
    jax_script = _jax_script("eval_raycast_depth")
    for extra in ([], ["--no-crop"], ["--input-dir", dirs["input"]]):
        texts = []
        for side in ("jax", "port"):
            out = str(tmp_path / f"{side}.json")
            argv = [dirs["raycast"], dirs["gt"], "--out", out] + extra
            if side == "jax":
                monkeypatch.setattr(sys, "argv", ["eval.py"] + argv)
                assert jax_script.main() == 0
                monkeypatch.undo()
            else:
                assert eval_raycast_depth.main(argv) == 0
            texts.append(open(out).read())
        assert texts[0] == texts[1], extra
        rec = json.loads(texts[1])
        assert rec["raycast"]["frames"] == 2
        assert ("input" in rec) == bool(extra and extra[0] == "--input-dir")
    monkeypatch.setattr(sys, "argv", ["eval.py", dirs["none"], dirs["gt"]])
    assert jax_script.main() == 1
    monkeypatch.undo()
    assert eval_raycast_depth.main([dirs["none"], dirs["gt"]]) == 1


def test_sweep_figure_and_sheet_on_the_cpu(tmp_path, monkeypatch):
    import denseslam_tpu_torch.main as port_main
    from denseslam_tpu_torch.models import dense_slam
    from denseslam_tpu_torch.ops import raycast as rc_ops

    seq, out = str(tmp_path / "seq"), str(tmp_path / "out")
    assert make_synthetic_dataset.main([seq, "--frames", "3", "--width",
                                        "96", "--height", "64",
                                        "--device", "cpu"]) == 0
    ckpt = str(tmp_path / "ckpt.npz")
    real_main, slams = port_main.main, []
    real_init = dense_slam.DenseSLAM.__init__

    def small_main(argv):
        extra = SMALL_MAP + (["--checkpoint_out", ckpt]
                             if any(a.endswith("seq_none.json")
                                    for a in argv) else [])
        return real_main(argv + extra)

    def init(s, *a, **kw):
        real_init(s, *a, **kw)
        slams.append(weakref.ref(s))

    monkeypatch.setattr(port_main, "main", small_main)
    monkeypatch.setattr(dense_slam.DenseSLAM, "__init__", init)
    assert tracking_exp.main([seq, "--out", out, "--frames", "3",
                              "--dataset_type", "kitti_odometry",
                              "--min_decay_age", "1",
                              "--max_decay_weight", "2",
                              "--device", "cpu"]) == 0
    monkeypatch.undo()
    assert len(slams) == 4 and all(r() is None for r in slams)
    sweep = json.load(open(os.path.join(out, "sweep.json")))
    assert [m["profile"] for m in sweep] == list(tracking_exp.PROFILES)
    blocks = {m["profile"]: m["final_blocks"] for m in sweep}
    assert blocks["decay_slide"] <= blocks["none"] and blocks["none"] > 0
    logs = [os.path.join(out, f"memory_seq_{p}.txt")
            for p in tracking_exp.PROFILES]
    for p, log in zip(tracking_exp.PROFILES, logs):
        assert len(open(log).read().splitlines()) == 3
        assert len(load_kitti(os.path.join(out, f"seq_{p}_traj.txt"))) == 3

    fig = str(tmp_path / "memory.png")
    assert memory_draw.main([fig] + logs) == 0
    img = plot.read_rgb(fig)
    want, (x0, y0, x1, y1) = memory_draw.figure(logs)
    assert img.shape == (memory_draw.FIG_H, memory_draw.FIG_W, 3)
    assert np.array_equal(img, want)
    inside = img[y0 + 1:y1, x0 + 1:x1]
    for c in plot.TAB10[:4]:
        assert (inside == c).all(-1).any(), c

    sheet = str(tmp_path / "sheet.png")
    args = [ckpt, sheet, "--memory-log", logs[0], "--width", "96",
            "--height", "64", "--voxel-size", "0.05", "--max-depth", "10",
            "--table-log2", "10", "--device", "cpu"]
    assert contact_sheet.main(args) == 0
    img = plot.read_rgb(sheet)
    rects = contact_sheet.layout(96, 64)
    assert img.shape == (rects["sheet"][3], rects["sheet"][2], 3)
    slam = contact_sheet.load_slam(contact_sheet.build_parser().parse_args(
        args))
    assert slam.frame == 3
    rc = slam.raycast_view(contact_sheet.last_pose(slam))
    color = rc_ops.render_preview(rc, "color").numpy()
    x, y, w, h = rects["color"]
    assert (w, h) == (96, 64) and color.any()
    assert np.array_equal(img[y:y + h, x:x + w], color)


def test_tools_import_no_jax_cv2_or_matplotlib():
    mods = ["io.font", "io.plot"] + [f"tools.{m}" for m in (
        "common", "make_synthetic_dataset", "eval_raycast_depth", "run_demo",
        "prepare_dataset", "decay_exp", "lowfreq_exp", "odo_exp",
        "tracking_exp", "memory_draw", "contact_sheet")]
    code = (
        "import sys\n"
        + "".join(f"import denseslam_tpu_torch.{m}\n" for m in mods)
        + "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'denseslam_tpu', 'cv2', 'matplotlib', 'PIL')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_tools_raise_without_a_card(tmp_path, monkeypatch):
    from denseslam_tpu_torch.tools import decay_exp, run_demo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seq = str(tmp_path / "seq")
    assert make_synthetic_dataset.main([seq, "--frames", "1", "--width",
                                        "32", "--height", "24",
                                        "--device", "cpu"]) == 0
    calls = [
        lambda: make_synthetic_dataset.main([str(tmp_path / "a"),
                                             "--frames", "1"]),
        lambda: prepare_dataset.main(["synth", str(tmp_path / "b"),
                                      "--frames", "1"]),
        lambda: run_demo.main(["--workdir", str(tmp_path / "c"),
                               "--frames", "1"]),
        lambda: decay_exp.main([seq, str(tmp_path / "d"), "--ages", "1",
                                "--weights", "1", "--frames", "1"]),
        lambda: contact_sheet.main([str(tmp_path / "none.npz"),
                                    str(tmp_path / "e.png")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not os.path.exists(str(tmp_path / "e.png"))
