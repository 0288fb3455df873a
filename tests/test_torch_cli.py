"""The port's command line (`denseslam_tpu_torch.main`) against the JAX
package's (`denseslam_tpu.main`) on the 6-frame 160x120 KITTI sequence of
tests/test_cli_e2e.py:15-41, written by the port's io/make_dataset.py. One
module fixture runs each command line once with the flags of
`test_cli_full_run` (every output); the port runs with `--device cpu` and
is handed the JAX frontend's RANSAC draws (its key splits once a frame).

Tolerances, and why:
  * poses within 1e-4 m on every frame. The running exposure that scales
    each frame is a ratio of two sums over 2048 matched patches; the port
    adds them in XLA:CPU's order (ops/matching.py `xla_sum`), so it gives
    the jitted JAX function's float32 result (a float32 sum in torch's
    order was one ulp off on frame 4, moved one feature's rank in its
    bucket and parted the poses by 2.7e-4 m there);
  * the memory log equal line for line; the summary's counts and map
    sizes equal; `device_memory_mb` larger in the port by the fusion DB's
    depth plane, int32 where JAX holds uint16 (2 bytes a pixel of each of
    its 64 slots);
  * the mesh's triangle count within 0.1%;
  * the raycast depth PNGs: equal on >= 99.5% of pixels on every frame;
  * checkpoints: each package's checkpoint loads into the other, leaves
    equal.
The port-only cases (no JAX program): a resumed run equals an
uninterrupted one bit for bit; `--chunk 4` equals SLAMSystem.process_chunk
and a two-frame per-frame tail called directly; the entry point raises
without a card unless `--device cpu`; `--live_viewer` on a free port
starts the viewer and closes it; the flags are the JAX command line's
and --device.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu_torch.io import png
from denseslam_tpu_torch.io.make_dataset import make_dataset
from denseslam_tpu_torch.io.trajectory import load_kitti, load_tum, save_kitti
from denseslam_tpu_torch.ops import ransac as pransac

N = 6
PARITY_FRAMES = N        # frames held to 1e-4 m: all of them
FLAGS = ["--table_slots_log2", "13", "--max_visible_log2", "11",
         "--voxel_size", "0.05", "--max_depth", "10", "--quiet"]


def _outputs(d):
    os.makedirs(d, exist_ok=True)
    return ["--save_trajectory", f"{d}/traj.txt",
            "--save_kitti_trajectory", f"{d}/kitti.txt",
            "--save_mesh", f"{d}/mesh.obj",
            "--save_memory_log", f"{d}/memory.txt",
            "--save_raycast_depth_dir", f"{d}/raycast",
            "--checkpoint_out", f"{d}/ckpt.npz",
            "--metrics_json", f"{d}/metrics.json"]


def _port_main(argv):
    """The port's command line on the CPU. It draws its RANSAC hypotheses
    from the frontend's threefry key, PRNGKey(0) split once a frame, as
    the JAX command line does: nothing is handed in."""
    from denseslam_tpu_torch.main import main
    return main(argv + ["--device", "cpu"])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are small: one thread each spares the other
    test processes of a parallel run the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settled_init_frontend(init):
    """JAX's init_frontend with disp_l strongly typed: its fresh state holds
    disp_l weakly typed and its VO step returns it strongly typed, so the
    jitted step compiles twice on the fresh state's types and on its own.
    The same values in the step's types compile it once."""
    def settled(*args, **kwargs):
        st = init(*args, **kwargs)
        return st._replace(disp_l=jnp.asarray(np.asarray(st.disp_l)))
    return settled


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from denseslam_tpu.main import main as jax_main
    from denseslam_tpu.models import frontend as jfe

    base = tmp_path_factory.mktemp("cli")
    root = str(base / "seq")
    make_dataset([root, "--frames", str(N), "--width", "160", "--height",
                  "120", "--device", "cpu"])
    out = {k: str(base / k) for k in ("jax", "port")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfe, "init_frontend",
                   _settled_init_frontend(jfe.init_frontend))
        assert jax_main(["--dataset_root", root] + FLAGS
                        + _outputs(out["jax"])) == 0
    assert _port_main(["--dataset_root", root] + FLAGS
                      + _outputs(out["port"])) == 0
    return dict(root=root, **out)


def _read(path):
    with open(path) as fh:
        return fh.read()


def _npz(path):
    with np.load(path) as z:
        return dict(z)


def _translation_errors(a, b):
    return np.array([np.abs(x[:3, 3] - y[:3, 3]).max() for x, y in zip(a, b)])


def test_cli_trajectories_match_jax(runs):
    j = load_tum(f"{runs['jax']}/traj.txt")
    p = load_tum(f"{runs['port']}/traj.txt")
    assert len(j) == len(p) == N
    assert [t for t, _ in j] == [t for t, _ in p]
    for a, b in ((j, p), (load_kitti(f"{runs['jax']}/kitti.txt"),
                          load_kitti(f"{runs['port']}/kitti.txt"))):
        a = [T if isinstance(T, np.ndarray) else T[1] for T in a]
        b = [T if isinstance(T, np.ndarray) else T[1] for T in b]
        err = _translation_errors(a, b)
        assert err[:PARITY_FRAMES].max() <= 1e-4, err
        assert err.max() <= 2e-3, err
        rot = max(np.abs(x[:3, :3] - y[:3, :3]).max()
                  for x, y in zip(a[:PARITY_FRAMES], b[:PARITY_FRAMES]))
        assert rot <= 1e-4


def test_cli_memory_log_equals_jax(runs):
    j = _read(f"{runs['jax']}/memory.txt").splitlines()
    p = _read(f"{runs['port']}/memory.txt").splitlines()
    assert len(p) == N and p == j


def test_cli_summary_equals_jax(runs):
    j = json.loads(_read(f"{runs['jax']}/metrics.json"))
    p = json.loads(_read(f"{runs['port']}/metrics.json"))
    assert set(p) == set(j)
    for k in ("frames", "final_blocks", "num_submaps", "num_device_submaps",
              "submap_evictions", "submap_restores", "final_memory_mb"):
        assert p[k] == j[k], k
    assert p["frames"] == N and p["mean_fusion_ms"] > 0
    db_slots = 64     # PipelineConfig.fusion_db_capacity
    extra = db_slots * 120 * 160 * 2 / 1e6
    assert p["device_memory_mb"] == pytest.approx(j["device_memory_mb"]
                                                  + extra, abs=1e-9)


def test_cli_mesh_triangles_match_jax(runs):
    def tris(path):
        return sum(1 for ln in _read(path).splitlines() if ln.startswith("f "))
    j, p = tris(f"{runs['jax']}/mesh.obj"), tris(f"{runs['port']}/mesh.obj")
    assert j > 1000 and abs(p - j) <= 1e-3 * j


def test_cli_raycast_depth_pngs_match_jax(runs):
    cv2 = pytest.importorskip("cv2")
    names = sorted(os.listdir(f"{runs['jax']}/raycast"))
    assert names == sorted(os.listdir(f"{runs['port']}/raycast"))
    assert len(names) == N
    for i, name in enumerate(names):
        j = cv2.imread(f"{runs['jax']}/raycast/{name}", cv2.IMREAD_UNCHANGED)
        p = png.read_png(f"{runs['port']}/raycast/{name}")
        assert p.dtype == j.dtype == np.uint16 and p.shape == j.shape
        diff = np.abs(p.astype(np.int64) - j.astype(np.int64))
        if i < PARITY_FRAMES:
            assert (diff == 0).mean() >= 0.995, (name, (diff == 0).mean())
        else:
            assert (diff <= 4).mean() >= 0.97, (name, (diff <= 4).mean())
        assert (p > 0).mean() > 0.3


def test_cli_checkpoints_load_across_packages(runs, tmp_path):
    from denseslam_tpu import main as jmain
    from denseslam_tpu.io import datasets as jds
    from denseslam_tpu.io.checkpoint import load_slam_checkpoint as jload
    from denseslam_tpu.models.dense_slam import DenseSLAM as JaxSLAM
    from denseslam_tpu_torch import main as pmain
    from denseslam_tpu_torch.io import convert
    from denseslam_tpu_torch.io.checkpoint import load_slam_checkpoint
    from denseslam_tpu_torch.models.dense_slam import DenseSLAM

    root = runs["root"]
    rig = jds.Input(root, jds.kitti_odometry_config()).rig
    jcfg = jmain.build_config(jmain.build_parser().parse_args(
        ["--dataset_root", root] + FLAGS), rig)
    pcfg = pmain.build_config(pmain.build_parser().parse_args(
        ["--dataset_root", root] + FLAGS), rig)

    def leaves(state):
        sm = state["submaps"][0]
        return sm["map"] + sm["db"] + [np.asarray(x)
                                       for x in state["fe_state"]]

    def same(a, b):
        assert a["frame"] == b["frame"] == N
        assert len(a["pose_history"]) == len(b["pose_history"]) == N
        for x, y in zip(leaves(a), leaves(b)):
            assert x.dtype == y.dtype and np.array_equal(x, y)

    # JAX's checkpoint into the port: equal to convert's state of the JAX
    # objects that loaded it
    js = JaxSLAM(jcfg)
    jload(f"{runs['jax']}/ckpt.npz", js)
    ps = DenseSLAM(pcfg, device="cpu")
    load_slam_checkpoint(f"{runs['jax']}/ckpt.npz", ps)
    np.testing.assert_array_equal(ps.fe_state.key.numpy(),
                                  np.asarray(js.fe_state.key))
    same(convert.slam_state_to_numpy(js), convert.slam_state_to_numpy(ps))
    assert ps.current_keyframes == js.current_keyframes

    # the port's checkpoint into JAX: the same leaves as the port's state
    ps2 = DenseSLAM(pcfg, device="cpu")
    load_slam_checkpoint(f"{runs['port']}/ckpt.npz", ps2)
    js2 = JaxSLAM(jcfg)
    jload(f"{runs['port']}/ckpt.npz", js2)
    same(convert.slam_state_to_numpy(js2), convert.slam_state_to_numpy(ps2))
    assert _npz(f"{runs['port']}/ckpt.npz").keys() == (
        _npz(f"{runs['jax']}/ckpt.npz").keys())


def test_cli_resume_equals_uninterrupted_run(runs, tmp_path):
    """Frames 0-2, a checkpoint, then frames 3-5 resumed from it: the
    trajectory, the map and the frontend state equal the fixture's
    uninterrupted run bit for bit (the same draws)."""
    root, ck = runs["root"], str(tmp_path / "ck.npz")
    assert _port_main(["--dataset_root", root, "--frame_limit", "3",
                       "--checkpoint_out", ck] + FLAGS) == 0
    d = str(tmp_path / "resumed")
    os.makedirs(d)
    assert _port_main(["--dataset_root", root, "--frame_offset", "3",
                       "--checkpoint_in", ck, "--save_trajectory",
                       f"{d}/traj.txt", "--checkpoint_out", f"{d}/ckpt.npz"]
                      + FLAGS) == 0
    assert _read(f"{d}/traj.txt") == _read(f"{runs['port']}/traj.txt")
    a, b = _npz(f"{d}/ckpt.npz"), _npz(f"{runs['port']}/ckpt.npz")
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


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


def test_cli_chunk_equals_process_chunk(runs, tmp_path):
    """`--chunk 4` over 6 frames: SLAMSystem.process_chunk on frames 0-3,
    then frames 4-5 one at a time, called directly on the frames the
    dataset reader decodes, with the same seed: the same poses, bit for
    bit."""
    from denseslam_tpu_torch import main as pmain
    from denseslam_tpu_torch.io import datasets
    from denseslam_tpu_torch.models.system import SLAMSystem

    root = runs["root"]
    argv = ["--dataset_root", root, "--chunk", "4"] + FLAGS
    cli = str(tmp_path / "cli.txt")
    assert _port_main(argv + ["--save_kitti_trajectory", cli]) == 0

    inp = datasets.Input(root, datasets.kitti_odometry_config())
    cfg = pmain.build_config(pmain.build_parser().parse_args(argv), inp.rig)
    system = SLAMSystem(cfg, device="cpu")
    frames = list(inp)
    lefts = torch.stack([torch.tensor(f["left"]) for f in frames])
    rights = torch.stack([torch.tensor(f["right"]) for f in frames])
    system.process_chunk(lefts[:4], rights[:4])
    for i in (4, 5):
        system.process_frame(lefts[i], rights[i])
    direct = str(tmp_path / "direct.txt")
    # 10 significant digits: a float32 pose round-trips exactly
    save_kitti(direct, [T for _, T in system.trajectory()])
    assert len(load_kitti(cli)) == N
    assert _read(cli) == _read(direct)


def test_cli_without_a_card_raises(runs, monkeypatch):
    from denseslam_tpu_torch.main import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataset_root", runs["root"]] + FLAGS)


def test_cli_live_viewer_starts_and_closes(runs, monkeypatch):
    """--live_viewer on a free port serves the dashboard for the run and
    closes it at the end (its server no longer answers)."""
    import socket
    import urllib.request

    from denseslam_tpu_torch.io import viewer
    from denseslam_tpu_torch.main import build_parser, main
    made = []

    class Recorded(viewer.LiveViewer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.port}/", timeout=10) as r:
                self.page = r.read()

    monkeypatch.setattr(viewer, "LiveViewer", Recorded)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert main(["--dataset_root", runs["root"], "--frame_limit", "2",
                 "--live_viewer", str(port), "--device", "cpu"]
                + FLAGS) == 0
    assert len(made) == 1 and made[0].port == port
    assert b"live pipeline" in made[0].page
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/state", timeout=2)
    # every flag of the JAX command line, and --device
    from denseslam_tpu.main import build_parser as jax_parser
    jax_flags = {a.dest: (a.default, a.choices)
                 for a in jax_parser()._actions}
    port_flags = {a.dest: (a.default, a.choices)
                  for a in build_parser()._actions}
    assert port_flags.pop("device") == (None, None)
    assert port_flags == jax_flags
