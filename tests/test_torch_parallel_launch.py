"""The parts of the port's parallel/ that need no spawned ranks: the
supertile owner hash bit for bit against JAX's `owner_of` and balanced over
2, 4 and 8 ranks, and the single-process launch (no torchrun environment:
a no-op of rank 0 whose map axis has size 1 and runs every collective as
the identity; with no device named, the card, as every entry point of the
port), and one cell of tools/bench_scaling.py's scaling matrices. The
sharded map itself is tests/test_torch_parallel.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.parallel import sharded_map as jsm
from denseslam_tpu_torch.parallel import launch
from denseslam_tpu_torch.parallel import sharded_map as psm


def test_owner_of_keys_bit_exact_and_balanced():
    coords = np.random.default_rng(0).integers(-100, 100, size=(4096, 3),
                                               dtype=np.int32)
    for n in (2, 4, 8):
        want = np.asarray(jsm.owner_of(jnp.asarray(coords), n))
        got = psm.owner_of(torch.tensor(coords), n).numpy()
        np.testing.assert_array_equal(got, want)
        counts = np.bincount(got, minlength=n)
        assert counts.min() > 0 and counts.max() < counts.mean() * 2.5


def test_launch_single_process_is_a_noop(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert launch.init_distributed() == 0
    # no device named: the card, as every entry point of the port
    if torch.cuda.is_available():
        assert launch.global_map_mesh().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.global_map_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.local_device()
    mesh = launch.global_map_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
    assert launch.is_coordinator()
    x = torch.arange(4.0)
    assert torch.equal(mesh.all_reduce(x, "min"), x)
    assert torch.equal(mesh.all_to_all(x[None]), x[None])


def test_bench_scaling_matrix_cell(tmp_path):
    """One cell of tools/bench_scaling.py's matrices, as the matrices run it:
    a launcher subprocess of one gloo rank on the CPU at 1/8 size; its
    record is the scaling bench's, for one rank."""
    from denseslam_tpu_torch.tools import bench_scaling

    log = tmp_path / "cell.log"
    rec = bench_scaling.run_cell(1, 1, str(log), extra=["--scale", "0.125"])
    assert rec["metric"] == "sharded_fused_frames_per_s_per_chip"
    assert (rec["n_chips"], rec["frames"], rec["backend"]) == (1, 1, "gloo")
    assert rec["value"] > 0 and rec["blocks"] > 0 and rec["overflow"] == 0
    assert log.read_text().strip().endswith("}")
