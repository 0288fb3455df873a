"""The port's SGM + WTA without a summed volume (ops/sgm.py `sgm_wta`, then
ops/stereo.py `_disparity_from_maps`) against JAX
`disparity_from_cost(sgm_aggregate(cost), raw_cost=cost)` at the ragged
shapes the card's kernels must mask (W not a multiple of a column chunk, H
not a multiple of a column group, D = 32, 64, 256), both backends, f32.

The volumes hold what the kernels' orderings must get right: costs in
[-2, 300] (box-filtered costs can be slightly negative), exact +-0, many
near-ties, and BIG where x < d. They are integer-valued, so that the two
backends' sum orders give the same sums (tests/test_torch_stereo.py) and
one jitted JAX reference serves both; subnormals are left to the card's
check (chip_smoke.py `check_sgm_ragged`), since XLA on the CPU flushes
them to zero. Disparity and validity must be equal, and the fused route's
maps equal to those of the summed volume."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import StereoConfig
from denseslam_tpu.ops import stereo as jst
from denseslam_tpu_torch.config import StereoConfig as PStereoConfig
from denseslam_tpu_torch.ops import sgm as psg
from denseslam_tpu_torch.ops import stereo as pst


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread each spares the other test processes of a parallel run
    the oversubscribed cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edge_volume(shape, seed):
    h, w, d = shape
    rng = np.random.default_rng(seed)
    c = rng.integers(-2, 301, shape).astype(np.float32)
    c[rng.integers(0, 16, shape) == 0] = -0.0
    invalid = np.arange(w)[None, :, None] < np.arange(d)[None, None, :]
    return np.where(invalid, np.float32(1e4), c).astype(np.float32)


@pytest.mark.parametrize("shape", [(7, 37, 32), (33, 130, 64), (5, 300, 256)])
def test_sgm_wta_matches_jax_on_ragged_shapes(shape):
    sc = StereoConfig()
    cv = _edge_volume(shape, shape[2])
    ref = jax.jit(lambda c: jst.disparity_from_cost(jst.sgm_aggregate(c, sc),
                                                    sc, raw_cost=c))
    dj, vj = (np.asarray(a) for a in ref(jnp.asarray(cv)))
    ct = torch.tensor(cv)
    for backend in ("xla", "pallas"):
        psc = PStereoConfig(sgm_backend=backend)
        maps = psg.sgm_wta(ct, psc.sgm_p1, psc.sgm_p2, backend)
        dp, vp = pst._disparity_from_maps(maps, shape[2], psc)
        np.testing.assert_array_equal(vj, vp.numpy(), err_msg=backend)
        np.testing.assert_array_equal(dj, dp.numpy(), err_msg=backend)
        vol = psg.wta_maps(psg.sgm_aggregate(ct, psc.sgm_p1, psc.sgm_p2,
                                             backend), ct)
        for name, a, b in zip(psg.WtaMaps._fields, maps, vol):
            assert torch.equal(a, b), (backend, name)
    assert vj.mean() > 0.0
