"""SGM path aggregation of the port (kernel B3's plain version, ops/sgm.py)
against the JAX package's for both backends and cost dtypes (split from
tests/test_torch_stereo.py, whose module fixture these do not use). The
JAX Pallas SGM runs in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu.config import StereoConfig
from denseslam_tpu.ops import stereo as jst
from denseslam_tpu_torch.ops import sgm as psg


def _sgm_pair(cost, backend, dtype):
    c = jnp.asarray(cost)
    if dtype == "bfloat16":
        c = c.astype(jnp.bfloat16)
    ref = np.asarray(jst.sgm_aggregate(
        c, StereoConfig(sgm_backend=backend)).astype(jnp.float32))
    ct = torch.tensor(np.asarray(c.astype(jnp.float32)))
    if dtype == "bfloat16":
        ct = ct.to(torch.bfloat16)
    got = psg.sgm_aggregate(ct, 8.0, 96.0, backend)
    assert got.dtype == ct.dtype
    return ref, got.to(torch.float32).numpy()



@pytest.mark.parametrize("w", [32, 27])          # aligned / Pallas-padded width
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sgm_f32_exact_per_backend(w, backend):
    """f32: exact against each JAX backend, for real-valued costs too —
    both sides round every add in the same order, and each backend's
    direction-sum association is reproduced."""
    rng = np.random.default_rng(w)
    cost = rng.uniform(0, 200, (6, w, 32)).astype(np.float32)
    ref, got = _sgm_pair(cost, backend, "float32")
    np.testing.assert_array_equal(ref, got)



def test_sgm_backends_agree_on_integer_costs():
    """The two sum orders agree bit for bit only on integer-valued costs."""
    cost = np.random.default_rng(4).integers(0, 200, (6, 27, 32)).astype(
        np.float32)
    a = psg.sgm_aggregate(torch.tensor(cost), 8.0, 96.0, "xla")
    b = psg.sgm_aggregate(torch.tensor(cost), 8.0, 96.0, "pallas")
    assert torch.equal(a, b)



@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sgm_bf16_within_tolerance(backend):
    """bf16: rtol=1.5e-2, atol=2, the tolerance tests/test_stereo.py:107-113
    allows — XLA on the CPU may keep bf16 intermediates in f32, the port
    rounds after every op."""
    cost = np.random.default_rng(5).integers(0, 200, (6, 27, 32)).astype(
        np.float32)
    ref, got = _sgm_pair(cost, backend, "bfloat16")
    np.testing.assert_allclose(ref, got, rtol=1.5e-2, atol=2.0)

