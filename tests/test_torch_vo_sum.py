"""ops/matching.py `xla_sum` against a jitted `jnp.sum` (split from
tests/test_torch_vo.py, whose module fixture it does not use):
XLA:CPU's order of a float32 sum, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from denseslam_tpu_torch.ops import matching as pm


@pytest.mark.parametrize("n", [5, 32, 33, 100, 256, 300, 2048, 4097])
def test_xla_sum_equals_jitted_jax_sum(n):
    """ops/matching.py xla_sum: XLA:CPU's order of a float32 sum (windows
    of 32, evenly zero-padded, then their sums), bit for bit against a
    jitted jnp.sum on values like the exposure's patch sums."""
    rng = np.random.default_rng(n)
    f = jax.jit(lambda v, x: jnp.sum(v * x))
    for _ in range(10):
        x = (rng.uniform(0, 6000, n)
             * (rng.uniform(size=n) > 0.3)).astype(np.float32)
        want = float(f(jnp.ones(n, jnp.float32), jnp.asarray(x)))
        assert float(pm.xla_sum(torch.tensor(x))) == want

