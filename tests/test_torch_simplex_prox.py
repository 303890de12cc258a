"""Port's ``proj_simplex_metric`` against the JAX package's, on the CPU in
float64.

Both run the same K Michelot passes, so they agree to rounding (atol
1e-13): random rows, zero metrics (a zero entry, and whole zero rows), rows
already on the simplex (returned unchanged) and a scalar metric.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp_pfdr_graph_d1_tpu.ops.prox import proj_simplex_metric as jproj
from cp_pfdr_graph_d1_tpu_torch.ops.prox import proj_simplex_metric

torch.set_num_threads(1)


@pytest.mark.parametrize("case", ["random", "zero_metric", "on_simplex",
                                  "scalar_metric"])
@pytest.mark.parametrize("k", [3, 4])
def test_proj_simplex_metric_matches_jax(case, k):
    r = np.random.default_rng(10 * k + len(case))
    x = 0.6 * r.normal(size=(60, k)) + 1.0 / k
    m = r.uniform(0.1, 2.0, (60, k))
    if case == "zero_metric":
        m[::3, 0] = 0.0
        m[::7] = 0.0
    elif case == "on_simplex":
        x = r.dirichlet(np.ones(k), 60)
    elif case == "scalar_metric":
        m = np.float64(0.7)
    out_j = np.asarray(jproj(jnp.asarray(x), jnp.asarray(m), 1.0))
    out_t = proj_simplex_metric(torch.from_numpy(x), torch.as_tensor(m), 1.0)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=0, atol=1e-13)
    if case == "on_simplex":
        np.testing.assert_allclose(out_t.numpy(), x, rtol=0, atol=1e-13)
    if case != "zero_metric":
        np.testing.assert_allclose(out_t.numpy().sum(axis=1), 1.0, atol=1e-13)
        assert (out_t.numpy() >= 0).all()
