"""The port's observation- and edge-sharded PFDR (``parallel.dp``) against
the JAX package.

The port runs in gloo ranks on the CPU, spawned once for this module at
P = 2 and at P = 4, on the JAX package's sharded problems carried over by
``convert`` (``_torch_ranks.dp_cases``); the result must match the JAX
package's single-device solve at the JAX tests' tolerance
(``tests/test_parallel.py:30-72,124-146``: float64, ``atol=1e-9``, the same
iteration count).  N = 47 pads the observation axis and the multi-label
grid's 127 edges pad the edge blocks, at P = 2 and 4.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from cp_pfdr_graph_d1_tpu import DenseOp, GraphD1, PFDROptions, VertexProx
from cp_pfdr_graph_d1_tpu.parallel import (shard_quadratic_problem,
                                           shard_simplex_problem)
from cp_pfdr_graph_d1_tpu.solvers.pfdr_quadratic import pfdr_quadratic_d1
from cp_pfdr_graph_d1_tpu.solvers.pfdr_simplex import pfdr_loss_d1_simplex
from cp_pfdr_graph_d1_tpu_torch.parallel import dp as tdp

from . import _torch_ranks as tr

SHARDS = (2, 4)
SIMPLEX = (8, 9, 4)


def _simplex_graph():
    h, w, _ = SIMPLEX
    eu, ev, la = tr.grid_graph(h, w, seed=3)
    return eu, ev, 0.3 * la


def jax_fields(p):
    out = {}
    for name, seed, n, _ in tr.DP_CASES:
        eu, ev, la, a, y = tr.dp_problem(seed=seed, n=n)
        out[name] = tuple(np.asarray(f) if isinstance(f, np.ndarray) else f
                          for f in shard_quadratic_problem(
                              a, y, eu, ev, la, p, dtype=np.float64))
    h, w, k = SIMPLEX
    out["simplex"] = tuple(shard_simplex_problem(
        tr.simplex_q(h, w, k, seed=3), *_simplex_graph(), p,
        dtype=np.float64))
    return out


@pytest.fixture(scope="module")
def ranks():
    fields = {p: jax_fields(p) for p in SHARDS}
    return tr.spawn_rings(tr.dp_cases, SHARDS, lambda p: (fields[p],))


@functools.lru_cache(maxsize=None)
def jax_quadratic(name):
    _, seed, n, opt = next(c for c in tr.DP_CASES if c[0] == name)
    eu, ev, la, a, y = tr.dp_problem(seed=seed, n=n)
    return pfdr_quadratic_d1(
        DenseOp(jnp.asarray(a, jnp.float64)), jnp.asarray(y, jnp.float64),
        GraphD1.create(eu, ev, la, dtype=jnp.float64),
        la_l1=jnp.full((a.shape[1],), 0.03), vprox=VertexProx(kind="l1"),
        lipsch=float(np.linalg.svd(a, compute_uv=False)[0] ** 2),
        opt=PFDROptions(**opt))


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("name", ["quadratic", "padding"])
def test_sharded_quadratic_matches_jax(ranks, p, name):
    """Observation- and edge-sharded PFDR against the JAX package's
    single-device solve, as ``test_sharded_matches_single_device`` and
    ``test_sharded_padding_inert``; every rank holds the same iterate."""
    base = jax_quadratic(name)
    outs = ranks[p]
    assert outs[0][name]["it"] == int(base.it)
    np.testing.assert_allclose(outs[0][name]["x"], np.asarray(base.x),
                               atol=1e-9)
    for o in outs[1:]:
        np.testing.assert_array_equal(o[name]["x"], outs[0][name]["x"])


@functools.lru_cache(maxsize=None)
def jax_simplex(al):
    h, w, k = SIMPLEX
    eu, ev, la = _simplex_graph()
    return pfdr_loss_d1_simplex(
        GraphD1.create(eu, ev, la, dtype=jnp.float64),
        jnp.asarray(tr.simplex_q(h, w, k, seed=3), jnp.float64), al=al,
        la_f=np.full(h * w, 1.3),
        opt=PFDROptions(rho=1.2, dif_tol=1e-8, it_max=400))


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("al", [0.0, 1.0, 0.5])
def test_sharded_simplex_matches_jax(ranks, p, al):
    """Edge-sharded multi-label PFDR, the three losses, against the JAX
    package's single-device solve, as
    ``test_sharded_simplex_matches_single_device``."""
    base = jax_simplex(al)
    out = ranks[p][0][f"simplex_{al}"]
    assert out["it"] == int(base.it)
    np.testing.assert_allclose(out["p"], np.asarray(base.p), atol=1e-9)


@pytest.mark.parametrize("p", [2, 3, 4, 7])
def test_shard_quadratic_problem_matches_jax(p):
    """The port's sharding is the JAX package's: the same padded blocks
    and the same local incidence tables."""
    eu, ev, la, a, y = tr.dp_problem(seed=1, n=47)
    mine = tdp.shard_quadratic_problem(a, y, eu, ev, la, p,
                                       dtype=np.float64)
    theirs = shard_quadratic_problem(a, y, eu, ev, la, p, dtype=np.float64)
    assert mine.num_vertices == theirs.num_vertices
    for field in ("a", "obs", "eu", "ev", "la_d1", "incidence"):
        np.testing.assert_array_equal(getattr(mine, field),
                                      np.asarray(getattr(theirs, field)),
                                      err_msg=field)
