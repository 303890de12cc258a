"""The port's sharded-graph cut-pursuit (``parallel.cp_sharded`` and
``parallel.cp_sharded_simplex``) against the JAX package's cut-pursuit:
single-device for the quadratic family, sharded on the conftest's virtual
devices for the multi-label one.

The port runs in gloo ranks on the CPU, spawned once for this module at
P = 2 and at P = 4 (``_torch_ranks.cp_sharded_cases``, a 12 x 12 grid); the
JAX side runs here.  The contracts are the JAX tests'
(``tests/test_parallel.py:335-680``): the partition of the certified PDHG
cuts and the values within float32 tolerance for the identity operator;
the objective and pointwise closeness where the two paths may settle on
different near-optimal partitions (bounds, dense); for the multi-label
family, against the same sharded algorithm, the same partition; a warm
restart from the result's state that stops at once with the same
partition.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from cp_pfdr_graph_d1_tpu import (CPOptions, DenseOp, GraphD1, IdentityOp,
                                  PFDROptions)
from cp_pfdr_graph_d1_tpu.parallel import (cp_loss_d1_simplex_sharded,
                                           make_mesh)
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1
from cp_pfdr_graph_d1_tpu.solvers.pfdr_simplex import (d1_objective,
                                                       loss_objective)
from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1

from . import _torch_ranks as tr

SHARDS = (2, 4)
SIDE = tr.CP_SHARDED_SIDE


@pytest.fixture(scope="module")
def ranks():
    """Every case at P = 2 and P = 4, the two rings run at once."""
    return tr.spawn_rings(tr.cp_sharded_cases, SHARDS)


def _jopt(**over):
    kw = dict(tr.CP_SHARDED_KW, **over)
    return CPOptions(pfdr=PFDROptions(**kw.pop("pfdr")), **kw)


def _jgraph(weight):
    return StencilGraphD1.create((SIDE, SIDE), {(0, 1): weight,
                                                (1, 0): weight},
                                 dtype=jnp.float32)


def _tv_objective(x, y, weight):
    xg = np.asarray(x, np.float64).reshape(SIDE, SIDE)
    f = (0.5 * np.sum((xg.ravel() - y.astype(np.float64)) ** 2)
         + weight * np.sum(np.abs(xg[:, 1:] - xg[:, :-1]))
         + weight * np.sum(np.abs(xg[1:] - xg[:-1])))
    return f


@functools.lru_cache(maxsize=None)
def jax_identity(bounds=None):
    return cp_quadratic_d1(IdentityOp(), jnp.asarray(tr.tv_grid_problem(SIDE)),
                           _jgraph(0.3), bounds=bounds, opt=_jopt())


@pytest.mark.parametrize("p", SHARDS)
def test_cp_sharded_identity_matches_jax(ranks, p):
    """Identity operator, as ``test_cp_sharded_identity_matches_single_
    device``: the same partition, values within float32 tolerance; every
    rank holds the same result."""
    base = jax_identity()
    out = ranks[p][0]["identity"]
    np.testing.assert_array_equal(out["cv"], np.asarray(base.cv))
    np.testing.assert_allclose(out["rx"], np.asarray(base.rx), atol=2e-5)
    for o in ranks[p][1:]:
        np.testing.assert_array_equal(o["identity"]["cv"], out["cv"])
        np.testing.assert_array_equal(o["identity"]["rx"], out["rx"])


@pytest.mark.parametrize("p", SHARDS)
def test_cp_sharded_bounds_and_restart(ranks, p):
    """Bounds through the sharded cut-pursuit, and a warm restart that
    stops at once with the same partition, as
    ``test_cp_sharded_bounds_and_restart``."""
    y = tr.tv_grid_problem(SIDE)
    base = jax_identity(bounds=(0.0, 0.9))
    out = ranks[p][0]["bounds"]
    x_s = out["rx"][out["cv"]]
    x_1 = np.asarray(base.rx)[np.asarray(base.cv)]
    f_s, f_1 = _tv_objective(x_s, y, 0.3), _tv_objective(x_1, y, 0.3)
    assert f_s <= f_1 * (1 + 1e-3), (f_s, f_1)
    assert x_s.min() >= -1e-6 and x_s.max() <= 0.9 + 1e-6
    again = ranks[p][0]["bounds_restart"]
    assert again["it"] <= 2
    np.testing.assert_array_equal(again["cv"], out["cv"])


@functools.lru_cache(maxsize=None)
def jax_dense():
    a, y, la_l1 = tr.cp_dense_problem()
    return cp_quadratic_d1(
        DenseOp(jnp.asarray(a)), jnp.asarray(y), _jgraph(0.05),
        la_l1=la_l1, positivity=True,
        opt=_jopt(it_max=5, pfdr=dict(rho=1.5, dif_tol=1e-6, it_max=3000)))


@pytest.mark.parametrize("p", SHARDS)
def test_cp_sharded_dense_matches_jax(ranks, p):
    """Dense operator (the gradient column-sharded), as
    ``test_cp_sharded_dense_matches_single_device``: pointwise within 2e-3
    and the objective within 1e-4 relative."""
    a, y, la_l1 = tr.cp_dense_problem()
    base = jax_dense()
    out = ranks[p][0]["dense"]
    x_s = out["rx"][out["cv"]]
    x_1 = np.asarray(base.rx)[np.asarray(base.cv)]
    np.testing.assert_allclose(x_s, x_1, atol=2e-3)
    g = _jgraph(0.05)
    eu, ev = np.asarray(g.eu), np.asarray(g.ev)
    la = np.asarray(g.la_d1).astype(np.float64)

    def obj(x):
        x = np.asarray(x, np.float64)
        r = a.astype(np.float64) @ x - y.astype(np.float64)
        return (0.5 * r @ r + np.sum(la * np.abs(x[eu] - x[ev]))
                + np.sum(la_l1.astype(np.float64) * np.abs(x)))

    assert abs(obj(x_s) - obj(x_1)) <= 1e-4 * max(abs(obj(x_1)), 1e-9)


def _simplex_kw():
    return _jopt(dif_tol=1.0, it_max=6, pfdr=dict(rho=1.5, dif_tol=1e-6,
                                                  it_max=2000))


@functools.lru_cache(maxsize=None)
def jax_simplex():
    """The multi-label problem, its real-edge float64 COO graph (for the
    objective) and the weight-bearing stencil."""
    g = _jgraph(tr.CP_SHARDED_SIMPLEX_WEIGHT)
    eu, ev, la = np.asarray(g.eu), np.asarray(g.ev), np.asarray(g.la_d1)
    real = la > 0
    g64 = GraphD1.create(eu[real], ev[real], la[real].astype(np.float64),
                         num_vertices=SIDE * SIDE, dtype=jnp.float64)
    return g, g64, tr.cp_sharded_simplex_problem()


@functools.lru_cache(maxsize=None)
def jax_simplex_sharded(p):
    """The JAX package's sharded multi-label cut-pursuit on ``p`` of the
    conftest's virtual devices."""
    g, _, q = jax_simplex()
    return cp_loss_d1_simplex_sharded(q, g, make_mesh(p), al=0.5,
                                      opt=_simplex_kw())


@pytest.mark.parametrize("p", SHARDS)
def test_cp_sharded_simplex_matches_jax(ranks, p):
    """Multi-label sharded cut-pursuit (K-1 sharded PDHG expansion cuts)
    against the JAX package's ``cp_loss_d1_simplex_sharded`` on the same
    ring size, with the label noise of
    ``test_cp_sharded_simplex_matches_single_device`` (0.08): the same
    iterations, the same partition and the component values within
    float32 tolerance; every rank holds the same result; a warm restart
    stops at once with the same partition."""
    base = jax_simplex_sharded(p)
    out = ranks[p][0]["simplex"]
    assert out["it"] == base.it
    np.testing.assert_array_equal(out["cv"], np.asarray(base.cv))
    np.testing.assert_allclose(out["rp"], np.asarray(base.rp), atol=2e-5)
    for o in ranks[p][1:]:
        np.testing.assert_array_equal(o["simplex"]["cv"], out["cv"])
        np.testing.assert_array_equal(o["simplex"]["rp"], out["rp"])
    again = ranks[p][0]["simplex_restart"]
    assert again["it"] <= 2
    np.testing.assert_array_equal(again["cv"], out["cv"])


@pytest.mark.parametrize("p", SHARDS)
def test_cp_sharded_staged_reduced_solve(ranks, p):
    """Without the native C++ the reduced problems go to the staged PFDR
    loop: the same partition, values within float32 tolerance of the
    native float64 solves."""
    out = ranks[p][0]
    native, staged = out["identity"], out["identity_staged"]
    np.testing.assert_array_equal(staged["cv"], native["cv"])
    np.testing.assert_allclose(staged["rx"], native["rx"], atol=2e-5)


@pytest.mark.parametrize("p", SHARDS)
def test_cp_sharded_simplex_staged_reduced_solve(ranks, p):
    """Without the native C++ the multi-label reduced problems go to the
    staged loop, padded to ``bucket`` sizes.  Its float32 solves and the
    native float64 ones may merge knife-edge components differently, so
    the contract is the JAX tests' for paths of different precisions: the
    objective within 1e-3 and at least 98 % of the labels the same."""
    _, g64, q = jax_simplex()

    def objective(pv):
        pv = jnp.asarray(np.asarray(pv, np.float64))
        return float(loss_objective(0.5, pv, jnp.asarray(q, jnp.float64),
                                    None) + d1_objective(g64, pv))

    out = ranks[p][0]
    native, staged = out["simplex"], out["simplex_staged"]
    p_n = native["rp"][native["cv"]]
    p_s = staged["rp"][staged["cv"]]
    assert objective(p_s) <= objective(p_n) * (1 + 1e-3)
    assert (np.argmax(p_s, 1) == np.argmax(p_n, 1)).mean() >= 0.98
