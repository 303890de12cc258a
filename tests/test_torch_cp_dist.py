"""The port's distributed cut-pursuit (``parallel.cp_dist``) against the JAX
package.

The port runs in gloo ranks on the CPU, spawned once for this module at
P = 2 and at P = 4 (``_torch_ranks.cp_dist_cases``); the JAX side runs
here.  Tolerances are the JAX tests' (``tests/test_parallel.py:242-330``):
the same components ``cv`` and ``rx`` within ``rtol=1e-9``.  N = 91
exercises the observation axis' zero padding at both ring sizes.

``cut="device"`` with the sharded operator (the per-iteration device loop
and the chained loop) is held against the JAX package's single-device
``cut="device"`` solve, as the JAX ``cp_quadratic_d1_dist`` passes the
option through: the same iterations and ``cv``, ``rx[cv]`` within the
``atol=1e-9`` of ``tests/test_torch_cut_pursuit_device.py``, and every
rank with the same ``cv`` and ``rx``.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from cp_pfdr_graph_d1_tpu import (CPOptions, DenseOp, GraphD1, GramOp,
                                  PFDROptions)
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import cp_quadratic_d1
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_simplex import \
    cp_loss_d1_simplex
from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1

from . import _torch_ranks as tr

SHARDS = (2, 4)


@pytest.fixture(scope="module")
def ranks():
    return tr.spawn_rings(tr.cp_dist_cases, SHARDS)


def _graph(eu, ev, la):
    return GraphD1.create(eu, ev, la, dtype=jnp.float64)


@functools.lru_cache(maxsize=None)
def jax_dense():
    eu, ev, la, a, y = tr.cp_problem()
    opt = CPOptions(dif_tol=1e-5, it_max=10,
                    pfdr=PFDROptions(rho=1.5, dif_tol=1e-9, it_max=5000))
    return cp_quadratic_d1(
        DenseOp(jnp.asarray(a)), jnp.asarray(y), _graph(eu, ev, la),
        la_l1=np.full(a.shape[1], 0.02),
        opt=dataclasses.replace(opt, host_small="off"), monitor=True)


def _opt8():
    return CPOptions(dif_tol=1e-5, it_max=8, host_small="off",
                     pfdr=PFDROptions(dif_tol=1e-9, it_max=5000))


@functools.lru_cache(maxsize=None)
def jax_duplex():
    eu, ev, la, a, y = tr.cp_problem(seed=5)
    return cp_quadratic_d1(
        DenseOp(jnp.asarray(a)), jnp.asarray(y), _graph(eu, ev, la),
        la_l1=np.full(a.shape[1], 0.05), positivity=True, duplex=True,
        opt=_opt8())


@functools.lru_cache(maxsize=None)
def jax_gram():
    eu, ev, la, a, y = tr.cp_problem(n=128, seed=7)
    return cp_quadratic_d1(GramOp(jnp.asarray(a.T @ a)),
                           jnp.asarray(a.T @ y), _graph(eu, ev, la),
                           la_l1=np.full(a.shape[1], 0.02), opt=_opt8())


def _same_on_every_rank(outs, case):
    for o in outs[1:]:
        np.testing.assert_array_equal(o[case]["cv"], outs[0][case]["cv"])
        np.testing.assert_array_equal(o[case]["rx"], outs[0][case]["rx"])


@pytest.mark.parametrize("p", SHARDS)
def test_cp_dist_dense_matches_jax(ranks, p):
    """Observation-sharded dense operator, as
    ``test_cp_dist_dense_matches_single_device``: same iterations, same
    partition, values and objective trace within 1e-9 relative."""
    base = jax_dense()
    out = ranks[p][0]["dense"]
    assert out["it"] == base.it
    np.testing.assert_array_equal(out["cv"], np.asarray(base.cv))
    np.testing.assert_allclose(out["rx"], np.asarray(base.rx), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(out["obj"], base.obj, rtol=1e-9)
    _same_on_every_rank(ranks[p], "dense")


@pytest.mark.parametrize("p", SHARDS)
def test_cp_dist_dense_positivity_duplex(ranks, p):
    """Positivity and the duplex cut, as
    ``test_cp_dist_dense_positivity_duplex``."""
    base = jax_duplex()
    out = ranks[p][0]["duplex"]
    np.testing.assert_allclose(out["rx"][out["cv"]],
                               np.asarray(base.rx)[np.asarray(base.cv)],
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("p", SHARDS)
def test_cp_dist_gram_matches_jax(ranks, p):
    """Row-sharded Gram operator, as
    ``test_cp_dist_gram_matches_single_device``."""
    base = jax_gram()
    out = ranks[p][0]["gram"]
    np.testing.assert_array_equal(out["cv"], np.asarray(base.cv))
    np.testing.assert_allclose(out["rx"], np.asarray(base.rx), rtol=1e-9,
                               atol=1e-12)
    _same_on_every_rank(ranks[p], "gram")


@pytest.mark.parametrize("p", SHARDS)
def test_cp_dist_gram_indivisible_raises(ranks, p):
    """A Gram operator whose vertex count the ranks do not divide raises,
    as ``test_cp_dist_gram_indivisible_raises``."""
    assert "divisible" in ranks[p][0]["gram_indivisible"]


@pytest.mark.parametrize("p", SHARDS)
def test_cp_dist_operator_is_sharded(ranks, p):
    """Each rank holds one zero-padded row block of the operator, not a
    replica, as ``test_cp_dist_operator_is_sharded``."""
    _, _, _, a, _ = tr.cp_problem()
    n_pad = -(-a.shape[0] // p) * p
    for r, o in enumerate(ranks[p]):
        pl = o["placement"]
        assert pl["num_obs"] == n_pad
        assert pl["rows"] == pl["obs"] == n_pad // p
        np.testing.assert_array_equal(pl["first"], a[r * (n_pad // p)])


@functools.lru_cache(maxsize=None)
def jax_simplex():
    eu, ev, la, q = tr.cp_simplex_problem()
    opt = CPOptions(dif_tol=1e-4, it_max=6, host_small="off",
                    pfdr=PFDROptions(rho=1.2, dif_tol=1e-7, it_max=2000))
    return cp_loss_d1_simplex(_graph(eu, ev, la), jnp.asarray(q), al=0.5,
                              opt=opt, monitor=True)


@pytest.mark.parametrize("p", SHARDS)
def test_cp_simplex_dist_matches_jax(ranks, p):
    """Row-sharded multi-label observation (the gradient gathered, the
    reduced sums summed over the ranks), as
    ``test_cp_simplex_dist_matches_single_device``."""
    base = jax_simplex()
    out = ranks[p][0]["simplex"]
    np.testing.assert_array_equal(out["cv"], np.asarray(base.cv))
    np.testing.assert_allclose(out["rp"], np.asarray(base.rp), atol=1e-10)
    np.testing.assert_allclose(out["obj"], base.obj, rtol=1e-9)
    for o in ranks[p][1:]:
        np.testing.assert_array_equal(o["simplex"]["rp"], out["rp"])


def _device_opt(chain, **kw):
    """``_torch_ranks.cp_dist_device_options`` in the JAX package."""
    return CPOptions(cut="device", chain=chain, host_small="off", **kw)


@functools.lru_cache(maxsize=None)
def jax_device(case):
    """The JAX package's single-device ``cut="device"`` solve of a case of
    ``_torch_ranks.cp_dist_device_cases``, float64."""
    if case in ("device_off", "device_on"):
        eu, ev, la, a, y = tr.cp_problem()
        chain = case.split("_")[1]
        g = (_graph(eu, ev, la) if chain == "off" else StencilGraphD1.create(
            (8, 8), tr.cp_stencil_weights(), dtype=jnp.float64))
        return cp_quadratic_d1(
            DenseOp(jnp.asarray(a)), jnp.asarray(y), g,
            la_l1=np.full(a.shape[1], 0.02),
            opt=_device_opt(chain, dif_tol=1e-5, it_max=10,
                            pfdr=PFDROptions(rho=1.5, dif_tol=1e-9,
                                             it_max=5000)))
    opt8 = _device_opt("off", dif_tol=1e-5, it_max=8,
                       pfdr=PFDROptions(dif_tol=1e-9, it_max=5000))
    if case == "device_gram":
        eu, ev, la, a, y = tr.cp_problem(n=128, seed=7)
        return cp_quadratic_d1(GramOp(jnp.asarray(a.T @ a)),
                               jnp.asarray(a.T @ y), _graph(eu, ev, la),
                               la_l1=np.full(a.shape[1], 0.02), opt=opt8)
    eu, ev, la, a, y = tr.cp_problem(seed=5)
    return cp_quadratic_d1(
        DenseOp(jnp.asarray(a)), jnp.asarray(y), _graph(eu, ev, la),
        la_l1=np.full(a.shape[1], 0.05), positivity=True, duplex=True,
        opt=opt8)


DEVICE_CASES = ("device_off", "device_on", "device_gram", "device_duplex")


@pytest.mark.parametrize("case", DEVICE_CASES)
@pytest.mark.parametrize("p", SHARDS)
def test_cp_dist_device_cut_matches_jax(ranks, p, case):
    """``cut="device"`` with the operator sharded over the ranks: the dense
    operator through the per-iteration device loop (``device_off``) and the
    chained loop on the same graph as a stencil (``device_on``), the Gram
    operator, positivity with the duplex cut; against the JAX package's
    single-device device-cut solve."""
    base = jax_device(case)
    out = ranks[p][0][case]
    assert out["it"] == base.it
    np.testing.assert_array_equal(out["cv"], np.asarray(base.cv))
    np.testing.assert_allclose(out["rx"][out["cv"]],
                               np.asarray(base.rx)[np.asarray(base.cv)],
                               rtol=0, atol=1e-9)
    _same_on_every_rank(ranks[p], case)


@pytest.mark.parametrize("p", SHARDS)
def test_cp_dist_device_cut_runs_on_the_device(ranks, p):
    """``cut="device"`` with a sharded operator no longer raises: every
    rank runs the device cuts of each case."""
    for o in ranks[p]:
        for case in DEVICE_CASES:
            assert o[case]["cuts"] > 0, case


@pytest.mark.parametrize("name", [c[0] for c in tr.REDUCED_CASES]
                         + ["gram", "gram_beyond"])
@pytest.mark.parametrize("p", SHARDS)
def test_cp_dist_reduced_problem_matches_single_device(ranks, p, name):
    """``_reduced_problem`` of the sharded operator equals that of the whole
    operator on one device: the premultiplication choice, the reduced
    operator and observation (the padded observation rows are zero) and
    the Lipschitz metric, with one-hot products and with segment sums
    beyond a forced cap; the Gram operator beyond the cap raises the same
    error.  Every rank gets the same reduced problem."""
    out = ranks[p][0]["reduced"][name]
    dist, single = out["dist"], out["single"]
    if name == "gram_beyond":
        assert isinstance(single, str) and dist == single
        return
    assert dist[0] == single[0]
    assert dist[0] == ("GramOp" if name in ("premultiplied", "gram")
                       else "DenseOp")
    for d, s in zip(dist[1:], single[1:]):
        rows = s.shape[0]
        np.testing.assert_allclose(d[:rows], s, rtol=1e-12, atol=1e-15)
        assert not np.any(d[rows:])
    for o in ranks[p][1:]:
        for d, d0 in zip(o["reduced"][name]["dist"][1:], dist[1:]):
            np.testing.assert_array_equal(d, d0)
