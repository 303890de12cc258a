"""Port's host-route ``cp_quadratic_d1`` against the JAX package, on the
CPU in float64: a 12 x 12 grid with a dense 16-row ``A``.

Solutions are compared at 1e-6 (as ``tests/test_stencil.py`` compares the
two JAX containers' cut-pursuit solutions) and objectives at 1e-9
relative.  The JAX side runs on the CPU, where its reduced solves take the
staged loop; the port runs its staged loop, the ``solve_small`` route
(kernel's plain version on the CPU) or the native host route.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_pfdr_graph_d1_tpu as J
import cp_pfdr_graph_d1_tpu_torch as T
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import \
    cp_quadratic_d1 as jax_cp
from cp_pfdr_graph_d1_tpu_torch import convert
from cp_pfdr_graph_d1_tpu_torch.ops import solve_small
from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit import \
    cp_quadratic_d1 as torch_cp

torch.set_num_threads(1)

H = W = 12


def problem(seed=0, n=16):
    r = np.random.default_rng(seed)
    idx = np.arange(H * W).reshape(H, W)
    eu = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    ev = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    la = 0.05 * (0.5 + r.random(eu.shape[0]))
    a = r.normal(size=(n, H * W)) / 4.0
    x_true = np.zeros((H, W))
    x_true[2:6, 3:8] = 1.0
    x_true[7:11, 1:5] = 0.6
    y = a @ x_true.ravel() + 0.02 * r.normal(size=n)
    return eu.astype(np.int32), ev.astype(np.int32), la, a, y


def objective(x, a, y, eu, ev, la, la_l1):
    r = a @ x - y
    obj = 0.5 * r @ r + np.sum(la * np.abs(x[eu] - x[ev]))
    return obj + (0.0 if la_l1 is None else np.sum(la_l1 * np.abs(x)))


# the intermediate reduced solves are capped at 300 iterations (inexact
# outer loop) and the settled partition is polished at full accuracy
JAX_OPT = J.CPOptions(dif_tol=1e-4, it_max=8, inexact_cap=300,
                      pfdr=J.PFDROptions(rho=1.5, dif_tol=1e-6, it_max=1000))


def port_opt(fused="auto", host_small="auto"):
    opt = convert.cp_options(dataclasses.asdict(JAX_OPT))
    return dataclasses.replace(
        opt, host_small=host_small,
        pfdr=dataclasses.replace(opt.pfdr, fused=fused))


def run_both(family, route, duplex=False, seed=0):
    eu, ev, la, a, y = problem(seed)
    v = H * W
    kw = {}
    la_l1 = None
    if family == "l1pos":
        la_l1 = np.full(v, 0.01)
        kw = dict(la_l1=la_l1, positivity=True)
    elif family == "l1":
        la_l1 = np.full(v, 0.01)
        kw = dict(la_l1=la_l1)
    else:
        kw = dict(bounds=(0.0, 0.8))
    jopt = JAX_OPT if route != "host" else dataclasses.replace(
        JAX_OPT, host_small="on")
    res_j = jax_cp(J.DenseOp(jnp.asarray(a)), jnp.asarray(y),
                   J.GraphD1.create(eu, ev, la, num_vertices=v,
                                    dtype=jnp.float64),
                   duplex=duplex, opt=jopt, **kw)
    topt = {"staged": port_opt(), "small": port_opt(fused="on"),
            "host": port_opt(host_small="on")}[route]
    launches = solve_small.fused_pfdr_solve_small.launches
    res_t = torch_cp(T.DenseOp(torch.from_numpy(a)), torch.from_numpy(y),
                     T.GraphD1.create(eu, ev, la, num_vertices=v,
                                      dtype=torch.float64, device="cpu"),
                     duplex=duplex, opt=topt, **kw)
    assert solve_small.fused_pfdr_solve_small.launches == launches
    x_j = res_j.rx[res_j.cv]
    x_t = res_t.rx[res_t.cv]
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-6)
    f_j = objective(x_j, a, y, eu, ev, la, la_l1)
    f_t = objective(x_t, a, y, eu, ev, la, la_l1)
    np.testing.assert_allclose(f_t, f_j, rtol=1e-9)
    return res_j, res_t


@pytest.mark.parametrize("family,route,duplex", [
    ("l1pos", "staged", False),
    ("l1pos", "small", False),
    ("l1", "small", True),
    ("bounds", "staged", False),
    ("l1pos", "host", False),
])
def test_cut_pursuit_matches_jax(family, route, duplex):
    res_j, res_t = run_both(family, route, duplex)
    assert len(res_t.rx) > 1  # the cuts split the grid


def test_cp_state_from_jax_resumes_in_port():
    """Two CP iterations in JAX, then the rest in the port from the
    converted ``CPState``, against the same resume in JAX."""
    eu, ev, la, a, y = problem(seed=0)
    v = H * W
    la_l1 = np.full(v, 0.01)
    jg = J.GraphD1.create(eu, ev, la, num_vertices=v, dtype=jnp.float64)
    op_j, y_j = J.DenseOp(jnp.asarray(a)), jnp.asarray(y)
    first = jax_cp(op_j, y_j, jg, la_l1=la_l1, positivity=True,
                   opt=dataclasses.replace(JAX_OPT, it_max=2))
    rest_j = jax_cp(op_j, y_j, jg, la_l1=la_l1, positivity=True,
                    opt=JAX_OPT, state=first.state)
    st = convert.cp_state(first.state.active, first.state.cv,
                          first.state.rx)
    rest_t = torch_cp(T.DenseOp(torch.from_numpy(a)), torch.from_numpy(y),
                      T.GraphD1.create(eu, ev, la, num_vertices=v,
                                       dtype=torch.float64, device="cpu"),
                      la_l1=la_l1, positivity=True, opt=port_opt(),
                      state=st)
    np.testing.assert_allclose(rest_t.rx[rest_t.cv], rest_j.rx[rest_j.cv],
                               rtol=0, atol=1e-6)
    assert rest_t.it == rest_j.it


@pytest.mark.parametrize("pfdr_kw,host_small", [
    (dict(fused="on", dif_rcd=1e-3), "on"),
    (dict(fused="on", verbose=10), "on"),
    (dict(fused="off"), "auto"),
])
def test_reduced_solves_reach_host_only_when_asked(monkeypatch, pfdr_kw,
                                                   host_small):
    """On the kernel route, PFDR options the kernel does not serve raise
    rather than moving the reduced solves to the native host PFDR; with
    host_small="auto" the native host PFDR is never called."""
    from cp_pfdr_graph_d1_tpu_torch import native

    def refuse(*args, **kwargs):
        raise AssertionError("the native host PFDR was called")

    monkeypatch.setattr(native, "pfdr_quadratic_d1_host", refuse)
    eu, ev, la, a, y = problem(seed=0)
    v = H * W
    opt = port_opt(host_small=host_small)
    opt = dataclasses.replace(opt, it_max=2,
                              pfdr=dataclasses.replace(opt.pfdr, **pfdr_kw))

    def run():
        return torch_cp(T.DenseOp(torch.from_numpy(a)), torch.from_numpy(y),
                        T.GraphD1.create(eu, ev, la, num_vertices=v,
                                         dtype=torch.float64, device="cpu"),
                        la_l1=np.full(v, 0.01), positivity=True, opt=opt)

    if pfdr_kw["fused"] == "on":
        name = next(k for k in pfdr_kw if k != "fused")
        with pytest.raises(NotImplementedError, match=name):
            run()
    else:
        assert run().it == 2
