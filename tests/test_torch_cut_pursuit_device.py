"""Port's ``cut="device"`` cut-pursuit against the JAX package, on the CPU
in float64: the per-iteration device loop (``chain="off"``) and the chained
loop (``chain="on"``, where the JAX package runs its Pallas kernels in
interpret mode, on 12 x 16 fields).

Objectives are compared at 1e-6 relative with equal CP iteration counts;
the chained loop also stays within 1e-3 of the host route's objective, the
bound of ``tests/test_cut_pursuit_chain.py``.  On CPU tensors no kernel is
launched: every wrapper runs its plain version.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_pfdr_graph_d1_tpu as J
from cp_pfdr_graph_d1_tpu.graph import GraphD1 as JGraph
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import \
    cp_quadratic_d1 as jax_cp
from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1 as JStencil
import cp_pfdr_graph_d1_tpu_torch as T
from cp_pfdr_graph_d1_tpu_torch import convert
from cp_pfdr_graph_d1_tpu_torch.ops import (components_fused, mincut_fused,
                                            solve_fused, solve_small,
                                            stencil_fused)
from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit import \
    cp_quadratic_d1 as torch_cp

torch.set_num_threads(1)

PF = J.PFDROptions(rho=1.5, dif_tol=1e-7, it_max=4000)


def counters():
    return (mincut_fused.fused_pdhg_min_cut.launches,
            components_fused.fused_components.launches,
            stencil_fused.fused_stencil_iteration.launches,
            solve_small.fused_pfdr_solve_small.launches,
            solve_fused.fused_pfdr_solve.launches)


def lasso_problem(h, w, n=24, seed=0):
    """``tests/test_cut_pursuit_chain.py``'s grid fused LASSO, float64."""
    r = np.random.default_rng(seed)
    idx = np.arange(h * w).reshape(h, w)
    a = r.normal(size=(n, h * w)) / np.sqrt(n)
    x_true = np.zeros(h * w)
    x_true[idx[4:8, 4:8].ravel()] = 2.0
    return a, a @ x_true + 0.02 * r.normal(size=n)


def denoise_problem(side=24, seed=1):
    r = np.random.default_rng(seed)
    xt = np.zeros((side, side))
    xt[4:12, 4:12] = 1.0
    xt[14:20, 10:20] = -0.7
    return (xt + 0.4 * r.standard_normal((side, side))).ravel()


def graphs(h, w, weight, container="stencil"):
    """The same graph in both packages: a stencil, or its COO view."""
    gj = JStencil.create((h, w), {(0, 1): weight, (1, 0): weight},
                         dtype=jnp.float64)
    if container == "stencil":
        return gj, T.StencilGraphD1.create(
            (h, w), {(0, 1): weight, (1, 0): weight}, dtype=torch.float64,
            device="cpu")
    keep = np.asarray(gj.la_d1) > 0
    eu, ev = np.asarray(gj.eu)[keep], np.asarray(gj.ev)[keep]
    la = np.asarray(gj.la_d1)[keep]
    return (JGraph.create(eu, ev, la, num_vertices=h * w, dtype=jnp.float64),
            T.GraphD1.create(eu, ev, la, num_vertices=h * w,
                             dtype=torch.float64, device="cpu"))


def objective(res, a, y, gt, la_l1=None):
    x = res.rx[res.cv].astype(np.float64)
    eu, ev, la = gt.host_coo()
    quad = (0.5 * np.sum((a @ x - y) ** 2) if a is not None
            else 0.5 * np.sum((x - y) ** 2))
    obj = quad + np.sum(la * np.abs(x[eu] - x[ev]))
    return obj + (0.0 if la_l1 is None else np.sum(la_l1 * np.abs(x)))


def run_both(gj, gt, a, y, jopt, state=None, **kw):
    """(JAX result, port result) of one solve with the same options."""
    if a is None:
        jop, top = J.IdentityOp(), T.IdentityOp()
    else:
        jop, top = J.DenseOp(jnp.asarray(a)), T.DenseOp(torch.from_numpy(a))
    res_j = jax_cp(jop, jnp.asarray(y), gj, opt=jopt, state=state, **kw)
    topt = convert.cp_options(dataclasses.asdict(jopt))
    tstate = None if state is None else convert.cp_state(
        *(np.asarray(v) for v in state))
    res_t = torch_cp(top, torch.from_numpy(y), gt, opt=topt, state=tstate,
                     **kw)
    return res_j, res_t


@pytest.mark.parametrize("case", ["lasso-stencil", "lasso-coo-kernels",
                                  "denoise-stencil"])
def test_device_loop_matches_jax(case):
    before = counters()
    if case.startswith("lasso"):
        h = w = 16
        a, y = lasso_problem(h, w)
        la_l1 = np.full(h * w, 0.03)
        kw = dict(la_l1=la_l1, positivity=True)
        gj, gt = graphs(h, w, 0.1, case.split("-")[1])
    else:
        h = w = 24
        a, y, la_l1, kw = None, denoise_problem(), None, {}
        gj, gt = graphs(h, w, 0.15)
    # "kernels": the reduced solves take the whole-solve kernels' plain
    # versions instead of the staged loop
    pf = dataclasses.replace(PF, fused="on" if "kernels" in case else "auto")
    jopt = J.CPOptions(dif_tol=1e-5, it_max=10, pfdr=pf, cut="device",
                       chain="off", cut_it_max=20_000)
    res_j, res_t = run_both(gj, gt, a, y, jopt, **kw)
    assert res_t.it == res_j.it
    f_j = objective(res_j, a, y, gt, la_l1)
    f_t = objective(res_t, a, y, gt, la_l1)
    assert abs(f_t - f_j) <= 1e-6 * abs(f_j)
    np.testing.assert_allclose(res_t.dif, np.asarray(res_j.dif), rtol=1e-5,
                               atol=1e-12)
    assert counters() == before


@pytest.mark.parametrize("cut_it_max,host", [(128, False), (1, True)],
                         ids=["continue", "host"])
def test_uncertified_cut_continues_then_falls_back(cut_it_max, host,
                                                   monkeypatch):
    """The per-iteration device loop on CPU tensors: a steepest cut that
    misses its certificate within ``cut_it_max`` steps continues from its
    own iterates for up to ``CONTINUE_FACTOR`` times as many; only what is
    still uncertified is redone on the host, with a warning.  Both reach
    the host route's solution."""
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit_device as cpd
    y = torch.from_numpy(denoise_problem())
    _, gt = graphs(24, 24, 0.15)
    caps = []
    device_cut = cpd.device_cut

    def recording(*args):
        caps.append(args[4])
        return device_cut(*args)

    monkeypatch.setattr(cpd, "device_cut", recording)
    pf = T.PFDROptions(rho=1.5, dif_tol=1e-7, it_max=4000)
    opt = T.CPOptions(dif_tol=1e-5, it_max=10, pfdr=pf, cut="device",
                      chain="off", cut_it_max=cut_it_max)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = torch_cp(T.IdentityOp(), y, gt, opt=opt)
    fell_back = [w for w in caught if "falling back" in str(w.message)]
    assert bool(fell_back) == host
    assert cpd.CONTINUE_FACTOR * cut_it_max in caps
    base = torch_cp(T.IdentityOp(), y, gt,
                    opt=dataclasses.replace(opt, cut="host"))
    assert res.it == base.it
    np.testing.assert_allclose(res.rx[res.cv], base.rx[base.cv], rtol=0,
                               atol=1e-9)


def host_objective(gt, a, y, opt, **kw):
    res = torch_cp(T.DenseOp(torch.from_numpy(a)), torch.from_numpy(y), gt,
                   opt=dataclasses.replace(opt, cut="host", chain="off"),
                   **kw)
    return res


@pytest.mark.parametrize("family,init", [("l1pos", 600), ("bounds", 300),
                                         ("l1pos", 0)])
def test_chain_matches_jax_chain(family, init):
    h, w = 12, 16
    a, y = lasso_problem(h, w, seed=2)
    if family == "l1pos":
        la_l1 = np.full(h * w, 0.03)
        kw = dict(la_l1=la_l1, positivity=True)
    else:
        la_l1, kw = None, dict(bounds=(-0.5, 1.5))
    gj, gt = graphs(h, w, 0.1)
    jopt = J.CPOptions(dif_tol=1e-5, it_max=10, pfdr=PF, cut="device",
                       chain="on", cut_it_max=5000, chain_init_pfdr=init)
    before = counters()
    res_j, res_t = run_both(gj, gt, a, y, jopt, **kw)
    assert counters() == before
    assert res_t.it == res_j.it
    assert res_t.obj.shape == (0,) and res_t.time.shape == (res_t.it + 1,)
    f_j = objective(res_j, a, y, gt, la_l1)
    f_t = objective(res_t, a, y, gt, la_l1)
    assert abs(f_t - f_j) <= 1e-6 * abs(f_j)
    f_h = objective(host_objective(gt, a, y, convert.cp_options(
        dataclasses.asdict(jopt)), **kw), a, y, gt, la_l1)
    assert f_t <= f_h * (1 + 1e-3) + 1e-9
    if family == "bounds":
        x = res_t.rx[res_t.cv]
        assert x.min() >= -0.5 - 1e-9 and x.max() <= 1.5 + 1e-9


def test_chain_warm_restart_from_jax_state():
    """A JAX chain stopped after two iterations resumes in both packages
    from its ``CPState`` to the same objective."""
    h, w = 12, 16
    a, y = lasso_problem(h, w, seed=5)
    la_l1 = np.full(h * w, 0.03)
    kw = dict(la_l1=la_l1, positivity=True)
    gj, gt = graphs(h, w, 0.1)
    short = J.CPOptions(dif_tol=1e-6, it_max=2, pfdr=PF, cut="device",
                        chain="on", cut_it_max=5000, chain_init_pfdr=0)
    part = jax_cp(J.DenseOp(jnp.asarray(a)), jnp.asarray(y), gj, opt=short,
                  **kw)
    res_j, res_t = run_both(gj, gt, a, y,
                            dataclasses.replace(short, it_max=10),
                            state=part.state, **kw)
    assert res_t.it == res_j.it
    f_j = objective(res_j, a, y, gt, la_l1)
    assert abs(objective(res_t, a, y, gt, la_l1) - f_j) <= 1e-6 * abs(f_j)


def test_chain_cap_follows_solve_small_fit(monkeypatch):
    """The chain caps an intermediate reduced solve by whether the problem
    fits ``solve_small`` (as the JAX chain caps its small-kernel and banded
    routes), not by which kernel runs it: moving every solve to
    ``solve_fused`` keeps the caps and the result."""
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit as tcp
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit_chain as tch
    h, w = 12, 16
    a, y = lasso_problem(h, w, seed=2)
    la_l1 = np.full(h * w, 0.03)
    _, gt = graphs(h, w, 0.1)
    opt = T.CPOptions(dif_tol=1e-5, it_max=10, cut="device", chain="on",
                      cut_it_max=5000, chain_init_pfdr=0, inexact_cap=300,
                      pfdr=T.PFDROptions(rho=1.5, dif_tol=1e-9, it_max=4000))
    monkeypatch.setattr(tch, "_FUSED_INNER_CAP", 100)
    caps = []
    kernel_solve = tcp._kernel_solve
    monkeypatch.setattr(tcp, "_kernel_solve", lambda *args, **kw: (
        caps.append(args[8]), kernel_solve(*args, **kw))[1])

    def solve():
        caps.clear()
        res = torch_cp(T.DenseOp(torch.from_numpy(a)), torch.from_numpy(y),
                       gt, la_l1=la_l1, positivity=True, opt=opt)
        return res, objective(res, a, y, gt, la_l1), caps[:]

    res_s, f_s, caps_s = solve()
    assert set(caps_s[:-1]) == {300} and caps_s[-1] == 4000
    monkeypatch.setattr(tcp, "SOLVE_FUSED_MIN_RV_CAP",
                        dict.fromkeys(tcp.SOLVE_FUSED_MIN_RV_CAP, 1))
    res_f, f_f, caps_f = solve()
    assert caps_f == caps_s and res_f.it == res_s.it
    assert abs(f_f - f_s) <= 1e-9 * abs(f_s)
    monkeypatch.setattr(tcp, "fits", lambda *args: False)
    _, _, caps_big = solve()
    assert set(caps_big[:-1]) == {100} and caps_big[-1] == 4000


def test_duplex_device_cut_raises():
    """Formerly the assertion that ``duplex=True`` with ``cut="device"``
    raised; the duplex device cut is ported, so the route now solves, and
    its objective matches the JAX duplex device loop's within 5e-7
    relative, in float64 on a stencil."""
    h = w = 6
    a, y = lasso_problem(h, w, n=8)
    gj, gt = graphs(h, w, 0.1)
    la_l1 = np.full(h * w, 0.01)
    jopt = J.CPOptions(dif_tol=1e-5, it_max=8, pfdr=PF, cut="device")
    res_j, res_t = run_both(gj, gt, a, y, jopt, la_l1=la_l1, duplex=True)
    f_j = objective(res_j, a, y, gt, la_l1)
    f_t = objective(res_t, a, y, gt, la_l1)
    assert res_t.it == res_j.it
    assert abs(f_t - f_j) <= 5e-7 * abs(f_j)
