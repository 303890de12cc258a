"""Port's multi-label cut-pursuit against the JAX package, on the CPU in
float64: the host-cut route, the device loop on a COO graph and on a
stencil graph (cuts and components through the kernels' plain versions),
label-count stopping with restart, the host fallback of the certificate,
the native host route, ``device_obs``, a restart from a JAX state, and
both ``api`` entries; and, against the host push-relabel, the continuation
of an uncertified cut on the device.

Maximum-likelihood labelings must be equal and ``rp[cv]`` within 1e-6 (the
JAX package's own tolerance between its routes,
``tests/test_cut_pursuit_simplex.py``).
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_pfdr_graph_d1_tpu as J
import cp_pfdr_graph_d1_tpu_torch as T
from cp_pfdr_graph_d1_tpu import api as japi
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_simplex import \
    cp_loss_d1_simplex as jcp
from cp_pfdr_graph_d1_tpu_torch import api as tapi
from cp_pfdr_graph_d1_tpu_torch import convert
from cp_pfdr_graph_d1_tpu_torch.ops import (components_fused, mincut_fused,
                                            stencil_fused_simplex)
from cp_pfdr_graph_d1_tpu_torch.solvers import \
    cut_pursuit_simplex_device as csd

from .test_cut_pursuit_simplex import make_problem

torch.set_num_threads(1)

PFDR = dict(rho=1.2, dif_tol=1e-9, it_max=8000)


def coo_graphs(eu, ev, la, v):
    jg = J.GraphD1.create(eu, ev, la, num_vertices=v, dtype=jnp.float64)
    tg = convert.graph(np.asarray(jg.eu), np.asarray(jg.ev),
                       np.asarray(jg.la_d1), v, device="cpu")
    return jg, tg


def run_both(jg, tg, q, al, state=None, tstate=None, device_obs=False,
             **opt):
    jopt = J.CPOptions(pfdr=J.PFDROptions(**PFDR), **opt)
    topt = convert.cp_options(dataclasses.asdict(jopt))
    rj = jcp(jg, jnp.asarray(q), al=al, opt=jopt, state=state,
             device_obs=device_obs)
    rt = T.cp_loss_d1_simplex(tg, torch.from_numpy(q), al=al, opt=topt,
                              state=tstate, device_obs=device_obs)
    return rj, rt


def full(res):
    """``p = rp[cv]`` of a solver result or an ``api`` output."""
    if hasattr(res, "rX"):
        return np.asarray(res.rX)[np.asarray(res.Cv)]
    return np.asarray(res.rp)[np.asarray(res.cv)]


def assert_same(rt, rj, atol=1e-6):
    pt, pj = full(rt), full(rj)
    np.testing.assert_array_equal(pt.argmax(1), pj.argmax(1))
    np.testing.assert_allclose(pt, pj, rtol=0, atol=atol)


@pytest.mark.parametrize("cut", ["host", "device"])
@pytest.mark.parametrize("al", [0.0, 1.0, 0.3])
def test_routes_match_jax_on_coo(al, cut):
    eu, ev, la, q, _ = make_problem(seed=11)
    jg, tg = coo_graphs(eu, ev, la, len(q))
    rj, rt = run_both(jg, tg, q, al, dif_tol=1e-4, it_max=8, cut=cut,
                      host_small="off")
    assert rt.it == rj.it
    assert_same(rt, rj)


@pytest.mark.parametrize("al", [1.0, 0.3])
def test_device_loop_on_stencil_matches_jax(al):
    """The device loop on a stencil graph: cuts through ``mincut_fused``'s
    wrapper and components through ``components_fused``'s (their plain
    versions on the CPU, no launch), against the JAX device loop on its
    stencil container."""
    h, w = 10, 9
    r = np.random.default_rng(31)
    weights = {(0, 1): r.uniform(0.15, 0.45, (h, w)),
               (1, 0): r.uniform(0.15, 0.45, (h, w))}
    jsg = J.StencilGraphD1.create((h, w), weights, dtype=jnp.float64)
    tsg = convert.stencil_graph(np.asarray(jsg.la_d1), jsg.field_shape,
                                jsg.shifts, jsg.wrap, device="cpu")
    _, _, _, q, _ = make_problem(h=h, w=w, seed=12)
    counts = (mincut_fused.fused_pdhg_min_cut.launches,
              components_fused.fused_components.launches)
    rj, rt = run_both(jsg, tsg, q, al, dif_tol=1e-4, it_max=8, cut="device",
                      verbose=1)
    assert counts == (mincut_fused.fused_pdhg_min_cut.launches,
                      components_fused.fused_components.launches)
    assert rt.it == rj.it and len(rt.rp) > 1
    assert_same(rt, rj)


def test_label_mode_and_restart():
    """Label-count stopping on the device loop, a restart from the port's
    own state, and a restart of the port from a JAX state, against JAX."""
    eu, ev, la, q, _ = make_problem(seed=13)
    jg, tg = coo_graphs(eu, ev, la, len(q))
    kw = dict(dif_tol=1.0, cut="device")
    full_j, full_t = run_both(jg, tg, q, 1.0, it_max=10, **kw)
    assert full_t.it == full_j.it
    assert_same(full_t, full_j)
    part_j, part_t = run_both(jg, tg, q, 1.0, it_max=2, **kw)
    st_j = convert.cp_simplex_state(part_j.state.active, part_j.state.cv,
                                    part_j.state.rp)
    rest_j, rest_t = run_both(jg, tg, q, 1.0, state=part_j.state,
                              tstate=part_t.state, it_max=10, **kw)
    np.testing.assert_array_equal(rest_t.rp[rest_t.cv].argmax(1),
                                  full_t.rp[full_t.cv].argmax(1))
    assert_same(rest_t, rest_j)
    topt = convert.cp_options(dataclasses.asdict(
        J.CPOptions(pfdr=J.PFDROptions(**PFDR), it_max=10, **kw)))
    from_j = T.cp_loss_d1_simplex(tg, torch.from_numpy(q), al=1.0, opt=topt,
                                  state=st_j)
    assert_same(from_j, rest_j, atol=1e-10)


def test_uncertified_cuts_fall_back_to_host():
    """A starved PDHG budget warns, redoes the expansion cuts on the host
    push-relabel and still reaches the host route's solution."""
    eu, ev, la, q, _ = make_problem(seed=15)
    jg, tg = coo_graphs(eu, ev, la, len(q))
    jopt = J.CPOptions(dif_tol=1e-4, it_max=8, pfdr=J.PFDROptions(**PFDR),
                       cut="host", host_small="off")
    base = jcp(jg, jnp.asarray(q), al=1.0, opt=jopt)
    topt = convert.cp_options(dataclasses.asdict(
        dataclasses.replace(jopt, cut="device", cut_it_max=1)))
    with pytest.warns(UserWarning, match="falling back"):
        res = T.cp_loss_d1_simplex(tg, torch.from_numpy(q), al=1.0,
                                   opt=topt)
    assert_same(res, base)


def test_uncertified_cut_continues_on_the_device():
    """On a stencil graph an expansion cut that misses its certificate
    within ``cut_it_max`` steps continues from its own iterates, and the
    cuts after it are solved again, without the host: the separating
    edges equal the host push-relabel's, and ``record`` holds the inputs
    of both passes, the second warm-started from the first."""
    h, w = 8, 8
    r = np.random.default_rng(31)
    weights = {(0, 1): r.uniform(0.15, 0.45, (h, w)),
               (1, 0): r.uniform(0.15, 0.45, (h, w))}
    g = T.StencilGraphD1.create((h, w), weights, dtype=torch.float64,
                                device="cpu")
    _, _, _, q_np, _ = make_problem(h=h, w=w, seed=12)
    q = torch.as_tensor(q_np)
    k = q.shape[1]
    active = torch.zeros(g.num_edges, dtype=torch.bool)
    cv = torch.zeros(h * w, dtype=torch.int32)
    p_full = q.mean(dim=0, keepdim=True).expand(h * w, k)
    eps = 1e-9
    dfs = csd._direction_costs_simplex(g, q, p_full, active, 1.0, eps)
    rdi = torch.argmax(p_full[:1], dim=1).to(torch.int32)
    opt = T.CPOptions(cut="device", cut_tol=1e-6, cut_it_max=8)
    record = []
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sep, n_new, steps, continued = csd._certified_expansion(
            g, dfs, rdi, cv, active, opt, {}, eps, record)
    assert continued == list(range(1, k))
    assert all(8 < s <= (1 + csd.CONTINUE_FACTOR) * 8 for s in steps)
    assert [key for _, *key, _ in record] == 2 * [[0, n] for n in range(1, k)]
    first_x0, again_x0 = record[0][3][4], record[k - 1][3][4]
    assert bool((first_x0 == 0.5).all()) and not bool((again_x0 == 0.5).all())
    host = csd._host_expansion_fallback(g, dfs, rdi, cv, active, eps)
    assert n_new > 0
    assert torch.equal(sep, csd._separating(g, host, active))


@pytest.mark.parametrize("variant", ["native", "device_obs"])
def test_host_variants_match_jax(variant):
    """``host_small="on"`` (the native C++ multi-label PFDR) and
    ``device_obs=True`` (observation stages on the tensors' device, host
    cut), against the same options in JAX."""
    eu, ev, la, q, _ = make_problem(seed=17)
    jg, tg = coo_graphs(eu, ev, la, len(q))
    if variant == "native":
        rj, rt = run_both(jg, tg, q, 0.3, dif_tol=1e-4, it_max=8,
                          host_small="on")
    else:
        rj, rt = run_both(jg, tg, q, 0.3, device_obs=True, dif_tol=1e-4,
                          it_max=8, host_small="off")
    assert rt.it == rj.it
    assert_same(rt, rj)


def test_inexact_cap_and_polish():
    """An inexact cap below the PFDR budget: capped intermediate solves and
    the final polish, as in JAX."""
    eu, ev, la, q, _ = make_problem(seed=19)
    jg, tg = coo_graphs(eu, ev, la, len(q))
    rj, rt = run_both(jg, tg, q, 1.0, dif_tol=1e-4, it_max=6,
                      inexact_cap=40, host_small="off")
    assert rt.it == rj.it
    assert_same(rt, rj)


def test_api_entries_match_jax():
    eu, ev, la, q, _ = make_problem(seed=21)
    kw = dict(CP_difTol=1e-4, CP_itMax=6, PFDR_rho=1.2, PFDR_difTol=1e-8,
              PFDR_itMax=5000)
    out_j = japi.cp_loss_d1_simplex(q, 0.3, eu, ev, la, **kw, monitor=True)
    out_t = tapi.cp_loss_d1_simplex(q, 0.3, eu, ev, la, **kw, monitor=True,
                                    device="cpu")
    assert out_t.it == out_j.it
    assert_same(out_t, out_j)
    np.testing.assert_allclose(out_t.Obj, out_j.Obj, rtol=1e-8)

    laf = np.random.default_rng(22).uniform(0.5, 1.5, len(q))
    pkw = dict(PFDR_rho=1.3, PFDR_difTol=1e-9, PFDR_itMax=400, monitor=True)
    pj = japi.pfdr_loss_d1_simplex_api(q, 1.0, eu, ev, la, La_f=laf, **pkw)
    launches = stencil_fused_simplex.fused_stencil_simplex_iteration.launches
    pt = tapi.pfdr_loss_d1_simplex_api(q, 1.0, eu, ev, la, La_f=laf, **pkw,
                                       device="cpu")
    assert (stencil_fused_simplex.fused_stencil_simplex_iteration.launches
            == launches)
    assert pt.it == pj.it
    np.testing.assert_allclose(pt.X.numpy(), pj.X, rtol=0, atol=1e-10)
    np.testing.assert_allclose(pt.Obj.numpy(), pj.Obj, rtol=1e-10)
    np.testing.assert_allclose(pt.Dif.numpy(), pj.Dif, rtol=1e-8, atol=1e-14)
