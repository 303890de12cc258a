"""Port's multi-label ``pfdr_loss_d1_simplex`` (staged loop) against the JAX
package on a COO graph, on the CPU in float64: the three losses, label-count
stopping, reconditioning, monitor traces, resume, and a solve started in
JAX resumed in the port.

Iterates are compared at 1e-10 and iteration counts exactly: both packages
run the same operations, in other summation orders.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_pfdr_graph_d1_tpu as J
import cp_pfdr_graph_d1_tpu_torch as T
from cp_pfdr_graph_d1_tpu.solvers.pfdr_simplex import \
    pfdr_loss_d1_simplex as jpfdr
from cp_pfdr_graph_d1_tpu_torch import convert

from .conftest import make_grid_graph

torch.set_num_threads(1)

H, W, K = 9, 10, 4


def problem(seed=0):
    eu, ev, la = make_grid_graph(H, W, seed=seed, weight_scale=0.3)
    r = np.random.default_rng(seed + 100)
    v = H * W
    true = (np.arange(v) % W >= W // 2).astype(int) + 2 * (
        np.arange(v) // W >= H // 2)
    q = np.full((v, K), 0.05)
    q[np.arange(v), true] = 0.85
    q = 0.6 * q + 0.4 * r.dirichlet(np.ones(K), v)
    q /= q.sum(axis=1, keepdims=True)
    jg = J.GraphD1.create(eu, ev, la, num_vertices=v, dtype=jnp.float64)
    tg = convert.graph(np.asarray(jg.eu), np.asarray(jg.ev),
                       np.asarray(jg.la_d1), v, device="cpu")
    return jg, tg, q


def both(jg, tg, q, al, la_f=None, monitor=False, **opt):
    jopt = J.PFDROptions(**opt)
    topt = convert.pfdr_options(dataclasses.asdict(jopt))
    rj = jpfdr(jg, jnp.asarray(q), al=al,
               la_f=None if la_f is None else jnp.asarray(la_f),
               opt=jopt, monitor=monitor)
    rt = T.pfdr_loss_d1_simplex(
        tg, torch.from_numpy(q), al=al,
        la_f=None if la_f is None else torch.from_numpy(la_f), opt=topt,
        monitor=monitor)
    return rj, rt


@pytest.mark.parametrize("al,la_f", [(0.0, None), (1.0, "laf"), (0.3, None)],
                         ids=["linear", "quadratic-laf", "kl"])
def test_losses_match_jax(al, la_f):
    jg, tg, q = problem(seed=1)
    laf = (np.random.default_rng(2).uniform(0.5, 1.5, H * W)
           if la_f else None)
    rj, rt = both(jg, tg, q, al, laf, rho=1.3, dif_tol=1e-8, it_max=600)
    assert rt.it == int(rj.it)
    np.testing.assert_allclose(rt.p.numpy(), np.asarray(rj.p), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("mode", ["labels", "recondition", "monitor"])
def test_modes_match_jax(mode):
    jg, tg, q = problem(seed=3)
    al = 0.5
    kw = dict(rho=1.2, dif_tol=1e-7, it_max=500)
    if mode == "labels":
        kw["dif_tol"] = 1.0
    elif mode == "recondition":
        kw.update(dif_rcd=1e-3, cond_min=1e-2)
    rj, rt = both(jg, tg, q, al, monitor=mode == "monitor", **kw)
    it = rt.it
    assert it == int(rj.it)
    np.testing.assert_allclose(rt.p.numpy(), np.asarray(rj.p), rtol=0,
                               atol=1e-10)
    if mode == "monitor":
        assert rt.obj.shape == (kw["it_max"] + 1,)
        np.testing.assert_allclose(rt.obj[:it + 1].numpy(),
                                   np.asarray(rj.obj)[:it + 1], rtol=1e-10)
        np.testing.assert_allclose(rt.dif[:it].numpy(),
                                   np.asarray(rj.dif)[:it], rtol=1e-8,
                                   atol=1e-14)
        assert not rt.obj[it + 1:].any() and not rt.dif[it:].any()
    if mode == "labels":
        assert it < kw["it_max"]


def test_resume_is_bitwise_and_carries_over_from_jax():
    jg, tg, q = problem(seed=5)
    opt = T.PFDROptions(rho=1.4, dif_tol=0.0, it_max=240)
    q_t = torch.from_numpy(q)
    full = T.pfdr_loss_d1_simplex(tg, q_t, al=0.3, opt=opt)
    _, st = T.pfdr_loss_d1_simplex(
        tg, q_t, al=0.3, opt=dataclasses.replace(opt, it_max=100),
        return_state=True)
    resumed, st2 = T.pfdr_loss_d1_simplex(tg, q_t, al=0.3, opt=opt,
                                          state0=st, return_state=True)
    assert resumed.it == full.it == st2.it == 240
    assert torch.equal(resumed.p, full.p)

    # a solve started in JAX resumes in the port
    jopt = J.PFDROptions(rho=1.4, dif_tol=0.0, it_max=100)
    _, jst = jpfdr(jg, jnp.asarray(q), al=0.3, opt=jopt, return_state=True)
    jres = jpfdr(jg, jnp.asarray(q), al=0.3,
                 opt=dataclasses.replace(jopt, it_max=240), state0=jst)
    st_t = convert.simplex_solve_state(
        np.asarray(jst.p), np.asarray(jst.zu), np.asarray(jst.zv),
        [np.asarray(a) for a in jst.pre], np.asarray(jst.prev),
        np.asarray(jst.dif), np.asarray(jst.dif_rcd), jst.it, device="cpu")
    res_t = T.pfdr_loss_d1_simplex(tg, q_t, al=0.3, opt=opt, state0=st_t)
    assert res_t.it == int(jres.it) == 240
    np.testing.assert_allclose(res_t.p.numpy(), np.asarray(jres.p), rtol=0,
                               atol=1e-10)


def test_kernel_route_rules():
    """On a stencil graph the kernel route serves monitoring: with
    ``fused="on"`` (its plain version on the CPU) the traces equal the
    staged loop's; a K beyond the kernel raises; with ``fused="auto"`` CPU
    tensors run the staged loop."""
    sg = T.StencilGraphD1.create((4, 5), {(0, 1): 0.5, (1, 0): 0.5},
                                 dtype=torch.float64, device="cpu")
    q = torch.from_numpy(np.random.default_rng(4).dirichlet(np.ones(3), 20))
    on = T.pfdr_loss_d1_simplex(sg, q, al=1.0, monitor=True,
                                opt=T.PFDROptions(fused="on", it_max=5))
    with pytest.raises(ValueError, match="labels"):
        T.pfdr_loss_d1_simplex(
            sg, torch.full((20, 40), 1.0 / 40, dtype=torch.float64),
            al=1.0, opt=T.PFDROptions(fused="on", it_max=5))
    res = T.pfdr_loss_d1_simplex(sg, q, al=1.0, monitor=True,
                                 opt=T.PFDROptions(it_max=5))
    assert res.obj.shape == on.obj.shape == (6,)
    assert on.it == res.it == 5
    np.testing.assert_allclose(on.obj.numpy(), res.obj.numpy(), rtol=1e-13)
    np.testing.assert_allclose(on.dif.numpy(), res.dif.numpy(), rtol=1e-10,
                               atol=1e-15)
    np.testing.assert_allclose(on.p.numpy(), res.p.numpy(), rtol=0,
                               atol=1e-14)
