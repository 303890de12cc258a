"""Port's ``pfdr_quadratic_d1`` against the JAX package, on the CPU in
float64: COO and stencil graphs, monitor traces, reconditioning and resume.

Iterates are compared at 1e-10 as ``tests/test_stencil.py`` compares the
two JAX containers, and iteration counts exactly.  The JAX side runs its
staged loop (``fused="off"``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_pfdr_graph_d1_tpu as J
import cp_pfdr_graph_d1_tpu_torch as T
from cp_pfdr_graph_d1_tpu.config import Lipsch as JLipsch
from cp_pfdr_graph_d1_tpu_torch import convert
from cp_pfdr_graph_d1_tpu_torch.config import Lipsch
from cp_pfdr_graph_d1_tpu_torch.ops import stencil_fused

torch.set_num_threads(1)


def problem(h=8, w=7, n=20, seed=0, wrap=(False, True)):
    r = np.random.default_rng(seed)
    weights = {(0, 1): r.uniform(0.2, 1.0, (h, w)),
               (1, 0): r.uniform(0.2, 1.0, (h, w))}
    v = h * w
    a = r.normal(size=(n, v)) / 4.0
    x_true = np.where(r.random(v) > 0.6, r.uniform(0.5, 1.5, v), 0.0)
    y = a @ x_true + 0.01 * r.normal(size=n)
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    return weights, a, y, lip, (h, w), wrap


def graphs(weights, shape, wrap):
    jsg = J.StencilGraphD1.create(shape, weights, wrap=wrap,
                                  dtype=jnp.float64)
    tsg = convert.stencil_graph(np.asarray(jsg.la_d1), jsg.field_shape,
                                jsg.shifts, jsg.wrap, device="cpu")
    keep = np.asarray(jsg.la_d1) > 0
    eu, ev = np.asarray(jsg.eu)[keep], np.asarray(jsg.ev)[keep]
    la = np.asarray(jsg.la_d1)[keep]
    jcg = J.GraphD1.create(eu, ev, la, num_vertices=jsg.num_vertices,
                           dtype=jnp.float64)
    tcg = convert.graph(np.asarray(jcg.eu), np.asarray(jcg.ev),
                        np.asarray(jcg.la_d1), jcg.num_vertices,
                        device="cpu")
    return jsg, tsg, jcg, tcg


def jopt(**kw):
    return J.PFDROptions(fused="off", **kw)


def topt(jax_opt, fused):
    return dataclasses.replace(
        convert.pfdr_options(dataclasses.asdict(jax_opt)), fused=fused)


@pytest.mark.parametrize("container,fused", [
    ("coo", "off"), ("stencil", "on"), ("stencil", "auto")])
def test_pfdr_matches_jax(container, fused):
    weights, a, y, lip, shape, wrap = problem(seed=1)
    jsg, tsg, jcg, tcg = graphs(weights, shape, wrap)
    jg, tg = (jcg, tcg) if container == "coo" else (jsg, tsg)
    v = jg.num_vertices
    opt = jopt(rho=1.3, dif_tol=1e-9, it_max=1500)
    vprox = dict(kind="l1", positivity=container == "stencil")
    res_j = J.pfdr_quadratic_d1(J.DenseOp(jnp.asarray(a)), jnp.asarray(y),
                                jg, la_l1=jnp.full((v,), 0.05),
                                vprox=J.VertexProx(**vprox), lipsch=lip,
                                opt=opt)
    launches = stencil_fused.fused_stencil_iteration.launches
    res_t = T.pfdr_quadratic_d1(T.DenseOp(torch.from_numpy(a)),
                                torch.from_numpy(y), tg,
                                la_l1=torch.full((v,), 0.05,
                                                 dtype=torch.float64),
                                vprox=T.VertexProx(**vprox), lipsch=lip,
                                opt=topt(opt, fused))
    # CPU tensors never launch the CUDA kernel, whatever the fused mode
    assert stencil_fused.fused_stencil_iteration.launches == launches
    assert res_t.it == int(res_j.it)
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                               rtol=0, atol=1e-10)


def test_monitor_traces_and_reconditioning_match_jax():
    """Gram operator, bounds, DIAG Lipschitz metric, reconditioning
    (``dif_rcd > 0``) and the monitor traces."""
    weights, a, y, lip, shape, wrap = problem(seed=2)
    _, _, jcg, tcg = graphs(weights, shape, wrap)
    gram, aty = a.T @ a, a.T @ y
    lip_diag = np.abs(gram).sum(axis=1)
    opt = jopt(rho=1.5, dif_tol=1e-8, dif_rcd=1e-3, it_max=400)
    vprox = dict(kind="bounds", lo=-0.2, hi=1.2)
    res_j = J.pfdr_quadratic_d1(J.GramOp(jnp.asarray(gram)),
                                jnp.asarray(aty), jcg,
                                vprox=J.VertexProx(**vprox),
                                lipsch=jnp.asarray(lip_diag),
                                ltype=JLipsch.DIAG, opt=opt, monitor=True)
    res_t = T.pfdr_quadratic_d1(T.GramOp(torch.from_numpy(gram)),
                                torch.from_numpy(aty), tcg,
                                vprox=T.VertexProx(**vprox),
                                lipsch=torch.from_numpy(lip_diag),
                                ltype=Lipsch.DIAG, opt=topt(opt, "off"),
                                monitor=True)
    it = int(res_j.it)
    assert res_t.it == it
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                               rtol=0, atol=1e-10)
    obj_j, obj_t = np.asarray(res_j.obj), res_t.obj.numpy()
    assert obj_t.shape == obj_j.shape
    np.testing.assert_allclose(obj_t[:it + 1], obj_j[:it + 1], rtol=1e-10)
    assert np.all(obj_t[it + 1:] == 0)
    np.testing.assert_allclose(res_t.dif.numpy()[:it],
                               np.asarray(res_j.dif)[:it], rtol=1e-6,
                               atol=1e-20)


def test_resume_is_bitwise_and_carries_over_from_jax():
    weights, a, y, lip, shape, wrap = problem(seed=3)
    jsg, tsg, _, _ = graphs(weights, shape, wrap)
    v = jsg.num_vertices
    op_t = T.DenseOp(torch.from_numpy(a))
    y_t = torch.from_numpy(y)
    kw_t = dict(la_l1=torch.full((v,), 0.04, dtype=torch.float64),
                vprox=T.VertexProx(kind="l1"), lipsch=lip)

    def run_t(it_max, state0=None):
        o = T.PFDROptions(rho=1.4, dif_tol=0.0, it_max=it_max, fused="on")
        return T.pfdr_quadratic_d1(op_t, y_t, tsg, opt=o, state0=state0,
                                   return_state=True, **kw_t)

    full, _ = run_t(300)
    _, st = run_t(120)
    resumed, _ = run_t(300, st)
    assert resumed.it == full.it == 300
    assert torch.equal(resumed.x, full.x)

    # a solve started in JAX resumes in the port
    kw_j = dict(la_l1=jnp.full((v,), 0.04), vprox=J.VertexProx(kind="l1"),
                lipsch=lip)
    op_j, y_j = J.DenseOp(jnp.asarray(a)), jnp.asarray(y)
    _, st_j = J.pfdr_quadratic_d1(op_j, y_j, jsg, return_state=True,
                                  opt=jopt(rho=1.4, dif_tol=0.0, it_max=120),
                                  **kw_j)
    full_j = J.pfdr_quadratic_d1(op_j, y_j, jsg, **kw_j,
                                 opt=jopt(rho=1.4, dif_tol=0.0, it_max=300))
    st_t = convert.pfdr_solve_state(
        np.asarray(st_j.x), np.asarray(st_j.zu), np.asarray(st_j.zv),
        [np.asarray(p) for p in st_j.pre], np.asarray(st_j.x_prev),
        np.asarray(st_j.dif), np.asarray(st_j.dif_rcd2), np.asarray(st_j.it),
        device="cpu")
    from_jax, _ = run_t(300, st_t)
    assert from_jax.it == int(full_j.it) == 300
    np.testing.assert_allclose(from_jax.x.numpy(), np.asarray(full_j.x),
                               rtol=0, atol=1e-10)


def test_prox_operators_and_power_iteration_match_jax():
    """The small pieces under the solvers: vertex and pair proxes, operator
    inference and conversion, and the power-iteration norm, whose
    Threefry start reproduces ``jax.random.uniform(PRNGKey(0))``."""
    import jax

    from cp_pfdr_graph_d1_tpu.ops import power_iter as jpi
    from cp_pfdr_graph_d1_tpu.ops import prox as jprox
    from cp_pfdr_graph_d1_tpu_torch.ops import power_iter as tpi
    from cp_pfdr_graph_d1_tpu_torch.ops import prox as tprox

    r = np.random.default_rng(7)
    x, th, pu, pv = r.normal(size=(4, 50))
    th, w = np.abs(th), r.uniform(0.1, 0.9, 50)
    t = torch.from_numpy
    for pos in (False, True):
        np.testing.assert_allclose(
            tprox.soft_threshold(t(x), t(th), pos).numpy(),
            np.asarray(jprox.soft_threshold(jnp.asarray(x), jnp.asarray(th),
                                            pos)), atol=1e-15)
    np.testing.assert_allclose(tprox.box_clamp(t(x), -0.3, 0.4).numpy(),
                               np.asarray(jprox.box_clamp(x, -0.3, 0.4)))
    for a, b in zip(tprox.d1_pair_prox(t(pu), t(pv), t(w), t(1 - w), t(th)),
                    jprox.d1_pair_prox(pu, pv, w, 1 - w, th)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-15)

    for dt in (np.float32, np.float64):
        np.testing.assert_array_equal(
            tpi.threefry_uniform((37, 10), dt),
            np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (37, 10), dt,
                                          minval=-1.0, maxval=1.0)))
    a = r.normal(size=(9, 60))
    np.testing.assert_allclose(
        float(tpi.dense_operator_norm(t(a))),
        float(jpi.dense_operator_norm(jnp.asarray(a))), rtol=1e-12)

    v = a.shape[1]
    for arr, kind in ((None, "IdentityOp"), (np.full(v, 2.0), "DiagOp"),
                      (a.T @ a, "GramOp"), (a, "DenseOp")):
        top = T.make_operator(arr, v, device="cpu")
        jop = J.make_operator(arr, v)
        assert type(top).__name__ == type(jop).__name__ == kind
        cop = convert.operator(kind, arr, device="cpu")
        obs = r.normal(size=a.shape[0] if kind == "DenseOp" else v)
        xv = r.normal(size=v)
        for op in (top, cop):
            np.testing.assert_allclose(
                op.grad(t(xv), t(obs)).numpy(),
                np.asarray(jop.grad(jnp.asarray(xv), jnp.asarray(obs))),
                atol=1e-12)
            np.testing.assert_allclose(
                float(op.quad_obj(t(xv), t(obs))),
                float(jop.quad_obj(jnp.asarray(xv), jnp.asarray(obs))),
                rtol=1e-12)


@pytest.mark.parametrize("fused", ["on", "auto"])
def test_stencil_beyond_kernel_families(fused):
    """A stencil of more shift families than the kernel takes raises on the
    kernel route instead of running the staged loop in its place; on CPU
    tensors "auto" takes the staged loop."""
    h, w = 4, 5
    shifts = [(dy, dx) for dy in range(1, 4) for dx in range(-3, 3)][:17]
    assert len(shifts) == 17
    g = T.StencilGraphD1.create((h, w), {s: 0.1 for s in shifts},
                                wrap=(True, True), dtype=torch.float64,
                                device="cpu")
    r = np.random.default_rng(0)
    op = T.DenseOp(torch.from_numpy(r.normal(size=(6, h * w))))
    obs = torch.from_numpy(r.normal(size=6))
    opt = T.PFDROptions(it_max=3, fused=fused)
    if fused == "on":
        with pytest.raises(ValueError, match="17 shift families.*at most 16"):
            T.pfdr_quadratic_d1(op, obs, g, lipsch=10.0, opt=opt)
    else:
        assert T.pfdr_quadratic_d1(op, obs, g, lipsch=10.0, opt=opt).it == 3
