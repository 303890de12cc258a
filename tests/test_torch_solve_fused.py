"""Plain version of the ``solve_fused`` kernel against the JAX package's
``pfdr_quadratic_d1`` on a ``BandedGraphD1`` (on the CPU).

The port's kernel takes flat edge rows in the banded plan's order (sorted by
smaller endpoint, padded with zero-weight copies of the last edge), so the
inputs here are the JAX banded graph's edges and the port's preconditioning
of them.  With ``fused="on"`` the JAX side runs its whole-solve Pallas
kernel in interpret mode in float32: equal iteration counts, iterates at
2e-5 (``tests/test_solve_fused.py``'s tolerance between that kernel and the
staged loop).  With ``fused="off"`` it runs its staged loop in float64:
iterates at 1e-10.  Fields are 12 x 16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_pfdr_graph_d1_tpu as J
from cp_pfdr_graph_d1_tpu.banded_graph import BandedGraphD1
from cp_pfdr_graph_d1_tpu_torch import (DenseOp, DiagOp, GramOp, GraphD1,
                                        IdentityOp, VertexProx)
from cp_pfdr_graph_d1_tpu_torch.config import Lipsch
from cp_pfdr_graph_d1_tpu_torch.ops import solve_fused, solve_small
from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit as tcp
from cp_pfdr_graph_d1_tpu_torch.solvers.pfdr_quadratic import \
    initial_precondition

from .conftest import make_grid_graph

torch.set_num_threads(1)

H, W, N = 12, 16, 20
RHO = 1.4


def problem(seed, dtype):
    r = np.random.default_rng(seed)
    v = H * W
    eu, ev, la = make_grid_graph(H, W, seed=seed)
    a = (r.standard_normal((N, v)) / np.sqrt(N)).astype(dtype)
    x_true = np.zeros(v, dtype)
    x_true[r.integers(0, v, 20)] = 1.0
    y = (a @ x_true + 0.01 * r.standard_normal(N)).astype(dtype)
    return eu, ev, la.astype(dtype), a, y


def vprox_of(kind):
    return {"none": VertexProx(), "l1": VertexProx(kind="l1"),
            "l1pos": VertexProx(kind="l1", positivity=True),
            "bounds": VertexProx(kind="bounds", lo=-0.2, hi=0.7)}[kind]


def operators(op_kind, a, y):
    """(JAX operator, port operator, obs) of one operator kind."""
    if op_kind == "dense":
        return J.DenseOp(jnp.asarray(a)), DenseOp(torch.from_numpy(a)), y
    aty = a.T @ y
    if op_kind == "gram":
        g = a.T @ a
        return (J.GramOp(jnp.asarray(g)), GramOp(torch.from_numpy(g)), aty)
    if op_kind == "diag":
        d = (a * a).sum(axis=0)
        return (J.DiagOp(jnp.asarray(d)), DiagOp(torch.from_numpy(d)), aty)
    return J.IdentityOp(), IdentityOp(), aty


def run_pair(op_kind, vkind, dtype, fused, it_max=60, dif_tol=0.0,
             seed=0, resume_at=None):
    eu, ev, la, a, y = problem(seed, dtype)
    v = H * W
    jop, top, obs = operators(op_kind, a, y)
    lip = float(np.linalg.eigvalsh((a.T @ a).astype(np.float64))[-1])
    vp = vprox_of(vkind)
    la_l1 = (np.full(v, 0.05, dtype) if vkind.startswith("l1") else None)
    bg = BandedGraphD1.create(eu, ev, la, num_vertices=v,
                              dtype=jnp.dtype(dtype))
    jvp = J.VertexProx(kind=vp.kind, positivity=vp.positivity, lo=vp.lo,
                       hi=vp.hi)

    def jopt(m):
        return J.PFDROptions(rho=RHO, dif_tol=dif_tol, it_max=m, fused=fused)

    jl1 = None if la_l1 is None else jnp.asarray(la_l1)
    kw = dict(la_l1=jl1, vprox=jvp, lipsch=lip)
    if resume_at is None:
        res_j = J.pfdr_quadratic_d1(jop, jnp.asarray(obs), bg, opt=jopt(it_max),
                                    **kw)
    else:
        _, st = J.pfdr_quadratic_d1(jop, jnp.asarray(obs), bg,
                                    opt=jopt(resume_at), return_state=True,
                                    **kw)
        res_j = J.pfdr_quadratic_d1(jop, jnp.asarray(obs), bg,
                                    opt=jopt(it_max), state0=st, **kw)

    # the port: preconditioning on the banded graph's edge order, then the
    # kernel's plain version with the same edge rows
    t = torch.from_numpy
    g = GraphD1.create(np.asarray(bg.eu), np.asarray(bg.ev),
                       np.asarray(bg.la_d1), num_vertices=v,
                       dtype=t(a).dtype, device="cpu")
    tl1 = None if la_l1 is None else t(la_l1)
    pre = initial_precondition(top, t(obs), g, tl1, RHO, lip, Lipsch.SCAL)
    if op_kind == "dense":
        kind, mat, aty = "dense", top.a, top.apply_t(t(obs))
    elif op_kind == "gram":
        kind, mat, aty = "gram", top.gram, t(obs)
    else:
        kind, aty = "diag", t(obs)
        mat = (top.diag if op_kind == "diag"
               else torch.ones(v, dtype=aty.dtype))
    ec = torch.stack([pre.wu, pre.wv, pre.w_d1u, pre.w_d1v, pre.th_d1])
    eps_mach = float(np.finfo(dtype).eps)
    args = (kind, mat, aty, pre.ga, pre.th_l1)
    skw = dict(rv=v, rho=RHO, vkind=vp.kind, positivity=vp.positivity,
               lo=float(vp.lo), hi=float(vp.hi), dif_tol2=dif_tol ** 2,
               eps=dif_tol if 0 < dif_tol < eps_mach else eps_mach)
    x0 = torch.zeros(v, dtype=aty.dtype)
    z0 = torch.stack([x0[g.eu], x0[g.ev]])
    if resume_at is None:
        out = solve_fused.fused_pfdr_solve(*args, x0, z0, ec, g.eu, g.ev,
                                           it_max=it_max, **skw)
    else:
        x1, z1, it1, _ = solve_fused.fused_pfdr_solve(
            *args, x0, z0, ec, g.eu, g.ev, it_max=resume_at, **skw)
        out = solve_fused.fused_pfdr_solve(*args, x1, z1, ec, g.eu, g.ev,
                                           it_max=it_max, it0=int(it1),
                                           **skw)
        straight = solve_fused.fused_pfdr_solve(*args, x0, z0, ec, g.eu,
                                                g.ev, it_max=it_max, **skw)
        # resuming continues the uninterrupted trajectory bit for bit
        assert int(out[2]) == int(straight[2])
        np.testing.assert_array_equal(out[0].numpy(), straight[0].numpy())
        np.testing.assert_array_equal(out[1].numpy(), straight[1].numpy())
    return res_j, out


@pytest.mark.parametrize("op_kind,vkind", [
    ("dense", "l1"), ("dense", "l1pos"), ("gram", "bounds"),
    ("identity", "none")])
def test_plain_matches_whole_solve_kernel_f32(op_kind, vkind):
    res_j, (x, _, it, _) = run_pair(op_kind, vkind, np.float32, "on")
    assert int(it) == int(res_j.it) == 60
    np.testing.assert_allclose(x.numpy(), np.asarray(res_j.x), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("op_kind,vkind", [
    ("dense", "none"), ("diag", "l1pos"), ("gram", "l1")])
def test_plain_matches_staged_f64(op_kind, vkind):
    res_j, (x, _, it, _) = run_pair(op_kind, vkind, np.float64, "off",
                                    it_max=3000, dif_tol=1e-6)
    assert int(it) == int(res_j.it) < 3000
    np.testing.assert_allclose(x.numpy(), np.asarray(res_j.x), rtol=0,
                               atol=1e-10)


def test_early_stop_matches_kernel():
    res_j, (x, _, it, _) = run_pair("dense", "bounds", np.float32, "on",
                                    it_max=400, dif_tol=1e-3, seed=3)
    assert int(it) == int(res_j.it) < 400
    np.testing.assert_allclose(x.numpy(), np.asarray(res_j.x), rtol=0,
                               atol=2e-5)


def test_resume_continues_trajectory():
    """Resume from ``(x, z, it0)`` against the JAX kernel's resume from
    its ``PFDRSolveState``."""
    res_j, (x, _, it, _) = run_pair("diag", "bounds", np.float32, "on",
                                    it_max=70, resume_at=25, seed=2)
    assert int(it) == int(res_j.it) == 70
    np.testing.assert_allclose(x.numpy(), np.asarray(res_j.x), rtol=0,
                               atol=2e-5)


def test_kernel_route_beyond_solve_small(monkeypatch):
    """A reduced problem that ``solve_small`` does not take goes to
    ``solve_fused`` with its edges sorted by smaller endpoint, and solves
    the same problem."""
    eu, ev, la, a, y = problem(5, np.float64)
    v = H * W
    g = GraphD1.create(eu[::-1].copy(), ev[::-1].copy(), la[::-1].copy(),
                       num_vertices=v, dtype=torch.float64, device="cpu")
    r_op = DenseOp(torch.from_numpy(a))
    lipsch = torch.full((v,), float(np.linalg.norm(a, 2) ** 2),
                        dtype=torch.float64)
    args = (r_op, r_op.a, torch.from_numpy(y), lipsch, g,
            torch.full((v,), 0.02, dtype=torch.float64),
            torch.zeros(v, dtype=torch.float64), v, 2000)
    kw = dict(vprox=VertexProx(kind="l1", positivity=True), rho=1.5,
              dif_tol=1e-6)
    x_s, it_s = tcp._kernel_solve(*args, **kw)
    calls = []
    monkeypatch.setattr(tcp, "fits", lambda *a: False)
    monkeypatch.setattr(tcp, "fused_pfdr_solve",
                        lambda *a, **k: calls.append(a[8:10]) or
                        solve_fused.fused_pfdr_solve(*a, **k))
    x_f, it_f = tcp._kernel_solve(*args, **kw)
    assert len(calls) == 1
    key = torch.minimum(*calls[0])
    assert bool((key[1:] >= key[:-1]).all())
    assert int(it_s) == int(it_f) < 2000
    np.testing.assert_allclose(x_f.numpy(), x_s.numpy(), rtol=0, atol=1e-12)
    assert solve_small.fits(4096, 91, torch.float32)
    assert not solve_small.fits(32768, 91, torch.float32)
