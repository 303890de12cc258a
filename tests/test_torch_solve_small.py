"""Port's ``solve_small`` kernel module against the JAX package, on the CPU
in float64.

The port's wrapper runs the kernel's plain PyTorch version here; the JAX
side runs its Pallas kernel in interpret mode, as
``tests/test_solve_small.py`` does.  Both get the same preconditioned
reduced problem; iterates are compared at 1e-12 (float64 round-off, well
inside the 3e-5 float32 bound of ``tests/test_solve_small.py``) and
iteration counts exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp_pfdr_graph_d1_tpu.ops.solve_small import \
    fused_pfdr_solve_small as jax_solve_small
from cp_pfdr_graph_d1_tpu.solvers import cut_pursuit as jcp
from cp_pfdr_graph_d1_tpu_torch import GraphD1, VertexProx
from cp_pfdr_graph_d1_tpu_torch.config import Lipsch
from cp_pfdr_graph_d1_tpu_torch.operators import DenseOp, DiagOp, GramOp
from cp_pfdr_graph_d1_tpu_torch.ops import solve_small
from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit as tcp
from cp_pfdr_graph_d1_tpu_torch.solvers.pfdr_quadratic import \
    initial_precondition

torch.set_num_threads(1)

RV_CAP = E_PAD = 128


def ring_problem(v=128, n=24, seed=0):
    r = np.random.default_rng(seed)
    eu = np.arange(v, dtype=np.int32)
    ev = ((np.arange(v) + 1) % v).astype(np.int32)
    la = np.full(v, 0.3)
    a = r.standard_normal((n, v)) / np.sqrt(n)
    x_true = (r.random(v) > 0.7).astype(np.float64)
    y = a @ x_true + 0.01 * r.standard_normal(n)
    return eu, ev, la, a, y


def contracted(rv, seed):
    """Labels contracting 128 vertices onto ``rv`` components, and the
    reduced ring padded to E_PAD with zero-weight loops."""
    r = np.random.default_rng(seed)
    cv = np.sort(r.integers(0, rv, RV_CAP))
    cv[:rv] = np.arange(rv)
    cv = np.sort(cv).astype(np.int32)
    reu = np.concatenate([np.arange(rv), np.zeros(E_PAD - rv)])
    rev = np.concatenate([(np.arange(rv) + 1) % rv, np.zeros(E_PAD - rv)])
    rla = np.concatenate([np.full(rv, 0.3), np.zeros(E_PAD - rv)])
    return cv, reu.astype(np.int32), rev.astype(np.int32), rla


def operator_arrays(mode, a, y):
    if mode == "gram":
        return a.T @ a, a.T @ y
    if mode == "diag":
        return np.sum(a * a, axis=0), a.T @ y
    return a, y


def vprox_of(vkind):
    return {"l1pos": VertexProx(kind="l1", positivity=True),
            "l1": VertexProx(kind="l1"),
            "bounds": VertexProx(kind="bounds", lo=-0.1, hi=0.6),
            "none": VertexProx()}[vkind]


def kernel_inputs(mode, vkind, rv, seed):
    """A preconditioned reduced problem (built with the port on the CPU):
    operator payload, vertex rows, z0, edge constants, endpoints."""
    eu, ev, la, a, y = ring_problem(seed=seed)
    cv, reu, rev, rla = contracted(rv, seed)
    op_arr, obs = operator_arrays(mode, a, y)
    t = torch.from_numpy
    kind = "dense" if mode in ("dense", "pre_at") else mode
    pre_at = mode == "pre_at"
    cv_t = t(cv.astype(np.int64))
    if kind == "dense":
        mat, ry, lipsch = tcp._reduce_dense(t(op_arr), t(obs), cv_t, RV_CAP,
                                            pre_at)
        r_op = GramOp(mat) if pre_at else DenseOp(mat)
    elif kind == "gram":
        mat, ry, lipsch = tcp._reduce_gram(t(op_arr), t(obs), cv_t, RV_CAP)
        r_op = GramOp(mat)
    else:
        mat, ry, lipsch = tcp._reduce_diag(t(op_arr), t(obs), cv_t, RV_CAP)
        r_op = DiagOp(mat)
    g = GraphD1.create(reu, rev, rla, num_vertices=RV_CAP,
                       dtype=torch.float64, device="cpu")
    la_l1 = t(np.full(RV_CAP, 0.02)) if vkind.startswith("l1") else None
    pre = initial_precondition(r_op, ry, g, la_l1, 1.4, lipsch, Lipsch.DIAG)
    if kind == "dense" and not pre_at:
        op_kind, aty = "dense", r_op.apply_t(ry)
    else:
        op_kind, aty = ("diag" if kind == "diag" else "gram"), ry
    x0 = np.zeros(RV_CAP)
    x0[:rv] = np.random.default_rng(seed + 1).uniform(0, 0.5, rv)
    x0 = t(x0)
    z0 = torch.stack([x0[g.eu], x0[g.ev]])
    ec = torch.stack([pre.wu, pre.wv, pre.w_d1u, pre.w_d1v, pre.th_d1])
    return (op_kind, mat, aty, pre.ga, pre.th_l1, x0, z0, ec, g.eu, g.ev)


def run_jax(op_kind, mat, aty, ga, th_l1, x0, z0, ec, eu, ev, *, rv, it_max,
            vprox, dif_tol2, eps):
    n = lambda a: np.asarray(a)  # noqa: E731
    m = jax.nn.one_hot(jnp.concatenate([jnp.asarray(n(eu)),
                                        jnp.asarray(n(ev))]),
                       RV_CAP, dtype=jnp.float64, axis=0)
    if op_kind == "dense":
        np_pad = 128
        a_pad = np.zeros((np_pad, RV_CAP))
        a_pad[:mat.shape[0]] = n(mat)
        op_a, op_b = jnp.asarray(a_pad.T), jnp.asarray(a_pad)
    elif op_kind == "gram":
        np_pad, op_a, op_b = 128, jnp.asarray(n(mat)), jnp.zeros((8, 128))
    else:
        np_pad, op_a = 128, jnp.asarray(n(mat).reshape(1, -1))
        op_b = jnp.zeros((8, 128))
    ec8 = np.zeros((8, E_PAD))
    ec8[:5] = n(ec)
    row = lambda a: jnp.asarray(n(a).reshape(1, -1))  # noqa: E731
    x, z, it, dif = jax_solve_small(
        m, op_a, op_b, row(aty), row(ga), row(th_l1), row(x0),
        jnp.asarray(n(z0)), jnp.asarray(ec8), rv_cap=RV_CAP, e_pad=E_PAD,
        np_pad=np_pad, op_kind=op_kind, rho=1.4, vkind=vprox.kind,
        positivity=vprox.positivity, lo=float(vprox.lo), hi=float(vprox.hi),
        it_max=it_max, dif_tol2=dif_tol2, eps=eps, rv=rv, interpret=True)
    return np.asarray(x).ravel(), np.asarray(z), int(it), float(dif)


@pytest.mark.parametrize("mode,vkind,rv,it_max,dif_tol", [
    ("dense", "l1pos", 128, 120, 0.0),
    ("pre_at", "none", 128, 120, 0.0),
    ("gram", "bounds", 128, 120, 0.0),
    ("diag", "l1", 128, 120, 0.0),
    ("dense", "l1pos", 100, 2000, 1e-4),   # early stop, padded vertices
])
def test_plain_solve_matches_pallas(mode, vkind, rv, it_max, dif_tol):
    args = kernel_inputs(mode, vkind, rv, seed=3)
    vprox = vprox_of(vkind)
    eps = dif_tol if dif_tol > 0 else float(np.finfo(np.float64).eps)
    kw = dict(rv=rv, it_max=it_max, dif_tol2=dif_tol ** 2, eps=eps)
    x_j, z_j, it_j, dif_j = run_jax(*args, vprox=vprox, **kw)
    launches = solve_small.fused_pfdr_solve_small.launches
    x_t, z_t, it_t, dif_t = solve_small.fused_pfdr_solve_small(
        *args, rho=1.4, vkind=vprox.kind, positivity=vprox.positivity,
        lo=float(vprox.lo), hi=float(vprox.hi), **kw)
    assert solve_small.fused_pfdr_solve_small.launches == launches
    assert int(it_t) == it_j
    if dif_tol > 0:
        assert it_j < it_max  # the evolution test fired
        assert np.all(x_t.numpy()[rv:] == 0)
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(z_t.numpy(), z_j, rtol=0, atol=1e-12)
    # dif is a ratio of squared norms: round-off of the iterates at 1e-16
    # shows in it at 1e-32 absolute once a solve has converged
    np.testing.assert_allclose(float(dif_t), dif_j, rtol=1e-9, atol=1e-24)


@pytest.mark.parametrize("mode,vkind,rv,it_max,dif_tol", [
    ("dense", "l1pos", 128, 120, 0.0),
    ("pre_at", "bounds", 100, 120, 0.0),
    ("gram", "l1", 100, 2000, 1e-4),
    ("diag", "none", 128, 120, 0.0),
])
def test_reduce_solve_small_matches_jax(mode, vkind, rv, it_max, dif_tol):
    """The whole reduced stage (reduction, Lipschitz metric,
    preconditioning, solve) against the JAX package's
    ``_reduce_solve_small``."""
    eu, ev, la, a, y = ring_problem(seed=5)
    cv, reu, rev, rla = contracted(rv, seed=5)
    op_arr, obs = operator_arrays(mode, a, y)
    kind = "dense" if mode in ("dense", "pre_at") else mode
    pre_at = mode == "pre_at"
    vprox = vprox_of(vkind)
    la_l1 = np.full(RV_CAP, 0.02) if vkind.startswith("l1") else None
    x0 = np.zeros(RV_CAP)
    x0[:rv] = 0.1
    buf = jcp.pack_small_inputs(cv, reu, rev, rla, la_l1, x0, it_max, rv,
                                RV_CAP, E_PAD, np.float64)
    out = np.asarray(jcp._reduce_solve_small(
        jnp.asarray(op_arr), jnp.asarray(obs), jnp.asarray(buf),
        rv_cap=RV_CAP, e_cap=E_PAD, kind=kind, pre_at=pre_at, np_pad=128,
        vprox=vprox, rho=1.4, dif_tol=dif_tol, has_l1=la_l1 is not None,
        interpret=True))
    x_j, it_j = out[:RV_CAP], int(out[RV_CAP])

    t = torch.from_numpy
    g = GraphD1.create(reu, rev, rla, num_vertices=RV_CAP,
                       dtype=torch.float64, device="cpu")
    x_t, it_t = tcp._reduce_solve_small(
        t(op_arr), t(obs), t(cv.astype(np.int64)), g,
        None if la_l1 is None else t(la_l1), t(x0), it_max, rv, kind=kind,
        pre_at=pre_at, vprox=vprox, rho=1.4, dif_tol=dif_tol)
    assert int(it_t) == it_j
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=0, atol=1e-12)


def test_kernel_limit_raises_with_sizes():
    """A reduced problem beyond the kernel's shared memory is refused with
    its sizes, before anything runs."""
    assert solve_small.fits(4096, 91, torch.float32)
    assert solve_small.fits(4096, 91, torch.float64)
    assert not solve_small.fits(16384, 0, torch.float64)
    f64 = dict(dtype=torch.float64)
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="rv_cap=16384"):
        solve_small._check("diag", torch.zeros(16384, **f64),
                           [torch.zeros(16384, **f64)] * 4,
                           torch.zeros(2, 1, **f64), torch.zeros(5, 1, **f64),
                           idx, idx, 16384)


def test_endpoints_out_of_range_raise():
    """An edge endpoint outside the reduced vertex range is refused before
    the kernel (or its plain version) indexes with it."""
    args = list(kernel_inputs("diag", "none", 128, seed=3))
    eu = args[8].clone()
    eu[5] = RV_CAP
    with pytest.raises(ValueError, match=r"\[0, 128\], outside the 128"):
        solve_small.incidence_csr(eu, args[9], RV_CAP)
    args[8] = eu
    with pytest.raises(ValueError, match="outside the 128 vertices"):
        solve_small.fused_pfdr_solve_small(
            *args, rv=128, it_max=5, rho=1.4, vkind="none", positivity=False,
            lo=-np.inf, hi=np.inf, dif_tol2=0.0, eps=1e-16)
