"""Port's multi-label kernel module on the circulant container
(``ops/circulant_fused_simplex``) and its kernel loop against the JAX
package, on the CPU in float64.

The port's wrapper runs its kernel's plain version here (the tensors lie on
the CPU).  The JAX side takes its staged loop (``GraphD1`` or the circulant
container with ``fused="off"``); ``tests/test_circulant_simplex.py`` holds
the JAX kernel against that loop.  Tolerances are those of
``tests/test_circulant_simplex.py``: equal iteration counts, iterates within
1e-9 and rows summing to 1.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_pfdr_graph_d1_tpu as J
import cp_pfdr_graph_d1_tpu_torch as T
from cp_pfdr_graph_d1_tpu.ops.prox import d1_pair_prox as j_pair_prox
from cp_pfdr_graph_d1_tpu.ops.prox import \
    proj_simplex_metric as j_proj_simplex
from cp_pfdr_graph_d1_tpu.solvers.pfdr_simplex import \
    _loss_grad as j_loss_grad
from cp_pfdr_graph_d1_tpu.solvers.pfdr_simplex import \
    pfdr_loss_d1_simplex as jpfdr
from cp_pfdr_graph_d1_tpu_torch import convert
from cp_pfdr_graph_d1_tpu_torch.ops import circulant_fused_simplex as cfs

from .conftest import make_grid_graph

torch.set_num_threads(1)

V = 600
CIRC_KW = dict(max_families=8, min_count=4)


def mesh_problem(k=4, seed=0):
    """Grid plus random chords (``tests/test_circulant_simplex.py``):
    families and a remainder, a piecewise-constant label field with
    noise."""
    r = np.random.default_rng(seed)
    eu, ev, la = make_grid_graph(24, V // 24, seed=seed)
    extra = 40
    ceu = r.integers(0, V, extra).astype(np.int32)
    cev = ((ceu + r.integers(1, V // 2, extra)) % V).astype(np.int32)
    keep = ceu != cev
    eu = np.concatenate([eu, ceu[keep]])
    ev = np.concatenate([ev, cev[keep]])
    la = np.concatenate([la, 0.4 + r.random(keep.sum())])
    labels = r.integers(0, k, size=V)
    q = np.full((V, k), 0.1 / (k - 1))
    q[np.arange(V), labels] = 0.9
    q += 0.05 * r.random((V, k))
    q /= q.sum(axis=1, keepdims=True)
    return eu, ev, 0.15 * la, q


def solve_pair(al, k=4, la_f=None, dif_tol=1e-7, it_max=300, rho=1.2,
               seed=0):
    """The JAX staged solve on ``GraphD1`` and the port's kernel loop
    (``fused="on"``) on its circulant container."""
    eu, ev, la, q = mesh_problem(k=k, seed=seed)
    base = jpfdr(
        J.GraphD1.create(eu, ev, la, num_vertices=V, dtype=jnp.float64),
        jnp.asarray(q), al=al,
        la_f=None if la_f is None else jnp.asarray(la_f),
        opt=J.PFDROptions(rho=rho, dif_tol=dif_tol, it_max=it_max,
                          fused="off"))
    tg = T.CirculantGraphD1.create(eu, ev, la, num_vertices=V,
                                   dtype=torch.float64, device="cpu",
                                   **CIRC_KW)
    assert tg.num_rem > 0
    launches = cfs.fused_circulant_simplex_iteration.launches
    res = T.pfdr_loss_d1_simplex(
        tg, torch.from_numpy(q), al=al,
        la_f=None if la_f is None else torch.from_numpy(la_f),
        opt=T.PFDROptions(rho=rho, dif_tol=dif_tol, it_max=it_max,
                          fused="on"))
    assert cfs.fused_circulant_simplex_iteration.launches == launches
    return base, res


def assert_matches(base, res):
    assert res.it == int(base.it)
    p = res.p.numpy()
    np.testing.assert_allclose(p, np.asarray(base.p), rtol=0, atol=1e-9)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=1e-9)
    assert p.min() >= -1e-12


@pytest.mark.parametrize("al", [0.0, 1.0, 0.2])
def test_kernel_loop_matches_jax(al):
    assert_matches(*solve_pair(al))


def test_kernel_loop_vertex_weights():
    la_f = np.random.default_rng(3).uniform(0.5, 3.0, size=V)
    assert_matches(*solve_pair(1.0, la_f=la_f, seed=2))


def test_kernel_loop_label_mode():
    """``dif_tol >= 1`` stops on the count of changed maximum-likelihood
    labels: the counts must agree."""
    assert_matches(*solve_pair(0.2, k=3, dif_tol=1.0, it_max=150, seed=4))


def test_kernel_loop_no_remainder():
    """A grid under its natural order decomposes with no remainder."""
    eu, ev, la = make_grid_graph(16, 16, seed=6)
    v, k = 256, 4
    r = np.random.default_rng(7)
    q = r.random((v, k))
    q /= q.sum(axis=1, keepdims=True)
    base = jpfdr(J.GraphD1.create(eu, ev, 0.1 * la, num_vertices=v,
                                  dtype=jnp.float64),
                 jnp.asarray(q), al=0.5,
                 opt=J.PFDROptions(dif_tol=1e-7, it_max=200, fused="off"))
    tg = T.CirculantGraphD1.create(eu, ev, 0.1 * la, num_vertices=v,
                                   dtype=torch.float64, device="cpu",
                                   max_families=4, min_count=2)
    assert tg.num_rem == 0 and tg.rem_graph is None
    res = T.pfdr_loss_d1_simplex(
        tg, torch.from_numpy(q), al=0.5,
        opt=T.PFDROptions(dif_tol=1e-7, it_max=200, fused="on"))
    assert_matches(base, res)


@pytest.mark.parametrize("label_mode", [False, True],
                         ids=["evolution", "labels"])
def test_plain_step_matches_jax_staged(label_mode):
    """One call of ``circulant_simplex_plain`` on ``[K, V]`` / ``[K, E]``
    planes against the JAX staged iteration on the JAX container, from the
    same random state; ``zu`` and ``zv`` on the real slots only."""
    eu, ev, la, q = mesh_problem(seed=5)
    k = q.shape[1]
    jg = J.CirculantGraphD1.create(eu, ev, la, num_vertices=V,
                                   dtype=jnp.float64, **CIRC_KW)
    tg = T.CirculantGraphD1.create(eu, ev, la, num_vertices=V,
                                   dtype=torch.float64, device="cpu",
                                   **CIRC_KW)
    e = tg.num_edges
    live = (tg.la_d1.numpy() != 0)[:, None]
    r = np.random.default_rng(6)
    p = r.dirichlet(np.ones(k), V)
    laf = r.uniform(0.5, 1.5, V)
    ga = r.uniform(0.1, 1.0, (V, k))
    gap = ga / ga.max(axis=1, keepdims=True)
    prev = (np.argmax(r.random((V, k)), axis=1)[:, None].astype(float)
            if label_mode else r.dirichlet(np.ones(k), V))
    zu, zv = r.normal(size=(2, e, k))
    wu, wv, th = r.uniform(0.05, 0.5, (3, e, k)) * live
    w_d1u = np.where(live, r.uniform(0.05, 0.95, (e, k)), 0.5)
    w_d1v = 1.0 - w_d1u
    al, rho = 0.5, 1.4

    # JAX staged iteration (solvers/pfdr_simplex.py loop body)
    fp = 2.0 * p - ga * np.asarray(j_loss_grad(al, jnp.asarray(p),
                                                jnp.asarray(q),
                                                jnp.asarray(laf)))
    fpu, fpv = jg.gather_endpoints(jnp.asarray(fp))
    spu, spv = jg.gather_endpoints(jnp.asarray(p))
    pu, pv = j_pair_prox(fpu - zu, fpv - zv, w_d1u, w_d1v, th)
    zu_j = zu + rho * (pu - spu)
    zv_j = zv + rho * (pv - spv)
    acc = jg.edge_to_vertex_sum(wu * zu_j, wv * zv_j)
    p_j = np.asarray(j_proj_simplex(acc, jnp.asarray(gap), 1.0))
    if label_mode:
        dif_j = float(np.sum(np.argmax(p_j, axis=1)[:, None] != prev))
    else:
        dif_j = float(np.abs(p_j - prev).sum())

    def planes(a):
        return torch.from_numpy(np.ascontiguousarray(a.T))

    out = cfs.fused_circulant_simplex_iteration(
        tg, planes(p), planes(q), planes(laf[:, None]), planes(ga),
        planes(gap), planes(prev), planes(zu), planes(zv), planes(wu),
        planes(wv), planes(w_d1u), planes(w_d1v), planes(th), rho=rho, al=al,
        has_laf=True, label_mode=label_mode)
    p_t, prev_t, zu_t, zv_t, dif_t = (a.numpy() for a in out)
    real = live[:, 0]
    np.testing.assert_allclose(p_t.T, p_j, rtol=0, atol=1e-13)
    np.testing.assert_allclose(zu_t.T[real], np.asarray(zu_j)[real], rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(zv_t.T[real], np.asarray(zv_j)[real], rtol=0,
                               atol=1e-13)
    if label_mode:
        np.testing.assert_array_equal(prev_t[0], np.argmax(p_j, axis=1))
        assert float(dif_t) == dif_j
    else:
        np.testing.assert_allclose(prev_t.T, p_j, rtol=0, atol=1e-13)
        np.testing.assert_allclose(float(dif_t), dif_j, rtol=1e-12)


@pytest.mark.parametrize("mode", ["monitor", "recondition", "verbose"])
def test_kernel_loop_serves_monitor_and_recondition(mode, capsys):
    """Monitoring, reconditioning and progress lines between the launches
    of the circulant kernel loop (``fused="on"``, plain version on the CPU)
    against the JAX staged loop: equal iteration counts, iterates within
    1e-9, objective traces within 1e-10 relative."""
    eu, ev, la, q = mesh_problem(seed=9)
    kw = dict(rho=1.2, dif_tol=1e-8, it_max=300, fused="on")
    if mode == "recondition":
        kw.update(dif_rcd=1e-3, cond_min=1e-2)
    if mode == "verbose":
        kw["verbose"] = 50
    jopt = J.PFDROptions(**dict(kw, fused="off"))
    monitor = mode != "verbose"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rj = jpfdr(J.GraphD1.create(eu, ev, la, num_vertices=V,
                                    dtype=jnp.float64),
                   jnp.asarray(q), al=0.5, opt=jopt, monitor=monitor)
    capsys.readouterr()
    tg = T.CirculantGraphD1.create(eu, ev, la, num_vertices=V,
                                   dtype=torch.float64, device="cpu",
                                   **CIRC_KW)
    rt = T.pfdr_loss_d1_simplex(tg, torch.from_numpy(q), al=0.5,
                                monitor=monitor, opt=T.PFDROptions(**kw))
    it = rt.it
    assert it == int(rj.it)
    np.testing.assert_allclose(rt.p.numpy(), np.asarray(rj.p), rtol=0,
                               atol=1e-9)
    if monitor:
        np.testing.assert_allclose(rt.obj[:it + 1].numpy(),
                                   np.asarray(rj.obj)[:it + 1], rtol=1e-10)
    else:
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("PFDR iteration")]
        assert len(lines) == it // 50


def test_jax_state_resumes_in_port():
    """A JAX solve on a ``CirculantGraphD1`` stopped at 60 iterations,
    carried through ``convert``, resumes in the port's kernel loop to the
    uninterrupted JAX result."""
    eu, ev, la, q = mesh_problem(seed=8)
    jg = J.CirculantGraphD1.create(eu, ev, la, num_vertices=V,
                                   dtype=jnp.float64, **CIRC_KW)
    qd = jnp.asarray(q)

    def jopt(it_max):
        return J.PFDROptions(dif_tol=0.0, it_max=it_max, fused="off")

    full = jpfdr(jg, qd, al=1.0, opt=jopt(120))
    _, st = jpfdr(jg, qd, al=1.0, opt=jopt(60), return_state=True)
    state = convert.simplex_solve_state(
        st.p, st.zu, st.zv, [np.asarray(a) for a in st.pre], st.prev,
        st.dif, st.dif_rcd, st.it, device="cpu")
    tg = convert.circulant_graph(eu, ev, la, V, device="cpu", **CIRC_KW)
    opt = dataclasses.replace(
        convert.pfdr_options(dataclasses.asdict(jopt(120))), fused="on")
    res = T.pfdr_loss_d1_simplex(tg, torch.from_numpy(q), al=1.0, opt=opt,
                                 state0=state)
    assert res.it == int(full.it) == 120
    np.testing.assert_allclose(res.p.numpy(), np.asarray(full.p), rtol=0,
                               atol=1e-9)
