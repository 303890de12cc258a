"""The port's row-sharded (halo) stencil PFDR against the JAX package's.

The port runs in gloo ranks on the CPU, spawned once for this module at
P = 2 and at P = 4 (``_torch_ranks.halo_cases``: each rank runs every case
on the JAX package's sharded problems, carried over by ``convert``); the
JAX side runs here on the conftest's virtual CPU devices.  Tolerances are
the JAX tests' (``tests/test_parallel.py``): float64, ``atol=1e-9`` and the
same iteration count.  ``fused="on"`` takes the plain version of the halo
kernels in the port and the interpret mode of the Pallas kernel in JAX.
"""
import ast
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp_pfdr_graph_d1_tpu import DenseOp, PFDROptions, VertexProx
from cp_pfdr_graph_d1_tpu.parallel import (make_mesh,
                                           pfdr_quadratic_d1_halo,
                                           shard_stencil_problem,
                                           shard_stencil_simplex_problem)
from cp_pfdr_graph_d1_tpu.solvers.pfdr_quadratic import pfdr_quadratic_d1
from cp_pfdr_graph_d1_tpu.solvers.pfdr_simplex import pfdr_loss_d1_simplex
from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1
import cp_pfdr_graph_d1_tpu_torch as tp

from . import _torch_ranks as tr

SHARDS = (2, 4)


def _jgraph(pb):
    return StencilGraphD1.create(pb["shape"], pb["sw"], wrap=pb["wrap"],
                                 dtype=jnp.float64)


def _jsimplex_graph(case):
    h, w, _, _, weight = case
    return StencilGraphD1.create((h, w), {(0, 1): weight, (1, 0): weight},
                                 dtype=jnp.float64)


def _fields(nt):
    return tuple(np.asarray(v) if isinstance(v, (np.ndarray, jnp.ndarray))
                 else v for v in nt)


def _la_f(al):
    return None if al == 0.0 else np.full(16 * 6, 0.8)


def jax_fields(p):
    """The JAX package's sharded problems of every case, for ``p`` ranks."""
    out = {}
    for name, pb in (("stencil", tr.halo_stencil_problem()),
                     ("fused", tr.halo_fused_problem()),
                     ("wrapped", tr.halo_wrapped_problem())):
        out[name] = _fields(shard_stencil_problem(pb["a"], pb["y"],
                                                  _jgraph(pb), p))
    for al in (0.0, 0.5):
        out[f"simplex_{al}"] = _fields(shard_stencil_simplex_problem(
            tr.simplex_case_q(tr.SIMPLEX_HALO),
            _jsimplex_graph(tr.SIMPLEX_HALO), p, la_f=_la_f(al)))
    out["simplex_labels"] = _fields(shard_stencil_simplex_problem(
        tr.simplex_case_q(tr.SIMPLEX_LABELS),
        _jsimplex_graph(tr.SIMPLEX_LABELS), p))
    return out


@pytest.fixture(scope="module")
def ranks():
    """Every case of this module in P = 2 and P = 4 gloo ranks."""
    fields = {p: jax_fields(p) for p in SHARDS}
    return tr.spawn_rings(tr.halo_cases, SHARDS, lambda p: (fields[p],))


def _jax_quadratic(pb, *, opt, vprox, mesh_p=None):
    if mesh_p is None:
        return pfdr_quadratic_d1(
            DenseOp(jnp.asarray(pb["a"])), jnp.asarray(pb["y"]),
            _jgraph(pb), la_l1=(None if pb["la_l1"] is None
                                else jnp.asarray(pb["la_l1"])),
            vprox=vprox, lipsch=pb["lip"], opt=opt)
    prob = shard_stencil_problem(pb["a"], pb["y"], _jgraph(pb), mesh_p)
    return pfdr_quadratic_d1_halo(prob, make_mesh(mesh_p),
                                  la_l1=pb["la_l1"], vprox=vprox,
                                  lipsch=pb["lip"], opt=opt)


@functools.lru_cache(maxsize=None)
def jax_stencil():
    return _jax_quadratic(tr.halo_stencil_problem(),
                          opt=PFDROptions(rho=1.2, dif_tol=1e-8, it_max=800),
                          vprox=VertexProx(kind="l1"))


@functools.lru_cache(maxsize=None)
def jax_fused(p):
    return _jax_quadratic(
        tr.halo_fused_problem(), mesh_p=p,
        opt=PFDROptions(rho=1.4, dif_tol=1e-9, it_max=120, fused="on"),
        vprox=VertexProx(kind="l1", positivity=True))


@functools.lru_cache(maxsize=None)
def jax_wrapped():
    return _jax_quadratic(tr.halo_wrapped_problem(),
                          opt=PFDROptions(dif_tol=1e-8, it_max=500),
                          vprox=VertexProx())


def _same_on_every_rank(outs, case, key):
    for o in outs[1:]:
        np.testing.assert_array_equal(o[case][key], outs[0][case][key])


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("fused", ["off", "on"])
def test_halo_stencil_matches_jax(ranks, p, fused):
    """Vertex-sharded stencil PFDR (staged halo loop, and the plain halo
    kernels) against the JAX package's single-device solve, as
    ``test_halo_stencil_matches_single_device``."""
    base = jax_stencil()
    out = ranks[p][0][f"stencil_{fused}"]
    assert out["it"] == int(base.it)
    np.testing.assert_allclose(out["x"], np.asarray(base.x), atol=1e-9)
    _same_on_every_rank(ranks[p], f"stencil_{fused}", "x")


@pytest.mark.parametrize("p", SHARDS)
def test_halo_kernel_plain_matches_jax_interpret(ranks, p):
    """``fused="on"``: the port's plain halo kernels against the JAX
    package's halo Pallas kernel in interpret mode on the same ring size
    (halo depth 2, a negative dx), float64."""
    base = jax_fused(p)
    out = ranks[p][0]["fused_on"]
    assert out["it"] == int(base.it)
    np.testing.assert_allclose(out["x"], np.asarray(base.x), atol=1e-9)


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("fused", ["off", "on"])
def test_halo_wrapped_axis0(ranks, p, fused):
    """A wrapped global axis 0 rides the ring, as
    ``test_halo_wrapped_axis0``."""
    base = jax_wrapped()
    out = ranks[p][0][f"wrapped_{fused}"]
    assert out["it"] == int(base.it)
    np.testing.assert_allclose(out["x"], np.asarray(base.x), atol=1e-9)


@functools.lru_cache(maxsize=None)
def jax_simplex(case, al, dif_tol, rho, it_max):
    q = tr.simplex_case_q(case)
    return pfdr_loss_d1_simplex(
        _jsimplex_graph(case), jnp.asarray(q, jnp.float64), al=al,
        la_f=_la_f(al) if case == tr.SIMPLEX_HALO else None,
        opt=PFDROptions(rho=rho, dif_tol=dif_tol, it_max=it_max))


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("al", [0.0, 0.5])
def test_halo_simplex_matches_jax(ranks, p, al):
    """Vertex-sharded multi-label PFDR against the JAX package's
    single-device solve, as ``test_halo_simplex_matches_single_device``."""
    base = jax_simplex(tr.SIMPLEX_HALO, al, 1e-8, 1.3, 300)
    out = ranks[p][0][f"simplex_{al}"]
    assert out["it"] == int(base.it)
    np.testing.assert_allclose(out["p"], np.asarray(base.p), atol=1e-9)


@pytest.mark.parametrize("p", SHARDS)
def test_halo_simplex_label_count_stopping(ranks, p):
    """The label-count stopping test sums across the row blocks, as
    ``test_halo_simplex_label_count_stopping``."""
    base = jax_simplex(tr.SIMPLEX_LABELS, 0.5, 1.0, 1.0, 200)
    out = ranks[p][0]["simplex_labels"]
    assert out["it"] == int(base.it)
    np.testing.assert_allclose(out["p"], np.asarray(base.p), atol=1e-9)


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("al", [0.0, 0.5])
def test_halo_simplex_dif_matches_single_device(ranks, p, al):
    """The evolution of a row-sharded multi-label solve divides by the
    global vertex count (``vertex_count_global``): its ``dif`` trace is the
    single-device one."""
    case = tr.SIMPLEX_HALO
    h, w, k, seed, weight = case
    la_f = _la_f(al)
    res = tp.pfdr_loss_d1_simplex(
        tr.simplex_stencil(h, w, weight),
        torch.as_tensor(tr.simplex_case_q(case)), al=al,
        la_f=None if la_f is None else torch.as_tensor(la_f),
        opt=tp.PFDROptions(rho=1.3, dif_tol=1e-8, it_max=300),
        monitor=True)
    out = ranks[p][0][f"simplex_{al}"]
    assert out["it"] == res.it
    np.testing.assert_allclose(out["dif"][:res.it], res.dif[:res.it].numpy(),
                               rtol=1e-9, atol=1e-15)


def test_self_ring_equals_single_device(ranks):
    """P = 1: the ring is a local copy, and the halo solve (through the
    plain halo kernels) is the port's own single-device solve."""
    pb = tr.halo_stencil_problem()
    g = tr._stencil(pb)
    res = tp.pfdr_quadratic_d1(
        tp.DenseOp(torch.as_tensor(pb["a"])), torch.as_tensor(pb["y"]), g,
        la_l1=torch.as_tensor(pb["la_l1"]), vprox=tp.VertexProx(kind="l1"),
        lipsch=pb["lip"], opt=tp.PFDROptions(rho=1.2, dif_tol=1e-8,
                                             it_max=800, fused="off"))
    for p in SHARDS:
        out = ranks[p][0]["self_ring"]
        assert out["it"] == res.it
        np.testing.assert_allclose(out["x"], res.x.numpy(), atol=1e-12)


def test_parallel_imports_no_jax():
    """No module of the port's ``parallel`` package (nor the halo kernel's
    wrapper) imports JAX or the JAX package."""
    root = Path(tp.__file__).parent
    files = sorted((root / "parallel").glob("*.py")) + [
        root / "ops" / "halo_fused.py"]
    assert len(files) >= 6
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "cp_pfdr_graph_d1_tpu"), \
                    f"{f.name} imports {n}"
