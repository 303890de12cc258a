"""Port's device connected components against the JAX package and scipy.

The plain version of the ``components_fused`` kernel (CPU tensors) and the
generic propagation of ``ops/components`` must give the labels of the JAX
package's Pallas kernel (interpret mode, 12 x 16 fields), of its generic
device components and of scipy bit for bit: the fixpoint is unique.  The
48 x 48, 45 %-active snake case is the regression of
``tests/test_cut_pursuit_chain.py`` (a round cap below V under-converged).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp_pfdr_graph_d1_tpu.ops import components as jcomp
from cp_pfdr_graph_d1_tpu.ops import components_fused as jcf
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit_device import \
    _device_components as jax_device_components
from cp_pfdr_graph_d1_tpu.graph import GraphD1 as JGraph
from cp_pfdr_graph_d1_tpu.stencil import StencilGraphD1 as JStencil
from cp_pfdr_graph_d1_tpu_torch import GraphD1, StencilGraphD1
from cp_pfdr_graph_d1_tpu_torch.ops import components as tcomp
from cp_pfdr_graph_d1_tpu_torch.ops import components_fused as tcf
from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit_common import \
    connected_components
from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit_device import \
    _device_components
from ._torch_cuda_source import (assert_struct_mirrors, cuda_constant,
                                cuda_source)

torch.set_num_threads(1)


def stencil_pair(h, w, shifts=((0, 1), (1, 0))):
    weights = {s: 0.3 for s in shifts}
    return (JStencil.create((h, w), weights, dtype=jnp.float64),
            StencilGraphD1.create((h, w), weights, dtype=torch.float64,
                                  device="cpu"))


def scipy_roots(g, mask):
    """Smallest vertex of each vertex's component, from scipy."""
    eu, ev, _ = g.host_coo()
    n, cv = connected_components(g.num_vertices, eu, ev, mask)
    first = np.full(n, g.num_vertices)
    np.minimum.at(first, cv, np.arange(g.num_vertices))
    return first[cv], n, cv


@pytest.mark.parametrize("frac,shifts,shape", [
    pytest.param(0.1, ((0, 1), (1, 0)), (12, 16), id="0.1-shifts0"),
    pytest.param(0.45, ((0, 1), (1, 0)), (12, 16), id="0.45-shifts1"),
    pytest.param(0.45, ((0, 1), (1, 0), (1, 1), (1, -1)), (12, 16),
                 id="0.45-shifts2"),
    pytest.param(0.3, ((0, 1), (1, 0)), (1, 16), id="one-row"),
    pytest.param(0.3, ((0, -1), (-1, 1)), (12, 16), id="negative-shifts")])
def test_plain_kernel_matches_pallas_kernel_and_scipy(frac, shifts, shape):
    gj, gt = stencil_pair(*shape, shifts)
    r = np.random.default_rng(int(frac * 100) + len(shifts))
    mask = (r.random(gt.num_edges) >= frac) & (gt.host_coo()[2] > 0)
    want, _, _ = scipy_roots(gt, mask)
    got_j = np.asarray(jcf.stencil_components_fused(
        gj, jnp.asarray(mask), interpret=True))
    got_t = tcf.stencil_components_fused(gt, torch.from_numpy(mask))
    np.testing.assert_array_equal(got_j, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(
        tcomp.connected_components_device(gt, torch.from_numpy(mask)).numpy(),
        want)


def test_snake_components_converge():
    """48 x 48 at 45 % active edges: the stencil kernel's plain version and
    the generic propagation on the COO view (zero-weight slots dropped)
    both reach scipy's labelling and component count."""
    side = 48
    _, gt = stencil_pair(side, side)
    act = np.random.default_rng(5).random(gt.num_edges) < 0.45
    eu, ev, la = gt.host_coo()
    _, nc_true, cv_true = scipy_roots(gt, ~act & (la > 0))
    cvf, ncf, _ = _device_components(gt, torch.from_numpy(act))
    assert int(ncf) == nc_true
    np.testing.assert_array_equal(cvf.numpy(), cv_true)
    keep = la > 0
    gc = GraphD1.create(eu[keep], ev[keep], la[keep], num_vertices=side**2,
                        dtype=torch.float64, device="cpu")
    cvg, ncg, _ = _device_components(gc, torch.from_numpy(act[keep]))
    assert int(ncg) == nc_true
    np.testing.assert_array_equal(cvg.numpy(), cv_true)


def test_compact_labels_match_jax():
    _, gt = stencil_pair(12, 16)
    act = np.random.default_rng(2).random(gt.num_edges) < 0.3
    roots, _, _ = scipy_roots(gt, ~act & (gt.host_coo()[2] > 0))
    cv_j, n_j, f_j = jcf.compact_labels_device(jnp.asarray(roots,
                                                           jnp.int32))
    cv_t, n_t, f_t = tcf.compact_labels_device(torch.from_numpy(roots))
    np.testing.assert_array_equal(cv_t.numpy(), np.asarray(cv_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    assert int(n_t) == int(n_j)
    n_h, cv_h = tcomp.compact_labels(roots)
    n_jh, cv_jh = jcomp.compact_labels(roots)
    assert n_h == n_jh == int(n_t)
    np.testing.assert_array_equal(cv_h, cv_jh)


def test_coo_device_components_match_jax():
    """Generic route (incidence min-reduction + pointer jumping) on a
    random COO graph with a hub vertex, against the JAX package's."""
    r = np.random.default_rng(4)
    v = 120
    eu = np.concatenate([r.integers(0, v, 150), np.zeros(60, int)])
    ev = np.concatenate([r.integers(0, v, 150), r.integers(1, v, 60)])
    la = r.uniform(0.1, 1.0, eu.shape[0])
    la[::17] = 0.0
    act = r.random(eu.shape[0]) < 0.5
    gj = JGraph.create(eu, ev, la, num_vertices=v, dtype=jnp.float64)
    gt = GraphD1.create(eu, ev, la, num_vertices=v, dtype=torch.float64,
                        device="cpu")
    cv_j, n_j, f_j = jax_device_components(gj, jnp.asarray(act))
    cv_t, n_t, f_t = _device_components(gt, torch.from_numpy(act))
    assert int(n_t) == int(n_j)
    np.testing.assert_array_equal(cv_t.numpy(), np.asarray(cv_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))


def test_hub_graph_transfers_match_numpy():
    """A hub vertex makes the incidence table wide (one row per vertex, as
    long as the hub's degree); the edge -> vertex sum and minimum over it
    match numpy's."""
    r = np.random.default_rng(6)
    v = 3000
    eu = np.concatenate([np.zeros(2000, int), r.integers(0, v, 500)])
    ev = np.concatenate([np.arange(1, 2001), r.integers(0, v, 500)])
    g = GraphD1.create(eu, ev, r.random(eu.shape[0]), num_vertices=v,
                       dtype=torch.float64, device="cpu")
    assert tuple(g.incidence.shape) == (v, np.bincount(np.r_[eu, ev]).max())
    a, b = r.random(eu.shape[0]), r.random(eu.shape[0])
    want = np.zeros(v)
    np.add.at(want, eu, a)
    np.add.at(want, ev, b)
    got = g.edge_to_vertex_sum(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)
    ia, ib = r.integers(0, 10 * v, (2, eu.shape[0]))
    want = np.full(v, 7 * v)
    np.minimum.at(want, eu, ia)
    np.minimum.at(want, ev, ib)
    got = g.edge_to_vertex_min(torch.from_numpy(ia), torch.from_numpy(ib),
                               7 * v)
    np.testing.assert_array_equal(got.numpy(), want)


# -- the kernel's union-find schedule, mirrored in Python ----------------------

def union_find_schedule(mask, shifts, tile):
    """Sequential copy of ``csrc/components_fused.cu``'s passes (tiles of
    ``tile`` = (rows, columns)), kept as the statement of the schedule's
    twin-skip argument: it tests this copy, not the CUDA source, which
    ``chip_smoke.py`` holds against the plain version on the card.
    The tile pass: each cell's run is the start of the cells joined to
    their left neighbours in its tile row by set edges of a (0, +-1)
    family; every other set edge with both ends in the tile hooks its two
    runs (the larger root under the smaller) unless its twin (the previous
    cell along the other axis, in the same tile) has that edge set between
    the same two runs; each cell's tile label is its root.  The hook pass
    does the same with the edges that leave their tile, on the tile
    labels, and the flatten pass takes every cell to its root.  Returns the
    labels and how many times each set edge was taken (in a run, hooked,
    or skipped for its twin or for joining one run or tile label)."""
    f, h, w = mask.shape
    th, tw = tile
    par = np.arange(h * w)
    run = np.arange(h * w)
    taken = np.zeros(mask.shape, int)

    def find(x):
        while par[x] != x:
            x = par[x]
        return x

    def unite(a, b):
        a, b = find(a), find(b)
        if a != b:
            par[max(a, b)] = min(a, b)

    def head(k, i, j):
        return (i + shifts[k][0]) % h, (j + shifts[k][1]) % w

    def tile_of(i, j):
        return i // th, j // tw

    def run_edge(k, j):
        dy, dx = shifts[k]
        return (dy == 0 and dx in (1, -1) and 0 <= j + dx < w
                and (j + dx) // tw == j // tw)

    def twin(k, i, j):
        if shifts[k][0] != 0:
            return (i, j - 1) if j % tw else None
        return (i - 1, j) if i % th else None

    def hook(i, j, k, local, ids):
        vi, vj = head(k, i, j)
        if local != (tile_of(vi, vj) == tile_of(i, j)):
            return
        taken[k, i, j] += 1
        if local and run_edge(k, j):
            return
        a, b = ids[i * w + j], ids[vi * w + vj]
        if a == b:
            return
        t = twin(k, i, j)
        if t is not None and mask[k, t[0], t[1]]:
            ui, uj = head(k, *t)
            if (tile_of(ui, uj) == tile_of(vi, vj)
                    and ids[t[0] * w + t[1]] == a and ids[ui * w + uj] == b):
                return
        unite(a, b)

    cells = [(i, j) for i in range(h) for j in range(w)]
    for t in sorted({tile_of(i, j) for i, j in cells}):
        mine = [(i, j) for i, j in cells if tile_of(i, j) == t]
        for i, j in mine:
            left = j % tw > 0 and any(
                (dy, dx) == (0, 1) and mask[k, i, j - 1]
                or (dy, dx) == (0, -1) and mask[k, i, j]
                for k, (dy, dx) in enumerate(shifts))
            run[i * w + j] = run[i * w + j - 1] if left else i * w + j
        for i, j in mine:
            for k in range(f):
                if mask[k, i, j]:
                    hook(i, j, k, True, run)
        for i, j in mine:
            par[i * w + j] = find(run[i * w + j])
    tl = par.copy()
    for i, j in cells:
        for k in range(f):
            if mask[k, i, j]:
                hook(i, j, k, False, tl)
    return np.array([find(tl[c]) for c in range(h * w)]), taken


@pytest.mark.parametrize("shape,shifts,tile,wrap", [
    ((13, 11), ((0, 1), (1, 0), (1, 1), (1, -1)), (4, 4), (True, True)),
    ((9, 14), ((0, -1), (-1, 1)), (4, 8), (True, False))],
    ids=["four-families-wrapped", "negative-shifts"])
def test_union_find_schedule_matches_scipy(shape, shifts, tile, wrap):
    """The copy of the kernel's passes takes every set edge exactly once
    and gives scipy's smallest-vertex labels, with twins and tile
    boundaries on every axis (small tiles, wrapped and diagonal
    families)."""
    weights = {s: 0.3 for s in shifts}
    gt = StencilGraphD1.create(shape, weights, wrap=wrap,
                               dtype=torch.float64, device="cpu")
    r = np.random.default_rng(len(shifts) + shape[0])
    mask = (r.random(gt.num_edges) >= 0.4) & (gt.host_coo()[2] > 0)
    want, _, _ = scipy_roots(gt, mask)
    m3 = mask.reshape(len(shifts), *shape)
    got, taken = union_find_schedule(m3, shifts, tile)
    np.testing.assert_array_equal(taken, m3.astype(int))
    np.testing.assert_array_equal(got, want)


def test_plan_mirrors_the_cuda_source():
    """``_Plan`` has ``CompPlan``'s fields at the same offsets, and the
    constants mirrored from the source agree."""
    src = cuda_source("components_fused.cu")
    assert_struct_mirrors(src, "CompPlan", tcf._Plan)
    for name, value in (("kCompThreads", tcf.THREADS),
                        ("kCompPasses", tcf.PASSES)):
        assert cuda_constant(src, name) == value


def test_cpu_call_runs_the_plain_version():
    """On CPU tensors the wrapper runs the plain version (its rounds of
    propagation) and launches nothing."""
    _, gt = stencil_pair(12, 16)
    mask = torch.from_numpy(np.random.default_rng(9).random(
        (2, 12, 16)) >= 0.3)
    before = tcf.fused_components.launches
    lab, rounds = tcf.fused_components(mask, shifts=gt.shifts, it_max=192)
    want, want_rounds = tcf.components_plain(mask, shifts=gt.shifts,
                                             it_max=192)
    assert torch.equal(lab, want) and int(rounds) == int(want_rounds)
    assert tcf.fused_components.launches == before
