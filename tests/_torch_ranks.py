"""Rank side of the port's distributed tests: the problems (numpy, seeded)
and the solves each rank of a gloo process group runs on the CPU.

Imports the port and never JAX: the test modules spawn ranks that import
this module (``parallel.spawn_ranks``), and compare what the ranks return
with the JAX package's solves on the same problems in the test process.
Each ``*_cases`` function runs every case of one test module in one rank
and returns a dict of numpy results.
"""
import concurrent.futures

import numpy as np
import torch

HALO_FUSED_SHIFTS = {(0, 1): 0.1, (1, 0): 0.12, (2, 0): 0.05, (1, -1): 0.07}


def grid_graph(h, w, seed=0, weight_scale=1.0):
    """2-D 4-neighbourhood grid with random positive weights (the JAX
    tests' ``conftest.make_grid_graph``)."""
    r = np.random.default_rng(seed)
    idx = np.arange(h * w).reshape(h, w)
    eu = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    ev = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    la = weight_scale * (0.5 + r.random(eu.shape[0]))
    return eu.astype(np.int32), ev.astype(np.int32), la


def simplex_q(h, w, k, seed=0):
    r = np.random.default_rng(seed)
    v = h * w
    labels = np.arange(v) * k // v
    q = np.full((v, k), 0.1 / k)
    q[np.arange(v), labels] += 0.9
    q += 0.05 * r.random((v, k))
    return q / q.sum(axis=1, keepdims=True)


def spawn_rings(fn, shards, args=lambda p: ()):
    """``{P: results of spawn_ranks(fn, P, *args(P))}`` for each ring size
    of ``shards``, the rings run at once."""
    from cp_pfdr_graph_d1_tpu_torch.parallel import spawn_ranks
    with concurrent.futures.ThreadPoolExecutor(len(shards)) as ex:
        futs = {p: ex.submit(spawn_ranks, fn, p, *args(p)) for p in shards}
        return {p: f.result() for p, f in futs.items()}


# -- problems ----------------------------------------------------------------

def halo_stencil_problem():
    """``test_parallel.py::test_halo_stencil_matches_single_device``'s."""
    h, w, n = 16, 12, 32
    r = np.random.default_rng(9)
    sw = {(0, 1): r.uniform(0.1, 0.4, (h, w)),
          (1, 0): r.uniform(0.1, 0.4, (h, w))}
    a = r.normal(size=(n, h * w)) / np.sqrt(n)
    x_true = np.zeros((h, w))
    x_true[4:10, 3:9] = 1.0
    y = a @ x_true.ravel() + 0.02 * r.normal(size=n)
    return dict(shape=(h, w), sw=sw, wrap=(False, True), a=a, y=y,
                la_l1=np.full(h * w, 0.02),
                lip=float(np.linalg.svd(a, compute_uv=False)[0] ** 2))


def halo_fused_problem():
    """``test_halo_fused_matches_staged``'s, float64: hd = 2 and a
    negative dx."""
    h, w, n = 16, 12, 24
    r = np.random.default_rng(1)
    a = r.standard_normal((n, h * w)) / np.sqrt(n)
    y = r.standard_normal(n)
    return dict(shape=(h, w), sw=HALO_FUSED_SHIFTS, wrap=(False, False), a=a,
                y=y, la_l1=np.full(h * w, 0.02),
                lip=float(np.linalg.svd(a, compute_uv=False)[0] ** 2))


def halo_wrapped_problem():
    """``test_halo_wrapped_axis0``'s: both axes wrap."""
    h, w, n = 8, 10, 24
    r = np.random.default_rng(11)
    a = r.normal(size=(n, h * w)) / np.sqrt(n)
    y = a @ r.normal(size=h * w)
    return dict(shape=(h, w), sw={(0, 1): 0.2, (1, 0): 0.2},
                wrap=(True, True), a=a, y=y, la_l1=None,
                lip=float(np.linalg.svd(a, compute_uv=False)[0] ** 2))


def dp_problem(v=100, n=48, seed=0):
    """``test_parallel.py::make_problem``'s."""
    eu, ev, la = grid_graph(10, v // 10, seed=seed)
    r = np.random.default_rng(seed + 500)
    a = r.normal(size=(n, v)) / np.sqrt(n)
    x_true = np.zeros(v)
    x_true[r.integers(0, v, 8)] = r.normal(size=8) * 2
    y = a @ x_true + 0.05 * r.normal(size=n)
    return eu, ev, 0.1 * la, a, y


def cp_problem(h=8, w=8, n=91, seed=3):
    """``test_parallel.py::_cp_problem``'s (n = 91: the observation axis
    needs padding at every P > 1)."""
    v = h * w
    eu, ev, la = grid_graph(h, w, seed=seed)
    r = np.random.default_rng(seed + 700)
    a = r.normal(size=(n, v)) / np.sqrt(n)
    x_true = np.zeros((h, w))
    x_true[1:4, 1:4] = 1.5
    x_true[5:7, 4:7] = -2.0
    y = a @ x_true.ravel() + 0.02 * r.normal(size=n)
    return eu, ev, 0.3 * la, a, y


def cp_simplex_problem():
    """``test_cp_simplex_dist_matches_single_device``'s."""
    r = np.random.default_rng(77)
    h, w, k = 10, 10, 3
    v = h * w
    eu, ev, la = grid_graph(h, w, seed=78)
    labels_true = (np.arange(v) // (v // k)).clip(0, k - 1)
    q = np.full((v, k), 0.15)
    q[np.arange(v), labels_true] = 0.7
    q += 0.05 * r.random((v, k))
    q /= q.sum(axis=1, keepdims=True)
    return eu, ev, 0.3 * la, q


# -- rank side ---------------------------------------------------------------

def _stencil(pb):
    from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1
    return StencilGraphD1.create(pb["shape"], pb["sw"], wrap=pb["wrap"],
                                 dtype=torch.float64, device="cpu")


def _halo_solve(mesh, prob, pb, fused, it_max=800, rho=1.2, dif_tol=1e-8,
                vprox=None):
    from cp_pfdr_graph_d1_tpu_torch import PFDROptions, VertexProx
    from cp_pfdr_graph_d1_tpu_torch.parallel import pfdr_quadratic_d1_halo
    if vprox is None:
        vprox = (VertexProx(kind="l1") if pb["la_l1"] is not None
                 else VertexProx())
    res = pfdr_quadratic_d1_halo(
        prob, mesh, la_l1=pb["la_l1"], vprox=vprox, lipsch=pb["lip"],
        opt=PFDROptions(rho=rho, dif_tol=dif_tol, it_max=it_max,
                        fused=fused), device="cpu")
    return dict(x=res.x.numpy(), it=res.it)


def simplex_stencil(h, w, weight):
    from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1
    return StencilGraphD1.create((h, w), {(0, 1): weight, (1, 0): weight},
                                 dtype=torch.float64, device="cpu")


# (h, w, K, seed, edge weight) of the multi-label halo cases
SIMPLEX_HALO = (16, 6, 3, 5, 0.25)
SIMPLEX_LABELS = (8, 6, 3, 7, 0.3)


def simplex_case_q(case):
    h, w, k, seed, _ = case
    return simplex_q(h, w, k, seed)


def _halo_simplex(mesh, prob, al, opt, monitor=False):
    from cp_pfdr_graph_d1_tpu_torch.parallel import pfdr_loss_d1_simplex_halo
    res = pfdr_loss_d1_simplex_halo(prob, mesh, al=al, opt=opt,
                                    monitor=monitor, device="cpu")
    return dict(p=res.p.numpy(), it=res.it, dif=res.dif.numpy())


def halo_cases(mesh, fields):
    """Every case of ``test_torch_halo.py`` in this rank.  ``fields`` holds
    the fields of the JAX package's sharded problems for this ring size,
    carried over by :mod:`cp_pfdr_graph_d1_tpu_torch.convert`."""
    from cp_pfdr_graph_d1_tpu_torch import PFDROptions, VertexProx, convert
    from cp_pfdr_graph_d1_tpu_torch.parallel import (make_mesh,
                                                     shard_stencil_problem)
    torch.set_num_threads(1)
    out = {}
    pb = halo_stencil_problem()
    prob = convert.halo_problem(*fields["stencil"])
    out["stencil_off"] = _halo_solve(mesh, prob, pb, "off")
    out["stencil_on"] = _halo_solve(mesh, prob, pb, "on")
    out["fused_on"] = _halo_solve(
        mesh, convert.halo_problem(*fields["fused"]), halo_fused_problem(),
        "on", it_max=120, rho=1.4, dif_tol=1e-9,
        vprox=VertexProx(kind="l1", positivity=True))
    for fused in ("off", "on"):
        out[f"wrapped_{fused}"] = _halo_solve(
            mesh, convert.halo_problem(*fields["wrapped"]),
            halo_wrapped_problem(), fused, it_max=500, rho=1.0)
    for al in (0.0, 0.5):
        out[f"simplex_{al}"] = _halo_simplex(
            mesh, convert.halo_simplex_problem(*fields[f"simplex_{al}"]), al,
            PFDROptions(rho=1.3, dif_tol=1e-8, it_max=300), monitor=True)
    out["simplex_labels"] = _halo_simplex(
        mesh, convert.halo_simplex_problem(*fields["simplex_labels"]), 0.5,
        PFDROptions(rho=1.0, dif_tol=1.0, it_max=200))
    # the self ring: a group of one rank (every rank takes part in making it)
    solo = make_mesh(1)
    if solo is not None:
        out["self_ring"] = _halo_solve(
            solo, shard_stencil_problem(pb["a"], pb["y"], _stencil(pb), 1),
            pb, "on")
    return out


def dp_cases(mesh, fields):
    """Every case of ``test_torch_dp.py`` in this rank, on the JAX
    package's sharded problems (``fields``) for this number of ranks."""
    from cp_pfdr_graph_d1_tpu_torch import PFDROptions, VertexProx, convert
    from cp_pfdr_graph_d1_tpu_torch.parallel import (
        pfdr_loss_d1_simplex_sharded, pfdr_quadratic_d1_sharded)
    torch.set_num_threads(1)
    out = {}
    for name, seed, n, opt in DP_CASES:
        _, _, _, a, _ = dp_problem(seed=seed, n=n)
        lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
        res = pfdr_quadratic_d1_sharded(
            convert.sharded_quadratic_problem(*fields[name]), mesh,
            la_l1=np.full(a.shape[1], 0.03), vprox=VertexProx(kind="l1"),
            lipsch=lip, opt=PFDROptions(**opt), device="cpu")
        out[name] = dict(x=res.x.numpy(), it=res.it)
    for al in (0.0, 1.0, 0.5):
        res = pfdr_loss_d1_simplex_sharded(
            convert.sharded_simplex_problem(*fields["simplex"]), mesh, al=al,
            la_f=np.full(8 * 9, 1.3),
            opt=PFDROptions(rho=1.2, dif_tol=1e-8, it_max=400), device="cpu")
        out[f"simplex_{al}"] = dict(p=res.p.numpy(), it=res.it)
    return out


# (name, seed, N, PFDR options) of the quadratic data-parallel cases: N = 47
# pads the observation axis at P = 2 and 4
DP_CASES = (("quadratic", 0, 48, dict(rho=1.2, dif_tol=1e-7, it_max=600)),
            ("padding", 1, 47, dict(dif_tol=1e-7, it_max=400)))


def cp_dist_cases(mesh):
    """Every case of ``test_torch_cp_dist.py`` in this rank."""
    from cp_pfdr_graph_d1_tpu_torch import (CPOptions, DenseOp, GraphD1,
                                            GramOp, PFDROptions)
    from cp_pfdr_graph_d1_tpu_torch.parallel import (
        cp_loss_d1_simplex_dist, cp_quadratic_d1_dist,
        shard_cp_quadratic_problem)
    torch.set_num_threads(1)
    out = {}

    def graph(eu, ev, la):
        return GraphD1.create(eu, ev, la, dtype=torch.float64, device="cpu")

    def cp(res):
        return dict(cv=res.cv, rx=res.rx, it=res.it, obj=res.obj)

    eu, ev, la, a, y = cp_problem()
    opt = CPOptions(dif_tol=1e-5, it_max=10,
                    pfdr=PFDROptions(rho=1.5, dif_tol=1e-9, it_max=5000))
    out["dense"] = cp(cp_quadratic_d1_dist(
        DenseOp(torch.as_tensor(a)), torch.as_tensor(y), graph(eu, ev, la),
        mesh, la_l1=np.full(a.shape[1], 0.02), opt=opt, monitor=True,
        device="cpu"))
    opt8 = CPOptions(dif_tol=1e-5, it_max=8, host_small="off",
                     pfdr=PFDROptions(dif_tol=1e-9, it_max=5000))
    eu, ev, la, a, y = cp_problem(seed=5)
    out["duplex"] = cp(cp_quadratic_d1_dist(
        DenseOp(torch.as_tensor(a)), torch.as_tensor(y), graph(eu, ev, la),
        mesh, la_l1=np.full(a.shape[1], 0.05), positivity=True, duplex=True,
        opt=opt8, device="cpu"))
    eu, ev, la, a, y = cp_problem(n=128, seed=7)
    out["gram"] = cp(cp_quadratic_d1_dist(
        GramOp(torch.as_tensor(a.T @ a)), torch.as_tensor(a.T @ y),
        graph(eu, ev, la), mesh, la_l1=np.full(a.shape[1], 0.02), opt=opt8,
        device="cpu"))
    try:
        shard_cp_quadratic_problem(GramOp(torch.eye(7, dtype=torch.float64)),
                                   np.ones(7), mesh, device="cpu")
        out["gram_indivisible"] = None
    except ValueError as e:
        out["gram_indivisible"] = str(e)
    eu, ev, la, a, y = cp_problem()
    op, obs = shard_cp_quadratic_problem(DenseOp(torch.as_tensor(a)), y,
                                         mesh, device="cpu")
    out["placement"] = dict(rows=op.a.shape[0], obs=obs.shape[0],
                            num_obs=op.num_obs, first=op.a[0].numpy())
    eu, ev, la, q = cp_simplex_problem()
    sopt = CPOptions(dif_tol=1e-4, it_max=6, host_small="off",
                     pfdr=PFDROptions(rho=1.2, dif_tol=1e-7, it_max=2000))
    res = cp_loss_d1_simplex_dist(graph(eu, ev, la), q, mesh, al=0.5,
                                  opt=sopt, monitor=True, device="cpu")
    out["simplex"] = dict(cv=res.cv, rp=res.rp, it=res.it, obj=res.obj)
    out.update(cp_dist_device_cases(mesh))
    out["reduced"] = cp_dist_reduced_cases(mesh)
    return out


def cp_stencil_weights(h=8, w=8, seed=3):
    """``cp_problem``'s edge weights as the shift weights of a stencil
    ``{(0, 1): [h, w], (1, 0): [h, w]}`` (zero where an edge leaves the
    field): the same graph as its COO edge list."""
    _, _, la, _, _ = cp_problem(h, w, seed=seed)
    right = np.zeros((h, w))
    right[:, :-1] = la[:h * (w - 1)].reshape(h, w - 1)
    down = np.zeros((h, w))
    down[:-1, :] = la[h * (w - 1):].reshape(h - 1, w)
    return {(0, 1): right, (1, 0): down}


def cp_dist_device_options(**kw):
    """The ``cut="device"`` cases' options (``test_torch_cp_dist.py``):
    ``(dense/chain options, Gram/duplex options)`` with ``kw`` added."""
    from cp_pfdr_graph_d1_tpu_torch import CPOptions, PFDROptions
    return (CPOptions(dif_tol=1e-5, it_max=10, host_small="off",
                      pfdr=PFDROptions(rho=1.5, dif_tol=1e-9, it_max=5000),
                      cut="device", **kw),
            CPOptions(dif_tol=1e-5, it_max=8, host_small="off",
                      pfdr=PFDROptions(dif_tol=1e-9, it_max=5000),
                      cut="device", **kw))


def cp_dist_device_cases(mesh):
    """The ``cut="device"`` cases of ``test_torch_cp_dist.py``: the dense
    operator through the per-iteration device loop and the chained loop
    (on the stencil of the same graph), the Gram operator, and positivity
    with the duplex cut; each with the number of device cuts it ran."""
    from cp_pfdr_graph_d1_tpu_torch import (DenseOp, GraphD1, GramOp,
                                            StencilGraphD1)
    from cp_pfdr_graph_d1_tpu_torch.parallel import cp_quadratic_d1_dist
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit_chain as chn
    from cp_pfdr_graph_d1_tpu_torch.solvers import cut_pursuit_device as cpd
    cuts = [0]

    def counting(fn):
        def wrapped(*args, **kw):
            cuts[0] += 1
            return fn(*args, **kw)
        return wrapped

    patched = [(m, name, getattr(m, name)) for m, name in
               ((cpd, "device_cut"), (cpd, "_device_cut_duplex"),
                (chn, "device_cut"))]
    for m, name, fn in patched:
        setattr(m, name, counting(fn))
    out = {}
    try:
        def run(name, op, obs, g, **kw):
            cuts[0] = 0
            res = cp_quadratic_d1_dist(op, obs, g, mesh, device="cpu", **kw)
            out[name] = dict(cv=res.cv, rx=res.rx, it=res.it, cuts=cuts[0])

        def coo(eu, ev, la):
            return GraphD1.create(eu, ev, la, dtype=torch.float64,
                                  device="cpu")

        eu, ev, la, a, y = cp_problem()
        la_l1 = np.full(a.shape[1], 0.02)
        for chain in ("off", "on"):
            opt, _ = cp_dist_device_options(chain=chain)
            g = (coo(eu, ev, la) if chain == "off" else
                 StencilGraphD1.create((8, 8), cp_stencil_weights(),
                                       dtype=torch.float64, device="cpu"))
            run(f"device_{chain}", DenseOp(torch.as_tensor(a)),
                torch.as_tensor(y), g, la_l1=la_l1, opt=opt)
        _, opt8 = cp_dist_device_options(chain="off")
        eu, ev, la, a, y = cp_problem(n=128, seed=7)
        run("device_gram", GramOp(torch.as_tensor(a.T @ a)),
            torch.as_tensor(a.T @ y), coo(eu, ev, la), la_l1=la_l1, opt=opt8)
        eu, ev, la, a, y = cp_problem(seed=5)
        run("device_duplex", DenseOp(torch.as_tensor(a)), torch.as_tensor(y),
            coo(eu, ev, la), la_l1=np.full(a.shape[1], 0.05),
            positivity=True, duplex=True, opt=opt8)
    finally:
        for m, name, fn in patched:
            setattr(m, name, fn)
    return out


# (name, components, previous PFDR iterations, one-hot cap) of the
# contraction cases: premultiplied, not premultiplied, and beyond a cap
# forced down to 32 components (segment sums)
REDUCED_CASES = (("premultiplied", 60, 60, None),
                 ("dense", 60, 1, None),
                 ("segment", 50, 1000, 32))


def cp_dist_reduced_cases(mesh):
    """The device loops' contraction (``reduce_operator`` with the
    premultiplication rule ``pre_at``) of the sharded operators against the
    same call on the whole single-device operator in this rank: per case of
    ``REDUCED_CASES`` (and the Gram operator within and beyond the cap)
    ``{"dist": (kind, mat, ry, lipsch), "single": ...}``, or the two
    errors' messages."""
    from cp_pfdr_graph_d1_tpu_torch import DenseOp, GramOp
    from cp_pfdr_graph_d1_tpu_torch.ops.reduced_setup import metric_value
    from cp_pfdr_graph_d1_tpu_torch.parallel import \
        shard_cp_quadratic_problem
    from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit import (
        pre_at, reduce_operator)
    from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit_common import (
        ONEHOT_MAX, bucket)

    def reduced(op, obs, cv, num_comp, it_prev, cap):
        try:
            r_op, mat, ry, lipsch = reduce_operator(
                op, obs, cv, num_comp, bucket(num_comp),
                pre_at=pre_at(num_comp, op.num_obs, it_prev),
                onehot_max=ONEHOT_MAX if cap is None else cap)
        except ValueError as e:
            return str(e)
        return (type(r_op).__name__, mat.numpy(), ry.numpy(),
                metric_value(lipsch).numpy())

    out = {}
    r = np.random.default_rng(13)
    _, _, _, a, y = cp_problem()
    cases = [(name, DenseOp(torch.as_tensor(a)), torch.as_tensor(y), n, it,
              cap) for name, n, it, cap in REDUCED_CASES]
    _, _, _, a, y = cp_problem(n=128, seed=7)
    g = GramOp(torch.as_tensor(a.T @ a))
    cases += [("gram", g, torch.as_tensor(a.T @ y), 40, 1000, None),
              ("gram_beyond", g, torch.as_tensor(a.T @ y), 40, 1000, 32)]
    for name, op, obs, num_comp, it_prev, cap in cases:
        cv = torch.as_tensor(np.concatenate([
            np.arange(num_comp), r.integers(0, num_comp, 64 - num_comp)]))
        dop, dobs = shard_cp_quadratic_problem(op, obs, mesh, device="cpu")
        out[name] = dict(
            dist=reduced(dop, dobs, cv, num_comp, it_prev, cap),
            single=reduced(op, obs, cv, num_comp, it_prev, cap))
    return out



CP_SHARDED_SIDE = 12
CP_SHARDED_SIMPLEX_WEIGHT = 0.2


def tv_grid_problem(side, seed=3):
    """``test_parallel.py::_tv_grid_problem``'s observation."""
    r = np.random.default_rng(seed)
    x_true = np.zeros((side, side), np.float32)
    x_true[side // 8:3 * side // 8, side // 6:side // 2] = 1.2
    x_true[5 * side // 8:7 * side // 8, side // 2:7 * side // 8] = 0.7
    return (x_true + 0.1 * r.standard_normal((side, side))
            ).astype(np.float32).ravel()


def tv_grid(side, weight=0.3, dtype=torch.float32):
    from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1
    return StencilGraphD1.create((side, side), {(0, 1): weight,
                                                (1, 0): weight},
                                 dtype=dtype, device="cpu")


def cp_sharded_options(**kw):
    from cp_pfdr_graph_d1_tpu_torch import CPOptions, PFDROptions
    pf = kw.pop("pfdr")
    return CPOptions(pfdr=PFDROptions(**pf), **kw)


# keyword arguments of the sharded cut-pursuit cases (CPOptions fields, the
# PFDR options as a dict)
CP_SHARDED_KW = dict(dif_tol=1e-4, it_max=4, cut_tol=1e-5, cut_it_max=60_000,
                     inexact="off", pfdr=dict(rho=1.8, dif_tol=1e-6,
                                              it_max=1500))


def cp_dense_problem(side=CP_SHARDED_SIDE, n_obs=32):
    """``test_cp_sharded_dense_matches_single_device``'s, at ``side``."""
    v = side * side
    r = np.random.default_rng(9)
    a = (r.standard_normal((n_obs, v)) / np.sqrt(n_obs)).astype(np.float32)
    x_true = np.zeros((side, side), np.float32)
    x_true[2:7, 3:9] = 1.5
    y = (a @ x_true.ravel()
         + 0.02 * r.standard_normal(n_obs)).astype(np.float32)
    return a, y, np.full(v, 0.01, np.float32)


def cp_sharded_simplex_problem(side=CP_SHARDED_SIDE, k=3):
    """``test_cp_sharded_simplex_matches_single_device``'s, at ``side``."""
    v = side * side
    r = np.random.default_rng(11)
    labf = np.zeros((side, side), np.int64)
    labf[1:5, 2:8] = 1
    labf[7:11, 6:11] = 2
    q = np.full((v, k), 0.1 / (k - 1), np.float32)
    q[np.arange(v), labf.ravel()] = 0.9
    q += 0.08 * r.random((v, k)).astype(np.float32)
    return q / q.sum(axis=1, keepdims=True)


def cp_sharded_cases(mesh):
    """Every case of ``test_torch_cp_sharded.py`` in this rank."""
    from cp_pfdr_graph_d1_tpu_torch.parallel import (
        cp_loss_d1_simplex_sharded, cp_quadratic_d1_sharded)
    torch.set_num_threads(1)
    side = CP_SHARDED_SIDE
    out = {}

    def cp(res):
        return dict(cv=res.cv, rx=res.rx, it=res.it)

    opt = cp_sharded_options(**CP_SHARDED_KW)
    g = tv_grid(side)
    y = tv_grid_problem(side)
    out["identity"] = cp(cp_quadratic_d1_sharded(y, g, mesh, opt=opt,
                                                 device="cpu"))
    res = cp_quadratic_d1_sharded(y, g, mesh, bounds=(0.0, 0.9), opt=opt,
                                  device="cpu")
    out["bounds"] = cp(res)
    out["bounds_restart"] = cp(cp_quadratic_d1_sharded(
        y, g, mesh, bounds=(0.0, 0.9), opt=opt, state=res.state,
        device="cpu"))
    a, y, la_l1 = cp_dense_problem()
    dopt = cp_sharded_options(**dict(CP_SHARDED_KW, it_max=5,
                                     pfdr=dict(rho=1.5, dif_tol=1e-6,
                                               it_max=3000)))
    out["dense"] = cp(cp_quadratic_d1_sharded(
        y, tv_grid(side, 0.05), mesh, a=a, la_l1=la_l1, positivity=True,
        opt=dopt, device="cpu"))
    q = cp_sharded_simplex_problem()
    sopt = cp_sharded_options(**dict(CP_SHARDED_KW, dif_tol=1.0, it_max=6,
                                     pfdr=dict(rho=1.5, dif_tol=1e-6,
                                               it_max=2000)))
    g = tv_grid(side, CP_SHARDED_SIMPLEX_WEIGHT)
    res = cp_loss_d1_simplex_sharded(q, g, mesh, al=0.5, opt=sopt,
                                     device="cpu")
    out["simplex"] = dict(cv=res.cv, rp=res.rp, it=res.it)
    res = cp_loss_d1_simplex_sharded(q, g, mesh, al=0.5, opt=sopt,
                                     state=res.state, device="cpu")
    out["simplex_restart"] = dict(cv=res.cv, rp=res.rp, it=res.it)
    # the reduced solves without the native C++ (the staged loops)
    from cp_pfdr_graph_d1_tpu_torch import native
    available = native.available
    native.available = lambda: False
    try:
        out["identity_staged"] = cp(cp_quadratic_d1_sharded(
            tv_grid_problem(side), tv_grid(side), mesh, opt=opt,
            device="cpu"))
        res = cp_loss_d1_simplex_sharded(q, g, mesh, al=0.5, opt=sopt,
                                         device="cpu")
        out["simplex_staged"] = dict(cv=res.cv, rp=res.rp, it=res.it)
    finally:
        native.available = available
    return out
