"""Multi-rank example on the PyTorch port: a fused LASSO solved four
distributed ways.

The port's counterpart of ``examples/example_distributed.py``, on the same
EEG-shaped problem (dense A with N = 64 << V, a 32 x 32 grid, a blob of
activity; seed 0, float32).  Each path runs in every rank of a
``torch.distributed`` process group started by
``cp_pfdr_graph_d1_tpu_torch.parallel.spawn_ranks`` (gloo on the CPU and
for ranks that share a card, NCCL with one card per rank):

1. observation/edge-sharded PFDR (``parallel.pfdr_quadratic_d1_sharded``):
   replicated iterate, two sums over the ranks per iteration;
2. vertex-sharded halo-exchange PFDR on the stencil container
   (``parallel.pfdr_quadratic_d1_halo``): row blocks exchanged on a ring;
3. distributed cut-pursuit (``parallel.cp_quadratic_d1_dist``): operator
   rows sharded over the ranks, combinatorics replicated; run twice, with
   the host cut (as the JAX example) and with ``cut="device"`` on the
   same graph as a stencil (the chained loop on a GPU);
4. sharded-graph device cut-pursuit (``parallel.cp_quadratic_d1_sharded``):
   the PDHG cuts, components and contraction run with the graph split into
   vertex row blocks.

It asserts what the JAX example asserts: paths 1 and 2 within 1e-5 of the
single-device PFDR, cut-pursuit recovering the support (Dice > 0.9), path
4's partition equal to the single-device device cut-pursuit's; and every
rank holding the same partition.

Run on the GPU (the default; the ranks share one card when there is one)
or the CPU, with the number of ranks (default 2):

    PYTHONPATH=. python examples/torch_example_distributed.py
    PYTHONPATH=. python examples/torch_example_distributed.py --device cpu \\
        --ranks 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np

SIDE = 32
N_OBS = 64


def make_problem(seed=0):
    """The JAX example's arrays, float32: the operator ``a`` [N, V], ``y``,
    the grid's ``eu``/``ev``, ``la_d1``, ``la_l1``, ``x_true`` and the
    denoising image ``y_img`` of path 4 (drawn from the same generator
    after ``y``, as there)."""
    h = w = SIDE
    v = h * w
    idx = np.arange(v).reshape(h, w)
    eu = np.concatenate([idx[:, :-1].ravel(),
                         idx[:-1, :].ravel()]).astype(np.int32)
    ev = np.concatenate([idx[:, 1:].ravel(),
                         idx[1:, :].ravel()]).astype(np.int32)
    r = np.random.default_rng(seed)
    a = (r.standard_normal((N_OBS, v)) / np.sqrt(N_OBS)).astype(np.float32)
    x_true = np.zeros((h, w), np.float32)
    x_true[8:16, 8:16] = 1.5
    y = (a @ x_true.ravel() + 0.02 * r.standard_normal(N_OBS)
         ).astype(np.float32)
    y_img = (x_true + 0.1 * r.standard_normal((h, w))
             ).astype(np.float32).ravel()
    return dict(a=a, y=y, eu=eu, ev=ev,
                la_d1=np.full(eu.shape, 0.1, np.float32),
                la_l1=np.full(v, 0.05, np.float32), x_true=x_true,
                y_img=y_img)


def support_dice(rx, cv, x_true):
    """Dice score of the support ``x > max(x) / 2`` against the true
    blob."""
    x = np.asarray(rx)[np.asarray(cv)]
    sup = x > 0.5 * x.max()
    tru = x_true.ravel() > 0
    return float(2 * np.sum(sup & tru) / (sup.sum() + tru.sum()))


def paths(mesh, device="cuda"):
    """The four paths in this rank of ``mesh``, and the single-device
    solves they are held against; returns a dict of results (numbers and
    this rank's partitions)."""
    import torch

    from cp_pfdr_graph_d1_tpu_torch import (CPOptions, DenseOp, GraphD1,
                                            IdentityOp, PFDROptions,
                                            StencilGraphD1, VertexProx,
                                            pfdr_quadratic_d1)
    from cp_pfdr_graph_d1_tpu_torch.parallel import (
        cp_quadratic_d1_dist, cp_quadratic_d1_sharded,
        pfdr_quadratic_d1_halo, pfdr_quadratic_d1_sharded,
        shard_quadratic_problem, shard_stencil_problem)
    from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit import \
        cp_quadratic_d1

    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    pb = make_problem()
    a, y, eu, ev = pb["a"], pb["y"], pb["eu"], pb["ev"]
    la_d1, la_l1 = pb["la_d1"], pb["la_l1"]
    n_dev = mesh.size
    f32 = torch.float32
    lip = float(np.linalg.svd(a, compute_uv=False)[0] ** 2)
    vprox = VertexProx(kind="l1", positivity=True)
    opt = PFDROptions(rho=1.5, dif_tol=1e-6, it_max=3000)
    out = dict(ranks=n_dev, backend=mesh.backend, seconds={})
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        if device != "cpu":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out["seconds"][name] = t - t0
        t0 = t

    def graph():
        return GraphD1.create(eu, ev, la_d1, dtype=f32, device=device)

    def stencil(weight):
        return StencilGraphD1.create((SIDE, SIDE), {(0, 1): weight,
                                                    (1, 0): weight},
                                     dtype=f32, device=device)

    # single-device reference solve
    base = pfdr_quadratic_d1(
        DenseOp(torch.as_tensor(a, device=device)),
        torch.as_tensor(y, device=device), graph(),
        la_l1=torch.as_tensor(la_l1, device=device), vprox=vprox,
        lipsch=lip, opt=opt)
    x_base = base.x.cpu().numpy()
    lap("single-device PFDR")

    # 1. observation/edge-sharded PFDR
    prob = shard_quadratic_problem(a, y, eu, ev, la_d1, n_dev)
    res1 = pfdr_quadratic_d1_sharded(prob, mesh, la_l1=la_l1, vprox=vprox,
                                     lipsch=lip, opt=opt, device=device)
    out["it1"] = res1.it
    out["err1"] = float(np.max(np.abs(res1.x.cpu().numpy() - x_base)))
    lap("1")

    # 2. vertex-sharded halo-exchange PFDR (stencil container)
    hprob = shard_stencil_problem(a, y, stencil(0.1), n_dev)
    res2 = pfdr_quadratic_d1_halo(hprob, mesh, la_l1=la_l1, vprox=vprox,
                                  lipsch=lip, opt=opt, device=device)
    out["it2"] = res2.it
    out["err2"] = float(np.max(np.abs(res2.x.cpu().numpy() - x_base)))
    lap("2")

    # 3. distributed cut-pursuit (operator rows sharded), host cut and
    # device cut (the same graph as a stencil)
    copt = CPOptions(dif_tol=1e-5, it_max=10,
                     pfdr=PFDROptions(rho=1.5, dif_tol=1e-8, it_max=5000))
    for cut, g in (("host", graph()), ("device", stencil(0.1))):
        res3 = cp_quadratic_d1_dist(
            DenseOp(torch.as_tensor(a)), torch.as_tensor(y), g, mesh,
            la_l1=la_l1, positivity=True,
            opt=CPOptions(**{**copt.__dict__, "cut": cut}), device=device)
        out[f"cp_{cut}"] = dict(it=res3.it, cv=res3.cv, rx=res3.rx,
                                dice=support_dice(res3.rx, res3.cv,
                                                  pb["x_true"]))
        lap(f"3 {cut}")

    # 4. sharded-graph device cut-pursuit (identity-operator TV denoising:
    # the whole-graph combinatorics run sharded, not just the operator)
    kw = dict(dif_tol=1e-4, it_max=4,
              pfdr=PFDROptions(rho=1.8, dif_tol=1e-6, it_max=1500),
              cut_tol=1e-6, cut_it_max=60_000, inexact="off")
    res4 = cp_quadratic_d1_sharded(pb["y_img"], stencil(0.3), mesh,
                                   opt=CPOptions(**kw), device=device)
    lap("4")
    ref4 = cp_quadratic_d1(IdentityOp(),
                           torch.as_tensor(pb["y_img"], device=device),
                           stencil(0.3), opt=CPOptions(**kw, cut="device"))
    lap("single-device CP")
    out["cp_sharded"] = dict(it=res4.it, cv=res4.cv, rx=res4.rx,
                             cv_match=bool(np.array_equal(res4.cv, ref4.cv)))
    return out


def report(outs):
    """Prints the four paths of the ranks' results ``outs`` (rank order) and
    asserts the JAX example's bars and that every rank holds the same
    partitions."""
    r0 = outs[0]
    print(f"{r0['ranks']} ranks, {r0['backend']}; seconds in rank 0: "
          + ", ".join(f"{k} {v:.2f}" for k, v in r0["seconds"].items()))
    print(f"1. edge/observation-sharded PFDR: it={r0['it1']} "
          f"max|dx|={r0['err1']:.2e}")
    print(f"2. vertex-sharded halo PFDR:      it={r0['it2']} "
          f"max|dx|={r0['err2']:.2e}")
    for cut in ("host", "device"):
        c = r0[f"cp_{cut}"]
        print(f"3. distributed cut-pursuit, cut='{cut}': it={c['it']} "
              f"components={len(c['rx'])} support-Dice={c['dice']:.3f}")
    c = r0["cp_sharded"]
    print(f"4. sharded-graph device CP:       it={c['it']} "
          f"components={len(c['rx'])} cv==single-device: {c['cv_match']}")
    for o in outs[1:]:
        for key in ("cp_host", "cp_device", "cp_sharded"):
            assert np.array_equal(o[key]["cv"], r0[key]["cv"]), \
                f"{key}: the ranks' partitions differ"
            assert np.array_equal(o[key]["rx"], r0[key]["rx"]), \
                f"{key}: the ranks' values differ"
    assert r0["err1"] < 1e-5 and r0["err2"] < 1e-5, \
        f"sharded PFDR off the single-device solve: {r0['err1']}, " \
        f"{r0['err2']}"
    assert r0["cp_host"]["dice"] > 0.9 and r0["cp_device"]["dice"] > 0.9, \
        "distributed cut-pursuit missed the support"
    assert c["cv_match"], "sharded-graph CP partition differs from one device"
    print("all distributed paths agree with the single-device solve")


def main(ranks=2, device="cuda"):
    """Runs the four paths in ``ranks`` spawned ranks on ``device``, checks
    them (:func:`report`) and returns rank 0's results."""
    from cp_pfdr_graph_d1_tpu_torch.parallel import spawn_ranks
    outs = spawn_ranks(paths, ranks, device, device=device)
    report(outs)
    return outs[0]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args()
    main(args.ranks, args.device)
