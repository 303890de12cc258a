"""EEG brain-source identification with cut-pursuit (fused LASSO), on the
PyTorch port.

The port's counterpart of ``examples/example_EEG_CP.py``: the same
synthesized problem (a dense leadfield ``Phi`` with N = 91 electrodes <<
V = 19,800 sources on a triangulated sphere, three compact constant
sources, SURE-like penalization magnitudes), the same three-family stencil
over the 110 x 180 theta-phi grid with the azimuthal axis wrapped, and the
reference example's options (``example_EEG_CP.m:20-27``), solved by
``cp_pfdr_graph_d1_tpu_torch.api.cp_quadratic_d1_l1``.  Reports the Dice
score of the recovered source support, raw and after discarding
non-significant values with 2-means clustering (``example_EEG_CP.m:77-96``).

Run on the GPU (the default) or the CPU:

    PYTHONPATH=. python examples/torch_example_EEG_CP.py
    PYTHONPATH=. python examples/torch_example_EEG_CP.py --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def make_sphere_mesh(n_theta=110, n_phi=180):
    """Triangulated sphere (cortex stand-in): returns vertices [V, 3] and
    undirected edge list."""
    thetas = np.linspace(0.08, np.pi - 0.08, n_theta)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(thetas, phis, indexing="ij")
    xyz = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                    np.cos(tt)], axis=-1)
    idx = np.arange(n_theta * n_phi).reshape(n_theta, n_phi)
    eu = [idx[:, :-1].ravel(), idx[:-1, :].ravel(), idx[:-1, :-1].ravel()]
    ev = [idx[:, 1:].ravel(), idx[1:, :].ravel(), idx[1:, 1:].ravel()]
    # wrap the azimuthal seam (right and down-right families)
    eu.append(idx[:, -1])
    ev.append(idx[:, 0])
    eu.append(idx[:-1, -1])
    ev.append(idx[1:, 0])
    eu = np.concatenate(eu).astype(np.int32)
    ev = np.concatenate(ev).astype(np.int32)
    return xyz.reshape(-1, 3), eu, ev


def make_problem(seed=0, n_electrodes=91, n_sources=3):
    """``(phi [N, V], y [N], eu, ev, la_d1 [E], la_l1 [V], x0 [V])``,
    float64."""
    rng = np.random.default_rng(seed)
    verts, eu, ev = make_sphere_mesh()
    num_v = len(verts)
    # electrodes on an outer sphere; leadfield ~ 1/r^4 falloff
    elec = verts[rng.choice(num_v, n_electrodes, replace=False)] * 1.15
    d = np.linalg.norm(elec[:, None, :] - verts[None, :, :], axis=-1)
    phi = (1.0 / d ** 4).astype(np.float64)
    phi /= np.linalg.norm(phi, axis=1, keepdims=True)
    # ground truth: compact constant patches of activity
    x0 = np.zeros(num_v)
    for _ in range(n_sources):
        center = rng.integers(0, num_v)
        dist = np.linalg.norm(verts - verts[center], axis=1)
        x0[dist < 0.12] = rng.uniform(1.0, 3.0)
    y = phi @ x0
    y += 0.01 * np.linalg.norm(y) / np.sqrt(len(y)) * \
        rng.standard_normal(len(y))
    # SURE-heuristic-like penalization magnitudes
    scale = float(np.abs(phi.T @ y).mean())
    la_d1 = np.full(eu.shape, 0.15 * scale)
    la_l1 = 0.15 * scale * np.ones(num_v)
    return phi, y, eu, ev, la_d1, la_l1, x0


def dice_scores(x, x0):
    """Raw and 2-means-cleaned Dice scores
    (``example_EEG_CP.m:77-96``)."""
    supp0 = x0 != 0
    supp = x != 0
    ds = 2 * np.sum(supp0 & supp) / max(1, supp0.sum() + supp.sum())
    # 2-means on |x|: walk the sorted values until the cluster threshold
    sabs = np.sort(np.abs(x))
    n0, n1 = 0, len(x)
    s0, s1 = 0.0, float(sabs.sum())
    m = s1 / n1
    while n0 + 1 < len(x) and 2 * sabs[n0] < m:
        s0 += sabs[n0]
        s1 -= sabs[n0]
        n0 += 1
        n1 -= 1
        m = (s0 / n0 if n0 else 0.0) + s1 / n1
    suppa = np.abs(x) > m / 2
    dsa = 2 * np.sum(supp0 & suppa) / max(1, supp0.sum() + suppa.sum())
    return ds, dsa


def make_stencil_graph(la_value, device, dtype, n_theta=110, n_phi=180):
    """The sphere mesh as a stencil: three shift families over the
    theta-phi grid with the azimuthal axis wrapped (the same edges as
    :func:`make_sphere_mesh`)."""
    from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1

    return StencilGraphD1.create(
        (n_theta, n_phi),
        {(0, 1): la_value, (1, 0): la_value, (1, 1): la_value},
        wrap=(False, True), dtype=dtype, device=device)


def main(device="cuda", use_stencil=True):
    """Solves the problem on ``device`` and returns the raw and cleaned
    Dice scores ``(ds, dsa)``."""
    import torch

    from cp_pfdr_graph_d1_tpu_torch import api

    phi, y, eu, ev, la_d1, la_l1, x0 = make_problem()
    print(f"V = {phi.shape[1]}, E = {len(eu)}, N = {phi.shape[0]}, "
          f"true support = {int((x0 != 0).sum())}, device {device}")
    graph = (make_stencil_graph(float(la_d1[0]), device, torch.float64)
             if use_stencil else None)
    # reference example parameters (example_EEG_CP.m:20-27)
    t0 = time.time()
    out = api.cp_quadratic_d1_l1(
        y, phi, eu, ev, la_d1, la_l1, positivity=True,
        CP_difTol=1e-4, CP_itMax=15, PFDR_rho=1.5, PFDR_condMin=1e-3,
        PFDR_difRcd=0.0, PFDR_difTol=1e-7, PFDR_itMax=10_000, graph=graph,
        device=device)
    x = out.rX[out.Cv]
    print(f"solved in {time.time() - t0:.1f}s: {out.it} cut-pursuit "
          f"iterations, {len(out.rX)} components")
    ds, dsa = dice_scores(x, x0)
    print(f"Dice score: raw {ds:.2f}; approx (discard less significant "
          f"with 2-means) {dsa:.2f}")
    return ds, dsa


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
