"""Multi-label image segmentation with cut-pursuit (loss + d1 + simplex), on
the PyTorch port.

The port's counterpart of ``examples/example_labeling_CP.py``: noisy
per-pixel label likelihoods ``Q`` (K = 4, noise 0.9, seed 0) on a
120 x 120 4-neighborhood grid, and a piecewise-constant labeling recovered
by minimizing the smoothed-KL loss plus the graph total variation over the
probability simplex through ``cp_pfdr_graph_d1_tpu_torch.api
.cp_loss_d1_simplex``, with the JAX example's options.

Run on the GPU (the default) or the CPU:

    PYTHONPATH=. python examples/torch_example_labeling_CP.py
    PYTHONPATH=. python examples/torch_example_labeling_CP.py --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def make_problem(h=120, w=120, k=4, noise=0.9, seed=0):
    """``(q [V, K], eu, ev, labels [V])``."""
    rng = np.random.default_rng(seed)
    # ground truth: voronoi cells of k random centers (piecewise constant)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    centers = rng.uniform(0, [h, w], (2 * k, 2))
    d = ((yy[..., None] - centers[:, 0]) ** 2
         + (xx[..., None] - centers[:, 1]) ** 2)
    labels = (np.argmin(d, axis=-1) % k).ravel()
    v = h * w
    q = np.full((v, k), noise / k)
    q[np.arange(v), labels] += 1.0 - noise
    q *= rng.uniform(0.2, 1.8, (v, k))  # observation noise
    q /= q.sum(axis=1, keepdims=True)
    idx = np.arange(v).reshape(h, w)
    eu = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    ev = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return q, eu.astype(np.int32), ev.astype(np.int32), labels


def main(device="cuda"):
    """Solves the problem on ``device`` and returns the label accuracy of
    the observations and of the regularized labeling ``(acc_in,
    acc_out)``."""
    from cp_pfdr_graph_d1_tpu_torch import api

    q, eu, ev, labels = make_problem()
    la_d1 = np.full(eu.shape, 0.5)
    print(f"V = {q.shape[0]}, E = {len(eu)}, K = {q.shape[1]}, "
          f"device {device}")
    t0 = time.time()
    out = api.cp_loss_d1_simplex(
        q, 0.5, eu, ev, la_d1, CP_difTol=1e-3, CP_itMax=10,
        PFDR_rho=1.5, PFDR_difTol=1e-6, PFDR_itMax=10_000, device=device)
    p = out.rX[out.Cv]
    acc_in = (np.argmax(q, axis=1) == labels).mean()
    acc_out = (np.argmax(p, axis=1) == labels).mean()
    print(f"solved in {time.time() - t0:.1f}s: {out.it} cut-pursuit "
          f"iterations, {out.rX.shape[0]} components")
    print(f"label accuracy: observations {acc_in:.3f} -> "
          f"regularized {acc_out:.3f}")
    return acc_in, acc_out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
