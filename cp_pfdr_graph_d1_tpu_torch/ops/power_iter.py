"""Squared operator norm by batched power iteration (counterpart of
``cp_pfdr_graph_d1_tpu.ops.power_iter``).

All restarts run as the columns of one matrix, so every iteration is one
matrix product.  The restarts start from the same numbers as the JAX
package's ``jax.random.uniform(PRNGKey(0), ...)``: :func:`threefry_uniform`
reproduces that counter-based generator (Threefry-2x32, 20 rounds, JAX's
partitionable counter layout) in numpy, so both packages estimate the same
norm for the same matrix, on any device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import (OPERATOR_NORM_IT_MAX, OPERATOR_NORM_NB_INIT,
                      OPERATOR_NORM_TOL, numpy_dtype)

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, c0, c1):
    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    ks = (np.uint32(k0), np.uint32(k1),
          np.uint32(k0 ^ k1 ^ 0x1BD11BDA))
    x0 = c0 + ks[0]
    x1 = c1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def threefry_uniform(shape, dtype, minval=-1.0, maxval=1.0, key=(0, 0)):
    """numpy array equal to ``jax.random.uniform(key, shape, dtype, minval,
    maxval)`` for a raw Threefry key ``(k0, k1)`` (``PRNGKey(0)`` is
    ``(0, 0)``), float32 or float64."""
    dt = np.dtype(dtype)
    n = int(np.prod(shape))
    i = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        b1, b2 = _threefry2x32(key[0], key[1],
                               (i >> np.uint64(32)).astype(np.uint32),
                               (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    if dt == np.float64:
        bits = (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
        bits = (bits >> np.uint64(12)) | np.array(1.0).view(np.uint64)
        f = bits.view(np.float64) - 1.0
    elif dt == np.float32:
        bits = ((b1 ^ b2) >> np.uint32(9)) | np.array(
            1.0, np.float32).view(np.uint32)
        f = bits.view(np.float32) - np.float32(1.0)
    else:
        raise TypeError(f"threefry_uniform supports float32/64, not {dt}")
    lo, hi = dt.type(minval), dt.type(maxval)
    return np.maximum(lo, f * (hi - lo) + lo).reshape(shape)


def operator_norm(gram_apply, dim: int, dtype=torch.float32, device="cuda",
                  *, tol: float = OPERATOR_NORM_TOL,
                  it_max: int = OPERATOR_NORM_IT_MAX,
                  nb_init: int = OPERATOR_NORM_NB_INIT):
    """``||A||^2`` (largest eigenvalue of ``A^t A``) as a 0-d tensor.

    Args:
      gram_apply: callable mapping [dim, B] -> [dim, B], applying ``A^t A``.
      dim: dimension of the domain of ``A^t A``.
      tol: per-restart relative convergence tolerance
        (``operator_norm_matrix.cpp:200``).
    """
    x = torch.as_tensor(threefry_uniform((dim, nb_init), numpy_dtype(dtype)),
                        device=device)

    def norm(z):
        return torch.sqrt((z * z).sum(dim=0))

    # one warm-up application, as in the reference (:192-194)
    b = norm(x)
    x = gram_apply(x / b)
    b = norm(x)
    for _ in range(it_max):
        safe_b = torch.where(b > 0, b, torch.ones_like(b))
        x = gram_apply(x / safe_b)
        a = norm(x)
        done = bool(torch.all((a - b) < tol * safe_b))
        b = torch.where(b > 0, a, torch.zeros_like(a))
        if done:
            break
    return b.max()


class MatApply:
    """Symmetric-matrix application for :func:`operator_norm`."""

    def __init__(self, m):
        self.m = m

    def __call__(self, x):
        return self.m @ x


class GramApply:
    """``A^t A`` application for :func:`operator_norm`."""

    def __init__(self, a):
        self.a = a

    def __call__(self, x):
        return self.a.T @ (self.a @ x)


def presymmetrize_wins(m: int, n: int,
                       it_max: int = OPERATOR_NORM_IT_MAX) -> bool:
    """The reference's pre-symmetrization cost rule
    (``operator_norm_matrix.cpp:116``): True when precomputing the smaller
    Gram matrix beats applying ``A`` twice per iteration."""
    p = min(m, n)
    return 2 * m * n * it_max > m * n * p + p * p * it_max


def dense_operator_norm(a, *, tol: float = OPERATOR_NORM_TOL,
                        it_max: int = OPERATOR_NORM_IT_MAX,
                        nb_init: int = OPERATOR_NORM_NB_INIT):
    """``||A||^2`` for a dense [M, N] matrix, through the smaller Gram
    matrix whenever :func:`presymmetrize_wins` says so."""
    m, n = a.shape
    kw = dict(tol=tol, it_max=it_max, nb_init=nb_init)
    if presymmetrize_wins(m, n, it_max):
        gram = a @ a.T if m <= n else a.T @ a
        return operator_norm(MatApply(gram), min(m, n), a.dtype, a.device,
                             **kw)
    return operator_norm(GramApply(a), n, a.dtype, a.device, **kw)
