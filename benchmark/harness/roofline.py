"""The card's peaks and the work of each kernel a roofline share reads,
frozen here so that no change to the program can move them.

Peaks: NVIDIA's H100 SXM data sheet at its 700 W limit: 3.35 TB/s of HBM,
67 TFLOP/s in float32 outside the tensor cores.  A share is the least time
the card could take for a launch's work (the larger of its bytes over the
memory rate and its operations over the float32 rate) over the time the
launch took.  Bytes count each input read once and each output written
once; operations count what the launch's inputs and the steps or
iterations it ran need.  The arithmetic is the one the port's own table of
kernels used (``chip_smoke.py``: ``bound``, ``reduced_solve_work`` and the
``mincut_fused`` entry of its ``work`` table): 51.9 us for a 250-step cut
at 724 x 724, 7.74 us for 300 iterations of a dense reduced solve of
``rv_cap`` 4096, 8192 edges and 91 rows.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# the certificate of a PDHG cut: every `CHECK_EVERY` steps, 15 coarea levels
CUT_CHECK_EVERY = 250
CUT_THRESHOLDS = 15


def bound_s(nbytes: float, flops: float):
    """``(seconds, "bytes" | "operations")``: the least time for the work
    and which of the two peaks sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mincut_work(v: int, f: int, steps: int, itemsize: int = 4):
    """Bytes and operations of one ``mincut_fused`` launch on a field of
    ``v`` cells and ``f`` shift families that ran ``steps`` PDHG steps:
    the weights, costs, step sizes and warm starts read once and the
    iterate and duals written once; 10 operations per edge and 6 per cell
    a step; per certificate, the 15 levels over the cells and edges plus
    the cut's value."""
    nbytes = itemsize * (4 * v + 4 * f * v)
    checks = steps // CUT_CHECK_EVERY
    flops = (steps * (10 * f * v + 6 * v)
             + checks * (CUT_THRESHOLDS * (2 * v + 3 * f * v)
                         + 4 * f * v + 3 * v))
    return nbytes, flops


def solve_small_work(op_kind: str, rv_cap: int, ne: int, n_rows: int,
                     iters: int, itemsize: int = 4):
    """Bytes and operations of one whole reduced PFDR solve of ``iters``
    iterations on ``rv_cap`` vertices and ``ne`` edges: per iteration the
    operator's gradient (dense ``A`` [n_rows, rv_cap]: two products, 4
    n_rows rv_cap; Gram [rv_cap, rv_cap]: one, 2 rv_cap^2; diagonal: one
    product a vertex), about 24 operations an edge (pair prox, relaxation,
    weighting, incidence sum) and 10 a vertex (forward step, prox,
    evolution); the operator, five vertex rows, seven edge rows and the
    integer endpoints read once, the vertex row and edge pairs written
    once."""
    if op_kind == "dense":
        op_vals, grad = n_rows * rv_cap, 4 * n_rows * rv_cap
    elif op_kind == "gram":
        op_vals, grad = rv_cap * rv_cap, 2 * rv_cap * rv_cap
    else:
        op_vals, grad = rv_cap, rv_cap
    nbytes = (itemsize * (op_vals + 4 * rv_cap + 7 * ne + rv_cap + 2 * ne)
              + 4 * (2 * ne + rv_cap + 1 + 2 * ne))
    flops = iters * (grad + 24 * ne + 10 * rv_cap)
    return nbytes, flops
