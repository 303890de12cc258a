"""Plain reference of the EEG fused LASSO for the port's device route: the
judge of :mod:`fused_lasso` (``benchmark/reference/fused_lasso.py``), with
the reference's own solves in a lower precision as the control
(``control_answers``, ``"reference:<dtype>"`` in the configuration).

The program's TF32 path, the control of the host-cut configuration, hardly
moves this route's answers: the chained loop never forms the reduced Gram
matrix, so TF32 rounds only the one-hot column sums of ``Phi``, and the
float32 reduced solves (``solve_small``) do the rest.  The reference's
preconditioned PDHG computed in the lower precision stands in its place.

Plain NumPy, SciPy and PyTorch; it imports nothing of the port.
"""
from __future__ import annotations

import numpy as np

from harness.spec import load_module

_base = load_module("reference", "fused_lasso")
judge = _base.judge


def control_answers(config: dict, handed: list, device, dtype) -> list:
    """The control: the reference's preconditioned PDHG, for the
    configuration's ``reference_iters`` iterations, computed in ``dtype``;
    its iterates as the answers."""
    m = config["mesh"]
    phi = np.asarray(handed[0]["phi"], np.float64)
    lam = _base.penalty(config, handed[0]["phi"], handed[0]["y0"])
    eu, ev = _base.sphere_edges(int(m["n_theta"]), int(m["n_phi"]))
    ys = np.stack([np.asarray(h["y"], np.float64) for h in handed])
    x = _base.pdhg(phi, ys, eu, ev, lam,
                   int(config["check"]["reference_iters"]), device,
                   dtype=dtype)
    return list(x)
