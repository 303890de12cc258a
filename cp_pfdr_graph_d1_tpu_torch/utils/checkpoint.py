"""Checkpoint and resume of solver state (counterpart of
``cp_pfdr_graph_d1_tpu.utils.checkpoint``).

Solver states are NamedTuples of arrays that round-trip through ``.npz``
files, in the JAX package's format letter for letter: one array per field
under its name, the fields of a nested preconditioner under ``pre.<field>``,
and the state's kind under ``__kind__``.  So a file either package writes
loads into the other.

* :class:`~..solvers.cut_pursuit.CPState` /
  :class:`~..solvers.cut_pursuit_simplex.CPSimplexState`: outer-loop state
  (active-edge flags, component labels, component values), host arrays;
  resumes a cut-pursuit solve through the solvers' ``state=``.
* :class:`~..solvers.pfdr_quadratic.PFDRSolveState` /
  :class:`~..solvers.pfdr_simplex.SimplexSolveState`: the whole
  loop-carried inner-solver state, tensors on the device
  :func:`load_state` names; from ``return_state=True``, resumed through
  ``state0=`` on the same container, operator, options and dtype, it
  reproduces the uninterrupted trajectory.  Its edge arrays follow the
  container's edge order, which is the JAX container's for every container
  of the port (a stencil's family-major ``F H W`` order included), so no
  mapping is needed.
"""
from __future__ import annotations

import numpy as np
import torch


def _kinds():
    """``({kind: state class}, {inner state class: preconditioner
    class})``, imported here: the solvers import this package's
    :mod:`.monitor`."""
    from ..solvers.cut_pursuit import CPState
    from ..solvers.cut_pursuit_simplex import CPSimplexState
    from ..solvers.pfdr_quadratic import PFDRSolveState, Precond
    from ..solvers.pfdr_simplex import SimplexPrecond, SimplexSolveState
    return ({"quadratic": CPState, "simplex": CPSimplexState,
             "pfdr": PFDRSolveState, "pfdr_simplex": SimplexSolveState},
            {PFDRSolveState: Precond, SimplexSolveState: SimplexPrecond})


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(state, prefix=""):
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if hasattr(v, "_fields"):  # nested NamedTuple (the preconditioner)
            out.update(_flatten(v, prefix=f"{prefix}{f}."))
        else:
            out[prefix + f] = _host(v)
    return out


def save_state(path, state) -> None:
    """Persists a solver state NamedTuple to ``path`` (.npz)."""
    for kind, cls in _kinds()[0].items():
        if isinstance(state, cls):
            break
    else:
        raise TypeError(f"unsupported state type {type(state)!r}")
    np.savez(path, __kind__=kind, **_flatten(state))


def load_state(path, device="cuda"):
    """Loads a solver state saved with :func:`save_state` (by either
    package).  Inner-solver states come back as tensors on ``device`` (the
    iteration count as an int); cut-pursuit states as host arrays, as the
    solvers return them."""
    kinds, preconds = _kinds()
    with np.load(path) as data:
        kind = str(data["__kind__"])
        cls = kinds.get(kind)
        if cls is None:
            raise ValueError(f"unknown state kind {kind!r}")
        if cls not in preconds:
            return cls(**{f: data[f] for f in cls._fields})

        def tensor(a):
            return torch.as_tensor(np.array(a), device=device)

        pre_cls = preconds[cls]
        pre = pre_cls(**{f: tensor(data[f"pre.{f}"])
                         for f in pre_cls._fields})
        rest = {f: tensor(data[f]) for f in cls._fields
                if f not in ("pre", "it")}
        return cls(pre=pre, it=int(data["it"]), **rest)
