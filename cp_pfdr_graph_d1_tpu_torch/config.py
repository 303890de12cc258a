"""Typed solver configuration (counterpart of ``cp_pfdr_graph_d1_tpu.config``).

Same knobs and defaults as the JAX package, so that options convert field
by field (:mod:`.convert`).  Two meanings differ in the port:

* ``PFDROptions.fused="auto"`` runs the hand-written CUDA iteration kernel
  when the tensors lie on a CUDA device, and the staged PyTorch loop
  otherwise; ``"on"`` goes through the kernel's wrapper on any device (on
  the CPU the wrapper runs the kernel's plain PyTorch version).
* ``CPOptions.chain="auto"`` takes the chained loop for float32 tensors on
  a CUDA device with a stencil graph (the JAX package: float32 on a TPU
  with a stencil its fused kernels admit).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (host copies keep the solve's)."""
    return torch.empty(0, dtype=dtype).numpy().dtype


class Lipsch(enum.Enum):
    """How the Lipschitz information ``L`` is interpreted: ``SCAL`` a scalar
    bound on the Hessian's norm, ``DIAG`` a per-vertex diagonal metric."""

    SCAL = 0
    DIAG = 1


@dataclasses.dataclass(frozen=True)
class PFDROptions:
    """Options of the inner preconditioned forward-Douglas-Rachford solver.

    Attributes:
      rho: relaxation parameter, in ]0, 2[.
      cond_min: positive floor of the preconditioning.
      dif_rcd: reconditioning threshold on the relative evolution (0 off).
      dif_tol: stopping threshold on the relative iterate evolution.
      it_max: maximum number of iterations.
      fused: "auto" | "on" | "off" — see the module docstring.
      verbose: print a progress line every ``verbose`` iterations (0 off).
    """

    rho: float = 1.0
    cond_min: float = 1e-3
    dif_rcd: float = 0.0
    dif_tol: float = 1e-4
    it_max: int = 10_000
    fused: str = "auto"
    verbose: int = 0

    def __post_init__(self):
        if self.fused not in ("auto", "on", "off"):
            raise ValueError(f"unknown fused mode {self.fused!r}")


@dataclasses.dataclass(frozen=True)
class CPOptions:
    """Options of the outer cut-pursuit loop.

    Attributes:
      dif_tol: stopping threshold on the relative evolution between two
        cut-pursuit iterations.
      it_max: maximum number of cut-pursuit iterations.
      pfdr: options of the inner PFDR solves of the reduced problems.
      verbose: 0 silences the solver, a positive value prints progress.
      host_small: "on" sends reduced problems of at most
        ``host_small_max`` components that the ``solve_small`` kernel does
        not take to the native C++ PFDR on the host; "auto" and "off" keep
        them on the tensors' device (the JAX package's "auto" means "on"
        on an accelerator; where the crossover lies on a GPU is not
        measured yet, so the port never moves work to the host unasked).
      host_small_max: component-count crossover of the native route.
      cut: "host" (native push-relabel on the host) or "device" (certified
        PDHG min-cut, components and contraction on the tensors' device;
        the chained loop or the per-iteration device loop, see ``chain``).
      cut_tol: duality-gap certificate of a device cut, relative to the
        cut's cost scale.
      cut_it_max: PDHG step cap of a device cut.
      chain_init_pfdr: full-graph PFDR iterations of the chained loop's
        warm partition (0 starts from one component).
      inexact: "auto" caps intermediate reduced solves at ``inexact_cap``
        iterations and polishes the settled partition at full accuracy;
        "off" runs every reduced solve at full accuracy.
      inexact_cap: iteration cap of intermediate reduced solves.
      chain: "auto" | "on" | "off": how ``cut="device"`` runs its outer
        loop.  "auto" takes the chained loop
        (:mod:`.solvers.cut_pursuit_chain`) for float32 tensors on a CUDA
        device with a stencil graph, "on" on any device, "off" never (the
        per-iteration device loop, :mod:`.solvers.cut_pursuit_device`).
    """

    dif_tol: float = 1e-3
    it_max: int = 10
    pfdr: PFDROptions = dataclasses.field(default_factory=PFDROptions)
    verbose: int = 0
    host_small: str = "auto"
    host_small_max: int = 1024
    cut: str = "host"
    cut_tol: float = 1e-6
    cut_it_max: int = 200_000
    inexact: str = "auto"
    inexact_cap: int = 3000
    chain: str = "auto"
    chain_init_pfdr: int = 600

    def __post_init__(self):
        if self.cut not in ("host", "device"):
            raise ValueError(f"unknown cut backend {self.cut!r}")
        if self.chain not in ("auto", "on", "off"):
            raise ValueError(f"unknown chain mode {self.chain!r}")
        if self.host_small not in ("auto", "on", "off"):
            raise ValueError(f"unknown host_small mode {self.host_small!r}")
        if self.inexact not in ("auto", "off"):
            raise ValueError(f"unknown inexact mode {self.inexact!r}")


# Power-method parameters of the reduced operator norm, as in the reference
# cut-pursuit solvers (CP_PFDR_graph_quadratic_d1_l1.cpp:270-274).
OPERATOR_NORM_TOL = 1e-3
OPERATOR_NORM_IT_MAX = 100
OPERATOR_NORM_NB_INIT = 10
