"""PyTorch and CUDA port of ``cp_pfdr_graph_d1_tpu`` for NVIDIA Hopper.

Cut-pursuit outer solvers over preconditioned forward-Douglas-Rachford
inner solvers for graph total-variation regularized problems, with the JAX
package's module layout.  Plain tensor code is PyTorch; the TPU kernels of
the JAX package are hand-written CUDA kernels (``csrc/``), built with
``nvcc`` for ``sm_90a`` at first use into ``build/``.  This package never
imports ``jax``; the JAX package stays beside it as the reference.

Importing the package turns TF32 off for matrix products and cuDNN: the
solvers need IEEE float32 products (the cut-pursuit merge and cut decisions
feed on ~1e-4-relative differences, which TF32's 10-bit mantissa would
blur).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import CPOptions, Lipsch, PFDROptions  # noqa: E402
from .graph import GraphD1  # noqa: E402
from .operators import (DenseOp, DiagOp, GramOp, IdentityOp,  # noqa: E402
                        QuadOp, make_operator)
from .solvers import (PFDRResult, VertexProx,  # noqa: E402
                      pfdr_quadratic_d1)
from .solvers.cut_pursuit_simplex import (CPSimplexResult,  # noqa: E402
                                          CPSimplexState, cp_loss_d1_simplex)
from .solvers.pfdr_simplex import (SimplexResult,  # noqa: E402
                                   SimplexSolveState, pfdr_loss_d1_simplex)
from .stencil import StencilGraphD1  # noqa: E402

__all__ = [
    "CPOptions", "Lipsch", "PFDROptions", "GraphD1", "StencilGraphD1",
    "DenseOp", "DiagOp", "GramOp", "IdentityOp", "QuadOp", "make_operator",
    "PFDRResult", "VertexProx", "pfdr_quadratic_d1",
    "CPSimplexResult", "CPSimplexState", "cp_loss_d1_simplex",
    "SimplexResult", "SimplexSolveState", "pfdr_loss_d1_simplex",
]

__version__ = "0.1.0"
