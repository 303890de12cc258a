"""Linear operators of the quadratic data term ``1/2 ||y - A x||^2``
(counterpart of ``cp_pfdr_graph_d1_tpu.operators``).

``obs`` keeps the reference's mode-dependent meaning: the raw ``y`` for
:class:`DenseOp`, the premultiplied ``A^t y`` for the Gram, diagonal and
identity modes.  Products run in IEEE float32 or float64: the package turns
TF32 off (see ``__init__``), because the cut-pursuit merge and cut
decisions feed on ~1e-4-relative value differences.
"""
from __future__ import annotations

import torch


class QuadOp:
    """Interface of the quadratic-term operator."""

    #: True when gradients are computed through the N-dim residual.
    uses_residual: bool = False

    def gram_apply(self, x):
        """``(A^t A) x``."""
        raise NotImplementedError

    def gram_diag(self, num_vertices: int, dtype, device):
        """``diag(A^t A)`` as a [V] vector."""
        raise NotImplementedError

    def grad(self, x, obs):
        """Gradient ``A^t(A x) - A^t y`` of the quadratic term."""
        raise NotImplementedError

    def quad_obj(self, x, obs):
        """``1/2 ||y - A x||^2``, up to the constant ``1/2||y||^2`` for the
        premultiplied modes."""
        raise NotImplementedError

    def ones_image(self, num_vertices: int, obs):
        """``(<A 1, y>, ||A 1||^2)`` for the all-ones direction (cut-pursuit
        scalar initialization)."""
        raise NotImplementedError


class DenseOp(QuadOp):
    """Dense N-by-V design matrix (reference ``N > 0`` mode)."""

    uses_residual = True

    def __init__(self, a):
        self.a = a  # [N, V]

    def apply(self, x):
        return self.a @ x

    def apply_t(self, r):
        return self.a.T @ r

    def residual(self, x, obs):
        return obs - self.a @ x

    def gram_apply(self, x):
        return self.a.T @ (self.a @ x)

    def gram_diag(self, num_vertices, dtype, device):
        return (self.a * self.a).sum(dim=0).to(dtype)

    def grad(self, x, obs):
        return -self.apply_t(self.residual(x, obs))

    def quad_obj(self, x, obs):
        r = self.residual(x, obs)
        return 0.5 * torch.dot(r, r)

    def ones_image(self, num_vertices, obs):
        a1 = self.a.sum(dim=1)
        return torch.dot(a1, obs), torch.dot(a1, a1)


class GramOp(QuadOp):
    """Premultiplied V-by-V Gram matrix ``A^t A`` (reference ``N < 0``)."""

    def __init__(self, gram):
        self.gram = gram  # [V, V]

    def gram_apply(self, x):
        return self.gram @ x

    def gram_diag(self, num_vertices, dtype, device):
        return torch.diagonal(self.gram).to(dtype)

    def grad(self, x, obs):
        return self.gram @ x - obs

    def quad_obj(self, x, obs):
        return torch.dot(x, 0.5 * (self.gram @ x) - obs)

    def ones_image(self, num_vertices, obs):
        return obs.sum(), self.gram.sum()


class DiagOp(QuadOp):
    """Diagonal ``A^t A`` (reference ``N == 0`` with non-null ``A``)."""

    def __init__(self, diag):
        self.diag = diag  # [V]

    def gram_apply(self, x):
        if x.ndim > 1:
            return self.diag[:, None] * x
        return self.diag * x

    def gram_diag(self, num_vertices, dtype, device):
        return self.diag.to(dtype)

    def grad(self, x, obs):
        return self.diag * x - obs

    def quad_obj(self, x, obs):
        return torch.dot(x, 0.5 * self.diag * x - obs)

    def ones_image(self, num_vertices, obs):
        return obs.sum(), self.diag.sum()


class IdentityOp(QuadOp):
    """Identity ``A`` (reference ``N == 0`` with ``A == NULL``)."""

    def gram_apply(self, x):
        return x

    def gram_diag(self, num_vertices, dtype, device):
        return torch.ones(num_vertices, dtype=dtype, device=device)

    def grad(self, x, obs):
        return x - obs

    def quad_obj(self, x, obs):
        return torch.dot(x, 0.5 * x - obs)

    def ones_image(self, num_vertices, obs):
        return obs.sum(), torch.tensor(float(num_vertices), dtype=obs.dtype,
                                       device=obs.device)


class RankShardedOp(QuadOp):
    """An operator sharded over the ranks of a process group
    (:mod:`..parallel.cp_dist`): every cut-pursuit loop (host, device and
    chained) contracts it through :meth:`reduced`, which sums the reduction
    over the ranks so that every rank gets the same reduced problem, and
    never reads its local blocks as the whole operator."""

    #: rows of the dense operator the contraction forms (global, padded);
    #: 0 for an operator without an observation axis (the Gram mode)
    num_obs: int = 0

    def reduced(self, obs, cv, rv_cap: int, pre_at: bool, onehot_max: int):
        """``(r_op, mat, ry, lipsch)`` of the problem contracted onto the
        component assignment ``cv`` (``rv_cap`` padded components): one-hot
        products up to ``onehot_max`` components, and for a dense operator
        segment sums beyond (never premultiplied there), as the device loop
        contracts a single-device operator."""
        raise NotImplementedError


def make_operator(a, num_vertices: int, dtype=None,
                  device="cuda") -> QuadOp:
    """Infers the operator mode from the shape of ``a``: ``None`` or scalar 1
    -> identity; 1-D of length V -> diagonal; (V, V) -> Gram; otherwise
    dense (N, V)."""
    if a is None:
        return IdentityOp()
    a = torch.as_tensor(a, dtype=dtype, device=device)
    if a.ndim == 0:
        return IdentityOp() if bool(a == 1) else DiagOp(
            torch.full((num_vertices,), float(a), dtype=a.dtype,
                       device=device))
    if a.ndim == 1:
        if a.shape[0] != num_vertices:
            raise ValueError(f"diagonal operator has length {a.shape[0]}, "
                             f"expected V={num_vertices}")
        return DiagOp(a)
    if a.ndim == 2:
        if a.shape[1] != num_vertices:
            raise ValueError(f"operator has {a.shape[1]} columns, "
                             f"expected V={num_vertices}")
        if a.shape[0] == num_vertices:
            # ambiguous square case: premultiplied meaning, as the reference's
            # AtA entry points declare; build DenseOp directly otherwise
            return GramOp(a)
        return DenseOp(a)
    raise ValueError(f"operator must have ndim <= 2, got {a.ndim}")
