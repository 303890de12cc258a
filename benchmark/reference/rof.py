"""Plain reference of total-variation (ROF) denoising on a 4-neighbour grid.

    P(x) = 1/2 ||x - y||^2 + lam * sum over grid edges |x_u - x_v|

The reference maximises the dual, ``D(p) = <D^t p, y> - 1/2 ||D^t p||^2``
over ``|p_e| <= lam``, by FISTA with step 1/8 (``||D||^2 <= 8`` on a
4-neighbour grid; Beck & Teboulle's fast gradient projection).  Any feasible
``p`` gives ``D(p) <= min P``, so ``P(x) - D(p)`` bounds from above how far
an answer ``x`` lies from the optimum: the number compared,
``objective_excess``, is that bound relative to ``D(p)``.

Plain PyTorch in float64 on the device it is handed, a batch of images at
once.  It imports nothing of the port and builds its own difference
operator: the graph's weights are ``lam`` on every edge inside the grid,
as the configuration states.
"""
from __future__ import annotations

import torch


def _diff(x):
    """Forward differences of [B, H, W] along the rows and the columns."""
    return x[:, :, 1:] - x[:, :, :-1], x[:, 1:, :] - x[:, :-1, :]


def _adjoint(ph, pv):
    """``D^t p`` for the horizontal [B, H, W-1] and vertical [B, H-1, W]
    edge values."""
    b, h, w1 = ph.shape
    out = torch.zeros((b, h, w1 + 1), dtype=ph.dtype, device=ph.device)
    out[:, :, 1:] += ph
    out[:, :, :-1] -= ph
    out[:, 1:, :] += pv
    out[:, :-1, :] -= pv
    return out


def primal(x, y, lam: float):
    """P(x) for [B, H, W] answers and observations, in float64."""
    x, y = x.double(), y.double()
    dh, dv = _diff(x)
    return (0.5 * ((x - y) ** 2).sum((1, 2))
            + lam * (dh.abs().sum((1, 2)) + dv.abs().sum((1, 2))))


def dual_solve(y, lam: float, iters: int, dtype=torch.float64):
    """FISTA on the dual for [B, H, W] observations, computed in ``dtype``.
    Returns ``(x, p)``: the primal point ``y - D^t p`` and the dual
    iterate ``(ph, pv)`` (``|p| <= lam`` by construction)."""
    y = y.to(dtype)
    b, h, w = y.shape
    ph = torch.zeros((b, h, w - 1), dtype=dtype, device=y.device)
    pv = torch.zeros((b, h - 1, w), dtype=dtype, device=y.device)
    qh, qv, t = ph, pv, 1.0
    for _ in range(iters):
        gh, gv = _diff(y - _adjoint(qh, qv))
        nh = torch.clamp(qh + gh / 8, -lam, lam)
        nv = torch.clamp(qv + gv / 8, -lam, lam)
        t_next = (1 + (1 + 4 * t * t) ** 0.5) / 2
        beta = (t - 1) / t_next
        qh, qv = nh + beta * (nh - ph), nv + beta * (nv - pv)
        ph, pv, t = nh, nv, t_next
    return y - _adjoint(ph, pv), (ph, pv)


def dual_value(y, ph, pv):
    """D(p) in float64."""
    u = _adjoint(ph.double(), pv.double())
    return (u * y.double()).sum((1, 2)) - 0.5 * (u * u).sum((1, 2))


def judge(config: dict, handed: list, answers: list, device) -> dict:
    """The numbers compared for a batch of solves: ``objective_excess``,
    the widest over the batch.  ``handed``: dicts with ``y`` [H, W];
    ``answers``: the program's ``x`` [H * W] (numpy, float64)."""
    lam = float(config["weight"])
    iters = int(config["check"]["reference_iters"])
    y = torch.stack([h["y"].to(device=device, dtype=torch.float64)
                     for h in handed])
    x = torch.stack([torch.as_tensor(a, dtype=torch.float64, device=device)
                     for a in answers]).reshape(y.shape)
    _, (ph, pv) = dual_solve(y, lam, iters)
    d = dual_value(y, ph, pv)
    excess = (primal(x, y, lam) - d) / d.abs()
    return dict(objective_excess=float(excess.max()))


def control_answers(config: dict, handed: list, device, dtype) -> list:
    """The control: the reference put in the program's place, computed in
    ``dtype``; its primal points as answers."""
    lam = float(config["weight"])
    iters = int(config["check"]["reference_iters"])
    y = torch.stack([h["y"].to(device=device, dtype=torch.float64)
                     for h in handed])
    x, _ = dual_solve(y, lam, iters, dtype=dtype)
    return [xi.double().reshape(-1).cpu().numpy() for xi in x]
