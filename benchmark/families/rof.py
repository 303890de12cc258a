"""Total-variation (ROF) denoising through the port's device cut-pursuit.

``solvers.cut_pursuit.cp_quadratic_d1(IdentityOp(), obs, graph, opt)`` on a
4-neighbour ``StencilGraphD1`` built once in set-up, one new image a solve
(the ``"cartoon"`` mix).  A solve ends when its ``cv`` and ``rx`` are numpy
arrays on the host.
"""
from __future__ import annotations

import torch

from harness.traffic import Cartoon

# host spans of a traced run: (module of the port, function, label)
SPANS = tuple(("solvers.cut_pursuit_device", fn, label) for fn, label in (
    ("_direction_costs", "cut_costs"), ("_device_cut", "cut"),
    ("_read_cuts", "cut_read"), ("contract", "contract"),
    ("_reduce_vertex_terms", "reduce"), ("_reduced_problem", "reduce"),
    ("_kernel_solve", "reduced_solve"), ("_device_merge", "merge"),
    ("_evolution", "evolution")))


class System:
    """The system under test of one run, and the inputs it is handed."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from cp_pfdr_graph_d1_tpu_torch import (CPOptions, IdentityOp,
                                                PFDROptions, StencilGraphD1)
        from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit import \
            cp_quadratic_d1
        self.dtype = getattr(torch, config["dtype"])
        self.traffic = Cartoon(mix, seed, device, self.dtype)
        side = self.traffic.side
        lam = float(config["weight"])
        self.graph = StencilGraphD1.create(
            (side, side), {tuple(s): lam for s in config["shifts"]},
            dtype=self.dtype, device=device)
        self.opt = CPOptions(pfdr=PFDROptions(**config["pfdr"]),
                             **config["cp"])
        self.op = IdentityOp()
        self._solve = cp_quadratic_d1

    def inputs(self, *index: int):
        return self.traffic.draw(*index)

    def solve(self, obs):
        """``(cv, rx, it)``: the partition and values on the host."""
        res = self._solve(self.op, obs, self.graph, opt=self.opt)
        return res.cv, res.rx, res.it

    def handed(self, *index: int) -> dict:
        """What the reference is handed for one solve: the same image,
        drawn again from its index (the draw is deterministic on one
        device), in float64."""
        y = self.traffic.draw(*index).to(torch.float64)
        side = self.traffic.side
        return dict(y=y.reshape(side, side))

    def close(self):
        self.graph = None

