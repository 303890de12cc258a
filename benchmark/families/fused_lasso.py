"""EEG fused LASSO through the port's reference-shaped API, as upstream's
example calls it (``example_EEG_CP.m``): ``api.cp_quadratic_d1_l1`` with the
example's options, positivity, ``cut="host"`` (the API's default) and the
sphere's three-family stencil graph built once in set-up.  One call a time
sample (the ``"eeg"`` mix), with numpy inputs, as a user's script makes
them.
"""
from __future__ import annotations

import numpy as np
import torch

from harness.traffic import EEG, lambda_of

SPANS = (("api", "_tensor", "api_inputs"),
         ("solvers.cut_pursuit", "_d1_sign_terms", "gradient"),
         ("solvers.cut_pursuit", "_steepest_cut", "host_cut"),
         ("solvers.cut_pursuit", "connected_components", "components"),
         ("solvers.cut_pursuit", "build_reduced_graph", "contraction"),
         ("solvers.cut_pursuit", "component_representatives", "contraction"),
         ("solvers.cut_pursuit", "pad_reduced_graph", "contraction"),
         ("solvers.cut_pursuit", "make_reduced_container", "contraction"),
         ("solvers.cut_pursuit", "_reduce_solve_small", "reduced_solve"),
         ("solvers.cut_pursuit", "_merge_close", "merge"))


class System:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        from cp_pfdr_graph_d1_tpu_torch import StencilGraphD1, api
        if config["dtype"] != "float32":
            raise ValueError("the EEG configuration runs in float32")
        self.traffic = EEG(config, mix, seed)
        # the penalty is fixed from the run's first sample (window solve 0)
        self.y0 = self.traffic.draw(0, 0)
        self.lam = lambda_of(self.traffic.phi, self.y0,
                             float(config["lambda_scale"]))
        m = config["mesh"]
        self.graph = StencilGraphD1.create(
            (int(m["n_theta"]), int(m["n_phi"])),
            {tuple(s): self.lam for s in m["shifts"]},
            wrap=tuple(m["wrap"]), dtype=torch.float32, device=device)
        self.la_l1 = np.full(self.traffic.num_v, self.lam, np.float32)
        self.options = dict(config["options"])
        self.device = device
        self._api = api

    def inputs(self, *index: int):
        return self.traffic.draw(*index)

    def solve(self, y):
        out = self._api.cp_quadratic_d1_l1(
            y, self.traffic.phi, None, None, None, self.la_l1,
            graph=self.graph, device=self.device, **self.options)
        return out.Cv, out.rX, out.it

    def handed(self, *index: int) -> dict:
        return dict(phi=self.traffic.phi, y=self.traffic.draw(*index),
                    y0=self.y0)

    def close(self):
        self.graph = None

