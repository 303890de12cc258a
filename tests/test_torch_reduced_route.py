"""Where cut-pursuit solves its reduced problems
(``solvers/cut_pursuit_common.reduced_solve_route``), and the solves that
the options of the staged loop give, against the JAX package on the CPU in
float64.

The route follows the JAX package's rule (``cp_pfdr_graph_d1_tpu/solvers/
cut_pursuit.py:515-519``): the whole-solve kernels need ``fused != "off"``,
``dif_rcd == 0`` and ``verbose == 0``, and tensors on the accelerator or
``fused == "on"``.  The port departs from it in one place: ``fused="on"``
with ``dif_rcd > 0`` or ``verbose > 0`` raises instead of leaving the
kernels it asks for.  Solutions are compared as in
``test_torch_cut_pursuit.py``: at 1e-6, objectives at 1e-9 relative.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_pfdr_graph_d1_tpu as J
import cp_pfdr_graph_d1_tpu_torch as T
from cp_pfdr_graph_d1_tpu.solvers.cut_pursuit import \
    cp_quadratic_d1 as jax_cp
from cp_pfdr_graph_d1_tpu_torch import config
from cp_pfdr_graph_d1_tpu_torch.ops import solve_fused, solve_small
from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit import \
    cp_quadratic_d1 as torch_cp
from cp_pfdr_graph_d1_tpu_torch.solvers.cut_pursuit_common import \
    reduced_solve_route

from .test_torch_cut_pursuit import JAX_OPT, H, W, objective, port_opt, \
    problem

torch.set_num_threads(1)


def expected_route(fused, dif_rcd, verbose, on_cuda):
    """The JAX package's rule, with the "on" refusal; None for a raise."""
    if fused == "off" or not (on_cuda or fused == "on"):
        return "staged"
    if dif_rcd or verbose:
        return None if fused == "on" else "staged"
    return "kernel"


@pytest.mark.parametrize("on_cuda", [False, True])
@pytest.mark.parametrize("verbose", [0, 10])
@pytest.mark.parametrize("dif_rcd", [0.0, 1e-3])
@pytest.mark.parametrize("fused", ["off", "auto", "on"])
def test_route_table(fused, dif_rcd, verbose, on_cuda):
    opt = config.PFDROptions(fused=fused, dif_rcd=dif_rcd, verbose=verbose)
    want = expected_route(fused, dif_rcd, verbose, on_cuda)
    if want is None:
        name = "dif_rcd" if dif_rcd else "verbose"
        with pytest.raises(NotImplementedError, match=name):
            reduced_solve_route(opt, on_cuda)
    else:
        assert reduced_solve_route(opt, on_cuda) == want


@pytest.mark.parametrize("pfdr_kw", [dict(dif_rcd=1e-3),
                                     dict(dif_rcd=1e-2, cond_min=1e-2)])
def test_auto_with_reconditioning_matches_jax(pfdr_kw):
    """``fused="auto"`` with ``dif_rcd > 0``: the staged loop, as the JAX
    package solves it (no kernel and no raise)."""
    eu, ev, la, a, y = problem(seed=0)
    v = H * W
    la_l1 = np.full(v, 0.01)
    jopt = dataclasses.replace(
        JAX_OPT, pfdr=dataclasses.replace(JAX_OPT.pfdr, **pfdr_kw))
    res_j = jax_cp(J.DenseOp(jnp.asarray(a)), jnp.asarray(y),
                   J.GraphD1.create(eu, ev, la, num_vertices=v,
                                    dtype=jnp.float64),
                   la_l1=la_l1, positivity=True, opt=jopt)
    topt = port_opt(fused="auto")
    topt = dataclasses.replace(
        topt, pfdr=dataclasses.replace(topt.pfdr, **pfdr_kw))
    before = (solve_small.fused_pfdr_solve_small.launches,
              solve_fused.fused_pfdr_solve.launches)
    res_t = torch_cp(T.DenseOp(torch.from_numpy(a)), torch.from_numpy(y),
                     T.GraphD1.create(eu, ev, la, num_vertices=v,
                                      dtype=torch.float64, device="cpu"),
                     la_l1=la_l1, positivity=True, opt=topt)
    assert (solve_small.fused_pfdr_solve_small.launches,
            solve_fused.fused_pfdr_solve.launches) == before
    assert res_t.it == res_j.it
    x_j = res_j.rx[res_j.cv]
    x_t = res_t.rx[res_t.cv]
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(objective(x_t, a, y, eu, ev, la, la_l1),
                               objective(x_j, a, y, eu, ev, la, la_l1),
                               rtol=1e-9)
    assert len(res_t.rx) > 1  # the cuts split the grid
