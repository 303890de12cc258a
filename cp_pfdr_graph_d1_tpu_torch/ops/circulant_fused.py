"""One PFDR edge + vertex stage over offset families plus a remainder: the
hand-written Hopper kernel ``csrc/circulant_fused.cu`` and its plain
PyTorch version.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.circulant_fused``
(``fused_circulant_iteration``).  The TPU kernel shifts the dense
``[VV8, 128]`` field by each family's offset (``_flat_shift``, rolls split
into row and lane parts); here the shift is index arithmetic
``(u + d_f) mod VV`` with the offsets ``d_f`` an int32 device array, and
the ``(row, lane)`` offset table, the VMEM budget and ``max_fused_vertices``
have no counterpart.  As the TPU kernel, the CUDA kernel derives ``wv`` and
``w_d1v`` from ``wu``, ``w_d1u`` and the endpoints' Gamma (the identity the
quadratic preconditioner satisfies up to rounding), on the families and on
the remainder; the plain version reads them.  A first launch writes the
forward field and sums the remainder rows of more than
:data:`.banded.LONG_ROW` slots (the endpoints of the remainder's padding
edges); the main launch gives each padded vertex a few threads, each a
group of its families (:func:`launch_shape`), and ends the sums in its last
block.

:func:`fused_circulant_iteration` launches the CUDA kernel for tensors on a
CUDA device and runs :func:`circulant_fused_plain` for tensors on the CPU;
there is no other fallback.  Each launch adds one to
``fused_circulant_iteration.launches``.  The kernel writes every slot's
``zu``/``zv``; those of virtual slots (no edge) depend on the path and are
never consumed, so comparisons hold only the real slots.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import banded
from .banded_fused import (_VKIND, check_stage_fields, edge_stage_plain,
                           run_stage, stage_key)

# threads of a main-launch block and most family groups a vertex; must
# equal kCircBlock and kMaxFamilyGroups in csrc/circulant_common.cuh
BLOCK = 256
MAX_GROUPS = 8


def circulant_fused_plain(graph, x, grad, ga, th_l1, zu, zv, wu, wv, w_d1u,
                          w_d1v, th_d1, *, rho: float, vkind: str,
                          positivity: bool, lo: float, hi: float):
    """Plain PyTorch version of the kernel (same arguments and results as
    :func:`fused_circulant_iteration`): the staged stage on the container,
    endpoint gathers by ``eu``/``ev`` and the sum over the incidence table
    of the real edges."""
    return edge_stage_plain(
        graph.eu, graph.ev, graph.edge_to_vertex_sum, x, grad, ga, th_l1,
        zu, zv, wu, wv, w_d1u, w_d1v, th_d1, rho=rho, vkind=vkind,
        positivity=positivity, lo=lo, hi=hi)


def launch_shape(vv: int, nf: int):
    """``(groups, blocks)`` of the main launch on ``nf`` families over
    ``vv`` padded vertices: ``groups`` is the largest power of two at most
    ``min(nf, MAX_GROUPS)``.  Block ``b`` holds the padded vertices
    ``b * tv ...`` with ``tv = BLOCK // groups``; its thread ``i`` takes
    vertex ``b * tv + i % tv`` (if below ``vv``) and group ``g = i // tv``,
    the families ``g * nf // groups`` to ``(g + 1) * nf // groups``."""
    groups = 1
    while 2 * groups <= min(nf, MAX_GROUPS):
        groups *= 2
    return groups, -(-vv // (BLOCK // groups))


class _Plan(ctypes.Structure):
    """``CirculantPlan`` of ``csrc/circulant_fused.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("offs", "reu", "rev", "roff", "rslots", "long_rows", "fp",
                  "acc_part", "partials", "ticket")]
                + [(n, ctypes.c_int) for n in
                   ("nv", "vv", "nf", "ner", "n_long", "device")]
                + [(n, ctypes.c_double) for n in ("rho", "lo", "hi")]
                + [("vkind", ctypes.c_int), ("positivity", ctypes.c_int)])


@functools.cache
def _lib():
    """The kernels' library as :mod:`.banded` opens it (which checks
    ``LONG_ROW``), with the entries declared and the plan's size checked
    against the CUDA source."""
    lib = banded._lib()
    ptr = ctypes.c_void_p
    for t in ("f32", "f64"):
        fn = getattr(lib, f"cp_circulant_fused_{t}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr] * 14
    lib.cp_circulant_plan_size.restype = ctypes.c_int
    lib.cp_circulant_plan_size.argtypes = []
    lib.cp_circulant_launch_shape.restype = None
    lib.cp_circulant_launch_shape.argtypes = [ctypes.c_int, ctypes.c_int,
                                              ptr]
    if lib.cp_circulant_plan_size() != ctypes.sizeof(_Plan):
        raise RuntimeError("_Plan disagrees with csrc/circulant_fused.cu")
    return lib


def remainder_index(graph):
    """``((eu, ev, offsets, slots, long_rows), count, n_long)`` of the
    remainder's kernel index: device pointers, the remainder's edge count
    and its number of rows of more than ``ops.banded.LONG_ROW`` slots;
    null pointers and zeros when the graph has no remainder."""
    if graph.rem_graph is None:
        return (0,) * 5, 0, 0
    idx = graph.rem_graph.edge_index()
    return ((idx.eu.data_ptr(), idx.ev.data_ptr(), idx.offsets.data_ptr(),
             idx.slots.data_ptr(), idx.long_rows.data_ptr()), graph.num_rem,
            idx.long_rows.numel())


def _make_plan(graph, key, vertex, edge, rho, vkind, positivity, lo, hi):
    """Checks the fields once for ``key`` and prepares the launch:
    ``(C function, plan address, device index, the plan and its
    buffers)``, kept in ``graph._stage_plans``."""
    nv, ne = graph.num_vertices, graph.num_edges
    check_stage_fields(vertex, edge, nv, ne, vkind)
    x = vertex[0]
    if graph.offsets_dev.device != x.device:
        raise ValueError(f"fields on {x.device}, the graph on "
                         f"{graph.offsets_dev.device}")
    lib = _lib()
    vv, nf = graph.vv, len(graph.offsets)
    groups, blocks = launch_shape(vv, nf)
    shape = (ctypes.c_int * 2)()
    lib.cp_circulant_launch_shape(vv, nf, shape)
    if tuple(shape) != (groups, blocks):
        raise RuntimeError("launch_shape disagrees with "
                           "csrc/circulant_common.cuh")
    rem, ner, n_long = remainder_index(graph)
    fp = x.new_empty(vv)
    # remainder-row sums of the vertices of long remainder rows
    acc_part = x.new_empty(nv) if n_long else None
    partials = x.new_empty(2 * blocks)
    ticket = torch.zeros(1, dtype=torch.int32, device=x.device)
    plan = _Plan(graph.offsets_dev.data_ptr(), *rem, fp.data_ptr(),
                 acc_part.data_ptr() if n_long else 0, partials.data_ptr(),
                 ticket.data_ptr(), nv, vv, nf, ner, n_long, x.device.index,
                 float(rho), float(lo), float(hi), _VKIND[vkind],
                 int(positivity))
    sfx = "f32" if x.dtype == torch.float32 else "f64"
    entry = (getattr(lib, f"cp_circulant_fused_{sfx}"),
             ctypes.addressof(plan), x.device.index,
             (plan, fp, acc_part, partials, ticket))
    graph._stage_plans[key] = entry
    return entry


def fused_circulant_iteration(graph, x, grad, ga, th_l1, zu, zv, wu, wv,
                              w_d1u, w_d1v, th_d1, *, rho: float, vkind: str,
                              positivity: bool, lo: float, hi: float):
    """One fused PFDR edge + vertex step on a
    :class:`..circulant.CirculantGraphD1`.

    The checks run once per (graph, fields' dtypes, shapes and devices,
    stage constants); the plan (index pointers, the forward field's and the
    long rows' scratch, the partials and the ticket that elects the block
    ending the sums) stays on the graph (``graph._stage_plans``).  Two
    streams must not run a stage on the same graph at once: they would
    share the scratch.

    Args:
      graph: the container (offsets, padded vertex count, remainder).
      x, grad, ga, th_l1: [V] vertex fields.
      zu, zv, wu, wv, w_d1u, w_d1v, th_d1: [E] edge fields in the
        container's edge order (families, then remainder); the kernel reads
        neither ``wv`` nor ``w_d1v``.
      rho: relaxation parameter; vkind / positivity / lo / hi: vertex prox.

    Returns:
      ``(x_new [V], zu_new, zv_new [E], num, den)``.
    """
    if not x.is_cuda:
        return circulant_fused_plain(
            graph, x, grad, ga, th_l1, zu, zv, wu, wv, w_d1u, w_d1v, th_d1,
            rho=rho, vkind=vkind, positivity=positivity, lo=lo, hi=hi)
    fields = (x, grad, ga, th_l1, zu, zv, wu, w_d1u, th_d1)
    key = stage_key(fields, rho, vkind, positivity, lo, hi)
    entry = graph._stage_plans.get(key)
    if entry is None:
        entry = _make_plan(graph, key, (x, grad, ga, th_l1),
                           (zu, zv, wu, wv, w_d1u, w_d1v, th_d1), rho, vkind,
                           positivity, lo, hi)
    fn, plan, index, _ = entry
    out = run_stage(fn, plan, index, graph.num_vertices, graph.num_edges,
                    fields, "circulant_fused")
    fused_circulant_iteration.launches += 1
    return out


fused_circulant_iteration.launches = 0
