"""One PFDR edge + vertex stage over offset families plus a remainder: the
hand-written Hopper kernel ``csrc/circulant_fused.cu`` and its plain
PyTorch version.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.circulant_fused``
(``fused_circulant_iteration``).  The TPU kernel shifts the dense
``[VV8, 128]`` field by each family's offset (``_flat_shift``, rolls split
into row and lane parts); here the shift is index arithmetic
``(u + d_f) mod VV`` with the offsets ``d_f`` an int32 device array, and
the ``(row, lane)`` offset table, the VMEM budget and ``max_fused_vertices``
have no counterpart.  The kernel reads ``wv`` and ``w_d1v`` from the
preconditioner where the TPU kernel derives them from ``wu`` and ``w_d1u``.
A vertex whose remainder row holds more than :data:`.banded.LONG_ROW`
slots (the endpoints of the remainder's padding edges) is ended by a
second launch, one block per such row.

:func:`fused_circulant_iteration` launches the CUDA kernel for tensors on a
CUDA device and runs :func:`circulant_fused_plain` for tensors on the CPU;
there is no other fallback.  Each launch adds one to
``fused_circulant_iteration.launches``.  The kernel writes every slot's
``zu``/``zv``; those of virtual slots (no edge) depend on the path and are
never consumed, so comparisons hold only the real slots.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .banded_fused import _VKIND, check_stage_fields, edge_stage_plain


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


def _lib():
    lib = _build.cuda_kernels()
    if not getattr(lib, "_cp_circulant_declared", False):
        ptr, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for name in ("cp_circulant_fused_f32", "cp_circulant_fused_f64"):
            fn = getattr(lib, name)
            fn.restype = i
            fn.argtypes = ([ptr] * 17 + [i] + [ptr] * 6
                           + [i, i, i, i, d, i, i, d, d, ptr])
        lib.cp_circulant_partials_len.restype = i
        lib.cp_circulant_partials_len.argtypes = [i, i]
        lib._cp_circulant_declared = True
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


def fused_circulant_iteration(graph, x, grad, ga, th_l1, zu, zv, wu, wv,
                              w_d1u, w_d1v, th_d1, *, rho: float, vkind: str,
                              positivity: bool, lo: float, hi: float):
    """One fused PFDR edge + vertex step on a
    :class:`..circulant.CirculantGraphD1`.

    Args:
      graph: the container (offsets, padded vertex count, remainder).
      x, grad, ga, th_l1: [V] vertex fields.
      zu, zv, wu, wv, w_d1u, w_d1v, th_d1: [E] edge fields in the
        container's edge order (families, then remainder).
      rho: relaxation parameter; vkind / positivity / lo / hi: vertex prox.

    Returns:
      ``(x_new [V], zu_new, zv_new [E], num, den)``.
    """
    vertex = (x, grad, ga, th_l1)
    edge = (zu, zv, wu, wv, w_d1u, w_d1v, th_d1)
    kw = dict(rho=rho, vkind=vkind, positivity=positivity, lo=lo, hi=hi)
    if not x.is_cuda:
        return circulant_fused_plain(graph, *vertex, *edge, **kw)
    nv, ne = graph.num_vertices, graph.num_edges
    check_stage_fields(vertex, edge, nv, ne, vkind)
    if graph.offsets_dev.device != x.device:
        raise ValueError(f"fields on {x.device}, the graph on "
                         f"{graph.offsets_dev.device}")
    lib = _lib()
    vv, nf = graph.vv, len(graph.offsets)
    xo = torch.empty_like(x)
    zuo = torch.empty_like(zu)
    zvo = torch.empty_like(zv)
    rem, ner, n_long = remainder_index(graph)
    partials = x.new_empty(lib.cp_circulant_partials_len(vv, n_long))
    sums = x.new_empty(2)
    # family sums of the vertices whose remainder rows the long-row launch
    # ends
    acc_part = x.new_empty(nv) if n_long else None
    fn = (lib.cp_circulant_fused_f32 if x.dtype == torch.float32
          else lib.cp_circulant_fused_f64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*[a.data_ptr() for a in vertex + edge],
                graph.offsets_dev.data_ptr(), *rem, n_long,
                xo.data_ptr(), zuo.data_ptr(), zvo.data_ptr(),
                acc_part.data_ptr() if n_long else 0,
                partials.data_ptr(), sums.data_ptr(), nv, vv, nf, ner,
                float(rho), _VKIND[vkind], int(positivity), float(lo),
                float(hi), stream)
    if rc != 0:
        raise RuntimeError(f"circulant_fused launch failed (CUDA error {rc})")
    fused_circulant_iteration.launches += 1
    return xo, zuo, zvo, sums[0], sums[1]


fused_circulant_iteration.launches = 0
