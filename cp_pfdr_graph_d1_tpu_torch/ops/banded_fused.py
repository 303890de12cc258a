"""One PFDR edge + vertex stage on an unstructured graph: the hand-written
Hopper kernel ``csrc/banded_fused.cu`` and its plain PyTorch version.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.banded_fused``
(``fused_banded_iteration``): forward step, endpoint gathers, d1 pair prox
with relaxation, weighted edge -> vertex average, vertex prox and the
evolution sums: one thread per vertex, and a block per vertex of more
than :data:`.banded.LONG_ROW` incident slots (a hub; the container's
padding edges make the endpoints of its last edge such), then a last
one-block launch for the sums.  The JAX kernel's VMEM admission
(``supports_fused_plan``) has no counterpart.

:func:`fused_banded_iteration` launches the CUDA kernel for tensors on a
CUDA device and runs :func:`banded_fused_plain` for tensors on the CPU;
there is no other fallback.  Each launch adds one to
``fused_banded_iteration.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .banded import banded_scatter_plain
from .prox import vertex_prox_plain

_VKIND = {"none": 0, "l1": 1, "bounds": 2}
_VERTEX = ("x", "grad", "ga", "th_l1")
_EDGE = ("zu", "zv", "wu", "wv", "w_d1u", "w_d1v", "th_d1")


def edge_stage_plain(eu, ev, edge_to_vertex, x, grad, ga, th_l1, zu, zv, wu,
                     wv, w_d1u, w_d1v, th_d1, *, rho: float, vkind: str,
                     positivity: bool, lo: float, hi: float):
    """The staged PFDR edge + vertex stage (the JAX package's staged loop,
    ``solvers/pfdr_quadratic.py``): endpoint gathers by ``eu``/``ev``, the
    pair prox with relaxation, ``edge_to_vertex(wu zu, wv zv)``, the vertex
    prox and ``(x_new, zu_new, zv_new, sum (x_new - x)^2, sum x_new^2)``."""
    p = 2.0 * x - ga * grad
    au = p[eu] - zu
    av = p[ev] - zv
    avg = w_d1u * au + w_d1v * av
    diff = au - av
    shrunk = torch.sign(diff) * torch.clamp(diff.abs() - th_d1, min=0)
    zu_new = zu + rho * ((avg + w_d1v * shrunk) - x[eu])
    zv_new = zv + rho * ((avg - w_d1u * shrunk) - x[ev])
    acc = edge_to_vertex(wu * zu_new, wv * zv_new)
    xn = vertex_prox_plain(acc, th_l1, vkind, positivity, lo, hi)
    delta = xn - x
    return xn, zu_new, zv_new, (delta * delta).sum(), (xn * xn).sum()


def banded_fused_plain(graph, x, grad, ga, th_l1, zu, zv, wu, wv, w_d1u,
                       w_d1v, th_d1, *, rho: float, vkind: str,
                       positivity: bool, lo: float, hi: float):
    """Plain PyTorch version of the kernel (same arguments and results as
    :func:`fused_banded_iteration`)."""
    return edge_stage_plain(
        graph.eu, graph.ev,
        lambda vu, vv: banded_scatter_plain(graph, vu, vv),
        x, grad, ga, th_l1, zu, zv, wu, wv, w_d1u, w_d1v, th_d1, rho=rho,
        vkind=vkind, positivity=positivity, lo=lo, hi=hi)


def _lib():
    lib = _build.cuda_kernels()
    if not getattr(lib, "_cp_banded_fused_declared", False):
        ptr, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for name in ("cp_banded_fused_f32", "cp_banded_fused_f64"):
            fn = getattr(lib, name)
            fn.restype = i
            fn.argtypes = ([ptr] * 16 + [i] + [ptr] * 5
                           + [i, i, d, i, i, d, d, ptr])
        lib.cp_banded_fused_partials_len.restype = i
        lib.cp_banded_fused_partials_len.argtypes = [i, i]
        lib._cp_banded_fused_declared = True
    return lib


def check_stage_fields(vertex, edge, nv: int, ne: int, vkind: str):
    """Raises on stage fields the quadratic stage kernels do not take:
    ``vertex`` [nv] and ``edge`` [ne] fields of one float type on one
    device, contiguous."""
    x = vertex[0]
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {x.dtype}")
    if vkind not in _VKIND:
        raise ValueError(f"unknown vertex prox {vkind!r}")
    fields = ([(n, a, nv) for n, a in zip(_VERTEX, vertex)]
              + [(n, a, ne) for n, a in zip(_EDGE, edge)])
    for name, a, n in fields:
        if tuple(a.shape) != (n,):
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                             f"({n},)")
        if a.dtype != x.dtype or a.device != x.device:
            raise ValueError(f"{name} is {a.dtype} on {a.device}; expected "
                             f"{x.dtype} on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def fused_banded_iteration(graph, x, grad, ga, th_l1, zu, zv, wu, wv, w_d1u,
                           w_d1v, th_d1, *, rho: float, vkind: str,
                           positivity: bool, lo: float, hi: float):
    """One fused edge + vertex PFDR step on an unstructured graph.

    Args:
      graph: the graph (a :class:`..banded_graph.BandedGraphD1`: its
        ``eu``/``ev`` and incidence list).
      x, grad, ga, th_l1: [V] vertex fields.
      zu, zv, wu, wv, w_d1u, w_d1v, th_d1: [E] edge fields in the graph's
        edge order.
      rho: relaxation parameter; vkind / positivity / lo / hi: vertex prox.

    Returns:
      ``(x_new [V], zu_new, zv_new [E], num, den)`` with ``num``/``den``
      (0-d) the squared evolution and squared norm of the new iterate.
    """
    vertex = (x, grad, ga, th_l1)
    edge = (zu, zv, wu, wv, w_d1u, w_d1v, th_d1)
    kw = dict(rho=rho, vkind=vkind, positivity=positivity, lo=lo, hi=hi)
    if not x.is_cuda:
        return banded_fused_plain(graph, *vertex, *edge, **kw)
    nv, ne = graph.num_vertices, graph.num_edges
    check_stage_fields(vertex, edge, nv, ne, vkind)
    idx = graph.edge_index()
    if idx.eu.device != x.device:
        raise ValueError(f"fields on {x.device}, the graph on "
                         f"{idx.eu.device}")
    lib = _lib()
    xo = torch.empty_like(x)
    zuo = torch.empty_like(zu)
    zvo = torch.empty_like(zv)
    n_long = idx.long_rows.numel()
    partials = x.new_empty(lib.cp_banded_fused_partials_len(nv, n_long))
    sums = x.new_empty(2)
    fn = (lib.cp_banded_fused_f32 if x.dtype == torch.float32
          else lib.cp_banded_fused_f64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*[a.data_ptr() for a in vertex + edge], idx.eu.data_ptr(),
                idx.ev.data_ptr(), idx.offsets.data_ptr(),
                idx.slots.data_ptr(), idx.long_rows.data_ptr(), n_long,
                xo.data_ptr(), zuo.data_ptr(),
                zvo.data_ptr(), partials.data_ptr(), sums.data_ptr(), nv, ne,
                float(rho), _VKIND[vkind], int(positivity), float(lo),
                float(hi), stream)
    if rc != 0:
        raise RuntimeError(f"banded_fused launch failed (CUDA error {rc})")
    fused_banded_iteration.launches += 1
    return xo, zuo, zvo, sums[0], sums[1]


fused_banded_iteration.launches = 0
