"""One PFDR edge + vertex stage on an unstructured graph: the hand-written
Hopper kernel ``csrc/banded_fused.cu`` and its plain PyTorch version.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.banded_fused``
(``fused_banded_iteration``): forward step, endpoint gathers, d1 pair prox
with relaxation, weighted edge -> vertex average, vertex prox and the
evolution sums, in one launch: L lanes of a warp per vertex
(:func:`launch_shape`), a block per vertex of more than
:data:`.banded.LONG_ROW` incident slots (a hub; the container's padding
edges make the endpoints of its last edge such), and the sums ended by the
last block to finish.  The JAX kernel's VMEM admission
(``supports_fused_plan``) has no counterpart.

:func:`fused_banded_iteration` launches the CUDA kernel for tensors on a
CUDA device and runs :func:`banded_fused_plain` for tensors on the CPU;
there is no other fallback.  Each launch adds one to
``fused_banded_iteration.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import operator

import numpy as np
import torch

from . import banded
from .banded import LONG_ROW, _raw_stream, banded_scatter_plain
from .prox import vertex_prox_plain

_VKIND = {"none": 0, "l1": 1, "bounds": 2}
_VERTEX = ("x", "grad", "ga", "th_l1")
_EDGE = ("zu", "zv", "wu", "wv", "w_d1u", "w_d1v", "th_d1")
# threads of a block and most lanes a vertex; must equal kBandedFusedBlock
# and kMaxVertexLanes in csrc/banded_fused.cu
BLOCK = 256
MAX_LANES = 32
# what a plan's key holds of each stage field
_SIGNATURE = operator.attrgetter("dtype", "shape", "device")


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


def launch_shape(offsets, long_rows):
    """``(lanes, vertex tiles, long-row blocks)`` of a launch on a graph
    whose incidence list has the offsets ``offsets`` ([V + 1]) and the rows
    ``long_rows`` of more than :data:`.banded.LONG_ROW` slots.

    ``lanes`` is the smallest power of two at least the mean slot count of
    the other rows (at most :data:`MAX_LANES`).  Tile ``b`` holds vertices
    ``b * BLOCK // lanes ...``, thread ``i`` of it vertex
    ``b * BLOCK // lanes + i // lanes`` as its lane ``i % lanes``, which
    takes the row's slots ``beg + lane, beg + lane + lanes, ...``; a tile
    skips the long rows, and block ``tiles + k`` takes ``long_rows[k]``.
    """
    deg = np.diff(np.asarray(offsets, np.int64))
    short = deg[deg <= LONG_ROW]
    mean = float(short.mean()) if short.size else 1.0
    lanes = 1
    while lanes < mean and lanes < MAX_LANES:
        lanes *= 2
    return lanes, -(-len(deg) // (BLOCK // lanes)), len(long_rows)


class _Plan(ctypes.Structure):
    """``BandedFusedPlan`` of ``csrc/banded_fused.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("eu", "ev", "offsets", "slots", "long_rows", "partials",
                  "ticket")]
                + [(n, ctypes.c_int) for n in
                   ("nv", "ne", "n_long", "lanes", "device")]
                + [(n, ctypes.c_double) for n in ("rho", "lo", "hi")]
                + [("vkind", ctypes.c_int), ("positivity", ctypes.c_int)])


@functools.cache
def _lib():
    """The kernels' library as :mod:`.banded` opens it, with the entries
    declared and the sizes mirrored here checked against the CUDA
    source."""
    lib = banded._lib()
    ptr = ctypes.c_void_p
    for t in ("f32", "f64"):
        fn = getattr(lib, f"cp_banded_fused_{t}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr] * 16
    lib.cp_banded_fused_plan_size.restype = ctypes.c_int
    lib.cp_banded_fused_plan_size.argtypes = []
    lib.cp_banded_fused_launch_shape.restype = None
    lib.cp_banded_fused_launch_shape.argtypes = [ctypes.c_int, ctypes.c_int,
                                                 ptr]
    if lib.cp_banded_fused_plan_size() != ctypes.sizeof(_Plan):
        raise RuntimeError("_Plan disagrees with csrc/banded_fused.cu")
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


def stage_key(fields, rho, vkind, positivity, lo, hi):
    """Key of a stage kernel's launch plan: each field's dtype, shape and
    device, and the stage's constants."""
    return (tuple(map(_SIGNATURE, fields)), float(rho), vkind,
            bool(positivity), float(lo), float(hi))


def run_stage(fn, plan, index, nv, ne, fields, name):
    """Calls a stage kernel's entry ``fn`` on a prepared ``plan`` (address)
    with the ``fields`` it reads, on the current stream of device
    ``index``; allocates the outputs (x and the two sums in one [V + 2]
    tensor, zu and zv in one [2, E]: each tensor made costs the host a few
    µs) and returns ``(x_new, zu_new, zv_new, num, den)``.  Raises if a
    field is not contiguous or the launch fails."""
    if not all(map(torch.Tensor.is_contiguous, fields)):
        raise ValueError(f"{name}: a stage field is not contiguous")
    x = fields[0]
    out = x.new_empty(nv + 2)
    z = x.new_empty((2, ne))
    base = out.data_ptr()
    rc = fn(plan, *[a.data_ptr() for a in fields], base, z.data_ptr(),
            base + nv * out.element_size(), _raw_stream(index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed (CUDA error {rc})")
    return (out.narrow(0, 0, nv), *z.unbind(), out[nv], out[nv + 1])


def _make_plan(graph, key, fields, rho, vkind, positivity, lo, hi):
    """Checks the fields once for ``key`` and prepares the launch:
    ``(C function, plan address, device index, the plan and its
    buffers)``, kept in ``graph._stage_plans``."""
    nv, ne = graph.num_vertices, graph.num_edges
    check_stage_fields(fields[:4], fields[4:], nv, ne, vkind)
    x = fields[0]
    idx = graph.edge_index()
    if idx.eu.device != x.device:
        raise ValueError(f"fields on {x.device}, the graph on "
                         f"{idx.eu.device}")
    lib = _lib()
    lanes, tiles, n_long = launch_shape(idx.offsets.cpu().numpy(),
                                        idx.long_rows)
    shape = (ctypes.c_int * 3)()
    lib.cp_banded_fused_launch_shape(nv, lanes, shape)
    if tuple(shape) != (BLOCK, MAX_LANES, tiles):
        raise RuntimeError("launch_shape disagrees with "
                           "csrc/banded_fused.cu")
    partials = x.new_empty(2 * (tiles + n_long))
    ticket = torch.zeros(1, dtype=torch.int32, device=x.device)
    plan = _Plan(idx.eu.data_ptr(), idx.ev.data_ptr(),
                 idx.offsets.data_ptr(), idx.slots.data_ptr(),
                 idx.long_rows.data_ptr(), partials.data_ptr(),
                 ticket.data_ptr(), nv, ne, n_long, lanes, x.device.index,
                 float(rho), float(lo), float(hi), _VKIND[vkind],
                 int(positivity))
    sfx = "f32" if x.dtype == torch.float32 else "f64"
    entry = (getattr(lib, f"cp_banded_fused_{sfx}"), ctypes.addressof(plan),
             x.device.index, (plan, partials, ticket))
    graph._stage_plans[key] = entry
    return entry


def fused_banded_iteration(graph, x, grad, ga, th_l1, zu, zv, wu, wv, w_d1u,
                           w_d1v, th_d1, *, rho: float, vkind: str,
                           positivity: bool, lo: float, hi: float):
    """One fused edge + vertex PFDR step on an unstructured graph.

    The checks run once per (graph, fields' dtypes, shapes and devices,
    stage constants); the plan (index pointers, lanes, partials and the
    ticket that elects the block ending the sums) stays on the graph
    (``graph._stage_plans``).  Two streams must not run a stage on the same
    graph at once: they would share the ticket and the partials.

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
    fields = (x, grad, ga, th_l1, zu, zv, wu, wv, w_d1u, w_d1v, th_d1)
    if not x.is_cuda:
        return banded_fused_plain(graph, *fields, rho=rho, vkind=vkind,
                                  positivity=positivity, lo=lo, hi=hi)
    key = stage_key(fields, rho, vkind, positivity, lo, hi)
    entry = graph._stage_plans.get(key)
    if entry is None:
        entry = _make_plan(graph, key, fields, rho, vkind, positivity, lo, hi)
    fn, plan, index, _ = entry
    out = run_stage(fn, plan, index, graph.num_vertices, graph.num_edges,
                    fields, "banded_fused")
    fused_banded_iteration.launches += 1
    return out


fused_banded_iteration.launches = 0
