"""Endpoint gather and deterministic edge -> vertex sum on an unstructured
graph: the hand-written Hopper kernels ``csrc/banded.cu`` and their plain
PyTorch versions, with the host-side edge ordering of the banded container.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.banded``.  The JAX package
re-expresses both transfers as one-hot MXU products over banded edge tiles,
because the TPU has no vector gather; the selector machinery, the
``[V8, 128]`` / ``[T8, 128]`` layouts and the packed index blocks exist
only for that and are not ported.  What is ported is what fixes the edge
order, which per-edge solver state follows: :func:`build_banded_plan`'s
stable sort by smaller endpoint and its padding to a multiple of the tile
with weight-0 copies of the last edge, and :func:`rcm_order`.

:func:`banded_gather` and :func:`banded_scatter` launch the CUDA kernels for
tensors on a CUDA device and run :func:`banded_gather_plain` and
:func:`banded_scatter_plain` for tensors on the CPU; there is no other
fallback.  Each launch adds one to ``banded_gather.launches`` or
``banded_scatter.launches``.  The scatter sums every vertex's incident
slots in a fixed order (no float atomics), so it gives the same sum in
every run.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..graph import incidence_csr

# rows of more incident slots than this take a block each in the scatter
# kernel; must equal kLongRow in csrc/banded.cu
LONG_ROW = 64


class BandedPlan(NamedTuple):
    """Host-built tiling of an edge list sorted by smaller endpoint.

    Attributes:
      starts8: [num_tiles] int32 first 128-vertex row of each tile's window.
      num_tiles, tile, wd8, v8: geometry (window width and vertex count in
        rows of 128).
    """
    starts8: np.ndarray
    num_tiles: int
    tile: int
    wd8: int
    v8: int


class EdgeIndex(NamedTuple):
    """Device-side index of a graph for the kernels: int32 endpoints, the
    incidence list (:func:`..graph.incidence_csr`) and the rows of more
    than :data:`LONG_ROW` slots."""
    eu: torch.Tensor
    ev: torch.Tensor
    offsets: torch.Tensor
    slots: torch.Tensor
    long_rows: torch.Tensor


def edge_index(eu, ev, num_vertices: int) -> EdgeIndex:
    eu32 = eu.to(torch.int32).contiguous()
    ev32 = ev.to(torch.int32).contiguous()
    offsets, slots = incidence_csr(eu32, ev32, num_vertices)
    deg = offsets[1:] - offsets[:-1]
    long_rows = torch.nonzero(deg > LONG_ROW).reshape(-1).to(torch.int32)
    return EdgeIndex(eu32, ev32, offsets, slots, long_rows)


def rcm_order(eu, ev, num_vertices: int):
    """Bandwidth-reducing vertex permutation (reverse Cuthill-McKee).

    Returns ``order`` such that relabeling ``v -> inv[v]`` (with
    ``inv = argsort(order)``) makes ``|eu - ev|`` small.  Callers must
    permute every per-vertex quantity (operator columns, weights)
    consistently.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    e = np.ones(len(eu), np.int8)
    adj = coo_matrix((e, (eu, ev)), shape=(num_vertices, num_vertices))
    adj = (adj + adj.T).tocsr()
    return np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))


def build_banded_plan(eu, ev, num_vertices: int, tile: int = 1024,
                      round_wd8: bool = False):
    """Sorts edges stably by smaller endpoint, pads them to a multiple of
    ``tile`` and computes each tile's vertex window, as the JAX package
    does.

    Returns ``(plan, perm, epad)``: the plan, the edge permutation applied
    (callers reorder per-edge data with it; positions ``>= len(perm)`` are
    the padding) and the padded edge count ``num_tiles * tile``.
    ``round_wd8`` rounds the window width up to a power of two (capped at
    ``v8``).
    """
    if tile < 1:
        raise ValueError(f"tile must be positive, got {tile}")
    eu = np.asarray(eu, np.int64)
    ev = np.asarray(ev, np.int64)
    e = len(eu)
    if e == 0:
        raise ValueError("empty edge set")
    perm = np.argsort(np.minimum(eu, ev), kind="stable")
    eu, ev = eu[perm], ev[perm]
    nt = -(-e // tile)
    epad = nt * tile
    # pad with (weight-0) copies of the last edge: keeps the last window
    # tight and the padding inert
    eu = np.concatenate([eu, np.full(epad - e, eu[-1])])
    ev = np.concatenate([ev, np.full(epad - e, ev[-1])])

    v8 = -(-num_vertices // 128)
    starts8 = np.empty(nt, np.int32)
    wd = 0
    for i in range(nt):
        sl = slice(i * tile, (i + 1) * tile)
        lo = min(eu[sl].min(), ev[sl].min())
        hi = max(eu[sl].max(), ev[sl].max())
        starts8[i] = lo // 128
        wd = max(wd, int(hi) + 1 - int(starts8[i]) * 128)
    wd8 = -(-wd // 128)
    if round_wd8:
        p2 = 1
        while p2 < wd8:
            p2 *= 2
        wd8 = p2
    wd8 = min(wd8, v8)
    starts8 = np.minimum(starts8, v8 - wd8).clip(0)
    return BandedPlan(starts8, nt, tile, int(wd8), int(v8)), perm, epad


def banded_gather_plain(graph, x):
    """Plain PyTorch version of the gather: ``(x[eu], x[ev])``."""
    return x[graph.eu], x[graph.ev]


def banded_scatter_plain(graph, vals_u, vals_v):
    """Plain PyTorch version of the scatter: the incident slots of each
    vertex summed in slot order, as a segment sum over the incidence
    list."""
    idx = graph.edge_index()
    vals = torch.cat([vals_u, vals_v])[idx.slots.to(torch.int64)]
    return torch.segment_reduce(vals, "sum",
                                offsets=idx.offsets.to(torch.int64))


class _Plan(ctypes.Structure):
    """``BandedPlan`` of ``csrc/banded.cu``."""
    _fields_ = [("eu", ctypes.c_void_p), ("ev", ctypes.c_void_p),
                ("offsets", ctypes.c_void_p), ("slots", ctypes.c_void_p),
                ("long_rows", ctypes.c_void_p), ("ne", ctypes.c_int),
                ("nv", ctypes.c_int), ("n_long", ctypes.c_int),
                ("k", ctypes.c_int), ("device", ctypes.c_int)]


@functools.cache
def _lib():
    """The kernels' library, opened as a ``ctypes.PyDLL``: a call keeps
    the GIL (the entries only enqueue launches), which saves its release
    and reacquisition on every launch.  The stage wrappers
    (``banded_fused``, ``circulant_fused``) declare their entries on it."""
    lib = ctypes.PyDLL(_build.cuda_kernels()._name)
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for t in ("f32", "f64"):
        fn = getattr(lib, f"cp_banded_gather_{t}")
        fn.restype = i
        fn.argtypes = [ptr] * 4
        fn = getattr(lib, f"cp_banded_scatter_{t}")
        fn.restype = i
        fn.argtypes = [ptr] * 5
    for name in ("cp_banded_long_row", "cp_banded_plan_size"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = []
    if lib.cp_banded_long_row() != LONG_ROW:
        raise RuntimeError("LONG_ROW disagrees with the CUDA source")
    if lib.cp_banded_plan_size() != ctypes.sizeof(_Plan):
        raise RuntimeError("_Plan disagrees with the CUDA source")
    return lib


def _check_float(name, a, like):
    if a.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the banded kernels take float32 or float64, not "
                         f"{a.dtype} ({name})")
    if a.dtype != like.dtype or a.device != like.device:
        raise ValueError(f"{name} is {a.dtype} on {a.device}; expected "
                         f"{like.dtype} on {like.device}")
    if not a.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if a.ndim not in (1, 2):
        raise ValueError(f"{name} must be 1-D or 2-D, got {tuple(a.shape)}")


def _make_plan(graph, kind, key, a, rows):
    """Checks a gather or scatter input ``a`` once for its (dtype, shape,
    device) and prepares the launch: ``(C function, plan address, output
    shape, device index, the plan)``.  ``rows`` is the leading size ``a``
    must have."""
    _check_float(kind, a, a)
    if a.shape[0] != rows:
        raise ValueError(f"{kind} input has {a.shape[0]} rows; expected "
                         f"{rows} for {graph.num_vertices} vertices and "
                         f"{graph.num_edges} edges")
    idx = graph.edge_index()
    if idx.eu.device != a.device:
        raise ValueError(f"input on {a.device}, the graph on "
                         f"{idx.eu.device}")
    lib = _lib()
    k = 1 if a.ndim == 1 else a.shape[1]
    plan = _Plan(idx.eu.data_ptr(), idx.ev.data_ptr(),
                 idx.offsets.data_ptr(), idx.slots.data_ptr(),
                 idx.long_rows.data_ptr(), graph.num_edges,
                 graph.num_vertices, idx.long_rows.numel(), k,
                 a.device.index)
    sfx = "f32" if a.dtype == torch.float32 else "f64"
    if kind == "gather":
        out_shape = (2, graph.num_edges) + tuple(a.shape[1:])
    else:
        out_shape = (graph.num_vertices,) + tuple(a.shape[1:])
    entry = (getattr(lib, f"cp_banded_{kind}_{sfx}"), ctypes.addressof(plan),
             out_shape, a.device.index, plan)
    graph._banded_plans[key] = entry
    return entry


# the current CUDA stream of a device (by index) as an integer handle;
# absent from builds of torch without CUDA, whose tensors never get here
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def banded_gather(graph, x):
    """Endpoint values of every edge of a :class:`..BandedGraphD1`:
    ``(x[eu], x[ev])`` for a contiguous [V] or [V, K] field ``x``; two rows
    of one [2, E(, K)] tensor.  The checks run once per (graph, dtype,
    shape, device) and their plan stays on the graph
    (``graph._banded_plans``); each call then allocates once and marshals
    four arguments."""
    if not x.is_cuda:
        return banded_gather_plain(graph, x)
    key = ("gather", x.dtype, x.shape, x.get_device())
    entry = graph._banded_plans.get(key)
    if entry is None:
        entry = _make_plan(graph, "gather", key, x, graph.num_vertices)
    if not x.is_contiguous():
        raise ValueError("x is not contiguous")
    fn, plan, out_shape, index, _ = entry
    out = x.new_empty(out_shape)
    rc = fn(plan, x.data_ptr(), out.data_ptr(), _raw_stream(index))
    if rc != 0:
        raise RuntimeError(f"banded gather launch failed (CUDA error {rc})")
    banded_gather.launches += 1
    return out.unbind()


def banded_scatter(graph, vals_u, vals_v):
    """``out[v] = sum_{eu[e]==v} vals_u[e] + sum_{ev[e]==v} vals_v[e]`` for
    contiguous [E] or [E, K] edge values, each vertex's slots summed in a
    fixed order.  Checked once per (graph, dtypes, shapes, devices), as
    :func:`banded_gather`."""
    if not vals_u.is_cuda:
        return banded_scatter_plain(graph, vals_u, vals_v)
    key = ("scatter", vals_u.dtype, vals_u.shape, vals_u.get_device(),
           vals_v.dtype, vals_v.shape, vals_v.get_device())
    entry = graph._banded_plans.get(key)
    if entry is None:
        _check_float("vals_v", vals_v, vals_u)
        if vals_v.shape != vals_u.shape:
            raise ValueError(f"edge values of shapes {tuple(vals_u.shape)} "
                             f"and {tuple(vals_v.shape)}")
        entry = _make_plan(graph, "scatter", key, vals_u, graph.num_edges)
    if not (vals_u.is_contiguous() and vals_v.is_contiguous()):
        raise ValueError("edge values are not contiguous")
    fn, plan, out_shape, index, _ = entry
    out = vals_u.new_empty(out_shape)
    rc = fn(plan, vals_u.data_ptr(), vals_v.data_ptr(), out.data_ptr(),
            _raw_stream(index))
    if rc != 0:
        raise RuntimeError(f"banded scatter launch failed (CUDA error {rc})")
    banded_scatter.launches += 1
    return out


banded_gather.launches = 0
banded_scatter.launches = 0
