"""Connected components of a masked stencil graph: the hand-written Hopper
kernel ``csrc/components_fused.cu`` and its plain PyTorch version, plus the
first-encounter compaction of the labels.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.components_fused``
(``_fused_components_call``, ``stencil_components_fused``,
``compact_labels_device``, ``device_components_stencil_fused``).  Labels
are the smallest vertex index of each component, which after compaction is
the reference's DFS first-encounter numbering
(``CP_PFDR_graph_quadratic_d1_l1.cpp:570-596``).  The TPU kernel ran
synchronous rounds of min-label propagation, as many as the components'
diameters need; the card's kernel runs union-find in a fixed number of
passes (:data:`PASSES`: each 32 x 32 tile in shared memory, the edges
between tiles, the roots), the same labels whatever order its atomics land
in.  The plain version keeps the rounds of propagation.

:func:`fused_components` launches the kernel for tensors on a CUDA device
and runs :func:`components_plain` for tensors on the CPU; there is no other
fallback.  A launch goes through a plan (the shifts and the tile-label
scratch) kept in this module per field shape, shifts and device, so the
label tensor is a call's only allocation.  Each launch adds one to
``fused_components.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import banded
from .stencil_fused import MAX_FAMILIES, _roll2

# kCompThreads, kTileH, kTileW, kCompPasses of the CUDA source
THREADS = 256
TILE = (32, 32)
PASSES = 3


def components_plain(mask, *, shifts: Tuple, it_max: int):
    """Plain PyTorch version of the kernel (same arguments and results as
    :func:`fused_components`): synchronous rounds of min-label propagation
    over the set edges, each followed by two pointer jumps."""
    f, h, w = mask.shape
    big = h * w
    lab = torch.arange(h * w, device=mask.device).reshape(h, w)
    incoming = [_roll2(mask[k], dy, dx) for k, (dy, dx) in enumerate(shifts)]
    rounds = 0
    changed = True
    while changed and rounds < it_max:
        l = lab
        for k, (dy, dx) in enumerate(shifts):
            fwd = torch.where(mask[k], _roll2(l, -dy, -dx), big)
            bwd = torch.where(incoming[k], _roll2(l, dy, dx), big)
            l = torch.minimum(l, torch.minimum(fwd, bwd))
        flat = l.reshape(-1)
        flat = torch.minimum(flat, flat[flat])
        flat = torch.minimum(flat, flat[flat])
        changed = bool((flat != lab.reshape(-1)).any())
        lab = flat.reshape(h, w)
        rounds += 1
    return (lab.to(torch.int32),
            torch.tensor(rounds, dtype=torch.int32, device=mask.device))


class _Plan(ctypes.Structure):
    """``CompPlan`` of ``csrc/components_fused.cu``."""
    _fields_ = ([("tl", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in ("h", "w", "nf", "device")]
                + [("dy", ctypes.c_int * MAX_FAMILIES),
                   ("dx", ctypes.c_int * MAX_FAMILIES)])


@functools.cache
def _lib():
    """The kernels' library (:func:`.banded._lib`) with the entries
    declared and the constants mirrored here checked against the CUDA
    source."""
    lib = banded._lib()
    ptr = ctypes.c_void_p
    lib.cp_components_fused.restype = ctypes.c_int
    lib.cp_components_fused.argtypes = [ptr] * 4
    lib.cp_components_plan_size.restype = ctypes.c_int
    lib.cp_components_plan_size.argtypes = []
    lib.cp_components_shape.restype = None
    lib.cp_components_shape.argtypes = [ptr]
    shape = (ctypes.c_int * 4)()
    lib.cp_components_shape(shape)
    if (tuple(shape) != (THREADS, *TILE, PASSES)
            or lib.cp_components_plan_size() != ctypes.sizeof(_Plan)):
        raise RuntimeError("ops/components_fused.py disagrees with "
                           "csrc/components_fused.cu")
    return lib


def _make_plan(key, mask, shifts):
    """Prepares the launches of one field shape, shifts and device:
    ``(C function, plan address, device index, passes tensor, the plan)``,
    kept in ``_plans``."""
    f, h, w = mask.shape
    if not 1 <= f <= MAX_FAMILIES or f != len(shifts):
        raise ValueError(f"mask has {f} families for {len(shifts)} shifts; "
                         f"the kernel takes 1..{MAX_FAMILIES}")
    lib = _lib()
    pad = [0] * (MAX_FAMILIES - f)
    # each shift reduced to |dy| < H, |dx| < W (the same circular shift)
    dys = [int(math.fmod(dy, h)) for dy, _ in shifts]
    dxs = [int(math.fmod(dx, w)) for _, dx in shifts]
    tl = torch.empty((h, w), dtype=torch.int32, device=mask.device)
    plan = _Plan(tl.data_ptr(), h, w, f, mask.device.index,
                 (ctypes.c_int * MAX_FAMILIES)(*dys, *pad),
                 (ctypes.c_int * MAX_FAMILIES)(*dxs, *pad))
    passes = torch.full((), PASSES, dtype=torch.int32, device=mask.device)
    entry = (lib.cp_components_fused, ctypes.addressof(plan),
             mask.device.index, passes, (plan, tl))
    _plans[key] = entry
    return entry


_plans: dict = {}


def fused_components(mask, *, shifts: Tuple, it_max: int):
    """Smallest vertex index reachable over the set edges, for every cell.

    Args:
      mask: bool [F, H, W]; ``mask[f, i, j]`` sets the edge from cell
        ``(i, j)`` to ``(i + dy_f, j + dx_f)`` (circular).
      shifts: ((dy, dx), ...) of the F shift families.
      it_max: round cap of the plain version's propagation (the vertex
        count bounds the rounds needed); the kernel's passes are fixed.

    Returns:
      ``(labels int32 [H, W], rounds)``, ``rounds`` a 0-d int32 tensor: a
      diagnostic, the number of passes the schedule ran (the kernel's
      :data:`PASSES`, whatever the components' diameters; the plain
      version's rounds of propagation on the CPU).
    """
    if not mask.is_cuda:
        return components_plain(mask, shifts=shifts, it_max=it_max)
    if mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous bool tensor, got "
                         f"{mask.dtype}")
    f, h, w = mask.shape
    shifts = tuple((int(dy), int(dx)) for dy, dx in shifts)
    key = (f, h, w, shifts, mask.device)
    entry = _plans.get(key)
    if entry is None:
        entry = _make_plan(key, mask, shifts)
    fn, plan, index, passes, _ = entry
    lab = torch.empty((h, w), dtype=torch.int32, device=mask.device)
    rc = fn(plan, mask.data_ptr(), lab.data_ptr(), banded._raw_stream(index))
    if rc != 0:
        raise RuntimeError(f"components_fused launch failed (CUDA error "
                           f"{rc})")
    fused_components.launches += 1
    return lab, passes


fused_components.launches = 0


def stencil_components_fused(graph, edge_mask):
    """Roots (smallest reachable vertex index, int32 [V]) of the stencil
    graph over the edges where ``edge_mask`` [E] is set."""
    h, w = graph.field_shape
    f = len(graph.shifts)
    lab, _ = fused_components(edge_mask.reshape(f, h, w).contiguous(),
                              shifts=graph.shifts, it_max=h * w)
    return lab.reshape(-1)


def compact_labels_device(roots):
    """First-encounter 0..rV-1 renumbering of root labels (a component's
    root is its smallest vertex, so ascending roots are first-encounter
    order).  Returns ``(cv int32 [V], num_comp 0-d int64, firsts bool
    [V])``."""
    iota = torch.arange(roots.shape[0], device=roots.device)
    firsts = roots == iota
    mapping = torch.cumsum(firsts.to(torch.int32), 0, dtype=torch.int32) - 1
    return mapping[roots.to(torch.int64)], firsts.sum(), firsts


def device_components_stencil_fused(graph, active):
    """Components of the inactive nonzero-weight edges of a stencil graph:
    ``(cv, num_comp, firsts)`` as :func:`compact_labels_device`."""
    mask = ~active & (graph.la_d1 > 0)
    return compact_labels_device(stencil_components_fused(graph, mask))
