"""Connected components of a masked stencil graph: the hand-written Hopper
kernel ``csrc/components_fused.cu`` and its plain PyTorch version, plus the
first-encounter compaction of the labels.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.components_fused``
(``_fused_components_call``, ``stencil_components_fused``,
``compact_labels_device``, ``device_components_stencil_fused``).  Labels
converge to the smallest vertex index of each component, which after
compaction is the reference's DFS first-encounter numbering
(``CP_PFDR_graph_quadratic_d1_l1.cpp:570-596``).  The TPU kernel ran many
cheap synchronous rounds without pointer jumping and compacted with a
double sort, because its gathers are element-serial; on the card pointer
jumping and a plain gather are fine, and the fixpoint is the same.

:func:`fused_components` launches the kernel for tensors on a CUDA device
and runs :func:`components_plain` for tensors on the CPU; there is no other
fallback.  Each launch adds one to ``fused_components.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from .stencil_fused import MAX_FAMILIES, _roll2

_THREADS = 256     # kCompThreads of the CUDA source
_MAX_BLOCKS = 4096


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


def _lib():
    lib = _build.cuda_kernels()
    if not getattr(lib, "_cp_components_declared", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.cp_components_fused.restype = i
        lib.cp_components_fused.argtypes = [ptr] * 4 + [i, i, i, i, ptr, i,
                                                        ptr]
        lib._cp_components_declared = True
    return lib


def fused_components(mask, *, shifts: Tuple, it_max: int):
    """Smallest vertex index reachable over the set edges, for every cell.

    Args:
      mask: bool [F, H, W]; ``mask[f, i, j]`` sets the edge from cell
        ``(i, j)`` to ``(i + dy_f, j + dx_f)`` (circular).
      shifts: ((dy, dx), ...) of the F shift families.
      it_max: round cap (the vertex count bounds the rounds needed).

    Returns:
      ``(labels int32 [H, W], rounds)``, ``rounds`` a 0-d int32 tensor.
    """
    if not mask.is_cuda:
        return components_plain(mask, shifts=shifts, it_max=it_max)
    f, h, w = mask.shape
    if not 1 <= f <= MAX_FAMILIES or f != len(shifts):
        raise ValueError(f"mask has {f} families for {len(shifts)} shifts; "
                         f"the kernel takes 1..{MAX_FAMILIES}")
    if mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous bool tensor, got "
                         f"{mask.dtype}")
    lib = _lib()
    lab = torch.empty((h, w), dtype=torch.int32, device=mask.device)
    flags = torch.empty(3, dtype=torch.int32, device=mask.device)
    rounds = torch.empty((), dtype=torch.int32, device=mask.device)
    max_blocks = min(-(-h * w // _THREADS), _MAX_BLOCKS)
    flat = [int(v) for dydx in shifts for v in dydx]
    shifts_c = (ctypes.c_int * len(flat))(*flat)
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cp_components_fused(
            mask.data_ptr(), lab.data_ptr(), flags.data_ptr(),
            rounds.data_ptr(), max_blocks, h, w, f, shifts_c, int(it_max),
            stream)
    if rc != 0:
        raise RuntimeError(f"components_fused launch failed (CUDA error "
                           f"{rc})")
    fused_components.launches += 1
    return lab, rounds


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
