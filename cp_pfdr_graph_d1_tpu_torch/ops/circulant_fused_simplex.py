"""One multi-label PFDR iteration over offset families plus a remainder, on
K label planes: the hand-written Hopper kernel
``csrc/circulant_fused_simplex.cu`` and its plain PyTorch version.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.circulant_fused_simplex``
(``fused_circulant_simplex_iteration``): loss gradient, forward step,
per-(slot, label) d1 prox with relaxation, weighted average, Michelot
simplex projection in the metric and the stopping sum, in one launch.  The
planes are ``[K, V]`` for vertex fields and ``[K, E]`` for edge fields over
the container's edge order (the transposes of the solver's ``[V, K]`` and
``[E, K]`` rows), where the TPU kernel holds ``[F, K, VV8, 128]`` blocks.
As in the TPU kernel, the CUDA kernel derives ``w_d1v = 1 - w_d1u`` and
``wv`` from ``wu``, ``w_d1u`` and the endpoints' Gamma (the identity the
preconditioner satisfies up to rounding); the plain version reads them.

:func:`fused_circulant_simplex_iteration` launches the CUDA kernel for
tensors on a CUDA device and runs :func:`circulant_simplex_plain` for
tensors on the CPU; there is no other fallback.  Each launch adds one to
``fused_circulant_simplex_iteration.launches``.  As in
:mod:`.circulant_fused`, the z values of virtual slots are path-dependent
and never consumed.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .circulant_fused import remainder_index
from .stencil_fused_simplex import simplex_forward_plain, simplex_tail_plain

# must equal kMaxSimplexLabels in csrc/circulant_fused_simplex.cu
MAX_LABELS = 32

_FIELDS = ("p", "q", "la_f", "ga", "ga_proj", "prev", "zu", "zv", "wu", "wv",
           "w_d1u", "w_d1v", "th_d1")
# the planes the kernel reads: wv and w_d1v follow from the others
_KERNEL_FIELDS = tuple(i for i, n in enumerate(_FIELDS)
                       if n not in ("wv", "w_d1v"))


def circulant_simplex_plain(graph, p, q, la_f, ga, ga_proj, prev, zu, zv,
                            wu, wv, w_d1u, w_d1v, th_d1, *, rho: float,
                            al: float, has_laf: bool, label_mode: bool):
    """Plain PyTorch version of the kernel (same arguments and results as
    :func:`fused_circulant_simplex_iteration`): the staged iteration on the
    planes, endpoint gathers by ``eu``/``ev`` and the sum over the
    incidence table of the real edges."""
    eu, ev = graph.eu, graph.ev
    fp = simplex_forward_plain(p, q, la_f, ga, al=al, has_laf=has_laf)
    au = fp[:, eu] - zu
    av = fp[:, ev] - zv
    avg = w_d1u * au + w_d1v * av
    diff = au - av
    shrunk = torch.sign(diff) * torch.clamp(diff.abs() - th_d1, min=0)
    zu_new = zu + rho * ((avg + w_d1v * shrunk) - p[:, eu])
    zv_new = zv + rho * ((avg - w_d1u * shrunk) - p[:, ev])
    acc = graph.edge_to_vertex_sum((wu * zu_new).T, (wv * zv_new).T).T
    pn, prev_new, dif = simplex_tail_plain(acc.contiguous(), ga_proj, prev,
                                           label_mode=label_mode)
    return pn, prev_new, zu_new, zv_new, dif


def _lib():
    lib = _build.cuda_kernels()
    if not getattr(lib, "_cp_circ_simplex_declared", False):
        ptr, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for name in ("cp_circulant_simplex_f32", "cp_circulant_simplex_f64"):
            fn = getattr(lib, name)
            fn.restype = i
            fn.argtypes = ([ptr] * 17 + [i] + [ptr] * 8
                           + [i, i, i, i, i, d, d, i, i, ptr])
        lib.cp_circulant_simplex_partials_len.restype = i
        lib.cp_circulant_simplex_partials_len.argtypes = [i, i]
        lib.cp_circulant_simplex_max_labels.restype = i
        lib.cp_circulant_simplex_max_labels.argtypes = []
        if lib.cp_circulant_simplex_max_labels() != MAX_LABELS:
            raise RuntimeError("MAX_LABELS disagrees with the CUDA source")
        lib._cp_circ_simplex_declared = True
    return lib


def _check(arrays, nv: int, ne: int, label_mode: bool):
    p = arrays[0]
    if p.ndim != 2:
        raise ValueError(f"p must be [K, V], got {tuple(p.shape)}")
    k = p.shape[0]
    if not 1 <= k <= MAX_LABELS:
        raise ValueError(f"{k} labels; the circulant_fused_simplex kernel "
                         f"takes 1..{MAX_LABELS}")
    if p.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, not {p.dtype}")
    shapes = {"la_f": (1, nv), "prev": (1 if label_mode else k, nv)}
    for name, a in zip(_FIELDS, arrays):
        want = shapes.get(name, (k, nv) if name in _FIELDS[:6] else (k, ne))
        if tuple(a.shape) != want:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                             f"{want}")
        if a.dtype != p.dtype or a.device != p.device:
            raise ValueError(f"{name} is {a.dtype} on {a.device}; expected "
                             f"{p.dtype} on {p.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def fused_circulant_simplex_iteration(graph, p, q, la_f, ga, ga_proj, prev,
                                      zu, zv, wu, wv, w_d1u, w_d1v, th_d1, *,
                                      rho: float, al: float, has_laf: bool,
                                      label_mode: bool):
    """One fused multi-label PFDR step on a
    :class:`..circulant.CirculantGraphD1`.

    Args:
      graph: the container (offsets, padded vertex count, remainder).
      p, q, ga, ga_proj: [K, V] label planes.
      la_f: [1, V] per-vertex loss weights (ignored unless has_laf).
      prev: [K, V] previous iterate, or [1, V] previous maximum-likelihood
        labels (label_mode).
      zu, zv, wu, wv, w_d1u, w_d1v, th_d1: [K, E] edge planes in the
        container's edge order.
      rho: relaxation parameter; al: loss selector (0 linear, 1 quadratic,
        in ]0, 1[ smoothed KL).

    Returns:
      ``(p_new, prev_new, zu_new, zv_new, dif_sum)``; ``dif_sum`` (0-d) is
      the changed-label count (label_mode) or ``sum |p_new - prev|``.
    """
    arrays = (p, q, la_f, ga, ga_proj, prev, zu, zv, wu, wv, w_d1u, w_d1v,
              th_d1)
    kw = dict(rho=rho, al=al, has_laf=has_laf, label_mode=label_mode)
    if not p.is_cuda:
        return circulant_simplex_plain(graph, *arrays, **kw)
    nv, ne = graph.num_vertices, graph.num_edges
    _check(arrays, nv, ne, label_mode)
    if graph.offsets_dev.device != p.device:
        raise ValueError(f"planes on {p.device}, the graph on "
                         f"{graph.offsets_dev.device}")
    lib = _lib()
    k = p.shape[0]
    vv, nf = graph.vv, len(graph.offsets)
    po = torch.empty_like(p)
    prevo = torch.empty_like(prev)
    zuo = torch.empty_like(zu)
    zvo = torch.empty_like(zv)
    rem, ner, n_long = remainder_index(graph)
    partials = p.new_empty(lib.cp_circulant_simplex_partials_len(vv, nf))
    dif = p.new_empty(())
    # remainder-row sums of the vertices of long remainder rows
    acc_part = p.new_empty((k, nv)) if n_long else None
    fp = p.new_empty((k, vv))  # forward values
    fn = (lib.cp_circulant_simplex_f32 if p.dtype == torch.float32
          else lib.cp_circulant_simplex_f64)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*[arrays[i].data_ptr() for i in _KERNEL_FIELDS],
                graph.offsets_dev.data_ptr(), *rem, n_long,
                po.data_ptr(), prevo.data_ptr(), zuo.data_ptr(),
                zvo.data_ptr(), acc_part.data_ptr() if n_long else 0,
                fp.data_ptr(), partials.data_ptr(), dif.data_ptr(), nv, vv,
                nf, ner, k, float(rho), float(al), int(has_laf),
                int(label_mode), stream)
    if rc != 0:
        raise RuntimeError(f"circulant_fused_simplex launch failed (CUDA "
                           f"error {rc})")
    fused_circulant_simplex_iteration.launches += 1
    return po, prevo, zuo, zvo, dif


fused_circulant_simplex_iteration.launches = 0
