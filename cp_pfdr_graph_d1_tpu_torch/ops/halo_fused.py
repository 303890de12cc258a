"""One quadratic PFDR edge + vertex stage on the row block of a
vertex-sharded stencil field, with its two ring exchanges: the hand-written
Hopper kernels of ``csrc/halo_fused.cu`` and their plain PyTorch versions.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.halo_fused``
(``halo_fused_iteration``).  The TPU kernel exchanges the ``hd = max |dy|``
boundary rows with its ring neighbours by remote copies from inside the
kernel.  Here the stage is cut at its two exchange points into three
steps of launches on the caller's stream, and the exchanges run between
them:

(a) the x and p = 2x - Gamma grad strips to send, then the edges with both
    ends in the block, while the strips travel on a side stream;
(b) the edges whose head lies in a neighbour's block, from the received
    strips, and the two strips of their head-side contributions;
(c) the received contributions, the vertex prox, and the block's
    ``sum (x_new - x)^2`` and ``sum x_new^2``.

:func:`halo_fused_iteration` runs the kernels for tensors on a CUDA device
and the plain versions (:func:`halo_iteration_plain`) for tensors on the
CPU, around the same exchanges; there is no other fallback.  An iteration
launches five kernels: the strips and the interior edges in (a), the
crossing edges in (b), the finish and its fixed-order sum of the per-block
partials in (c).  Each launch adds one to ``halo_fused_iteration.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from .prox import d1_pair_prox, vertex_prox_plain
from .stencil_fused import _VKIND, _check


def _pair(p, pv, x, xv, zu, zv, wdu, wdv, thd, rho):
    """d1 pair prox with relaxation of a set of edges (the TPU kernel's
    ``pair_prox``)."""
    pu_new, pv_new = d1_pair_prox(p - zu, pv - zv, wdu, wdv, thd)
    return zu + rho * (pu_new - x), zv + rho * (pv_new - xv)


def _cols(a, dx: int):
    """Column ``j`` of the result is column ``(j + dx) mod W`` of ``a``."""
    return torch.roll(a, -dx, dims=-1) if dx % a.shape[-1] else a


def _cols_back(a, dx: int):
    return torch.roll(a, dx, dims=-1) if dx % a.shape[-1] else a


def halo_strips_plain(x, grad, ga, *, hd: int):
    """Plain version of launch (a)'s first kernel: ``send`` [4, hd, W], x
    and p of the last ``hd`` rows (to the next shard), then of the first
    ``hd`` rows (to the previous one)."""
    h = x.shape[0]
    p = 2.0 * x - ga * grad
    return torch.stack([x[h - hd:], p[h - hd:], x[:hd], p[:hd]])


def halo_interior_plain(x, grad, ga, zu, zv, wu, wv, w_d1u, w_d1v, th_d1, *,
                        shifts: Tuple, rho: float):
    """Plain version of launch (a): ``(zu_new, zv_new, acc)``, the edges
    with both ends in the block written into ``zu_new``/``zv_new`` (the
    other slots keep ``zu``/``zv``) and summed into ``acc``."""
    h = x.shape[0]
    p = 2.0 * x - ga * grad
    zuo, zvo = zu.clone(), zv.clone()
    acc = torch.zeros_like(x)
    for f, (dy, dx) in enumerate(shifts):
        # u-rows [r0, r1) have their heads in the block, dy rows further on
        r0, r1 = max(0, -dy), min(h, h - dy)
        if r1 <= r0:
            continue
        zuf, zvf = _pair(p[r0:r1], _cols(p[r0 + dy:r1 + dy], dx), x[r0:r1],
                         _cols(x[r0 + dy:r1 + dy], dx), zu[f, r0:r1],
                         zv[f, r0:r1], w_d1u[f, r0:r1], w_d1v[f, r0:r1],
                         th_d1[f, r0:r1], rho)
        zuo[f, r0:r1] = zuf
        zvo[f, r0:r1] = zvf
        acc[r0:r1] += wu[f, r0:r1] * zuf
        acc[r0 + dy:r1 + dy] += _cols_back(wv[f, r0:r1] * zvf, dx)
    return zuo, zvo, acc


def halo_crossing_plain(x, grad, ga, zu, zv, wu, wv, w_d1u, w_d1v, th_d1,
                       from_prev, from_next, zuo, zvo, acc, *,
                       shifts: Tuple, hd: int, rho: float):
    """Plain version of launch (b), in place on ``zuo``, ``zvo`` and
    ``acc``: the edges whose head lies in a neighbour's block.
    ``from_prev``/``from_next`` [2, hd, W] are the x and p strips received
    from the previous and next shard.  Returns ``ctr`` [2, hd, W]: the
    head-side contributions to the next shard's first ``hd`` rows, then to
    the previous shard's last ``hd`` rows."""
    h, w = x.shape
    p = 2.0 * x - ga * grad
    ctr = x.new_zeros((2, hd, w))
    for f, (dy, dx) in enumerate(shifts):
        if dy > 0:  # u-rows [h - dy, h): heads in the next shard's rows
            r0, r1 = h - dy, h
            xv, pv = from_next[0, :dy], from_next[1, :dy]
        elif dy < 0:  # u-rows [0, -dy): heads in the previous shard's rows
            r0, r1 = 0, -dy
            xv, pv = from_prev[0, hd + dy:], from_prev[1, hd + dy:]
        else:
            continue
        zuf, zvf = _pair(p[r0:r1], _cols(pv, dx), x[r0:r1], _cols(xv, dx),
                         zu[f, r0:r1], zv[f, r0:r1], w_d1u[f, r0:r1],
                         w_d1v[f, r0:r1], th_d1[f, r0:r1], rho)
        zuo[f, r0:r1] = zuf
        zvo[f, r0:r1] = zvf
        acc[r0:r1] += wu[f, r0:r1] * zuf
        back = _cols_back(wv[f, r0:r1] * zvf, dx)
        if dy > 0:
            ctr[0, :dy] += back
        else:
            ctr[1, hd + dy:] += back
    return ctr


def halo_finish_plain(acc, ctr_a, ctr_b, x, th_l1, *, hd: int, vkind: str,
                      positivity: bool, lo: float, hi: float):
    """Plain version of launch (c): ``(x_new, num, den)`` after adding the
    received contributions ``ctr_a`` to the first ``hd`` rows and
    ``ctr_b`` to the last ``hd`` rows."""
    h = x.shape[0]
    acc = acc.clone()
    acc[:hd] += ctr_a
    acc[h - hd:] += ctr_b
    xn = vertex_prox_plain(acc, th_l1, vkind, positivity, lo, hi)
    delta = xn - x
    return xn, (delta * delta).sum(), (xn * xn).sum()


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.cuda_kernels()
    if not getattr(lib, "_cp_halo_declared", False):
        ptr, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"cp_halo_strips_{sfx}")
            fn.restype = i
            fn.argtypes = [ptr] * 4 + [i, i, i, ptr]
            fn = getattr(lib, f"cp_halo_interior_{sfx}")
            fn.restype = i
            fn.argtypes = [ptr] * 13 + [i, i, i, ptr, d, ptr]
            fn = getattr(lib, f"cp_halo_crossing_{sfx}")
            fn.restype = i
            fn.argtypes = [ptr] * 16 + [i, i, i, i, ptr, d, ptr]
            fn = getattr(lib, f"cp_halo_finish_{sfx}")
            fn.restype = i
            fn.argtypes = [ptr] * 8 + [i, i, i, i, i, d, d, ptr]
        lib.cp_halo_partials_len.restype = i
        lib.cp_halo_partials_len.argtypes = [i, i]
        lib._cp_halo_declared = True
    return lib


def _fn(name, x):
    return getattr(_lib(), f"{name}_{'f32' if x.dtype == torch.float32 else 'f64'}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise(rc, what):
    if rc != 0:
        raise RuntimeError(f"halo_fused {what} launch failed (CUDA error "
                           f"{rc})")


def _shifts_c(shifts):
    flat = [int(v) for dydx in shifts for v in dydx]
    return (ctypes.c_int * len(flat))(*flat)


def _check_strip(t, hd, x, name):
    want = (2, hd, x.shape[1])
    if (tuple(t.shape) != want or t.dtype != x.dtype or t.device != x.device
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {want} {x.dtype} "
                         f"tensor on {x.device}")


def halo_strips(x, grad, ga, *, hd: int):
    """Kernel (a), first launch: the send strips (see
    :func:`halo_strips_plain`)."""
    send = torch.empty((4, hd, x.shape[1]), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _raise(_fn("cp_halo_strips", x)(
            x.data_ptr(), grad.data_ptr(), ga.data_ptr(), send.data_ptr(),
            x.shape[0], x.shape[1], hd, _stream(x)), "strips")
    halo_fused_iteration.launches += 1
    return send


def halo_interior(x, grad, ga, zu, zv, wu, wv, w_d1u, w_d1v, th_d1, *,
                  shifts: Tuple, rho: float):
    """Kernel (a): ``(zu_new, zv_new, acc)`` of the edges with both ends in
    the block; the crossing slots of ``zu_new``/``zv_new`` are written by
    :func:`halo_crossing`."""
    zuo, zvo = torch.empty_like(zu), torch.empty_like(zv)
    acc = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _raise(_fn("cp_halo_interior", x)(
            *[a.data_ptr() for a in (x, grad, ga, zu, zv, wu, wv, w_d1u,
                                     w_d1v, th_d1, zuo, zvo, acc)],
            x.shape[0], x.shape[1], len(shifts), _shifts_c(shifts),
            float(rho), _stream(x)), "interior")
    halo_fused_iteration.launches += 1
    return zuo, zvo, acc


def halo_crossing(x, grad, ga, zu, zv, wu, wv, w_d1u, w_d1v, th_d1,
                  from_prev, from_next, zuo, zvo, acc, *, shifts: Tuple,
                  hd: int, rho: float):
    """Kernel (b), in place on ``zuo``, ``zvo`` and ``acc``; returns the
    contribution strips ``ctr`` [2, hd, W] (see
    :func:`halo_crossing_plain`)."""
    _check_strip(from_prev, hd, x, "from_prev")
    _check_strip(from_next, hd, x, "from_next")
    ctr = torch.empty((2, hd, x.shape[1]), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _raise(_fn("cp_halo_crossing", x)(
            *[a.data_ptr() for a in (x, grad, ga, zu, zv, wu, wv, w_d1u,
                                     w_d1v, th_d1, from_prev, from_next,
                                     zuo, zvo, acc, ctr)],
            x.shape[0], x.shape[1], hd, len(shifts), _shifts_c(shifts),
            float(rho), _stream(x)), "crossing")
    halo_fused_iteration.launches += 1
    return ctr


def halo_finish(acc, ctr_a, ctr_b, x, th_l1, *, hd: int, vkind: str,
                positivity: bool, lo: float, hi: float):
    """Kernel (c): ``(x_new, num, den)`` (see :func:`halo_finish_plain`);
    the two sums are reduced in a fixed order."""
    for t, name in ((ctr_a, "ctr_a"), (ctr_b, "ctr_b")):
        if (tuple(t.shape) != (hd, x.shape[1]) or t.dtype != x.dtype
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({hd}, "
                             f"{x.shape[1]}) {x.dtype} tensor")
    lib = _lib()
    h, w = x.shape
    xo = torch.empty_like(x)
    partials = torch.empty(lib.cp_halo_partials_len(h, w), dtype=x.dtype,
                           device=x.device)
    sums = torch.empty(2, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _raise(_fn("cp_halo_finish", x)(
            acc.data_ptr(), ctr_a.data_ptr(), ctr_b.data_ptr(), x.data_ptr(),
            th_l1.data_ptr(), xo.data_ptr(), partials.data_ptr(),
            sums.data_ptr(), h, w, hd, _VKIND[vkind], int(positivity),
            float(lo), float(hi), _stream(x)), "finish")
    halo_fused_iteration.launches += 2  # the finish and the partials' sum
    return xo, sums[0], sums[1]


# ---------------------------------------------------------------------------
# the iteration
# ---------------------------------------------------------------------------

_PLAIN = (halo_strips_plain, halo_interior_plain, halo_crossing_plain,
          halo_finish_plain)
_KERNELS = (halo_strips, halo_interior, halo_crossing, halo_finish)


def _iterate(stages, x, grad, ga, th_l1, zu, zv, wu, wv, w_d1u, w_d1v,
             th_d1, *, shifts, hd, rho, vkind, positivity, lo, hi, exchange):
    """The iteration's three steps around its two exchanges, with the
    kernels or their plain versions (``stages``)."""
    strips, interior, crossing, finish = stages
    if not 1 <= hd <= x.shape[0]:
        raise ValueError(f"halo depth {hd} outside 1..{x.shape[0]}")
    e_args = (x, grad, ga, zu, zv, wu, wv, w_d1u, w_d1v, th_d1)
    send = strips(x, grad, ga, hd=hd)
    ex = exchange(send[:2], send[2:])   # travels while (a) runs
    zuo, zvo, acc = interior(*e_args, shifts=shifts, rho=rho)
    from_prev, from_next = ex.wait()
    ctr = crossing(*e_args, from_prev.contiguous(), from_next.contiguous(),
                   zuo, zvo, acc, shifts=shifts, hd=hd, rho=rho)
    ctr_a, ctr_b = exchange(ctr[0], ctr[1]).wait()
    xn, num, den = finish(acc, ctr_a.contiguous(), ctr_b.contiguous(), x,
                          th_l1, hd=hd, vkind=vkind, positivity=positivity,
                          lo=lo, hi=hi)
    return xn, zuo, zvo, num, den


def halo_iteration_plain(*arrays, **kw):
    """Plain version of :func:`halo_fused_iteration` (same arguments and
    results), on any device: the same three steps around the same
    exchanges."""
    return _iterate(_PLAIN, *arrays, **kw)


def halo_fused_iteration(x, grad, ga, th_l1, zu, zv, wu, wv, w_d1u, w_d1v,
                         th_d1, *, shifts: Tuple, hd: int, rho: float,
                         vkind: str, positivity: bool, lo: float, hi: float,
                         exchange):
    """One edge+vertex PFDR step on a LOCAL [H_loc, W] row block.

    Args mirror :func:`.stencil_fused.fused_stencil_iteration`, on local
    blocks; ``hd`` is the halo depth (``max |dy|``, 1 <= hd <= H_loc).
    ``exchange(to_next, to_prev)`` starts one exchange on the ring and
    returns an object whose ``wait()`` gives ``(from_prev, from_next)``
    (:class:`..parallel.mesh.RingExchange` bound to a mesh, or a scripted
    stand-in in checks).

    Returns ``(x_new, zu_new, zv_new, num_local, den_local)``: the
    stopping-test sums are this block's; the caller sums them over the
    ring.  CPU tensors run :func:`halo_iteration_plain`.
    """
    arrays = (x, grad, ga, th_l1, zu, zv, wu, wv, w_d1u, w_d1v, th_d1)
    kw = dict(shifts=shifts, hd=hd, rho=rho, vkind=vkind,
              positivity=positivity, lo=lo, hi=hi, exchange=exchange)
    if not x.is_cuda:
        return halo_iteration_plain(*arrays, **kw)
    _check(arrays, shifts, vkind)
    return _iterate(_KERNELS, *arrays, **kw)


halo_fused_iteration.launches = 0


class ScriptedExchange:
    """Stand-in for a ring exchange in checks without processes: returns
    the given ``(from_prev, from_next)`` pairs in turn and keeps what was
    sent (``sent``).  With ``cycle`` it starts over after the last pair,
    forever, and keeps nothing (to time iterations on one block alone)."""

    def __init__(self, replies, cycle: bool = False):
        self.replies = list(replies)
        self.cycle = cycle
        self.sent = []
        self.k = 0

    def __call__(self, to_next, to_prev):
        if not self.cycle:
            self.sent.append((to_next.clone(), to_prev.clone()))
        reply = self.replies[self.k % len(self.replies)]
        self.k += 1
        if not self.cycle and self.k > len(self.replies):
            raise IndexError("ScriptedExchange: no reply left")
        return _Done(reply)


class _Done:
    def __init__(self, reply):
        self.reply = reply

    def wait(self):
        return self.reply


def ring_iteration_plain(x, grad, ga, th_l1, zu, zv, wu, wv, w_d1u, w_d1v,
                         th_d1, *, num_shards: int, shifts: Tuple, rho: float,
                         vkind: str, positivity: bool, lo: float, hi: float):
    """The plain halo iteration of every row block of a WHOLE [H, W] field
    (edge fields [F, H, W]), the ``num_shards`` ranks run in turn in one
    process with the ring exchanges done by hand.  Returns per block
    ``(outputs, replies)``: the iteration's five results, and the two
    ``(from_prev, from_next)`` pairs the block received, which feed a
    :class:`ScriptedExchange` when one block's kernels are checked alone."""
    h = x.shape[0]
    p_n = num_shards
    if h % p_n:
        raise ValueError(f"H={h} not divisible by {p_n} shards")
    hb = h // p_n
    hd = max(abs(dy) for dy, _ in shifts)
    blk = [[a[..., b * hb:(b + 1) * hb, :] for a in (x, grad, ga, th_l1, zu,
                                                       zv, wu, wv, w_d1u,
                                                       w_d1v, th_d1)]
           for b in range(p_n)]
    sends = [halo_strips_plain(*bl[:3], hd=hd) for bl in blk]
    a_out = [halo_interior_plain(*(bl[:3] + bl[4:]), shifts=shifts, rho=rho)
             for bl in blk]
    round1 = [(sends[(b - 1) % p_n][:2], sends[(b + 1) % p_n][2:])
              for b in range(p_n)]
    ctrs = [halo_crossing_plain(*(blk[b][:3] + blk[b][4:]), *round1[b],
                                *a_out[b], shifts=shifts, hd=hd, rho=rho)
            for b in range(p_n)]
    round2 = [(ctrs[(b - 1) % p_n][0], ctrs[(b + 1) % p_n][1])
              for b in range(p_n)]
    out = []
    for b in range(p_n):
        zuo, zvo, acc = a_out[b]
        xn, num, den = halo_finish_plain(
            acc, *round2[b], blk[b][0], blk[b][3], hd=hd, vkind=vkind,
            positivity=positivity, lo=lo, hi=hi)
        out.append(((xn, zuo, zvo, num, den), [round1[b], round2[b]]))
    return out

