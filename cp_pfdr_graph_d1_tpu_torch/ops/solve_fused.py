"""Whole PFDR solve of a reduced problem of any size in one launch: the
hand-written Hopper kernel ``csrc/solve_fused.cu`` and its plain PyTorch
version.

Counterpart of ``cp_pfdr_graph_d1_tpu.ops.solve_fused``
(``fused_pfdr_solve``).  It takes the reduced problems that
:mod:`.solve_small` cannot hold in one block's shared memory
(:func:`.solve_small.fits`).  The TPU kernel reached edges through the
banded-tile layout of ``ops/banded.BandedPlan`` (``[nt T8, 128]`` edge
tiles, one-hot selector products, ``wd8`` vertex windows), a workaround for
the TPU's lack of a vector gather; this kernel takes flat vertex and edge
rows and indexed endpoints instead, with the arguments of
:func:`.solve_small.fused_pfdr_solve_small` plus the resume count ``it0``.
Callers pass the edges sorted stably by their smaller endpoint, the order
of the TPU kernel's banded plan (``ops/banded.py:103``): each block's own
edges are then contiguous.

The kernel runs one block per SM, each owning a contiguous slice of the
vertices (:func:`partition`); the launch's index arrays, its shared-memory
layout and its scratch form a plan (:func:`make_plan`), built on every
call.

:func:`fused_pfdr_solve` launches the kernel for tensors on a CUDA device
and runs :func:`solve_fused_plain` for tensors on the CPU; there is no other
fallback.  Each launch adds one to ``fused_pfdr_solve.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import banded
from .banded import _raw_stream
from .solve_small import (_OP_KIND, _VKIND, MAX_SMEM_BYTES, _check,
                          solve_small_plain)

# threads of a block and the longest row one thread sums (kSolveThreads and
# kHubRow of the CUDA source); a row of more slots gets a warp
THREADS = 512
HUB_ROW = 32
# fewest vertices a block owns on average: a small problem takes fewer
# blocks than the card has SMs
MIN_BLOCK_VERTICES = 32


def solve_fused_plain(op_kind: str, op, aty, ga, th_l1, x0, z0, ec, eu, ev,
                      *, rv: int, it_max: int, rho: float, vkind: str,
                      positivity: bool, lo: float, hi: float,
                      dif_tol2: float, eps: float, it0: int = 0):
    """Plain PyTorch version of the kernel (same arguments and results as
    :func:`fused_pfdr_solve`): the reduced PFDR iteration of
    :func:`.solve_small.solve_small_plain`, resumed at iteration ``it0``."""
    x, z, it, dif = solve_small_plain(
        op_kind, op, aty, ga, th_l1, x0, z0, ec, eu, ev, rv=rv,
        it_max=it_max - it0, rho=rho, vkind=vkind, positivity=positivity,
        lo=lo, hi=hi, dif_tol2=dif_tol2, eps=eps)
    return x, z, it + it0, dif


def grid_size(rv_cap: int, sms: int) -> int:
    """Blocks of a launch: one per SM, fewer for a problem of less than
    ``MIN_BLOCK_VERTICES`` vertices a block."""
    return max(1, min(sms, rv_cap // MIN_BLOCK_VERTICES))


def partition(offsets, grid: int, n_rows: int):
    """``vstart`` (int64 [grid + 1], on the device of ``offsets``): block
    ``b`` owns the vertices ``[vstart[b], vstart[b + 1])``.  Contiguous
    ranges of about equal cost, a vertex costing its slot count (its pair
    proxes) plus 1 + n_rows / 16 (its vertex prox and its column of the
    dense operator's two products)."""
    off = torch.as_tensor(offsets, dtype=torch.int64)
    deg = torch.diff(off)
    cost = torch.cumsum(deg + 1 + n_rows // 16, 0).double()
    total = cost[-1:] if cost.numel() else cost.new_zeros(1)
    at = torch.arange(1, grid, dtype=torch.float64, device=off.device)
    cuts = torch.searchsorted(cost, at * total / grid, right=True)
    ends = torch.tensor([0, deg.numel()], device=off.device)
    return torch.cat([ends[:1], cuts, ends[1:]])


def build_index(eu, ev, rv_cap: int, grid: int, n_rows: int):
    """Index arrays of a launch, built on the device of ``eu`` (tensors or
    arrays): ``(index, nb_max, slots)``, with ``nb_max`` and ``slots`` the
    most vertices and incidence slots a block owns (read back to the host
    with the endpoints' range, one synchronisation).  ``index`` holds, as
    int64 tensors (``inc_slot`` int32, as the kernel reads it):

    * ``vstart`` [grid + 1]: :func:`partition`;
    * ``inc_off`` [rv_cap + 1] and ``inc_slot`` [2E]: the incidence list of
      :func:`..graph.incidence_csr` (slot ``s < E`` is edge ``s``'s u-end,
      ``E + s`` its v-end), the sign bit set on the one slot of each edge
      that writes its new pair: the end at its smaller endpoint (the u-end
      of a self-loop), so each edge's owner is the block of that endpoint;
    * ``inc_other`` [2E]: the slot's other endpoint; ``inc_self`` [2E]: its
      own endpoint's index inside its block;
    * ``hubs`` and ``hub_off`` [grid + 1]: the vertices of more than
      :data:`HUB_ROW` slots, block ``b``'s at ``hubs[hub_off[b]:hub_off[b +
      1]]``, each summed by a warp."""
    eu = torch.as_tensor(eu).to(torch.int64)
    ev = torch.as_tensor(ev).to(device=eu.device, dtype=torch.int64)
    dev, ne = eu.device, eu.numel()
    me, slot = torch.sort(torch.cat([eu, ev]), stable=True)
    off = torch.searchsorted(me, torch.arange(rv_cap + 1, device=dev))
    e = slot % ne
    at_v = slot >= ne
    other = torch.where(at_v, eu[e], ev[e])
    writer = torch.where(at_v, ev[e] < eu[e], eu[e] <= ev[e])
    vstart = partition(off, grid, n_rows)
    block = torch.searchsorted(vstart, me, right=True) - 1
    is_hub = torch.diff(off) > HUB_ROW
    hub_cum = torch.cat([off.new_zeros(1), torch.cumsum(is_hub, 0)])
    hub_order = torch.sort((~is_hub).to(torch.uint8), stable=True).indices
    lo, hi, n_hubs, nb_max, slots = torch.stack([
        me[0], me[-1], hub_cum[-1], torch.diff(vstart).max(),
        torch.diff(off[vstart]).max()]).tolist()
    if lo < 0 or hi >= rv_cap:
        raise ValueError(f"edge endpoints span [{lo}, {hi}], outside the "
                         f"{rv_cap} vertices")
    # the sign bit of an int32 as the kernel reads it: slot | 1 << 31
    code = (slot - (writer.to(torch.int64) << 31)).to(torch.int32)
    index = dict(vstart=vstart, hub_off=hub_cum[vstart],
                 hubs=hub_order[:n_hubs], inc_off=off, inc_slot=code,
                 inc_other=other, inc_self=me - vstart[block])
    return index, nb_max, slots


_INDEX_ORDER = ("vstart", "hub_off", "hubs", "inc_off", "inc_slot",
                "inc_other", "inc_self")


def smem_bytes(itemsize: int, n_rows: int, nb_max: int, xs_in_smem: bool,
               op_in_smem: bool, slot_cap: int) -> int:
    """Dynamic shared memory of a block (``solve_smem_bytes`` of the CUDA
    source): the row sums and the reduction scratch, the block's iterate
    and forward values (``xs_in_smem``), the dense operator's slice
    (``op_in_smem``) and the slot contributions (``slot_cap``, 0 when they
    stay in global scratch)."""
    n = n_rows + 2 + 64 + slot_cap
    if xs_in_smem:
        n += 2 * nb_max
    if op_in_smem:
        n += n_rows * nb_max
    return itemsize * n


def layout(op_kind: str, n_rows: int, itemsize: int, nb_max: int,
           slots: int):
    """``(xs_in_smem, op_in_smem, slot_cap)`` of a launch whose blocks own
    at most ``nb_max`` vertices and ``slots`` incidence slots: the block's
    iterate and forward values in shared memory when they fit there, then
    the dense operator's slice when it fits beside them, then the slot
    contributions (``slot_cap`` 0: in global scratch).  What does not fit
    is read from global memory, so any size launches, unless the row sums
    alone (a dense operator of some 28,000 rows) exceed a block's shared
    memory: that raises a ``ValueError``."""
    n_rows = n_rows if op_kind == "dense" else 0

    def fits(*parts):
        return smem_bytes(itemsize, n_rows, nb_max, *parts) <= MAX_SMEM_BYTES

    if not fits(False, False, 0):
        raise ValueError(
            f"solve_fused: the {n_rows + 2} row sums need "
            f"{smem_bytes(itemsize, n_rows, nb_max, False, False, 0)} bytes "
            f"of shared memory, more than a block's {MAX_SMEM_BYTES}")
    xs_in = fits(True, False, 0)
    op_in = op_kind == "dense" and xs_in and fits(True, True, 0)
    slot_cap = slots if fits(xs_in, op_in, slots) else 0
    return xs_in, op_in, slot_cap


@dataclass
class Plan:
    """A launch's index arrays (``index``, packed on the device in
    :data:`_INDEX_ORDER`), its layout (:func:`layout`) and its scratch
    (x and z second buffers, p, the partials, the slot contributions)."""
    index: dict
    packed: torch.Tensor
    grid: int
    nb_max: int
    xs_in_smem: bool
    op_in_smem: bool
    slot_cap: int
    scratch: torch.Tensor


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def make_plan(op_kind: str, eu, ev, rv_cap: int, n_rows: int, dtype,
              sms: int | None = None) -> Plan:
    """The plan of a launch on the edge list ``eu``/``ev`` (tensors, on the
    device the plan's tensors go to), built there.  ``sms``: the SMs to plan for
    (default: the device's; a CPU plan needs it)."""
    if sms is None:
        sms = _sm_count(eu.device.index)
    grid = grid_size(rv_cap, sms)
    ne = eu.shape[0]
    index, nb_max, slots = build_index(eu, ev, rv_cap, grid, n_rows
                                       if op_kind == "dense" else 0)
    itemsize = torch.finfo(dtype).bits // 8
    xs_in, op_in, slot_cap = layout(op_kind, n_rows, itemsize, nb_max, slots)
    packed = torch.cat([index[k].to(torch.int32) for k in _INDEX_ORDER])
    rows = (n_rows if op_kind == "dense" else 0) + 2
    scratch = torch.empty(2 * rv_cap + 4 * ne + rows * grid, dtype=dtype,
                          device=eu.device)
    return Plan(index, packed, grid, nb_max, xs_in, op_in, slot_cap, scratch)


@functools.cache
def _lib():
    """The kernels' library (:func:`.banded._lib`) with the entries
    declared and the constants mirrored here checked against the CUDA
    source."""
    lib = banded._lib()
    ptr = ctypes.c_void_p
    for name in ("cp_solve_fused_f32", "cp_solve_fused_f64"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr] * 16
    lib.cp_solve_fused_smem_bytes.restype = ctypes.c_size_t
    lib.cp_solve_fused_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.cp_solve_fused_shape.restype = None
    lib.cp_solve_fused_shape.argtypes = [ptr]
    shape = (ctypes.c_int * 2)()
    lib.cp_solve_fused_shape(shape)
    if (tuple(shape) != (THREADS, HUB_ROW)
            or any(lib.cp_solve_fused_smem_bytes(8, 91, 150, xs, op, 900)
                   != smem_bytes(8, 91, 150, bool(xs), bool(op), 900)
                   for xs, op in ((1, 1), (0, 0)))):
        raise RuntimeError("ops/solve_fused.py disagrees with "
                           "csrc/solve_fused.cu")
    return lib


def fused_pfdr_solve(op_kind: str, op, aty, ga, th_l1, x0, z0, ec, eu, ev,
                     *, rv: int, it_max: int, rho: float, vkind: str,
                     positivity: bool, lo: float, hi: float,
                     dif_tol2: float, eps: float, it0: int = 0):
    """Complete reduced PFDR solve, resumable.

    Args: as :func:`.solve_small.fused_pfdr_solve_small`, with no size
      limit, plus ``it0``: iterations already done (a resumed solve passes
      the state it stopped at as ``x0``/``z0`` and runs up to ``it_max``
      in all).  The evolution test starts afresh, as in the JAX package.

    Returns:
      ``(x [rv_cap], z [2, E], it, dif)`` with ``it`` (``it0`` included) an
      int32 and ``dif`` a 0-d tensor on the inputs' device.
    """
    kw = dict(rv=rv, it_max=it_max, rho=rho, vkind=vkind,
              positivity=positivity, lo=lo, hi=hi, dif_tol2=dif_tol2,
              eps=eps)
    if not x0.is_cuda:
        return solve_fused_plain(op_kind, op, aty, ga, th_l1, x0, z0, ec,
                                 eu, ev, it0=it0, **kw)
    _check(op_kind, op, (x0, aty, ga, th_l1), z0, ec, eu, ev, rv,
           size_limit=False)
    if vkind not in _VKIND:
        raise ValueError(f"unknown vertex prox {vkind!r}")
    lib = _lib()
    rv_cap, ne = x0.shape[0], eu.shape[0]
    n_rows = op.shape[0] if op_kind == "dense" else 0
    plan = make_plan(op_kind, eu, ev, rv_cap, n_rows, x0.dtype)
    dims = (ctypes.c_int * 16)(
        _OP_KIND[op_kind], n_rows, rv_cap, ne, int(rv),
        int(it_max) - int(it0), _VKIND[vkind], int(positivity), plan.grid,
        plan.nb_max, len(plan.index["hubs"]), int(plan.op_in_smem),
        int(plan.slot_cap > 0), plan.slot_cap, x0.device.index,
        int(plan.xs_in_smem))
    consts = (ctypes.c_double * 5)(float(rho), float(lo), float(hi),
                                   float(dif_tol2), float(eps))
    xo = torch.empty_like(x0)
    zo = torch.empty_like(z0)
    it = torch.empty((), dtype=torch.int32, device=x0.device)
    dif = torch.empty((), dtype=x0.dtype, device=x0.device)
    fn = (lib.cp_solve_fused_f32 if x0.dtype == torch.float32
          else lib.cp_solve_fused_f64)
    rc = fn(op.data_ptr(), aty.data_ptr(), ga.data_ptr(), th_l1.data_ptr(),
            x0.data_ptr(), z0.data_ptr(), ec.data_ptr(),
            plan.packed.data_ptr(), ctypes.addressof(dims),
            ctypes.addressof(consts), xo.data_ptr(), zo.data_ptr(),
            plan.scratch.data_ptr(), it.data_ptr(), dif.data_ptr(),
            _raw_stream(x0.device.index))
    if rc != 0:
        raise RuntimeError(f"solve_fused launch failed (CUDA error {rc})")
    fused_pfdr_solve.launches += 1
    return xo, zo, it + int(it0), dif


fused_pfdr_solve.launches = 0
