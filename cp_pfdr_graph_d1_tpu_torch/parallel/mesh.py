"""Process groups and collectives of the port's distributed solvers
(counterpart of ``cp_pfdr_graph_d1_tpu.parallel.mesh``).

The JAX package runs one SPMD program over a device mesh (``shard_map``,
``psum``, ``ppermute``).  The port runs the per-shard body in each rank of a
``torch.distributed`` process group instead, one rank per shard:

* ``psum`` -> :func:`all_sum` (an all-gather of the P partials, added in
  rank order: every rank gets the same bits, whatever algorithm the backend
  uses, so a solve's iteration count does not depend on it);
* ``ppermute`` on the ring -> :func:`ring_exchange` (``batch_isend_irecv``
  to the ranks ``(r +- 1) % P``; at P = 1 a local copy, as ``ppermute`` over
  ``[(0, 0)]`` is);
* ``process_allgather`` -> :func:`all_gather`.

Backends (:func:`initialize_distributed`): gloo for CPU tensors, NCCL for
CUDA tensors with one rank per card, and gloo for ranks that share a card
(NCCL refuses two ranks on one device).  gloo's point-to-point calls take
CPU tensors only, so under gloo the CUDA strips and partials go through
pinned host buffers (:attr:`Mesh.staged`); the kernels still run on the
card in every rank.

A :class:`Mesh` stands for the JAX ``Mesh`` argument of the entry points:
the group (default: the world), its size and this rank's place in it.
Each rank passes the whole host problem and takes its own block of it
(:func:`put_sharded`, as the JAX ``put_sharded`` uploads each process's
addressable shards).
"""
from __future__ import annotations

import os
import socket
import tempfile
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """A ring of ranks: a process group (``None``: the world), its size
    and this rank's index in it.  ``axis`` keeps the JAX mesh axis name."""

    def __init__(self, group=None, axis: str = "dp"):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: call "
                               "initialize_distributed first")
        self.group = group
        self.axis = axis
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self._side_streams = {}

    def global_rank(self, r: int) -> int:
        """World rank of the group's rank ``r``."""
        r %= self.size
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def side_stream(self, device):
        """The stream of ``device`` on which this mesh's strips travel."""
        s = self._side_streams.get(device)
        if s is None:
            s = self._side_streams[device] = torch.cuda.Stream(device=device)
        return s

    def staged(self, t) -> bool:
        """Whether the collectives stage ``t`` through host memory (a CUDA
        tensor under gloo)."""
        return t.is_cuda and self.backend == "gloo"

    def __repr__(self):
        return (f"Mesh({self.axis}: rank {self.rank} of {self.size}, "
                f"{self.backend})")


def _backend_for(device: str, num_processes: int) -> str:
    """gloo for CPU tensors and for ranks that share a card, else NCCL."""
    if device == "cpu":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def initialize_distributed(coordinator_address: str, num_processes: int,
                           process_id: int, device: str = "cuda") -> str:
    """Joins this process to the world group as rank ``process_id`` of
    ``num_processes``, rendezvous at ``coordinator_address``
    (``"host:port"``; nothing in the environment names it).  The backend
    follows ``device``: gloo for ``"cpu"``; for ``"cuda"`` NCCL when every
    rank of the host has a card of its own (the rank's card is then
    ``LOCAL_RANK`` or ``process_id`` modulo the cards), gloo when ranks
    share a card.  Returns the backend's name."""
    backend = _backend_for(device, num_processes)
    if device != "cpu":
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return backend


def make_mesh(num_devices: int | None = None, axis: str = "dp") -> Mesh:
    """1-D mesh over the first ``num_devices`` ranks of the world (all of
    them by default).  Every rank calls it; a rank outside the first
    ``num_devices`` gets ``None``."""
    world = dist.get_world_size()
    if num_devices is None or num_devices == world:
        return Mesh(None, axis)
    if num_devices > world:
        raise ValueError(f"requested {num_devices} ranks, have {world}")
    group = dist.new_group(list(range(num_devices)))
    return Mesh(group, axis) if dist.get_rank() < num_devices else None


class HybridMesh(NamedTuple):
    """The ``(host, device)`` mesh of the JAX package as two groups of this
    rank: ``host`` crosses hosts (one rank of each), ``local`` stays on
    this host."""
    host: Mesh
    local: Mesh


def make_hybrid_mesh(axis: str = "dp", host_axis: str = "host",
                     local_size: int | None = None):
    """``(host, local)`` subgroups of the world: ``local`` the
    ``local_size`` consecutive ranks of this host (``LOCAL_WORLD_SIZE`` by
    default), ``host`` the ranks that hold the same local index on every
    host.  On a single host it is the 1-D mesh of :func:`make_mesh`, as in
    the JAX package."""
    world = dist.get_world_size()
    if local_size is None:
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local_size:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"{local_size}")
    nhost = world // local_size
    if nhost == 1:
        return make_mesh(axis=axis)
    me = dist.get_rank()
    local = host = None
    # every rank creates every group, in the same order
    for h in range(nhost):
        g = dist.new_group(list(range(h * local_size, (h + 1) * local_size)))
        if me // local_size == h:
            local = g
    for i in range(local_size):
        g = dist.new_group(list(range(i, world, local_size)))
        if me % local_size == i:
            host = g
    return HybridMesh(Mesh(host, host_axis), Mesh(local, axis))


def put_sharded(x, mesh: Mesh, device="cuda"):
    """This rank's block of a host array (or tensor) stacked along its
    leading axis ``[P, ...]``, on ``device``."""
    if isinstance(x, torch.Tensor):
        return x[mesh.rank].to(device)
    return torch.as_tensor(np.asarray(x[mesh.rank]), device=device)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _pinned_like(t):
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def all_gather(mesh: Mesh, t):
    """``[P, *t.shape]``: every rank's ``t`` in rank order, on ``t``'s
    device."""
    t = t.contiguous()
    src = t.cpu() if mesh.staged(t) else t
    if mesh.backend == "nccl":
        out = torch.empty((mesh.size,) + tuple(src.shape), dtype=src.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(out, src, group=mesh.group)
    else:
        parts = [torch.empty_like(src) for _ in range(mesh.size)]
        dist.all_gather(parts, src, group=mesh.group)
        out = torch.stack(parts)
    return out.to(t.device)


def all_sum(mesh: Mesh, t):
    """``psum``: the sum over the ranks of ``t``, added in rank order from
    an all-gather, so that every rank holds the same bits."""
    g = all_gather(mesh, t)
    acc = g[0]
    for r in range(1, mesh.size):
        acc = acc + g[r]
    return acc


def all_gather_object(mesh: Mesh, obj):
    """Every rank's picklable ``obj``, in rank order."""
    if mesh.size == 1:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


class RingExchange:
    """One exchange on the ring under way: ``to_next`` goes to rank
    ``r + 1``, ``to_prev`` to rank ``r - 1``.  :meth:`wait` returns
    ``(from_prev, from_next)``: what rank ``r - 1`` sent forward and what
    rank ``r + 1`` sent back.

    Started on a CUDA tensor, the sends wait for the work already queued
    on the current stream and run on a side stream, so the caller can
    queue more work on its stream before :meth:`wait`; after :meth:`wait`
    the current stream is ordered after the received strips.  Under gloo
    the strips are copied to pinned host buffers on the side stream and
    exchanged by the host in :meth:`wait`."""

    def __init__(self, mesh: Mesh, to_next, to_prev):
        self.mesh = mesh
        self.device = to_next.device
        to_next, to_prev = to_next.contiguous(), to_prev.contiguous()
        self._works = None
        self._host = None
        if mesh.size == 1:  # self ring: a local copy
            self._out = (to_next.clone(), to_prev.clone())
            return
        if not to_next.is_cuda:
            self._out = (torch.empty_like(to_next), torch.empty_like(to_prev))
            self._works = self._post(to_next, to_prev, *self._out)
            return
        side = self.mesh.side_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        for t in (to_next, to_prev):
            t.record_stream(side)
        with torch.cuda.stream(side):
            if mesh.staged(to_next):
                self._host = (_pinned_like(to_next), _pinned_like(to_prev))
                self._host[0].copy_(to_next, non_blocking=True)
                self._host[1].copy_(to_prev, non_blocking=True)
                self._event = side.record_event()
            else:
                self._out = (torch.empty_like(to_next),
                             torch.empty_like(to_prev))
                self._works = self._post(to_next, to_prev, *self._out)

    def _post(self, to_next, to_prev, from_prev, from_next):
        m = self.mesh
        nxt, prv = m.global_rank(m.rank + 1), m.global_rank(m.rank - 1)
        # at P = 2 next and prev are one rank: the two pairs match by the
        # order of the operations, the same on both ranks
        ops = [dist.P2POp(dist.isend, to_next, nxt, m.group),
               dist.P2POp(dist.irecv, from_prev, prv, m.group),
               dist.P2POp(dist.isend, to_prev, prv, m.group),
               dist.P2POp(dist.irecv, from_next, nxt, m.group)]
        return dist.batch_isend_irecv(ops)

    def wait(self):
        if self._host is not None:  # gloo: exchange the host copies
            self._event.synchronize()
            recv = (_pinned_like(self._host[0]), _pinned_like(self._host[1]))
            for w in self._post(*self._host, *recv):
                w.wait()
            side = self.mesh.side_stream(self.device)
            with torch.cuda.stream(side):
                self._out = tuple(r.to(self.device, non_blocking=True)
                                  for r in recv)
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(side)
            for t in self._out:
                t.record_stream(cur)
            self._host = None
        elif self._works is not None:
            for w in self._works:
                w.wait()
            if self.device.type == "cuda":
                cur = torch.cuda.current_stream(self.device)
                cur.wait_stream(self.mesh.side_stream(self.device))
                for t in self._out:
                    t.record_stream(cur)
            self._works = None
        return self._out


def ring_exchange(mesh: Mesh, to_next, to_prev):
    """``(from_prev, from_next)`` of one exchange on the ring (blocking
    form of :class:`RingExchange`)."""
    return RingExchange(mesh, to_next, to_prev).wait()


# ---------------------------------------------------------------------------
# launching ranks
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A TCP port of localhost that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, nprocs, port, device, outdir, fn, args):
    os.environ["MASTER_ADDR"] = "127.0.0.1"
    os.environ["MASTER_PORT"] = str(port)
    initialize_distributed(f"127.0.0.1:{port}", nprocs, rank, device)
    try:
        out = fn(make_mesh(), *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))


def spawn_ranks(fn, nprocs: int, *args, device: str = "cpu"):
    """Runs ``fn(mesh, *args)`` in ``nprocs`` new processes, one rank
    each, joined in a process group on a free port of localhost (gloo for
    ``device="cpu"``; for ``"cuda"`` as :func:`initialize_distributed`
    picks), and returns their results in rank order.  ``fn`` must be a
    module-level function; its result must be picklable.  A rank that
    fails raises here."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as outdir:
        mp.start_processes(_rank_main, nprocs=nprocs, join=True,
                           start_method="spawn",
                           args=(nprocs, free_port(), device, outdir, fn,
                                 args))
        return [torch.load(os.path.join(outdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
