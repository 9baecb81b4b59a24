"""The distributed SpMV: each rank's product of its shard, with the halo
of x exchanged point to point and the interior product run meanwhile.

Counterpart of :mod:`spgpu_tpu.parallel.dist_spmv`.  Each rank holds one
shard of a :class:`~spgpu_tpu_torch.parallel.partition_packed.PackedPartition`
(kernels #1, #4, #7 or the complex128 kernel on its layouts), of a
:class:`~spgpu_tpu_torch.parallel.partition_whell.PartitionedWhell`
(kernel #15) or of the HELL
:class:`~spgpu_tpu_torch.parallel.partition.PartitionedMatrix` (plain torch
``hell_spmv``, as the JAX partition runs XLA ops); each product goes
through ``ops.spmv``, which dispatches on the layout.  Per product:

1. the exchange: the rank gathers ``x[send_lanes]`` for each requester
   with a halo and posts the sends and receives of its live pairs in one
   ``torch.distributed.batch_isend_irecv``, each pair at its exact width
   (a pair of count 0 posts nothing).  It never writes into ``x``: the
   received values land in a workspace of the handle, a copy of ``x``
   with the halo lanes set (packed), or the flat halo buffer (classic
   WHELL and HELL);
2. the interior product reads the local ``x`` only and runs while the
   exchange is in flight; on a CUDA device the exchange runs on a side
   stream, forked from and joined to the current stream by events, so the
   whole product can be captured in a CUDA graph (NCCL's point-to-point
   calls included: the card tests replay it against the eager product);
3. the exterior product reads the workspace and adds into the interior
   product's prefix (a packed exterior is cut after its last live output
   group).

A packed partition built with ``overlap=False`` runs its one slab on the
workspace after the exchange, and a partition with no halo anywhere runs
the interior product on ``x`` with no exchange.  Complex vectors cross as
their real views.  Every product launches the hand kernels on a CUDA
device (the HELL partition its plain torch products); there is no
fallback.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from spgpu_tpu_torch import ops
from spgpu_tpu_torch.parallel.group import RankGroup
from spgpu_tpu_torch.parallel.partition_packed import PackedPartition

__all__ = ["ShardedHandle", "dist_spmv", "make_dist_matvec"]


def real_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the collectives carry it: a complex tensor's real view."""
    return torch.view_as_real(t) if t.is_complex() else t


class ShardedHandle:
    """One rank's shard placed on its device once, with its exchange
    buffers, for many products: the counterpart of the JAX
    ``ShardedHandle``.

    >>> h = ShardedHandle(pm, rg)
    >>> xl = h.embed(x_host)         # this rank's block, on its device
    >>> for _ in range(steps):
    ...     xl = h.matvec(xl)        # no host round trip
    >>> z = h.extract(xl)            # the global vector, on every rank

    ``placements`` counts the shard's placements (1 for the handle's
    life)."""

    def __init__(self, pm, rg: RankGroup):
        if pm.n_shards != rg.size:
            raise ValueError(f"a {pm.n_shards}-shard partition needs {pm.n_shards} "
                             f"ranks, not {rg.size}")
        self.pm, self.rg = pm, rg
        dev = rg.device
        sh = pm.shard(rg.rank, dev)
        self.placements = 1
        self.interior, self.exterior = sh.interior, sh.exterior
        self.packed = isinstance(pm, PackedPartition)
        self.n = sh.n_lane if self.packed else pm.chunk
        self.sends = sorted(sh.send_lanes.items())
        owners = sorted(sh.halo_lanes.items())
        self.halo = (torch.cat([t for _, t in owners]) if owners
                     else torch.zeros(0, dtype=torch.long, device=dev))
        self.recv = torch.empty(self.halo.numel(), dtype=pm.dtype, device=dev)
        offs = np.cumsum([0] + [t.numel() for _, t in owners])
        self.recv_views = [(p, self.recv[offs[i]:offs[i + 1]])
                           for i, (p, _) in enumerate(owners)]
        # the workspace the halo lands in: a copy of x (packed) or the flat
        # halo buffer (classic WHELL, HELL), zero where no halo value lands
        self.work = torch.zeros(self.n if self.packed else pm.halo_size,
                                dtype=pm.dtype, device=dev)
        self.side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    # --- vectors ---------------------------------------------------------

    def embed(self, x, fill=0) -> torch.Tensor:
        """Global ``(n,)`` vector (host or tensor) -> this rank's block on
        its device (padding and phantom lanes ``fill``)."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return self.pm.embed_shard(x, self.rg.rank, self.rg.device, fill=fill)

    def extract(self, z: torch.Tensor) -> torch.Tensor:
        """This rank's block -> the global ``(n,)`` vector, gathered from
        every rank (a collective: every rank calls it), on the device."""
        pm, rg = self.pm, self.rg
        loc = pm.extract_shard(z, rg.rank)
        buf = torch.zeros(pm.chunk, dtype=z.dtype, device=z.device)
        buf[: loc.numel()] = loc
        parts = [torch.empty_like(buf) for _ in range(rg.size)]
        dist.all_gather([real_view(p) for p in parts], real_view(buf), group=rg.group)
        return torch.cat(parts)[: pm.n_rows]

    # --- the product ----------------------------------------------------

    def _stream(self):
        return torch.cuda.stream(self.side) if self.side is not None \
            else contextlib.nullcontext()

    def _start(self, x: torch.Tensor) -> list:
        """Gather the send buffers, copy ``x`` into the workspace and post
        the exchange; returns its works."""
        # the gathered send buffers live until the exchange is waited for
        self._sent = [real_view(x[idx]) for _, idx in self.sends]
        if self.packed:
            self.work.copy_(x)
        return self._post()

    def _post(self) -> list:
        """Post this rank's sends and receives; returns their works."""
        group = self.rg.group
        p2p = [dist.P2POp(dist.isend, buf, r, group)
               for (r, _), buf in zip(self.sends, self._sent)]
        p2p += [dist.P2POp(dist.irecv, real_view(v), p, group)
                for p, v in self.recv_views]
        return dist.batch_isend_irecv(p2p) if p2p else []

    def _finish(self, works: list) -> None:
        """Wait for the exchange and place the halo in the workspace."""
        for w in works:
            w.wait()
        self._sent = []
        if self.halo.numel():
            self.work.index_copy_(0, self.halo, self.recv)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``A @ x`` for its block ``x`` (lane space
        for a packed partition, its ``chunk`` rows for a classic WHELL or
        HELL one), on the device.  Every rank of the group calls it together."""
        if x.shape != (self.n,):
            raise ValueError(f"x must be this rank's ({self.n},) block, got "
                             f"{tuple(x.shape)}")
        if self.pm.no_halo:
            return ops.spmv(self.interior, x)
        if self.side is not None:
            self.side.wait_stream(torch.cuda.current_stream(x.device))
        with self._stream():
            works = self._start(x)
        if not self.pm.overlapped:
            with self._stream():
                self._finish(works)
            self._join(x)
            return ops.spmv(self.interior, self.work)
        z = ops.spmv(self.interior, x)
        with self._stream():
            self._finish(works)
        self._join(x)
        if self.exterior is not None:
            z_ext = ops.spmv(self.exterior, self.work)
            z[: z_ext.shape[0]] += z_ext
        return z

    def _join(self, x: torch.Tensor) -> None:
        if self.side is not None:
            torch.cuda.current_stream(x.device).wait_stream(self.side)


class _PlannedHalo(ShardedHandle):
    """Shard ``s`` of ``pm`` alone on ``device``, its halo taken by the
    plan from a global x (:meth:`set_x`) instead of from peers: the same
    schedule, send gathers, workspace and products as a rank's
    :meth:`matvec`, run in one process (no group), only the posting of
    the exchange replaced by a copy.  A check of each shard's product on
    one card, not an exchange."""

    def __init__(self, pm, s: int, device):
        super().__init__(pm, RankGroup(rank=s, size=pm.n_shards,
                                       device=torch.device(device), group=None))
        self._values = torch.zeros_like(self.recv)

    def set_x(self, x) -> torch.Tensor:
        """Take the halo from the global ``(n,)`` vector ``x``: each owner's
        values at the lanes it would send this shard.  Returns this shard's
        block of ``x``."""
        s, pm = self.rg.rank, self.pm
        vals = [pm.embed_shard(x, p)[pm.shards[p].send_lanes[s]]
                for p in sorted(pm.shards[s].halo_lanes)]
        if vals:
            self._values.copy_(torch.cat(vals))
        return self.embed(x)

    def _post(self) -> list:
        self.recv.copy_(self._values)
        return []


def make_dist_matvec(pm, rg: RankGroup):
    """This rank's matvec closure ``x_block -> (A @ x)_block`` (a
    :class:`ShardedHandle`'s), for a solver loop."""
    return ShardedHandle(pm, rg).matvec


def dist_spmv(pm, x, rg: RankGroup) -> torch.Tensor:
    """Distributed ``A @ x`` for a row-partitioned square matrix: ``x`` is
    the global ``(n,)`` vector (every rank passes it), the result the
    global ``(n,)`` product on every rank, on the rank's device.  Places
    the shard anew; a loop keeps a :class:`ShardedHandle`."""
    h = ShardedHandle(pm, rg)
    return h.extract(h.matvec(h.embed(x)))
