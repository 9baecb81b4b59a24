"""Distributed Krylov solves over a row-partitioned matrix.

Counterpart of :mod:`spgpu_tpu.parallel.dist_solve`.  Each rank runs the
port's CG or BiCGSTAB (:mod:`spgpu_tpu_torch.solvers.cg`) on its block of
every vector, with its :class:`~spgpu_tpu_torch.parallel.dist_spmv.ShardedHandle`
as the matvec and the group given, so each inner product is
``all_reduce``d on the device and every rank reads the same flag.  On a
CUDA device the step, halo exchange and reductions included, is captured
in the loop's CUDA graph and replayed; on the CPU (gloo) it runs eagerly.
The card tests hold the graphed solve to its eager witness at one rank
and at one rank a card on a host with two cards or more.

* float64 runs the port's float64 solvers (the JAX ``cg_dd`` and
  ``bicgstab_dd`` emulate float64 with double-float pairs), and complex
  systems the port's complex CG (Hermitian positive-definite) and
  BiCGSTAB on one complex state (the JAX ``cg_herm_planes`` and
  ``bicgstab_planes`` on ``[re, im]`` plane stacks).
* ``m_inv`` (a diagonal preconditioner) embeds into each rank's block in
  the system's type, with 1 in phantom and padding lanes; the JAX package
  embeds it as float32 for every real type.  A complex system with
  ``m_inv`` raises, as in the JAX package.
"""

from __future__ import annotations

import importlib
from typing import Optional

import torch

from spgpu_tpu_torch.parallel.dist_spmv import ShardedHandle
from spgpu_tpu_torch.parallel.group import RankGroup

__all__ = ["DistSolveHandle", "dist_bicgstab", "dist_cg"]


def _loop():
    return importlib.import_module("spgpu_tpu_torch.solvers.cg")


class DistSolveHandle:
    """One rank's shard placed once for many solves: the counterpart of
    the JAX ``DistSolveHandle``.  ``placements`` (the JAX handle's
    ``trace_counts``) stays 1 across solves.

    >>> h = DistSolveHandle(pm, rg)
    >>> r1 = h.solve(b1)             # every rank calls it together
    >>> r2 = h.solve(b2)             # the same placement and buffers
    """

    def __init__(self, pm, rg: RankGroup):
        self.op = ShardedHandle(pm, rg)
        self.pm, self.rg = pm, rg

    @property
    def placements(self) -> int:
        return self.op.placements

    def solve(self, b, symmetric: bool = True, tol: float = 1e-10,
              maxiter: int = 1000, x0=None, m_inv=None, eager: bool = False):
        """Solve ``A x = b`` (CG with ``symmetric``, else BiCGSTAB):
        ``b``, ``x0`` and ``m_inv`` are global host vectors, the same on
        every rank; the result's ``x`` is the global solution on every
        rank, on its device.  ``eager`` runs the plain loop instead (the
        witness of the graphed one)."""
        pm, op = self.pm, self.op
        if m_inv is not None and pm.dtype.is_complex:
            raise NotImplementedError("preconditioning is not supported on the "
                                      "complex solvers yet")
        b_l = op.embed(b)
        x0_l = None if x0 is None else op.embed(x0)
        m_l = None if m_inv is None else op.embed(m_inv, fill=1)
        loop = _loop()
        solver = {(True, False): loop.cg, (False, False): loop.bicgstab,
                  (True, True): loop._cg_eager,
                  (False, True): loop._bicgstab_eager}[(bool(symmetric), bool(eager))]
        res = solver(op.matvec, b_l, x0=x0_l, tol=tol, maxiter=maxiter, m_inv=m_l,
                     group=self.rg.group)
        return res._replace(x=op.extract(res.x))


def dist_cg(pm, b, rg: RankGroup, x0=None, tol: float = 1e-10, maxiter: int = 1000,
            m_inv: Optional[torch.Tensor] = None):
    """Distributed preconditioned CG (SPD or Hermitian positive-definite
    systems); every rank calls it with the same global ``b``."""
    return DistSolveHandle(pm, rg).solve(b, True, tol, maxiter, x0, m_inv)


def dist_bicgstab(pm, b, rg: RankGroup, x0=None, tol: float = 1e-10,
                  maxiter: int = 1000, m_inv: Optional[torch.Tensor] = None):
    """Distributed BiCGSTAB (general systems)."""
    return DistSolveHandle(pm, rg).solve(b, False, tol, maxiter, x0, m_inv)
