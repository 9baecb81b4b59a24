"""The system under test: the port's converters, ops and Krylov loops,
called as ``spgpu_tpu_torch.solvers.auto.solve`` calls them, with the
layout built once in set-up and kept for every solve or product.

A route is the layout and the op of one of ``solve()``'s formats;
``"auto"`` is the format ``suggest_format`` picks, mapped as ``solve()``
maps it.  Packed WHELL works in lane space: the right-hand side is
embedded and the answer extracted by the layout's own ``embed`` and
``extract``, as ``solve()`` does; the other formats work in the original
numbering.  The benchmark hands the program only the generated COO and
vectors, and takes back answers in the original numbering."""

from __future__ import annotations

import importlib
import time
from typing import Callable, Tuple

import torch

__all__ = ["Program"]

#: auto-selection's names mapped to ``solve()``'s routes, as ``solve()``
#: maps them for a real system
_AUTO = {"dia": "sdia", "ell": "whell"}


class Program:
    """One route of the port over the COO ``coo`` on ``device``, in the
    values' type: ``product(v)`` is the route's op, and ``solve(b)`` the
    entry ``solver`` (``"cg"`` or ``"bicgstab"``) over it."""

    def __init__(self, coo, route: str, device: torch.device):
        from spgpu_tpu_torch import convert, ops
        from spgpu_tpu_torch.convert.select import suggest_format

        t0 = time.perf_counter()
        if route == "auto":
            route = suggest_format(coo)
            route = _AUTO.get(route, route)
        #: seconds the selection took (within the conversion's span)
        self.select_s = time.perf_counter() - t0
        self.fmt = route
        self.dtype = getattr(torch, coo.values.dtype.name)
        builders = {
            "whell": (convert.coo_to_whell, ops.whell_spmv),
            "sdia": (convert.coo_to_sdia, ops.sdia_spmv),
            "whdia": (convert.coo_to_whdia, ops.whdia_spmv),
            "pcell": (convert.coo_to_whell_percell, ops.whell_spmv),
            "hybrid": (convert.coo_to_hybrid, ops.hybrid_spmv),
            "hell": (convert.coo_to_hell, ops.hell_spmv),
        }
        if self.fmt not in builders:
            raise ValueError(f"unknown route {self.fmt!r} (one of {sorted(builders)})")
        build, op = builders[self.fmt]
        self.layout = build(coo, device=device)
        self.op: Callable = op
        self.lane_space = self.fmt == "whell"

    def into(self, v: torch.Tensor) -> torch.Tensor:
        """An original-space vector in the op's space."""
        if self.lane_space:
            return self.layout.embed(v, dtype=self.dtype)
        return v.to(self.dtype)

    def out(self, v: torch.Tensor) -> torch.Tensor:
        """An op-space vector in the original numbering."""
        if self.lane_space:
            return self.layout.extract(v, dtype=self.dtype)
        return v

    def product(self, v: torch.Tensor) -> torch.Tensor:
        """``A·v`` in the op's space."""
        return self.op(self.layout, v)

    def solve(self, b: torch.Tensor, solver: str, tol: float,
              maxiter: int) -> Tuple[torch.Tensor, int, bool, float]:
        """``(x, iterations, converged, residual norm)`` of one solve of
        ``A x = b`` from ``x0 = 0`` as the loop reports them, ``x`` in the
        original numbering, waited for."""
        loop = importlib.import_module("spgpu_tpu_torch.solvers.cg")
        res = getattr(loop, solver)(self.product, self.into(b), tol=tol, maxiter=maxiter)
        x = self.out(res.x)
        return x, res.iterations, bool(res.converged), float(res.residual_norm)
