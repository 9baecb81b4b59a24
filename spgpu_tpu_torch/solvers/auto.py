"""High-level solve: format selection + compute layout + Krylov.

Counterpart of :func:`spgpu_tpu.solvers.auto.solve`: coalesce
duplicates, pick the format by slab-traffic estimate (the DIA class goes
to SDIA, ELL to packed WHELL), build the layout and run CG (SPD) or
BiCGSTAB.  Packed WHELL iterates in lane space (``b`` is embedded, ``x``
extracted); SDIA, WHDIA, the per-cell-routing layout (``fmt="pcell"``,
float32 and float64), the hybrid split (``fmt="hybrid"``, float32 and float64:
WHDIA band and packed WHELL rest, the crossing inside its product) and
classic HELL (``fmt="hell"``, plain torch products) iterate in the
original numbering.  The TPU budget switches (row blocks past the VMEM x
budget, the SDIA→WHDIA VMEM fallback) are left out: the port builds one
layout at any size.  ``fmt="blocks"``, which the JAX route sends to its
row-blocked packed layout (``BlockedPackedWhell`` and ``blocks_cg``, TPU
budget machinery that is not ported), runs the one-layout packed-WHELL
route on a real system (a stated deviation: the same system, one
layout).  As in the JAX route, a complex system with ``fmt`` "hell",
"hybrid", "blocks" or "pcell" runs the classic ``hell`` route.

Every route iterates through :mod:`spgpu_tpu_torch.solvers.cg`: on a CUDA
device as replays of a CUDA graph of masked CG or BiCGSTAB steps (the
counterpart of the JAX ``lax.while_loop``; the host reads one flag per
replay), on the CPU as eager steps.  The layout, the embedding of ``b``
and ``x0`` into lane space, the extraction of ``x`` and the Jacobi
preconditioner are built once, outside the loop.

float64 systems run the same routes with float64 layouts, kernels and
work vectors: the counterpart of the JAX double-float routes
(``cg_dd``/``bicgstab_dd`` on hi/lo pairs), with the plain CG/BiCGSTAB
loop in native float64.

complex64 and complex128 systems (the counterpart of ``_solve_complex``
and of the JAX complex ``hell`` route) run the whell, sdia, whdia and
hell routes with complex layouts, products and work vectors: CG for
Hermitian positive-definite systems (``symmetric=True``, as
``cg_herm_planes``; the loop's inner product is conjugated, as the JAX
``cg``'s is), BiCGSTAB otherwise (``bicgstab_planes``), with no
preconditioner.  Auto-selection maps the hybrid class to WHDIA, as the
JAX complex route does, and keeps SDIA where the JAX route switches an
SDIA system whose two x planes pass its VMEM budget to WHDIA (by design:
the port has no such budget).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spgpu_tpu_torch.convert.host import coo_to_hell
from spgpu_tpu_torch.convert.hybrid import coo_to_hybrid
from spgpu_tpu_torch.convert.pcell import coo_to_whell_percell
from spgpu_tpu_torch.convert.sdia import coo_to_sdia
from spgpu_tpu_torch.convert.select import suggest_format
from spgpu_tpu_torch.convert.whdia import coo_to_whdia
from spgpu_tpu_torch.convert.whell import coo_to_whell
from spgpu_tpu_torch.core import value_dtype
from spgpu_tpu_torch.formats.coo import CooMatrix
from spgpu_tpu_torch.ops import hell_spmv, hybrid_spmv, sdia_spmv, whdia_spmv, whell_spmv
from spgpu_tpu_torch.solvers.cg import CgResult, bicgstab, cg, jacobi_preconditioner

__all__ = ["solve"]

def solve(coo: CooMatrix, b, *, device, symmetric: bool = True,
          tol: float = 1e-8, maxiter: int = 5000, jacobi: bool = False,
          fmt: Optional[str] = None, x0=None) -> CgResult:
    """Solve ``A x = b`` for a square host COO on ``device``.

    ``symmetric=True`` runs CG (SPD systems, or Hermitian positive-definite
    ones with complex values), else BiCGSTAB.  ``fmt`` overrides the
    automatic choice: "whell", "sdia", "whdia", "hybrid", "hell", "pcell"
    (float32 and float64) or "blocks" (the packed-WHELL route on one
    layout, where the JAX package builds row blocks); a complex system
    with "hell", "hybrid", "blocks" or "pcell" runs the "hell" route, as
    the JAX ``solve()`` does.  Values are float32,
    float64, complex64 or complex128, and the layout, the kernels, the
    work vectors, ``x0`` and the Jacobi preconditioner (``jacobi=True``)
    take the values' type: a float64 system iterates in float64
    throughout (where the JAX double-float route rounds its
    preconditioner to float32).  ``jacobi=True`` with complex values
    raises ``NotImplementedError`` (the JAX complex route takes no
    preconditioner).  Returns a :class:`CgResult` whose ``x`` is in the
    ORIGINAL numbering, on ``device``, in the values' type."""
    if coo.n_rows != coo.n_cols:
        raise ValueError("solve requires a square system")
    work = getattr(torch, value_dtype(coo.values.dtype, "solve()").name)
    if jacobi and work.is_complex:
        raise NotImplementedError(
            "jacobi=True with complex values: the complex routes run "
            "unpreconditioned CG/BiCGSTAB, as the JAX package's do")
    # coalesce once: WHELL adds duplicates while SDIA/WHDIA keep the last
    # write, so every format then solves the same matrix
    coo = coo.sum_duplicates()
    if fmt is None:
        fmt = suggest_format(coo)
        # the hybrid split is real-only: complex band-heavy systems take
        # WHDIA, as in the JAX complex route
        fmt = {"dia": "sdia", "ell": "whell",
               **({"hybrid": "whdia"} if work.is_complex else {})}.get(fmt, fmt)
    if work.is_complex and fmt in ("hell", "hybrid", "blocks", "pcell"):
        fmt = "hell"  # the JAX solve()'s complex overrides run its hell route
    if fmt == "blocks":
        fmt = "whell"  # one packed layout holds what JAX cuts into row blocks

    m_inv = jacobi_preconditioner(coo, device).to(work) if jacobi else None
    if fmt == "whell":
        a = coo_to_whell(coo, device=device)
        mv = lambda v: whell_spmv(a, v)  # noqa: E731
        into = lambda v: a.embed(torch.as_tensor(np.asarray(v)), dtype=work)  # noqa: E731
        out = lambda v: a.extract(v, dtype=work)  # noqa: E731
        if m_inv is not None:
            # phantom lane-space coordinates get 1 (their residual stays 0)
            ones = torch.ones(a.n_rows, dtype=work, device=a.device)
            ones[a.lane_of_row.long()] = m_inv
            m_inv = ones
    elif fmt in ("sdia", "whdia", "pcell", "hybrid", "hell"):
        # the DIA class, pcell, the hybrid split and HELL iterate in the
        # original numbering
        if fmt == "sdia":
            a = coo_to_sdia(coo, device=device)
            mv = lambda v: sdia_spmv(a, v)  # noqa: E731
        elif fmt == "whdia":
            a = coo_to_whdia(coo, device=device)
            mv = lambda v: whdia_spmv(a, v)  # noqa: E731
        elif fmt == "hybrid":
            a = coo_to_hybrid(coo, device=device)
            mv = lambda v: hybrid_spmv(a, v)  # noqa: E731
        elif fmt == "hell":
            a = coo_to_hell(coo, device=device)
            mv = lambda v: hell_spmv(a, v)  # noqa: E731
        else:
            a = coo_to_whell_percell(coo, device=device)
            mv = lambda v: whell_spmv(a, v)  # noqa: E731
        into = lambda v: torch.as_tensor(np.asarray(v)).to(device, work)  # noqa: E731
        out = lambda v: v  # noqa: E731
    else:
        raise ValueError(f"unknown fmt {fmt!r}")
    solver = cg if symmetric else bicgstab
    res = solver(mv, into(b), x0=None if x0 is None else into(x0), tol=tol,
                 maxiter=maxiter, m_inv=m_inv)
    return res._replace(x=out(res.x))
