"""SpMV on the classic layouts (ELL/OELL, HELL, DIA, HDIA) in plain torch.

Counterpart of :mod:`spgpu_tpu.ops.spmv_xla`.  The JAX package computes
these products as XLA gathers and ``segment_sum`` outside any Pallas
kernel; the port computes them as torch gathers and reductions on the
layout's device, CUDA included (no host round trip):

* ELL: one gather of x by ``col_indices``, a product and a sum over the
  slot axis;
* HELL: the same gather and product on the ``(total_slots, hack_size)``
  slab, then each hack's contiguous slot range (``hack_offsets``) summed
  in slot order by ``torch.segment_reduce``, where the JAX op sums over
  ``slot_to_hack`` with ``segment_sum``: no atomics, so a product gives
  the same bits every call on the card;
* DIA: each diagonal reads x shifted by its offset, out-of-range columns
  masked (``dia_spmv_base_template.cuh:133-135``), summed over diagonals;
* HDIA: the shifted window of each slot, then the hack ranges as HELL.

Every product is ``z = beta*y + alpha*(A @ x)`` with spGPU's ``beta ==
0`` case never reading ``y`` (``ell_spmv_base_template.cuh:334-340``),
OELL's stored rows scattered back to the original rows (``:274-282``),
and leading batch dimensions ``(..., n_cols) → (..., n_rows)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from spgpu_tpu_torch.formats.dia import DiaMatrix
from spgpu_tpu_torch.formats.ell import EllMatrix
from spgpu_tpu_torch.formats.hdia import HdiaMatrix
from spgpu_tpu_torch.formats.hell import HellMatrix

__all__ = ["dia_spmv_plain", "ell_spmv_plain", "epilogue", "hack_sums",
           "hdia_spmv_plain", "hell_spmv_plain"]

_STATIC = (int, float, complex)


def epilogue(acc: torch.Tensor, alpha, beta, y) -> torch.Tensor:
    """``beta*y + alpha*acc`` in ``acc``'s type (alpha and beta may be
    complex for a complex ``acc``); a static ``beta == 0`` (or ``y is
    None``) never reads ``y``, as in spGPU's ``*spmv`` entry points."""
    if (isinstance(beta, _STATIC) and beta == 0) or y is None:
        return acc if isinstance(alpha, _STATIC) and alpha == 1 else alpha * acc
    return alpha * acc + beta * y


def _combine(acc, n_rows: int, alpha, beta, y, perm=None) -> torch.Tensor:
    """The stored-row product ``acc`` (``(..., rows_p)``) to the original
    rows (through the OELL ``perm``, a permutation of ``rows_p``), cut to
    ``n_rows``, then the epilogue."""
    if perm is not None:
        out = torch.zeros_like(acc)
        out[..., perm.long()] = acc
        acc = out
    return epilogue(acc[..., :n_rows], alpha, beta, y)


def hack_sums(prod: torch.Tensor, hack_offsets: torch.Tensor) -> torch.Tensor:
    """``prod`` ``(..., S, hack)`` summed over each hack's slot range
    ``hack_offsets[h]:hack_offsets[h + 1]``, in slot order, to ``(...,
    H * hack)``.  A complex ``prod`` sums as its real view."""
    p = prod.movedim(-2, 0)
    cplx = p.is_complex()
    if cplx:
        p = torch.view_as_real(p)
    z = torch.segment_reduce(p.contiguous(), "sum", offsets=hack_offsets, axis=0,
                             unsafe=True)
    if cplx:
        z = torch.view_as_complex(z)
    z = z.movedim(0, -2)
    return z.reshape(*z.shape[:-2], -1)


def ell_spmv_plain(a: EllMatrix, x: torch.Tensor, alpha=1.0, beta=0.0,
                   y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ELL/OELL: padding cells hold (0, column 0), so every slot is summed
    with no ``row_lengths`` mask (spGPU's "noRs" kernels on zero-padded
    storage, ``ell_spmv_base_nors.cuh:17-120``)."""
    acc = (a.values * x[..., a.col_indices]).sum(dim=-2)
    return _combine(acc, a.n_rows, alpha, beta, y, a.row_perm)


def hell_spmv_plain(a: HellMatrix, x: torch.Tensor, alpha=1.0, beta=0.0,
                    y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HELL (and hacked OELL): the slab's products summed by hack."""
    acc = hack_sums(a.values * x[..., a.col_indices], a.hack_offsets)
    return _combine(acc, a.n_rows, alpha, beta, y, a.row_perm)


def _masked_gather(x: torch.Tensor, cols: torch.Tensor, n_cols: int) -> torch.Tensor:
    """``x[..., cols]`` with 0 where a column leaves ``[0, n_cols)``."""
    ok = (cols >= 0) & (cols < n_cols)
    xg = x[..., cols.clamp(0, n_cols - 1)]
    return torch.where(ok, xg, torch.zeros((), dtype=xg.dtype, device=xg.device))


def dia_spmv_plain(a: DiaMatrix, x: torch.Tensor, alpha=1.0, beta=0.0,
                   y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DIA: ``sum_j values[j] * x[i + offsets[j]]`` over in-range columns
    (a padding diagonal's offset ``n_cols`` is never in range)."""
    i = torch.arange(a.rows_padded, dtype=torch.int64, device=a.device)
    cols = i[None, :] + a.offsets.long()[:, None]
    acc = (a.values * _masked_gather(x, cols, a.n_cols)).sum(dim=-2)
    return _combine(acc, a.n_rows, alpha, beta, y)


def hdia_spmv_plain(a: HdiaMatrix, x: torch.Tensor, alpha=1.0, beta=0.0,
                    y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HDIA: slot ``s`` of hack ``h`` reads the x window from
    ``h*hack_size + offsets[s]``; the products summed by hack."""
    lane = torch.arange(a.hack_size, dtype=torch.int64, device=a.device)
    start = a.slot_to_hack.long() * a.hack_size + a.offsets.long()
    prod = a.values * _masked_gather(x, start[:, None] + lane[None, :], a.n_cols)
    return _combine(hack_sums(prod, a.hack_offsets), a.n_rows, alpha, beta, y)
