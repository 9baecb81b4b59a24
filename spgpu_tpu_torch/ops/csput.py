"""Coordinate updates of stored values (csput) on ELL and HELL.

Counterpart of :mod:`spgpu_tpu.ops.csput` (spGPU's ``spgpu?ellcsput``,
``ell_csput_base.cuh:44-73``): each triple (row, col, value) overwrites
the value stored at its coordinate, found among the row's slots (all of
them are compared, so a row's columns need not be sorted, where spGPU
binary-searches).  The JAX module's deviations hold:

* ``alpha`` is honoured (spGPU documents ``alpha*val`` but stores
  ``val``);
* a triple whose coordinate is absent is skipped;
* the update is functional: a new layout that shares every tensor but
  ``values`` is returned.

The triples may be NumPy arrays, lists or tensors; the search and the
update run on the layout's device.
"""

from __future__ import annotations

import dataclasses

import torch

from spgpu_tpu_torch.formats.ell import EllMatrix
from spgpu_tpu_torch.formats.hell import HellMatrix

__all__ = ["ell_csput", "hell_csput"]


def _triples(a, rows, cols, values):
    def t(v, dtype):
        return torch.as_tensor(v).to(device=a.device, dtype=dtype)

    return t(rows, torch.int64), t(cols, torch.int64), t(values, a.values.dtype)


def _stored_rows(a, rows: torch.Tensor) -> torch.Tensor:
    """Original rows → stored rows through an OELL ``row_perm``."""
    if a.row_perm is None:
        return rows
    inv = torch.empty(a.rows_padded, dtype=torch.int64, device=a.device)
    inv[a.row_perm.long()] = torch.arange(a.rows_padded, device=a.device)
    return inv[rows]


def _update(a, slot, lane, cand, values, alpha):
    """Write ``alpha * values`` into ``(slot[k, j], lane[j])`` where
    triple ``j`` matched in slot ``k`` (``slot``, ``cand``: ``(W, m)``; the
    first match wins), else leave it."""
    k = cand.to(torch.uint8).argmax(dim=0)
    found = cand.any(dim=0)
    sidx = slot.gather(0, k[None, :])[0]
    new = a.values.clone()
    old = new[sidx, lane]
    new[sidx, lane] = torch.where(found, alpha * values, old)
    return dataclasses.replace(a, values=new)


def ell_csput(a: EllMatrix, rows, cols, values, alpha=1.0) -> EllMatrix:
    """Overwrite the ELL values at ``(rows, cols)`` (original rows) with
    ``alpha * values``."""
    rows, cols, values = _triples(a, rows, cols, values)
    rows = _stored_rows(a, rows)
    cand = a.col_indices[:, rows].long() == cols[None, :]  # (W, m)
    slot = torch.arange(a.width_padded, device=a.device)[:, None]
    if a.row_lengths is not None:
        cand &= slot < a.row_lengths[rows].long()[None, :]
    return _update(a, slot.expand_as(cand), rows, cand, values, alpha)


def hell_csput(a: HellMatrix, rows, cols, values, alpha=1.0) -> HellMatrix:
    """csput on HELL (spGPU ships it for ELL only): row ``r``'s slot ``k``
    is ``hack_offsets[r // hack_size] + k`` at lane ``r % hack_size``; the
    search spans the widest hack."""
    rows, cols, values = _triples(a, rows, cols, values)
    rows = _stored_rows(a, rows)
    h, lane = rows // a.hack_size, rows % a.hack_size
    base = a.hack_offsets.long()[h]
    width = a.hack_offsets.long()[h + 1] - base
    slot = torch.arange(max(a.max_hack_width, 1), device=a.device)[:, None]  # (W, 1)
    sidx = (base[None, :] + slot).clamp(0, a.total_slots - 1)  # (W, m)
    cand = (a.col_indices[sidx, lane[None, :]].long() == cols[None, :]) \
        & (slot < width[None, :])
    if a.row_lengths is not None:
        cand &= slot < a.row_lengths[rows].long()[None, :]
    return _update(a, sidx, lane, cand, values, alpha)
