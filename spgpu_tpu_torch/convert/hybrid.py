"""COO → the hybrid banded + irregular split (HYB class), on the host.

Counterpart of :mod:`spgpu_tpu.convert.hybrid`: the same split, so the
band and rest parts hold the JAX parts' entries.  A diagonal joins the
band within a 128-row hack when it fills at least ``tau_lanes`` of the
hack's lanes; ``tau_lanes="auto"`` takes the candidate with the least
modelled time among those whose band fraction clears ``min_band_frac``.
The model's per-cell rates are the JAX package's (TPU v5e rates of WHDIA
pattern mode and packed WHELL, ``BASELINE.md`` round 4), kept so that the
two packages split alike; they say nothing of the H100.  The band part is
a :class:`~spgpu_tpu_torch.formats.whdia.WhdiaMatrix`, the rest a packed
:class:`~spgpu_tpu_torch.formats.whell.WhellMatrix`; values are float32
or float64 (the JAX package's double-float layouts are native float64
here).  The JAX package's design notes measured the split slower than
pure packed WHELL on the TPU; ``suggest_format`` never proposes it.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from spgpu_tpu_torch.core import dtype_name
from spgpu_tpu_torch.formats.coo import CooMatrix
from spgpu_tpu_torch.formats.hybrid import HybridMatrix, lane_runs

__all__ = ["coo_to_hybrid", "hybrid_split_stats"]

# the JAX package's per-cell model (ns per 1024-cell tile, TPU v5e):
# WHDIA pattern mode ~8.6 ns/tile, packed WHELL ~12 ns/tile
_BAND_NS_PER_CELL = 8.6 / 1024.0
_REST_NS_PER_CELL = 12.0 / 1024.0

#: the value types of the split
_TYPES = ("float32", "float64")


def _occupancy(coo: CooMatrix):
    """Each (hack, diagonal) slot's entry count and each entry's slot."""
    hack = (coo.rows // 128).astype(np.int64)
    diag = coo.cols.astype(np.int64) - coo.rows.astype(np.int64)
    key = hack * (coo.n_rows + coo.n_cols) + (diag + coo.n_rows)
    _, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
    return cnt, inv


def hybrid_split_stats(coo: CooMatrix, taus=(8, 16, 32, 48, 64, 96, 128), _occ=None):
    """For each candidate threshold: the band fraction, the band part's
    WHDIA cells and pad, and the modelled time; and each entry's slot
    occupancy.  ``_occ``: a precomputed ``(cnt, inv)`` histogram."""
    cnt, inv = _occupancy(coo) if _occ is None else _occ
    rows = []
    for t in taus:
        sel = cnt >= t
        band_nnz = int(cnt[sel].sum())
        band_cells = int(sel.sum()) * 128
        # the rest's pad is unknown before it converts: the JAX model takes
        # the flagship's packed pad, 1.74
        model_ns = (_BAND_NS_PER_CELL * band_cells
                    + _REST_NS_PER_CELL * (coo.nnz - band_nnz) * 1.74)
        rows.append({"tau_lanes": int(t), "band_frac": band_nnz / max(coo.nnz, 1),
                     "band_nnz": band_nnz, "band_cells": band_cells,
                     "band_pad": band_cells / max(band_nnz, 1), "model_ns": model_ns})
    return rows, cnt[inv]


def _not_banded(frac: float, tau: int, min_band_frac: float, occ_max: int) -> ValueError:
    return ValueError(
        f"matrix is not part-banded: band fraction {frac:.3f} at tau_lanes={tau} "
        f"(< min_band_frac={min_band_frac}); occupancy max {occ_max}/128 lanes "
        "- use packed WHELL")


def coo_to_hybrid(coo: CooMatrix, *, device, tau_lanes: Union[int, str] = "auto",
                  min_band_frac: float = 0.25, dtype=None, **whell_kw) -> HybridMatrix:
    """COO → :class:`HybridMatrix` on ``device``.

    Duplicates are summed first (the two parts store plainly, so the
    split must not depend on where a duplicate lands).  Raises
    ``ValueError`` with the occupancy figures when the band fraction
    falls below ``min_band_frac``, ``NotImplementedError`` on complex
    values (as the JAX converter does) and on any type but float32 and
    float64.  ``whell_kw`` goes to the rest part's ``coo_to_whell``
    (``scattered=False`` gives the JAX float64 geometry)."""
    from spgpu_tpu_torch.convert.whdia import coo_to_whdia
    from spgpu_tpu_torch.convert.whell import coo_to_whell

    if coo.n_rows != coo.n_cols:
        raise ValueError("hybrid layout requires a square matrix")
    if np.issubdtype(coo.values.dtype, np.complexfloating):
        raise NotImplementedError(
            "hybrid layout covers real float32/float64 matrices; complex "
            "matrices run the WHDIA and WHELL routes")
    coo = coo.sum_duplicates()
    if dtype is not None:
        coo = CooMatrix(coo.rows, coo.cols, coo.values.astype(dtype), coo.n_rows,
                        coo.n_cols)
    if dtype_name(coo.values.dtype) not in _TYPES:
        raise NotImplementedError(
            f"hybrid layout in the port takes float32 or float64 values, not "
            f"{dtype_name(coo.values.dtype)}")
    cnt, inv = _occupancy(coo)
    occ_max = int(cnt.max()) if cnt.size else 0
    if tau_lanes == "auto":
        rows, _ = hybrid_split_stats(coo, _occ=(cnt, inv))
        ok = [r for r in rows if r["band_frac"] >= min_band_frac]
        if not ok:
            best = max(rows, key=lambda r: r["band_frac"])
            raise _not_banded(best["band_frac"], best["tau_lanes"], min_band_frac,
                              occ_max)
        tau = min(ok, key=lambda r: r["model_ns"])["tau_lanes"]
    else:
        tau = int(tau_lanes)
    sel = cnt[inv] >= tau
    band_nnz = int(sel.sum())
    if band_nnz / max(coo.nnz, 1) < min_band_frac:
        raise _not_banded(band_nnz / max(coo.nnz, 1), tau, min_band_frac, occ_max)

    def part(mask):
        return CooMatrix(coo.rows[mask], coo.cols[mask], coo.values[mask],
                         coo.n_rows, coo.n_cols)

    band = coo_to_whdia(part(sel), device=device)
    rest, runs = None, ()
    if coo.nnz - band_nnz:
        rest = coo_to_whell(part(~sel), device=device, packed=True, **whell_kw)
        runs = lane_runs(rest.lane_of_row.cpu().numpy(), rest.n_rows)
    return HybridMatrix(band=band, rest=rest, n_rows=coo.n_rows, n_cols=coo.n_cols,
                        nnz=coo.nnz, band_nnz=band_nnz, tau_lanes=tau, runs=runs)
