"""Format selection heuristics (host NumPy).

A copy of :mod:`spgpu_tpu.convert.select`: each format's padded slab
traffic is estimated from cheap COO statistics and the layout that moves
the fewest bytes per product wins.  The estimates are unchanged, so both
packages pick the same format for the same matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from spgpu_tpu_torch.core import unique_sorted
from spgpu_tpu_torch.formats.coo import CooMatrix

__all__ = ["FormatEstimate", "estimate_formats", "suggest_format"]


@dataclasses.dataclass
class FormatEstimate:
    fmt: str
    bytes_per_product: float  # slab traffic per SpMV (value+index bytes)
    pad_factor: float

    def json(self):
        return dataclasses.asdict(self)


def estimate_formats(coo: CooMatrix, itemsize: int = 4) -> Dict[str, FormatEstimate]:
    """Per-product slab traffic estimates:

    * DIA: distinct diagonals × padded rows (dense diagonal slab);
    * WHDIA: per-(hack, diagonal) occupancy, values-only traffic;
    * HYBRID: band part as WHDIA, the rest as packed WHELL;
    * WHELL: per-(hack, superpage) group widths, 6 B/cell;
    * ELL: global max row length.
    """
    n, m = coo.n_rows, coo.nnz
    if m == 0:
        z = FormatEstimate("ell", 0.0, 1.0)
        return {"ell": z}
    rows_p = -(-n // 128) * 128
    lens = coo.row_lengths()
    diag = coo.cols - coo.rows
    hack = coo.rows // 128

    out: Dict[str, FormatEstimate] = {}

    # ELL: width = max row length
    w = int(lens.max())
    cells = w * rows_p
    out["ell"] = FormatEstimate("ell", cells * (itemsize + 4), cells / m)

    # DIA: every distinct diagonal stored dense
    ndiag = unique_sorted(diag).size
    cells = ndiag * rows_p
    out["dia"] = FormatEstimate("dia", cells * itemsize, cells / m)

    # WHDIA: distinct (hack, diagonal) pairs × 128 lanes, values only;
    # diagonals are biased by n so keys stay collision-free
    occ = np.unique(hack.astype(np.int64) * (n + coo.n_cols) + (diag + n),
                    return_counts=True)[1]
    hd = occ.size
    cells = hd * 128
    out["whdia"] = FormatEstimate("whdia", cells * itemsize, cells / m)

    # HYBRID: entries on diagonals filling >= t of a hack's lanes go to
    # WHDIA, the rest to packed WHELL at padding 1.74; admissible when
    # some threshold captures >= 25% of entries.  suggest_format never
    # returns it (the model under-prices the two-space crossing).
    if coo.n_rows == coo.n_cols:
        best = None
        for t in (16, 32, 48, 64, 96, 128):
            sel = occ >= t
            bn = int(occ[sel].sum())
            if bn < 0.25 * m:
                continue
            bcells = int(sel.sum()) * 128
            rcells = (m - bn) * 1.74
            by = (bcells * itemsize + rcells * (itemsize + 2)
                  + n * 2 * itemsize)
            if best is None or by < best[0]:
                best = (by, bcells + rcells)
        if best is not None:
            out["hybrid"] = FormatEstimate("hybrid", best[0], best[1] / m)

    # WHELL: classic-layout cells (sum over (hack, superpage) groups of
    # the max per-row count × 128), with the packed layout recovering
    # ~54% of the raggedness excess over nnz
    nsp = max(-(-coo.n_cols // 1024), 1)
    G = hack * nsp + coo.cols // 1024
    key = G * n + coo.rows
    uk, cnt = np.unique(key, return_counts=True)
    gq = uk // n
    o = np.argsort(gq, kind="stable")
    gs, cs = gq[o], cnt[o]
    grp = np.r_[True, gs[1:] != gs[:-1]]
    gid = np.cumsum(grp) - 1
    W = np.zeros(gid[-1] + 1, dtype=np.int64)
    np.maximum.at(W, gid, cs)
    cells = int((-(-W // 8) * 8).sum()) * 128
    cells = m + int(max(cells - m, 0) * 0.46)
    out["whell"] = FormatEstimate("whell", cells * (itemsize + 2), cells / m)

    return out


def suggest_format(coo: CooMatrix, itemsize: int = 4) -> str:
    """The format with the least per-product slab traffic ("hybrid"
    excluded)."""
    est = estimate_formats(coo, itemsize)
    return min((e for k, e in est.items() if k != "hybrid"),
               key=lambda e: e.bytes_per_product).fmt
