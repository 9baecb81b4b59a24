"""HPCG's problem: the 27-point stencil of HPCG 3.x's ``GenerateProblem``.

On an ``nx x ny x nz`` grid (row ``iz*nx*ny + iy*nx + ix``, x fastest),
each point couples to every neighbour of its 3x3x3 box that lies inside
the grid: 26 on the diagonal, -1 off it.  Rows come out in order and each
row's columns ascending, with no duplicates, so the COO needs no sort.
HPCG's own right-hand side is ``b = A·1`` (its ``xexact`` is all ones).
"""

from __future__ import annotations

import numpy as np

__all__ = ["generate"]


def generate(params: dict, dtype) -> tuple:
    """``(rows, cols, values, n)`` of HPCG's matrix for ``params``'s
    ``nx``, ``ny``, ``nz``, as int64 row and column indices and ``dtype``
    values."""
    nx, ny, nz = (int(params[k]) for k in ("nx", "ny", "nz"))
    n = nx * ny * nz
    iz, iy, ix = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    iz, iy, ix = iz.ravel(), iy.ravel(), ix.ravel()
    # the 27 offsets in HPCG's loop order (sz, sy, sx ascending): the
    # column offsets then ascend within every row
    offs = [(sz, sy, sx) for sz in (-1, 0, 1) for sy in (-1, 0, 1) for sx in (-1, 0, 1)]
    cols = np.empty((n, 27), dtype=np.int64)
    keep = np.empty((n, 27), dtype=bool)
    row = np.arange(n, dtype=np.int64)
    for j, (sz, sy, sx) in enumerate(offs):
        keep[:, j] = ((iz + sz >= 0) & (iz + sz < nz) & (iy + sy >= 0) & (iy + sy < ny)
                      & (ix + sx >= 0) & (ix + sx < nx))
        cols[:, j] = row + sz * nx * ny + sy * nx + sx
    del iz, iy, ix
    flat = keep.ravel()
    cols = cols.ravel()[flat]
    rows = np.repeat(row, keep.sum(axis=1))
    values = np.where(cols == rows, 26.0, -1.0).astype(dtype)
    return rows, cols, values, n
