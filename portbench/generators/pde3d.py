"""PSBLAS's ``pde3d`` test problem (``test/pargen/psb_d_pde3d.f90``).

The 7-point central-difference discretisation of

    -div(a grad u) + b . grad u + c u = f

on the unit cube with a Dirichlet boundary, on an ``idim``-cubed grid of
interior points (spacing ``h = 1/(idim + 1)``).  Row
``(ix-1)*idim**2 + (iy-1)*idim + iz`` (z fastest, 1-based as PSBLAS's
``glob_row``) holds, in column order: (x-1) ``-a1/h² - b1/(2h)``, (y-1)
``-a2/h² - b2/(2h)``, (z-1) ``-a3/h² - b3/(2h)``, the centre
``2(a1+a2+a3)/h² + c``, (z+1) ``-a3/h² + b3/(2h)``, (y+1)
``-a2/h² + b2/(2h)``, (x+1) ``-a1/h² + b1/(2h)``.  A neighbour outside
the grid carries the boundary value into PSBLAS's right-hand side and
leaves no entry.  The coefficients are constants here (PSBLAS's
``a1..a3``, ``b1..b3``, ``c`` functions return constants), given in the
configuration.
"""

from __future__ import annotations

import numpy as np

__all__ = ["generate"]


def generate(params: dict, dtype) -> tuple:
    """``(rows, cols, values, n)`` of the pde3d matrix for ``params``
    ``idim`` and the coefficients ``a1 a2 a3 b1 b2 b3 c``."""
    m = int(params["idim"])
    a1, a2, a3, b1, b2, b3, c = (float(params[k]) for k in
                                  ("a1", "a2", "a3", "b1", "b2", "b3", "c"))
    n = m ** 3
    h = 1.0 / (m + 1)
    h2, hh = h * h, 2.0 * h
    ix, iy, iz = np.meshgrid(np.arange(m), np.arange(m), np.arange(m), indexing="ij")
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    row = np.arange(n, dtype=np.int64)
    # (offset, inside, value) in PSBLAS's order, which is column order
    terms = [(-m * m, ix > 0, -a1 / h2 - b1 / hh),
             (-m, iy > 0, -a2 / h2 - b2 / hh),
             (-1, iz > 0, -a3 / h2 - b3 / hh),
             (0, np.ones(n, dtype=bool), 2.0 * (a1 + a2 + a3) / h2 + c),
             (1, iz < m - 1, -a3 / h2 + b3 / hh),
             (m, iy < m - 1, -a2 / h2 + b2 / hh),
             (m * m, ix < m - 1, -a1 / h2 + b1 / hh)]
    keep = np.stack([t[1] for t in terms], axis=1)
    cols = row[:, None] + np.array([t[0] for t in terms], dtype=np.int64)[None, :]
    vals = np.broadcast_to(np.array([t[2] for t in terms], dtype=dtype)[None, :], keep.shape)
    flat = keep.ravel()
    return (np.repeat(row, keep.sum(axis=1)), cols.ravel()[flat], vals.ravel()[flat],
            n)
