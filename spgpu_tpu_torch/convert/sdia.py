"""COO → SDIA (static-offset DIA, the stencil-matrix layout), host NumPy.

Counterpart of :func:`spgpu_tpu.convert.sdia.coo_to_sdia` for float32,
float64, complex64 and complex128 values: the same diagonal discovery
and tiling, so float32 planes are bit-identical to the JAX converter's,
float64 planes hold the COO's values where the JAX converter splits them
into a double-float pair, and complex planes hold the COO's complex
values where the JAX converter builds two real-plane layouts of the same
offsets (``ComplexPlanes``).  ``dia_to_sdia`` waits for the
classic DIA format (ROADMAP module item 11).
"""

from __future__ import annotations

import numpy as np

from spgpu_tpu_torch.core import value_dtype
from spgpu_tpu_torch.formats.coo import CooMatrix
from spgpu_tpu_torch.formats.dia import SdiaMatrix, make

__all__ = ["coo_to_sdia"]


def coo_to_sdia(coo: CooMatrix, *, device) -> SdiaMatrix:
    """COO → :class:`SdiaMatrix` on ``device``.

    Diagonals ascend by offset (``dia.c:40-104``); duplicate coordinates
    keep the last write (coalesce with ``sum_duplicates()`` first if they
    should add).  Planes hold tiles of 1024 rows, rounded up to a
    multiple of 16 tiles as in the JAX layout."""
    dt = value_dtype(coo.values.dtype, "SDIA")
    n_tiles = -(-max(1, -(-coo.n_rows // 1024)) // 16) * 16
    if coo.nnz == 0:
        return make(np.zeros((1, n_tiles * 8, 128), dt), (),
                    coo.n_rows, coo.n_cols).to(device)
    offs_all = coo.cols - coo.rows
    uniq = np.unique(offs_all)
    planes = np.zeros((uniq.size, n_tiles * 1024), dtype=dt)
    planes[np.searchsorted(uniq, offs_all), coo.rows] = coo.values
    return make(planes.reshape(uniq.size, n_tiles * 8, 128), uniq,
                coo.n_rows, coo.n_cols).to(device)
