"""COO (coordinate) format — the universal ingestion format.

A copy of :mod:`spgpu_tpu.formats.coo` (pure NumPy), carried so the
PyTorch port never imports the JAX package.  spGPU consumes host-side COO
triple arrays in every ``cooTo*`` conversion (``ell.c:39-80`` etc.) and
supports a Fortran-style ``baseIndex`` on all index arrays
(``ell.h:44``).  We normalise to 0-based indices at construction and keep
the matrix on host (NumPy) — conversions are host-side in spGPU too.

Duplicate policy: duplicates are *kept* as separate entries, matching
``cooToEll`` (``ell.c:65-78``) where a duplicated coordinate occupies two
ELL slots and both contribute to SpMV.  Use :meth:`sum_duplicates` to opt
out.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CooMatrix:
    """Host-side COO triples, always 0-based internally."""

    rows: np.ndarray  # (nnz,) int
    cols: np.ndarray  # (nnz,) int
    values: np.ndarray  # (nnz,) any supported dtype
    n_rows: int
    n_cols: int

    @classmethod
    def from_arrays(
        cls,
        rows,
        cols,
        values,
        n_rows: int,
        n_cols: int,
        base_index: int = 0,
    ) -> "CooMatrix":
        """Build from possibly 1-based triples (``baseIndex`` parity)."""
        rows = np.asarray(rows, dtype=np.int64) - base_index
        cols = np.asarray(cols, dtype=np.int64) - base_index
        values = np.asarray(values)
        if rows.size:
            if rows.min() < 0 or rows.max() >= n_rows:
                raise ValueError("row index out of range")
            if cols.min() < 0 or cols.max() >= n_cols:
                raise ValueError("col index out of range")
        return cls(rows, cols, values, int(n_rows), int(n_cols))

    @property
    def nnz(self) -> int:
        return int(self.rows.size)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    def sum_duplicates(self) -> "CooMatrix":
        """Coalesce duplicate coordinates by summation (not the reference
        default — see module docstring).  Entries come out in (row, col)
        order; a COO already in that order without duplicates is copied
        without a sort."""
        key = self.rows * self.n_cols + self.cols
        if key.size and bool(np.all(key[1:] > key[:-1])):
            order = slice(None)
        else:
            order = np.argsort(key, kind="stable")
        key_s = key[order]
        first = np.flatnonzero(np.r_[True, key_s[1:] != key_s[:-1]]) if key.size else key
        uniq = key_s[first]
        vals = np.add.reduceat(self.values[order], first) if key.size else self.values
        return CooMatrix(
            (uniq // self.n_cols).astype(np.int64),
            (uniq % self.n_cols).astype(np.int64),
            vals,
            self.n_rows,
            self.n_cols,
        )

    def to_dense(self) -> np.ndarray:
        """Dense materialisation (golden-reference helper; duplicates add)."""
        out = np.zeros(self.shape, dtype=self.values.dtype)
        np.add.at(out, (self.rows, self.cols), self.values)
        return out

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """Golden host SpMV ``A @ x`` (duplicates contribute additively,
        matching the reference kernels' treatment of duplicated ELL slots).

        Supports multi-RHS ``x`` of shape ``(..., n_cols)``.
        """
        x = np.asarray(x)
        v = self.values.reshape((-1,) + (1,) * (x.ndim - 1))
        prod = v * np.moveaxis(x, -1, 0)[self.cols]
        out_dtype = np.result_type(self.values.dtype, x.dtype)
        out = np.zeros(x.shape[:-1] + (self.n_rows,), dtype=out_dtype)
        np.add.at(np.moveaxis(out, -1, 0), self.rows, prod)
        return out

    @classmethod
    def from_scipy(cls, m) -> "CooMatrix":
        """Build from any scipy.sparse matrix (kept un-coalesced if the
        input is; scipy coo duplicates survive as separate entries)."""
        c = m.tocoo()
        return cls(
            np.asarray(c.row, dtype=np.int64),
            np.asarray(c.col, dtype=np.int64),
            np.asarray(c.data),
            int(c.shape[0]),
            int(c.shape[1]),
        )

    def to_scipy(self):
        """Export as scipy.sparse.coo_matrix (duplicates preserved)."""
        import scipy.sparse as sp

        return sp.coo_matrix(
            (self.values, (self.rows, self.cols)), shape=self.shape
        )

    def row_lengths(self) -> np.ndarray:
        """Per-row nnz histogram; mirrors ``computeEllRowLenghts``
        (``ell.c:5-31``)."""
        return np.bincount(self.rows, minlength=self.n_rows).astype(np.int32)
