"""ELLpack (ELL) and ordered ELL (OELL) as a dataclass of torch tensors.

Counterpart of :class:`spgpu_tpu.formats.ell.EllMatrix`; the arrays are
the same, cell for cell.  ``values`` and ``col_indices`` are slot-major,
``(width_p, rows_p)``: element (row ``i``, slot ``k``) lives at
``values[k, i]``, rows padded to 128 and slots to the type's slot
multiple (:func:`~spgpu_tpu_torch.core.sublanes`).  Padding cells hold
value 0 and column 0, so a product over every slot adds nothing for
them.  ``row_lengths`` is None in spGPU's "noRs" mode (every row taken
as ``max_nnz_per_row`` long), and ``row_perm`` (OELL) maps each stored
row to its original row (``ell.c:161-202``).  Values are float32,
float64, complex64 or complex128.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from spgpu_tpu_torch.formats._fields import bridge, host, nbytes, to_device

__all__ = ["EllMatrix", "from_numpy_fields"]


@dataclasses.dataclass
class EllMatrix:
    values: torch.Tensor  # (width_p, rows_p) slot-major
    col_indices: torch.Tensor  # (width_p, rows_p) int32, padding 0
    row_lengths: Optional[torch.Tensor]  # (rows_p,) int32, None in noRs mode
    row_perm: Optional[torch.Tensor]  # (rows_p,) int32: OELL stored -> original
    n_rows: int
    n_cols: int
    max_nnz_per_row: int
    #: rounded average nnz a row, spGPU's kernel-variant selector
    avg_nnz_per_row: float

    _TENSORS = ("values", "col_indices", "row_lengths", "row_perm")

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def rows_padded(self) -> int:
        return self.values.shape[1]

    @property
    def width_padded(self) -> int:
        return self.values.shape[0]

    @property
    def is_ordered(self) -> bool:
        """True for OELL (a row permutation is present)."""
        return self.row_perm is not None

    @property
    def storage_bytes(self) -> int:
        return nbytes(*(getattr(self, n) for n in self._TENSORS))

    def to(self, device) -> "EllMatrix":
        """A copy with every tensor on ``device``."""
        return to_device(self, device, self._TENSORS)

    def to_dense(self) -> np.ndarray:
        """Host densification (testing helper; duplicates add)."""
        vals, cols = host(self.values), host(self.col_indices)
        out = np.zeros((self.n_rows, self.n_cols), dtype=vals.dtype)
        rows_p = vals.shape[1]
        lens = (host(self.row_lengths) if self.row_lengths is not None
                else np.full((rows_p,), self.max_nnz_per_row, dtype=np.int32))
        mask = np.arange(vals.shape[0])[:, None] < lens[None, :]
        stored = np.broadcast_to(np.arange(rows_p)[None, :], vals.shape)
        out_row = host(self.row_perm)[stored] if self.row_perm is not None else stored
        valid = mask & (out_row < self.n_rows)
        np.add.at(out, (out_row[valid], cols[valid]), vals[valid])
        return out


def from_numpy_fields(**fields) -> EllMatrix:
    """The port's :class:`EllMatrix` from a JAX ``EllMatrix``'s fields by
    name (arrays as NumPy, ``row_lengths``/``row_perm`` None where
    absent), on the CPU."""
    return bridge(EllMatrix, fields)
