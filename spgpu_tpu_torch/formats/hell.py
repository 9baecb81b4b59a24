"""HELL (hacked ELLpack) as a dataclass of torch tensors.

Counterpart of :class:`spgpu_tpu.formats.hell.HellMatrix`; the arrays are
the same, cell for cell.  Rows are grouped into hacks of ``hack_size``
(128 by default) rows, each stored as its own small ELL padded only to
its own widest row (``hell.h:26-59``, ``hell.c:46-104``).  ``values`` and
``col_indices`` are ``(total_slots, hack_size)``; hack ``h`` owns slots
``hack_offsets[h]:hack_offsets[h + 1]`` (a prefix sum with its sentinel:
``hack_offsets[-1] == total_slots``), each hack's slot count a multiple
of the type's slot multiple, and element (row ``i``, slot ``k``) lives at
``values[hack_offsets[i // hack_size] + k, i % hack_size]``.
``slot_to_hack`` names each slot's hack.  Padding cells hold value 0 and
column 0.  ``row_perm`` (hacked OELL) maps each stored row to its
original row.  Values are float32, float64, complex64 or complex128.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from spgpu_tpu_torch.formats._fields import bridge, host, nbytes, to_device

__all__ = ["HellMatrix", "from_numpy_fields"]


@dataclasses.dataclass
class HellMatrix:
    values: torch.Tensor  # (total_slots, hack_size)
    col_indices: torch.Tensor  # (total_slots, hack_size) int32, padding 0
    hack_offsets: torch.Tensor  # (num_hacks + 1,) int32 prefix sum of slot counts
    slot_to_hack: torch.Tensor  # (total_slots,) int32
    row_lengths: Optional[torch.Tensor]  # (rows_p,) int32
    row_perm: Optional[torch.Tensor]  # (rows_p,) int32 (hacked OELL)
    n_rows: int
    n_cols: int
    hack_size: int
    total_slots: int
    max_hack_width: int
    avg_nnz_per_row: float

    _TENSORS = ("values", "col_indices", "hack_offsets", "slot_to_hack",
                "row_lengths", "row_perm")

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
    def num_hacks(self) -> int:
        return int(self.hack_offsets.shape[0]) - 1

    @property
    def rows_padded(self) -> int:
        return self.num_hacks * self.hack_size

    @property
    def storage_bytes(self) -> int:
        return nbytes(*(getattr(self, n) for n in self._TENSORS))

    def to(self, device) -> "HellMatrix":
        """A copy with every tensor on ``device``."""
        return to_device(self, device, self._TENSORS)

    def to_dense(self) -> np.ndarray:
        """Host densification (testing helper; duplicates add)."""
        vals, cols, s2h = host(self.values), host(self.col_indices), host(self.slot_to_hack)
        out = np.zeros((self.n_rows, self.n_cols), dtype=vals.dtype)
        stored = s2h[:, None] * self.hack_size + np.arange(self.hack_size)[None, :]
        out_row = host(self.row_perm)[stored] if self.row_perm is not None else stored
        # padding cells hold (0, 0) and add nothing; the mask also drops the
        # last hack's rows past n_rows
        valid = ((vals != 0) | (cols != 0)) & (out_row < self.n_rows)
        np.add.at(out, (out_row[valid], cols[valid]), vals[valid])
        return out


def from_numpy_fields(**fields) -> HellMatrix:
    """The port's :class:`HellMatrix` from a JAX ``HellMatrix``'s fields
    by name (arrays as NumPy, None where absent), on the CPU."""
    return bridge(HellMatrix, fields)
