"""HDIA (hacked DIA) as a dataclass of torch tensors.

Counterpart of :class:`spgpu_tpu.formats.hdia.HdiaMatrix`; the arrays are
the same, cell for cell.  Rows are grouped into hacks of ``hack_size``
rows, and each hack stores only its own occupied diagonals
(``hdia.h:21-49``, ``hdia.cpp:68-153``).  ``values`` is ``(total_slots,
hack_size)``; hack ``h`` owns slots ``hack_offsets[h]:hack_offsets[h +
1]`` (a prefix sum with its sentinel), and slot ``s`` holds the diagonal
of global offset ``offsets[s] = col - row`` on its hack's rows:
``A[i, i + offsets[s]]`` at ``values[s, i % hack_size]``.  A padding slot
has offset ``n_cols`` and zero values.  As in the JAX layout, the offset
is the global ``col - row`` where spGPU keys a hack's diagonals from its
first row: the same grouping, a different integer.  Values are float32,
float64, complex64 or complex128.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spgpu_tpu_torch.formats._fields import bridge, host, nbytes, to_device

__all__ = ["HdiaMatrix", "from_numpy_fields"]


@dataclasses.dataclass
class HdiaMatrix:
    values: torch.Tensor  # (total_slots, hack_size)
    offsets: torch.Tensor  # (total_slots,) int32 global col - row; padding n_cols
    hack_offsets: torch.Tensor  # (num_hacks + 1,) int32 prefix sum
    slot_to_hack: torch.Tensor  # (total_slots,) int32
    n_rows: int
    n_cols: int
    hack_size: int
    total_slots: int
    max_hack_diags: int

    _TENSORS = ("values", "offsets", "hack_offsets", "slot_to_hack")

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

    def to(self, device) -> "HdiaMatrix":
        """A copy with every tensor on ``device``."""
        return to_device(self, device, self._TENSORS)

    def to_dense(self) -> np.ndarray:
        """Host densification (testing helper; a cell's last store wins)."""
        vals, offs, s2h = host(self.values), host(self.offsets), host(self.slot_to_hack)
        out = np.zeros((self.n_rows, self.n_cols), dtype=vals.dtype)
        lane = np.arange(self.hack_size)
        for s in np.flatnonzero(offs != self.n_cols):  # padding slots skipped
            rows = s2h[s] * self.hack_size + lane
            cols = rows + offs[s]
            sel = (rows < self.n_rows) & (cols >= 0) & (cols < self.n_cols)
            out[rows[sel], cols[sel]] = vals[s][sel]
        return out


def from_numpy_fields(**fields) -> HdiaMatrix:
    """The port's :class:`HdiaMatrix` from a JAX ``HdiaMatrix``'s fields
    by name (arrays as NumPy), on the CPU."""
    return bridge(HdiaMatrix, fields)
