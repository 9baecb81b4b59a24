"""The DIA and SDIA (static-offset DIA) layouts as dataclasses of torch
tensors.

:class:`DiaMatrix` is the counterpart of
:class:`spgpu_tpu.formats.dia.DiaMatrix`, the same arrays cell for cell:
``values`` is ``(diags_p, rows_p)``, diagonal-major with rows padded to
128 and diagonals to the type's slot multiple, so ``A[i, i + offsets[j]]``
lives at ``values[j, i]``; offsets ascend (``dia.c:76-85``) and a padding
diagonal has offset ``n_cols``.  Its product needs no column index: each
diagonal reads a shifted x, bound-checked (``dia_spmv_base_template.cuh:
133-135``).

:class:`SdiaMatrix` is the counterpart of
:class:`spgpu_tpu.formats.dia.SdiaMatrix`; the arrays are the same, cell
for cell.  ``values`` is ``(n_diags, n_tiles*8, 128)``:
plane ``j`` holds diagonal ``offsets[j]`` with row ``r`` at flat index
``r`` (tiles of 1024 rows), so ``A[r, r + offsets[j]] = values[j].flat[r]``.
Offsets ascend; cells whose column falls outside ``[0, n_cols)`` are 0.

The JAX kernel compiles the offsets into the program.  The CUDA kernel
reads them from ``offset_table``, a small int32 copy on the device that it
stages through shared memory, as spGPU's DIA kernel stages its offset
list (``dia_spmv_base_template.cuh:35-49``).  ``offsets`` stays a tuple
of Python ints for the host side.  Values are float32, float64,
complex64 or complex128: where the JAX package keeps float64 planes as
double-float pairs (``values`` hi, ``values_lo`` lo), the port keeps one
float64 array, and where it keeps a complex matrix as two real-plane
layouts (``ComplexPlanes``: ``ar``, ``ai``), the port keeps one complex
array (interleaved re/im).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spgpu_tpu_torch.core import join_dd, join_plane_fields
from spgpu_tpu_torch.formats._fields import bridge, host, nbytes, to_device

__all__ = ["DiaMatrix", "SdiaMatrix", "from_numpy_dia", "from_numpy_fields",
           "from_numpy_planes"]

#: the value types of the planes
VALUE_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)


@dataclasses.dataclass
class DiaMatrix:
    values: torch.Tensor  # (diags_p, rows_p)
    offsets: torch.Tensor  # (diags_p,) int32, ascending; padding n_cols
    n_rows: int
    n_cols: int
    n_diags: int

    _TENSORS = ("values", "offsets")

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
    def diags_padded(self) -> int:
        return self.values.shape[0]

    @property
    def storage_bytes(self) -> int:
        return nbytes(self.values, self.offsets)

    def to(self, device) -> "DiaMatrix":
        """A copy with every tensor on ``device``."""
        return to_device(self, device, self._TENSORS)

    def to_dense(self) -> np.ndarray:
        """Host densification (testing helper)."""
        vals, offs = host(self.values), host(self.offsets)
        out = np.zeros((self.n_rows, self.n_cols), dtype=vals.dtype)
        rows = np.arange(self.n_rows)
        for j in range(self.n_diags):
            cols = rows + offs[j]
            sel = (cols >= 0) & (cols < self.n_cols)
            out[rows[sel], cols[sel]] = vals[j, : self.n_rows][sel]
        return out


def from_numpy_dia(**fields) -> DiaMatrix:
    """The port's :class:`DiaMatrix` from a JAX ``DiaMatrix``'s fields by
    name (arrays as NumPy), on the CPU."""
    return bridge(DiaMatrix, fields)


@dataclasses.dataclass
class SdiaMatrix:
    values: torch.Tensor  # (max(n_diags, 1), n_tiles*8, 128), one of VALUE_DTYPES
    offset_table: torch.Tensor  # (n_diags,) int32, the offsets on the device
    offsets: tuple  # ascending Python ints
    n_rows: int
    n_cols: int

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def n_diags(self) -> int:
        return len(self.offsets)

    @property
    def n_tiles(self) -> int:
        return self.values.shape[1] // 8

    def to(self, device) -> "SdiaMatrix":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(self, values=self.values.to(device),
                                   offset_table=self.offset_table.to(device))

    def to_dense(self) -> np.ndarray:
        """Host densification (testing helper)."""
        vals = self.values.detach().cpu().numpy().reshape(self.values.shape[0], -1)
        out = np.zeros((self.n_rows, self.n_cols), dtype=vals.dtype)
        rows = np.arange(self.n_rows)
        for j, off in enumerate(self.offsets):
            cols = rows + off
            sel = (cols >= 0) & (cols < self.n_cols)
            out[rows[sel], cols[sel]] = vals[j, : self.n_rows][sel]
        return out

    def check(self) -> None:
        """Validate shapes, dtypes and the offset table; raises
        ``ValueError``."""
        nd = self.n_diags
        v = self.values

        def want(cond, msg):
            if not cond:
                raise ValueError(f"invalid SdiaMatrix: {msg}")

        want(v.dtype in VALUE_DTYPES, f"values dtype {v.dtype}")
        want(v.dim() == 3 and v.shape[0] == max(nd, 1) and v.shape[2] == 128
             and v.shape[1] % 8 == 0, f"values shape {tuple(v.shape)}")
        want(v.shape[1] * 128 >= self.n_rows, "values planes shorter than n_rows")
        want(self.offset_table.dtype == torch.int32
             and tuple(self.offset_table.shape) == (nd,), "offset_table")
        want(self.offset_table.device == v.device, "offset_table device")
        want(self.offset_table.cpu().tolist() == list(self.offsets),
             "offset_table differs from offsets")
        want(all(a < b for a, b in zip(self.offsets, self.offsets[1:])),
             "offsets must ascend")


def make(values, offsets, n_rows: int, n_cols: int) -> SdiaMatrix:
    """An :class:`SdiaMatrix` on the CPU from planes (a NumPy array or a
    tensor of one of ``VALUE_DTYPES``) and offsets."""
    offsets = tuple(int(o) for o in offsets)
    return SdiaMatrix(
        values=torch.as_tensor(values).contiguous(),
        offset_table=torch.tensor(offsets, dtype=torch.int32),
        offsets=offsets, n_rows=int(n_rows), n_cols=int(n_cols))


def from_numpy_fields(values: np.ndarray, offsets, n_rows: int, n_cols: int,
                      values_lo=None) -> SdiaMatrix:
    """Build the port's :class:`SdiaMatrix` from a JAX ``SdiaMatrix``'s
    fields (``np.asarray(a.values)``, ``a.offsets``, shape, ``values_lo``).

    Double-float planes join into float64, ``values + values_lo``.  The
    result lies on the CPU and has passed :meth:`SdiaMatrix.check`; move
    it with :meth:`SdiaMatrix.to`."""
    values = torch.from_numpy(np.array(values))
    if values_lo is not None:
        values = join_dd(values, torch.from_numpy(np.array(values_lo)))
    a = make(values, offsets, n_rows, n_cols)
    a.check()
    return a


def from_numpy_planes(ar: dict, ai: dict, n_rows: int, n_cols: int) -> SdiaMatrix:
    """Build one complex :class:`SdiaMatrix` from a JAX ``ComplexPlanes``
    of SDIA planes: ``ar`` and ``ai`` hold each plane's ``values``,
    ``values_lo`` (None unless double-float) and ``offsets``.

    The two planes must have the same offsets (raises ``ValueError``
    otherwise); the values are ``ar + i·ai``, complex64 from fp32 planes
    and complex128 from double-float ones."""
    values = join_plane_fields(ar, ai, ("offsets",), "SDIA")
    a = make(values, ar["offsets"], n_rows, n_cols)
    a.check()
    return a
