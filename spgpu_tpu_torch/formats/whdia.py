"""WHDIA (windowed hacked DIA) layout as a dataclass of torch tensors.

Counterpart of :class:`spgpu_tpu.formats.whdia.WhdiaMatrix`; the arrays
are the same, cell for cell.  Rows are hacked by 128; each hack stores
only its own occupied diagonals, one slot (128 lanes) per (hack,
diagonal).  A tile is 8 slots of one hack.  For slot ``s`` of tile
``t = s // 8`` and lane ``j``:

* ``base = tile_base[t] & 0xFFFF`` (first x page of the tile's window)
  and ``hh = tile_base[t] >> 16`` (hack within its group);
* ``r0`` per slot: ``slot_r0[s]`` (slab mode), or in pattern mode the
  packed ``tile_r0[t] = (step+4096) << 19 | (F-1) << 16 | (r00+1024)``
  gives ``r0 = r00 + step*min(s % 8, F-1)``;
* the cell holds ``A[row, col]`` with ``row = hack*128 + j``,
  ``hack = chunk_group[t // chunk_tiles]*group_hacks + hh`` and
  ``col = base*128 + r0 + j``.

The output index ``hack*128 + j`` is the row itself, so vectors stay in
the original numbering.  Cells whose column leaves ``[0, n_cols)`` (the
ends of a diagonal, dead slots) hold 0.

The JAX layout replicates ``slot_r0`` across the 128 lanes, a TPU
vector-operand device; here ``slot_r0`` holds one int16 per slot.
Values are float32, float64, complex64 or complex128: where the JAX
package keeps a float64 slab as a double-float pair (``values`` hi,
``values_lo`` lo), the port keeps one float64 slab, and where it keeps a
complex matrix as two real-plane layouts of one structure
(``ComplexPlanes``: ``ar``, ``ai``), the port keeps one complex slab
(interleaved re/im).  The row-blocked ``BlockedWhdia`` is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from spgpu_tpu_torch.core import join_dd, join_plane_fields

__all__ = ["WhdiaMatrix", "from_numpy_fields", "from_numpy_planes"]

#: the value types of a slab
VALUE_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)

_TENSORS = ("values", "slot_r0", "tile_r0", "tile_base", "chunk_group")


@dataclasses.dataclass
class WhdiaMatrix:
    values: torch.Tensor  # (total_slots, 128), one of VALUE_DTYPES
    slot_r0: Optional[torch.Tensor]  # (total_slots,) int16; None in pattern mode
    tile_r0: Optional[torch.Tensor]  # (num_tiles,) int32 packed; pattern mode only
    tile_base: torch.Tensor  # (num_tiles,) int32: base page | hh << 16
    chunk_group: torch.Tensor  # (num_tiles // chunk_tiles,) int32
    n_rows: int
    n_cols: int
    num_hacks: int
    num_groups: int
    total_slots: int
    nnz: int
    x_pages: int
    window_pages: int
    group_hacks: int
    chunk_tiles: int

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def num_tiles(self) -> int:
        return self.total_slots // 8

    @property
    def pattern_mode(self) -> bool:
        return self.tile_r0 is not None

    def to(self, device) -> "WhdiaMatrix":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f: None if getattr(self, f) is None else getattr(self, f).to(device)
            for f in _TENSORS})

    def slot_r0_host(self) -> np.ndarray:
        """Per-slot r0 ``(total_slots,)`` int64, from the slab or decoded
        from the pattern-mode words."""
        if self.slot_r0 is not None:
            return self.slot_r0.cpu().numpy().astype(np.int64)
        w = self.tile_r0.cpu().numpy().view(np.uint32).astype(np.int64)
        r00 = (w & 0xFFFF) - 1024
        f1 = (w >> 16) & 0x7
        step = ((w >> 19) & 0x1FFF) - 4096
        s = np.arange(8)[None, :]
        return (r00[:, None] + step[:, None] * np.minimum(s, f1[:, None])).reshape(-1)

    def _cells(self):
        """(values, row, col) of every cell, host int64 (row/col may be
        out of range for zero cells)."""
        vals = self.values.detach().cpu().numpy()
        r0 = self.slot_r0_host()
        meta = self.tile_base.cpu().numpy().astype(np.int64)
        cg = self.chunk_group.cpu().numpy().astype(np.int64)
        t = np.arange(self.total_slots) // 8
        hack = cg[t // self.chunk_tiles] * self.group_hacks + (meta >> 16)[t]
        lane = np.arange(128)[None, :]
        row = hack[:, None] * 128 + lane
        col = ((meta & 0xFFFF)[t] * 128 + r0)[:, None] + lane
        return vals, row, col

    def to_dense(self) -> np.ndarray:
        """Host densification (testing helper).  Plain stores, slot by
        slot: a repeated cell keeps the last write, as in ``coo2dia``."""
        vals, row, col = self._cells()
        ok = (vals != 0) & (row < self.n_rows) & (col >= 0) & (col < self.n_cols)
        out = np.zeros((self.n_rows, self.n_cols), dtype=vals.dtype)
        s, j = np.nonzero(ok)  # slot-major order: later slots write last
        out[row[s, j], col[s, j]] = vals[s, j]
        return out

    def check(self) -> None:
        """Validate shapes, dtypes and index ranges once, on the host, so
        the kernel can trust every decoded hack; raises ``ValueError``.
        Every nonzero cell must decode to a row below ``n_rows`` and a
        column in ``[0, n_cols)``."""
        T, S, ct, gh = self.num_tiles, self.total_slots, self.chunk_tiles, self.group_hacks

        def want(cond, msg):
            if not cond:
                raise ValueError(f"invalid WhdiaMatrix: {msg}")

        want((self.slot_r0 is None) != (self.tile_r0 is None),
             "exactly one of slot_r0 (slab mode) and tile_r0 (pattern mode)")
        want(ct > 0 and gh > 0 and S % 8 == 0 and T % ct == 0,
             "slots must fill whole chunks")
        want(self.values.dtype in VALUE_DTYPES, f"values dtype {self.values.dtype}")
        shapes = [("values", (S, 128), self.values.dtype),
                  ("tile_base", (T,), torch.int32),
                  ("chunk_group", (T // ct,), torch.int32)]
        shapes.append(("tile_r0", (T,), torch.int32) if self.pattern_mode
                      else ("slot_r0", (S,), torch.int16))
        for name, shape, dt in shapes:
            t = getattr(self, name)
            want(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
            want(t.dtype == dt, f"{name} dtype {t.dtype}")
            want(t.device == self.device, f"{name} on {t.device}")
        want(self.num_groups * gh * 128 >= self.n_rows, "row space size")
        cg = self.chunk_group.cpu().numpy()
        want(bool(((cg >= 0) & (cg < self.num_groups)).all()), "chunk_group range")
        hh = self.tile_base.cpu().numpy().astype(np.int64) >> 16
        want(bool(((hh >= 0) & (hh < gh)).all()), "hack-in-group range")
        vals, row, col = self._cells()
        nz = vals != 0
        want(bool((row[nz] < self.n_rows).all()), "a nonzero cell past n_rows")
        want(bool(((col[nz] >= 0) & (col[nz] < self.n_cols)).all()),
             "a nonzero cell outside [0, n_cols)")


def _layout(fields: dict, values: torch.Tensor, static: dict) -> WhdiaMatrix:
    """A checked :class:`WhdiaMatrix` on the CPU from JAX array fields,
    with ``values`` as its slab."""
    arrays = dict(fields)
    if arrays.get("slot_r0") is not None:
        arrays["slot_r0"] = np.asarray(arrays["slot_r0"])[:, 0]
    kw = {f: None if arrays.get(f) is None else torch.from_numpy(np.array(arrays[f]))
          for f in _TENSORS[1:]}
    kw["values"] = values
    names = {f.name for f in dataclasses.fields(WhdiaMatrix)}
    kw.update({k: int(v) for k, v in static.items() if k in names})
    a = WhdiaMatrix(**kw)
    a.check()
    return a


def from_numpy_fields(fields: dict, **static) -> WhdiaMatrix:
    """Build the port's :class:`WhdiaMatrix` from the array fields of a
    JAX ``WhdiaMatrix`` (``np.asarray`` of each) and its static fields.

    The lane-replicated ``slot_r0`` slab crosses as its first lane, and a
    double-float slab joins into float64, ``values + values_lo``.  The
    result lies on the CPU and has passed :meth:`WhdiaMatrix.check`; move
    it with :meth:`WhdiaMatrix.to`."""
    values = torch.from_numpy(np.array(fields["values"]))
    if fields.get("values_lo") is not None:
        values = join_dd(values, torch.from_numpy(np.array(fields["values_lo"])))
    return _layout(fields, values, static)


def from_numpy_planes(ar: dict, ai: dict, **static) -> WhdiaMatrix:
    """Build one complex :class:`WhdiaMatrix` from the array fields of a
    JAX ``ComplexPlanes`` of WHDIA planes (``ar``: real parts, ``ai``:
    imaginary parts, each as for :func:`from_numpy_fields`) and the
    planes' static fields.

    The planes must share every structural array, bit for bit (raises
    ``ValueError`` otherwise); the slab is ``ar.values + i·ai.values``,
    complex64 from fp32 planes and complex128 from double-float ones."""
    return _layout(ar, join_plane_fields(ar, ai, _TENSORS[1:], "WHDIA"), static)
