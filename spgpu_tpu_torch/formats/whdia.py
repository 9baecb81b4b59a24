"""WHDIA (windowed hacked DIA) layout as a dataclass of torch tensors.

Counterpart of :class:`spgpu_tpu.formats.whdia.WhdiaMatrix`; the arrays
are the same, cell for cell.  Rows are hacked by 128; each hack stores
only its own occupied diagonals, one slot (128 lanes) per (hack,
diagonal).  A tile is 8 slots of one hack.  For slot ``s`` of tile
``t = s // 8`` and lane ``j``:

* ``base = tile_page[t]`` (first x page of the tile's window) and
  ``hh = tile_base[t] >> 16`` (hack within its group);
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

``tile_base`` is the JAX encoding, ``base | hh << 16``, whose 16-bit base
field bounds one layout at 65,536 x pages (about 8.4M columns).  Beside
it every layout carries ``tile_page``, the same base page as a full-width
int32; the kernels and plain versions read the page from ``tile_page``
and only ``hh`` from ``tile_base``.  Within the old bound (every layout
the JAX converter builds) ``tile_page`` equals the base field and is
derived from it when not given; past it the field holds the low 16 bits
only.  :meth:`WhdiaMatrix.check` rejects a ``tile_page`` whose low bits
disagree with the field.

A layout also carries ``hack_slot_ptr`` and ``hack_slots``
(:func:`hack_slot_list`), derived from its values whenever it is built:
the ids of the slots that hold a nonzero, grouped by hack.  The SpMV
kernels of every value type and the fp32 SpMM kernel read only those
slots, so a slab must not be changed in place (``check`` rejects a stale
list).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from spgpu_tpu_torch.core import join_dd, join_plane_fields
from spgpu_tpu_torch.kernels.whdia import whdia_columns, whdia_tile_hacks

__all__ = ["WhdiaMatrix", "from_numpy_fields", "from_numpy_planes",
           "hack_slot_list"]

#: the value types of a slab
VALUE_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)

_TENSORS = ("values", "slot_r0", "tile_r0", "tile_base", "chunk_group",
            "tile_page")


def hack_slot_list(values: torch.Tensor, tile_base: torch.Tensor,
                   chunk_group: torch.Tensor, *, chunk_tiles: int,
                   group_hacks: int, num_groups: int):
    """The live slots of each hack, on ``values``' device:
    ``(hack_slot_ptr, hack_slots)``, both int32.  ``hack_slots`` holds the
    ids of the slots with at least one nonzero value, grouped by hack
    (``num_groups * group_hacks`` of them, each tile's hack as the
    kernels decode it) by a stable sort, so each hack's slots stay in
    tile order and then slot order; hack ``h``'s are
    ``hack_slots[hack_slot_ptr[h]:hack_slot_ptr[h + 1]]``.  A hack's tiles
    need not be contiguous."""
    hacks = num_groups * group_hacks
    live = torch.nonzero((values != 0).any(dim=1)).view(-1)
    hack = whdia_tile_hacks(tile_base, chunk_group, chunk_tiles, group_hacks)[live // 8]
    order = torch.sort(hack, stable=True).indices
    ptr = torch.zeros(hacks + 1, dtype=torch.int64, device=values.device)
    torch.cumsum(torch.bincount(hack, minlength=hacks), 0, out=ptr[1:])
    return ptr.int(), live[order].int()


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
    # (num_tiles,) int32: each tile's full-width base page; None derives it
    # from tile_base's 16-bit field
    tile_page: Optional[torch.Tensor] = None
    # hack_slot_list(...), rebuilt with every layout (None when the arrays
    # are not shaped for it; check() then rejects the layout)
    hack_slot_ptr: Optional[torch.Tensor] = dataclasses.field(default=None, init=False,
                                                              repr=False)
    hack_slots: Optional[torch.Tensor] = dataclasses.field(default=None, init=False,
                                                           repr=False)

    def __post_init__(self) -> None:
        if self.tile_page is None:
            self.tile_page = self.tile_base & 0xFFFF
        if self._listable():
            self.hack_slot_ptr, self.hack_slots = self._derive_hack_slots()

    def _listable(self) -> bool:
        """The arrays are shaped for :func:`hack_slot_list`: whole tiles
        and chunks, one chunk_group entry per chunk, on one device, and
        every tile's hack in range."""
        v, tb, cg, ct = self.values, self.tile_base, self.chunk_group, self.chunk_tiles
        if not (v.dim() == 2 and v.shape[1] == 128 and v.shape[0] % 8 == 0
                and ct > 0 and tb.shape == (v.shape[0] // 8,) and tb.shape[0] % ct == 0
                and cg.shape == (tb.shape[0] // ct,)
                and tb.device == v.device and cg.device == v.device):
            return False
        hh = tb >> 16
        return bool(((cg >= 0) & (cg < self.num_groups)).all()
                    and ((hh >= 0) & (hh < self.group_hacks)).all())

    def _derive_hack_slots(self, device=None):
        t = [getattr(self, f) if device is None else getattr(self, f).to(device)
             for f in ("values", "tile_base", "chunk_group")]
        return hack_slot_list(*t, chunk_tiles=self.chunk_tiles,
                              group_hacks=self.group_hacks, num_groups=self.num_groups)

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
        t = [None if getattr(self, f) is None else getattr(self, f).cpu()
             for f in ("slot_r0", "tile_r0", "tile_base", "chunk_group", "tile_page")]
        hack = whdia_tile_hacks(t[2], t[3], self.chunk_tiles, self.group_hacks)
        row = hack.repeat_interleave(8)[:, None] * 128 + torch.arange(128)
        col = whdia_columns(t[0], t[1], t[2], tile_page=t[4]).reshape(-1, 128)
        return vals, row.numpy(), col.numpy()

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
                  ("tile_base", (T,), torch.int32), ("tile_page", (T,), torch.int32),
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
        meta = self.tile_base.cpu().long()
        hh = meta >> 16
        want(bool(((hh >= 0) & (hh < gh)).all()), "hack-in-group range")
        tp = self.tile_page.cpu().long()
        want(bool((tp >= 0).all()), "negative tile_page")
        want(torch.equal(tp & 0xFFFF, meta & 0xFFFF),
             "tile_page disagrees with tile_base's low field")
        vals, row, col = self._cells()
        nz = vals != 0
        want(bool((row[nz] < self.n_rows).all()), "a nonzero cell past n_rows")
        want(bool(((col[nz] >= 0) & (col[nz] < self.n_cols)).all()),
             "a nonzero cell outside [0, n_cols)")
        ptr, slots = self.hack_slot_ptr, self.hack_slots
        want(ptr is not None and slots is not None
             and ptr.dtype == torch.int32 and slots.dtype == torch.int32
             and ptr.device == self.device and slots.device == self.device,
             "hack_slot_ptr/hack_slots missing, or of another type or device")
        want_ptr, want_slots = self._derive_hack_slots("cpu")
        want(torch.equal(ptr.cpu(), want_ptr) and torch.equal(slots.cpu(), want_slots),
             "hack_slots does not match the values (changed in place?)")


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
