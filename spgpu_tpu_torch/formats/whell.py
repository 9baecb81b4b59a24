"""WHELL layouts as dataclasses of torch tensors: packed, classic and
per-cell routing.

Counterpart of :class:`spgpu_tpu.formats.whell.WhellMatrix` (packed and
classic) and :class:`spgpu_tpu.formats.whell.PcellWhell`; the arrays are
the same, cell for cell (see that module for the layouts).  In short, for
a cell ``(slot s, lane j)`` of tile ``t = s // 8``:

* ``r = residue[s, j]`` and ``d = page_tab[s, r]`` — the page table is
  indexed by RESIDUE, not by lane;
* scattered windows (``group_bases`` set): ``g = tile_page[t]`` (the
  layout group), ``hh = tile_base[t] >> 20`` and
  ``page = group_bases[g*K + (d >> 3)] + (d & 7)`` with
  ``K = window_pages // 8``;
* aligned windows: ``page = tile_page[t] + d`` (the window's base page)
  and ``hh = tile_base[t] >> 16``;
* column ``page*128 + r``; output hack
  ``chunk_group[t // chunk_tiles] * group_hacks + hh``.

The **packed** layout (``seg_lo`` set) gives rows lane segments;
``seg_lo``/``seg_hi`` give each output lane the segment bounds its
prefix-scan difference reads.  Its vectors live in lane space:
:meth:`WhellMatrix.embed` and :meth:`WhellMatrix.extract` map original
vectors in and out.  Its values are float32, bfloat16, float64, complex64
or complex128: where the JAX package keeps a float64 matrix as a
double-float pair (``values`` hi, ``values_lo`` lo), the port keeps one
float64 slab, and where it keeps a complex matrix as two real-plane
layouts of one structure (``WhellComplex``: ``ar``, ``ai``), the port
keeps one layout whose slab is complex (interleaved re/im), so its vectors
are complex too.

The **classic** layout (``seg_lo`` None) works in the original numbering:
output lane ``j`` of hack ``h`` is stored row ``h*128 + j``, aligned
8-page windows, 8-hack groups and 64-tile chunks, and a ``chunk_group``
without the trailing -1 sentinel.  ``row_perm`` (stored row → original
row, padded with the identity) is the OELL order, and ``ways > 1`` splits
each row into ``ways`` virtual rows that the op sums back.  Its values are
float32, bfloat16 or float64 (plain float64, as the JAX classic layout
keeps it: no double-float pair).  A classic layout
also carries ``work_list`` (:func:`classic_work_list`), derived from its
values whenever the layout is built: the (tile, 32-lane quarter) units
that hold a nonzero, each with the mask of its live slots, and, in
float64, aligned with it, ``work_sectors`` (:func:`classic_work_sectors`):
each unit's 32 B value sectors that hold a nonzero, and both lists again
in the SpMM kernel's order, ``spmm_work`` and ``spmm_work_sectors``
(:func:`classic_spmm_order`: by output row block, then tile).  The
kernels read only those units and slots, and in float64 values only in
those sectors, so a slab must not be changed in place
(:func:`spgpu_tpu_torch.convert.whell_update_values` builds a new layout,
and new lists).

The **per-cell routing** layout (:class:`PcellWhell`) packs the cells of
many rows densely into each slot and routes each row's run to its output
lane through ``run_hi``/``run_lo``; it works in the original numbering.
Its values are float32 or float64.  It carries ``hack_tile_ptr``,
``hack_tiles`` (:func:`pcell_hack_tiles`: each output hack's tiles that
route a run) and ``hack_units``, derived whenever the layout is built;
kernel #17 reads only those tiles, so never change a pcell slab in place.
Neither the classic nor the pcell
layout takes complex values: the JAX converters build complex slabs, but
its ops cannot multiply them (the Pallas interpreter refuses the kernels'
complex output), so the port adds no such product
(:func:`unported_complex`).

``tile_base`` is the JAX encoding, ``page | hh << 16`` (aligned) or
``group | hh << 20`` (scattered), whose low field bounds one layout at
65,536 x pages or 2**20 layout groups.  Beside it every layout carries
``tile_page``, the same page or group as a full-width int32, and every
kernel and plain version reads the page or group from ``tile_page`` and
only ``hh`` from ``tile_base``.  Wherever the low field holds the page or
group (any layout the JAX converter can build), ``tile_page`` equals it
and is derived from it when not given; past it the field holds the low
bits only.  :meth:`WhellMatrix.check` (and :meth:`PcellWhell.check`)
reject a ``tile_page`` whose low bits disagree with ``tile_base``'s field,
and a layout whose x pages or layout groups pass :data:`MAX_TILE_PAGE`.
The TPU budget containers (``PanelledWhell``, ``SegmentedWhell``) are not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from spgpu_tpu_torch.core import CHUNK_TILES, join_dd, join_plane_fields

__all__ = ["MAX_TILE_PAGE", "PcellWhell", "WhellMatrix", "classic_spmm_order",
           "classic_work_list", "classic_work_sectors",
           "from_numpy_fields", "from_numpy_pcell", "from_numpy_planes",
           "low_field_bits", "packed_hack_ptr", "packed_hack_units",
           "pcell_hack_tiles", "unported_complex"]

#: the value types of a packed slab
VALUE_DTYPES = (torch.float32, torch.bfloat16, torch.float64, torch.complex64,
                torch.complex128)
#: the value types of a classic slab
CLASSIC_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
#: the value types of a pcell slab
PCELL_DTYPES = (torch.float32, torch.float64)


def unported_complex(what: str, dtype) -> NotImplementedError:
    """The error for a value type the JAX package's ``what`` (classic
    WHELL, pcell) has no product for: its converters build complex slabs,
    but its Pallas interpreter refuses the kernel's complex output
    (``NotImplementedError: complex64`` while it sets the output up), so
    the port adds no such feature."""
    return NotImplementedError(
        f"{what} takes real values, not {dtype}: the JAX package has no "
        f"complex {what} product (its Pallas interpreter refuses the "
        "kernel's complex output), so the port has none either")

#: x pages, and layout groups, that a tile's full-width ``tile_page``
#: word addresses
MAX_TILE_PAGE = (1 << 31) - 1

_TENSORS = ("values", "residue", "page_tab", "tile_base", "chunk_group",
            "seg_lo", "seg_hi", "lane_of_row", "group_bases", "row_perm",
            "tile_page")


def low_field_bits(scattered: bool) -> int:
    """The width of ``tile_base``'s low field: a scattered tile's layout
    group has 20 bits, an aligned window's base page 16 (the JAX
    encoding; ``hh`` sits above it)."""
    return 20 if scattered else 16


def low_field(tile_base: torch.Tensor, scattered: bool) -> torch.Tensor:
    """``tile_base``'s low field, the page or group of every layout the
    JAX converter can build: the ``tile_page`` of such a layout."""
    return tile_base & ((1 << low_field_bits(scattered)) - 1)


def _want(cls: str):
    def want(cond, msg):
        if not cond:
            raise ValueError(f"invalid {cls}: {msg}")
    return want


def _check_arrays(obj, want, specs) -> None:
    """Each ``(name, shape, dtype)`` of ``specs`` (dtype None: any) on
    ``obj``'s device."""
    for name, shape, dt in specs:
        t = getattr(obj, name)
        want(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
        want(dt is None or t.dtype == dt, f"{name} dtype {t.dtype}")
        want(t.device == obj.device, f"{name} on {t.device}")


def _decode_pages(pt, res, tile_page, meta, tile, group_bases, window_pages):
    """Every cell's decoded x page and its tile's hack-in-group (int64,
    on the host): the page or layout group from ``tile_page``, then
    through ``group_bases`` (scattered) or plus the delta (aligned); the
    hack-in-group from ``tile_base`` (``meta``) above its low field."""
    d = torch.gather(pt, 1, res)  # page delta by residue
    scattered = group_bases is not None
    hh = meta >> low_field_bits(scattered)
    if scattered:
        K = window_pages // 8
        return group_bases[tile_page[tile, None] * K + (d >> 3)] + (d & 7), hh
    return tile_page[tile, None] + d, hh


def packed_hack_ptr(tile_base: torch.Tensor, chunk_group: torch.Tensor, *,
                    group_hacks: int, chunk_tiles: int, num_hacks: int,
                    scattered: bool) -> torch.Tensor:
    """The run of tiles of each hack of a packed layout: ``(num_hacks, 2)``
    int32 ``[begin, end)``, on ``tile_base``'s device, derived from the
    tiles' hacks alone.  The converter places each hack's tiles
    contiguously, in hack order within each output group, then pads the
    group to whole chunks with zero tiles whose hack-in-group is 0: a
    group's tiles from its first descent in hack order on are that
    padding and belong to no run (padding behind a last run of
    hack-in-group 0 cannot be told apart and joins that run).  A hack with
    no tiles gets ``[0, 0)``.  :meth:`WhellMatrix.check` verifies that the
    runs hold every nonzero value."""
    dev = tile_base.device
    T = tile_base.numel()
    t = torch.arange(T, device=dev)
    grp = chunk_group.long()[t // chunk_tiles]
    hack = grp * group_hacks + (tile_base.long() >> (20 if scattered else 16))
    first = torch.ones(T, dtype=torch.bool, device=dev)
    first[1:] = grp[1:] != grp[:-1]
    descents = torch.zeros(T, dtype=torch.long, device=dev)
    descents[1:] = (~first[1:] & (hack[1:] < hack[:-1])).long()
    descents = descents.cumsum(0)
    group_start = torch.cummax(torch.where(first, t, 0), 0).values
    live = (descents == descents[group_start]) & (hack < num_hacks)
    lt, lh = t[live], hack[live]  # hack order within and across groups
    count = torch.bincount(lh, minlength=num_hacks)[:num_hacks]
    begin = torch.zeros(num_hacks, dtype=torch.long, device=dev)
    if lt.numel():
        pos = torch.searchsorted(lh, torch.arange(num_hacks, device=dev))
        begin = torch.where(count > 0, lt[pos.clamp(max=lt.numel() - 1)], 0)
    return torch.stack([begin, begin + count], 1).int()


#: tiles of a hack's run that one block of the hack pass sums: a longer
#: run is cut into chunks of this many tiles, summed by as many blocks
RUN_CHUNK_TILES = 16
#: the same for pcell's hack pass (#17), whose 2-warp blocks walk a chunk
#: 2 tiles at a time: 8-tile chunks ran the SPD flagship 15 % faster than
#: 16-tile ones (sweeps/kernel_account.py; NVIDIA H100 80GB HBM3, 700 W)
PCELL_CHUNK_TILES = 8


def packed_hack_units(hack_ptr: torch.Tensor, num_rows: int,
                      chunk_tiles: int = RUN_CHUNK_TILES) -> torch.Tensor:
    """The work units of the hack pass (kernels #4, #12, complex128 and
    #17), one per block: ``(U, 4)`` int32 ``[begin, end, row, chunk]`` on
    ``hack_ptr``'s device, in row order.  Row ``h < num_hacks`` sums its
    run ``hack_ptr[h]`` in one unit when the run has at most
    ``chunk_tiles`` tiles (``chunk`` -1), else in ``k`` units of
    consecutive chunks of the run (``chunk`` ``c << 16 | k`` for the
    ``c``-th); every other output row is one empty unit.  So ``U`` exceeds
    ``num_rows`` exactly when some run is chunked."""
    dev = hack_ptr.device
    H = hack_ptr.shape[0]
    begin = torch.zeros(num_rows, dtype=torch.long, device=dev)
    n = torch.zeros(num_rows, dtype=torch.long, device=dev)
    begin[:H] = hack_ptr[:, 0].long()
    n[:H] = hack_ptr[:, 1].long() - begin[:H]
    k = (-(-n // chunk_tiles)).clamp(min=1)
    row = torch.repeat_interleave(torch.arange(num_rows, device=dev), k)
    c = torch.arange(row.numel(), device=dev) - (torch.cumsum(k, 0) - k)[row]
    b = begin[row] + c * chunk_tiles
    e = torch.minimum(b + chunk_tiles, begin[row] + n[row])
    chunk = torch.where(k[row] > 1, c << 16 | k[row], -1)
    return torch.stack([b, e, row, chunk], 1).int()


def pcell_hack_tiles(run_hi: torch.Tensor, tile_base: torch.Tensor,
                     chunk_group: torch.Tensor, *, chunk_tiles: int,
                     group_hacks: int, num_rows: int) -> tuple:
    """The tiles of each output hack of a pcell layout, on ``run_hi``'s
    device: ``hack_tile_ptr`` ``(num_rows + 1,)`` int32 offsets into
    ``hack_tiles``, int32 tile indices in ascending tile order within each
    hack (hack ``chunk_group[t // chunk_tiles] * group_hacks + (tile_base[t]
    >> 20)``).  Only tiles that route a run (some ``run_hi >= 0``) are
    listed: a tile with none adds exactly 0 to its hack (every output lane
    reads no prefix sum), as the converter's chunk-padding tiles do.  One
    pass over ``run_hi``."""
    dev = run_hi.device
    T = tile_base.numel()
    t = torch.nonzero((run_hi.view(T, -1) >= 0).any(dim=1)).view(-1)
    hack = (chunk_group.long()[t // chunk_tiles] * group_hacks
            + (tile_base.long()[t] >> 20))
    order = torch.sort(hack, stable=True).indices
    ptr = torch.zeros(num_rows + 1, dtype=torch.long, device=dev)
    ptr[1:] = torch.cumsum(torch.bincount(hack, minlength=num_rows)[:num_rows], 0)
    return ptr.int(), t[order].int()


def classic_work_list(values: torch.Tensor) -> torch.Tensor:
    """The live units of a classic slab ``(S, 128)``, on its device: one
    int64 ``(t*4 + q) << 8 | mask`` per (tile ``t``, 32-lane quarter
    ``q``) that holds a nonzero value, in ascending unit order, where bit
    ``s`` of ``mask`` is set when slot ``s`` of the unit holds one.  One
    pass over the values."""
    S = values.shape[0]
    live = (values.view(S // 8, 8, 4, 32) != 0).any(dim=3)  # (tile, slot, q)
    bit = torch.arange(8, device=values.device).view(1, 8, 1)
    mask = (live.long() << bit).sum(dim=1).view(-1)  # per unit t*4 + q
    units = torch.nonzero(mask).view(-1)
    return units << 8 | mask[units]


def classic_work_sectors(values: torch.Tensor,
                         work_list: torch.Tensor) -> torch.Tensor:
    """The live 32 B value sectors of each unit of ``work_list`` (the
    slab's :func:`classic_work_list`), on the values' device: one int64 per
    entry, aligned with it, where bit ``8*s + g`` is set when sector ``g``
    of slot ``s`` of the unit holds a nonzero value.  A unit's 32 lanes of
    a slot are ``32 * itemsize`` bytes, so a slot has ``itemsize`` sectors
    of ``32 // itemsize`` lanes: 8 of 4 lanes in float64, 4 of 8 in fp32,
    2 of 16 in bf16.  Kernel #15 in float64 loads a lane's value only
    where its sector's bit is set; a float64 classic layout keeps the list
    (``WhellMatrix.work_sectors``), an fp32 or bf16 one, whose kernel
    reads whole warp-slots, none."""
    S, n = values.shape[0], values.element_size()
    live = (values.view(S // 8, 8, 4, n, 32 // n) != 0).any(dim=4)  # (tile, s, q, g)
    bit = (8 * torch.arange(8, device=values.device).view(1, 8, 1, 1)
           + torch.arange(n, device=values.device).view(1, 1, 1, n))
    words = (live.long() << bit).sum(dim=(1, 3)).view(-1)  # per unit t*4 + q
    return words[work_list >> 8]


def classic_spmm_order(work_list: torch.Tensor, tile_base: torch.Tensor,
                       chunk_group: torch.Tensor) -> torch.Tensor:
    """The positions of ``work_list``'s entries (a classic layout's
    :func:`classic_work_list`) in kernel #16's order, on its device: by
    output row block (the stored-row hack ``chunk_group[t // 64] * 8 +
    (tile_base[t] >> 16)``, then the quarter), then by tile, so entries
    that add into the same 32 rows of z come one after another and a warp
    that takes several of them adds its sums into z once."""
    t = work_list >> 10
    hack = chunk_group.long()[t // CHUNK_TILES] * 8 + (tile_base.long()[t] >> 16)
    return torch.sort(hack * 4 + (work_list >> 8 & 3), stable=True).indices


def _check_tile_page(want, tile_page, meta, scattered: bool) -> torch.Tensor:
    """``tile_page`` (host int64, returned) is non-negative and agrees
    with ``tile_base``'s (``meta``) low field in its low bits."""
    tp = tile_page.cpu().long()
    mask = (1 << low_field_bits(scattered)) - 1
    want(bool((tp >= 0).all()), "negative tile_page")
    want(torch.equal(tp & mask, meta & mask),
         "tile_page disagrees with tile_base's low field")
    return tp


def _check_groups(want, groups: int, tile_page) -> None:
    """At most :data:`MAX_TILE_PAGE` layout groups, each tile's in range."""
    want(groups <= MAX_TILE_PAGE,
         f"{groups} layout groups, past the {MAX_TILE_PAGE} that tile_page's "
         "31-bit group addresses")
    want(bool((tile_page < groups).all()), "tile group index")


@dataclasses.dataclass
class WhellMatrix:
    # slabs, slot-major (total_slots, 128)
    values: torch.Tensor  # one of VALUE_DTYPES (classic: CLASSIC_DTYPES)
    residue: torch.Tensor  # int8: col % 128 of each cell
    page_tab: torch.Tensor  # int8: window page delta, indexed by residue
    # per-tile and per-chunk scalars
    tile_base: torch.Tensor  # (num_tiles,) int32 packed window | hh
    chunk_group: torch.Tensor  # packed: (num_chunks + 1,) int32, trailing -1;
    #   classic: (num_chunks,), no sentinel
    # packed only: output segments (num_groups * group_hacks, 128) int8
    seg_lo: Optional[torch.Tensor]
    seg_hi: Optional[torch.Tensor]
    lane_of_row: Optional[torch.Tensor]  # (orig_rows,) int32 lane-space coordinate
    group_bases: Optional[torch.Tensor]  # (layout_groups * K,) int32 or None
    n_rows: int  # packed: lane-space size; classic: rows (virtual rows with ways)
    n_cols: int
    num_hacks: int
    num_groups: int
    total_slots: int
    nnz: int
    x_pages: int
    window_pages: int
    orig_rows: int  # packed: original rows; classic: 0, as in the JAX package
    group_hacks: int
    chunk_tiles: int
    unit_segments: bool = False
    # classic only: stored row -> original row, (rows_padded,) int32, or None
    row_perm: Optional[torch.Tensor] = None
    ways: int = 1  # classic only: virtual rows per true row
    # (num_tiles,) int32: each tile's full-width aligned base page or
    # layout group; None derives it from tile_base's low field
    tile_page: Optional[torch.Tensor] = None
    # classic only: classic_work_list(values) and, for float64 values
    # only (the one type whose kernel reads by sector), aligned with it,
    # classic_work_sectors(values, work_list), rebuilt with every layout
    work_list: Optional[torch.Tensor] = dataclasses.field(default=None, init=False,
                                                          repr=False)
    work_sectors: Optional[torch.Tensor] = dataclasses.field(default=None, init=False,
                                                             repr=False)
    # classic only: both lists in classic_spmm_order, kernel #16's, rebuilt
    # with them
    spmm_work: Optional[torch.Tensor] = dataclasses.field(default=None, init=False,
                                                          repr=False)
    spmm_work_sectors: Optional[torch.Tensor] = dataclasses.field(default=None, init=False,
                                                                  repr=False)
    # packed only, rebuilt with every layout: packed_hack_ptr(...) and the
    # hack pass's work units packed_hack_units(hack_ptr, rows); a product
    # keeps no state here (its chunked-run counters are its own), so
    # products of one layout may run at once on several streams
    hack_ptr: Optional[torch.Tensor] = dataclasses.field(default=None, init=False,
                                                         repr=False)
    hack_units: Optional[torch.Tensor] = dataclasses.field(default=None, init=False,
                                                           repr=False)

    def __post_init__(self) -> None:
        if self.tile_page is None:
            self.tile_page = low_field(self.tile_base, self.scattered)
        v = self.values
        if not self.packed and v.dim() == 2 and v.shape[1] == 128 and v.shape[0] % 8 == 0:
            self.work_list = classic_work_list(v)
            order = classic_spmm_order(self.work_list, self.tile_base, self.chunk_group)
            self.spmm_work = self.work_list[order]
            if v.dtype == torch.float64:
                self.work_sectors = classic_work_sectors(v, self.work_list)
                self.spmm_work_sectors = self.work_sectors[order]
        if self.packed and self._whole_chunks():
            self.hack_ptr = self._derive_hack_ptr()
            self.hack_units = packed_hack_units(self.hack_ptr, self.seg_lo.shape[0])

    def _whole_chunks(self) -> bool:
        """The packed tile scalars are shaped for a derivation: whole
        chunks and one chunk_group entry per chunk plus the sentinel."""
        T, ct = self.tile_base.numel(), self.chunk_tiles
        return (ct >= 1 and T % ct == 0 and self.tile_base.dim() == 1
                and self.chunk_group.shape == (T // ct + 1,))

    def _derive_hack_ptr(self, device=None) -> torch.Tensor:
        tb, cg = self.tile_base, self.chunk_group
        if device is not None:
            tb, cg = tb.to(device), cg.to(device)
        return packed_hack_ptr(tb, cg, group_hacks=self.group_hacks,
                               chunk_tiles=self.chunk_tiles,
                               num_hacks=self.num_hacks, scattered=self.scattered)

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def num_tiles(self) -> int:
        return self.total_slots // 8

    @property
    def scattered(self) -> bool:
        return self.group_bases is not None

    @property
    def packed(self) -> bool:
        return self.seg_lo is not None

    @property
    def rows_padded(self) -> int:
        return self.num_groups * self.group_hacks * 128

    def to(self, device) -> "WhellMatrix":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f: None if getattr(self, f) is None else getattr(self, f).to(device)
            for f in _TENSORS})

    def _lane_space(self) -> None:
        if not self.packed:
            raise ValueError("a classic WHELL layout works in the original "
                             "numbering: it has no lane space")

    def embed(self, x, dtype: torch.dtype) -> torch.Tensor:
        """Original-space vector(s) → lane space, as ``dtype``, on the
        matrix's device (phantom coordinates zero).  A complex ``dtype``
        gives the one complex vector that the JAX ``embed_complex`` gives
        as a ``[re, im]`` plane stack.  Packed layouts only."""
        self._lane_space()
        x = torch.as_tensor(x).to(device=self.device, dtype=dtype)
        out = torch.zeros(x.shape[:-1] + (self.n_rows,), dtype=dtype,
                          device=self.device)
        out[..., self.lane_of_row.long()] = x
        return out

    def extract(self, z, dtype: torch.dtype) -> torch.Tensor:
        """Lane-space vector(s) → original space, as ``dtype``.  Packed
        layouts only."""
        self._lane_space()
        z = torch.as_tensor(z).to(device=self.device)
        return z[..., self.lane_of_row.long()].to(dtype)

    def to_dense(self) -> np.ndarray:
        """Host densification (testing helper; duplicates add): in LANE
        space for a packed layout (compare with the original matrix
        embedded in lane space), in the original numbering for a classic
        one (``(n_rows, n_cols)``, virtual rows with ``ways``)."""
        vals = self.values.detach().cpu()
        vals = (vals.float() if vals.dtype == torch.bfloat16 else vals).numpy()
        res = self.residue.cpu().long()
        tile = torch.arange(self.total_slots) // 8
        page, hh = _decode_pages(
            self.page_tab.cpu().long(), res, self.tile_page.cpu().long(),
            self.tile_base.cpu().long(), tile,
            None if self.group_bases is None else self.group_bases.cpu().long(),
            self.window_pages)
        col = (page * 128 + res).numpy()
        cg = self.chunk_group.cpu().numpy().astype(np.int64)
        t = tile.numpy()
        hack = cg[t // self.chunk_tiles] * self.group_hacks + hh.numpy()[t]
        if self.packed:
            lo = self.seg_lo.cpu().numpy().astype(np.int64)
            hi = self.seg_hi.cpu().numpy().astype(np.int64)
            row_of_lane = np.full(lo.shape, -1, dtype=np.int64)
            for hk, j in zip(*np.nonzero(hi >= 0)):
                row_of_lane[hk, lo[hk, j] + 1: hi[hk, j] + 1] = hk * 128 + j
            row = row_of_lane[hack]
        else:
            row = hack[:, None] * 128 + np.arange(128)
            if self.row_perm is not None:
                row = self.row_perm.cpu().numpy().astype(np.int64)[row]
        ok = (vals != 0) & (row >= 0) & (row < self.n_rows) & (col < self.n_cols)
        out = np.zeros((self.n_rows, self.n_cols), dtype=vals.dtype)
        np.add.at(out, (row[ok], col[ok]), vals[ok])
        return out

    def check(self) -> None:
        """Validate shapes, dtypes and index ranges once, on the host, so
        the kernel can trust every decoded page and hack; raises
        ``ValueError``."""
        T, S, R = self.num_tiles, self.total_slots, self.num_groups * self.group_hacks
        ct, gh, packed = self.chunk_tiles, self.group_hacks, self.packed
        want = _want("WhellMatrix")
        specs = [("values", (S, 128), None), ("residue", (S, 128), torch.int8),
                 ("page_tab", (S, 128), torch.int8),
                 ("tile_base", (T,), torch.int32), ("tile_page", (T,), torch.int32),
                 ("chunk_group", (T // max(ct, 1) + packed,), torch.int32)]
        if packed:
            want(self.values.dtype in VALUE_DTYPES, f"values dtype {self.values.dtype}")
            want(self.row_perm is None and self.ways == 1,
                 "a packed layout has no row_perm or ways")
            want(self.window_pages in (8, 16, 32), f"window_pages {self.window_pages}")
            want(self.n_rows == self.num_hacks * 128 <= R * 128, "lane space size")
            specs += [("seg_lo", (R, 128), torch.int8), ("seg_hi", (R, 128), torch.int8),
                      ("lane_of_row", (self.orig_rows,), torch.int32)]
        else:
            want(self.values.dtype in CLASSIC_DTYPES,
                 f"classic values dtype {self.values.dtype}")
            want(self.seg_hi is None and self.lane_of_row is None
                 and self.group_bases is None, "a classic layout has no packed fields")
            want((gh, ct, self.window_pages) == (8, CHUNK_TILES, 8),
                 f"classic geometry (group_hacks {gh}, chunk_tiles {ct}, "
                 f"window_pages {self.window_pages})")
            want(self.ways >= 1 and self.n_rows % self.ways == 0, f"ways {self.ways}")
            want(self.num_hacks == max(-(-self.n_rows // 128), 1)
                 and self.num_hacks <= R, "row space size")
            if self.row_perm is not None:
                specs.append(("row_perm", (R * 128,), torch.int32))
        _check_arrays(self, want, specs)
        want(S % 8 == 0 and T % ct == 0, "slots must fill whole chunks")
        want(self.x_pages * 128 >= self.n_cols, "x_pages too small")
        if not self.scattered:
            want(self.x_pages <= MAX_TILE_PAGE,
                 f"x_pages {self.x_pages} past the {MAX_TILE_PAGE} pages "
                 "tile_page's 31-bit base page addresses")
        res = self.residue.cpu().long()
        pt = self.page_tab.cpu().long()
        want(bool((res >= 0).all()), "negative residue")
        want(bool(((pt >= 0) & (pt < self.window_pages)).all()), "page_tab range")
        meta = self.tile_base.cpu().long()
        tp = _check_tile_page(want, self.tile_page, meta, self.scattered)
        cg = self.chunk_group.cpu().long()
        real = cg[:-1] if packed else cg
        want(bool(((real >= 0) & (real < self.num_groups)).all()), "chunk_group range")
        gb = None
        if self.scattered:
            K = self.window_pages // 8
            gb = self.group_bases.cpu().long()
            want(gb.numel() % K == 0 and gb.numel() > 0, "group_bases size")
            _check_groups(want, gb.numel() // K, tp)
        page, hh = _decode_pages(pt, res, tp, meta, torch.arange(S) // 8, gb,
                                 self.window_pages)
        want(bool(((page >= 0) & (page < self.x_pages)).all()), "page range")
        want(bool(((hh >= 0) & (hh < gh)).all()), "hack-in-group range")
        if packed:
            for name in ("seg_lo", "seg_hi"):
                s = getattr(self, name).cpu().long()
                want(bool((s >= -1).all()), f"{name} range")
            lor = self.lane_of_row.cpu().long()
            want(bool(((lor >= 0) & (lor < self.n_rows)).all()), "lane_of_row range")
        elif self.row_perm is not None:
            want(torch.equal(torch.sort(self.row_perm.cpu().long()).values,
                             torch.arange(R * 128)), "row_perm is not a permutation")
        if packed:
            want(self.work_list is None and self.work_sectors is None
                 and self.spmm_work is None and self.spmm_work_sectors is None,
                 "a packed layout has no work_list, work_sectors or their spmm order")
            self._check_hack_runs(want)
        else:
            wl, ws = self.work_list, self.work_sectors
            vals = self.values.cpu()
            want(wl is not None and wl.dtype == torch.int64 and wl.device == self.device
                 and torch.equal(wl.cpu(), classic_work_list(vals)),
                 "work_list does not match the values (changed in place?)")
            if self.values.dtype == torch.float64:
                want(ws is not None and ws.dtype == torch.int64
                     and ws.device == self.device
                     and torch.equal(ws.cpu(), classic_work_sectors(vals, wl.cpu())),
                     "work_sectors does not match the values (changed in place?)")
            else:
                want(ws is None, "only a float64 classic layout has work_sectors")
            order = classic_spmm_order(wl.cpu(), self.tile_base.cpu(), self.chunk_group.cpu())
            for name, lst in (("spmm_work", wl), ("spmm_work_sectors", ws)):
                got = getattr(self, name)
                want(got is None if lst is None else
                     got is not None and got.device == self.device
                     and torch.equal(got.cpu(), lst.cpu()[order]),
                     f"{name} is not {name.removeprefix('spmm_')} in classic_spmm_order")


    def _check_hack_runs(self, want) -> None:
        """``hack_ptr`` is the derivation from the tile scalars, each run
        holds only its hack's tiles, no tile lies in two runs, and every
        tile outside the runs holds zeros only: the hack-pass kernels (#4,
        #12 and complex128) never read those tiles."""
        hp = self.hack_ptr
        want(hp is not None and hp.dtype == torch.int32 and hp.device == self.device
             and tuple(hp.shape) == (self.num_hacks, 2)
             and torch.equal(hp.cpu(), self._derive_hack_ptr("cpu")),
             "hack_ptr does not match the tile scalars")
        hp = hp.cpu().long()
        want(self.num_hacks == 0 or int((hp[:, 1] - hp[:, 0]).max()) < RUN_CHUNK_TILES << 15,
             "a hack's run passes the 15-bit chunk field of its work units")
        rows = self.num_groups * self.group_hacks
        units = self.hack_units
        want(units is not None and units.device == self.device
             and torch.equal(units.cpu(), packed_hack_units(hp.int(), rows)),
             "hack_units does not match hack_ptr")
        T = self.num_tiles
        begin, count = hp[:, 0], hp[:, 1] - hp[:, 0]
        owner = torch.repeat_interleave(torch.arange(self.num_hacks), count)
        tiles = (torch.repeat_interleave(begin, count) + torch.arange(owner.numel())
                 - torch.repeat_interleave(torch.cumsum(count, 0) - count, count))
        meta = self.tile_base.cpu().long()
        cg = self.chunk_group.cpu().long()
        hack = (cg[torch.arange(T) // self.chunk_tiles] * self.group_hacks
                + (meta >> (20 if self.scattered else 16)))
        covered = torch.zeros(T, dtype=torch.long)
        covered.index_add_(0, tiles, torch.ones_like(tiles))
        want(bool((covered <= 1).all()) and torch.equal(hack[tiles], owner),
             "a hack's tiles are not one contiguous run")
        skipped = (covered == 0).nonzero().view(-1)
        vals = self.values.detach().cpu().view(T, 8 * 128)[skipped]
        want(not bool((vals != 0).any()),
             "a tile outside every hack run holds a nonzero value (runs not "
             "contiguous, or padding not zero)")


@dataclasses.dataclass
class PcellWhell:
    """Per-cell row-routing WHELL: the counterpart of
    :class:`spgpu_tpu.formats.whell.PcellWhell` (layout in
    :mod:`spgpu_tpu_torch.convert.pcell`).  Cells of many rows pack densely
    into each slot, one contiguous lane run per (row, slot); the kernel
    scans each slot along its lanes and differences the scan at the run
    bounds ``run_hi``/``run_lo``, keyed by the row's output lane (row %
    128).  Vectors are in the ORIGINAL numbering, of the values' type.
    float32 or float64 values."""

    values: torch.Tensor  # (total_slots, 128) float32 or float64
    residue: torch.Tensor  # (total_slots, 128) int8: col % 128
    page_tab: torch.Tensor  # (total_slots, 128) int8: delta keyed by residue
    run_hi: torch.Tensor  # (total_slots, 128) int8: run end lane, keyed by
    #   the run's row output lane; -1 = the row has no run in the slot
    run_lo: torch.Tensor  # (total_slots, 128) int8: lane before the run
    tile_base: torch.Tensor  # (num_tiles,) int32: layout group | hh << 20
    chunk_group: torch.Tensor  # (num_chunks + 1,) int32, trailing -1
    group_bases: torch.Tensor  # (layout_groups * K,) int32 superpage bases
    n_rows: int
    n_cols: int
    num_hacks: int
    num_groups: int
    total_slots: int
    nnz: int
    x_pages: int
    window_pages: int = 32
    group_hacks: int = 512
    chunk_tiles: int = 128
    # (num_tiles,) int32: each tile's full-width layout group; None
    # derives it from tile_base's 20-bit field
    tile_page: Optional[torch.Tensor] = None
    # rebuilt with every layout: pcell_hack_tiles(...), each output hack's
    # tiles that route a run, and the hack pass's work units over them
    # (packed_hack_units: hacks past PCELL_CHUNK_TILES tiles in chunks); a
    # product keeps no state here, so products of one layout may run at
    # once on several streams
    hack_tile_ptr: Optional[torch.Tensor] = dataclasses.field(default=None, init=False,
                                                              repr=False)
    hack_tiles: Optional[torch.Tensor] = dataclasses.field(default=None, init=False,
                                                           repr=False)
    hack_units: Optional[torch.Tensor] = dataclasses.field(default=None, init=False,
                                                           repr=False)

    _TENSORS = ("values", "residue", "page_tab", "run_hi", "run_lo",
                "tile_base", "chunk_group", "group_bases", "tile_page")

    def __post_init__(self) -> None:
        if self.tile_page is None:
            self.tile_page = low_field(self.tile_base, True)
        T, ct = self.tile_base.numel(), self.chunk_tiles
        if (self.run_hi.dim() == 2 and self.run_hi.shape[0] == 8 * T and ct >= 1
                and T % ct == 0 and self.chunk_group.shape == (T // ct + 1,)):
            self.hack_tile_ptr, self.hack_tiles, self.hack_units = self._derive_lists()

    def _derive_lists(self, device=None) -> tuple:
        """``hack_tile_ptr``, ``hack_tiles`` and ``hack_units`` from the
        layout's arrays (on ``device``, default theirs)."""
        run_hi, tb, cg = (t if device is None else t.to(device)
                          for t in (self.run_hi, self.tile_base, self.chunk_group))
        rows = self.num_groups * self.group_hacks
        ptr, tiles = pcell_hack_tiles(run_hi, tb, cg, chunk_tiles=self.chunk_tiles,
                                      group_hacks=self.group_hacks, num_rows=rows)
        return ptr, tiles, packed_hack_units(torch.stack([ptr[:-1], ptr[1:]], 1), rows,
                                             PCELL_CHUNK_TILES)

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def num_tiles(self) -> int:
        return self.total_slots // 8

    def to(self, device) -> "PcellWhell":
        """A copy with every tensor on ``device`` (the lists rebuilt there)."""
        return dataclasses.replace(self, **{f: getattr(self, f).to(device)
                                            for f in self._TENSORS})

    def _hacks(self) -> np.ndarray:
        """The output hack of every slot (host int64)."""
        tile = np.arange(self.total_slots) // 8
        meta = self.tile_base.cpu().numpy().astype(np.int64)
        cg = self.chunk_group.cpu().numpy().astype(np.int64)
        return cg[tile // self.chunk_tiles] * self.group_hacks + (meta >> 20)[tile]

    def to_dense(self) -> np.ndarray:
        """Host densification in the original numbering (testing helper;
        duplicates add): each row's lanes come from its runs."""
        vals = self.values.detach().cpu().numpy()
        res = self.residue.cpu().long()
        page, _ = _decode_pages(self.page_tab.cpu().long(), res,
                                self.tile_page.cpu().long(), self.tile_base.cpu().long(),
                                torch.arange(self.total_slots) // 8,
                                self.group_bases.cpu().long(), self.window_pages)
        col = (page * 128 + res).numpy()
        hi = self.run_hi.cpu().numpy().astype(np.int64)
        lo = self.run_lo.cpu().numpy().astype(np.int64)
        hack = self._hacks()
        row = np.full(vals.shape, -1, np.int64)
        for s, o in zip(*np.nonzero(hi >= 0)):
            row[s, lo[s, o] + 1: hi[s, o] + 1] = hack[s] * 128 + o
        ok = (vals != 0) & (row >= 0) & (row < self.n_rows) & (col < self.n_cols)
        out = np.zeros((self.n_rows, self.n_cols), vals.dtype)
        np.add.at(out, (row[ok], col[ok]), vals[ok])
        return out

    def check(self) -> None:
        """Validate shapes, dtypes and index ranges once, on the host;
        raises ``ValueError``."""
        T, S, ct, gh = self.num_tiles, self.total_slots, self.chunk_tiles, self.group_hacks
        want = _want("PcellWhell")
        K = self.window_pages // 8
        want(self.values.dtype in PCELL_DTYPES, f"values dtype {self.values.dtype}")
        _check_arrays(self, want, [
            ("values", (S, 128), None), ("residue", (S, 128), torch.int8),
            ("page_tab", (S, 128), torch.int8), ("run_hi", (S, 128), torch.int8),
            ("run_lo", (S, 128), torch.int8), ("tile_base", (T,), torch.int32),
            ("tile_page", (T,), torch.int32),
            ("chunk_group", (T // max(ct, 1) + 1,), torch.int32),
            ("group_bases", (self.group_bases.numel(),), torch.int32)])
        want(self.window_pages in (8, 16, 32, 64), f"window_pages {self.window_pages}")
        want(S % 8 == 0 and T % ct == 0, "slots must fill whole chunks")
        want(self.x_pages * 128 >= self.n_cols, "x_pages too small")
        want(self.num_hacks == max(-(-self.n_rows // 128), 1)
             and self.num_hacks <= self.num_groups * gh, "row space size")
        gb = self.group_bases.cpu().long()
        want(gb.numel() % K == 0 and gb.numel() > 0, "group_bases size")
        res = self.residue.cpu().long()
        pt = self.page_tab.cpu().long()
        want(bool((res >= 0).all()), "negative residue")
        want(bool(((pt >= 0) & (pt < self.window_pages)).all()), "page_tab range")
        meta = self.tile_base.cpu().long()
        cg = self.chunk_group.cpu().long()
        want(bool(((cg[:-1] >= 0) & (cg[:-1] < self.num_groups)).all())
             and int(cg[-1]) == -1, "chunk_group range or sentinel")
        tp = _check_tile_page(want, self.tile_page, meta, True)
        _check_groups(want, gb.numel() // K, tp)
        page, hh = _decode_pages(pt, res, tp, meta, torch.arange(S) // 8, gb,
                                 self.window_pages)
        want(bool(((page >= 0) & (page < self.x_pages)).all()), "page range")
        want(bool(((hh >= 0) & (hh < gh)).all()), "hack-in-group range")
        for name in ("run_hi", "run_lo"):
            r = getattr(self, name).cpu().long()
            want(bool((r >= -1).all()), f"{name} range")
        self._check_hack_lists(want)

    def _check_hack_lists(self, want) -> None:
        """The hack lists and units are the derivation from the layout's
        arrays (so never change a slab in place: build a new layout), on
        the layout's device, and every tile that routes a run is listed
        once, under its own hack."""
        lists = (self.hack_tile_ptr, self.hack_tiles, self.hack_units)
        want(all(t is not None and t.dtype == torch.int32 and t.device == self.device
                 for t in lists)
             and all(torch.equal(a.cpu(), b)
                     for a, b in zip(lists, self._derive_lists("cpu"))),
             "hack_tile_ptr/hack_tiles/hack_units do not match the layout "
             "(changed in place?)")
        ptr, tiles = self.hack_tile_ptr.cpu().long(), self.hack_tiles.cpu().long()
        want(bool((ptr[1:] >= ptr[:-1]).all()) and int(ptr[0]) == 0
             and int(ptr[-1]) == tiles.numel(), "hack_tile_ptr is not a partition")
        want(tiles.numel() == torch.unique(tiles).numel(), "a tile listed twice")
        want(tiles.numel() == 0 or int((ptr[1:] - ptr[:-1]).max()) < PCELL_CHUNK_TILES << 15,
             "a hack's tiles pass the 15-bit chunk field of its work units")


def _tensor(a) -> Optional[torch.Tensor]:
    """NumPy → torch, keeping bf16 (an ml_dtypes array from JAX) as bf16."""
    if a is None:
        return None
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # views of JAX arrays are read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _statics(cls, static: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: (bool(v) if k == "unit_segments" else int(v))
            for k, v in static.items() if k in names}


def _layout(fields: dict, values: torch.Tensor, static: dict) -> WhellMatrix:
    """A checked :class:`WhellMatrix` on the CPU from JAX array fields,
    with ``values`` as its slab."""
    kw = {f: _tensor(fields.get(f)) for f in _TENSORS[1:]}
    kw["values"] = values
    a = WhellMatrix(**kw, **_statics(WhellMatrix, static))
    if not a.packed and values.dtype not in CLASSIC_DTYPES:
        raise unported_complex("classic WHELL", values.dtype)
    a.check()
    return a


def from_numpy_fields(fields: dict, **static) -> WhellMatrix:
    """Build the port's :class:`WhellMatrix` from the array fields of a
    JAX ``WhellMatrix`` (``np.asarray`` of each) and its static fields.

    Packed and classic layouts cross (a classic one with its ``row_perm``
    and ``ways``, a float64 classic slab as it is); a complex classic
    layout raises ``NotImplementedError``.  A double-float slab joins into float64,
    ``values + values_lo``.  The result lies on the CPU and has passed
    :meth:`WhellMatrix.check`; move it with :meth:`WhellMatrix.to`."""
    values = _tensor(fields.get("values"))
    if fields.get("values_lo") is not None:
        values = join_dd(values, _tensor(fields["values_lo"]))
    return _layout(fields, values, static)


def from_numpy_planes(ar: dict, ai: dict, **static) -> WhellMatrix:
    """Build one complex :class:`WhellMatrix` from the array fields of a
    JAX ``WhellComplex``'s two planes (``ar``: real parts, ``ai``:
    imaginary parts, each as for :func:`from_numpy_fields`) and the
    planes' static fields.

    The planes must share every structural array, bit for bit (raises
    ``ValueError`` otherwise); the slab is ``ar.values + i·ai.values``,
    complex64 from fp32 planes and complex128 from double-float ones
    (each plane joined as ``values + values_lo`` first)."""
    values = join_plane_fields(ar, ai, _TENSORS[1:], "WHELL")
    return _layout(ar, values, static)


def from_numpy_pcell(fields: dict, **static) -> PcellWhell:
    """Build the port's :class:`PcellWhell` from the array fields of a JAX
    ``PcellWhell`` (``np.asarray`` of each) and its static fields, with
    float32 or float64 values (complex raises ``NotImplementedError``);
    the result lies on the CPU and has passed :meth:`PcellWhell.check`."""
    a = PcellWhell(**{f: _tensor(fields.get(f)) for f in PcellWhell._TENSORS},
                   **_statics(PcellWhell, static))
    if a.values.dtype.is_complex:
        raise unported_complex("pcell", a.values.dtype)
    a.check()
    return a
