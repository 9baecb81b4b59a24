"""Packed-lane WHELL layout as a dataclass of torch tensors.

Counterpart of the packed branch of :class:`spgpu_tpu.formats.whell.
WhellMatrix`; the arrays are the same, cell for cell (see that module for
the layout).  In short, for a cell ``(slot s, lane j)`` of tile
``t = s // 8``:

* ``r = residue[s, j]`` and ``d = page_tab[s, r]`` — the page table is
  indexed by RESIDUE, not by lane;
* scattered windows (``group_bases`` set): ``g = tile_base[t] & 0xFFFFF``,
  ``hh = tile_base[t] >> 20`` and
  ``page = group_bases[g*K + (d >> 3)] + (d & 7)`` with
  ``K = window_pages // 8``;
* aligned windows: ``page = (tile_base[t] & 0xFFFF) + d`` and
  ``hh = tile_base[t] >> 16``;
* column ``page*128 + r`` in lane space; output hack
  ``chunk_group[t // chunk_tiles] * group_hacks + hh``.

Rows own lane segments; ``seg_lo``/``seg_hi`` give each output lane the
segment bounds its prefix-scan difference reads.  Vectors live in lane
space: :meth:`WhellMatrix.embed` and :meth:`WhellMatrix.extract` map
original vectors in and out.

Only the packed layout exists in the port.  Its values are float32,
bfloat16, float64, complex64 or complex128: where the JAX package keeps a
float64 matrix as a double-float pair (``values`` hi, ``values_lo`` lo),
the port keeps one float64 slab, and where it keeps a complex matrix as
two real-plane layouts of one structure (``WhellComplex``: ``ar``,
``ai``), the port keeps one layout whose slab is complex (interleaved
re/im), so its vectors are complex too.  The classic layout
(``row_perm``, ``ways``) and the TPU budget containers
(``PanelledWhell``, ``SegmentedWhell``) are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from spgpu_tpu_torch.core import join_dd, join_plane_fields

__all__ = ["WhellMatrix", "from_numpy_fields", "from_numpy_planes"]

#: the value types of a slab
VALUE_DTYPES = (torch.float32, torch.bfloat16, torch.float64, torch.complex64,
                torch.complex128)

_TENSORS = ("values", "residue", "page_tab", "tile_base", "chunk_group",
            "seg_lo", "seg_hi", "lane_of_row", "group_bases")


@dataclasses.dataclass
class WhellMatrix:
    # slabs, slot-major (total_slots, 128)
    values: torch.Tensor  # one of VALUE_DTYPES
    residue: torch.Tensor  # int8: col % 128 of each cell
    page_tab: torch.Tensor  # int8: window page delta, indexed by residue
    # per-tile and per-chunk scalars
    tile_base: torch.Tensor  # (num_tiles,) int32 packed window | hh
    chunk_group: torch.Tensor  # (num_chunks + 1,) int32, trailing -1
    # output segments (num_groups * group_hacks, 128) int8
    seg_lo: torch.Tensor
    seg_hi: torch.Tensor
    lane_of_row: torch.Tensor  # (orig_rows,) int32 lane-space coordinate
    group_bases: Optional[torch.Tensor]  # (layout_groups * K,) int32 or None
    n_rows: int
    n_cols: int
    num_hacks: int
    num_groups: int
    total_slots: int
    nnz: int
    x_pages: int
    window_pages: int
    orig_rows: int
    group_hacks: int
    chunk_tiles: int
    unit_segments: bool = False

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def num_tiles(self) -> int:
        return self.total_slots // 8

    @property
    def scattered(self) -> bool:
        return self.group_bases is not None

    def to(self, device) -> "WhellMatrix":
        """A copy with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f: None if getattr(self, f) is None else getattr(self, f).to(device)
            for f in _TENSORS})

    def embed(self, x, dtype: torch.dtype) -> torch.Tensor:
        """Original-space vector(s) → lane space, as ``dtype``, on the
        matrix's device (phantom coordinates zero).  A complex ``dtype``
        gives the one complex vector that the JAX ``embed_complex`` gives
        as a ``[re, im]`` plane stack."""
        x = torch.as_tensor(x).to(device=self.device, dtype=dtype)
        out = torch.zeros(x.shape[:-1] + (self.n_rows,), dtype=dtype,
                          device=self.device)
        out[..., self.lane_of_row.long()] = x
        return out

    def extract(self, z, dtype: torch.dtype) -> torch.Tensor:
        """Lane-space vector(s) → original space, as ``dtype``."""
        z = torch.as_tensor(z).to(device=self.device)
        return z[..., self.lane_of_row.long()].to(dtype)

    def to_dense(self) -> np.ndarray:
        """Host densification in LANE space (testing helper; duplicates
        add).  Compare with the original matrix embedded in lane space."""
        vals = self.values.detach().cpu()
        vals = (vals.float() if vals.dtype == torch.bfloat16 else vals).numpy()
        res = self.residue.cpu().numpy().astype(np.int64)
        pt = self.page_tab.cpu().numpy().astype(np.int64)
        meta = self.tile_base.cpu().numpy().astype(np.int64)
        cg = self.chunk_group.cpu().numpy().astype(np.int64)
        lo = self.seg_lo.cpu().numpy().astype(np.int64)
        hi = self.seg_hi.cpu().numpy().astype(np.int64)
        row_of_lane = np.full(lo.shape, -1, dtype=np.int64)
        for hk, j in zip(*np.nonzero(hi >= 0)):
            row_of_lane[hk, lo[hk, j] + 1: hi[hk, j] + 1] = hk * 128 + j
        s = np.arange(self.total_slots)
        t = s // 8
        d = np.take_along_axis(pt, res, axis=1)
        if self.scattered:
            gb = self.group_bases.cpu().numpy().astype(np.int64)
            K = self.window_pages // 8
            g, hh = meta & 0xFFFFF, meta >> 20
            page = gb[g[t][:, None] * K + (d >> 3)] + (d & 7)
        else:
            base, hh = meta & 0xFFFF, meta >> 16
            page = base[t][:, None] + d
        col = page * 128 + res
        hack = cg[t // self.chunk_tiles] * self.group_hacks + hh[t]
        row = row_of_lane[hack]
        ok = (vals != 0) & (row >= 0) & (row < self.n_rows) & (col < self.n_cols)
        out = np.zeros((self.n_rows, self.n_cols), dtype=vals.dtype)
        np.add.at(out, (row[ok], col[ok]), vals[ok])
        return out

    def check(self) -> None:
        """Validate shapes, dtypes and index ranges once, on the host, so
        the kernel can trust every decoded page and hack; raises
        ``ValueError``."""
        T, S, R = self.num_tiles, self.total_slots, self.num_groups * self.group_hacks
        ct, gh = self.chunk_tiles, self.group_hacks

        def want(cond, msg):
            if not cond:
                raise ValueError(f"invalid WhellMatrix: {msg}")

        want(self.values.dtype in VALUE_DTYPES, f"values dtype {self.values.dtype}")
        for name, shape, dt in (
                ("values", (S, 128), None), ("residue", (S, 128), torch.int8),
                ("page_tab", (S, 128), torch.int8),
                ("tile_base", (T,), torch.int32),
                ("chunk_group", (T // max(ct, 1) + 1,), torch.int32),
                ("seg_lo", (R, 128), torch.int8), ("seg_hi", (R, 128), torch.int8),
                ("lane_of_row", (self.orig_rows,), torch.int32)):
            t = getattr(self, name)
            want(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
            want(dt is None or t.dtype == dt, f"{name} dtype {t.dtype}")
            want(t.device == self.device, f"{name} on {t.device}")
        want(S % 8 == 0 and T % ct == 0, "slots must fill whole chunks")
        want(self.window_pages in (8, 16, 32), f"window_pages {self.window_pages}")
        want(self.n_rows == self.num_hacks * 128 <= R * 128, "lane space size")
        want(self.x_pages * 128 >= self.n_cols, "x_pages too small")
        res = self.residue.cpu().long()
        pt = self.page_tab.cpu().long()
        want(bool((res >= 0).all()), "negative residue")
        want(bool(((pt >= 0) & (pt < self.window_pages)).all()), "page_tab range")
        meta = self.tile_base.cpu().long()
        cg = self.chunk_group.cpu().long()
        want(bool(((cg[:-1] >= 0) & (cg[:-1] < self.num_groups)).all()),
             "chunk_group range")
        tile = torch.arange(S) // 8
        d = torch.gather(pt, 1, res)  # every cell's page delta, as decoded
        if self.scattered:
            K = self.window_pages // 8
            gb = self.group_bases.cpu().long()
            want(gb.numel() % K == 0 and gb.numel() > 0, "group_bases size")
            want(bool(((meta & 0xFFFFF) < gb.numel() // K).all()),
                 "tile group index")
            page = gb[(meta & 0xFFFFF)[tile, None] * K + (d >> 3)] + (d & 7)
            hh = meta >> 20
        else:
            page = (meta & 0xFFFF)[tile, None] + d
            hh = meta >> 16
        want(bool(((page >= 0) & (page < self.x_pages)).all()), "page range")
        want(bool(((hh >= 0) & (hh < gh)).all()), "hack-in-group range")
        for name in ("seg_lo", "seg_hi"):
            s = getattr(self, name).cpu().long()
            want(bool((s >= -1).all()), f"{name} range")
        lor = self.lane_of_row.cpu().long()
        want(bool(((lor >= 0) & (lor < self.n_rows)).all()), "lane_of_row range")


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


def _layout(fields: dict, values: torch.Tensor, static: dict) -> WhellMatrix:
    """A checked :class:`WhellMatrix` on the CPU from JAX array fields,
    with ``values`` as its slab."""
    if fields.get("seg_lo") is None or fields.get("row_perm") is not None \
            or static.pop("ways", 1) != 1:
        raise NotImplementedError(
            "classic (non-packed) WHELL is not ported yet (ROADMAP module "
            "item 11, kernel #15)")
    kw = {f: _tensor(fields.get(f)) for f in _TENSORS[1:]}
    kw["values"] = values
    names = {f.name for f in dataclasses.fields(WhellMatrix)}
    kw.update({k: (bool(v) if k == "unit_segments" else int(v))
               for k, v in static.items() if k in names})
    a = WhellMatrix(**kw)
    a.check()
    return a


def from_numpy_fields(fields: dict, **static) -> WhellMatrix:
    """Build the port's :class:`WhellMatrix` from the array fields of a
    JAX ``WhellMatrix`` (``np.asarray`` of each) and its static fields.

    Only plain packed layouts cross: a classic layout (``row_perm``,
    ``ways``) or a budget container raise ``NotImplementedError``.  A
    double-float slab joins into float64, ``values + values_lo``.  The
    result lies on the CPU and has passed :meth:`WhellMatrix.check`; move
    it with :meth:`WhellMatrix.to`."""
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
    values = join_plane_fields(ar, ai, _TENSORS[1:] + ("row_perm",), "WHELL")
    return _layout(ar, values, static)
