"""COO → WHELL conversion (host NumPy + the C++ helpers): the packed-lane
and the classic layouts.

Counterpart of :mod:`spgpu_tpu.convert.whell` (``coo_to_whell`` with its
packed branch ``_coo_to_whell_packed`` and its classic branch): the same
geometry defaults, the same sorts and the same native first-fit, so the
arrays are bit-identical to the JAX converter's.  What the TPU's memory
budgets forced is left out, because the GPU reads x from device memory
through its 50 MB L2 and holds its scalars in plain arrays: no VMEM
group-size shrink, no column panels (``PanelledWhell``) and no SMEM row
segments (``SegmentedWhell``).  One :class:`WhellMatrix` is built at any
size.  At the sizes where the JAX converter does not split either, the
two layouts are identical.  (For float64 the JAX budgets are tighter,
since it stages x as a hi/lo pair: past 3,584 x pages its double-float
layout shrinks groups or splits panels, and the port's does not.)

A complex COO converts its structure once and scatters the complex values
into one complex slab.  The JAX converter runs the real converter twice,
on the real and on the imaginary parts, and both planes come out with one
structure (entries are placed by coordinate, never by value): the port's
structural arrays equal its ``ar`` plane's.  complex64 takes the fp32
geometry and complex128 the float64 (double-float) one, as the JAX
converter's planes do, but with scattered windows by default (the JAX
double-float layout's aligned ones with ``scattered=False``).

Each tile's layout group (scattered) or window base page (aligned and
classic) goes into ``tile_page`` at full width, and into ``tile_base``'s
low field as the JAX converter packs it: that field holds the whole value
up to 2**20 groups or 65,536 x pages (every layout the JAX converter
builds) and its low bits past them.  So one layout holds any system that
fits the card; the converters raise only past :data:`_MAX_TILE_PAGE`
pages or groups, where ``tile_page`` itself would wrap.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from spgpu_tpu_torch import native
from spgpu_tpu_torch.core import CHUNK_TILES, dtype_name, unique_sorted, value_dtype
from spgpu_tpu_torch.formats.coo import CooMatrix
from spgpu_tpu_torch.formats.whell import (CLASSIC_DTYPES, MAX_TILE_PAGE,
                                           WhellMatrix, low_field_bits,
                                           unported_complex)

__all__ = ["coo_to_whell", "dataclasses_replace_values", "degree_sort_perm",
           "local_degree_perm", "slab_dtype", "symmetric_relabel",
           "whell_update_values"]

_HACK = 128

#: refuse to allocate a padded host slab beyond this (runaway padding on
#: matrices with no column locality)
_SLAB_GUARD_BYTES = 16 * 2 ** 30

#: x pages (aligned and classic layouts) and layout groups (scattered) a
#: tile's full-width tile_page word addresses
_MAX_TILE_PAGE = MAX_TILE_PAGE


def _field_bound(what: str, value: int) -> None:
    """Raise when ``tile_page`` would wrap: ``value`` past
    :data:`_MAX_TILE_PAGE`."""
    if value > _MAX_TILE_PAGE:
        raise ValueError(
            f"this matrix needs {value} {what}, past the {_MAX_TILE_PAGE} that "
            "tile_page's 31-bit word holds")


def _pack_tile_base(page: np.ndarray, hh: np.ndarray, scattered: bool) -> np.ndarray:
    """The JAX ``tile_base``: the page or group in the low field (its low
    bits where it passes the field), ``hh`` above it."""
    bits = low_field_bits(scattered)
    return ((page & ((1 << bits) - 1)) | (hh << bits)).astype(np.int32)


def slab_dtype(dtype) -> torch.dtype:
    """The slab dtype for a NumPy/torch dtype or name: float32, float64,
    complex64, complex128 or bfloat16; anything else raises
    ``NotImplementedError``."""
    if dtype_name(dtype) == "bfloat16":
        return torch.bfloat16
    return getattr(torch, value_dtype(dtype, "packed WHELL").name)


def degree_sort_perm(coo: CooMatrix) -> np.ndarray:
    """Stored-row → original-row permutation sorting rows by descending
    nnz: the OELL ordering."""
    return np.argsort(-coo.row_lengths(), kind="stable").astype(np.int32)


def local_degree_perm(coo: CooMatrix, window: int = 1024) -> np.ndarray:
    """Descending-degree row order within ``window``-row blocks (new
    label → old label); labels move by less than ``window``, so column
    locality survives a symmetric relabel."""
    lens = coo.row_lengths()
    n = coo.n_rows
    perm = np.empty(n, dtype=np.int32)
    for s in range(0, n, window):
        e = min(s + window, n)
        perm[s:e] = s + np.argsort(-lens[s:e], kind="stable")
    return perm


def symmetric_relabel(coo: CooMatrix, perm: np.ndarray) -> CooMatrix:
    """Relabel rows AND columns by ``perm`` (new label → old label):
    ``A' = P A Pᵀ``, which keeps symmetry and definiteness."""
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty(coo.n_rows, dtype=np.int64)
    inv[perm[: coo.n_rows]] = np.arange(coo.n_rows)
    return CooMatrix(inv[coo.rows], inv[coo.cols], coo.values,
                     coo.n_rows, coo.n_cols)


def _excl_cumsum(a: np.ndarray) -> np.ndarray:
    out = np.zeros_like(a)
    np.cumsum(a[:-1], out=out[1:])
    return out


def coo_to_whell(
    coo: CooMatrix,
    *,
    device,
    dtype=None,
    packed: bool = True,
    row_perm: Optional[np.ndarray] = None,
    sort_rows: bool = False,
    ways: int = 1,
    return_plan: bool = False,
    window_pages: Optional[int] = None,
    scattered: Optional[bool] = None,
    group_hacks: Optional[int] = None,
    chunk_tiles: Optional[int] = None,
    row_degrees: Optional[np.ndarray] = None,
    lane_capacity: Optional[float] = None,
):
    """Build a :class:`WhellMatrix` on ``device``: packed (the default) or
    classic (``packed=False``).

    **Packed** (square matrices): rows get lane segments of
    ``ceil(degree / lane_capacity)`` lanes (capacity ~1.25x the mean
    degree) and are binned into 128-lane hacks; rows and columns are
    relabelled into lane space (``a.embed`` / ``a.extract``).
    ``scattered`` lets a tile's window be ``window_pages / 8``
    independently based 8-page superpages; ``scattered=False`` keeps one
    aligned window of ``window_pages`` (default 32).  ``dtype`` selects
    float32, float64, complex64, complex128 or bfloat16 values (default:
    the COO's).  float64 and complex128 take the chunk and group sizes of
    the JAX package's double-float layout; its aligned windows are
    ``scattered=False`` (then the two packages' structural arrays are
    identical), and the port's default is scattered windows, which pad
    less and run faster on the H100.  The values are the COO's, not hi/lo
    pairs or real planes.  ``group_hacks`` (hacks per output group) and ``chunk_tiles``
    (tiles per chunk) override that measured geometry, as in the JAX
    converter (the geometry sweep's knobs); a group may hold at most
    2**12 hacks with scattered windows and 2**16 with aligned ones (the
    width of tile_base's hack field).  ``row_degrees`` (each row's degree,
    ``(n_rows,)``) and ``lane_capacity`` (nonzeros a lane holds) override
    what sizes the rows' lane segments, as in the JAX converter: given
    both, they pin the lane map, so conversions of subsets of one
    matrix's entries share one lane space and their products add exactly
    (:mod:`spgpu_tpu_torch.parallel.partition_packed`).

    **Classic** (``packed=False``, any shape): output lane ``j`` of hack
    ``h`` is stored row ``h*128 + j``, one aligned 8-page window per tile
    (``window_pages`` must be 8), and the op works in the original
    numbering.  ``sort_rows=True`` applies the OELL descending-degree
    order (``row_perm`` wins if both are given; the op then scatters its
    output back); ``ways > 1`` splits every row into ``ways`` virtual rows
    (entries round-robined) that the op sums back.  float32, bfloat16 or
    float64 values (plain float64, the JAX classic slab); complex raises
    ``NotImplementedError``, as the JAX package has no complex classic
    product.

    The JAX default is classic; the port's stays packed, which its
    ``solve()`` and earlier releases call without ``packed``.
    ``return_plan=True`` also returns each COO entry's cell, ``(slot,
    lane)`` (classic) or ``(panel, slot, lane)`` (packed; the panel is
    always 0), for :func:`whell_update_values`.  Duplicates stay separate
    cells and add.
    """
    if packed:
        if row_perm is not None or sort_rows or ways != 1:
            raise ValueError("packed=True is incompatible with "
                             "row_perm/sort_rows/ways")
        vdt = slab_dtype(coo.values.dtype if dtype is None else dtype)
        if return_plan and vdt.is_complex:
            raise ValueError("return_plan is not supported for complex "
                             "packed matrices (convert anew)")
        return _packed_geometry(coo, vdt, window_pages or 32, scattered,
                                return_plan, device, group_hacks, chunk_tiles,
                                row_degrees, lane_capacity)
    if row_degrees is not None or lane_capacity is not None:
        raise ValueError("row_degrees/lane_capacity require packed=True")
    if group_hacks is not None or chunk_tiles is not None:
        raise ValueError("group_hacks/chunk_tiles require packed=True (the "
                         "classic geometry is fixed: 8-hack groups, 64-tile "
                         "chunks)")
    window_pages = window_pages or 8
    if window_pages != 8:
        raise ValueError("window_pages > 8 requires packed=True")
    if ways > 1:
        if row_perm is not None or sort_rows or return_plan:
            raise ValueError("ways>1 is incompatible with row_perm/plan")
        order0 = np.lexsort((coo.cols, coo.rows))
        rows_o = coo.rows[order0]
        starts = np.flatnonzero(np.r_[True, rows_o[1:] != rows_o[:-1]])
        runs = np.diff(np.r_[starts, rows_o.size])
        k_in_row = np.arange(rows_o.size) - np.repeat(starts, runs)
        vrows = rows_o * ways + (k_in_row % ways)
        vcoo = CooMatrix(vrows, coo.cols[order0], coo.values[order0],
                         coo.n_rows * ways, coo.n_cols)
        return dataclasses.replace(
            coo_to_whell(vcoo, device=device, dtype=dtype, packed=False),
            ways=ways)
    vdt = slab_dtype(coo.values.dtype if dtype is None else dtype)
    if vdt not in CLASSIC_DTYPES:
        raise unported_complex("classic WHELL", vdt)
    if row_perm is None and sort_rows:
        row_perm = degree_sort_perm(coo)
    return _coo_to_whell_classic(coo, vdt, row_perm, return_plan, device)


def _packed_geometry(coo, vdt, window_pages, scattered, return_plan, device,
                     group_hacks=None, chunk_tiles=None, row_degrees=None,
                     lane_capacity=None):
    """The JAX package's measured packed geometry defaults for ``coo``,
    or the caller's ``group_hacks``/``chunk_tiles``, with scattered
    windows unless the caller asks otherwise.  (The JAX double-float
    layout of float64 and complex128 has aligned windows; on the H100
    scattered ones stream fewer bytes and their product is faster.)"""
    f64 = vdt in (torch.float64, torch.complex128)  # the double-float geometry
    if scattered is None:
        scattered = True
    est_tiles = max(1, coo.nnz // 1024)
    num_hacks = -(-coo.n_rows // 128)
    if f64:
        ct = 32 if est_tiles >= 128 else 16
    elif scattered:
        ct = 128 if est_tiles >= 512 else (64 if est_tiles >= 128 else 32)
    elif est_tiles >= 2048:
        ct = 256
    elif est_tiles >= 512:
        ct = 128
    elif est_tiles >= 128:
        ct = 64
    else:
        ct = 32
    if (f64 or scattered) and num_hacks >= 512:
        gh = 512
    elif num_hacks >= 128:
        gh = 128
    else:
        gh = 32
    gh = gh if group_hacks is None else group_hacks
    ct = ct if chunk_tiles is None else chunk_tiles
    hh_limit = 1 << (12 if scattered else 16)
    if not (isinstance(gh, (int, np.integer)) and 1 <= gh <= hh_limit):
        raise ValueError(f"group_hacks must be an int in [1, {hh_limit}] "
                         f"({'scattered' if scattered else 'aligned'} "
                         f"windows), not {gh!r}")
    if not (isinstance(ct, (int, np.integer)) and ct >= 1):
        raise ValueError(f"chunk_tiles must be a positive int, not {ct!r}")
    return _coo_to_whell_packed(coo, window_pages, vdt, group_hacks=int(gh),
                                chunk_tiles=int(ct), scattered=scattered,
                                return_plan=return_plan, device=device,
                                row_degrees=row_degrees,
                                lane_capacity=lane_capacity)


def _slab_values(values: np.ndarray, vdt: torch.dtype) -> np.ndarray:
    """Per-entry values in the slab's storage type (bf16 as int16 bits,
    since NumPy has no bfloat16; a real COO given a complex type gets
    zero imaginary parts)."""
    t = torch.from_numpy(np.ascontiguousarray(values)).to(vdt)
    return (t.view(torch.int16) if vdt == torch.bfloat16 else t).numpy()


def _coo_to_whell_packed(coo: CooMatrix, window_pages: int, vdt: torch.dtype,
                         group_hacks: int, chunk_tiles: int, scattered: bool,
                         return_plan: bool, device, row_degrees=None,
                         lane_capacity=None):
    if coo.n_rows != coo.n_cols:
        raise ValueError("packed WHELL requires a square matrix (rows and "
                         "columns share the lane-space labels)")
    if window_pages not in (8, 16, 32):
        raise ValueError("window_pages must be 8, 16 or 32")
    w = window_pages
    K = max(w // 8, 1)
    n, m = coo.n_rows, coo.nnz

    deg = (np.asarray(row_degrees, np.int64) if row_degrees is not None
           else coo.row_lengths().astype(np.int64))
    if deg.shape != (n,):
        raise ValueError(f"row_degrees must have shape ({n},)")
    if lane_capacity is None:
        # ~1.25x the mean degree balances segment padding against hack count
        lane_capacity = max(8.0, 1.25 * m / max(n, 1))
    d = np.clip(np.ceil(deg / lane_capacity).astype(np.int64), 1, 128)

    if n:
        num_hacks, hack_of_row, lane_start = native.whell_hack_fill(d)
    else:
        num_hacks, hack_of_row, lane_start = 1, np.zeros(1, np.int64), np.zeros(1, np.int64)
    num_hacks = max(num_hacks, 1)
    # hack_of_row is non-decreasing (the greedy fill walks rows in order)
    hfirst = np.r_[True, hack_of_row[1:n] != hack_of_row[:n - 1]]
    first_idx = np.flatnonzero(hfirst)
    out_pos = (np.arange(n, dtype=np.int64)
               - np.repeat(first_idx, np.diff(np.r_[first_idx, n])))
    lane_of_row = (hack_of_row[:n] * _HACK + out_pos).astype(np.int32)

    gh, ct = group_hacks, chunk_tiles
    n_lane = num_hacks * _HACK
    if scattered:  # x needs only superpage (8-page) alignment
        x_pages = max(-(-num_hacks // 8) * 8, 8)
    else:
        x_pages = max(-(-num_hacks // w) * w, w)
        _field_bound("aligned x pages", x_pages)
    num_groups = -(-num_hacks // gh)

    seg_lo = np.full((num_groups * gh, _HACK), -1, dtype=np.int8)
    seg_hi = np.full((num_groups * gh, _HACK), -1, dtype=np.int8)
    seg_lo[hack_of_row[:n], out_pos] = (lane_start[:n] - 1).astype(np.int8)
    seg_hi[hack_of_row[:n], out_pos] = (lane_start[:n] + d[:n] - 1).astype(np.int8)
    # width-1 segments everywhere: the flush skips the prefix scan
    unit_segs = bool(np.all(d[:n] == 1)) if n else True

    def make(values, residue, page_tab, tile_base, chunk_group, group_bases,
             total_slots, nnz, unit, tile_page=None):
        t = lambda a: None if a is None else torch.from_numpy(a)
        vals = t(values)
        if vdt == torch.bfloat16:
            vals = vals.view(torch.bfloat16)
        return WhellMatrix(
            values=vals, residue=t(residue), page_tab=t(page_tab),
            tile_base=t(tile_base), chunk_group=t(chunk_group),
            seg_lo=t(seg_lo), seg_hi=t(seg_hi), lane_of_row=t(lane_of_row),
            group_bases=t(group_bases), n_rows=n_lane, n_cols=n_lane,
            num_hacks=num_hacks, num_groups=num_groups,
            total_slots=total_slots, nnz=nnz, x_pages=x_pages,
            window_pages=8 * K if scattered else w, orig_rows=n,
            group_hacks=gh, chunk_tiles=ct, unit_segments=unit,
            tile_page=t(tile_page),
        ).to(device)

    store_dt = _slab_values(np.zeros(0), vdt).dtype
    if m == 0:
        # an empty matrix builds aligned (no group_bases) in both packages
        total = num_groups * ct * 8
        a = make(np.zeros((total, _HACK), store_dt),
                 np.zeros((total, _HACK), np.int8),
                 np.zeros((total, 128), np.int8),
                 np.zeros((num_groups * ct,), np.int32),
                 np.r_[np.arange(num_groups, dtype=np.int32), np.int32(-1)],
                 None, total, 0, False)
        e = np.zeros(0, np.int64)
        return (a, (e, e, e)) if return_plan else a

    cols_l32 = lane_of_row[coo.cols]  # int32, lane-space columns
    nwin = x_pages // w
    hack = hack_of_row[coo.rows]
    if scattered:
        # A group's window is a SET of up to K independently based
        # superpages: rank each hack's touched superpages and bin the
        # ranks by K, so a hack's local cluster and its far hub columns
        # share one group.
        nsup_tot = x_pages // 8
        page_e = cols_l32.astype(np.int64) >> 7
        sup_e = page_e >> 3
        ukey = hack * nsup_tot + sup_e
        keyspace = int(num_hacks) * nsup_tot
        if keyspace <= 4 * m + (1 << 20):
            occ = np.zeros(keyspace, dtype=bool)
            occ[ukey] = True
            uk = np.flatnonzero(occ)
            del occ
            lookup = "lut"
        else:
            uk = unique_sorted(ukey)
            lookup = "searchsorted"
        sup_u = uk % nsup_tot
        u_hp = uk // nsup_tot
        first = np.r_[True, u_hp[1:] != u_hp[:-1]]
        starts = np.flatnonzero(first)
        rank_u = (np.arange(uk.size)
                  - np.repeat(starts, np.diff(np.r_[starts, uk.size])))
        maxbins = int(rank_u.max()) // K + 1
        G_u = u_hp * maxbins + rank_u // K
        tbl_u = rank_u % K
        # per-entry (group, table) through one packed code with a 3-bit
        # table field
        code_u = (G_u << 3) | tbl_u
        if lookup == "lut":
            lut = np.zeros(keyspace, dtype=np.int64)
            lut[uk] = code_u
            code = lut[ukey]
            del lut
        else:
            code = code_u[np.searchsorted(uk, ukey)]
        G = code >> 3
        dlt8 = (((code & 7) << 3) | (page_e & 7)).astype(np.int8)
    else:
        G = hack * nwin + (cols_l32.astype(np.int64) >> 7) // w

    # entries sort by (G, row, col): canonicalise to (row, col) order once
    # (already true for coalesced or generated COOs), then one stable sort
    # by G keeps that suborder
    if np.all((coo.rows[1:] > coo.rows[:-1])
              | ((coo.rows[1:] == coo.rows[:-1])
                 & (coo.cols[1:] >= coo.cols[:-1]))):
        order = np.argsort(G, kind="stable")
    else:
        pre = np.argsort(coo.rows * np.int64(coo.n_cols) + coo.cols,
                         kind="stable")
        order = pre[np.argsort(G[pre], kind="stable")]

    if scattered:
        Gs_all = G[order]
        g_change = np.r_[True, Gs_all[1:] != Gs_all[:-1]]
        g_starts = np.flatnonzero(g_change)
        k, vlane, res_s, g_id, W = native.whell_gather_assign_par(
            order, coo.rows, cols_l32, d, lane_start, dlt8,
            np.r_[g_starts, m])
        _field_bound("layout groups", int(W.size))
        del_s = dlt8[order]
        g_G = Gs_all[g_starts]
        # group g's table j holds the first page of its j-th superpage
        gI = np.searchsorted(g_G, G_u)
        bases = np.zeros((g_G.size, K), np.int32)
        bases[gI, tbl_u] = (sup_u * 8).astype(np.int32)
        g_hack = g_G // maxbins
        g_meta = np.arange(W.size, dtype=np.int64)  # layout-group index
    else:
        _ng, k, vlane, res_s, del_s, g_id, W, g_G = native.whell_gather_assign(
            order, coo.rows, cols_l32, d, lane_start, hack_of_row, nwin, w)
        bases = None
        g_hack = g_G // nwin
        g_meta = (g_G % nwin) * w  # first page of the aligned window

    raw_tiles_per_grp = -(-W // 8)
    hack8 = g_hack // gh
    tiles_per_g8 = np.zeros(num_groups, dtype=np.int64)
    np.add.at(tiles_per_g8, hack8, raw_tiles_per_grp)
    pad_tiles_per_g8 = np.maximum(-(-tiles_per_g8 // ct) * ct, ct)
    g8_base = _excl_cumsum(pad_tiles_per_g8)
    num_tiles = int(pad_tiles_per_g8.sum())
    total_slots = num_tiles * 8
    slab_bytes = total_slots * _HACK * (vdt.itemsize + 2)
    pad_now = total_slots * _HACK / max(k.size, 1)
    if slab_bytes > _SLAB_GUARD_BYTES:
        raise ValueError(
            f"packed WHELL slab would be {slab_bytes/2**30:.1f} GiB (padding "
            f"{pad_now:.0f}x nnz): this matrix has too little column locality "
            "for a windowed layout; relabel it first (symmetric_relabel)")
    if pad_now > 8.0 and k.size > 100_000:
        warnings.warn(f"packed WHELL padding is {pad_now:.1f}x nnz — the "
                      "matrix's column structure suits the windowed layout "
                      "poorly; consider a relabel", stacklevel=3)
    within_t = (_excl_cumsum(raw_tiles_per_grp)
                - _excl_cumsum(tiles_per_g8)[hack8])
    g_tile0 = g8_base[hack8] + within_t

    vals, res8, pt8, slot = native.whell_scatter_slabs(
        order, _slab_values(coo.values, vdt), g_tile0, g_id, k, vlane,
        res_s, del_s, total_slots)

    tile_page = np.zeros(num_tiles, dtype=np.int32)
    tile_hh = np.zeros(num_tiles, dtype=np.int32)
    g_tiles_idx = np.repeat(g_tile0, raw_tiles_per_grp) + (
        np.arange(int(raw_tiles_per_grp.sum()))
        - np.repeat(_excl_cumsum(raw_tiles_per_grp), raw_tiles_per_grp))
    tile_page[g_tiles_idx] = np.repeat(g_meta.astype(np.int32),
                                       raw_tiles_per_grp)
    tile_hh[g_tiles_idx] = np.repeat((g_hack % gh).astype(np.int32),
                                     raw_tiles_per_grp)
    # scattered: layout group | hh << 20; aligned: page | hh << 16
    tile_meta = _pack_tile_base(tile_page, tile_hh, scattered)
    # trailing -1 sentinel marks the last chunk of the last group
    chunk_group = np.r_[
        np.repeat(np.arange(num_groups, dtype=np.int32), pad_tiles_per_g8 // ct),
        np.int32(-1)]
    a = make(vals, res8, pt8, tile_meta, chunk_group,
             None if bases is None else np.ascontiguousarray(bases.reshape(-1)),
             total_slots, int(k.size), unit_segs, tile_page)
    if not return_plan:
        return a
    # entry i of the COO lives at cell (panel 0, plan_slot[i], plan_lane[i])
    plan_slot = np.empty(m, np.int64)
    plan_lane = np.empty(m, np.int64)
    plan_slot[order] = slot
    plan_lane[order] = vlane
    return a, (np.zeros(m, np.int64), plan_slot, plan_lane)


def _to_device(arrays: dict, device) -> dict:
    """NumPy arrays → torch tensors on ``device`` (bf16 values arrive as
    int16 bits; None stays None)."""
    out = {}
    for k, v in arrays.items():
        t = None if v is None else torch.from_numpy(np.ascontiguousarray(v))
        if k == "values" and t is not None and t.dtype == torch.int16:
            t = t.view(torch.bfloat16)
        out[k] = None if t is None else t.to(device)
    return out


def _classic(coo, arrays: dict, device, **static) -> WhellMatrix:
    return WhellMatrix(**_to_device(arrays, device), seg_lo=None, seg_hi=None,
                       lane_of_row=None, group_bases=None, n_rows=coo.n_rows,
                       n_cols=coo.n_cols, window_pages=8, orig_rows=0,
                       group_hacks=8, chunk_tiles=CHUNK_TILES, **static)


def _padded_perm(row_perm, num_groups: int) -> Optional[np.ndarray]:
    """``row_perm`` over every stored row, the padded tail the identity."""
    if row_perm is None:
        return None
    perm_p = np.arange(num_groups * 8 * _HACK, dtype=np.int32)
    perm_p[: np.asarray(row_perm).size] = row_perm
    return perm_p


def _coo_to_whell_classic(coo: CooMatrix, vdt: torch.dtype, row_perm,
                          return_plan: bool, device):
    """The classic branch of the JAX ``coo_to_whell``: entries grouped by
    (hack, aligned superpage), slots by the native first-fit under the
    one-page-per-(slot, residue) constraint, each 8-hack group padded to
    whole 64-tile chunks."""
    _CT = CHUNK_TILES
    if row_perm is not None:
        row_perm = np.asarray(row_perm, dtype=np.int32)
        inv = np.empty(coo.n_rows, dtype=np.int64)
        inv[row_perm[: coo.n_rows]] = np.arange(coo.n_rows)
        eff_rows = inv[coo.rows]
    else:
        eff_rows = coo.rows
    num_hacks = max(-(-coo.n_rows // _HACK), 1)
    num_pages = max(-(-coo.n_cols // 128), 1)
    nsp = -(-num_pages // 8)  # superpages (aligned 8-page windows)
    x_pages = max(nsp * 8, 8)
    _field_bound("x pages", x_pages)
    m = coo.nnz
    num_groups = -(-num_hacks // 8)
    static = dict(num_hacks=num_hacks, num_groups=num_groups, x_pages=x_pages)
    store_dt = _slab_values(np.zeros(0), vdt).dtype

    if m == 0:
        total = num_groups * _CT * 8
        a = _classic(coo, dict(
            values=np.zeros((total, _HACK), store_dt),
            residue=np.zeros((total, _HACK), np.int8),
            page_tab=np.zeros((total, 128), np.int8),
            tile_base=np.zeros((num_groups * _CT,), np.int32),
            chunk_group=np.arange(num_groups, dtype=np.int32),
            row_perm=_padded_perm(row_perm, num_groups)), device,
            total_slots=total, nnz=0, **static)
        e = np.zeros(0, np.int64)
        return (a, (e, e)) if return_plan else a

    hack = (eff_rows // _HACK).astype(np.int64)
    lane = (eff_rows % _HACK).astype(np.int64)
    page = (coo.cols // 128).astype(np.int64)
    resid = (coo.cols % 128).astype(np.int64)
    delta = (page % 8).astype(np.int8)

    # group per (hack, superpage); the native first-fit assigns slots
    G = hack * nsp + page // 8
    order = np.lexsort((coo.cols, eff_rows, G))  # by group, row, col
    Gs = G[order]
    res_s = resid[order]
    del_s = delta[order].astype(np.int64)
    k = native.whell_assign(Gs, lane[order], res_s, del_s)

    # group widths and slot layout: groups pad to whole tiles (one window
    # per tile), each 8-hack group's tiles to whole chunks
    g_first = np.r_[True, Gs[1:] != Gs[:-1]]
    g_id = np.cumsum(g_first) - 1
    W = np.zeros(g_id[-1] + 1, dtype=np.int64)
    np.maximum.at(W, g_id, k + 1)
    g_G = Gs[g_first]
    g_hack = g_G // nsp
    g_sp = g_G % nsp
    raw_tiles_per_grp = -(-W // 8)
    hack8 = g_hack // 8
    tiles_per_g8 = np.zeros(num_groups, dtype=np.int64)
    np.add.at(tiles_per_g8, hack8, raw_tiles_per_grp)
    pad_tiles_per_g8 = np.maximum(-(-tiles_per_g8 // _CT) * _CT, _CT)
    g8_base = _excl_cumsum(pad_tiles_per_g8)
    num_tiles = int(pad_tiles_per_g8.sum())
    total_slots = num_tiles * 8
    slab_bytes = total_slots * _HACK * (vdt.itemsize + 2)
    if slab_bytes > _SLAB_GUARD_BYTES:
        raise ValueError(
            f"classic WHELL slab would be {slab_bytes/2**30:.1f} GiB (padding "
            f"{total_slots * _HACK / m:.0f}x nnz): this matrix has too little "
            "column locality for a windowed layout; relabel it first")
    within_t = (_excl_cumsum(raw_tiles_per_grp)
                - _excl_cumsum(tiles_per_g8)[hack8])
    g_tile0 = g8_base[hack8] + within_t

    # scatter entries (cells are distinct: one entry per lane and slot)
    slot = g_tile0[g_id] * 8 + k
    vals = np.zeros((total_slots, _HACK), dtype=store_dt)
    res8 = np.zeros((total_slots, _HACK), dtype=np.int8)
    pt8 = np.zeros((total_slots, 128), dtype=np.int8)
    lane_o = lane[order]
    vals[slot, lane_o] = _slab_values(coo.values, vdt)[order]
    res8[slot, lane_o] = res_s.astype(np.int8)
    pt8[slot, res_s] = del_s.astype(np.int8)

    # per-tile scalars: the base page, and base page | hack-in-group << 16
    tile_page = np.zeros(num_tiles, dtype=np.int32)
    tile_hh = np.zeros(num_tiles, dtype=np.int32)
    g_tiles_idx = np.repeat(g_tile0, raw_tiles_per_grp) + (
        np.arange(int(raw_tiles_per_grp.sum()))
        - np.repeat(_excl_cumsum(raw_tiles_per_grp), raw_tiles_per_grp))
    tile_page[g_tiles_idx] = np.repeat((g_sp * 8).astype(np.int32),
                                       raw_tiles_per_grp)
    tile_hh[g_tiles_idx] = np.repeat((g_hack % 8).astype(np.int32),
                                     raw_tiles_per_grp)
    a = _classic(coo, dict(
        values=vals, residue=res8, page_tab=pt8, tile_page=tile_page,
        tile_base=_pack_tile_base(tile_page, tile_hh, False),
        chunk_group=np.repeat(np.arange(num_groups, dtype=np.int32),
                              pad_tiles_per_g8 // _CT),
        row_perm=_padded_perm(row_perm, num_groups)), device,
        total_slots=total_slots, nnz=m, **static)
    if not return_plan:
        return a
    # entry i of the COO lives at cell (plan_slot[i], plan_lane[i])
    inv_order = np.empty(m, dtype=np.int64)
    inv_order[order] = np.arange(m)
    return a, (slot[inv_order], lane)


def whell_update_values(a: WhellMatrix, plan, new_values) -> WhellMatrix:
    """Refresh the value slab of a matrix with the SAME pattern: a copy of
    ``a`` whose slab holds ``new_values`` (in the original COO entry
    order) at the cells of ``plan``, from ``coo_to_whell(...,
    return_plan=True)``: ``(slot, lane)`` for a classic layout,
    ``(panel, slot, lane)`` for a packed one (the port builds one panel,
    so the panel is always 0).  Each entry, duplicates included, updates
    its own cell; the values are stored as the slab's type (a float64
    slab stores float64, where the JAX package splits a double-float
    pair)."""
    if len(plan) == 3:
        panel, slot, lane = plan
        if np.any(np.asarray(panel) != 0):
            raise ValueError("a packed plan of the port has panel 0 only")
    else:
        slot, lane = plan
    vals = torch.zeros((a.total_slots, _HACK), dtype=a.values.dtype)
    new = torch.from_numpy(np.ascontiguousarray(new_values))
    vals[torch.as_tensor(slot), torch.as_tensor(lane)] = new.to(a.values.dtype)
    return dataclasses_replace_values(a, vals.to(a.device))


def dataclasses_replace_values(a: WhellMatrix, values: torch.Tensor) -> WhellMatrix:
    """A copy of ``a`` with the value slab ``values`` (its derived lists
    rebuilt, as every layout built by ``dataclasses.replace`` is)."""
    return dataclasses.replace(a, values=values)
