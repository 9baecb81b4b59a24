"""COO → WHDIA conversion (host NumPy + the C++ tiler).

Counterpart of the unblocked path of :func:`spgpu_tpu.convert.whdia.
coo_to_whdia` for float32, float64, complex64 and complex128 values:
the same slot discovery, the same native greedy tiler, the same geometry
defaults, window pick and pattern-mode detection, so the arrays are
bit-identical to the JAX converter's (``slot_r0`` is stored once per
slot instead of lane-replicated).  float64 takes the geometry of the JAX
double-float layout, holds the COO's values where JAX holds a hi/lo
pair, and packs r0 per tile wherever float32 would (the JAX double-float
kernel reads the ``slot_r0`` slab only).  A complex COO converts its
structure once into one complex slab, where the JAX converter builds two
real-plane layouts of one structure (``ComplexPlanes``): complex64 takes
the fp32 geometry, complex128 the float64 one (and its r0-mode rule).
Entries are bucketed by (hack, diagonal); duplicate coordinates
plain-store, so the last entry in file order wins, as in ``cooToHdia``
(``hdia.cpp:230-349``).

The JAX converter splits a matrix into row blocks (``BlockedWhdia``) when
x passes its VMEM budget (``n_cols*itemsize > 10 MiB``) or its tile scalars pass
the SMEM budget (``2*nnz/1024 > 150,000`` estimated tiles).  The port reads x from device
memory and keeps its scalars in plain arrays, so it builds one layout at
any size; past those budgets the two packages' layouts differ by design.
Each tile's base page goes into ``tile_page`` at full width and into
``tile_base``'s 16-bit field as the JAX converter packs it: the whole page
up to 65,536 x pages (about 8.4M columns), its low 16 bits past them.
"""

from __future__ import annotations

import numpy as np
import torch

from spgpu_tpu_torch import native
from spgpu_tpu_torch.core import value_dtype
from spgpu_tpu_torch.formats.coo import CooMatrix
from spgpu_tpu_torch.formats.whdia import WhdiaMatrix
from spgpu_tpu_torch.formats.whell import MAX_TILE_PAGE

__all__ = ["coo_to_whdia"]

_HACK = 128
#: the largest base page a tile's full-width tile_page word holds
_MAX_TILE_PAGE = MAX_TILE_PAGE


def _spread(w: int) -> int:
    """Max diagonal spread inside one tile for a ``w``-page window."""
    return (w - 2) * 128


def _excl_cumsum(a: np.ndarray) -> np.ndarray:
    out = np.zeros_like(a)
    np.cumsum(a[:-1], out=out[1:])
    return out


def coo_to_whdia(coo: CooMatrix, *, device) -> WhdiaMatrix:
    """COO → :class:`WhdiaMatrix` on ``device``.

    One slot per occupied (hack, diagonal); slots pack greedily into
    8-slot tiles of one hack whose diagonal spread fits the window; the
    window (8, 16 or 32 pages) is the one with the fewest group-padded
    tiles by the JAX package's cost model.  Tiles whose filled slots'
    ``r0`` form an arithmetic progression everywhere switch the layout
    to pattern mode (one packed word per tile); otherwise ``slot_r0``
    holds one int16 per slot.  Raises ``ValueError`` only where a base
    page passes :data:`_MAX_TILE_PAGE`, the width of ``tile_page``."""
    dt = value_dtype(coo.values.dtype, "WHDIA")
    f64 = dt in (np.float64, np.complex128)  # the double-float geometry
    num_hacks = max(-(-coo.n_rows // _HACK), 1)
    # the JAX package's geometry defaults
    group_hacks = 32 if (f64 or num_hacks < 128) else 128
    est_tiles = max(1, coo.nnz // 1024)
    chunk_tiles = (32 if f64 else 256 if est_tiles >= 4096
                   else 128 if est_tiles >= 1024
                   else 64 if est_tiles >= 256 else 32)
    gh, ct = group_hacks, chunk_tiles
    num_groups = -(-num_hacks // gh)
    num_pages = max(-(-coo.n_cols // 128), 1)
    m = coo.nnz

    def make(vals, slot_r0, tile_r0, tile_base, chunk_group, total_slots,
             x_pages, w, tile_page=None):
        t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
        return WhdiaMatrix(
            values=t(vals), slot_r0=t(slot_r0), tile_r0=t(tile_r0),
            tile_base=t(tile_base), chunk_group=t(chunk_group),
            tile_page=t(tile_page),
            n_rows=coo.n_rows, n_cols=coo.n_cols, num_hacks=num_hacks,
            num_groups=num_groups, total_slots=total_slots, nnz=m,
            x_pages=x_pages, window_pages=w, group_hacks=gh,
            chunk_tiles=ct).to(device)

    if m == 0:
        total = num_groups * ct * 8
        return make(np.zeros((total, _HACK), dt),
                    np.zeros(total, np.int16), None,
                    np.zeros(total // 8, np.int32),
                    np.arange(num_groups, dtype=np.int32), total,
                    max(num_pages, 8), 8)

    hack = (coo.rows // _HACK).astype(np.int64)
    lane = (coo.rows % _HACK).astype(np.int64)
    diag = (coo.cols - coo.rows).astype(np.int64)

    # slots: one per occupied (hack, diagonal), entries ordered by (hack,
    # diag, file order) so later duplicates win
    order = np.lexsort((np.arange(m), diag, hack))
    h_s, d_s = hack[order], diag[order]
    new_slot_flag = np.r_[True, (h_s[1:] != h_s[:-1]) | (d_s[1:] != d_s[:-1])]
    slot_of_entry = np.cumsum(new_slot_flag) - 1
    slot_hack = h_s[new_slot_flag]
    slot_diag = d_s[new_slot_flag]

    def padded_tiles(tile_hack_a):
        raw = np.bincount(tile_hack_a // gh, minlength=num_groups)
        return int(np.maximum(-(-raw // ct) * ct, ct).sum())

    # window pick: the fewest group-padded tiles, each extra 8 pages
    # priced at one op in eight (the JAX package's cost model)
    best = None
    for w_try in (8, 16, 32):
        cand = native.whdia_tile(slot_hack, slot_diag, _spread(w_try))
        cost = padded_tiles(cand[2]) * (8 + (w_try // 8 - 1))
        if best is None or cost < best[0]:
            best = (cost, w_try, cand)
    _, w, (tile_of_slot, pos_of_slot, tile_hack_a, tile_d0_a) = best
    x_pages = max(num_pages, w)
    n_raw_tiles = tile_hack_a.size

    # group hacks; pad each group's tiles to whole chunks
    tile_group = tile_hack_a // gh
    raw_tiles_per_group = np.bincount(tile_group, minlength=num_groups)
    pad_tiles_per_group = np.maximum(-(-raw_tiles_per_group // ct) * ct, ct)
    group_tile_base = _excl_cumsum(pad_tiles_per_group)
    num_tiles = int(pad_tiles_per_group.sum())
    total_slots = num_tiles * 8
    # raw tiles are already group-contiguous (slots sorted by hack)
    rank_in_group = (np.arange(n_raw_tiles)
                     - _excl_cumsum(raw_tiles_per_group)[tile_group])
    tile_final = group_tile_base[tile_group] + rank_in_group

    # per-tile scalars
    base_cap = max(x_pages - w, 0)
    tb_raw = np.clip((tile_hack_a * _HACK + tile_d0_a) >> 7, 0, base_cap)
    if int(tb_raw.max()) > _MAX_TILE_PAGE:
        raise ValueError(
            f"WHDIA needs base page {int(tb_raw.max())}, past the "
            f"{_MAX_TILE_PAGE} that tile_page's 31-bit word holds "
            f"({coo.n_cols} columns)")
    # the full base page, and the JAX word: its low 16 bits | hh << 16
    tile_page = np.zeros(num_tiles, dtype=np.int32)
    tile_page[tile_final] = tb_raw.astype(np.int32)
    tile_hh = np.zeros(num_tiles, dtype=np.int32)
    tile_hh[tile_final] = (tile_hack_a % gh).astype(np.int32)
    tile_meta = ((tile_page & 0xFFFF) | (tile_hh << 16)).astype(np.int32)
    chunk_group = np.repeat(np.arange(num_groups, dtype=np.int32),
                            pad_tiles_per_group // ct)

    # per-slot r0; scatter values
    slot_final = tile_final[tile_of_slot] * 8 + pos_of_slot
    r0 = slot_hack * _HACK + slot_diag - tb_raw[tile_of_slot] * 128
    slot_r0 = np.zeros(total_slots, dtype=np.int16)
    slot_r0[slot_final] = r0.astype(np.int16)
    vals = np.zeros((total_slots, _HACK), dtype=dt)
    vals[slot_final[slot_of_entry], lane[order]] = coo.values[order]

    # pattern mode: every tile's filled slots (a position prefix) form an
    # arithmetic progression r0[s] = r00 + step*s; one packed word per
    # tile then replaces slot_r0, dead slots repeating the last value
    r0g = np.zeros((num_tiles, 8), np.int64)
    nfill = np.zeros(num_tiles, np.int64)
    tf = tile_final[tile_of_slot]
    r0g[tf, pos_of_slot] = r0
    np.maximum.at(nfill, tf, pos_of_slot + 1)
    d1 = r0g[:, 1:] - r0g[:, :-1]
    step = np.where(nfill > 1, d1[:, 0], 0)
    is_ap = np.ones(num_tiles, bool)
    for s in range(1, 7):
        is_ap &= (nfill <= s + 1) | (d1[:, s] == step)
    r00 = r0g[:, 0]
    f1 = np.maximum(nfill - 1, 0)
    if (is_ap.all() and r00.min() >= -1024 and r00.max() < 64512
            and step.min() >= -4096 and step.max() < 4096):
        packed = ((r00 + 1024).astype(np.uint32)
                  | (f1.astype(np.uint32) << np.uint32(16))
                  | ((step + 4096).astype(np.uint32) << np.uint32(19)))
        return make(vals, None, packed.view(np.int32), tile_meta, chunk_group,
                    total_slots, x_pages, w, tile_page)
    return make(vals, slot_r0, None, tile_meta, chunk_group, total_slots,
                x_pages, w, tile_page)
