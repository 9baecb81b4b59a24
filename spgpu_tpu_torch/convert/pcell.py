"""COO → per-cell row-routing WHELL (pcell), host NumPy.

A copy of :func:`spgpu_tpu.convert.pcell.coo_to_whell_percell`: the same
geometry shrink, the same scattered-superpage grouping and the same
per-group greedy, so the arrays are bit-identical to the JAX converter's.

The packed layout gives each row a FIXED lane segment across all slots of
its (hack, window) group, so slots fill only partly.  This layout lets
the cells of MANY rows pack densely into each slot, a row's cells forming
one contiguous lane RUN per slot, so slots fill to capacity and the
padding drops to the bin-packing bound.  The price is a per-tile flush:
an inclusive lane prefix scan of each slot, differenced at each run's
end and start (``run_hi``/``run_lo``, two more int8 slabs keyed by the
row's output lane, 8 B per cell against 6), so the output is in the
ORIGINAL row order with no lane space.  The JAX package keeps the layout
as the evidence of a refuted TPU design; on a GPU the scan is a few warp
shuffles (kernel #17, :mod:`spgpu_tpu_torch.kernels.pcell`).
"""

from __future__ import annotations

import numpy as np
import torch

from spgpu_tpu_torch.core import dtype_name
from spgpu_tpu_torch.formats.coo import CooMatrix
from spgpu_tpu_torch.formats.whell import MAX_TILE_PAGE, PcellWhell

__all__ = ["coo_to_whell_percell"]

_HACK = 128

#: layout groups a tile's full-width tile_page word addresses (its
#: tile_base keeps the JAX 20-bit field: the group's low bits past 2**20)
_MAX_TILE_PAGE = MAX_TILE_PAGE


def _excl_cumsum(a):
    out = np.zeros_like(a)
    np.cumsum(a[:-1], out=out[1:])
    return out


def _greedy(res_s, del_s, gstarts, gsizes):
    """The defer-on-conflict packer, per group: walk the pending cells in
    order, place each at the next lane of the current slot unless the slot
    is full or already maps its residue to another page, and defer it to
    the next slot otherwise.  Returns each cell's slot in its group and
    lane, and each group's slot count."""
    m = res_s.size
    res_l, del_l = res_s.tolist(), del_s.tolist()
    slot_of = [0] * m
    lane_of = [0] * m
    slots_per_group = []
    for s0, sz in zip(gstarts.tolist(), gsizes.tolist()):
        pending = range(s0, s0 + sz)
        nslots = 0
        while pending:
            used = {}
            lane = 0
            nxt = []
            for i in pending:
                if lane >= 128:
                    nxt.append(i)
                    continue
                r_ = res_l[i]
                u = used.get(r_)
                if u is not None and u != del_l[i]:
                    nxt.append(i)
                    continue
                used[r_] = del_l[i]
                slot_of[i] = nslots
                lane_of[i] = lane
                lane += 1
            pending = nxt
            nslots += 1
        slots_per_group.append(nslots)
    return (np.array(slot_of, np.int64), np.array(lane_of, np.int64),
            np.array(slots_per_group, np.int64))


def coo_to_whell_percell(coo: CooMatrix, *, device, group_hacks: int = 512,
                         chunk_tiles: int = 128, supers_per_tile: int = 4,
                         dtype=None) -> PcellWhell:
    """Build the per-cell-routing layout of a square or rectangular host COO
    on ``device``.

    Rows are hacked by 128 (output lane = row % 128); each hack's entries
    are grouped by scattered superpage bins of ``supers_per_tile`` 8-page
    superpages (as packed WHELL's scattered windows); within a group a
    greedy packs cells slot by slot.  ``group_hacks`` halves while it
    exceeds the hack count (down to 32).  Duplicates stay separate cells
    and add.  float32 values only (``dtype`` None or float32): other types
    raise ``NotImplementedError`` (ROADMAP module item 14).  Raises
    ``ValueError`` past :data:`_MAX_TILE_PAGE` layout groups."""
    name = dtype_name(coo.values.dtype if dtype is None else dtype)
    if name != "float32":
        raise NotImplementedError(
            f"pcell in the port takes float32 values, not {name}: other value "
            "types are ROADMAP module item 14 (follow-ups)")
    vals_in = coo.values.astype(np.float32)
    n, m = coo.n_rows, coo.nnz
    K = supers_per_tile
    gh, ct = group_hacks, chunk_tiles
    num_hacks = max(-(-n // _HACK), 1)
    while gh > 32 and gh > num_hacks:
        gh //= 2
    num_groups = -(-num_hacks // gh)
    num_pages = max(-(-coo.n_cols // 128), 1)
    x_pages = max(-(-num_pages // 8) * 8, 8)
    static = dict(n_rows=n, n_cols=coo.n_cols, num_hacks=num_hacks,
                  num_groups=num_groups, x_pages=x_pages, window_pages=8 * K,
                  group_hacks=gh, chunk_tiles=ct)

    def make(total_slots, nnz, **arrays):
        return PcellWhell(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                             for k, v in arrays.items()},
                          total_slots=total_slots, nnz=nnz, **static)

    if m == 0:
        total = num_groups * ct * 8
        return make(total, 0, values=np.zeros((total, _HACK), np.float32),
                    residue=np.zeros((total, _HACK), np.int8),
                    page_tab=np.zeros((total, 128), np.int8),
                    run_hi=np.full((total, _HACK), -1, np.int8),
                    run_lo=np.full((total, _HACK), -1, np.int8),
                    tile_base=np.zeros((num_groups * ct,), np.int32),
                    chunk_group=np.r_[np.arange(num_groups, dtype=np.int32),
                                      np.int32(-1)],
                    group_bases=np.zeros((K,), np.int32))

    hack = (coo.rows // _HACK).astype(np.int64)
    page = (coo.cols >> 7).astype(np.int64)
    sup = page >> 3

    # scattered superpage bins per hack (the grouping of packed WHELL)
    keysp = num_pages // 8 + 2
    key = hack * keysp + sup
    uk, inv = np.unique(key, return_inverse=True)
    uh = uk // keysp
    first = np.r_[True, uh[1:] != uh[:-1]]
    starts = np.flatnonzero(first)
    rank = np.arange(uk.size) - np.repeat(starts, np.diff(np.r_[starts, uk.size]))
    maxbins = int(rank.max()) // K + 1
    Gu = uh * maxbins + rank // K
    tbl_u = rank % K
    sup_u = uk % keysp
    G = Gu[inv]
    delta = ((tbl_u[inv] << 3) | (page & 7)).astype(np.int8)
    res = (coo.cols & 127).astype(np.int64)

    order = np.lexsort((coo.cols, coo.rows, G))
    Gs = G[order]
    res_s = res[order]
    del_s = delta[order].astype(np.int64)
    rows_o = coo.rows[order]

    g_first = np.r_[True, Gs[1:] != Gs[:-1]]
    gstarts = np.flatnonzero(g_first)
    gsizes = np.diff(np.r_[gstarts, m])
    n_grp = gstarts.size
    if n_grp > _MAX_TILE_PAGE:
        raise ValueError(
            f"this matrix needs {n_grp} pcell layout groups, past the "
            f"{_MAX_TILE_PAGE} that tile_page's 31-bit word holds")
    g_G = Gs[gstarts]
    g_hack = g_G // maxbins

    slot_of, lane_of, slots_per_group = _greedy(res_s, del_s, gstarts, gsizes)

    # group -> global tiles (the output-group chunking of packed WHELL)
    raw_tiles_per_grp = -(-slots_per_group // 8)
    hack8 = g_hack // gh
    tiles_per_g8 = np.zeros(num_groups, np.int64)
    np.add.at(tiles_per_g8, hack8, raw_tiles_per_grp)
    pad_tiles_per_g8 = np.maximum(-(-tiles_per_g8 // ct) * ct, ct)
    g8_base = _excl_cumsum(pad_tiles_per_g8)
    num_tiles = int(pad_tiles_per_g8.sum())
    total_slots = num_tiles * 8
    within = (_excl_cumsum(raw_tiles_per_grp)
              - _excl_cumsum(tiles_per_g8)[hack8])
    g_tile0 = g8_base[hack8] + within

    gid_of = np.repeat(np.arange(n_grp), gsizes)
    gslot = g_tile0[gid_of] * 8 + slot_of  # global slot

    vals = np.zeros((total_slots, _HACK), np.float32)
    res8 = np.zeros((total_slots, _HACK), np.int8)
    pt8 = np.zeros((total_slots, 128), np.int8)
    run_hi = np.full((total_slots, _HACK), -1, np.int8)
    run_lo = np.full((total_slots, _HACK), -1, np.int8)
    vals[gslot, lane_of] = vals_in[order]
    res8[gslot, lane_of] = res_s.astype(np.int8)
    pt8[gslot, res_s] = del_s.astype(np.int8)

    # runs: a row's cells in one slot are contiguous, but deferred cells
    # reorder placement, so find the runs in placement (slot, lane) order
    porder = np.lexsort((lane_of, gslot))
    gs_p = gslot[porder]
    row_p = rows_o[porder]
    lane_p = lane_of[porder]
    newrun = np.r_[True, (gs_p[1:] != gs_p[:-1]) | (row_p[1:] != row_p[:-1])]
    r_starts = np.flatnonzero(newrun)
    r_ends = np.r_[r_starts[1:], gs_p.size] - 1
    r_slot = gs_p[r_starts]
    r_out = (row_p[r_starts] % _HACK).astype(np.int64)
    run_hi[r_slot, r_out] = lane_p[r_ends].astype(np.int8)
    run_lo[r_slot, r_out] = (lane_p[r_starts] - 1).astype(np.int8)

    # per-tile scalars (the layout group, and its low 20 bits |
    # hack-in-group << 20) and per-group superpage base tables
    tile_meta = np.zeros(num_tiles, np.int32)
    tile_page = np.zeros(num_tiles, np.int32)
    g_tiles_idx = np.repeat(g_tile0, raw_tiles_per_grp) + (
        np.arange(int(raw_tiles_per_grp.sum()))
        - np.repeat(_excl_cumsum(raw_tiles_per_grp), raw_tiles_per_grp))
    gidx_of_tile = np.repeat(np.arange(n_grp), raw_tiles_per_grp)
    tile_page[g_tiles_idx] = gidx_of_tile
    tile_meta[g_tiles_idx] = ((gidx_of_tile & 0xFFFFF)
                              | ((g_hack[gidx_of_tile] % gh) << 20)).astype(np.int32)
    chunk_group = np.r_[np.repeat(np.arange(num_groups, dtype=np.int32),
                                  pad_tiles_per_g8 // ct), np.int32(-1)]
    gI = np.searchsorted(g_G, Gu)
    bases = np.zeros((n_grp, K), np.int32)
    bases[gI, tbl_u] = (sup_u * 8).astype(np.int32)

    return make(total_slots, m, values=vals, residue=res8, page_tab=pt8,
                run_hi=run_hi, run_lo=run_lo, tile_base=tile_meta,
                tile_page=tile_page, chunk_group=chunk_group,
                group_bases=bases.reshape(-1))
