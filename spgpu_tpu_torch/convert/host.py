"""Host conversions to the classic layouts (COO → ELL/OELL/HELL/DIA/HDIA/
BCOO/BHDIA), in NumPy.

Counterpart of :mod:`spgpu_tpu.convert.host`: the same nineteen names,
the same arrays cell for cell, and spGPU's semantics as the JAX module
keeps them (``ell.c``, ``hell.c``, ``dia.c``, ``hdia.cpp``, ``coo.cpp``):

* duplicates: ``coo_to_ell``/``coo_to_hell`` keep duplicate coordinates
  as separate slots (both add, ``ell.c:65-78``); ``coo_to_dia`` and
  ``coo_to_hdia`` store into the (row, diagonal) cell, so the last entry
  wins (``dia.c:95-100``);
* explicit zeros are kept, but ``dia_to_hdia`` drops every all-zero
  (hack, diagonal) block, as spGPU's byte-occupancy scan does
  (``hdia.cpp:44-52``);
* OELL sorts rows by descending length, stably (``ell.c:85-157``).

As in the JAX layouts, row axes are padded to 128, slot axes to the
type's slot multiple, hacks are 128 rows by default, ``hack_offsets``
carries a sentinel and HELL/HDIA carry ``slot_to_hack``.  Each converter
builds its arrays on the host and returns the layout on the required
``device``; values are float32, float64, complex64 or complex128.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spgpu_tpu_torch.core import DEFAULT_HACK_SIZE, LANES, round_up, sublanes, value_dtype
from spgpu_tpu_torch.formats._fields import host
from spgpu_tpu_torch.formats.bcoo import BcooMatrix, BhdiaMatrix
from spgpu_tpu_torch.formats.coo import CooMatrix
from spgpu_tpu_torch.formats.dia import DiaMatrix
from spgpu_tpu_torch.formats.ell import EllMatrix
from spgpu_tpu_torch.formats.hdia import HdiaMatrix
from spgpu_tpu_torch.formats.hell import HellMatrix

__all__ = [
    "coo_to_ell",
    "ell_to_oell",
    "ell_to_hell",
    "coo_to_hell",
    "coo_to_dia",
    "dia_to_hdia",
    "coo_to_hdia",
    "coo_to_bcoo",
    "bcoo_to_bhdia",
    "compute_ell_row_lengths",
    "compute_ell_alloc_pitch",
    "compute_hell_alloc_size",
    "compute_dia_diagonals_count",
    "compute_dia_alloc_pitch",
    "get_hdia_hacks_count",
    "compute_hdia_hack_offsets",
    "compute_hdia_hack_offsets_from_coo",
    "coo_to_hdia_size",
    "compute_bcoo_size",
]


def _t(a):
    """A NumPy array this module built (owned, writable) as a CPU tensor
    sharing its memory, or None."""
    return None if a is None else torch.from_numpy(a)


def _dtype(coo: CooMatrix, layout: str) -> np.dtype:
    return value_dtype(coo.values.dtype, layout)


# --- small helpers of spGPU's API (ell.c, hell.c, dia.c, hdia.cpp) ----------


def compute_ell_row_lengths(coo: CooMatrix) -> np.ndarray:
    """Each row's nnz; mirrors ``computeEllRowLenghts`` (``ell.c:5-31``)."""
    return coo.row_lengths()


def compute_ell_alloc_pitch(n_rows: int) -> int:
    """The row axis padded to 128 (``computeEllAllocPitch``, ``ell.c:33-37``,
    pads to 32)."""
    return round_up(max(n_rows, 1), LANES)


def compute_dia_diagonals_count(coo: CooMatrix) -> int:
    """The occupied diagonals (``computeDiaDiagonalsCount``, ``dia.c:11-38``)."""
    if coo.nnz == 0:
        return 0
    return int(np.unique(coo.cols - coo.rows).size)


def get_hdia_hacks_count(n_rows: int, hack_size: int = DEFAULT_HACK_SIZE) -> int:
    """Mirrors ``getHdiaHacksCount`` (``hdia.cpp:8-11``)."""
    return -(-n_rows // hack_size)


def compute_dia_alloc_pitch(n_rows: int) -> int:
    """The DIA row axis padded to 128 (``computeDiaAllocPitch``,
    ``dia.c:5-9``, pads to 32)."""
    return round_up(max(n_rows, 1), LANES)


def compute_hdia_hack_offsets_from_coo(coo: CooMatrix,
                                       hack_size: int = DEFAULT_HACK_SIZE) -> np.ndarray:
    """The prefix sum of each hack's occupied diagonals, ``(hacks + 1,)``
    int64 (``computeHdiaHackOffsetsFromCoo``, ``hdia.cpp:161-228``)."""
    hacks = max(get_hdia_hacks_count(coo.n_rows, hack_size), 1)
    off = np.zeros(hacks + 1, dtype=np.int64)
    if coo.nnz:
        h = coo.rows.astype(np.int64) // hack_size
        d = coo.cols.astype(np.int64) - coo.rows
        # diagonals span [-(n_rows-1), n_cols-1]: biased by n_rows, keyed
        # over a span covering both, so tall and wide shapes don't collide
        span = coo.n_rows + coo.n_cols
        per_hack = np.unique(h * span + (d + coo.n_rows))
        np.cumsum(np.bincount(per_hack // span, minlength=hacks), out=off[1:])
    return off


def compute_hdia_hack_offsets(dia: DiaMatrix,
                              hack_size: int = DEFAULT_HACK_SIZE) -> np.ndarray:
    """The prefix sum of each hack's occupied diagonals from a DIA layout
    (``computeHdiaHackOffsets``, ``hdia.cpp:13-61``): a diagonal counts for
    a hack iff one of its values on the hack's rows is nonzero."""
    vals = host(dia.values)[:, : dia.n_rows]
    hacks = max(get_hdia_hacks_count(dia.n_rows, hack_size), 1)
    off = np.zeros(hacks + 1, dtype=np.int64)
    for hk in range(hacks):
        blk = vals[: dia.n_diags, hk * hack_size:(hk + 1) * hack_size]
        off[hk + 1] = off[hk] + int((blk != 0).any(axis=1).sum())
    return off


def coo_to_hdia_size(coo: CooMatrix, hack_size: int = DEFAULT_HACK_SIZE) -> int:
    """The stored elements of the HDIA conversion (``cooToHdiaSize``,
    ``hdia.cpp:230-249``)."""
    return int(compute_hdia_hack_offsets_from_coo(coo, hack_size)[-1]) * hack_size


def compute_bcoo_size(coo: CooMatrix, block_rows: int, block_cols: int) -> int:
    """The occupied dense blocks (``computeBcooSize``, ``coo.cpp:7-28``)."""
    if coo.nnz == 0:
        return 0
    nbc = -(-coo.n_cols // block_cols)
    return int(np.unique((coo.rows // block_rows) * nbc + coo.cols // block_cols).size)


def _per_row_positions(rows: np.ndarray, counts: np.ndarray) -> tuple:
    """Entries stably sorted by row: ``(order, k)``, ``k`` each entry's
    slot within its row in file order (spGPU's per-row cursor walk,
    ``ell.c:55-78``)."""
    order = np.argsort(rows, kind="stable")
    starts = np.zeros(counts.size + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    k = np.arange(rows.size, dtype=np.int64) - starts[rows[order]]
    return order, k


# --- ELL / OELL -------------------------------------------------------------


def coo_to_ell(coo: CooMatrix, store_row_lengths: bool = True, *, device) -> EllMatrix:
    """COO → :class:`EllMatrix` on ``device`` (``cooToEll``,
    ``ell.c:39-80``).  ``store_row_lengths=False`` gives spGPU's "noRs"
    layout: no ``row_lengths``, every row ``max_nnz_per_row`` long with
    zero padding."""
    dt = _dtype(coo, "ELL")
    counts = coo.row_lengths()
    max_nnz = int(counts.max()) if counts.size and coo.nnz else 0
    width_p = round_up(max(max_nnz, 1), sublanes(dt))
    rows_p = compute_ell_alloc_pitch(coo.n_rows)
    vals = np.zeros((width_p, rows_p), dtype=dt)
    cols = np.zeros((width_p, rows_p), dtype=np.int32)
    if coo.nnz:
        order, k = _per_row_positions(coo.rows, counts)
        r = coo.rows[order]
        vals[k, r] = coo.values[order]
        cols[k, r] = coo.cols[order]
    lens = None
    if store_row_lengths:
        lens = np.zeros(rows_p, dtype=np.int32)
        lens[: coo.n_rows] = counts
    return EllMatrix(_t(vals), _t(cols), _t(lens), None, coo.n_rows, coo.n_cols,
                     max_nnz, float(coo.nnz) / max(coo.n_rows, 1)).to(device)


def ell_to_oell(ell: EllMatrix, *, device) -> EllMatrix:
    """ELL → OELL on ``device``: rows stably sorted by descending length,
    with the stored → original row permutation (``ellToOell``,
    ``ell.c:161-202``).  Padding rows (length 0) sort after every real row
    of their length, so ``row_perm[i] >= n_rows`` exactly for them.  The
    order is found on the host; the slabs are permuted on ``ell``'s
    device."""
    if ell.row_lengths is None:
        raise ValueError("OELL requires row_lengths (not available in noRs mode)")
    lens = host(ell.row_lengths)
    perm = np.argsort(-lens.astype(np.int64), kind="stable").astype(np.int32)
    cols = torch.from_numpy(perm.astype(np.int64)).to(ell.device)
    return EllMatrix(ell.values.index_select(1, cols), ell.col_indices.index_select(1, cols),
                     _t(lens[perm]), _t(perm), ell.n_rows, ell.n_cols,
                     ell.max_nnz_per_row, ell.avg_nnz_per_row).to(device)


# --- HELL -------------------------------------------------------------------


def compute_hell_alloc_size(counts: np.ndarray, n_rows: int, hack_size: int,
                            dtype=np.float32) -> int:
    """The sum of each hack's padded widest row (``computeHellAllocSize``,
    ``hell.c:4-44``, with slot-multiple padding)."""
    return int(_hack_widths(counts, n_rows, hack_size, dtype).sum())


def _hack_widths(counts, n_rows, hack_size, dtype) -> np.ndarray:
    rows_p = round_up(max(n_rows, 1), hack_size)
    lens = np.zeros(rows_p, dtype=np.int64)
    lens[:n_rows] = counts[:n_rows]
    w = lens.reshape(-1, hack_size).max(axis=1)
    sl = sublanes(dtype)
    w = ((w + sl - 1) // sl) * sl
    if w.sum() == 0:
        w[0] = sl  # no zero-sized arrays for an empty matrix
    return w


def _hell(vals, cols, w, lens, perm, n_rows, n_cols, hack_size, avg, device):
    """A :class:`HellMatrix` from its slabs, hack widths ``w``, row lengths
    and stored → original permutation (None: none), on ``device``."""
    num_hacks = w.size
    hack_off = np.zeros(num_hacks + 1, dtype=np.int32)
    np.cumsum(w, out=hack_off[1:])
    rows_p = num_hacks * hack_size
    lens_p = np.zeros(rows_p, dtype=np.int32)
    lens_p[: min(lens.size, rows_p)] = lens[: min(lens.size, rows_p)]
    perm_p = None
    if perm is not None:
        perm_p = np.arange(rows_p, dtype=np.int32)
        perm_p[: perm.size] = perm
    return HellMatrix(
        _t(vals), _t(cols), _t(hack_off),
        _t(np.repeat(np.arange(num_hacks, dtype=np.int32), w)), _t(lens_p), _t(perm_p),
        n_rows, n_cols, hack_size, int(hack_off[-1]), int(w.max()) if w.size else 0,
        avg).to(device)


def coo_to_hell(coo: CooMatrix, hack_size: int = DEFAULT_HACK_SIZE,
                row_perm: Optional[np.ndarray] = None, *, device) -> HellMatrix:
    """COO → :class:`HellMatrix` on ``device``, directly (spGPU goes COO →
    ELL → HELL, ``hellPerf.cpp:254-280``).  ``row_perm`` (stored →
    original, as :func:`ell_to_oell` orders rows) gives a hacked OELL: rows
    are permuted before they are hacked."""
    dt = _dtype(coo, "HELL")
    if row_perm is not None:
        row_perm = np.asarray(row_perm, dtype=np.int32)
        stored_of_orig = np.full(coo.n_rows, -1, dtype=np.int64)
        valid = row_perm < coo.n_rows
        stored_of_orig[row_perm[valid]] = np.nonzero(valid)[0]
        eff_rows = stored_of_orig[coo.rows]
        n_stored_rows = int(row_perm.size)
        counts = np.bincount(eff_rows, minlength=n_stored_rows).astype(np.int32)
    else:
        eff_rows, counts, n_stored_rows = coo.rows, coo.row_lengths(), coo.n_rows
    w = _hack_widths(counts, n_stored_rows, hack_size, dt)
    hack_off = np.concatenate([[0], np.cumsum(w)])
    vals = np.zeros((int(hack_off[-1]), hack_size), dtype=dt)
    cols = np.zeros((int(hack_off[-1]), hack_size), dtype=np.int32)
    if coo.nnz:
        order, k = _per_row_positions(eff_rows, counts)
        r = eff_rows[order]
        slot = hack_off[r // hack_size] + k
        vals[slot, r % hack_size] = coo.values[order]
        cols[slot, r % hack_size] = coo.cols[order]
    return _hell(vals, cols, w, counts, row_perm, coo.n_rows, coo.n_cols, hack_size,
                 float(coo.nnz) / max(coo.n_rows, 1), device)


def ell_to_hell(ell: EllMatrix, hack_size: int = DEFAULT_HACK_SIZE, *,
                device) -> HellMatrix:
    """ELL → :class:`HellMatrix` on ``device`` (``ellToHell``,
    ``hell.c:46-104``), carrying an OELL's ``row_perm`` over (the hacked
    OELL of ``hellPerf.cpp:323-344``)."""
    if ell.row_lengths is None:
        raise ValueError("ell_to_hell requires row_lengths")
    lens, evals, ecols = host(ell.row_lengths), host(ell.values), host(ell.col_indices)
    rows_p0 = evals.shape[1]
    w = _hack_widths(lens, rows_p0, hack_size, evals.dtype)
    hack_off = np.concatenate([[0], np.cumsum(w)])
    vals = np.zeros((int(hack_off[-1]), hack_size), dtype=evals.dtype)
    cols = np.zeros((int(hack_off[-1]), hack_size), dtype=np.int32)
    for h in range(w.size):
        r0, r1 = h * hack_size, min((h + 1) * hack_size, rows_p0)
        if r1 <= r0:
            continue
        take = min(int(w[h]), evals.shape[0])
        vals[hack_off[h]: hack_off[h] + take, : r1 - r0] = evals[:take, r0:r1]
        cols[hack_off[h]: hack_off[h] + take, : r1 - r0] = ecols[:take, r0:r1]
    perm = None if ell.row_perm is None else host(ell.row_perm)
    return _hell(vals, cols, w, lens, perm, ell.n_rows, ell.n_cols, hack_size,
                 ell.avg_nnz_per_row, device)


# --- DIA / HDIA -------------------------------------------------------------


def coo_to_dia(coo: CooMatrix, *, device) -> DiaMatrix:
    """COO → :class:`DiaMatrix` on ``device`` (``coo2dia``,
    ``dia.c:40-104``): diagonals ascending by offset, the last write of a
    duplicated coordinate wins."""
    dt = _dtype(coo, "DIA")
    rows_p = compute_ell_alloc_pitch(coo.n_rows)
    if coo.nnz == 0:
        sl = sublanes(dt)
        return DiaMatrix(torch.zeros((sl, rows_p), dtype=getattr(torch, dt.name)),
                         torch.full((sl,), coo.n_cols, dtype=torch.int32),
                         coo.n_rows, coo.n_cols, 0).to(device)
    offs_all = coo.cols - coo.rows
    uniq = np.unique(offs_all)
    n_diags = int(uniq.size)
    diags_p = round_up(n_diags, sublanes(dt))
    vals = np.zeros((diags_p, rows_p), dtype=dt)
    vals[np.searchsorted(uniq, offs_all), coo.rows] = coo.values  # last write wins
    offsets = np.full(diags_p, coo.n_cols, dtype=np.int32)
    offsets[:n_diags] = uniq
    return DiaMatrix(_t(vals), _t(offsets), coo.n_rows, coo.n_cols, n_diags).to(device)


def _build_hdia(fill, hack_of_entry, off_of_entry, num_hacks, n_cols_sentinel,
                hack_size, dtype, block_shape=()):
    """The HDIA slots of per-entry (hack, offset) keys, hacks ascending and
    each hack's offsets ascending (``hdia.cpp:68-153``); ``fill(vals,
    slot_of_entry)`` stores the entries.  Returns (values, offsets,
    hack_offsets, slot_to_hack, total, max_hack_diags)."""
    span = int(off_of_entry.max() - off_of_entry.min()) + 1 if off_of_entry.size else 1
    off0 = int(off_of_entry.min()) if off_of_entry.size else 0
    key = hack_of_entry.astype(np.int64) * span + (off_of_entry - off0)
    uniq_keys, inv = np.unique(key, return_inverse=True)
    uh = (uniq_keys // span).astype(np.int64)
    uo = (uniq_keys % span + off0).astype(np.int64)
    counts = np.bincount(uh, minlength=num_hacks)
    sl = sublanes(dtype)
    w = ((counts + sl - 1) // sl) * sl
    if w.sum() == 0:
        w = w.copy()
        w[0] = sl
    hack_off = np.zeros(num_hacks + 1, dtype=np.int32)
    np.cumsum(w, out=hack_off[1:])
    total = int(hack_off[-1])
    starts = np.zeros(num_hacks + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot_of_uniq = hack_off[uh] + (np.arange(uniq_keys.size) - starts[uh])
    vals = np.zeros((total, hack_size) + block_shape, dtype=dtype)
    fill(vals, slot_of_uniq[inv])
    offsets = np.full(total, n_cols_sentinel, dtype=np.int32)
    offsets[slot_of_uniq] = uo
    s2h = np.repeat(np.arange(num_hacks, dtype=np.int32), w)
    return vals, offsets, hack_off, s2h, total, int(counts.max()) if counts.size else 0


def coo_to_hdia(coo: CooMatrix, hack_size: int = DEFAULT_HACK_SIZE, *,
                device) -> HdiaMatrix:
    """COO → :class:`HdiaMatrix` on ``device``, directly (``cooToHdia``
    and ``computeHdiaHackOffsetsFromCoo``, ``hdia.cpp:161-348``); the last
    write of a duplicated coordinate wins."""
    dt = _dtype(coo, "HDIA")
    num_hacks = max(get_hdia_hacks_count(coo.n_rows, hack_size), 1)
    if coo.nnz == 0:
        sl = sublanes(dt)
        return HdiaMatrix(
            torch.zeros((sl, hack_size), dtype=getattr(torch, dt.name)),
            torch.full((sl,), coo.n_cols, dtype=torch.int32),
            _t(np.concatenate([[0], np.full(num_hacks, sl)]).astype(np.int32)),
            torch.zeros((sl,), dtype=torch.int32), coo.n_rows, coo.n_cols,
            hack_size, sl, 0).to(device)
    lane = coo.rows % hack_size

    def fill(vals, slot_of_entry):
        vals[slot_of_entry, lane] = coo.values

    vals, offsets, hack_off, s2h, total, max_diags = _build_hdia(
        fill, coo.rows // hack_size, coo.cols - coo.rows, num_hacks, coo.n_cols,
        hack_size, dt)
    return HdiaMatrix(_t(vals), _t(offsets), _t(hack_off), _t(s2h), coo.n_rows,
                      coo.n_cols, hack_size, total, max_diags).to(device)


def dia_to_hdia(dia: DiaMatrix, hack_size: int = DEFAULT_HACK_SIZE, *,
                device) -> HdiaMatrix:
    """DIA → :class:`HdiaMatrix` on ``device`` (``computeHdiaHackOffsets``
    and ``diaToHdia``, ``hdia.cpp:13-153``): a (hack, diagonal) block is
    kept iff one of its values is nonzero, so stored zeros on an otherwise
    empty block are dropped."""
    vals0 = host(dia.values)[: dia.n_diags]
    offs0 = host(dia.offsets)[: dia.n_diags]
    num_hacks = max(get_hdia_hacks_count(dia.n_rows, hack_size), 1)
    rows_hp = num_hacks * hack_size
    if vals0.shape[1] < rows_hp:
        vals0 = np.pad(vals0, ((0, 0), (0, rows_hp - vals0.shape[1])))
    blocks = vals0[:, :rows_hp].reshape(dia.n_diags, num_hacks, hack_size)
    d_idx, h_idx = np.nonzero((blocks != 0).any(axis=2))
    # by (hack, offset): DIA offsets ascend, so (h, d) order keeps them so
    order = np.lexsort((d_idx, h_idx))
    d_idx, h_idx = d_idx[order], h_idx[order]

    def fill(vals, slot_of_entry):
        vals[slot_of_entry] = blocks[d_idx, h_idx]

    vals, offsets, hack_off, s2h, total, max_diags = _build_hdia(
        fill, h_idx.astype(np.int64), offs0[d_idx].astype(np.int64), num_hacks,
        dia.n_cols, hack_size, vals0.dtype)
    return HdiaMatrix(_t(vals), _t(offsets), _t(hack_off), _t(s2h), dia.n_rows,
                      dia.n_cols, hack_size, total, max_diags).to(device)


# --- BCOO / BHDIA -----------------------------------------------------------


def coo_to_bcoo(coo: CooMatrix, block_rows: int, block_cols: int, *,
                device) -> BcooMatrix:
    """COO → :class:`BcooMatrix` on ``device`` (``computeBcooSize`` and
    ``cooToBcoo``, ``coo.cpp:7-96``): blocks in (block row, block column)
    order, the last write of a duplicated coordinate wins."""
    dt = _dtype(coo, "BCOO")
    nbc = -(-coo.n_cols // block_cols)
    uniq, inv = np.unique((coo.rows // block_rows) * nbc + coo.cols // block_cols,
                          return_inverse=True)
    blocks = np.zeros((max(int(uniq.size), 1), block_rows, block_cols), dtype=dt)
    if coo.nnz:
        blocks[inv, coo.rows % block_rows, coo.cols % block_cols] = coo.values
    bri = (uniq // nbc).astype(np.int32) if uniq.size else np.zeros(1, np.int32)
    bci = (uniq % nbc).astype(np.int32) if uniq.size else np.zeros(1, np.int32)
    return BcooMatrix(_t(bri), _t(bci), _t(blocks), coo.n_rows, coo.n_cols,
                      block_rows, block_cols).to(device)


def bcoo_to_bhdia(bcoo: BcooMatrix, hack_size: int = 32, *, device) -> BhdiaMatrix:
    """BCOO → :class:`BhdiaMatrix` on ``device`` (``bcooToBhdia``,
    ``hdia.cpp:351-373``): HDIA over block coordinates, each element a
    dense block."""
    bri = host(bcoo.block_row_idx).astype(np.int64)
    bci = host(bcoo.block_col_idx).astype(np.int64)
    blocks = host(bcoo.blocks)
    num_hacks = max(-(-bcoo.n_block_rows // hack_size), 1)
    lane = bri % hack_size

    def fill(vals, slot_of_entry):
        vals[slot_of_entry, lane] = blocks

    vals, offsets, hack_off, s2h, _, _ = _build_hdia(
        fill, bri // hack_size, bci - bri, num_hacks, bcoo.n_block_cols, hack_size,
        blocks.dtype, block_shape=(bcoo.block_rows, bcoo.block_cols))
    return BhdiaMatrix(_t(vals), _t(offsets), _t(hack_off), _t(s2h), bcoo.n_rows,
                       bcoo.n_cols, bcoo.block_rows, bcoo.block_cols,
                       hack_size).to(device)
