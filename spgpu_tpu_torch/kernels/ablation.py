"""Kernels #18 and #19: the per-op cycle accounts of the WHDIA (#3) and
float64 packed WHELL (#4) SpMVs, hand-written in CUDA C++.

Replaces the ``call`` closures of ``doc/sweeps/whdia_ablation.py`` (#18:
its ``pallas_call`` runs ``_whdia_kernel``'s body cut after one op
family, pattern-mode fp32) and ``doc/sweeps/dd_ablation.py`` (#19: the
same for ``_whell_packed_dd_kernel``, double-float on the TPU, float64
here).  Each level is a production body of its source cut after one op
family (``whdia_tile``, ``warp_hack`` and ``hack_body`` in
``csrc/whdia_spmv.cu``, ``whell_hack_pass`` in
``csrc/whell_packed_spmv.cu``; their header notes give the design), so
that the differences between levels price one family each:

* #18's tile levels (:data:`WHDIA_LEVELS`, :func:`whdia_ablation`), on
  the fp32 tile pass (#3's design before it read only the live slots,
  and #6's and #10's before they did): ``stream`` (each lane's 8 values, summed as
  ``1.5·v``), ``r0`` (+ the r0 decode and the column, kept live as
  ``v·(col & 127)``), ``gather`` (+ the guarded x read: the tile sum) and
  ``full`` (+ one atomicAdd per lane into a zeroed z: the fp32 tile
  pass);
* #18's hack levels (:data:`HACK_LEVELS`, :func:`whdia_hack_ablation`),
  on the production #3 (``warp_hack``: one warp per hack over its live
  slots) for an ``(n_cols,)`` x, and on #13 (``hack_body``: one block per
  hack) for an ``(n_rhs, n_cols)`` stack: ``launch`` (each hack's list
  bounds; its live-slot count stored in each of its rows), ``list`` (+
  the list entries, their tile words and r0 and the column: each cell
  adds its key ``(col + slot) & 127``), ``stream`` (+ the live values,
  ``v·key``) and ``full`` (+ the guarded x gathers: the production
  ``whdia_spmv`` or ``whdia_spmm`` launch), each row stored once;
* #19 (:data:`F64_LEVELS`), on the production hack pass of #4
  (``whell_hack_pass``: one block per hack row, the run's index bytes
  brought into shared memory by bulk copies, its values streamed):
  ``stream`` (each cell's value, residue and page-table bytes summed as
  ``1.5·v + r + d``), ``gather`` (+ the decode and the x gather), ``own`` (+ each
  lane's register sum over its hack's run, stored unscanned) and
  ``full`` (+ the scan and segment difference: the production
  ``whell_packed_spmv_f64`` launch).

Below ``full`` (``own`` for #19) a tile level returns its lane sums, one
plain store per lane: ``part`` ``(num_tiles, 128)``; every hack level
returns the rows of the product's shape.  :data:`TPU_LEVELS`
maps each level of the TPU scripts to the card level that covers it, or
to None with the reason it has no counterpart; :data:`RETIRED_LEVELS`
names the card levels that the production code no longer has, and why.

:func:`whdia_ablation`, :func:`whdia_hack_ablation` and
:func:`whell_f64_ablation` launch for CUDA tensors (or raise) and run
:func:`whdia_ablation_plain` / :func:`whdia_hack_ablation_plain` /
:func:`whell_f64_ablation_plain`, the plain PyTorch versions of the same
functions, for CPU tensors.  ``LAUNCHES_WHDIA_ABLATION`` (#18, both
level sets) and ``LAUNCHES_F64_ABLATION`` count their launches, every
level included.
The entries live in the production sources and are bound through their
libraries (:mod:`spgpu_tpu_torch.kernels.whdia`,
:mod:`spgpu_tpu_torch.kernels.whell`).
"""

from __future__ import annotations

from typing import Optional

import torch

from spgpu_tpu_torch.kernels import whdia as _whdia
from spgpu_tpu_torch.kernels import whell as _whell

__all__ = ["F64_LEVELS", "HACK_LEVELS", "LAUNCHES_F64_ABLATION",
           "LAUNCHES_WHDIA_ABLATION", "LEVEL_ADDS", "RETIRED_LEVELS",
           "TPU_LEVELS", "WHDIA_LEVELS", "whdia_ablation",
           "whdia_ablation_plain", "whdia_hack_ablation",
           "whdia_hack_ablation_plain", "whell_f64_ablation",
           "whell_f64_ablation_plain"]

#: launches of kernel #18 and #19 so far, every level; the CPU path does
#: not count
LAUNCHES_WHDIA_ABLATION = 0
LAUNCHES_F64_ABLATION = 0

#: the card levels, in the order they add op families (the C entries'
#: level codes are the positions)
WHDIA_LEVELS = ("stream", "r0", "gather", "full")
HACK_LEVELS = ("launch", "list", "stream", "full")
F64_LEVELS = ("stream", "gather", "own", "full")

#: what each card level adds to the one before it
LEVEL_ADDS = {
    "whdia": {
        "stream": "each lane reads its 8 values (4 B/cell) and sums 1.5·v",
        "r0": "the tile_r0/slot_r0 decode and the column, kept live as "
              "v·(col & 127)",
        "gather": "the guarded x read at the column: the tile sum",
        "full": "one atomicAdd per lane into the hack row of a zeroed z: the "
                "fp32 tile pass (the card's WHDIA has no flush; every "
                "production WHDIA SpMV reads only the live slots, and "
                "whdia_spmv is the hack levels' full)",
    },
    "whdia_hack": {
        "launch": "the block start and the store: each hack's hack_slot_ptr "
                  "pair, its live-slot count stored in each of its rows (a "
                  "warp per hack at 1 RHS, a block per hack at 8)",
        "list": "the chain of dependent loads: the hack's list entries, their "
                "tile words and r0 and the column, each cell adding its key "
                "(col + slot) & 127",
        "stream": "the live slots' values (4 B/cell), summed as v·key",
        "full": "the guarded x gathers: the production launch (whdia_spmv, "
                "kernel #3, at 1 RHS; whdia_spmm, kernel #13, at 8)",
    },
    "f64": {
        "stream": "each cell's value (8 B) streamed from global memory and "
                  "its residue and page-table bytes bulk-copied into shared "
                  "memory, summed as 1.5·v + r + d (10 B/cell), a 1 KiB "
                  "store per tile",
        "gather": "the cell's column from shared memory and the x gather: "
                  "the production tile sum, still stored per tile",
        "own": "each lane's register sum over its hack's run, one unscanned "
               "store per hack row in place of the per-tile stores",
        "full": "the scan and segment difference in the same block: the "
                "production whell_packed_spmv_f64 launch",
    },
}

#: card levels that an earlier production body had and this one has not,
#: with the reason
RETIRED_LEVELS = {
    "whdia_hack": {
        "atomic": "one atomicAdd per lane and tile into a zero-filled z (the "
                  "tile levels' full less gather, with the part store): #3 "
                  "sums each hack's live slots in registers and stores each "
                  "row once, so it has no atomics to price",
    },
    "f64": {
        "atomic": "one atomicAdd(double) per lane and tile into a zeroed "
                  "accumulator, then a flush launch: the hack pass owns "
                  "each hack row in one block, sums its run in registers "
                  "and scans it in place, so it has no atomics to price",
    },
}

#: each level of the TPU scripts (doc/sweeps/whdia_ablation.py:8-13,
#: dd_ablation.py:7-15) -> (the card level that covers it, or None, and
#: why), for each card level set
TPU_LEVELS = {
    "whdia": {
        "stream": ("stream", "the value slab and a register FMA"),
        "r0": ("r0", "the packed tile_r0 decode"),
        "sgather": ("gather", "the card reads x with one cached global load: "
                              "it has no sublane/lane gather split"),
        "lgather": ("gather", "the same load as sgather"),
        "rmw": ("full", "the accumulate is one atomicAdd per lane; the card's "
                        "WHDIA has no flush, so full - gather is the atomics "
                        "less the part store that gather makes"),
        "full": ("full", "the fp32 tile pass (the production #3 is the hack "
                         "levels' full)"),
    },
    "whdia_hack": {
        "stream": ("stream", "the live slots' values and a register FMA (the "
                             "TPU streams every slot)"),
        "r0": ("list", "the r0 decode and the column, behind the list entries "
                       "that the card reads first"),
        "sgather": ("full", "the card reads x with one cached global load: it "
                            "has no sublane/lane gather split"),
        "lgather": ("full", "the same load as sgather"),
        "rmw": (None, "no accumulate in memory: each row's sum stays in "
                      "registers and is stored once, in every level"),
        "full": ("full", "the production kernel"),
    },
    "f64": {
        "stream": ("stream", "10 B/cell on both: 8 B of value (hi/lo fp32 on "
                             "the TPU) and the two index bytes"),
        "gather": ("gather", "one x gather of a float64 x (two x-plane "
                             "gather chains on the TPU)"),
        "eft": (None, "TwoProd and the cross terms are double-float "
                      "arithmetic, which the port does not have: float64 "
                      "FMA is native on the card"),
        "ddrmw": (None, "the double-float accumulate (two_sum chain) has no "
                        "counterpart; the card's accumulate is one float64 "
                        "FMA into a register per cell, inside the gather "
                        "and own levels"),
        "norelax": (None, "relaxes the double-float renormalisation, which "
                          "native float64 does not do"),
        "full": ("full", "the production kernel"),
    },
}


def _code(level: str, levels, op: str) -> int:
    if level not in levels:
        raise ValueError(f"{op}: level must be one of {levels}, not {level!r}")
    return levels.index(level)


def whdia_ablation(level: str, values, slot_r0: Optional[torch.Tensor],
                   tile_r0: Optional[torch.Tensor], tile_base, chunk_group, x,
                   *, chunk_tiles: int, group_hacks: int, num_groups: int,
                   tile_page: torch.Tensor) -> torch.Tensor:
    """Kernel #18 at ``level`` (:data:`WHDIA_LEVELS`) on an fp32 WHDIA
    layout in either r0 mode and ``x`` ``(n_cols,)`` fp32: ``part``
    ``(num_tiles, 128)`` below ``full``, the product
    ``(num_groups*group_hacks*128,)`` at ``full``.

    CUDA tensors launch the kernel (counted in
    ``LAUNCHES_WHDIA_ABLATION``); CPU tensors run
    :func:`whdia_ablation_plain`.  Any other device raises."""
    code = _code(level, WHDIA_LEVELS, "whdia_ablation")
    _whdia._check_args("whdia_ablation", values, slot_r0, tile_r0, tile_base,
                       chunk_group, x, chunk_tiles, tile_page)
    if values.dtype != torch.float32:
        raise ValueError(f"whdia_ablation: bad values: kernel #18 takes "
                         f"float32, not {values.dtype}")
    static = dict(chunk_tiles=chunk_tiles, group_hacks=group_hacks,
                  num_groups=num_groups)
    dev = x.device
    if dev.type == "cpu":
        return whdia_ablation_plain(level, values, slot_r0, tile_r0, tile_base,
                                    chunk_group, x, tile_page=tile_page, **static)
    lib = _whdia._LIB.load()
    T = tile_base.shape[0]
    out = (torch.zeros(num_groups * group_hacks * 128, dtype=x.dtype, device=dev)
           if level == "full" else torch.empty((T, 128), dtype=x.dtype, device=dev))
    err = lib.whdia_ablation(
        code, values.data_ptr(), *_whdia._r0_ptrs(slot_r0, tile_r0),
        tile_base.data_ptr(), tile_page.data_ptr(), chunk_group.data_ptr(),
        x.data_ptr(), out.data_ptr(), T, x.shape[0], chunk_tiles, group_hacks,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"whdia_ablation({level!r}) launch failed: CUDA "
                           f"error {err}")
    global LAUNCHES_WHDIA_ABLATION
    LAUNCHES_WHDIA_ABLATION += 1
    return out


def whdia_ablation_plain(level: str, values, slot_r0, tile_r0, tile_base,
                         chunk_group, x, *, chunk_tiles: int, group_hacks: int,
                         num_groups: int, tile_page: torch.Tensor) -> torch.Tensor:
    """Kernel #18's function at ``level`` in plain PyTorch, on the
    operands' device: the gathers of :func:`~spgpu_tpu_torch.kernels.whdia.
    whdia_spmm_plain`, cut where the level cuts the tile pass."""
    _code(level, WHDIA_LEVELS, "whdia_ablation_plain")
    if level == "full":
        return _whdia.whdia_spmv_plain(values, slot_r0, tile_r0, tile_base,
                                       chunk_group, x, chunk_tiles=chunk_tiles,
                                       group_hacks=group_hacks,
                                       num_groups=num_groups, tile_page=tile_page)
    v = values.view(tile_base.shape[0], 8, 128)
    if level == "stream":
        return (v * 1.5).sum(dim=1)
    if level == "r0":
        col = _whdia.whdia_columns(slot_r0, tile_r0, tile_base, tile_page=tile_page)
        return (v * (col & 127).to(v.dtype)).sum(dim=1)
    return _whdia.whdia_tile_sums(values, slot_r0, tile_r0, tile_base,
                                  x.unsqueeze(0), tile_page=tile_page)[0]


def whdia_hack_ablation(level: str, values, slot_r0: Optional[torch.Tensor],
                        tile_r0: Optional[torch.Tensor], tile_base, chunk_group,
                        x, *, chunk_tiles: int, group_hacks: int, num_groups: int,
                        hack_slot_ptr: torch.Tensor, hack_slots: torch.Tensor,
                        tile_page: torch.Tensor) -> torch.Tensor:
    """Kernel #18's hack level ``level`` (:data:`HACK_LEVELS`) on an fp32
    WHDIA layout in either r0 mode and its live-slot list: the rows of
    #3's warp pass for ``x`` ``(n_cols,)`` (``(num_groups*group_hacks*128,)``)
    or of #13's hack pass for ``x`` ``(n_rhs, n_cols)`` (``(n_rhs,
    num_groups*group_hacks*128)``), cut where the level cuts it; ``full``
    is the production launch.

    CUDA tensors launch the kernel (counted in
    ``LAUNCHES_WHDIA_ABLATION``); CPU tensors run
    :func:`whdia_hack_ablation_plain`.  Any other device raises."""
    code = _code(level, HACK_LEVELS, "whdia_hack_ablation")
    if values.dtype != torch.float32 or x.dim() not in (1, 2):
        raise ValueError(f"whdia_hack_ablation: bad values or x: kernel #18 "
                         f"takes float32 values and an (n_cols,) or (n_rhs, "
                         f"n_cols) x, not {values.dtype} and {tuple(x.shape)}")
    spmm = x.dim() == 2
    hacks = num_groups * group_hacks
    _whdia._check_args("whdia_spmm" if spmm else "whdia_spmv", values, slot_r0,
                       tile_r0, tile_base, chunk_group, x, chunk_tiles, tile_page)
    dev = x.device
    if dev.type == "cpu":
        return whdia_hack_ablation_plain(
            level, values, slot_r0, tile_r0, tile_base, chunk_group, x,
            chunk_tiles=chunk_tiles, group_hacks=group_hacks, num_groups=num_groups,
            hack_slot_ptr=hack_slot_ptr, hack_slots=hack_slots, tile_page=tile_page)
    lists = _whdia._list_ptrs("whdia_hack_ablation", hack_slot_ptr, hack_slots,
                              hacks, dev)
    _whdia._check_aligned("whdia_hack_ablation", values)
    lib = _whdia._LIB.load()
    n_rhs = x.shape[0] if spmm else 1
    out = torch.empty((n_rhs, hacks * 128) if spmm else (hacks * 128,),
                      dtype=x.dtype, device=dev)
    err = lib.whdia_hack_ablation(
        code, int(spmm), values.data_ptr(), *_whdia._r0_ptrs(slot_r0, tile_r0),
        tile_page.data_ptr(), *lists, x.data_ptr(), out.data_ptr(), hacks,
        x.shape[-1], hacks * 128, n_rhs, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"whdia_hack_ablation({level!r}) launch failed: CUDA "
                           f"error {err}")
    global LAUNCHES_WHDIA_ABLATION
    LAUNCHES_WHDIA_ABLATION += 1
    return out


def whdia_hack_ablation_plain(level: str, values, slot_r0, tile_r0, tile_base,
                              chunk_group, x, *, chunk_tiles: int, group_hacks: int,
                              num_groups: int, hack_slot_ptr, hack_slots,
                              tile_page: torch.Tensor) -> torch.Tensor:
    """Kernel #18's hack level ``level`` in plain PyTorch, on the
    operands' device: each hack's rows sum its listed slots' terms in list
    order (:func:`~spgpu_tpu_torch.kernels.whdia.whdia_listed_sum`), the
    same for every RHS below ``full``: ``launch`` the hack's live-slot
    count, ``list`` each cell's key ``(col + slot) & 127``, ``stream``
    ``v·key``; ``full`` is :func:`~spgpu_tpu_torch.kernels.whdia.
    whdia_spmm_listed_plain`.  ``chunk_group`` and ``chunk_tiles`` are
    not read (the wrapper's checks take them)."""
    _code(level, HACK_LEVELS, "whdia_hack_ablation_plain")
    xs = x if x.dim() == 2 else x.unsqueeze(0)
    n_rhs, hacks = xs.shape[0], num_groups * group_hacks
    if level == "full":
        out = _whdia.whdia_spmm_listed_plain(values, slot_r0, tile_r0, tile_base,
                                             hack_slot_ptr, hack_slots, xs,
                                             group_hacks=group_hacks,
                                             num_groups=num_groups, tile_page=tile_page)
    elif level == "launch":
        ptr = hack_slot_ptr.long()
        count = (ptr[1:] - ptr[:-1]).to(values.dtype)
        out = count.repeat_interleave(128).expand(n_rhs, -1)
    else:
        slots = hack_slots.long()
        col = _whdia.whdia_listed_columns(slot_r0, tile_r0, tile_base, hack_slots,
                                          tile_page=tile_page)
        key = ((col + slots[:, None]) & 127).to(values.dtype)
        terms = key if level == "list" else values[slots] * key
        out = _whdia.whdia_listed_sum(terms[None], hack_slot_ptr, hacks).expand(n_rhs, -1)
    out = out.contiguous()
    return out if x.dim() == 2 else out[0]


def whell_f64_ablation(level: str, values, residue, page_tab, tile_base,
                       chunk_group, group_bases: Optional[torch.Tensor],
                       seg_lo, seg_hi, x2d, *, chunk_tiles: int,
                       group_hacks: int, window_pages: int,
                       unit_segments: bool, hack_units: torch.Tensor,
                       tile_page: torch.Tensor) -> torch.Tensor:
    """Kernel #19 at ``level`` (:data:`F64_LEVELS`) on a float64 packed
    WHELL layout (aligned or scattered windows), its work units
    (``WhellMatrix.hack_units``) and lane-space
    ``x2d`` ``(x_pages, 128)`` float64: ``part`` ``(num_tiles, 128)`` at
    ``stream`` and ``gather`` (zero on tiles outside every run), the
    unscanned row sums ``(num_groups*group_hacks, 128)`` at ``own``, the
    product (same shape) at ``full``.

    CUDA tensors launch the kernel (counted in
    ``LAUNCHES_F64_ABLATION``); CPU tensors run
    :func:`whell_f64_ablation_plain`.  Any other device raises."""
    code = _code(level, F64_LEVELS, "whell_f64_ablation")
    _whell._check_args("whell_f64_ablation", values, residue, page_tab,
                       tile_base, chunk_group, group_bases, seg_lo, seg_hi,
                       x2d, chunk_tiles, group_hacks, window_pages, tile_page)
    if values.dtype != torch.float64:
        raise ValueError(f"whell_f64_ablation: bad values: kernel #19 takes "
                         f"float64, not {values.dtype}")
    _whell._check_units("whell_f64_ablation", hack_units, values, seg_lo)
    static = dict(chunk_tiles=chunk_tiles, group_hacks=group_hacks,
                  window_pages=window_pages, unit_segments=unit_segments)
    dev = x2d.device
    if dev.type == "cpu":
        return whell_f64_ablation_plain(level, values, residue, page_tab,
                                        tile_base, chunk_group, group_bases,
                                        seg_lo, seg_hi, x2d, hack_units=hack_units,
                                        tile_page=tile_page, **static)
    lib = _whell._LIB.load()
    rows = tile_base.shape[0] if level in ("stream", "gather") else seg_lo.shape[0]
    # the part rows of tiles outside every run are never written
    out = (torch.zeros if level in ("stream", "gather") else torch.empty)(
        (rows, 128), dtype=x2d.dtype, device=dev)
    err = lib.whell_packed_ablation_f64(
        code, values.data_ptr(), *_whell.hack_pass_args(
            "whell_f64_ablation", values, residue, page_tab, tile_page,
            group_bases, hack_units, seg_lo, seg_hi, x2d, out, window_pages,
            unit_segments))
    if err != 0:
        raise RuntimeError(f"whell_f64_ablation({level!r}) launch failed: "
                           f"CUDA error {err}")
    global LAUNCHES_F64_ABLATION
    LAUNCHES_F64_ABLATION += 1
    return out


def whell_f64_ablation_plain(level: str, values, residue, page_tab,
                             tile_base, chunk_group, group_bases, seg_lo,
                             seg_hi, x2d, *, chunk_tiles: int,
                             group_hacks: int, window_pages: int,
                             unit_segments: bool, hack_units: torch.Tensor,
                             tile_page: torch.Tensor) -> torch.Tensor:
    """Kernel #19's function at ``level`` in plain PyTorch, on the
    operands' device: the products of :func:`~spgpu_tpu_torch.kernels.
    whell.whell_hack_sums` and its flush, cut where the level cuts the
    kernel (``stream`` and ``gather`` zero the tiles outside every unit)."""
    _code(level, F64_LEVELS, "whell_f64_ablation_plain")
    T = tile_base.shape[0]
    if level in ("stream", "gather"):
        if level == "stream":
            index_bytes = (residue.long() + page_tab.long()).to(values.dtype)
            part = (values * 1.5 + index_bytes).view(T, 8, 128).sum(dim=1)
        else:
            part = _whell.whell_cell_products(
                values, residue, page_tab, tile_base, group_bases,
                x2d.unsqueeze(0), window_pages=window_pages,
                tile_page=tile_page)[0][0].sum(dim=1)
        run = torch.zeros(T + 1, dtype=torch.long, device=part.device)
        begin, end = hack_units[:, 0].long(), hack_units[:, 1].long()
        run.index_add_(0, begin, torch.ones_like(begin))
        run.index_add_(0, end, -torch.ones_like(end))
        return torch.where((run.cumsum(0)[:T] > 0)[:, None], part, 0.0)
    acc = _whell.whell_hack_sums(values, residue, page_tab, tile_base,
                                 group_bases, hack_units, x2d.unsqueeze(0),
                                 num_rows=seg_lo.shape[0],
                                 window_pages=window_pages, tile_page=tile_page)
    if level == "own":
        return acc[0]
    return _whell.whell_flush_plain(acc, seg_lo, seg_hi, unit_segments)[0]
