"""Kernels #18 and #19: the per-op cycle accounts of the WHDIA (#3) and
float64 packed WHELL (#4) tile passes, hand-written in CUDA C++.

Replaces the ``call`` closures of ``doc/sweeps/whdia_ablation.py`` (#18:
its ``pallas_call`` runs ``_whdia_kernel``'s body cut after one op
family, pattern-mode fp32) and ``doc/sweeps/dd_ablation.py`` (#19: the
same for ``_whell_packed_dd_kernel``, double-float on the TPU, float64
here).  Each level is the production tile body of its source cut after
one op family (``whdia_tile`` in ``csrc/whdia_spmv.cu``, ``whell_tile`` in
``csrc/whell_packed_spmv.cu``; their header notes give the design), so
that the differences between levels price one family each:

* #18 (:data:`WHDIA_LEVELS`): ``stream`` (each lane's 8 values, summed
  as ``1.5·v``), ``r0`` (+ the r0 decode and the column, kept live as
  ``v·(col & 127)``), ``gather`` (+ the guarded x read: the production
  tile sum) and ``full`` (+ one atomicAdd per lane: the production
  ``whdia_spmv`` launch);
* #19 (:data:`F64_LEVELS`), on the production hack pass of #4
  (``whell_hack_pass``: one block per hack row, the run's index bytes
  brought into shared memory by bulk copies, its values streamed):
  ``stream`` (each cell's value, residue and page-table bytes summed as
  ``1.5·v + r + d``), ``gather`` (+ the decode and the x gather), ``own`` (+ each
  lane's register sum over its hack's run, stored unscanned) and
  ``full`` (+ the scan and segment difference: the production
  ``whell_packed_spmv_f64`` launch).

Below ``full`` (``own`` for #19) a level returns its lane sums, one
plain store per lane: ``part`` ``(num_tiles, 128)``.  :data:`TPU_LEVELS`
maps each level of the TPU scripts to the card level that covers it, or
to None with the reason it has no counterpart; :data:`RETIRED_LEVELS`
names the card levels that the production code no longer has, and why.

:func:`whdia_ablation` and :func:`whell_f64_ablation` launch for CUDA
tensors (or raise) and run :func:`whdia_ablation_plain` /
:func:`whell_f64_ablation_plain`, the plain PyTorch versions of the same
functions, for CPU tensors.  ``LAUNCHES_WHDIA_ABLATION`` and
``LAUNCHES_F64_ABLATION`` count their launches, every level included.
The entries live in the production sources and are bound through their
libraries (:mod:`spgpu_tpu_torch.kernels.whdia`,
:mod:`spgpu_tpu_torch.kernels.whell`).
"""

from __future__ import annotations

from typing import Optional

import torch

from spgpu_tpu_torch.kernels import whdia as _whdia
from spgpu_tpu_torch.kernels import whell as _whell

__all__ = ["F64_LEVELS", "LAUNCHES_F64_ABLATION", "LAUNCHES_WHDIA_ABLATION",
           "LEVEL_ADDS", "RETIRED_LEVELS", "TPU_LEVELS", "WHDIA_LEVELS",
           "whdia_ablation",
           "whdia_ablation_plain", "whell_f64_ablation",
           "whell_f64_ablation_plain"]

#: launches of kernel #18 and #19 so far, every level; the CPU path does
#: not count
LAUNCHES_WHDIA_ABLATION = 0
LAUNCHES_F64_ABLATION = 0

#: the card levels, in the order they add op families (the C entries'
#: level codes are the positions)
WHDIA_LEVELS = ("stream", "r0", "gather", "full")
F64_LEVELS = ("stream", "gather", "own", "full")

#: what each card level adds to the one before it
LEVEL_ADDS = {
    "whdia": {
        "stream": "each lane reads its 8 values (4 B/cell) and sums 1.5·v",
        "r0": "the tile_r0/slot_r0 decode and the column, kept live as "
              "v·(col & 127)",
        "gather": "the guarded x read at the column: the production tile sum",
        "full": "one atomicAdd per lane into the hack row: the production "
                "whdia_spmv launch (the card's WHDIA has no flush)",
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
    "f64": {
        "atomic": "one atomicAdd(double) per lane and tile into a zeroed "
                  "accumulator, then a flush launch: the hack pass owns "
                  "each hack row in one block, sums its run in registers "
                  "and scans it in place, so it has no atomics to price",
    },
}

#: each level of the TPU scripts (doc/sweeps/whdia_ablation.py:8-13,
#: dd_ablation.py:7-15) -> (the card level that covers it, or None, and why)
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
                   *, chunk_tiles: int, group_hacks: int,
                   num_groups: int) -> torch.Tensor:
    """Kernel #18 at ``level`` (:data:`WHDIA_LEVELS`) on an fp32 WHDIA
    layout in either r0 mode and ``x`` ``(n_cols,)`` fp32: ``part``
    ``(num_tiles, 128)`` below ``full``, the product
    ``(num_groups*group_hacks*128,)`` at ``full``.

    CUDA tensors launch the kernel (counted in
    ``LAUNCHES_WHDIA_ABLATION``); CPU tensors run
    :func:`whdia_ablation_plain`.  Any other device raises."""
    code = _code(level, WHDIA_LEVELS, "whdia_ablation")
    _whdia._check_args("whdia_ablation", values, slot_r0, tile_r0, tile_base,
                       chunk_group, x, chunk_tiles)
    if values.dtype != torch.float32:
        raise ValueError(f"whdia_ablation: bad values: kernel #18 takes "
                         f"float32, not {values.dtype}")
    static = dict(chunk_tiles=chunk_tiles, group_hacks=group_hacks,
                  num_groups=num_groups)
    dev = x.device
    if dev.type == "cpu":
        return whdia_ablation_plain(level, values, slot_r0, tile_r0, tile_base,
                                    chunk_group, x, **static)
    lib = _whdia._LIB.load()
    T = tile_base.shape[0]
    out = (torch.zeros(num_groups * group_hacks * 128, dtype=x.dtype, device=dev)
           if level == "full" else torch.empty((T, 128), dtype=x.dtype, device=dev))
    err = lib.whdia_ablation(
        code, values.data_ptr(), *_whdia._r0_ptrs(slot_r0, tile_r0),
        tile_base.data_ptr(), chunk_group.data_ptr(), x.data_ptr(),
        out.data_ptr(), T, x.shape[0], chunk_tiles, group_hacks,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"whdia_ablation({level!r}) launch failed: CUDA "
                           f"error {err}")
    global LAUNCHES_WHDIA_ABLATION
    LAUNCHES_WHDIA_ABLATION += 1
    return out


def whdia_ablation_plain(level: str, values, slot_r0, tile_r0, tile_base,
                         chunk_group, x, *, chunk_tiles: int, group_hacks: int,
                         num_groups: int) -> torch.Tensor:
    """Kernel #18's function at ``level`` in plain PyTorch, on the
    operands' device: the gathers of :func:`~spgpu_tpu_torch.kernels.whdia.
    whdia_spmm_plain`, cut where the level cuts the tile pass."""
    _code(level, WHDIA_LEVELS, "whdia_ablation_plain")
    if level == "full":
        return _whdia.whdia_spmv_plain(values, slot_r0, tile_r0, tile_base,
                                       chunk_group, x, chunk_tiles=chunk_tiles,
                                       group_hacks=group_hacks,
                                       num_groups=num_groups)
    v = values.view(tile_base.shape[0], 8, 128)
    if level == "stream":
        return (v * 1.5).sum(dim=1)
    if level == "r0":
        col = _whdia.whdia_columns(slot_r0, tile_r0, tile_base)
        return (v * (col & 127).to(v.dtype)).sum(dim=1)
    return _whdia.whdia_tile_sums(values, slot_r0, tile_r0, tile_base,
                                  x.unsqueeze(0))[0]


def whell_f64_ablation(level: str, values, residue, page_tab, tile_base,
                       chunk_group, group_bases: Optional[torch.Tensor],
                       seg_lo, seg_hi, x2d, *, chunk_tiles: int,
                       group_hacks: int, window_pages: int,
                       unit_segments: bool, hack_units: torch.Tensor,
                       hack_done: torch.Tensor) -> torch.Tensor:
    """Kernel #19 at ``level`` (:data:`F64_LEVELS`) on a float64 packed
    WHELL layout (aligned or scattered windows), its work units and run
    counters (``WhellMatrix.hack_units``, ``.hack_done``) and lane-space
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
                       x2d, chunk_tiles, group_hacks, window_pages)
    if values.dtype != torch.float64:
        raise ValueError(f"whell_f64_ablation: bad values: kernel #19 takes "
                         f"float64, not {values.dtype}")
    _whell._check_units("whell_f64_ablation", hack_units, hack_done, values, seg_lo)
    static = dict(chunk_tiles=chunk_tiles, group_hacks=group_hacks,
                  window_pages=window_pages, unit_segments=unit_segments)
    dev = x2d.device
    if dev.type == "cpu":
        return whell_f64_ablation_plain(level, values, residue, page_tab,
                                        tile_base, chunk_group, group_bases,
                                        seg_lo, seg_hi, x2d,
                                        hack_units=hack_units, **static)
    lib = _whell._LIB.load()
    rows = tile_base.shape[0] if level in ("stream", "gather") else seg_lo.shape[0]
    # the part rows of tiles outside every run are never written
    out = (torch.zeros if level in ("stream", "gather") else torch.empty)(
        (rows, 128), dtype=x2d.dtype, device=dev)
    err = lib.whell_packed_ablation_f64(
        code, values.data_ptr(), *_whell.hack_pass_args(
            "whell_f64_ablation", values, residue, page_tab, tile_base,
            group_bases, hack_units, hack_done, seg_lo, seg_hi, x2d, out,
            window_pages, unit_segments))
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
                             hack_done: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel #19's function at ``level`` in plain PyTorch, on the
    operands' device: the products of :func:`~spgpu_tpu_torch.kernels.
    whell.whell_hack_sums` and its flush, cut where the level cuts the
    kernel (``stream`` and ``gather`` zero the tiles outside every unit);
    ``hack_done`` is taken for the kernel's signature and not read."""
    _code(level, F64_LEVELS, "whell_f64_ablation_plain")
    T = tile_base.shape[0]
    if level in ("stream", "gather"):
        if level == "stream":
            index_bytes = (residue.long() + page_tab.long()).to(values.dtype)
            part = (values * 1.5 + index_bytes).view(T, 8, 128).sum(dim=1)
        else:
            part = _whell.whell_cell_products(
                values, residue, page_tab, tile_base, group_bases,
                x2d.unsqueeze(0), window_pages=window_pages)[0][0].sum(dim=1)
        run = torch.zeros(T + 1, dtype=torch.long, device=part.device)
        begin, end = hack_units[:, 0].long(), hack_units[:, 1].long()
        run.index_add_(0, begin, torch.ones_like(begin))
        run.index_add_(0, end, -torch.ones_like(end))
        return torch.where((run.cumsum(0)[:T] > 0)[:, None], part, 0.0)
    acc = _whell.whell_hack_sums(values, residue, page_tab, tile_base,
                                 group_bases, hack_units, x2d.unsqueeze(0),
                                 num_rows=seg_lo.shape[0],
                                 window_pages=window_pages)
    if level == "own":
        return acc[0]
    return _whell.whell_flush_plain(acc, seg_lo, seg_hi, unit_segments)[0]
