"""Kernels #1, #4, #7 and #12: the packed-lane WHELL SpMV and SpMM,
hand-written in CUDA C++.

Replaces ``spgpu_tpu/ops/pallas_kernels.py::_whell_packed_kernel`` (#1:
fp32 or bf16 values, fp32 x and product), ``_whell_packed_dd_kernel``
(#4: float64 values, x and product, where the TPU kernel emulates float64
with double-float pairs), ``_whell_packed_cplx_kernel`` (#7:
complex64) and ``_whell_packed_spmm_kernel`` (#12: the multi-RHS product,
fp32 or bf16 values, fp32 x), and adds the complex128 product, which the
JAX package runs as four double-float plane products of #4.  The source
of all five is ``spgpu_tpu_torch/csrc/whell_packed_spmv.cu`` (its header
note gives the design and its bound).  It is compiled with ``nvcc`` for
``sm_90a`` into ``spgpu_tpu_torch/_build/`` on first launch and bound
through ``ctypes`` (:mod:`spgpu_tpu_torch.kernels._build`); nothing is
built when this module is imported.

:func:`whell_packed_spmv` and :func:`whell_packed_spmm` launch their
kernels for CUDA tensors (or raise) and run
:func:`whell_packed_spmv_plain` / :func:`whell_packed_spmm_plain`, the
plain PyTorch versions of the same functions, for CPU tensors.
``LAUNCHES`` counts the launches of kernel #1, ``LAUNCHES_F64`` those of
kernel #4, ``LAUNCHES_C64`` those of kernel #7, ``LAUNCHES_C128`` those
of the complex128 kernel and ``LAUNCHES_SPMM`` those of kernel #12.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from spgpu_tpu_torch.kernels._build import CudaLibrary

__all__ = ["LAUNCHES", "LAUNCHES_C128", "LAUNCHES_C64", "LAUNCHES_F64",
           "LAUNCHES_SPMM", "PER_HACK", "SOURCE", "build", "whell_hack_sums",
           "whell_packed_spmm", "whell_packed_spmm_plain", "whell_packed_spmv",
           "whell_packed_spmv_plain"]

#: launches of kernel #1 (fp32 product), #4 (float64), #7 (complex64),
#: of the complex128 kernel and of #12 (SpMM) so far; the CPU path does
#: not count
LAUNCHES = 0
LAUNCHES_F64 = 0
LAUNCHES_C64 = 0
LAUNCHES_C128 = 0
LAUNCHES_SPMM = 0

#: value dtype -> (C entry, launch counter) of the entries that take x
#: and z in the values' own type
_TYPED = {torch.float64: ("whell_packed_spmv_f64", "LAUNCHES_F64"),
          torch.complex64: ("whell_packed_spmv_c64", "LAUNCHES_C64"),
          torch.complex128: ("whell_packed_spmv_c128", "LAUNCHES_C128")}
#: value dtypes whose kernel sums each hack's run in one block (#4 and the
#: complex128 kernel: one launch over ``hack_units``, no accumulator)
PER_HACK = (torch.float64, torch.complex128)
#: value dtypes of the fp32-x entries (#1 and the SpMM #12)
_FP32_X = (torch.float32, torch.bfloat16)


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    tile_pass = [p, p, p, p, p, p, p, p, p, p, i64, i64, i32, i32, i32, i32, p]
    hack_pass = [p, p, p, p, p, p, p, p, p, p, p, i64, i32, i32, p]
    lib.whell_packed_spmv.restype = ctypes.c_int
    lib.whell_packed_spmv.argtypes = [p, i32] + tile_pass
    lib.whell_packed_spmm.restype = ctypes.c_int
    lib.whell_packed_spmm.argtypes = [p, i32] + [p] * 11 + [i64, i64, i32, i32, i32, p]
    for dt, (name, _) in _TYPED.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [p] + (hack_pass if dt in PER_HACK else tile_pass)
    # kernel #19 (spgpu_tpu_torch.kernels.ablation)
    lib.whell_packed_ablation_f64.restype = ctypes.c_int
    lib.whell_packed_ablation_f64.argtypes = [i32, p] + hack_pass


_LIB = CudaLibrary("whell_packed_spmv", _bind)
SOURCE = _LIB.source
build = _LIB.build


def _check_args(op, values, residue, page_tab, tile_base, chunk_group,
                group_bases, seg_lo, seg_hi, x, chunk_tiles, group_hacks,
                window_pages):
    """Shapes, dtypes, devices and contiguity of ``op``'s operands: ``x``
    is ``(x_pages, 128)`` for the SpMV, ``(n_rhs, x_pages, 128)`` for the
    SpMM (fp32 or bf16 values only)."""
    spmm = op == "whell_packed_spmm"
    S = values.shape[0]
    T = tile_base.shape[0]
    R = seg_lo.shape[0]
    # float64 and complex values take x of their own type; fp32 and bf16
    # values fp32 x
    xdt = values.dtype if values.dtype in _TYPED else torch.float32
    xname, xshape = (("x3d", "(n_rhs, x_pages, 128)") if spmm
                     else ("x2d", "(x_pages, 128)"))
    want = [
        (values.dtype in _FP32_X + (() if spmm else tuple(_TYPED)),
         "values dtype"),
        (values.shape == (S, 128) and S == 8 * T, "values shape"),
        (residue.shape == (S, 128) and residue.dtype == torch.int8, "residue"),
        (page_tab.shape == (S, 128) and page_tab.dtype == torch.int8, "page_tab"),
        (tile_base.dtype == torch.int32 and T % chunk_tiles == 0, "tile_base"),
        (chunk_group.dtype == torch.int32
         and chunk_group.shape == (T // chunk_tiles + 1,), "chunk_group"),
        (seg_lo.shape == (R, 128) and seg_hi.shape == (R, 128)
         and seg_lo.dtype == seg_hi.dtype == torch.int8
         and R % group_hacks == 0, "seg_lo/seg_hi"),
        (x.dim() == (3 if spmm else 2) and x.shape[-1] == 128
         and x.dtype == xdt,
         f"{xname}: {values.dtype} values take {xshape} {xdt}"),
        (window_pages in (8, 16, 32), "window_pages"),
        (group_bases is None or (group_bases.dtype == torch.int32
                                 and group_bases.numel() % (window_pages // 8) == 0),
         "group_bases"),
    ]
    for ok, what in want:
        if not ok:
            raise ValueError(f"{op}: bad {what}")
    ts = [values, residue, page_tab, tile_base, chunk_group, seg_lo, seg_hi,
          x] + ([] if group_bases is None else [group_bases])
    if any(t.device != x.device for t in ts):
        raise ValueError(f"{op}: all operands must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{op}: operands must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: no kernel for device {x.device}")


def _layout_args(residue, page_tab, tile_base, chunk_group, group_bases,
                 seg_lo, seg_hi):
    """The layout arrays' device pointers, in the tile-pass entries'
    order."""
    return (residue.data_ptr(), page_tab.data_ptr(), tile_base.data_ptr(),
            chunk_group.data_ptr(),
            None if group_bases is None else group_bases.data_ptr(),
            seg_lo.data_ptr(), seg_hi.data_ptr())


def _check_units(op, hack_units, values, seg_lo) -> None:
    """``hack_units`` is ``(U, 4)`` int32 with ``U >= rows``, contiguous,
    on the values' device (``WhellMatrix.hack_units``)."""
    ok = (hack_units is not None and hack_units.dtype == torch.int32
          and hack_units.dim() == 2 and hack_units.shape[1] == 4
          and hack_units.shape[0] >= seg_lo.shape[0]
          and hack_units.device == values.device and hack_units.is_contiguous())
    if not ok:
        raise ValueError(f"{op}: the hack pass takes hack_units, (U, 4) int32 on "
                         "the values' device (WhellMatrix.hack_units)")


def hack_pass_args(op, values, residue, page_tab, tile_base, group_bases,
                   hack_units, seg_lo, seg_hi, x, out, window_pages,
                   unit_segments, n_rhs=None):
    """The C arguments of the hack-pass entries (#4, complex128, #19;
    #12 with ``n_rhs``) after the values: device pointers, the work units'
    count (and for #12 the rows and ``n_rhs``), sizes and the current
    stream.  The launch's scratch for chunked runs is allocated here, per
    call, and only when some run is chunked (more units than rows): the
    counters zeroed, one per output row (per row and block of 8 RHS for
    #12), and the chunks' sums; else both are null.  So no product keeps
    state on the layout.  The bulk copies need 16 B aligned slabs (raises
    otherwise)."""
    if any(t.data_ptr() % 16 for t in (values, residue, page_tab)):
        raise ValueError(f"{op}: values, residue and page_tab must be 16 B "
                         "aligned for the bulk copies")
    U, rows = hack_units.shape[0], seg_lo.shape[0]
    done = part = None
    if U > rows:
        blocks = 1 if n_rhs is None else -(-n_rhs // 8)
        done = torch.zeros(rows * blocks, dtype=torch.int32, device=x.device)
        part = torch.empty((U, n_rhs or 1, 128), dtype=x.dtype, device=x.device)
    sizes = (U,) if n_rhs is None else (U, rows, n_rhs)
    return (residue.data_ptr(), page_tab.data_ptr(), tile_base.data_ptr(),
            None if group_bases is None else group_bases.data_ptr(),
            hack_units.data_ptr(), None if done is None else done.data_ptr(),
            None if part is None else part.data_ptr(), seg_lo.data_ptr(),
            seg_hi.data_ptr(), x.data_ptr(), out.data_ptr(), *sizes,
            window_pages, int(unit_segments),
            torch.cuda.current_stream(x.device).cuda_stream)


def whell_packed_spmv(values, residue, page_tab, tile_base, chunk_group,
                      group_bases: Optional[torch.Tensor], seg_lo, seg_hi,
                      x2d, *, chunk_tiles: int, group_hacks: int,
                      window_pages: int, unit_segments: bool,
                      hack_units: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed-lane WHELL product ``(num_groups*group_hacks, 128)`` in x2d's
    type: the values' own type for float64, complex64 and complex128
    values, float32 for fp32 or bf16 ones.

    CUDA tensors launch the hand kernel (#1; #4 for float64, #7 for
    complex64, the complex128 kernel for complex128; each counted in its
    ``LAUNCHES*``); CPU tensors run :func:`whell_packed_spmv_plain`.  Any
    other device raises.  float64 and complex128 values also take
    ``hack_units`` (``WhellMatrix.hack_units``; raises without): their
    kernel sums each hack's run of tiles in one launch, from those work
    units, and reads no tile outside the runs (other values ignore them).
    A call keeps no state on the layout: the counters of chunked runs are
    its own.  The layout arrays are trusted as built by the converter or
    checked by ``WhellMatrix.check``; shapes, dtypes and devices are
    checked here."""
    _check_args("whell_packed_spmv", values, residue, page_tab, tile_base,
                chunk_group, group_bases, seg_lo, seg_hi, x2d, chunk_tiles,
                group_hacks, window_pages)
    per_hack = values.dtype in PER_HACK
    if per_hack:
        _check_units("whell_packed_spmv", hack_units, values, seg_lo)
    dev = x2d.device
    static = dict(chunk_tiles=chunk_tiles, group_hacks=group_hacks,
                  window_pages=window_pages, unit_segments=unit_segments)
    if dev.type == "cpu":
        return whell_packed_spmv_plain(
            values, residue, page_tab, tile_base, chunk_group, group_bases,
            seg_lo, seg_hi, x2d, hack_units=hack_units if per_hack else None,
            **static)
    lib = _LIB.load()
    R = seg_lo.shape[0]
    z = torch.empty((R, 128), dtype=x2d.dtype, device=dev)
    typed = _TYPED.get(values.dtype)
    if per_hack:
        err = getattr(lib, typed[0])(values.data_ptr(), *hack_pass_args(
            "whell_packed_spmv", values, residue, page_tab, tile_base,
            group_bases, hack_units, seg_lo, seg_hi, x2d, z, window_pages,
            unit_segments))
    else:
        acc = torch.zeros((R, 128), dtype=x2d.dtype, device=dev)
        args = (*_layout_args(residue, page_tab, tile_base, chunk_group,
                              group_bases, seg_lo, seg_hi),
                x2d.data_ptr(), acc.data_ptr(), z.data_ptr(),
                tile_base.shape[0], R, chunk_tiles, group_hacks, window_pages,
                int(unit_segments), torch.cuda.current_stream(dev).cuda_stream)
        if typed is not None:
            err = getattr(lib, typed[0])(values.data_ptr(), *args)
        else:
            err = lib.whell_packed_spmv(values.data_ptr(),
                                        int(values.dtype == torch.bfloat16), *args)
    if err != 0:
        raise RuntimeError(f"whell_packed_spmv launch failed: CUDA error {err}")
    globals()["LAUNCHES" if typed is None else typed[1]] += 1
    return z


def whell_packed_spmm(values, residue, page_tab, tile_base, chunk_group,
                      group_bases: Optional[torch.Tensor], seg_lo, seg_hi,
                      x3d, *, chunk_tiles: int, group_hacks: int,
                      window_pages: int, unit_segments: bool,
                      hack_units: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused multi-RHS product ``(n_rhs, num_groups*group_hacks, 128)``
    fp32 of fp32 or bf16 values and the lane-space stack ``x3d``
    ``(n_rhs, x_pages, 128)`` fp32: each tile is decoded once for every
    RHS.

    CUDA tensors launch kernel #12, the hack pass over ``hack_units``
    (``WhellMatrix.hack_units``; required there, raises without): one
    launch, counted in ``LAUNCHES_SPMM``, after the wrapper copies X into
    the kernel's RHS-interleaved buffer; it reads no tile outside the
    runs and gathers no x for a zero-valued cell.  CPU tensors run
    :func:`whell_packed_spmm_plain`, in its per-hack form when given
    ``hack_units``.  Any other device raises."""
    _check_args("whell_packed_spmm", values, residue, page_tab, tile_base,
                chunk_group, group_bases, seg_lo, seg_hi, x3d, chunk_tiles,
                group_hacks, window_pages)
    dev = x3d.device
    static = dict(chunk_tiles=chunk_tiles, group_hacks=group_hacks,
                  window_pages=window_pages, unit_segments=unit_segments)
    if hack_units is not None or dev.type != "cpu":
        _check_units("whell_packed_spmm", hack_units, values, seg_lo)
    if dev.type == "cpu":
        return whell_packed_spmm_plain(
            values, residue, page_tab, tile_base, chunk_group, group_bases,
            seg_lo, seg_hi, x3d, hack_units=hack_units, **static)
    n_rhs = x3d.shape[0]
    if n_rhs > 65535:
        raise ValueError("whell_packed_spmm: at most 65,535 RHS per launch")
    lib = _LIB.load()
    xi = x3d.reshape(n_rhs, x3d.shape[1] * 128).t().contiguous()  # (x_pages*128, n_rhs)
    z = torch.empty((n_rhs, seg_lo.shape[0], 128), dtype=torch.float32, device=dev)
    err = lib.whell_packed_spmm(
        values.data_ptr(), int(values.dtype == torch.bfloat16), *hack_pass_args(
            "whell_packed_spmm", values, residue, page_tab, tile_base,
            group_bases, hack_units, seg_lo, seg_hi, xi, z, window_pages,
            unit_segments, n_rhs=n_rhs))
    if err != 0:
        raise RuntimeError(f"whell_packed_spmm launch failed: CUDA error {err}")
    global LAUNCHES_SPMM
    LAUNCHES_SPMM += 1
    return z


def whell_packed_spmv_plain(values, residue, page_tab, tile_base,
                            chunk_group, group_bases, seg_lo, seg_hi, x2d, *,
                            chunk_tiles: int, group_hacks: int,
                            window_pages: int, unit_segments: bool,
                            hack_units: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same product in plain PyTorch: :func:`whell_packed_spmm_plain`
    with one RHS (with ``hack_units``, its per-hack form: that of #4 and
    the complex128 kernel)."""
    return whell_packed_spmm_plain(
        values, residue, page_tab, tile_base, chunk_group, group_bases,
        seg_lo, seg_hi, x2d.unsqueeze(0), chunk_tiles=chunk_tiles,
        group_hacks=group_hacks, window_pages=window_pages,
        unit_segments=unit_segments, hack_units=hack_units)[0]


def whell_packed_spmm_plain(values, residue, page_tab, tile_base,
                            chunk_group, group_bases, seg_lo, seg_hi, x3d, *,
                            chunk_tiles: int, group_hacks: int,
                            window_pages: int, unit_segments: bool,
                            hack_units: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The multi-RHS product in plain PyTorch, vectorised over the RHS
    axis of ``x3d`` ``(n_rhs, x_pages, 128)``, on the operands' device, in
    x3d's type, then the flush (``cumsum`` and the segment gathers;
    complex products are PyTorch's complex multiply).  With
    ``hack_units``, the per-hack form of the hack-pass kernels (#4, #12
    and complex128): :func:`whell_hack_sums` (each hack's run, tile by
    tile and slot by slot; no tile outside the runs); without, the tile
    pass's: decode once, gather ``(n_rhs, S, 128)`` and ``index_add_``
    every tile's sums into its hack row."""
    if hack_units is not None:
        acc = whell_hack_sums(values, residue, page_tab, tile_base,
                              group_bases, hack_units, x3d,
                              num_rows=seg_lo.shape[0], window_pages=window_pages)
        return whell_flush_plain(acc, seg_lo, seg_hi, unit_segments)
    n_rhs = x3d.shape[0]
    tile_sums, hack = whell_tile_sums(values, residue, page_tab, tile_base,
                                      chunk_group, group_bases, x3d,
                                      chunk_tiles=chunk_tiles,
                                      group_hacks=group_hacks,
                                      window_pages=window_pages)
    acc = torch.zeros((n_rhs, seg_lo.shape[0], 128), dtype=x3d.dtype,
                      device=x3d.device)
    acc.index_add_(1, hack, tile_sums)
    return whell_flush_plain(acc, seg_lo, seg_hi, unit_segments)


def whell_cell_products(values, residue, page_tab, tile_base, group_bases,
                        x3d, *, window_pages: int):
    """Every cell's product ``values[s, j] * x[page*128 + r]``, ``(n_rhs,
    T, 8, 128)`` in x3d's type, and each tile's hack-in-group ``(T,)``
    int64 (the field above the page or layout-group bits)."""
    dev = x3d.device
    n_rhs = x3d.shape[0]
    T = tile_base.shape[0]
    res = residue.long()
    d = torch.gather(page_tab.long(), 1, res)  # page delta by residue
    meta = tile_base.long()
    tile = torch.arange(T * 8, device=dev) // 8
    if group_bases is not None:
        K = window_pages // 8
        page = group_bases.long()[(meta & 0xFFFFF)[tile, None] * K + (d >> 3)] + (d & 7)
        hh = meta >> 20
    else:
        page = (meta & 0xFFFF)[tile, None] + d
        hh = meta >> 16
    prod = values.to(x3d.dtype) * x3d.reshape(n_rhs, x3d.shape[1] * 128)[:, page * 128 + res]
    return prod.view(n_rhs, T, 8, 128), hh


def whell_tile_sums(values, residue, page_tab, tile_base, chunk_group,
                    group_bases, x3d, *, chunk_tiles: int, group_hacks: int,
                    window_pages: int):
    """The tile pass in plain PyTorch: each tile's lane sums over its 8
    slots, ``(n_rhs, T, 128)`` in x3d's type, and each tile's accumulator
    row (hack), ``(T,)`` int64."""
    prod, hh = whell_cell_products(values, residue, page_tab, tile_base,
                                   group_bases, x3d, window_pages=window_pages)
    T = tile_base.shape[0]
    hack = chunk_group.long()[torch.arange(T, device=x3d.device) // chunk_tiles] * group_hacks + hh
    return prod.sum(dim=2), hack


def whell_hack_sums(values, residue, page_tab, tile_base, group_bases,
                    hack_units, x3d, *, num_rows: int,
                    window_pages: int) -> torch.Tensor:
    """Each output row's unscanned lane sums in plain PyTorch, ``(n_rhs,
    num_rows, 128)`` in x3d's type, as the hack-pass kernels (#4, #12 and
    complex128) sum them over the work units ``hack_units`` (``[begin,
    end, row, chunk]``,
    :func:`~spgpu_tpu_torch.formats.whell.packed_hack_units`): each unit
    adds its tiles' products tile by tile and slot by slot, then a row
    adds its units' sums in chunk order; tiles outside every unit are not
    read."""
    prod, _ = whell_cell_products(values, residue, page_tab, tile_base,
                                  group_bases, x3d, window_pages=window_pages)
    units = hack_units.long()
    begin, row = units[:, 0], units[:, 2]
    n = units[:, 1] - begin
    chunk = torch.where(units[:, 3] >= 0, units[:, 3] >> 16, 0)
    n_rhs, U = x3d.shape[0], units.shape[0]
    sums = torch.zeros((n_rhs, U, 128), dtype=x3d.dtype, device=x3d.device)
    for i in range(int(n.max()) if U else 0):
        live = torch.nonzero(n > i).view(-1)
        for s in range(8):
            sums[:, live] += prod[:, begin[live] + i, s]
    acc = torch.zeros((n_rhs, num_rows, 128), dtype=x3d.dtype, device=x3d.device)
    for c in range(int(chunk.max()) + 1 if U else 0):
        sel = torch.nonzero(chunk == c).view(-1)
        acc[:, row[sel]] += sums[:, sel]
    return acc


def whell_flush_plain(acc, seg_lo, seg_hi, unit_segments: bool) -> torch.Tensor:
    """The flush in plain PyTorch: each output lane of ``acc`` ``(n_rhs,
    R, 128)`` takes its segment's sum, the difference of two inclusive
    lane prefix sums (``cumsum``), or with unit segments the one lane."""
    n_rhs, R = acc.shape[:2]
    hi = seg_hi.long().expand(n_rhs, R, 128)
    if unit_segments:
        return torch.where(hi >= 0, torch.gather(acc, 2, hi.clamp(min=0)), 0.0)
    p = acc.cumsum(dim=2)
    lo = seg_lo.long().expand(n_rhs, R, 128)
    return (torch.where(hi >= 0, torch.gather(p, 2, hi.clamp(min=0)), 0.0)
            - torch.where(lo >= 0, torch.gather(p, 2, lo.clamp(min=0)), 0.0))
