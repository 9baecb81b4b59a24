"""Kernels #1, #4 and #7: the packed-lane WHELL SpMV, hand-written in
CUDA C++.

Replaces ``spgpu_tpu/ops/pallas_kernels.py::_whell_packed_kernel`` (#1:
fp32 or bf16 values, fp32 x and product), ``_whell_packed_dd_kernel``
(#4: float64 values, x and product, where the TPU kernel emulates float64
with double-float pairs) and ``_whell_packed_cplx_kernel`` (#7:
complex64), and adds the complex128 product, which the JAX package runs
as four double-float plane products of #4.  The source of all four is
``spgpu_tpu_torch/csrc/whell_packed_spmv.cu`` (its header note gives the
design and its bound).  It is compiled with ``nvcc`` for
``sm_90a`` into ``spgpu_tpu_torch/_build/`` on first launch and bound
through ``ctypes`` (:mod:`spgpu_tpu_torch.kernels._build`); nothing is
built when this module is imported.

:func:`whell_packed_spmv` launches the kernel for CUDA tensors (or
raises) and runs :func:`whell_packed_spmv_plain`, the plain PyTorch
version of the same function, for CPU tensors.  ``LAUNCHES`` counts the
launches of kernel #1, ``LAUNCHES_F64`` those of kernel #4,
``LAUNCHES_C64`` those of kernel #7 and ``LAUNCHES_C128`` those of the
complex128 kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from spgpu_tpu_torch.kernels._build import CudaLibrary

__all__ = ["LAUNCHES", "LAUNCHES_C128", "LAUNCHES_C64", "LAUNCHES_F64",
           "SOURCE", "build", "whell_packed_spmv", "whell_packed_spmv_plain"]

#: launches of kernel #1 (fp32 product), #4 (float64), #7 (complex64)
#: and of the complex128 kernel so far; the CPU path does not count
LAUNCHES = 0
LAUNCHES_F64 = 0
LAUNCHES_C64 = 0
LAUNCHES_C128 = 0

#: value dtype -> (C entry, launch counter) of the entries that take x,
#: the accumulator and z in the values' own type
_TYPED = {torch.float64: ("whell_packed_spmv_f64", "LAUNCHES_F64"),
          torch.complex64: ("whell_packed_spmv_c64", "LAUNCHES_C64"),
          torch.complex128: ("whell_packed_spmv_c128", "LAUNCHES_C128")}


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.whell_packed_spmv.restype = ctypes.c_int
    lib.whell_packed_spmv.argtypes = [
        p, i32, p, p, p, p, p, p, p, p, p, p, i64, i64, i32, i32, i32, i32, p]
    for name, _ in _TYPED.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i64, i64, i32, i32,
                       i32, i32, p]


_LIB = CudaLibrary("whell_packed_spmv", _bind)
SOURCE = _LIB.source
build = _LIB.build


def _check_args(values, residue, page_tab, tile_base, chunk_group,
                group_bases, seg_lo, seg_hi, x2d, chunk_tiles, group_hacks,
                window_pages):
    S = values.shape[0]
    T = tile_base.shape[0]
    R = seg_lo.shape[0]
    # float64 and complex values take x of their own type; fp32 and bf16
    # values fp32 x
    xdt = values.dtype if values.dtype in _TYPED else torch.float32
    want = [
        (values.dtype in (torch.float32, torch.bfloat16) + tuple(_TYPED),
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
        (x2d.dim() == 2 and x2d.shape[1] == 128 and x2d.dtype == xdt,
         f"x2d: {values.dtype} values take (x_pages, 128) {xdt}"),
        (window_pages in (8, 16, 32), "window_pages"),
        (group_bases is None or (group_bases.dtype == torch.int32
                                 and group_bases.numel() % (window_pages // 8) == 0),
         "group_bases"),
    ]
    for ok, what in want:
        if not ok:
            raise ValueError(f"whell_packed_spmv: bad {what}")
    ts = [values, residue, page_tab, tile_base, chunk_group, seg_lo, seg_hi,
          x2d] + ([] if group_bases is None else [group_bases])
    if any(t.device != x2d.device for t in ts):
        raise ValueError("whell_packed_spmv: all operands must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("whell_packed_spmv: operands must be contiguous")


def whell_packed_spmv(values, residue, page_tab, tile_base, chunk_group,
                      group_bases: Optional[torch.Tensor], seg_lo, seg_hi,
                      x2d, *, chunk_tiles: int, group_hacks: int,
                      window_pages: int, unit_segments: bool) -> torch.Tensor:
    """Packed-lane WHELL product ``(num_groups*group_hacks, 128)`` in x2d's
    type: the values' own type for float64, complex64 and complex128
    values, float32 for fp32 or bf16 ones.

    CUDA tensors launch the hand kernel (#1; #4 for float64, #7 for
    complex64, the complex128 kernel for complex128; each counted in its
    ``LAUNCHES*``); CPU tensors run
    :func:`whell_packed_spmv_plain`.  Any other device raises.
    The layout arrays are trusted as built by the converter or checked by
    ``WhellMatrix.check``; shapes, dtypes and devices are checked here."""
    _check_args(values, residue, page_tab, tile_base, chunk_group,
                group_bases, seg_lo, seg_hi, x2d, chunk_tiles, group_hacks,
                window_pages)
    dev = x2d.device
    if dev.type == "cpu":
        return whell_packed_spmv_plain(
            values, residue, page_tab, tile_base, chunk_group, group_bases,
            seg_lo, seg_hi, x2d, chunk_tiles=chunk_tiles,
            group_hacks=group_hacks, window_pages=window_pages,
            unit_segments=unit_segments)
    if dev.type != "cuda":
        raise ValueError(f"whell_packed_spmv: no kernel for device {dev}")
    lib = _LIB.load()
    R = seg_lo.shape[0]
    acc = torch.zeros((R, 128), dtype=x2d.dtype, device=dev)
    z = torch.empty((R, 128), dtype=x2d.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    typed = _TYPED.get(values.dtype)
    args = (residue.data_ptr(), page_tab.data_ptr(), tile_base.data_ptr(),
            chunk_group.data_ptr(),
            None if group_bases is None else group_bases.data_ptr(),
            seg_lo.data_ptr(), seg_hi.data_ptr(), x2d.data_ptr(),
            acc.data_ptr(), z.data_ptr(), tile_base.shape[0], R,
            chunk_tiles, group_hacks, window_pages, int(unit_segments), stream)
    if typed is not None:
        err = getattr(lib, typed[0])(values.data_ptr(), *args)
    else:
        err = lib.whell_packed_spmv(values.data_ptr(),
                                    int(values.dtype == torch.bfloat16), *args)
    if err != 0:
        raise RuntimeError(f"whell_packed_spmv launch failed: CUDA error {err}")
    globals()["LAUNCHES" if typed is None else typed[1]] += 1
    return z


def whell_packed_spmv_plain(values, residue, page_tab, tile_base,
                            chunk_group, group_bases, seg_lo, seg_hi, x2d, *,
                            chunk_tiles: int, group_hacks: int,
                            window_pages: int,
                            unit_segments: bool) -> torch.Tensor:
    """The same product in plain PyTorch (decode, gather, ``index_add_``,
    then ``cumsum`` and gathers), on the operands' device, in x2d's
    type (complex products are PyTorch's complex multiply)."""
    dev = x2d.device
    T = tile_base.shape[0]
    R = seg_lo.shape[0]
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
    prod = values.to(x2d.dtype) * x2d.reshape(-1)[page * 128 + res]
    hack = chunk_group.long()[torch.arange(T, device=dev) // chunk_tiles] * group_hacks + hh
    acc = torch.zeros((R, 128), dtype=x2d.dtype, device=dev)
    acc.index_add_(0, hack, prod.view(T, 8, 128).sum(dim=1))
    hi = seg_hi.long()
    if unit_segments:
        return torch.where(hi >= 0, torch.gather(acc, 1, hi.clamp(min=0)), 0.0)
    p = acc.cumsum(dim=1)
    lo = seg_lo.long()
    return (torch.where(hi >= 0, torch.gather(p, 1, hi.clamp(min=0)), 0.0)
            - torch.where(lo >= 0, torch.gather(p, 1, lo.clamp(min=0)), 0.0))
