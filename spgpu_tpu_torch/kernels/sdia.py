"""Kernels #2, #5, #8, #11 and #14: the static-offset DIA (SDIA) SpMV and
SpMM, hand-written in CUDA C++.

Replaces ``spgpu_tpu/ops/pallas_kernels.py::_sdia_kernel`` (#2, fp32),
``_sdia_dd_kernel`` (#5, float64, which the TPU kernel emulates with
double-float pairs), ``_sdia_cplx_kernel`` (#8, complex64),
``_sdia_z_kernel`` (#11, complex128, four double-float planes on the
TPU) and ``_sdia_spmm_kernel`` (#14, the multi-RHS product, fp32).  The
source of all five is ``spgpu_tpu_torch/csrc/sdia_spmv.cu`` (its header
note gives the design and its bound), built on first launch by
:mod:`spgpu_tpu_torch.kernels._build`.

:func:`sdia_spmv` and :func:`sdia_spmm` launch their kernels for CUDA
tensors (or raise) and run :func:`sdia_spmv_plain` /
:func:`sdia_spmm_plain`, the plain PyTorch versions of the same
functions, for CPU tensors.  ``LAUNCHES`` counts the launches of kernel
#2, ``LAUNCHES_F64`` those of #5, ``LAUNCHES_C64`` those of #8,
``LAUNCHES_C128`` those of #11 and ``LAUNCHES_SPMM`` those of #14.
"""

from __future__ import annotations

import ctypes

import torch

from spgpu_tpu_torch.kernels._build import CudaLibrary

__all__ = ["LAUNCHES", "LAUNCHES_C128", "LAUNCHES_C64", "LAUNCHES_F64",
           "LAUNCHES_SPMM", "SOURCE", "build", "sdia_spmm", "sdia_spmm_plain",
           "sdia_spmv", "sdia_spmv_plain"]

#: launches of kernel #2 (fp32), #5 (float64), #8 (complex64), #11
#: (complex128) and #14 (SpMM) so far; the CPU path does not count
LAUNCHES = 0
LAUNCHES_F64 = 0
LAUNCHES_C64 = 0
LAUNCHES_C128 = 0
LAUNCHES_SPMM = 0

#: value dtype -> (C entry, launch counter)
_ENTRIES = {torch.float32: ("sdia_spmv", "LAUNCHES"),
            torch.float64: ("sdia_spmv_f64", "LAUNCHES_F64"),
            torch.complex64: ("sdia_spmv_c64", "LAUNCHES_C64"),
            torch.complex128: ("sdia_spmv_c128", "LAUNCHES_C128")}


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, _ in _ENTRIES.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, p, i32, i64, i64, i64, p]
    lib.sdia_spmm.restype = ctypes.c_int
    lib.sdia_spmm.argtypes = [p, p, p, p, i32, i64, i64, i64, i32, p]


_LIB = CudaLibrary("sdia_spmv", _bind)
SOURCE = _LIB.source
build = _LIB.build


def _check_args(op, values, offset_table, x, n_rows):
    """Shapes, dtypes, devices and contiguity of ``op``'s operands: ``x``
    is ``(n_cols,)`` for the SpMV, ``(n_rhs, n_cols)`` for the SpMM (fp32
    only)."""
    spmm = op == "sdia_spmm"
    nd = offset_table.numel()
    xshape = "an (n_rhs, n_cols)" if spmm else "an (n_cols,)"
    want = [
        ((values.dtype == torch.float32 if spmm else values.dtype in _ENTRIES)
         and values.dim() == 3
         and values.shape[0] == max(nd, 1) and values.shape[2] == 128
         and values.shape[1] * 128 >= n_rows, "values"),
        (offset_table.dtype == torch.int32 and offset_table.dim() == 1,
         "offset_table"),
        (x.dim() == (2 if spmm else 1) and x.dtype == values.dtype,
         f"x: {values.dtype} planes take {xshape} {values.dtype} x"),
    ]
    for ok, what in want:
        if not ok:
            raise ValueError(f"{op}: bad {what}")
    ts = (values, offset_table, x)
    if any(t.device != x.device for t in ts):
        raise ValueError(f"{op}: all operands must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{op}: operands must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: no kernel for device {x.device}")


def sdia_spmv(values: torch.Tensor, offset_table: torch.Tensor,
              x: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """SDIA product ``(n_rows,)`` of the planes ``values``
    ``(max(n_diags, 1), n_tiles*8, 128)`` and ``x`` ``(n_cols,)``, both
    float32, float64, complex64 or complex128.

    CUDA tensors launch the hand kernel of their type (#2, #5, #8 or
    #11, each counted in its ``LAUNCHES*``); CPU tensors run
    :func:`sdia_spmv_plain`.  Any other device raises."""
    _check_args("sdia_spmv", values, offset_table, x, n_rows)
    dev = x.device
    if dev.type == "cpu":
        return sdia_spmv_plain(values, tuple(offset_table.tolist()), x,
                               n_rows=n_rows)
    lib = _LIB.load()
    z = torch.empty(n_rows, dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry, counter = _ENTRIES[x.dtype]
    err = getattr(lib, entry)(
        values.data_ptr(), offset_table.data_ptr(), x.data_ptr(), z.data_ptr(),
        offset_table.numel(), values.shape[1] * 128, n_rows, x.shape[0],
        stream)
    if err != 0:
        raise RuntimeError(f"sdia_spmv launch failed: CUDA error {err}")
    globals()[counter] += 1
    return z


def sdia_spmm(values: torch.Tensor, offset_table: torch.Tensor,
              x: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """Fused multi-RHS SDIA product ``(n_rhs, n_rows)`` of the fp32
    planes and ``x`` ``(n_rhs, n_cols)`` fp32: each value is read once
    for a block of RHS, and each RHS equals :func:`sdia_spmv` bit for bit.

    CUDA tensors launch kernel #14 (counted in ``LAUNCHES_SPMM``); CPU
    tensors run :func:`sdia_spmm_plain`.  Any other device raises."""
    _check_args("sdia_spmm", values, offset_table, x, n_rows)
    dev = x.device
    if dev.type == "cpu":
        return sdia_spmm_plain(values, tuple(offset_table.tolist()), x,
                               n_rows=n_rows)
    lib = _LIB.load()
    n_rhs, n_cols = x.shape
    z = torch.empty((n_rhs, n_rows), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.sdia_spmm(
        values.data_ptr(), offset_table.data_ptr(), x.data_ptr(), z.data_ptr(),
        offset_table.numel(), values.shape[1] * 128, n_rows, n_cols, n_rhs,
        stream)
    if err != 0:
        raise RuntimeError(f"sdia_spmm launch failed: CUDA error {err}")
    global LAUNCHES_SPMM
    LAUNCHES_SPMM += 1
    return z


def sdia_spmv_plain(values: torch.Tensor, offsets: tuple, x: torch.Tensor,
                    *, n_rows: int) -> torch.Tensor:
    """The same product in plain PyTorch: :func:`sdia_spmm_plain` with
    one RHS."""
    return sdia_spmm_plain(values, offsets, x.unsqueeze(0), n_rows=n_rows)[0]


def sdia_spmm_plain(values: torch.Tensor, offsets: tuple, x: torch.Tensor,
                    *, n_rows: int) -> torch.Tensor:
    """The multi-RHS product in plain PyTorch, vectorised over the RHS
    axis of ``x`` ``(n_rhs, n_cols)``, on the operands' device, with the
    offsets as Python ints: x with zero margins, then one shifted slice
    per diagonal, summed in the kernel's order (ascending) with the
    kernel's roundings (multiply, then add), in x's type.  A complex step
    is ``cr = vr·xr − vi·xi``, ``ci = vr·xi + vi·xr``, then ``z += c``,
    each operation rounded on its own, as in the kernel."""
    offs = list(offsets)
    n_rhs, n_cols = x.shape
    z = torch.zeros((n_rhs, n_rows), dtype=x.dtype, device=x.device)
    if not offs or n_rows == 0:
        return z
    lo = max(0, -offs[0])
    hi = max(0, offs[-1] + n_rows - n_cols)
    xp = torch.nn.functional.pad(x, (lo, hi))
    planes = values.reshape(values.shape[0], -1)
    if not x.is_complex():
        for j, o in enumerate(offs):
            z += planes[j, :n_rows] * xp[:, lo + o: lo + o + n_rows]
        return z
    zr, zi = torch.view_as_real(z).unbind(-1)  # views: the sums land in z
    pr, pi = torch.view_as_real(planes).unbind(-1)
    xr, xi = torch.view_as_real(xp).unbind(-1)
    for j, o in enumerate(offs):
        vr, vi = pr[j, :n_rows], pi[j, :n_rows]
        sr, si = xr[:, lo + o: lo + o + n_rows], xi[:, lo + o: lo + o + n_rows]
        zr += vr * sr - vi * si
        zi += vr * si + vi * sr
    return z
