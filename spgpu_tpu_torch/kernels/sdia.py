"""Kernel #2: the static-offset DIA (SDIA) SpMV, hand-written in CUDA C++.

Replaces ``spgpu_tpu/ops/pallas_kernels.py::_sdia_kernel``.  The source is
``spgpu_tpu_torch/csrc/sdia_spmv.cu`` (its header note gives the design
and its bound), built on first launch by
:mod:`spgpu_tpu_torch.kernels._build`.

:func:`sdia_spmv` launches the kernel for CUDA tensors (or raises) and
runs :func:`sdia_spmv_plain`, the plain PyTorch version of the same
function, for CPU tensors.  ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from spgpu_tpu_torch.kernels._build import CudaLibrary

__all__ = ["LAUNCHES", "SOURCE", "build", "sdia_spmv", "sdia_spmv_plain"]

#: kernel launches so far (the CPU path does not count)
LAUNCHES = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.sdia_spmv.restype = ctypes.c_int
    lib.sdia_spmv.argtypes = [p, p, p, p, i32, i64, i64, i64, p]


_LIB = CudaLibrary("sdia_spmv", _bind)
SOURCE = _LIB.source
build = _LIB.build


def _check_args(values, offset_table, x, n_rows):
    nd = offset_table.numel()
    want = [
        (values.dtype == torch.float32 and values.dim() == 3
         and values.shape[0] == max(nd, 1) and values.shape[2] == 128
         and values.shape[1] * 128 >= n_rows, "values"),
        (offset_table.dtype == torch.int32 and offset_table.dim() == 1,
         "offset_table"),
        (x.dim() == 1 and x.dtype == torch.float32, "x must be (n_cols,) float32"),
    ]
    for ok, what in want:
        if not ok:
            raise ValueError(f"sdia_spmv: bad {what}")
    ts = (values, offset_table, x)
    if any(t.device != x.device for t in ts):
        raise ValueError("sdia_spmv: all operands must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("sdia_spmv: operands must be contiguous")


def sdia_spmv(values: torch.Tensor, offset_table: torch.Tensor,
              x: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """SDIA product ``(n_rows,)`` float32 of the planes ``values``
    ``(max(n_diags, 1), n_tiles*8, 128)`` and ``x`` ``(n_cols,)``.

    CUDA tensors launch the hand kernel (and count in ``LAUNCHES``); CPU
    tensors run :func:`sdia_spmv_plain`.  Any other device raises."""
    global LAUNCHES
    _check_args(values, offset_table, x, n_rows)
    dev = x.device
    if dev.type == "cpu":
        return sdia_spmv_plain(values, tuple(offset_table.tolist()), x,
                               n_rows=n_rows)
    if dev.type != "cuda":
        raise ValueError(f"sdia_spmv: no kernel for device {dev}")
    lib = _LIB.load()
    z = torch.empty(n_rows, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.sdia_spmv(values.data_ptr(), offset_table.data_ptr(),
                        x.data_ptr(), z.data_ptr(), offset_table.numel(),
                        values.shape[1] * 128, n_rows, x.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"sdia_spmv launch failed: CUDA error {err}")
    LAUNCHES += 1
    return z


def sdia_spmv_plain(values: torch.Tensor, offsets: tuple, x: torch.Tensor,
                    *, n_rows: int) -> torch.Tensor:
    """The same product in plain PyTorch, on the operands' device, with
    the offsets as Python ints: x with zero margins, then one shifted
    slice per diagonal, summed in the kernel's order (ascending)."""
    offs = list(offsets)
    z = torch.zeros(n_rows, dtype=torch.float32, device=x.device)
    if not offs or n_rows == 0:
        return z
    lo = max(0, -offs[0])
    hi = max(0, offs[-1] + n_rows - x.shape[0])
    xp = torch.nn.functional.pad(x, (lo, hi))
    planes = values.reshape(values.shape[0], -1)
    for j, o in enumerate(offs):
        z += planes[j, :n_rows] * xp[lo + o: lo + o + n_rows]
    return z
