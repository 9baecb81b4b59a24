"""Core constants, type registry and status codes of the PyTorch port.

Counterpart of :mod:`spgpu_tpu.core`.  The layout constants (128 lanes,
chunk sizes) are properties of the compute layouts, not of the TPU, so
they carry over unchanged: the port reads the same layout arrays.
float64 runs natively on the GPU: the JAX package's double-float pairs
are joined into one float64 array (:func:`join_dd`).  The
TPU ``Context`` (device kind, VMEM, HBM table) has no counterpart here:
every function of the port takes an explicit ``device``.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

__all__ = ["Status", "TypeCode", "size_of", "LANES", "CHUNK_TILES",
           "round_up", "cdiv", "require_cuda", "dtype_name", "real_dtype",
           "join_dd"]


class Status(enum.IntEnum):
    """Return codes; mirrors ``spgpuStatus_t`` (``core.h:43-48``)."""

    SUCCESS = 0
    UNSUPPORTED = 1
    UNSPECIFIED = 2
    OUTOFMEMORY = 3


class TypeCode(enum.IntEnum):
    """Element type codes; mirrors ``spgpuType_t`` (``core.h:51-57``)."""

    INT = 0
    FLOAT = 1
    DOUBLE = 2
    COMPLEX_FLOAT = 3
    COMPLEX_DOUBLE = 4
    BFLOAT16 = 5


_TYPE_TO_DTYPE = {
    TypeCode.INT: torch.int32,
    TypeCode.FLOAT: torch.float32,
    TypeCode.DOUBLE: torch.float64,
    TypeCode.COMPLEX_FLOAT: torch.complex64,
    TypeCode.COMPLEX_DOUBLE: torch.complex128,
    TypeCode.BFLOAT16: torch.bfloat16,
}


def size_of(code: TypeCode) -> int:
    """Byte size of a type code; mirrors ``spgpuSizeOf`` (``core.c:82-99``)."""
    return _TYPE_TO_DTYPE[TypeCode(code)].itemsize


#: Lane width of every layout: one hack is 128 rows, one x page 128 entries.
LANES = 128

#: Default tiles per chunk of the classic WHELL layout (packed layouts
#: carry their own ``chunk_tiles``).
CHUNK_TILES = 64


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def require_cuda() -> torch.device:
    """The first CUDA device; raises when there is none.

    Measurement paths call this instead of falling back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device is required (torch.cuda.is_available() "
                           "is False)")
    return torch.device("cuda", 0)


def dtype_name(dtype) -> str:
    """The name of a NumPy or torch dtype, or of a dtype given by name
    ("float32", "bfloat16", ...)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    try:
        return np.dtype(dtype).name
    except TypeError:  # "bfloat16": NumPy has no such dtype
        return str(dtype)


def real_dtype(dtype, layout: str) -> np.dtype:
    """``dtype`` (NumPy or torch) as ``np.float32`` or ``np.float64``, the
    real value types every layout takes; anything else raises
    ``NotImplementedError`` (complex values are a later slice)."""
    name = dtype_name(dtype)
    if name in ("float32", "float64"):
        return np.dtype(name)
    if name.startswith("complex"):
        later = "complex values are ROADMAP module item 6"
    else:
        later = "no other value type is planned"
    raise NotImplementedError(
        f"{layout} in the port takes float32 or float64 values, not "
        f"{name}: {later}")


def join_dd(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """A double-float pair of fp32 arrays joined into float64, as
    ``spgpu_tpu.ops.dd.join`` does."""
    if hi.shape != lo.shape or not hi.dtype == lo.dtype == torch.float32:
        raise ValueError(
            "a double-float pair is two float32 arrays of one shape, not "
            f"{hi.dtype} {tuple(hi.shape)} and {lo.dtype} {tuple(lo.shape)}")
    return hi.double() + lo.double()
