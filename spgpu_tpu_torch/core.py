"""Core constants, type registry and status codes of the PyTorch port.

Counterpart of :mod:`spgpu_tpu.core`.  The layout constants (128 lanes,
chunk sizes) are properties of the compute layouts, not of the TPU, so
they carry over unchanged: the port reads the same layout arrays.
float64 runs natively on the GPU: the JAX package's double-float pairs
are joined into one float64 array (:func:`join_dd`).  Complex values are
PyTorch's complex64 and complex128, interleaved re/im: the JAX package's
two real planes join into one complex array (:func:`join_planes`).  The
TPU ``Context`` (device kind, VMEM, HBM table) has no counterpart here:
every function of the port takes an explicit ``device``.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

__all__ = ["Status", "TypeCode", "size_of", "LANES", "CHUNK_TILES",
           "DEFAULT_HACK_SIZE", "sublanes", "round_up", "cdiv", "require_cuda", "unique_sorted",
           "dtype_name", "value_dtype", "real_part_dtype", "join_dd",
           "join_planes", "join_plane_fields"]


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

#: Default hack size of the classic HELL and HDIA layouts: one lane vector
#: of rows per hack (spGPU uses 32, ``hell.h:30-33``).
DEFAULT_HACK_SIZE = 128

#: Minimum slot multiple per element width, as the JAX layouts pad it.
_SUBLANES_BY_ITEMSIZE = {8: 8, 4: 8, 2: 16, 1: 32}


def sublanes(dtype) -> int:
    """The slot-axis padding multiple of the classic layouts for ``dtype``
    (NumPy or torch): 8 for 4- and 8-byte types (and complex), 16 for
    2-byte ones, 32 for 1-byte ones, as ``spgpu_tpu.core.sublanes`` pads
    them, so the port's classic arrays equal the JAX ones."""
    size = dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize
    return _SUBLANES_BY_ITEMSIZE.get(size, 8)


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


def unique_sorted(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` of a 1-D array, by one sort: the same values in
    the same order.  ``np.unique`` without ``return_*`` may take a hashing
    path (NumPy 2.3 on) that is tens of times slower than a sort on tens
    of millions of int64 keys."""
    s = np.sort(a)
    return s[np.r_[True, s[1:] != s[:-1]]] if s.size else s


def dtype_name(dtype) -> str:
    """The name of a NumPy or torch dtype, or of a dtype given by name
    ("float32", "bfloat16", ...)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    try:
        return np.dtype(dtype).name
    except TypeError:  # "bfloat16": NumPy has no such dtype
        return str(dtype)


def value_dtype(dtype, layout: str) -> np.dtype:
    """``dtype`` (NumPy or torch) as one of the value types every layout
    takes: float32, float64, complex64 or complex128; anything else raises
    ``NotImplementedError``."""
    name = dtype_name(dtype)
    if name in ("float32", "float64", "complex64", "complex128"):
        return np.dtype(name)
    raise NotImplementedError(
        f"{layout} in the port takes float32 or float64 values (or "
        f"complex64/complex128), not {name}: no other value type is planned")


def real_part_dtype(dtype) -> torch.dtype:
    """The real type of a complex torch dtype (complex64 → float32,
    complex128 → float64); a real dtype is its own."""
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(dtype, dtype)


def join_dd(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """A double-float pair of fp32 arrays joined into float64, as
    ``spgpu_tpu.ops.dd.join`` does."""
    if hi.shape != lo.shape or not hi.dtype == lo.dtype == torch.float32:
        raise ValueError(
            "a double-float pair is two float32 arrays of one shape, not "
            f"{hi.dtype} {tuple(hi.shape)} and {lo.dtype} {tuple(lo.shape)}")
    return hi.double() + lo.double()


def join_planes(ar: torch.Tensor, ai: torch.Tensor, ar_lo=None,
                ai_lo=None) -> torch.Tensor:
    """Two real planes of one shape joined into one complex tensor
    ``ar + i·ai``: complex64 from float32 planes, complex128 from
    double-float pairs (each plane first joined with :func:`join_dd`, as
    the JAX package's Z planes are ``(hi, lo)`` pairs) or float64 planes."""
    if (ar_lo is None) != (ai_lo is None):
        raise ValueError("give the lo word of both planes or of neither")
    if ar_lo is not None:
        ar, ai = join_dd(ar, ar_lo), join_dd(ai, ai_lo)
    if ar.shape != ai.shape or ar.dtype != ai.dtype \
            or ar.dtype not in (torch.float32, torch.float64):
        raise ValueError(
            "complex planes are two float32 or float64 arrays of one shape, "
            f"not {ar.dtype} {tuple(ar.shape)} and {ai.dtype} {tuple(ai.shape)}")
    return torch.complex(ar.contiguous(), ai.contiguous())


def join_plane_fields(ar: dict, ai: dict, structure, layout: str) -> torch.Tensor:
    """The complex values of a JAX two-plane layout (``ar``, ``ai``: each
    plane's array fields as NumPy arrays, ``values`` and ``values_lo``
    among them), joined by :func:`join_planes`.  Raises ``ValueError``
    unless the planes share every field named in ``structure``, bit for
    bit: the port keeps one structure for both."""
    for f in structure:
        a, b = ar.get(f), ai.get(f)
        if (a is None) != (b is None) or (
                a is not None and not np.array_equal(np.asarray(a), np.asarray(b))):
            raise ValueError(f"complex {layout} planes differ in {f}: the two "
                             "planes must share one structure")

    def plane(p, f):
        return None if p.get(f) is None else torch.from_numpy(np.array(p[f]))

    return join_planes(plane(ar, "values"), plane(ai, "values"),
                       plane(ar, "values_lo"), plane(ai, "values_lo"))
