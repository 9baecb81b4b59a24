"""Core constants, type registry and status codes of the PyTorch port.

Counterpart of :mod:`spgpu_tpu.core`.  The layout constants (128 lanes,
chunk sizes) are properties of the compute layouts, not of the TPU, so
they carry over unchanged: the port reads the same layout arrays.
float64 runs natively on the GPU: the JAX package's double-float pairs
are joined into one float64 array (:func:`join_dd`).  Complex values are
PyTorch's complex64 and complex128, interleaved re/im: the JAX package's
two real planes join into one complex array (:func:`join_planes`).

:class:`Context` is spGPU's handle (``spgpuCreate``, ``core.c:11-48``) on
one device: its type, the layouts' lane and slot geometry, the card's HBM
rate for rooflines (:func:`hbm_bandwidth`, from :data:`HBM_BW_BY_KIND`)
and, optionally, the rank group of a distributed run.  Its stream calls
act on the card (``spgpuStreamCreate/SetStream/GetStream``,
``core.c:50-80``): every op of the port launches on torch's current
stream, so :meth:`Context.set_stream` moves the ops that follow onto the
stream given.  The JAX package stubs them, since XLA owns the TPU's
schedule; on the CPU they keep that no-op behaviour.  A context takes the
card unless the caller asks for the CPU.  The port's functions still take
an explicit ``device``: pass the context's.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

if TYPE_CHECKING:
    from spgpu_tpu_torch.parallel.group import RankGroup

__all__ = ["Status", "TypeCode", "size_of", "dtype_of", "HBM_BW_BY_KIND",
           "hbm_bandwidth", "Context", "create", "destroy", "LANES", "CHUNK_TILES",
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


def dtype_of(code: TypeCode) -> torch.dtype:
    """The torch dtype of a type code (``BFLOAT16`` → ``torch.bfloat16``)."""
    return _TYPE_TO_DTYPE[TypeCode(code)]


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


#: HBM bytes/s by a substring of ``torch.cuda.get_device_name``, for
#: rooflines: NVIDIA's data sheet, at the card's full power limit (700 W
#: for the H100 SXM, whose name ends "80GB HBM3")
HBM_BW_BY_KIND = {
    "H100 80GB HBM3": 3.35e12,
}


def hbm_bandwidth(device=None) -> Optional[float]:
    """HBM bytes/s of ``device`` (default: the first card, if any) from
    :data:`HBM_BW_BY_KIND`; ``None`` for the CPU and for a card the table
    does not name, as the JAX function gives for an unknown kind."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((bw for key, bw in HBM_BW_BY_KIND.items() if key in name), None)


@dataclasses.dataclass
class Context:
    """Per-device context; the counterpart of ``spgpuHandle_t``
    (``spgpuCreate``, ``core.c:11-41``) and of the JAX ``Context``.

    ``device``: ``None`` takes ``cuda:0`` and raises, as
    :func:`require_cuda` does, without a card; pass ``"cpu"`` for the
    CPU.  ``group``: the :class:`~spgpu_tpu_torch.parallel.group.RankGroup`
    of a distributed run, where the JAX context holds a device mesh."""

    device: object = None
    group: Optional["RankGroup"] = None

    def __post_init__(self):
        self.device = require_cuda() if self.device is None else torch.device(self.device)
        if self.device.type == "cuda":
            require_cuda()
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())

    @property
    def platform(self) -> str:
        """The torch device type: ``"cuda"`` or ``"cpu"``."""
        return self.device.type

    @property
    def lanes(self) -> int:
        return LANES

    def sublanes(self, dtype) -> int:
        return sublanes(dtype)

    @property
    def hbm_bandwidth(self) -> Optional[float]:
        return hbm_bandwidth(self.device)

    # -- streams (spgpuStreamCreate/SetStream/GetStream, core.c:50-80) -----

    def _on_card(self) -> bool:
        return self.device.type == "cuda"

    def stream_create(self):
        """A new ``torch.cuda.Stream`` on the context's card; ``None`` on
        the CPU."""
        return torch.cuda.Stream(self.device) if self._on_card() else None

    def set_stream(self, stream) -> Status:
        """Make ``stream`` (``None``: the card's default stream) torch's
        current stream on the context's card, so the port's ops that
        follow launch on it; a no-op on the CPU."""
        if self._on_card():
            torch.cuda.set_stream(torch.cuda.default_stream(self.device)
                                  if stream is None else stream)
        return Status.SUCCESS

    def get_stream(self):
        """torch's current stream on the context's card; ``None`` on the
        CPU."""
        return torch.cuda.current_stream(self.device) if self._on_card() else None


def create(device_index: int = 0) -> Context:
    """A context on ``cuda:device_index``; raises without a card (or
    without that card).  Mirrors ``spgpuCreate`` (``core.c:11-41``)."""
    require_cuda()
    if not 0 <= device_index < torch.cuda.device_count():
        raise ValueError(f"no CUDA device {device_index}: "
                         f"{torch.cuda.device_count()} present")
    return Context(torch.device("cuda", device_index))


def destroy(ctx: Context) -> Status:
    """Wait for the context's card to finish its work; mirrors
    ``spgpuDestroy`` (``core.c:43-48``).  Nothing is freed: torch owns the
    streams and memory."""
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return Status.SUCCESS


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
