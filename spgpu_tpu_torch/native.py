"""ctypes binding of the C++ layout helpers the port's converters call.

The source is the port's own ``spgpu_tpu_torch/csrc/conversion.cpp``, a
copy of the JAX package's ``native/conversion.cpp`` (a test holds the two
identical, but for one comment that cites spGPU's sources by a relative
path), compiled into ``spgpu_tpu_torch/_build/`` with
the JAX package's ``g++`` flags, so both packages run the same first-fit
assigner and WHDIA tiler and produce bit-identical layouts, and the same
Matrix Market tokenizer (:func:`mm_parse`).  The port
reads no file of the JAX package.

There is no NumPy fallback: the fallback assigner gives a different and
much worse layout (measured 5.44x padding against 1.74x on the flagship
FEM matrix), so a missing compiler raises instead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time

import numpy as np

__all__ = ["BUILD_DIR", "SOURCE", "build", "mm_parse", "whdia_tile", "whell_assign",
           "whell_hack_fill", "whell_gather_assign", "whell_gather_assign_par",
           "whell_scatter_slabs"]

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCE = os.path.join(_PKG, "csrc", "conversion.cpp")
_SO = os.path.join(BUILD_DIR, "libspgpu_native.so")

_lock = threading.Lock()
_lib = None

_i8 = ctypes.POINTER(ctypes.c_int8)
_i32 = ctypes.POINTER(ctypes.c_int32)
_i64 = ctypes.POINTER(ctypes.c_int64)
_n = ctypes.c_int64


def build() -> float:
    """Compile the helpers if the library is missing or older than its
    source; returns the seconds the compile took (0.0 when up to date)."""
    if not os.path.exists(SOURCE):
        raise RuntimeError(f"native source not found: {SOURCE}")
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(SOURCE):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        try:  # OpenMP for the parallel assign/scatter passes
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-fopenmp",
                            SOURCE, "-o", tmp],
                           check=True, capture_output=True, timeout=300)
        except subprocess.CalledProcessError:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", SOURCE,
                            "-o", tmp],
                           check=True, capture_output=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ is required to build the WHELL/WHDIA layout "
                           "helpers (no NumPy fallback)") from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError("g++ failed to build the layout helpers:\n"
                           + e.stderr.decode(errors="replace")) from e
    os.replace(tmp, _SO)  # atomic: a concurrent compile never sees a torn file
    return time.perf_counter() - t0


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        lib = ctypes.CDLL(_SO)
        lib.whdia_tile.restype = ctypes.c_int64
        lib.whdia_tile.argtypes = [_i64, _i64, _n, _n, _i64, _i64, _i64, _i64]
        lib.whell_hack_fill.restype = ctypes.c_int64
        lib.whell_hack_fill.argtypes = [_i64, _n, _n, _i64, _i64]
        lib.whell_gather_assign.restype = ctypes.c_int64
        lib.whell_gather_assign.argtypes = [
            _i64, _i64, _i32, _i64, _i64, _i64, _n, _n, _n,
            _i64, _i64, _i8, _i8, _i64, _i64, _i64]
        lib.whell_gather_assign_par.restype = ctypes.c_int64
        lib.whell_gather_assign_par.argtypes = [
            _i64, _i64, _i32, _i64, _i64, _i8, _i64, _n,
            _i64, _i64, _i8, _i64, _i64]
        lib.whell_assign.restype = None
        lib.whell_assign.argtypes = [_i64, _i64, _i64, _i64, _n, _i64]
        lib.whell_scatter_slabs.restype = None
        lib.whell_scatter_slabs.argtypes = [
            _i64, ctypes.c_void_p, _i64, _i64, _i64, _i64, _i8, _i8,
            _n, _n, ctypes.c_void_p, _i8, _i8, _i64]
        lib.mm_parse.restype = ctypes.c_int64
        lib.mm_parse.argtypes = [ctypes.c_char_p, _n, _n, _n, _i64, _i64,
                                 ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return lib


def _c(a: np.ndarray, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=dtype)


def _p(a: np.ndarray, ptr):
    return a.ctypes.data_as(ptr)


def whdia_tile(slot_hack: np.ndarray, slot_diag: np.ndarray, spread: int):
    """Greedy 8-slot WHDIA tiling (a new tile when full, on a new hack, or
    past ``spread``); returns ``(tile_of_slot, pos_of_slot, tile_hack,
    tile_d0)``."""
    lib = _load()
    n = slot_hack.size
    sh, sd = _c(slot_hack, np.int64), _c(slot_diag, np.int64)
    tos = np.empty(n, dtype=np.int64)
    pos = np.empty(n, dtype=np.int64)
    th = np.empty(max(n, 1), dtype=np.int64)
    td = np.empty(max(n, 1), dtype=np.int64)
    nt = lib.whdia_tile(_p(sh, _i64), _p(sd, _i64), n, spread, _p(tos, _i64),
                        _p(pos, _i64), _p(th, _i64), _p(td, _i64))
    return tos, pos, th[:nt], td[:nt]


def whell_hack_fill(d: np.ndarray, cap: int = 128):
    """Greedy weighted row→hack binning of lane widths ``d``; returns
    ``(num_hacks, hack_of_row, lane_start)``."""
    lib = _load()
    d = _c(d, np.int64)
    hof = np.empty(d.size, dtype=np.int64)
    ls = np.empty(d.size, dtype=np.int64)
    nh = lib.whell_hack_fill(_p(d, _i64), d.size, cap, _p(hof, _i64),
                             _p(ls, _i64))
    return int(nh), hof, ls


def whell_gather_assign(order, rows, cols_l, d, lane_start, hack_of_row,
                        nwin: int, w: int):
    """Aligned-window gather + first-fit + group widths in one pass.

    Returns ``(ngroups, slot, lane, res8, del8, gid, gW, gG)`` with the
    per-entry outputs in sorted-entry order."""
    lib = _load()
    m = order.size
    order, rows = _c(order, np.int64), _c(rows, np.int64)
    cols_l = _c(cols_l, np.int32)
    d, lane_start = _c(d, np.int64), _c(lane_start, np.int64)
    hack_of_row = _c(hack_of_row, np.int64)
    slot = np.empty(m, dtype=np.int64)
    lane = np.empty(m, dtype=np.int64)
    res8 = np.empty(m, dtype=np.int8)
    del8 = np.empty(m, dtype=np.int8)
    gid = np.empty(m, dtype=np.int64)
    gW = np.empty(max(m, 1), dtype=np.int64)
    gG = np.empty(max(m, 1), dtype=np.int64)
    ng = lib.whell_gather_assign(
        _p(order, _i64), _p(rows, _i64), _p(cols_l, _i32), _p(d, _i64),
        _p(lane_start, _i64), _p(hack_of_row, _i64), m, nwin, w,
        _p(slot, _i64), _p(lane, _i64), _p(res8, _i8), _p(del8, _i8),
        _p(gid, _i64), _p(gW, _i64), _p(gG, _i64))
    return int(ng), slot, lane, res8, del8, gid, gW[:ng], gG[:ng]


def whell_gather_assign_par(order, rows, cols_l, d, lane_start, dlt, starts):
    """Scattered-window gather + first-fit over precomputed group bounds
    (``starts``: ``ngroups + 1`` sorted-entry offsets), groups in parallel.

    Returns ``(slot, lane, res8, gid, gW)`` in sorted-entry order."""
    lib = _load()
    m = order.size
    order, rows = _c(order, np.int64), _c(rows, np.int64)
    cols_l = _c(cols_l, np.int32)
    d, lane_start = _c(d, np.int64), _c(lane_start, np.int64)
    dlt, starts = _c(dlt, np.int8), _c(starts, np.int64)
    ngroups = starts.size - 1
    slot = np.empty(m, dtype=np.int64)
    lane = np.empty(m, dtype=np.int64)
    res8 = np.empty(m, dtype=np.int8)
    gid = np.empty(m, dtype=np.int64)
    gW = np.empty(max(ngroups, 1), dtype=np.int64)
    lib.whell_gather_assign_par(
        _p(order, _i64), _p(rows, _i64), _p(cols_l, _i32), _p(d, _i64),
        _p(lane_start, _i64), _p(dlt, _i8), _p(starts, _i64), ngroups,
        _p(slot, _i64), _p(lane, _i64), _p(res8, _i8), _p(gid, _i64),
        _p(gW, _i64))
    return slot, lane, res8, gid, gW


def whell_assign(G: np.ndarray, lane: np.ndarray, res: np.ndarray,
                 dlt: np.ndarray) -> np.ndarray:
    """Classic WHELL first-fit: entries sorted by (group, row, col) get the
    first slot of their group whose lane is free and whose residue maps to
    their page (or to none yet); returns each entry's slot in its group."""
    lib = _load()
    m = G.size
    G, lane = _c(G, np.int64), _c(lane, np.int64)
    res, dlt = _c(res, np.int64), _c(dlt, np.int64)
    out = np.empty(m, dtype=np.int64)
    lib.whell_assign(_p(G, _i64), _p(lane, _i64), _p(res, _i64), _p(dlt, _i64),
                     m, _p(out, _i64))
    return out


def whell_scatter_slabs(order, vals, g_tile0, gid, k, lane, res, dlt,
                        total_slots: int):
    """Scatter entries into zeroed ``(total_slots, 128)`` value, residue
    and page-table slabs (cells are distinct by construction).  ``vals``
    may have any element size.  Returns ``(vals, res8, pt8, slot)``."""
    lib = _load()
    m = order.size
    order = _c(order, np.int64)
    vals = np.ascontiguousarray(vals)
    g_tile0, gid = _c(g_tile0, np.int64), _c(gid, np.int64)
    k, lane = _c(k, np.int64), _c(lane, np.int64)
    res, dlt = _c(res, np.int8), _c(dlt, np.int8)
    vslab = np.zeros((total_slots, 128), dtype=vals.dtype)
    rslab = np.zeros((total_slots, 128), dtype=np.int8)
    pslab = np.zeros((total_slots, 128), dtype=np.int8)
    slot = np.empty(m, dtype=np.int64)
    lib.whell_scatter_slabs(
        _p(order, _i64), ctypes.c_void_p(vals.ctypes.data),
        _p(g_tile0, _i64), _p(gid, _i64), _p(k, _i64), _p(lane, _i64),
        _p(res, _i8), _p(dlt, _i8), m, vals.dtype.itemsize,
        ctypes.c_void_p(vslab.ctypes.data), _p(rslab, _i8), _p(pslab, _i8),
        _p(slot, _i64))
    return vslab, rslab, pslab, slot


def mm_parse(buf: bytes, ntok: int, nnz: int):
    """Parallel strict tokenizer for a Matrix Market coordinate body.

    ``ntok`` = tokens per line (2 pattern / 3 real-integer / 4 complex);
    returns ``(rows, cols, vals)`` int64/int64/float64 arrays (``vals``
    shape ``(n, 2)`` for complex, ``(n,)`` real/integer, size 0
    pattern), or ``None`` when the body is malformed or line-misaligned
    (callers fall back to ``np.loadtxt``).  Row/col are returned 1-BASED
    as in the file.  A missing compiler raises (:func:`build`)."""
    lib = _load()
    if isinstance(buf, str):
        buf = buf.encode("ascii", errors="replace")
    nval = ntok - 2
    cap = nnz + 8
    rows = np.empty(cap, dtype=np.int64)
    cols = np.empty(cap, dtype=np.int64)
    vals = np.empty(cap * (2 if nval == 2 else 1) if nval else 1,
                    dtype=np.float64)
    n = lib.mm_parse(buf, len(buf), ntok, cap, _p(rows, _i64), _p(cols, _i64),
                     vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if n != nnz:
        return None
    if nval == 2:
        v = vals[: 2 * n].reshape(n, 2)
    elif nval == 1:
        v = vals[:n]
    else:
        v = vals[:0]
    return rows[:n], cols[:n], v
