"""Host allocator tuning for conversion-scale NumPy workloads.

A copy of :mod:`spgpu_tpu.utils.hostmem`, carried so the PyTorch port
never imports the JAX package; the opt-out variable keeps its name.

The layout builders (:mod:`spgpu_tpu_torch.convert`) stream tens of millions
of entries through m-sized NumPy temporaries.  glibc hands every such
allocation to ``mmap`` and returns it to the kernel on free, so each
conversion pays the full soft-page-fault cost again — on the
virtualised hosts this library targets (Firecracker-class microVMs)
faulting fresh pages measures at only ~30–140 MB/s, which made a
26.8M-nnz packed-WHELL conversion spend >10 s of its 15 s wall time in
page faults (measured: the same elementwise expression runs 34 s on
first touch, 1.5 s on reuse).

:func:`tune_malloc` raises ``M_MMAP_THRESHOLD`` and disables trimming
via ``mallopt`` so large buffers come from (and return to) the sbrk
heap, where freed pages stay resident and are reused fault-free.  The
cost is that the process retains its peak NumPy working set (a few GB
at the 26.8M-nnz class); set ``SPGPU_TPU_NO_MALLOC_TUNING=1`` before
import to opt out.  Measured effect: steady-state 26.8M-nnz conversion
15 s → ~5 s.

The reference's conversions are single-threaded C walks over
caller-owned host arrays (``hell.c:46-104``) and never faced this; it
is a property of the NumPy temporary-buffer lifecycle, not of the
algorithms.
"""

from __future__ import annotations

import ctypes
import os
import sys

__all__ = ["tune_malloc", "prefault"]

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_done = False


def tune_malloc() -> bool:
    """Keep large freed buffers heap-resident (idempotent; returns
    whether tuning is active).  No-op off Linux/glibc or when
    ``SPGPU_TPU_NO_MALLOC_TUNING`` is set."""
    global _done
    if _done:
        return True
    if os.environ.get("SPGPU_TPU_NO_MALLOC_TUNING"):
        return False
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30)
        ok &= libc.mallopt(_M_TRIM_THRESHOLD, 2 ** 31 - 1)
        _done = bool(ok)
    except Exception:
        return False
    return _done


def prefault(nbytes: int) -> None:
    """Touch ``nbytes`` of heap once so later NumPy allocations of that
    magnitude reuse already-faulted pages.  Useful before timing a
    first conversion; harmless elsewhere."""
    if not tune_malloc():
        return
    import numpy as np

    scratch = np.empty(nbytes, dtype=np.uint8)
    scratch[::4096] = 1
    del scratch
