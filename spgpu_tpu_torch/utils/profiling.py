"""Profiling and roofline helpers.

Counterpart of :mod:`spgpu_tpu.utils.profiling`:

* :func:`time_op` — seconds per ``op(a, x)`` over a chained loop, by CUDA
  events on the card and the host clock on the CPU;
* :func:`roofline_report` — the achieved rate against the card's HBM rate
  (:func:`spgpu_tpu_torch.core.hbm_bandwidth`), with the JAX keys;
* :func:`trace` — a ``torch.profiler`` session that writes a Chrome trace;
* :func:`span` — a range of the program's own (the Krylov loop's phases)
  in that trace, on the profiler's clock, and nothing while no profiler
  records.

One deviation: the JAX ``trace`` swallows any error raised inside it (a
TPU runtime there cannot always trace the device); this one lets every
error through, its trace written all the same.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch

from spgpu_tpu_torch.core import hbm_bandwidth

__all__ = ["time_op", "roofline_report", "span", "trace"]

#: what :func:`span` gives while no profiler records
_OFF = contextlib.nullcontext()
#: the host-only range behind :func:`span`, where this torch has one
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def time_op(op: Callable, a, x: torch.Tensor, iters: int = 20, repeats: int = 3) -> float:
    """Seconds per ``op(a, x)`` over a chained loop ``x ← op(a, x)·1e-3``
    of ``iters`` calls after one warm-up loop, the best of ``repeats``:
    CUDA events around the loop for a tensor on a card, else the host
    clock.  ``op`` maps ``(a, x)`` to a result shaped like ``x`` (SpMV on
    a square matrix, an elementwise op, ...)."""
    def chained():
        c = x
        for _ in range(iters):
            c = op(a, c) * 1e-3
        return c

    on_card = x.device.type == "cuda"
    chained()
    best = float("inf")
    for _ in range(repeats):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chained()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            chained()
            t = time.perf_counter() - t0
        best = min(best, t / iters)
    return best


def roofline_report(name: str, t_seconds: float, bytes_moved: int,
                    flops: int, device=None) -> dict:
    """The achieved bandwidth and FLOP rate against ``device``'s HBM rate
    (``None`` where :func:`~spgpu_tpu_torch.core.hbm_bandwidth` knows none)."""
    bw = hbm_bandwidth(device)
    achieved_bw = bytes_moved / t_seconds
    return {
        "name": name,
        "t_s": t_seconds,
        "gflops": flops / t_seconds / 1e9,
        "achieved_gbs": achieved_bw / 1e9,
        "roofline_gbs": (bw / 1e9) if bw else None,
        "roofline_frac": (achieved_bw / bw) if bw else None,
    }


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host activity, and the card's where there is
    one) and write its Chrome trace into ``log_dir`` (``*.pt.trace.json``,
    ``torch.profiler.tensorboard_trace_handler``'s naming); yields the
    ``torch.profiler.profile``.  An error inside the block propagates,
    after the trace is written."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def span(name: str):
    """A range named ``name`` on the profiler's clock while a profiler
    records (``torch.autograd._profiler_enabled()``), else a shared
    ``nullcontext``: off, a span costs one bool check.

    The range is a host-side record-function event of function scope
    (``torch._C._profiler._RecordFunctionFast``), not
    ``torch.profiler.record_function``: that one's user scope also puts a
    copy of the range on the card's timeline (a GPU user annotation over
    the kernels launched inside it), which a reader of the device's
    operations would count as device work.  A torch without the fast
    range records no span."""
    if not torch.autograd._profiler_enabled() or _RANGE is None:
        return _OFF
    return _RANGE(name)
