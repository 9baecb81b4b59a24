"""Device timing with CUDA events.

Counterpart of :mod:`spgpu_tpu.utils.timing` for the GPU: after a
warm-up, each candidate is timed over a run of launches between two CUDA
events, and the candidates take turns rep by rep so that clock and power
drift falls on all of them alike.  Reports the best and the spread.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from spgpu_tpu_torch.core import require_cuda

__all__ = ["time_interleaved", "device_ms", "device_ms_by_kernel"]


def time_interleaved(fns: Dict[str, Callable[[], object]], reps: int = 5,
                     iters: int = 20, warmup: int = 3) -> Dict[str, dict]:
    """Milliseconds per call of each ``fn()`` on the current CUDA device.

    Returns ``{name: {"best_ms", "spread_ms"}}``: the best rep's mean and
    the max-min spread over reps.  Raises when
    there is no CUDA device (a host clock would time the enqueue only)."""
    require_cuda()
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / iters)
    return {name: {"best_ms": min(t), "spread_ms": max(t) - min(t)}
            for name, t in times.items()}


def device_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 3,
              attempts: int = 3) -> Tuple[float, str]:
    """Device milliseconds per call of ``fn()`` and where they come from.

    Normally ``(ms, "profiler")``: the summed GPU time of every kernel,
    memset and copy ``fn`` issues, from ``torch.profiler``.  Unlike
    :func:`time_interleaved`, gaps where the device waits for the host are
    not counted, so the two differ when launches are host-bound.

    A profiling session now and then records no device activity at all
    (CUPTI hands back an empty buffer).  The session is then repeated, up
    to ``attempts`` times in all; if none records any, the time comes from
    CUDA events around ``iters`` back-to-back calls, ``(ms,
    "cuda_events")``, which counts the host gaps too and so is an upper
    bound on the device time."""
    require_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        total = sum(device_ms_by_kernel(fn, iters=iters, warmup=0).values())
        if total > 0:
            return total, "profiler"
    t = time_interleaved({"fn": fn}, reps=1, iters=iters, warmup=0)
    return t["fn"]["best_ms"], "cuda_events"


def device_ms_by_kernel(fn: Callable[[], object], iters: int = 20,
                        warmup: int = 3) -> Dict[str, float]:
    """Device milliseconds per call of ``fn()`` for each kernel, memset
    and copy it issues, by name (a kernel's name without its namespace,
    template arguments and parameters), from ``torch.profiler``: where
    the time of a call that runs several device operations goes.  Empty
    when the session recorded no device activity (see :func:`device_ms`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    require_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0].split("<")[0].split("::")[-1].strip()
            out[name] = out.get(name, 0.0) + e.device_time / 1e3 / iters
    return out
