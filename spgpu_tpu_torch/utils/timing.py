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
    (CUPTI hands back an empty buffer), or only part of it, which would
    under-report the time.  Every call of ``fn`` issues the same device
    operations, so each operation's count in the session tells how many
    of its events were lost (:func:`_tally`): a session that lost none,
    or one event of an operation (seen on the H100 in every session after
    one that profiled a loop with host reads), is used; any other is
    repeated, up to ``attempts`` times in all.  If none is usable, the
    time comes from CUDA events around ``iters`` back-to-back calls,
    ``(ms, "cuda_events")``, which counts the host gaps too and so is an
    upper bound on the device time."""
    require_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        times, usable = _session(fn, iters)
        if usable:
            return sum(times.values()), "profiler"
    t = time_interleaved({"fn": fn}, reps=1, iters=iters, warmup=0)
    return t["fn"]["best_ms"], "cuda_events"


def device_ms_by_kernel(fn: Callable[[], object], iters: int = 20,
                        warmup: int = 3, attempts: int = 5) -> Dict[str, float]:
    """Device milliseconds per call of ``fn()`` for each kernel, memset
    and copy it issues, by name (a kernel's name without its namespace,
    template arguments and parameters), from ``torch.profiler``: where
    the time of a call that runs several device operations goes.  From
    the first usable session (see :func:`device_ms`) of up to
    ``attempts``; empty when none is usable."""
    require_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        times, usable = _session(fn, iters)
        if usable:
            return times
    return {}


def _session(fn: Callable[[], object], iters: int) -> Tuple[Dict[str, float], bool]:
    """One profiling session of ``iters`` calls, tallied by :func:`_tally`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
            events.append((name.split("(")[0].split("<")[0].split("::")[-1].strip(),
                           e.device_time / 1e3))
    return _tally(events, iters)


def _tally(events, iters: int) -> Tuple[Dict[str, float], bool]:
    """Device ms per call by operation name from one session's ``(name,
    ms)`` events of ``iters`` calls, and whether the session is usable.
    Each call issues ``k`` events of a name, ``k`` the count over
    ``iters`` rounded; the session is usable when it is not empty and no
    name lost more than one event (``count`` is ``k·iters`` or one less).
    A name's time per call is its mean event time times ``k``: the summed
    time over ``iters`` when nothing was lost."""
    total: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for name, ms in events:
        total[name] = total.get(name, 0.0) + ms
        count[name] = count.get(name, 0) + 1
    per_call = {n: max(1, round(c / iters)) for n, c in count.items()}
    usable = bool(count) and all(0 <= per_call[n] * iters - c <= 1
                                 for n, c in count.items())
    return {n: total[n] / count[n] * per_call[n] for n in total}, usable
