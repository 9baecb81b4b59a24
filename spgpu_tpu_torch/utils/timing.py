"""Device timing with CUDA events and ``torch.profiler``.

Counterpart of :mod:`spgpu_tpu.utils.timing` for the GPU: after a
warm-up, each candidate is timed over a run of launches between two CUDA
events, and the candidates take turns rep by rep so that clock and power
drift falls on all of them alike.  Reports the best and the spread.
Device times come from profiling sessions (:func:`device_ms`,
:func:`device_ms_by_kernel`, :func:`kernel_device_ms`), the last also
with the L2 cache cold before every call.

It also holds spGPU's wall clock and benchmark protocol
(``timing.hpp:22-70``, ``hellPerf.cpp:209-252``), as the JAX module
does: :class:`Clock` and :func:`benchmark_op`, which gives a
:class:`BenchResult`.  The JAX module's ``chained_time`` works around a
TPU runtime's per-call cost and has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from spgpu_tpu_torch.core import require_cuda

__all__ = ["time_interleaved", "device_ms", "device_ms_by_kernel",
           "kernel_device_ms", "Clock", "BenchResult", "benchmark_op", "loop_seconds",
           "squared_norm"]


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


def kernel_device_ms(fn: Callable[[], object], kernels: Sequence[str], *,
                     cold: bool = False, iters: int = 20, warmup: int = 3,
                     attempts: int = 3) -> Tuple[float, str]:
    """Device milliseconds per call of ``fn()`` in the kernels named
    ``kernels`` (names as :func:`device_ms_by_kernel` gives them; every
    other operation ``fn`` issues, such as a zero fill, is left out), and
    where they come from.

    Warm (the default), the calls run back to back, so operands that fit
    the card's L2 cache (50 MB on the H100) stay there from one call to the
    next.  ``cold=True`` flushes the L2 before every call
    (:func:`_l2_flush`), so that each call reads its operands from device
    memory; the flush's operations are left out by name.

    A session is used under :func:`device_ms`'s rule (:func:`_tally`) if
    it holds every named kernel, else repeated, up to ``attempts`` times
    in all: ``(ms, "profiler")``.  If none is usable, CUDA events around
    each call (after its flush) give ``(ms, "cuda_events")``, an upper
    bound that counts ``fn``'s other operations and its host gaps."""
    require_cuda()
    flush = _l2_flush() if cold else None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        times, usable = _session(fn, iters, flush)
        if usable and all(k in times for k in kernels):
            return sum(times[k] for k in kernels), "profiler"
    return _call_events_ms(fn, iters, flush), "cuda_events"


def _l2_flush() -> Callable[[], object]:
    """The flush before a cold call: write a scratch buffer of 4x the
    current device's L2, then read another of 4x, so that the L2 holds
    none of the call's operands and no dirty line either, whose write-back
    the call would otherwise pay (a write-only flush measured 4.4-4.9 us
    more per call on the H100 sweeps' 29-40 MB working sets)."""
    l2 = torch.cuda.get_device_properties(torch.cuda.current_device()).L2_cache_size
    write, read = torch.empty(2 * l2, dtype=torch.float32, device="cuda").chunk(2)

    def flush():
        write.fill_(0.0)
        read.sum()
    return flush


def _call_events_ms(fn: Callable[[], object], iters: int,
                    flush: Optional[Callable[[], object]]) -> float:
    """Mean ms between CUDA events recorded just before and just after
    each of ``iters`` calls, each after ``flush()`` if given."""
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def _session(fn: Callable[[], object], iters: int,
             flush: Optional[Callable[[], object]] = None) -> Tuple[Dict[str, float], bool]:
    """One profiling session of ``iters`` calls, each after ``flush()`` if
    given, tallied by :func:`_tally`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
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


class Clock:
    """Monotonic wall clock; parity with ``timing.hpp``'s ``Clock``."""

    def get_time(self) -> float:
        return time.perf_counter()


@dataclasses.dataclass
class BenchResult:
    seconds_per_iter: float
    iters: int
    gflops: Optional[float]
    checksum: float
    bytes_per_iter: Optional[int] = None

    @property
    def gbytes_per_sec(self) -> Optional[float]:
        if self.bytes_per_iter is None:
            return None
        return self.bytes_per_iter / self.seconds_per_iter / 1e9


def _first_tensor(out) -> torch.Tensor:
    """``out`` or the first tensor of a tuple or list ``out``."""
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def squared_norm(z: torch.Tensor) -> float:
    """‖z‖², over every real component, in float64 on the host: the JAX
    ``dot(z, z)`` summed over a plane stack's planes."""
    v = z.detach().cpu()
    v = torch.view_as_real(v) if v.is_complex() else v
    return float(np.square(v.double().numpy()).sum())


def loop_seconds(fn: Callable[[], object], iters: int,
                 device: Optional[torch.device] = None) -> float:
    """Seconds per call of ``fn()`` over ``iters`` calls back to back, by
    :class:`Clock`, with the card ``device`` (if given) synchronised just
    before and after the loop."""
    clock = Clock()
    if device is not None:
        torch.cuda.synchronize(device)
    t0 = clock.get_time()
    for _ in range(iters):
        fn()
    if device is not None:
        torch.cuda.synchronize(device)
    return (clock.get_time() - t0) / iters


def benchmark_op(fn: Callable, *args, iters: int = 1000, nnz: Optional[int] = None,
                 bytes_per_iter: Optional[int] = None,
                 checksum_fn: Optional[Callable] = None) -> BenchResult:
    """spGPU's measurement protocol on ``fn(*args)``: a warm-up call, the
    checksum of its result (:func:`squared_norm` of the first tensor, or
    ``checksum_fn(out)``), then ``iters`` calls back to back and one
    ``torch.cuda.synchronize()`` when the result lies on a card
    (``hellPerf.cpp:238-245`` and its ``cudaDeviceSynchronize``), timed by
    :class:`Clock`; GFLOPS = (2·nnz − 1)/t.  The time counts the host's
    launch work too: it is the time per call, not the device's."""
    out = fn(*args)
    first = _first_tensor(out)
    on_card = first.device.type == "cuda"
    checksum = squared_norm(first) if checksum_fn is None else float(checksum_fn(out))
    t = loop_seconds(lambda: fn(*args), iters, first.device if on_card else None)
    gflops = None if nnz is None else (2.0 * nnz - 1.0) / t * 1e-9
    return BenchResult(t, iters, gflops, checksum, bytes_per_iter)
