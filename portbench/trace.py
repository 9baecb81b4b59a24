"""The traced slice: ``torch.profiler`` over a short steady stretch of the
window, read into plain data that the per-layer readers take.

The benchmark's own spans (:func:`span`) are ``record_function`` ranges,
so they lie on the profiler's clock beside the device operations."""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch

__all__ = ["Slice", "kernel_name", "span"]

#: prefix of the benchmark's spans among the profiler's CPU events
SPAN = "portbench."


def span(name: str, on: bool):
    """A span of the benchmark named ``name`` while ``on`` (the traced
    slice), else nothing."""
    return torch.profiler.record_function(SPAN + name) if on else contextlib.nullcontext()


def kernel_name(name: str) -> str:
    """A device operation's name without its namespace, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def warm() -> None:
    """Start and stop the profiler once: its first start in a process
    takes seconds (CUPTI's set-up), which a traced run pays in set-up and
    not inside its window."""
    sl = Slice()
    sl.start()
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda").add_(1)
    sl.stop()


class Slice:
    """One profiled stretch: ``start()``, work, ``stop()``; then
    :meth:`record` gives its device operations and the benchmark's spans,
    each ``(name, start_s, end_s)``."""

    def __init__(self):
        self._prof = None
        self.running = False

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self.running = True

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.running = False
        self._prof.__exit__(None, None, None)

    def record(self) -> Optional[dict]:
        """The slice's events in seconds from its first event, or None if
        it never ran."""
        if self._prof is None:
            return None
        from torch.autograd import DeviceType

        device: List[Tuple[str, float, float]] = []
        spans: List[Tuple[str, float, float]] = []
        for e in self._prof.events():
            t0, t1 = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.name.startswith(SPAN):
                # a span's host range; its copy on the device's timeline
                # (a user annotation) is no device work
                if e.device_type != DeviceType.CUDA:
                    spans.append((e.name[len(SPAN):], t0, t1))
            elif e.device_type == DeviceType.CUDA:
                device.append((kernel_name(e.name), t0, t1))
        times = [t for _, t, _ in device + spans] + [t for _, _, t in device + spans]
        origin = min(times) if times else 0.0
        shift = lambda evs: [(n, a - origin, b - origin) for n, a, b in evs]  # noqa: E731
        spans = shift(spans)
        # the slice: from its first span's start to its last span's end
        # (the spans cover every call the slice made)
        t0 = min((a for _, a, _ in spans), default=0.0)
        t1 = max((b for _, _, b in spans), default=0.0)
        return {"device_ops": shift(device), "spans": spans, "t0": t0, "t1": t1}


def summarize(rec: dict) -> dict:
    """The slice's device busy seconds (the union of its operations inside
    the slice), its length, and the breakdown: the 10 device operations
    that took most time, by name, and the 10 longest idle gaps, each named
    by the innermost benchmark span open at its middle."""
    from portbench import stats

    t0, t1 = rec["t0"], rec["t1"]
    ops = [(n, max(a, t0), min(b, t1)) for n, a, b in rec["device_ops"] if b > t0 and a < t1]
    by_name: dict = {}
    for n, a, b in ops:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    gaps = stats.idle_gaps([(a, b) for _, a, b in ops], t0, t1)

    def label(mid):
        open_ = [(b - a, n) for n, a, b in rec["spans"] if a <= mid <= b]
        return min(open_)[1] if open_ else "none"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"busy_s": stats.busy_union([(a, b) for _, a, b in ops]), "window_s": t1 - t0,
            "breakdown": {
                "device_ops": sorted(([n, s] for n, s in by_name.items()),
                                     key=lambda e: -e[1])[:10],
                "idle_gaps": [[label((a + b) / 2), b - a] for a, b in longest]}}


def probe(fn, calls: int, attempts: int = 3):
    """Device seconds of one call of ``fn`` from a profiled run of
    ``calls`` calls back to back (:func:`portbench.stats.tally`; a session
    that lost more than one event of an operation is repeated, up to
    ``attempts`` in all), with the operation that takes most of it:
    ``{"per_call_s", "primary", "primary_s"}``, or None where no session
    is usable."""
    from portbench import stats

    fn()
    for _ in range(attempts):
        sl = Slice()
        sl.start()
        for _ in range(calls):
            fn()
        sl.stop()
        times, usable = stats.tally(((n, b - a) for n, a, b in sl.record()["device_ops"]),
                                    calls)
        if usable:
            primary = max(times, key=times.get)
            return {"per_call_s": sum(times.values()), "primary": primary,
                    "primary_s": times[primary]}
    return None


def vector_us_per_iter(rec: dict):
    """Device microseconds an iteration spends outside the products: the
    traced slice's busy time less its products' time, over the iterations
    its solves reported.  A product in the slice is an event of the
    product's main kernel (named by the back-to-back probe), plus the
    probe's other operations a product.  None without a probe or slice."""
    probe, sl = rec.get("probe"), rec.get("slice")
    if not probe or not sl or not rec.get("slice_iterations") or not rec.get("busy_s"):
        return None
    t0, t1 = sl["t0"], sl["t1"]
    main = [b - a for n, a, b in sl["device_ops"]
            if n == probe["primary"] and a >= t0 and b <= t1]
    products_s = sum(main) + len(main) * (probe["per_call_s"] - probe["primary_s"])
    return 1e6 * (rec["busy_s"] - products_s) / rec["slice_iterations"]
