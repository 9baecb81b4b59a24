"""The metric arithmetic: rates over a whole window, a tail over all
samples, the union of device intervals, the profiler's event tally and
the spread that bounds are set from."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["MIN_TAIL_SAMPLES", "busy_union", "idle_gaps", "p95", "per_call", "rate",
           "spread", "tally"]

#: samples a 95th percentile needs, so that at least 10 lie beyond it
MIN_TAIL_SAMPLES = 200


def rate(work: float, seconds: float) -> float:
    """Work per second over the whole window: all the work done in it over
    all of its time (never a median of chunks)."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return work / seconds


def p95(samples: Sequence[float]) -> Optional[float]:
    """The 95th percentile of every sample (linear interpolation between
    order statistics), or None below :data:`MIN_TAIL_SAMPLES` samples."""
    if len(samples) < MIN_TAIL_SAMPLES:
        return None
    return statistics.quantiles(samples, n=100, method="inclusive")[94]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median, as ``statistics.quantiles(values, n=4)`` gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def busy_union(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


def idle_gaps(intervals: Iterable[Tuple[float, float]], t0: float,
              t1: float) -> List[Tuple[float, float]]:
    """The ``(start, end)`` stretches of ``[t0, t1]`` that no interval
    covers, in time order."""
    gaps, end = [], t0
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, t1)))
        end = max(end, b)
        if end >= t1:
            break
    if end < t1:
        gaps.append((end, t1))
    return [g for g in gaps if g[1] > g[0]]


def tally(events: Iterable[Tuple[str, float]], calls: int) -> Tuple[Dict[str, float], bool]:
    """Time per call by operation name from one profiling session's
    ``(name, time)`` events of ``calls`` identical calls, and whether the
    session is usable.  Each call issues ``k`` events of a name, ``k`` the
    count over ``calls`` rounded; the session is usable when it is not
    empty and no name lost more than one event.  A name's time per call
    is its mean event time times ``k``."""
    total: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for name, t in events:
        total[name] = total.get(name, 0.0) + t
        count[name] = count.get(name, 0) + 1
    k = {n: max(1, round(c / calls)) for n, c in count.items()}
    usable = bool(count) and all(0 <= k[n] * calls - c <= 1 for n, c in count.items())
    return {n: total[n] / count[n] * k[n] for n in total}, usable


def per_call(events: Iterable[Tuple[str, float]], calls: int) -> Optional[float]:
    """Device time of one call from a session of ``calls`` identical calls
    (:func:`tally`), or None where the session is not usable."""
    times, usable = tally(events, calls)
    return sum(times.values()) if usable else None


def idle_pct(rec: dict) -> Optional[float]:
    """The traced slice's idle share in %: 1 - device busy / slice length;
    None without a slice in which the device ran."""
    if not rec.get("window_s") or not rec.get("busy_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def solve_median_ms(rec: dict) -> Optional[float]:
    """The median of the solves' wall times outside the traced slice, ms."""
    times = rec.get("solve_s")
    return 1e3 * statistics.median(times) if times else None


def solve_p95_ms(rec: dict) -> Optional[float]:
    """The 95th percentile of the solves' wall times outside the traced
    slice, ms; None below :data:`MIN_TAIL_SAMPLES` of them."""
    q = p95(rec.get("solve_s") or [])
    return None if q is None else 1e3 * q
