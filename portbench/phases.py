"""The traced slice's device idle time split by the phase of the port's
Krylov loop that the host was in: each idle instant of the slice (a gap
of the union of its device operations, :func:`portbench.stats.idle_gaps`)
goes to the innermost program span open at that instant
(``spgpu.krylov.*``, ``solvers/cg.py``'s spans, host ranges on the
profiler's clock), or to none.

    python3 -m portbench.phases --workload <name> --seed <n> --seconds <s>

runs a solve cell once, traced, as ``portbench.run --trace 1`` does, with
a slice that keeps the program's spans beside its record, and prints one
JSON object: the result line, the idle split in % of the slice
(``idle_in_capture``, ``idle_in_replays``, ``idle_in_loop_other``,
``idle_outside_loop``; they sum to ``device_idle.solve``), the ten longest
idle gaps named by the innermost span of either kind open at their
middle, the wall times of the solves inside the slice, and the device
operations that bear a program span's name (a span's copy on the card's
timeline; the program's spans make none).  A program without spans reads
all its idle as ``idle_outside_loop``."""

from __future__ import annotations

import json
import statistics
import sys
from typing import Dict, List, Optional, Tuple

from portbench import stats, trace

__all__ = ["PROGRAM", "PhaseSlice", "idle_by_span", "idle_split", "longest_gaps", "main"]

#: prefix of the program's spans among the profiler's CPU events
PROGRAM = "spgpu."

Span = Tuple[str, float, float]


def _pieces(spans: List[Span], t0: float, t1: float) -> List[Tuple[float, float, Optional[str]]]:
    """``[t0, t1]`` cut at every span's edges, each piece with the name of
    the innermost (shortest) span open over it, or None."""
    edges = sorted({t0, t1} | {t for _, a, b in spans for t in (a, b) if t0 < t < t1})
    order = sorted(spans, key=lambda s: s[1])
    out, open_, j = [], [], 0
    for a, b in zip(edges, edges[1:]):
        while j < len(order) and order[j][1] <= a:
            open_.append(order[j])
            j += 1
        open_ = [s for s in open_ if s[2] > a]
        inner = min(open_, key=lambda s: s[2] - s[1], default=None)
        out.append((a, b, inner[0] if inner else None))
    return out


def idle_by_span(device_ops: List[Span], spans: List[Span], t0: float,
                 t1: float) -> Dict[Optional[str], float]:
    """Seconds of ``[t0, t1]`` in which no device operation ran, by the
    innermost of ``spans`` open then (None: no span open); the values sum
    to the slice's idle seconds."""
    gaps = stats.idle_gaps([(a, b) for _, a, b in device_ops if b > t0 and a < t1], t0, t1)
    pieces = _pieces(spans, t0, t1)
    out: Dict[Optional[str], float] = {}
    i = 0
    for g0, g1 in gaps:
        while pieces[i][1] <= g0:
            i += 1
        k = i
        while k < len(pieces) and pieces[k][0] < g1:
            a, b, name = pieces[k]
            out[name] = out.get(name, 0.0) + min(b, g1) - max(a, g0)
            k += 1
    return out


def idle_split(sl: dict) -> Optional[dict]:
    """The slice's idle time in % of its length by the loop's phase, from a
    record with ``program_spans`` (:class:`PhaseSlice`): ``capture`` and
    ``replays`` (those spans innermost), ``loop_other`` (any other program
    span innermost) and ``outside`` (no program span open).  None for an
    empty slice."""
    t0, t1 = sl["t0"], sl["t1"]
    if t1 <= t0:
        return None
    by = idle_by_span(sl["device_ops"], sl["program_spans"], t0, t1)
    capture = by.pop(PROGRAM + "krylov.capture", 0.0)
    replays = by.pop(PROGRAM + "krylov.replays", 0.0)
    outside = by.pop(None, 0.0)
    pct = lambda s: 100.0 * s / (t1 - t0)  # noqa: E731
    return {"idle_in_capture": pct(capture), "idle_in_replays": pct(replays),
            "idle_in_loop_other": pct(sum(by.values())), "idle_outside_loop": pct(outside)}


def longest_gaps(sl: dict) -> list:
    """The slice's 10 longest idle gaps, longest first, each named by the
    innermost span of either kind (the program's or the benchmark's) open
    at its middle: the breakdown's ``idle_gaps``
    (:func:`portbench.trace.summarize`) over both lists of spans."""
    merged = dict(sl, spans=sl["spans"] + sl["program_spans"])
    return trace.summarize(merged)["breakdown"]["idle_gaps"]


class PhaseSlice(trace.Slice):
    """The benchmark's slice, its record also holding the program's spans
    (``program_spans``: host ranges named ``spgpu.*``, on the record's
    clock); the last record is kept in :attr:`last`."""

    last: Optional[dict] = None

    def record(self) -> Optional[dict]:
        rec = super().record()
        if rec is None:
            return None
        from torch.autograd import DeviceType

        host = [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
                for e in self._prof.events() if e.device_type != DeviceType.CUDA]
        # the record's origin, from its first benchmark span, which lies in both
        first = next((a for name, a, _ in host if name.startswith(trace.SPAN)), None)
        origin = first - rec["spans"][0][1] if first is not None and rec["spans"] else 0.0
        rec["program_spans"] = [(name, a - origin, b - origin) for name, a, b in host
                                if name.startswith(PROGRAM)]
        PhaseSlice.last = rec
        return rec


def main(argv=None) -> int:
    import torch

    from portbench import run, spec

    args = run.parse(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print(f"{cell.name} needs a CUDA card: no result", file=sys.stderr)
        return 2
    trace.Slice = PhaseSlice  # the cell's slice also keeps the program's spans
    line = run.run_one(cell, torch.device("cuda", 0), args.seed, args.seconds, True,
                       run.T_START)
    sl = PhaseSlice.last
    out = {"line": line}
    if sl is not None:
        solves = [1e3 * (b - a) for name, a, b in sl["spans"] if name == "solve"]
        out.update(split=idle_split(sl), idle_gaps=longest_gaps(sl),
                   slice_solve_ms=solves,
                   slice_solve_median_ms=statistics.median(solves) if solves else None,
                   span_copies_on_device=sum(name.startswith(PROGRAM)
                                             for name, _, _ in sl["device_ops"]),
                   program_spans=len(sl["program_spans"]))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
