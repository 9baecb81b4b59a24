"""The idle split by the loop's phase (``portbench/phases.py``) on synthetic
records and on a profiled CPU solve, and the readers of the loop's
counters (``masked_steps_per_solve``, ``pool_mallocs_per_solve``)."""

import importlib
import os
import sys
import types

import pytest
import torch

from portbench import phases, stats, trace
from portbench.spec import load_module

LAYER = os.path.join(os.path.dirname(os.path.dirname(__file__)), "layer_metrics")
LOOP = importlib.import_module("spgpu_tpu_torch.solvers.cg")

#: two solves of a slice [0, 10]: device operations, the benchmark's spans
#: and the program's (host ranges), as a traced record holds them
REC = {"t0": 0.0, "t1": 10.0,
       "spans": [("solve", 0.0, 4.0), ("solve", 4.0, 10.0)],
       "device_ops": [("spmv", 1.0, 2.0), ("axpby", 2.0, 3.0), ("spmv", 5.0, 6.0),
                      ("dot", 6.0, 6.5), ("late", 9.5, 11.0)],
       "program_spans": [("spgpu.krylov.cg", 0.5, 3.5), ("spgpu.krylov.setup", 0.5, 1.0),
                         ("spgpu.krylov.capture", 1.0, 1.5),
                         ("spgpu.krylov.replays", 1.5, 3.2),
                         ("spgpu.krylov.release", 3.2, 3.5),
                         ("spgpu.krylov.cg", 4.2, 9.0), ("spgpu.krylov.capture", 6.5, 8.2),
                         ("spgpu.krylov.replays", 8.2, 9.0)]}


def test_idle_split_sums_to_the_idle_share():
    """Idle [0, 1] is 0.5 s outside the loop and 0.5 s in set-up; [3, 5]
    0.2 s in replays, 0.3 s in the release, 0.7 s outside, 0.8 s in the
    solve's own span; [6.5, 9.5] 1.7 s in capture, 0.8 s in replays, 0.5 s
    outside."""
    split = phases.idle_split(REC)
    assert split == pytest.approx({"idle_in_capture": 17.0, "idle_in_replays": 10.0,
                                   "idle_in_loop_other": 16.0, "idle_outside_loop": 17.0})
    s = trace.summarize(REC)
    assert sum(split.values()) == pytest.approx(stats.idle_pct(s))
    by = phases.idle_by_span(REC["device_ops"], REC["program_spans"], 0.0, 10.0)
    assert by[None] == pytest.approx(1.7) and by["spgpu.krylov.cg"] == pytest.approx(0.8)
    # with no program span every idle instant lies outside the loop
    bare = phases.idle_split(dict(REC, program_spans=[]))
    assert bare["idle_outside_loop"] == pytest.approx(stats.idle_pct(s))
    assert phases.idle_split(dict(REC, t1=0.0)) is None


def test_program_spans_leave_every_reader_as_it_was():
    """The program's spans are no device operations: the summary, the idle
    share and the vector reader read the same with and without them."""
    bare = {k: v for k, v in REC.items() if k != "program_spans"}
    assert trace.summarize(REC) == trace.summarize(bare)
    vector = load_module(os.path.join(LAYER, "vector_us_per_iter.py"))
    probe = {"per_call_s": 1.25, "primary": "spmv", "primary_s": 1.0}
    for rec in (REC, bare):
        full = dict(trace.summarize(rec), slice=rec, slice_iterations=2, probe=probe)
        assert vector.read(full) == pytest.approx(1e6 * (4.0 - 2.5) / 2)
        assert stats.idle_pct(full) == pytest.approx(60.0)


def test_longest_gaps_are_named_by_the_innermost_span():
    gaps = phases.longest_gaps(REC)
    assert gaps[0] == ["spgpu.krylov.capture", pytest.approx(3.0)]
    assert gaps[1] == ["solve", pytest.approx(2.0)]  # its middle, 4.0, lies in no program span
    assert gaps[2] == ["spgpu.krylov.setup", pytest.approx(1.0)]


def test_phase_slice_keeps_the_program_spans_on_the_record_clock():
    """On the CPU: the program's spans of a profiled solve lie inside the
    benchmark's span around it, and the record is otherwise the slice's."""
    a = torch.eye(30, dtype=torch.float64) * 3 + 0.1
    b = torch.ones(30, dtype=torch.float64)
    sl = phases.PhaseSlice()
    sl.start()
    with trace.span("solve", True):
        LOOP.cg(lambda v: a @ v, b, tol=1e-10, maxiter=100)
    sl.stop()
    rec = sl.record()
    assert phases.PhaseSlice.last is rec
    (solve,) = rec["spans"]
    names = [n for n, _, _ in rec["program_spans"]]
    assert names.count("spgpu.krylov.cg") == 1 and "spgpu.krylov.steps" in names
    assert all(solve[1] <= s <= e <= solve[2] for _, s, e in rec["program_spans"])
    assert set(rec) == {"device_ops", "spans", "t0", "t1", "program_spans"}


def test_counter_readers(monkeypatch):
    masked = load_module(os.path.join(LAYER, "masked_steps_per_solve.py"))
    pool = load_module(os.path.join(LAYER, "pool_mallocs_per_solve.py"))
    for name, value in (("SOLVES", 4), ("MASKED_STEPS", 28), ("POOL_MALLOCS", 21)):
        monkeypatch.setattr(LOOP, name, value)
    rec = {"iterations": [50] * 10, "solve_s": [0.04] * 7, "slice": {}}
    assert masked.read(rec) == pytest.approx(7.0)
    assert pool.read(rec) == pytest.approx(7.0)  # three solves in the slice
    assert pool.read({k: v for k, v in rec.items() if k != "slice"}) is None
    assert pool.read(dict(rec, solve_s=[0.04] * 10)) is None
    monkeypatch.setattr(LOOP, "SOLVES", 0)
    assert masked.read(rec) is None
    # a program without the counters (the parent's) gives nothing and raises nothing
    monkeypatch.setitem(sys.modules, "spgpu_tpu_torch.solvers.cg",
                        types.ModuleType("spgpu_tpu_torch.solvers.cg"))
    assert masked.read(rec) is None and pool.read(rec) is None
