"""PyTorch port: the Krylov loop's spans and counters, on the CPU.

While a profiler records, each solver call is a span
``spgpu.krylov.<solver>`` with its phases as children (on the CPU:
``setup``, ``steps``, ``release``), host-side ranges on the profiler's
clock; with no profiler no range is entered at all.  ``counters()`` gives
the loop's seven counters by name: ``SOLVES`` moves by one a call,
``MASKED_STEPS`` by the steps a solve ran past its last iteration (a
chunk of ``steps`` steps runs whole), and ``POOL_MALLOCS`` and
``CAPTURE_MS`` stay 0 where no graph is captured.  The card's form (the
eager step, the capture, the replays, the pool's allocations) is held in
``tests/test_torch_cuda.py``.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from spgpu_tpu_torch.utils import profiling  # noqa: E402

#: the loop's module (``solvers.cg`` is the function of that name)
loop = importlib.import_module("spgpu_tpu_torch.solvers.cg")

SOLVERS = ("cg", "bicgstab")


def _system(symmetric: bool):
    """A dense 40x40 float64 operator, SPD for CG, non-symmetric for
    BiCGSTAB, and ``b``."""
    rng = np.random.default_rng(7)
    m = rng.standard_normal((40, 40))
    a = m @ m.T / 40 + np.eye(40) if symmetric else m / 8 + 3 * np.eye(40)
    at = torch.from_numpy(a)
    return (lambda v: at @ v), torch.from_numpy(rng.standard_normal(40))


def _private(solver):
    return {"cg": loop._cg, "bicgstab": loop._bicgstab}[solver]


@pytest.mark.parametrize("solver", SOLVERS)
def test_cpu_spans_nest_under_the_solver(solver):
    """One span a solver call, and under it, in order, one span each of
    the set-up, the chunks of steps and the release."""
    mv, b = _system(solver == "cg")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = getattr(loop, solver)(mv, b, tol=1e-10, maxiter=200)
    assert bool(got.converged)
    spans = [e for e in prof.events() if e.name.startswith("spgpu.")]
    top = "spgpu.krylov." + solver
    phases = ["spgpu.krylov.setup", "spgpu.krylov.steps", "spgpu.krylov.release"]
    assert sorted(e.name for e in spans) == sorted([top] + phases)
    (root,) = [e for e in spans if e.name == top]
    children = sorted((e for e in spans if e is not root), key=lambda e: e.time_range.start)
    assert [e.name for e in children] == phases
    for e in children:
        assert e.cpu_parent is not None and e.cpu_parent.name == top
        assert root.time_range.start <= e.time_range.start <= e.time_range.end \
            <= root.time_range.end
    assert all(a.time_range.end <= b.time_range.start for a, b in zip(children, children[1:]))


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    """Off, a span is the shared no-op: neither the fast range nor
    ``record_function`` is entered by any solver call; under a profiler
    the same calls enter four ranges each."""
    entered = []

    class Counting:
        def __init__(self, name, *args, **kw):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiling, "_RANGE", Counting)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    assert profiling.span("spgpu.krylov.cg") is profiling._OFF
    for solver in SOLVERS:
        mv, b = _system(solver == "cg")
        getattr(loop, solver)(mv, b, tol=1e-10, maxiter=200)
        _private(solver)(mv, b, tol=1e-10, maxiter=200, steps=3)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        for solver in SOLVERS:
            mv, b = _system(solver == "cg")
            getattr(loop, solver)(mv, b, tol=1e-10, maxiter=200)
    assert len(entered) == 8 and entered[:4] == [
        "spgpu.krylov.cg", "spgpu.krylov.setup", "spgpu.krylov.steps", "spgpu.krylov.release"]


def test_counters_by_name():
    got = loop.counters()
    assert tuple(got) == loop.COUNTERS
    assert set(got) == {"SOLVES", "STEPS", "MASKED_STEPS", "HOST_READS", "REPLAYS",
                        "CAPTURE_MS", "POOL_MALLOCS"}
    assert all(got[name] == getattr(loop, name) for name in got)


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("maxiter,steps,masked", [(10, 4, 2), (8, 4, 4), (7, 1, 1),
                                                  (9, 3, 3), (0, 4, 4)])
def test_masked_steps_by_hand(solver, maxiter, steps, masked):
    """tol 0 runs exactly ``maxiter`` iterations; the chunks of ``steps``
    then run until the first that holds the inactive step ``maxiter + 1``:
    ``steps·ceil((maxiter + 1) / steps)`` steps, ``masked`` of them past
    the last iteration.  One solve; no capture and no pool on the CPU."""
    mv, b = _system(solver == "cg")
    before = loop.counters()
    got = _private(solver)(mv, b, tol=0.0, maxiter=maxiter, steps=steps)
    moved = {k: v - before[k] for k, v in loop.counters().items()}
    assert got.iterations == maxiter
    assert moved["SOLVES"] == 1
    assert moved["STEPS"] == maxiter + masked == steps * -(-(maxiter + 1) // steps)
    assert moved["MASKED_STEPS"] == masked
    assert moved["POOL_MALLOCS"] == 0 and moved["CAPTURE_MS"] == 0.0


def test_converged_solves_count_their_one_masked_step():
    """A solve that ends at once (``b = 0``) runs one inactive step; the
    eager witnesses are not solver calls and count nothing."""
    mv, b = _system(True)
    before = loop.counters()
    got = loop.cg(mv, torch.zeros_like(b), tol=1e-10, maxiter=50)
    loop._cg_eager(mv, b, tol=1e-10, maxiter=50)
    moved = {k: v - before[k] for k, v in loop.counters().items()}
    assert got.iterations == 0
    assert (moved["SOLVES"], moved["STEPS"], moved["MASKED_STEPS"]) == (1, 1, 1)
