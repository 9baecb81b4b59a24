"""Closed loop of solves, one caller, as HPCG's timed phase and a PSBLAS
solver loop run: back-to-back solves of the program's entry (its Krylov
loop over its op), each on the next right-hand side of a pool made in
set-up, each waited for before the next starts.

Traffic keys: ``solver`` ("cg" or "bicgstab"), ``tol`` and ``maxiter``
(tol 0 runs exactly ``maxiter`` iterations), ``pool`` (right-hand sides
``b = A·x*``, ``x*`` uniform in [-1, 1) from the seed, or from
``pool_seed`` where the traffic fixes the pool, so that every seed solves
the same systems; with ``pool_first_ones`` the first ``x*`` is all ones,
as HPCG's own ``b``; the seed orders the pool),
``samples`` (answers compared with the reference, drawn from the seed),
``slice_s`` (the traced slice's length) and ``probe_products`` (products
timed back to back in a traced run's set-up)."""

from __future__ import annotations

import statistics
import sys
import time

import torch

from portbench import stats, trace
from portbench.harness import Context, relative_gap, worst
from portbench.reference import krylov

__all__ = ["run"]


def run(ctx: Context) -> dict:
    t, m, dev = ctx.cell.traffic, ctx.matrix, ctx.device
    dtype = getattr(torch, m.dtype)
    gen = ctx.generator(t.get("pool_seed"))
    xs = torch.rand((t["pool"], m.n), generator=gen, device=dev, dtype=dtype)
    xs.mul_(2).sub_(1)
    if t.get("pool_first_ones"):
        xs[0] = 1
    bs = m.reference(dev)(xs.T.contiguous()).T.contiguous()
    ctx.inputs_made()
    rng = ctx.sampler()
    order = list(range(t["pool"]))
    rng.shuffle(order)

    def solve(b):
        return ctx.program.solve(b, t["solver"], t["tol"], t["maxiter"])

    solve(bs[order[-1]])  # loads every kernel and library the loop reaches
    record = {}
    if ctx.trace:
        trace.warm()
        v = ctx.program.into(xs[0])
        record["probe"] = trace.probe(lambda: ctx.program.product(v), t["probe_products"])
        del v

    # the loop's own counter of host ms spent capturing graphs
    loop = sys.modules.get("spgpu_tpu_torch.solvers.cg")

    def capture_ms():
        return getattr(loop, "CAPTURE_MS", 0.0)

    kept = []  # (pool index, x): a reservoir of answers drawn from the seed
    times, iters, unconverged, outside, captures = [], [], 0, [], []
    sl = trace.Slice() if ctx.trace else None
    slice_at, slice_end, slice_iters = 0.3 * ctx.seconds, None, 0
    t0 = ctx.window_opens()
    while True:
        i = len(times)
        s0 = time.perf_counter()
        if sl is not None and slice_end is None and s0 - t0 >= slice_at:
            sl.start()
            slice_end = time.perf_counter() + t["slice_s"]
            s0 = time.perf_counter()
        c0 = capture_ms()
        with trace.span("solve", sl is not None and sl.running):
            x, k, converged, rnorm = solve(bs[order[i % t["pool"]]])
        s1 = time.perf_counter()
        times.append(s1 - s0)
        if sl is None or not sl.running:
            outside.append(s1 - s0)
            captures.append(capture_ms() - c0)
        iters.append(k)
        unconverged += t["tol"] > 0 and not converged
        if len(kept) < t["samples"]:
            kept.append((order[i % t["pool"]], x, rnorm))
        else:
            j = rng.randrange(i + 1)
            if j < t["samples"]:
                kept[j] = (order[i % t["pool"]], x, rnorm)
        if sl is not None and sl.running:
            slice_iters += k
            if s1 >= slice_end:
                sl.stop()
        if s1 - t0 >= ctx.seconds:
            break
    window_s = s1 - t0
    if sl is not None and sl.running:
        sl.stop()
    ctx.window_closed()

    record.update(iterations=iters, slice_iterations=slice_iters, solve_s=outside,
                  capture_ms=captures)
    rec = sl.record() if sl is not None else None
    if rec is not None:  # None where the window ended before the slice began
        record.update(slice=rec, **trace.summarize(rec))
    ctx.release_program()

    ref = m.reference(dev)
    solver = getattr(krylov, t["solver"])
    want = {p: solver(ref, bs[p], t["tol"], t["maxiter"])[0]
            for p in sorted({p for p, _, _ in kept})}
    x_gap = worst(relative_gap(x, want[p]) for p, x, _ in kept)
    # the true residual of each answer, and how far the residual the loop
    # reported lies from it
    residual, drift = [], []
    for p, x, rnorm in kept:
        bnorm = float(torch.linalg.vector_norm(bs[p]))
        true = float(torch.linalg.vector_norm(bs[p] - ref(x.to(dtype))))
        residual.append(true / bnorm)
        drift.append(abs(true - rnorm) / bnorm)
    e2e = {"solve_ms": 1e3 / stats.rate(len(times), window_s)}
    return {"attempted": len(times), "failed": unconverged, "e2e": e2e,
            "numbers": {"x_gap": x_gap, "residual": worst(residual),
                        "residual_drift": worst(drift)},
            "record": record,
            "info": {"solves": len(times), "window_s": window_s,
                     "ms_quantiles": [1e3 * q for q in statistics.quantiles(
                         times, n=10, method="inclusive")] if len(times) > 1 else None,
                     "ms_max": 1e3 * max(times), "iterations_mean": statistics.fmean(iters),
                     **ctx.window_diag}}
