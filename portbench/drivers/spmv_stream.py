"""spGPU's own product benchmark (``hellPerf``/``diaPerf``): products
``y = A·x`` of the program's op back to back, x alternating between two
vectors from the seed, dispatched ahead in batches with one synchronise a
batch, until the window ends.

Traffic keys: ``batch`` (products a batch), ``samples`` (outputs compared
with the reference, drawn from the seed) and ``slice_s`` (the traced
slice's length, whole batches)."""

from __future__ import annotations

import time

import torch

from portbench import stats, trace
from portbench.harness import Context, relative_gap, worst

__all__ = ["run"]


def run(ctx: Context) -> dict:
    t, m, dev = ctx.cell.traffic, ctx.matrix, ctx.device
    dtype = getattr(torch, m.dtype)
    xs = torch.rand((2, m.n), generator=ctx.generator(), device=dev, dtype=dtype)
    xs.mul_(2).sub_(1)
    ctx.inputs_made()
    prog = ctx.program
    xl = [prog.into(xs[0]), prog.into(xs[1])]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for j in range(t["batch"]):  # loads the kernel; the batch's shapes
        prog.product(xl[j % 2])
    sync()
    if ctx.trace:
        trace.warm()

    rng = ctx.sampler()
    kept = []  # (which x, y): a reservoir of outputs drawn from the seed
    products, call_ns, calls = 0, 0, 0
    sl = trace.Slice() if ctx.trace else None
    slice_at, slice_end, slice_products = 0.3 * ctx.seconds, None, 0
    t0 = ctx.window_opens()
    while True:
        if sl is not None and slice_end is None and time.perf_counter() - t0 >= slice_at:
            sl.start()
            slice_end = time.perf_counter() + t["slice_s"]
        tracing = sl is not None and sl.running
        with trace.span("batch", tracing):
            for _ in range(t["batch"]):
                c0 = time.perf_counter_ns()
                y = prog.product(xl[products % 2])
                c1 = time.perf_counter_ns()
                if not tracing:
                    call_ns += c1 - c0
                    calls += 1
                if len(kept) < t["samples"]:
                    kept.append((products % 2, y))
                else:
                    j = rng.randrange(products + 1)
                    if j < t["samples"]:
                        kept[j] = (products % 2, y)
                products += 1
        with trace.span("synchronise", tracing):
            sync()
        s1 = time.perf_counter()
        if tracing:
            slice_products += t["batch"]
            if s1 >= slice_end:
                sl.stop()
        if s1 - t0 >= ctx.seconds:
            break
    window_s = s1 - t0
    if sl is not None and sl.running:
        sl.stop()
    ctx.window_closed()

    record = {"call_us": 1e-3 * call_ns / calls if calls else None}
    rec = sl.record() if sl is not None else None
    if rec is not None:  # None where the window ended before the slice began
        record.update(slice=rec, slice_products=slice_products, **trace.summarize(rec))
        # the products' device time from the slice itself: back to back
        per_call = stats.per_call(((n, b - a) for n, a, b in rec["device_ops"]),
                                  slice_products) if slice_products else None
        record["probe"] = None if per_call is None else {"per_call_s": per_call}
    outs = [(w, prog.out(y)) for w, y in kept]
    del kept, y, prog, xl
    ctx.release_program()

    ref = m.reference(dev)
    want = [ref(xs[0]), ref(xs[1])]
    y_gap = worst(relative_gap(y, want[w]) for w, y in outs)
    return {"attempted": products, "failed": 0,
            "e2e": {"spmv_gflops": 1e-9 * stats.rate(2.0 * m.nnz * products, window_s)},
            "numbers": {"y_gap": y_gap}, "record": record,
            "info": {"products": products, "window_s": window_s, **ctx.window_diag}}
