"""Closed loop of distributed solves, one caller a rank, as HPCG's timed
phase runs on several processes: each rank holds the configuration's
block, stacked along the traffic's ``stack`` axis (weak scaling), and
every rank runs each solve together through the port's
``parallel.DistSolveHandle`` over its packed row partition, so the port's
contiguous row split gives each rank its block.  Rank 0 decides when the
window ends (one broadcast a solve) and compares the answers.

Traffic keys: ``ranks`` (true: one process a chip), ``stack`` (the
configuration's size that grows with the ranks), ``tol``, ``maxiter``,
``pool``, ``pool_first_ones``, ``samples`` and ``slice_s`` as for
``solve_loop``; a traced run profiles rank 0's slice."""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from portbench import stats, trace
from portbench.harness import Context, relative_gap, worst
from portbench.reference import krylov

__all__ = ["build_program", "params", "run"]


def params(cell, base: dict, rg) -> dict:
    """The global sizes: the block's, ``stack`` times the ranks."""
    out = dict(base)
    out[cell.traffic["stack"]] = int(base[cell.traffic["stack"]]) * rg.size
    return out


class DistProgram:
    """This rank's shard of the packed row partition, placed once."""

    fmt = "packed row partition"

    def __init__(self, coo, rg):
        from spgpu_tpu_torch.parallel import DistSolveHandle, partition_coo_rows_packed

        self.handle = DistSolveHandle(partition_coo_rows_packed(coo, rg.size), rg)

    def solve(self, b, solver: str, tol: float, maxiter: int):
        """``(x, iterations, converged, residual norm)`` of one solve of the
        global host ``b`` (``solver`` "cg" or "bicgstab"); ``x`` is the
        global answer, on every rank."""
        res = self.handle.solve(b, symmetric=solver == "cg", tol=tol, maxiter=maxiter)
        return res.x, res.iterations, bool(res.converged), float(res.residual_norm)


def build_program(cell, matrix, device, rg) -> DistProgram:
    return DistProgram(matrix.coo(), rg)


def run(ctx: Context) -> dict:
    t, m, dev, rg = ctx.cell.traffic, ctx.matrix, ctx.device, ctx.rg
    dtype = getattr(torch, m.dtype)
    xs = torch.rand((t["pool"], m.n), generator=ctx.generator(), device=dev, dtype=dtype)
    xs.mul_(2).sub_(1)
    if t.get("pool_first_ones"):
        xs[0] = 1
    bs = m.reference(dev)(xs.T.contiguous()).T.contiguous()
    bs_host = bs.cpu().numpy()
    ctx.inputs_made()
    first = rg.rank == 0

    def solve(i):
        return ctx.program.solve(bs_host[i % t["pool"]], "cg", t["tol"], t["maxiter"])

    solve(0)
    sl = trace.Slice() if ctx.trace and first else None
    if sl is not None:
        trace.warm()
    rng = ctx.sampler()
    kept, times, unconverged, slice_iters = [], [], 0, 0
    slice_end = None
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    t0 = ctx.window_opens()
    while True:
        i = len(times)
        s0 = time.perf_counter()
        if sl is not None and slice_end is None and s0 - t0 >= 0.3 * ctx.seconds:
            sl.start()
            slice_end = time.perf_counter() + t["slice_s"]
            s0 = time.perf_counter()
        with trace.span("solve", sl is not None and sl.running):
            x, k, converged, _ = solve(i)
        s1 = time.perf_counter()
        if sl is not None and sl.running:
            slice_iters += k
            if s1 >= slice_end:
                sl.stop()
        times.append(s1 - s0)
        unconverged += t["tol"] > 0 and not converged
        if first:
            if len(kept) < t["samples"]:
                kept.append((i % t["pool"], x))
            else:
                j = rng.randrange(i + 1)
                if j < t["samples"]:
                    kept[j] = (i % t["pool"], x)
            flag.fill_(int(s1 - t0 >= ctx.seconds))
        dist.broadcast(flag, 0, group=rg.group)
        if int(flag.item()):
            break
    window_s = s1 - t0
    if sl is not None and sl.running:
        sl.stop()
    ctx.window_closed()
    peak = torch.tensor([ctx.memory_peak_bytes], dtype=torch.float64, device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=rg.group)
    ctx.release_program()
    if not first:
        return None
    record = {"slice_iterations": slice_iters}
    rec = sl.record() if sl is not None else None
    if rec is not None:  # None where the window ended before the slice began
        record.update(slice=rec, **trace.summarize(rec))
    ref = m.reference(dev)
    want = {p: krylov.cg(ref, bs[p], t["tol"], t["maxiter"])[0]
            for p in sorted({p for p, _ in kept})}
    return {"attempted": len(times), "failed": unconverged,
            "e2e": {"solve_ms": 1e3 / stats.rate(len(times), window_s)},
            "numbers": {"x_gap": worst(relative_gap(x, want[p]) for p, x in kept)},
            "record": record, "memory_peak_bytes": int(peak.item()),
            "info": {"solves": len(times), "window_s": window_s, "ranks": rg.size}}
