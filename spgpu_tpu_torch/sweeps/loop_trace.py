"""Where a graphed CG step's time goes on the card: the replays of the
Krylov loop's CUDA graph (:mod:`spgpu_tpu_torch.solvers.cg`, ``GRAPH_STEPS``
steps a replay) as the profiler sees them, on the pcell layout of the SPD
flagship (the system of ``chip_smoke.py``'s ``solve(fmt="pcell")``
phases) in float64 or fp32.

Per step, the median over the replays of one profiled run: the device
operations by name and count, their device time, the gaps inside a
replay (between its operations: what the graph's nodes cost beyond
their own time) and the gap before it (the host's read of the last
replay's flag and its launch of this one).  Beside it, the host clock of
whole solves, with their capture and without it.

    python -m spgpu_tpu_torch.sweeps.loop_trace [--dtype float64|float32]
        [--reps 5] [--steps 64]

Also runs as a file (``python .../sweeps/loop_trace.py``) against another
checkout's package on ``PYTHONPATH``.  Card only.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import time

import numpy as np
import torch

from spgpu_tpu_torch.sweeps import _common as c

__all__ = ["FLAGSHIP_ROWS", "main", "replay_windows", "run"]

#: rows of the flagship (``chip_smoke.py``'s, the JAX benchmark's)
FLAGSHIP_ROWS = 262144

#: the device operation behind each replay: the copy of its flag to the
#: host
_READ = "Memcpy DtoH"


def replay_windows(events, steps: int) -> dict:
    """Per step, the median over replays of one run's device ``events``
    (``(name, start_us, end_us)``, any order): the operations by name
    (count and µs), their µs, the gaps inside a replay and the gap before
    it.  A replay is the operations after one flag copy (:data:`_READ`) up
    to and with the next; the first window (the eager step and its read)
    is left out, and so is any window whose operation count is not the
    most common one (a read before the loop, or events the session
    lost)."""
    events = sorted(events, key=lambda e: e[1])
    windows, cur = [], []
    for e in events:
        cur.append(e)
        if e[0].startswith(_READ):
            windows.append(cur)
            cur = []
    out = []
    for prev, win in zip(windows, windows[1:]):
        busy, end, gaps = 0.0, win[0][1], 0.0
        by_name: dict = {}
        for name, t0, t1 in win:
            gaps += max(0.0, t0 - end)
            busy += t1 - max(t0, end) if t1 > end else 0.0
            end = max(end, t1)
            n, us = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, us + t1 - t0)
        out.append(dict(ops=len(win), busy_us=busy, inner_gap_us=gaps,
                        gap_before_us=win[0][1] - prev[-1][2], by_name=by_name))
    if not out:
        return dict(replays=0)
    common = statistics.mode(w["ops"] for w in out)
    out = [w for w in out if w["ops"] == common]
    med = lambda key: statistics.median(w[key] for w in out) / steps  # noqa: E731
    names = sorted({n for w in out for n in w["by_name"]})
    return dict(replays=len(out), ops_per_step=med("ops"), busy_us_per_step=med("busy_us"),
                inner_gap_us_per_step=med("inner_gap_us"),
                gap_before_us_per_step=med("gap_before_us"),
                by_name_per_step={n: dict(
                    count=statistics.median(w["by_name"].get(n, (0, 0))[0] for w in out)
                    / steps,
                    us=statistics.median(w["by_name"].get(n, (0, 0.0))[1] for w in out)
                    / steps) for n in names})


def _device_events(prof) -> list:
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
            out.append((name.split("(")[0].split("<")[0].split("::")[-1].strip(),
                        float(e.time_range.start), float(e.time_range.end)))
    return out


def run(device="cuda", *, dtype: str = "float64", reps: int = 5, steps: int = 64,
        size: int = FLAGSHIP_ROWS) -> dict:
    """The trace of ``dtype``'s pcell CG on the SPD flagship: ``reps``
    solves to the phase's tolerance (1e-10 float64, 1e-5 fp32) on the host
    clock, then ``steps`` iterations (tol 0) under the profiler."""
    dev = c.sweep_device(device)
    if dev.type != "cuda":
        raise ValueError("the loop trace profiles CUDA-graph replays: it runs on a card")
    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.convert import coo_to_whell_percell
    from spgpu_tpu_torch.utils.fixtures import random_fem_like, spd_from

    loop = importlib.import_module("spgpu_tpu_torch.solvers.cg")  # the module

    dt = np.dtype(dtype).type
    spd = spd_from(random_fem_like(size, 27.0, span=768, far_frac=0.01, seed=0,
                                   dtype=dt), dt)
    t0 = time.perf_counter()
    p = coo_to_whell_percell(spd, device=dev)
    convert_s = time.perf_counter() - t0
    b = torch.from_numpy(spd.spmv(np.random.default_rng(1).standard_normal(spd.n_cols))
                         .astype(dt)).to(dev)
    tol = 1e-10 if dt is np.float64 else 1e-5

    def mv(v):
        return ops.whell_spmv(p, v)

    loop.cg(mv, b, tol=tol, maxiter=5000)  # loads every kernel
    solves = []
    for _ in range(reps):
        loop.CAPTURE_MS = 0.0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        r = loop.cg(mv, b, tol=tol, maxiter=5000)
        torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0)
        solves.append(dict(iterations=r.iterations, solve_ms=ms, capture_ms=loop.CAPTURE_MS,
                           ms_per_iter=ms / r.iterations,
                           ms_per_iter_past_capture=(ms - loop.CAPTURE_MS) / r.iterations))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loop.cg(mv, b, tol=0.0, maxiter=steps)
        torch.cuda.synchronize(dev)
    return dict(sweep="loop_trace", dtype=dtype, **c.card(dev), rows=spd.n_rows,
                nnz=spd.nnz, tiles=p.num_tiles, convert_s=convert_s,
                graph_steps=loop.GRAPH_STEPS, solves=solves,
                median_ms_per_iter=statistics.median(s["ms_per_iter"] for s in solves),
                median_ms_per_iter_past_capture=statistics.median(
                    s["ms_per_iter_past_capture"] for s in solves),
                profiled=replay_windows(_device_events(prof), loop.GRAPH_STEPS))


def main() -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("float64", "float32"), default="float64")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--steps", type=int, default=64)
    res = run("cuda", **vars(ap.parse_args()))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
