"""The caching allocator's ``cudaMalloc`` calls a solve makes while its
Krylov loop captures a CUDA graph into a new private pool
(``solvers/cg.py``'s ``POOL_MALLOCS``, which counts only while a profiler
records), over the solves of the traced slice: in a run, the only solves
made under a profiler.  Read from the loop's ``counters()`` when the run
ends; nothing where the program has no such counter or the run no
slice."""

import sys


def read(rec: dict):
    counters = getattr(sys.modules.get("spgpu_tpu_torch.solvers.cg"), "counters", None)
    solves = len(rec.get("iterations") or []) - len(rec.get("solve_s") or [])
    if not counters or "slice" not in rec or solves <= 0:
        return None
    return counters()["POOL_MALLOCS"] / solves
