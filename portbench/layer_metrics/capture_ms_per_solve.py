"""Host milliseconds a solve spends capturing the Krylov loop's CUDA graph
(``solvers/cg.py``'s ``CAPTURE_MS`` counter, read around each solve),
the mean over the window's solves outside the traced slice."""

import statistics


def read(rec: dict):
    captures = rec.get("capture_ms")
    return statistics.fmean(captures) if captures else None
