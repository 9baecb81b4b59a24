"""The 95th percentile of a solve's wall time over the window's solves
outside the traced slice; None below 200 of them."""

from portbench.stats import solve_p95_ms


def read(rec: dict):
    return solve_p95_ms(rec)
