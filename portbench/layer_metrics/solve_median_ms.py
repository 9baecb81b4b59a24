"""The median wall time of a solve (one call of the entry, to its answer
on the host) over the window's solves outside the traced slice: steadier
than the window's mean, which the slow solves move."""

from portbench.stats import solve_median_ms


def read(rec: dict):
    return solve_median_ms(rec)
