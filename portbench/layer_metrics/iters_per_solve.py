"""Iterations a solve took (the Krylov loop's ``CgResult.iterations``),
the mean over every solve of the window."""

import statistics


def read(rec: dict):
    its = rec.get("iterations")
    return statistics.fmean(its) if its else None
