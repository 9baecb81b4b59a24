"""Steps a solve runs past its last iteration (``solvers/cg.py``: the
replay queued behind the one whose flag ends the loop, and the rest of the
replay in which the loop ends), the mean over every solve of the run, the
warm-up's included: the loop's ``MASKED_STEPS`` over its ``SOLVES``, read
from its ``counters()`` when the run ends.  Nothing where the program has
no such counters."""

import sys


def read(rec: dict):
    counters = getattr(sys.modules.get("spgpu_tpu_torch.solvers.cg"), "counters", None)
    c = counters() if counters else None
    return c["MASKED_STEPS"] / c["SOLVES"] if c and c["SOLVES"] else None
