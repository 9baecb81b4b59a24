"""Device microseconds a Krylov iteration spends outside the products
(``solvers/cg.py`` and ``ops/blas1.py``: the vector passes, reductions and
masked writes), from the traced slice: ``trace.vector_us_per_iter``."""

from portbench.trace import vector_us_per_iter


def read(rec: dict):
    return vector_us_per_iter(rec)
