"""The route's product (the op and its kernel) against the least time the
card could take for it (``portbench/work.py``), in %, from the device
time of products run back to back in the traced run."""

from portbench.work import spmv_roofline_pct


def read(rec: dict):
    return spmv_roofline_pct(rec)
