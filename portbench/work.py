"""The work a sparse product needs, and the card's peaks: the yardstick of
every roofline share the benchmark reports.

The work is fixed by the matrix, not by the layout that computes it:
each nonzero's value read once, x read once and z written once.  Indices
are left out: the configurations are stencils, whose structure a layout
can hold implicitly (DIA stores none), so a layout that moves indices or
padding pays for them in its share.
"""

from __future__ import annotations

__all__ = ["PEAKS", "peaks_for", "spmv_bound_s", "spmv_bytes", "spmv_flops"]

#: published peaks by a substring of ``torch.cuda.get_device_name()``
#: (NVIDIA's data sheet, dense rates, at the full power limit): HBM
#: bytes/s and FLOP/s by value type (float64 on the tensor cores, float32
#: outside them).  "H100 80GB HBM3" is the SXM part (700 W).
PEAKS = {
    "H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                       "flops": {"float64": 67e12, "float32": 67e12}},
}


def peaks_for(kind: str):
    """The peaks of the card named ``kind``, or None for a card the table
    does not hold (no roofline share is then reported)."""
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    return None


def spmv_bytes(nnz: int, n_rows: int, n_cols: int, itemsize: int) -> int:
    """Bytes one product ``z = A·x`` must move: values, x once, z once."""
    return (nnz + n_rows + n_cols) * itemsize


def spmv_flops(nnz: int) -> int:
    """Operations of one product: a multiply and an add per nonzero."""
    return 2 * nnz


def spmv_bound_s(nnz: int, n_rows: int, n_cols: int, dtype: str, peaks: dict) -> float:
    """The least seconds one product in ``dtype`` ("float64", "float32")
    could take on a card with ``peaks``: the larger of its bytes over the
    HBM rate and its operations over the peak rate for its type."""
    itemsize = {"float64": 8, "float32": 4}[dtype]
    return max(spmv_bytes(nnz, n_rows, n_cols, itemsize) / peaks["bytes_per_s"],
               spmv_flops(nnz) / peaks["flops"][dtype])


def spmv_roofline_pct(rec: dict):
    """A run's product against its bound, in %: the bound over the device
    time of one product (``rec["probe"]``), or None where either is
    missing (no usable profile, or a card the table does not hold)."""
    probe, peaks = rec.get("probe"), rec.get("peaks")
    if not probe or not peaks:
        return None
    return 100.0 * spmv_bound_s(rec["nnz"], rec["n"], rec["n"], rec["dtype"], peaks) \
        / probe["per_call_s"]
