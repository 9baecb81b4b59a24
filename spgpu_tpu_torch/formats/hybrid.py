"""The hybrid banded + irregular split (HYB class) as a dataclass.

Counterpart of :class:`spgpu_tpu.formats.hybrid.HybridMatrix`: the
entries on densely occupied (hack, diagonal) slots go to a WHDIA layout
(``band``, kernels #3 and #6), the rest to a packed WHELL layout
(``rest``, kernels #1 and #4), and one product sums the two
(``cusparsePerf.cpp:668-680``, ``cusparseDcsr2hyb``).  WHDIA works in the
original numbering and packed WHELL in its lane space, so the rest part's
product crosses into lane space and back.  The JAX op crosses with a
concatenation of static slices, one per run of :func:`lane_runs` (a TPU
device: no gather); the port crosses with one index copy each way over
the rest part's ``lane_of_row``, held on the device as ``rest_lanes``.
``runs`` stays, the same tuple as the JAX layout's, and
:func:`run_embed`/:func:`run_extract` take it as the JAX functions do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["HybridMatrix", "layout_bytes", "lane_runs", "run_embed", "run_extract",
           "run_lanes"]


def layout_bytes(layout) -> int:
    """The bytes of every tensor a layout dataclass holds (its slab, its
    structure and the lists derived from them)."""
    return sum(t.numel() * t.element_size() for t in (
        getattr(layout, f.name) for f in dataclasses.fields(layout))
        if isinstance(t, torch.Tensor))


def lane_runs(lane_of_row, n_lane: int) -> Tuple[Tuple[int, int], ...]:
    """An order-preserving lane map as maximal runs ``((dst_lane0,
    length), ...)``, the source coordinates consecutive from 0: one run a
    hack for a packed layout."""
    lor = np.asarray(lane_of_row, dtype=np.int64)
    if lor.size == 0:
        return ()
    brk = np.flatnonzero(np.diff(lor) != 1)
    starts = np.r_[0, brk + 1]
    ends = np.r_[brk + 1, lor.size]
    return tuple((int(lor[s]), int(e - s)) for s, e in zip(starts, ends))


def run_lanes(runs) -> np.ndarray:
    """The lane of each original coordinate, from :func:`lane_runs`'
    runs (the ``lane_of_row`` they came from, as int64)."""
    if not runs:
        return np.zeros(0, np.int64)
    return np.concatenate([np.arange(d, d + n, dtype=np.int64) for d, n in runs])


def run_embed(runs, n_lane: int, x: torch.Tensor) -> torch.Tensor:
    """Original-space vector(s) ``(..., n)`` → lane space ``(..., n_lane)``
    (phantom lanes zero), on ``x``'s device."""
    lanes = torch.from_numpy(run_lanes(runs)).to(x.device)
    return x.new_zeros(x.shape[:-1] + (n_lane,)).index_copy_(-1, lanes, x)


def run_extract(runs, z: torch.Tensor) -> torch.Tensor:
    """Lane-space vector(s) → original space (phantom lanes dropped)."""
    return z.index_select(-1, torch.from_numpy(run_lanes(runs)).to(z.device))


@dataclasses.dataclass
class HybridMatrix:
    """``A = band + rest``: ``band`` a :class:`WhdiaMatrix` (None when no
    diagonal clears the threshold), ``rest`` a packed :class:`WhellMatrix`
    (None for a purely banded matrix).  Both take the same original-space
    ``x``; the rest part's crossing is internal."""

    band: Optional[object]  # WhdiaMatrix | None
    rest: Optional[object]  # packed WhellMatrix | None
    n_rows: int
    n_cols: int
    nnz: int
    band_nnz: int
    #: the split's occupancy threshold, in lanes of 128
    tau_lanes: int
    #: the rest part's lane map as maximal (dst_lane, length) runs
    runs: Tuple[Tuple[int, int], ...] = ()
    #: ``rest.lane_of_row`` as int64 on the rest part's device: the index
    #: of both crossings
    rest_lanes: Optional[torch.Tensor] = dataclasses.field(init=False, repr=False)

    def __post_init__(self) -> None:
        self.rest_lanes = (None if self.rest is None
                           else self.rest.lane_of_row.to(torch.int64))

    @property
    def device(self) -> torch.device:
        return (self.band if self.band is not None else self.rest).device

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self) -> torch.dtype:
        return (self.band if self.band is not None else self.rest).values.dtype

    @property
    def rest_nnz(self) -> int:
        return self.nnz - self.band_nnz

    @property
    def storage_bytes(self) -> int:
        """The two parts' bytes: every tensor each holds (:func:`layout_bytes`)."""
        return sum(layout_bytes(p) for p in (self.band, self.rest) if p is not None)

    @property
    def pad_factor(self) -> float:
        cells = sum(int(p.values.numel()) for p in (self.band, self.rest) if p is not None)
        return cells / max(self.nnz, 1)

    def to(self, device) -> "HybridMatrix":
        """A copy with both parts on ``device``."""
        return dataclasses.replace(
            self, band=None if self.band is None else self.band.to(device),
            rest=None if self.rest is None else self.rest.to(device))

    def embed_rest(self, x: torch.Tensor) -> torch.Tensor:
        """Original-space vector(s) → the rest part's lane space: one index
        copy into zeros."""
        out = x.new_zeros(x.shape[:-1] + (self.rest.n_rows,))
        return out.index_copy_(-1, self.rest_lanes, x)

    def extract_rest(self, z: torch.Tensor) -> torch.Tensor:
        """Rest-part lane-space vector(s) → original space: one gather."""
        return z.index_select(-1, self.rest_lanes)

    def to_dense(self) -> np.ndarray:
        """Host densification (testing helper), in the original numbering."""
        d = None
        for part in (self.band, self.rest):
            if part is None:
                continue
            pd = part.to_dense()
            if part is self.rest:  # lane space: back to the original numbering
                lor = part.lane_of_row.cpu().numpy()
                pd = pd[np.ix_(lor, lor)]
            d = pd if d is None else d + pd
        return d
