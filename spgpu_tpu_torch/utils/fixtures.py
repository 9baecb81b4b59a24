"""Test and benchmark matrix generators (host NumPy).

Copies of the generators in :mod:`spgpu_tpu.utils.fixtures`: the same
``np.random.default_rng(seed)`` draws in the same order, so both packages
see byte-identical matrices for the same arguments.
"""

from __future__ import annotations

import numpy as np

from spgpu_tpu_torch.core import unique_sorted
from spgpu_tpu_torch.formats.coo import CooMatrix

__all__ = [
    "laplacian_2d",
    "laplacian_3d",
    "random_irregular",
    "random_fem_like",
    "random_banded",
    "ctest_fixture",
]


def laplacian_2d(nx: int, ny: int, dtype=np.float64) -> CooMatrix:
    """2-D 5-point Laplacian on an nx×ny grid (SPD)."""
    n = nx * ny
    idx = np.arange(n, dtype=np.int64)
    ix, iy = idx % nx, idx // nx
    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 4.0)]
    for (dx, dy) in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        jx, jy = ix + dx, iy + dy
        ok = (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
        rows.append(idx[ok])
        cols.append((jy * nx + jx)[ok])
        vals.append(np.full(ok.sum(), -1.0))
    return CooMatrix(
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals).astype(dtype),
        n,
        n,
    )


def laplacian_3d(nx: int, ny: int, nz: int, dtype=np.float64) -> CooMatrix:
    """3-D 7-point Laplacian (SPD)."""
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)
    rows, cols, vals = [idx], [idx], [np.full(n, 6.0)]
    for (dx, dy, dz) in (
        (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)
    ):
        jx, jy, jz = ix + dx, iy + dy, iz + dz
        ok = (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny) & (jz >= 0) & (jz < nz)
        rows.append(idx[ok])
        cols.append((jz * nx * ny + jy * nx + jx)[ok])
        vals.append(np.full(int(ok.sum()), -1.0))
    return CooMatrix(
        np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals).astype(dtype), n, n,
    )


def random_irregular(
    n_rows: int,
    n_cols: int,
    avg_nnz_per_row: float = 16.0,
    alpha: float = 1.8,
    seed: int = 0,
    dtype=np.float64,
) -> CooMatrix:
    """Power-law row-degree matrix with uniformly random distinct columns
    per row; row lengths are Zipf-like with exponent ``alpha``, scaled to
    the requested average."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(alpha, size=n_rows) + 1.0
    lens = np.maximum(1, (raw * (avg_nnz_per_row / raw.mean())).astype(np.int64))
    lens = np.minimum(lens, n_cols)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), lens)
    cols = rng.integers(0, n_cols, size=rows.size, dtype=np.int64)
    key = rows * n_cols + cols
    uniq = unique_sorted(key)  # drops duplicate coordinates
    rows, cols = uniq // n_cols, uniq % n_cols
    vals = rng.standard_normal(rows.size)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        vals = vals + 1j * rng.standard_normal(rows.size)
    return CooMatrix(rows, cols, vals.astype(dtype), n_rows, n_cols)


def random_fem_like(
    n: int,
    avg_nnz_per_row: float = 27.0,
    span: int = 2048,
    far_frac: float = 0.05,
    hub_cols: int = 64,
    alpha: float = 1.8,
    seed: int = 0,
    dtype=np.float64,
) -> CooMatrix:
    """Irregular-degree matrix with column locality: most couplings lie
    within ``span`` of the diagonal; a ``far_frac`` share targets one
    contiguous block of ``hub_cols`` shared columns (constraint blocks,
    Lagrange multipliers)."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(alpha, size=n) + 1.0
    lens = np.maximum(1, (raw * (avg_nnz_per_row / raw.mean())).astype(np.int64))
    lens = np.minimum(lens, n)
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    m = rows.size
    local = rng.integers(-span, span + 1, size=m) + rows
    nh = max(min(hub_cols, n), 1)
    hub0 = int(rng.integers(0, max(n - nh, 1)))
    far = hub0 + rng.integers(0, nh, size=m)
    is_far = rng.random(m) < far_frac
    cols = np.where(is_far, far, np.clip(local, 0, n - 1))
    key = rows * n + cols
    uniq = unique_sorted(key)
    rows, cols = uniq // n, uniq % n
    vals = rng.standard_normal(rows.size)
    return CooMatrix(rows, cols, vals.astype(dtype), n, n)


def random_banded(
    n: int,
    bands: int = 9,
    wander: int = 0,
    seed: int = 0,
    dtype=np.float64,
) -> CooMatrix:
    """Banded matrix with ``bands`` diagonals; ``wander > 0`` shifts the
    band per 128-row block."""
    rng = np.random.default_rng(seed)
    half = bands // 2
    offsets = np.arange(-half, bands - half, dtype=np.int64)
    rows_l, cols_l, vals_l = [], [], []
    idx = np.arange(n, dtype=np.int64)
    if wander:
        shift = ((idx // 128) * wander) % max(n // 4, 1)
    else:
        shift = np.zeros(n, dtype=np.int64)
    for off in offsets:
        c = idx + off + shift
        ok = (c >= 0) & (c < n)
        rows_l.append(idx[ok])
        cols_l.append(c[ok])
        v = rng.standard_normal(int(ok.sum()))
        if off == 0:
            v = v + bands + 1.0  # diagonal dominance
        vals_l.append(v)
    return CooMatrix(
        np.concatenate(rows_l),
        np.concatenate(cols_l),
        np.concatenate(vals_l).astype(dtype),
        n,
        n,
    )


def ctest_fixture(dtype=np.float32) -> CooMatrix:
    """spGPU's smoke-test fixture: 100×100, 200 nnz with ``rows[i] =
    cols[i] = i % 100`` — every diagonal entry appears twice."""
    i = np.arange(200, dtype=np.int64)
    return CooMatrix(i % 100, i % 100, np.ones(200, dtype=dtype), 100, 100)
