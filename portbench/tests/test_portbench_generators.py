"""The generators against their sources' definitions, at small sizes."""

import json
import os

import numpy as np
import pytest

from portbench.generators import hpcg, pde3d

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")


def _dense(rows, cols, vals, n):
    a = np.zeros((n, n))
    np.add.at(a, (rows, cols), vals)
    return a


def _ordered(rows, cols, n):
    key = rows * n + cols
    return bool(np.all(key[1:] > key[:-1]))  # row order, columns ascending, no duplicates


@pytest.mark.parametrize("shape", [(16, 16, 16), (5, 3, 4)])
def test_hpcg_stencil(shape):
    nx, ny, nz = shape
    rows, cols, vals, n = hpcg.generate({"nx": nx, "ny": ny, "nz": nz}, np.float64)
    assert n == nx * ny * nz
    assert rows.size == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    assert _ordered(rows, cols, n)
    a = _dense(rows, cols, vals, n)
    assert np.array_equal(a, a.T)
    assert np.all(np.diag(a) == 26.0)
    assert set(np.unique(vals)) == {-1.0, 26.0}
    # HPCG's own b = A·1: 26 less the row's off-diagonal count
    per_row = np.bincount(rows, minlength=n)
    assert np.array_equal(a @ np.ones(n), 26.0 - (per_row - 1))


def test_hpcg_config_counts():
    cfg = json.load(open(os.path.join(CONFIGS, "hpcg-128.json")))
    assert cfg["n"] == cfg["nx"] * cfg["ny"] * cfg["nz"]
    assert cfg["nnz"] == (3 * cfg["nx"] - 2) * (3 * cfg["ny"] - 2) * (3 * cfg["nz"] - 2) \
        == 55_742_968


@pytest.mark.parametrize("m", [1, 2, 6])
def test_pde3d_stencil(m):
    cfg = json.load(open(os.path.join(CONFIGS, "pde3d-hll-128.json")))
    rows, cols, vals, n = pde3d.generate(dict(cfg, idim=m), np.float64)
    assert n == m ** 3 and rows.size == 7 * n - 6 * m * m
    assert _ordered(rows, cols, n)
    h = 1.0 / (m + 1)
    a = _dense(rows, cols, vals, n)
    centre = 6 * cfg["a1"] / h ** 2
    assert np.allclose(np.diag(a), centre)
    lo, hi = -cfg["a1"] / h ** 2 - cfg["b1"] / (2 * h), -cfg["a1"] / h ** 2 + cfg["b1"] / (2 * h)
    g = lambda ix, iy, iz: ix * m * m + iy * m + iz  # noqa: E731
    for ix, iy, iz in [(0, 0, 0), (m - 1, m // 2, m - 1), (m // 2, m // 2, m // 2)]:
        r = g(ix, iy, iz)
        for d, (dx, dy, dz) in enumerate([(1, 0, 0), (0, 1, 0), (0, 0, 1)]):
            up = (ix + dx, iy + dy, iz + dz)
            down = (ix - dx, iy - dy, iz - dz)
            if max(up) < m:
                assert np.isclose(a[r, g(*up)], hi)
            if min(down) >= 0:
                assert np.isclose(a[r, g(*down)], lo)
    assert not np.allclose(a, a.T) or m == 1  # convection makes it non-symmetric


def test_pde3d_config_counts():
    cfg = json.load(open(os.path.join(CONFIGS, "pde3d-hll-128.json")))
    m = cfg["idim"]
    assert cfg["n"] == m ** 3 and cfg["nnz"] == 7 * m ** 3 - 6 * m * m == 14_581_760
