"""The reference against dense algebra at a tiny size."""

import numpy as np
import pytest
import torch

from portbench.reference import krylov
from portbench.reference.spmv import CsrMatrix


def _system(n=40, seed=3, symmetric=True):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.15)
    a = a + a.T if symmetric else a
    a += np.diag(np.abs(a).sum(1) + 1.0)
    rows, cols = np.nonzero(a)
    return a, rows.astype(np.int64), cols.astype(np.int64), a[rows, cols]


def test_product_is_the_dense_product():
    a, rows, cols, vals = _system(symmetric=False)
    csr = CsrMatrix(rows, cols, vals, a.shape[0], "cpu", torch.float64)
    x = np.random.default_rng(0).standard_normal((a.shape[0], 3))
    assert np.allclose(csr(torch.from_numpy(x[:, 0])).numpy(), a @ x[:, 0], rtol=1e-14)
    assert np.allclose(csr(torch.from_numpy(x)).numpy(), a @ x, rtol=1e-14)
    with pytest.raises(ValueError):
        CsrMatrix(rows[::-1].copy(), cols, vals, a.shape[0], "cpu", torch.float64)


@pytest.mark.parametrize("name,symmetric", [("cg", True), ("bicgstab", False)])
def test_loops_solve(name, symmetric):
    a, rows, cols, vals = _system(symmetric=symmetric)
    csr = CsrMatrix(rows, cols, vals, a.shape[0], "cpu", torch.float64)
    b = torch.from_numpy(a @ np.linspace(-1, 1, a.shape[0]))
    x, k, rnorm = getattr(krylov, name)(csr, b, 1e-12, 500)
    assert rnorm <= 1e-12 * float(torch.linalg.vector_norm(b)) and 0 < k < 500
    assert np.allclose(x.numpy(), np.linalg.solve(a, b.numpy()), rtol=1e-9, atol=1e-10)
    x2, k2, _ = getattr(krylov, name)(csr, b, 0.0, 3)
    assert k2 == 3
