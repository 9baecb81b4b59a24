"""PyTorch port: solve(), CG and BiCGSTAB against the JAX package.

The same systems go through ``spgpu_tpu.solvers.solve`` (Pallas kernel
in interpret mode on the CPU) and ``spgpu_tpu_torch.solvers.solve``
(plain PyTorch on the CPU); both must converge, agree on x, and meet the
host float64 residual.  Both iterate in float32, so x agrees to the
solver tolerance times the (small) condition number, and iteration
counts may differ by rounding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.solvers import solve as j_solve  # noqa: E402
from spgpu_tpu.utils.fixtures import laplacian_2d as j_lap  # noqa: E402
from spgpu_tpu.utils.fixtures import random_banded as j_banded  # noqa: E402
from spgpu_tpu.utils.fixtures import random_fem_like as j_fem  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.kernels import whell as kw  # noqa: E402
from spgpu_tpu_torch.solvers import bicgstab, cg, jacobi_preconditioner, solve  # noqa: E402
from spgpu_tpu_torch.utils.fixtures import laplacian_2d  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)


def spd_fem_1500():
    """The SPD FEM-like system of tests/test_solvers.py (whell-forced)."""
    coo0 = j_fem(1500, 10.0, span=120, far_frac=0.0, seed=12, dtype=np.float32)
    d = coo0.to_dense()
    d = (d + d.T) / 2 + np.eye(1500) * (np.abs(d).sum(1).max() + 1)
    rows, cols = np.nonzero(d)
    return rows, cols, d[rows, cols].astype(np.float32), 1500


def lap_30x20():
    c = j_lap(30, 20, np.float32)
    return c.rows, c.cols, c.values, c.n_rows


def banded_700():
    c = j_banded(700, bands=5, wander=0, seed=3, dtype=np.float32)
    return c.rows, c.cols, c.values, c.n_rows


SYSTEMS = {"fem_spd": spd_fem_1500, "laplace": lap_30x20, "banded": banded_700}


@pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("name,symmetric", [("fem_spd", True), ("laplace", True),
                                            ("banded", False)])
def test_solve_matches_jax(name, symmetric, jacobi):
    rows, cols, vals, n = SYSTEMS[name]()
    b = np.random.default_rng(11).standard_normal(n).astype(np.float32)
    kw_ = dict(fmt="whell", tol=1e-5, maxiter=3000, symmetric=symmetric,
               jacobi=jacobi)
    rj = j_solve(JCoo(rows, cols, vals, n, n), b, **kw_)
    rt = solve(CooMatrix(rows, cols, vals, n, n), b, device="cpu", **kw_)
    assert bool(rj.converged) and bool(rt.converged)
    assert abs(int(rj.iterations) - rt.iterations) <= max(3, rt.iterations // 10)
    xt = rt.x.numpy().astype(np.float64)
    xj = np.asarray(rj.x, np.float64)
    np.testing.assert_allclose(xt, xj, rtol=1e-3,
                               atol=1e-3 * np.abs(xj).max())
    a = CooMatrix(rows, cols, vals, n, n).sum_duplicates()
    assert np.linalg.norm(b - a.spmv(xt)) <= 1e-4 * np.linalg.norm(b)
    assert float(rt.residual_norm) <= 1e-5 * np.linalg.norm(b) * 1.0001


def test_solve_duplicates_are_summed():
    """solve() coalesces first: a duplicated COO solves the summed matrix."""
    rows, cols, vals, n = lap_30x20()
    dup = CooMatrix(np.r_[rows, rows], np.r_[cols, cols], np.r_[vals, vals], n, n)
    b = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    r = solve(dup, b, device="cpu", fmt="whell", tol=1e-6, maxiter=2000)
    assert bool(r.converged)
    x = r.x.numpy().astype(np.float64)
    np.testing.assert_allclose(2 * CooMatrix(rows, cols, vals, n, n).spmv(x), b,
                               atol=1e-3)


def test_auto_selection_runs_whell():
    """An irregular FEM-like SPD system auto-selects whell and solves."""
    rows, cols, vals, n = spd_fem_1500()
    coo = CooMatrix(rows, cols, vals, n, n)
    from spgpu_tpu.convert import suggest_format as j_suggest
    from spgpu_tpu_torch.convert import suggest_format

    fmt = suggest_format(coo)
    assert fmt == j_suggest(JCoo(rows, cols, vals, n, n))
    b = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    if fmt in ("whell", "ell"):
        assert bool(solve(coo, b, device="cpu", tol=1e-5).converged)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            solve(coo, b, device="cpu", tol=1e-5)


def test_unported_formats_raise():
    """The hybrid and hell routes are ported: hell solves a Laplacian as
    the JAX ``solve()`` does, and hybrid, whose split of a Laplacian is all
    band, as the whdia route does, the same bits (tests/test_torch_hybrid.py
    holds both to the JAX routes on its part-banded fixture); an unknown
    format still raises."""
    coo = laplacian_2d(40, 40, np.float32)
    b = np.random.default_rng(2).standard_normal(1600).astype(np.float32)
    _check_against_jax(coo.rows, coo.cols, coo.values, 1600, b,
                       dict(fmt="hell", tol=1e-5, maxiter=2000),
                       dict(fmt="hell", tol=1e-5, maxiter=2000))
    rh = solve(coo, b, device="cpu", fmt="hybrid", tol=1e-5)
    rw = solve(coo, b, device="cpu", fmt="whdia", tol=1e-5)
    assert bool(rh.converged) and rh.iterations == rw.iterations
    assert torch.equal(rh.x, rw.x)
    # "dia" is a selection class, not a layout: as in the JAX solve()
    for fmt in ("nope", "dia"):
        with pytest.raises(ValueError, match="unknown"):
            solve(coo, b, device="cpu", fmt=fmt)


def _spy(monkeypatch, name):
    """Count the calls solve() makes to one of its SpMV ops."""
    from spgpu_tpu_torch.solvers import auto

    calls = []
    op = getattr(auto, name)
    monkeypatch.setattr(auto, name, lambda *a, **k: calls.append(1) or op(*a, **k))
    return calls


def _check_against_jax(rows, cols, vals, n, b, jax_kw, torch_kw):
    rj = j_solve(JCoo(rows, cols, vals, n, n), b, **jax_kw)
    rt = solve(CooMatrix(rows, cols, vals, n, n), b, device="cpu", **torch_kw)
    assert bool(rj.converged) and bool(rt.converged)
    xt = rt.x.numpy().astype(np.float64)
    xj = np.asarray(rj.x, np.float64)
    np.testing.assert_allclose(xt, xj, rtol=1e-4, atol=1e-4 * np.abs(xj).max())
    a = CooMatrix(rows, cols, vals, n, n).sum_duplicates()
    assert np.linalg.norm(b - a.spmv(xt)) <= 1e-4 * np.linalg.norm(b)
    return rt


def test_auto_selection_picks_sdia_and_solves(monkeypatch):
    """A stencil selects the DIA class, which runs SDIA, as in JAX."""
    from spgpu_tpu.convert import suggest_format as j_suggest
    from spgpu_tpu_torch.convert import suggest_format

    c = j_lap(24, 24, np.float32)
    assert suggest_format(CooMatrix(c.rows, c.cols, c.values, 576, 576)) == "dia"
    assert j_suggest(c) == "dia"
    calls = _spy(monkeypatch, "sdia_spmv")
    b = np.random.default_rng(4).standard_normal(576).astype(np.float32)
    rt = _check_against_jax(c.rows, c.cols, c.values, 576, b,
                            dict(tol=1e-6, maxiter=2000),
                            dict(tol=1e-6, maxiter=2000))
    assert len(calls) >= rt.iterations > 0


@pytest.mark.parametrize("fmt", ["sdia", "whdia"])
@pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
def test_solve_dia_class_matches_jax(fmt, jacobi, monkeypatch):
    rows, cols, vals, n = lap_30x20()
    calls = _spy(monkeypatch, f"{fmt}_spmv")
    b = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    kw_ = dict(fmt=fmt, tol=1e-6, maxiter=2000, jacobi=jacobi)
    rt = _check_against_jax(rows, cols, vals, n, b, kw_, kw_)
    assert len(calls) >= rt.iterations > 0


def test_bicgstab_on_whdia_matches_jax(monkeypatch):
    """A non-symmetric contiguous band (WHDIA pattern mode).  A wandering
    band (``wander > 0``) moves the dominant entry off the diagonal and
    BiCGSTAB breaks down on it in both packages."""
    from spgpu_tpu_torch.convert import coo_to_whdia

    rows, cols, vals, n = banded_700()
    assert coo_to_whdia(CooMatrix(rows, cols, vals, n, n), device="cpu").pattern_mode
    calls = _spy(monkeypatch, "whdia_spmv")
    b = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    kw_ = dict(fmt="whdia", symmetric=False, tol=1e-6, maxiter=2000)
    rt = _check_against_jax(rows, cols, vals, n, b, kw_, kw_)
    assert len(calls) >= rt.iterations > 0


def test_solve_x0_on_the_dia_class():
    rows, cols, vals, n = lap_30x20()
    a = CooMatrix(rows, cols, vals, n, n)
    x_true = np.random.default_rng(2).standard_normal(n)
    b = a.spmv(x_true).astype(np.float32)
    for fmt in ("sdia", "whdia"):
        r = solve(a, b, device="cpu", fmt=fmt, x0=x_true.astype(np.float32),
                  tol=1e-5)
        assert r.iterations <= 1 and bool(r.converged)


@pytest.mark.parametrize("dtype,item", [(np.float16, "planned")])
def test_unported_dtypes_raise(dtype, item):
    c = laplacian_2d(8, 8, np.float64)
    coo = CooMatrix(c.rows, c.cols, c.values.astype(dtype), 64, 64)
    with pytest.raises(NotImplementedError, match=item):
        solve(coo, np.ones(64, dtype), device="cpu", fmt="whell")


def test_complex64_whell_solve_matches_jax():
    """A complex64 Hermitian positive-definite system through solve() on
    the whell route, CG against the JAX ``cg_herm_planes`` route
    (tests/test_torch_complex_solve.py covers complex in full)."""
    rng = np.random.default_rng(0)
    n = 300
    off = ((rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)) * 0.5)
    rows = np.r_[np.arange(n), np.arange(n - 1), np.arange(1, n)]
    cols = np.r_[np.arange(n), np.arange(1, n), np.arange(n - 1)]
    vals = np.r_[np.full(n, 6.0 + 0j), off, np.conj(off)].astype(np.complex64)
    b = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    kw_ = dict(fmt="whell", tol=1e-5, maxiter=500)
    rj = j_solve(JCoo(rows, cols, vals, n, n), b, **kw_)
    rt = solve(CooMatrix(rows, cols, vals, n, n), b, device="cpu", **kw_)
    assert bool(rj.converged) and bool(rt.converged)
    assert rt.x.dtype == torch.complex64
    assert abs(int(rj.iterations) - rt.iterations) <= max(1, rt.iterations // 10)
    x = rt.x.numpy().astype(np.complex128)
    a = CooMatrix(rows, cols, vals, n, n)
    assert np.linalg.norm(b - a.spmv(x)) <= 1e-4 * np.linalg.norm(b)
    np.testing.assert_allclose(x, np.asarray(rj.x), rtol=0,
                               atol=1e-4 * np.abs(x).max())


def test_cg_and_bicgstab_on_a_dense_operator():
    """The Krylov loops alone, against the JAX ones, on a dense SPD matrix."""
    import jax.numpy as jnp
    from spgpu_tpu.solvers import cg as j_cg
    from spgpu_tpu.solvers.cg import bicgstab as j_bicgstab

    rng = np.random.default_rng(9)
    m = rng.standard_normal((60, 60))
    a = (m @ m.T / 60 + np.eye(60)).astype(np.float64)
    b = rng.standard_normal(60)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    for j_fn, t_fn in ((j_cg, cg), (j_bicgstab, bicgstab)):
        rj = j_fn(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), tol=1e-12,
                  maxiter=500)
        rt = t_fn(lambda v: at @ v, bt, tol=1e-12, maxiter=500)
        assert bool(rt.converged)
        assert rt.iterations == int(rj.iterations)
        np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9,
                                   atol=1e-10)
        np.testing.assert_allclose(a @ rt.x.numpy(), b, atol=1e-9)


def test_cg_respects_maxiter_and_x0():
    a = torch.diag(torch.arange(1.0, 201.0, dtype=torch.float64))
    b = torch.ones(200, dtype=torch.float64)
    r = cg(lambda v: a @ v, b, tol=1e-14, maxiter=3)
    assert r.iterations == 3 and not bool(r.converged)
    exact = b / torch.arange(1.0, 201.0, dtype=torch.float64)
    r0 = cg(lambda v: a @ v, b, x0=exact, tol=1e-10, maxiter=10)
    assert r0.iterations == 0 and bool(r0.converged)


def test_jacobi_preconditioner_matches_jax():
    from spgpu_tpu.solvers.cg import jacobi_preconditioner as j_jacobi

    rows, cols, vals, n = banded_700()
    mj = np.asarray(j_jacobi(JCoo(rows, cols, vals, n, n)))
    mt = jacobi_preconditioner(CooMatrix(rows, cols, vals, n, n), "cpu")
    np.testing.assert_array_equal(mt.numpy(), mj)


def test_solve_counts_no_launches_on_cpu():
    rows, cols, vals, n = lap_30x20()
    before = kw.LAUNCHES
    solve(CooMatrix(rows, cols, vals, n, n), np.ones(n, np.float32),
          device="cpu", fmt="whell", tol=1e-4)
    assert kw.LAUNCHES == before
