"""PyTorch port, complex64 (C) and complex128 (Z) solvers against the JAX
package.

The JAX package solves a complex system on ``[re, im]`` plane stacks
(``cg_herm_planes``, ``bicgstab_planes`` and their double-float ``_dd``
variants for Z, through ``_solve_complex``); the port runs its ``cg`` and
``bicgstab`` on one complex vector.  ``solve()`` must agree with the JAX
``solve()``: the same ``converged``, iteration counts within 10 %
(complex64) or 2 (complex128), and the true residual under
``tests/test_dd.py``'s thresholds; ``cg`` and ``bicgstab`` agree with
``cg_herm_planes`` and ``bicgstab_planes`` on one operator.  (The complex
layouts and SpMVs: ``tests/test_torch_complex.py``.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.solvers import solve as j_solve  # noqa: E402
from spgpu_tpu.utils import fixtures as jfix  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.solvers import bicgstab, cg, solve  # noqa: E402
from test_torch_complex import CDTYPES, TORCH, WHELL_CASES, _cvec, _pair, mixed  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)


def hermitian_tridiag(dtype):
    """The Hermitian positive-definite system of tests/test_dd.py
    (``test_hermitian_cg_fast_path``)."""
    rng = np.random.default_rng(0)
    n = 600
    d = np.ones(n) * 6.0
    off = (rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)) * 0.5
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([d.astype(np.complex128), off, np.conj(off)])
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return rows, cols, vals.astype(dtype), n, b.astype(dtype)


def nonhermitian_tridiag(dtype):
    """The non-Hermitian system of tests/test_dd.py
    (``test_bicgstab_complex_planes``)."""
    rng = np.random.default_rng(7)
    n = 500
    d = 5.0 + 1j * rng.standard_normal(n)
    up = (rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)) * .4
    lo = (rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)) * .4
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([d, up, lo]).astype(dtype)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return rows, cols, vals, n, b.astype(dtype)


def hermitian_laplace(dtype):
    """A 20x15 Laplacian made Hermitian positive-definite: (A + Aᴴ)/2 of
    the complex Laplacian, each diagonal entry the row's off-diagonal
    modulus sum + 1."""
    c = jfix.laplacian_2d(20, 15)
    v = mixed(c, np.complex128) / 2
    n = c.n_rows
    h = CooMatrix(np.r_[c.rows, c.cols], np.r_[c.cols, c.rows], np.r_[v, np.conj(v)],
                  n, n).sum_duplicates()
    off = h.rows != h.cols
    d = np.bincount(h.rows[off], weights=np.abs(h.values[off]), minlength=n) + 1.0
    i = np.arange(n)
    b = _cvec(n, 5)
    return (np.r_[h.rows[off], i], np.r_[h.cols[off], i],
            np.r_[h.values[off], d].astype(dtype), n, b.astype(dtype))


#: (system, fmt, symmetric, solver tol, true-residual bound), as in
#: tests/test_dd.py
SOLVES = {
    "herm_tridiag": (hermitian_tridiag, None, True,
                     {"complex64": (1e-5, 1e-4), "complex128": (1e-12, 1e-10)}),
    "nonherm_tridiag_whell": (nonhermitian_tridiag, "whell", False,
                              {"complex64": (1e-6, 2e-4),
                               "complex128": (1e-12, 1e-10)}),
    "herm_laplace_sdia": (hermitian_laplace, "sdia", True,
                          {"complex64": (1e-5, 1e-4), "complex128": (1e-10, 1e-9)}),
    "herm_laplace_whdia": (hermitian_laplace, "whdia", True,
                           {"complex64": (1e-5, 1e-4), "complex128": (1e-10, 1e-9)}),
}


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("name", sorted(SOLVES))
def test_solve_matches_jax(name, dtype):
    system, fmt, symmetric, tols = SOLVES[name]
    tol, true_tol = tols[dtype]
    rows, cols, vals, n, b = system(dtype)
    kw_ = dict(fmt=fmt, tol=tol, maxiter=800, symmetric=symmetric)
    rj = j_solve(JCoo(rows, cols, vals, n, n), b, **kw_)
    rt = solve(CooMatrix(rows, cols, vals, n, n), b, device="cpu", **kw_)
    assert bool(rj.converged) and bool(rt.converged)
    assert rt.x.dtype == TORCH[dtype]
    kj = int(rj.iterations)
    slack = 2 if dtype == "complex128" else max(1, kj // 10)
    assert abs(kj - rt.iterations) <= slack, (kj, rt.iterations)
    a = CooMatrix(rows, cols, vals, n, n).sum_duplicates()
    for x in (rt.x.numpy(), np.asarray(rj.x)):
        x = x.astype(np.complex128)
        assert np.linalg.norm(b - a.spmv(x)) <= true_tol * np.linalg.norm(b)


def test_solve_auto_selects_like_jax():
    """The tridiagonal systems select the DIA class (SDIA), the irregular
    FEM-like one WHELL, in both packages (``suggest_format`` on the
    complex COO's structure)."""
    from spgpu_tpu.convert import suggest_format as j_suggest
    from spgpu_tpu_torch.convert import suggest_format

    rows, cols, vals, n, _ = hermitian_tridiag(np.complex64)
    assert suggest_format(CooMatrix(rows, cols, vals, n, n)) == \
        j_suggest(JCoo(rows, cols, vals, n, n)) == "dia"
    jc, tc = _pair(WHELL_CASES["fem"], np.complex64)
    assert suggest_format(tc) == j_suggest(jc) == "whell"


def test_solve_complex_jacobi_raises():
    rows, cols, vals, n, b = hermitian_tridiag(np.complex64)
    with pytest.raises(NotImplementedError, match="jacobi"):
        solve(CooMatrix(rows, cols, vals, n, n), b, device="cpu", jacobi=True)


def test_solve_complex_x0_and_numbering():
    """``x0`` in the complex type, ``x`` back in the original numbering
    (WHELL iterates in lane space)."""
    rows, cols, vals, n, _ = hermitian_laplace(np.complex128)
    a = CooMatrix(rows, cols, vals, n, n)
    x_true = _cvec(n, 9)
    b = a.spmv(x_true)
    for fmt in ("whell", "sdia", "whdia"):
        r = solve(a, b, device="cpu", fmt=fmt, tol=1e-10)
        np.testing.assert_allclose(r.x.numpy(), x_true, rtol=0, atol=1e-8)
        r0 = solve(a, b, device="cpu", fmt=fmt, x0=x_true, tol=1e-10)
        assert r0.iterations <= 1 and bool(r0.converged)


def _dense_operator(hermitian):
    rng = np.random.default_rng(4)
    m = rng.standard_normal((80, 80)) + 1j * rng.standard_normal((80, 80))
    a = m @ m.conj().T / 80 + np.eye(80) if hermitian else m / 10 + 4 * np.eye(80)
    return a.astype(np.complex64), _cvec(80, 6).astype(np.complex64)


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_krylov_loops_match_plane_solvers(solver):
    """``cg`` against ``cg_herm_planes`` (Hermitian PD) and ``bicgstab``
    against ``bicgstab_planes`` (non-Hermitian) on one dense complex64
    operator: the port's complex vector against the JAX ``[re, im]``
    plane stack."""
    from spgpu_tpu.solvers.cg import bicgstab_planes, cg_herm_planes

    a, b = _dense_operator(solver == "cg")
    j_fn, t_fn = {"cg": (cg_herm_planes, cg), "bicgstab": (bicgstab_planes, bicgstab)}[solver]
    aj = jnp.asarray(a)

    def mv_planes(v):
        z = aj @ (v[0] + 1j * v[1])
        return jnp.stack([z.real, z.imag])

    rj = j_fn(mv_planes, jnp.asarray(np.stack([b.real, b.imag])), tol=1e-5,
              maxiter=300)
    at = torch.from_numpy(a)
    rt = t_fn(lambda v: at @ v, torch.from_numpy(b), tol=1e-5, maxiter=300)
    assert bool(rj.converged) and bool(rt.converged)
    kj = int(rj.iterations)
    assert abs(kj - rt.iterations) <= max(1, kj // 10), (kj, rt.iterations)
    xj = np.asarray(rj.x[0]) + 1j * np.asarray(rj.x[1])
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0, atol=1e-4 * np.abs(xj).max())
    assert np.linalg.norm(a.astype(np.complex128) @ rt.x.numpy() - b) <= \
        1e-4 * np.linalg.norm(b)


def test_bicgstab_complex_is_sesquilinear():
    """On a complex system whose non-conjugated products vanish in the
    first step (``rhat·rhat = 0`` for ``b = [1, i]``), the sesquilinear
    BiCGSTAB still converges."""
    a = torch.tensor([[2.0, 0.5], [0.25, 3.0]], dtype=torch.complex128)
    b = torch.tensor([1.0, 1j], dtype=torch.complex128)
    r = bicgstab(lambda v: a @ v, b, tol=1e-12, maxiter=20)
    assert bool(r.converged)
    torch.testing.assert_close(a @ r.x, b, rtol=0, atol=1e-12)
