"""PyTorch port: the ``hybrid``, ``hell`` and complex-override routes of
``solve()`` against the JAX package's (the split itself and its product:
tests/test_torch_hybrid.py; a file of its own, so that the test workers
run the two files' JAX compiles side by side).

On tests/test_hybrid.py's fixture (``random_mixed(1 << 12, bands=9,
wander=3, extra_avg=4.0, span=500, far_frac=0.02, seed=1)``): its SPD form
(CG) and its diagonally shifted form (BiCGSTAB) through
``solve(fmt="hybrid"|"hell")`` in float32 and float64, and the complex
overrides (``fmt`` "hell", "hybrid", "blocks", "pcell" on complex64 and
complex128, all on the ``hell`` route): iterations within 10 % of the JAX
``solve()``'s (2 in float64 and complex128) and ``x`` at the type's
tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spgpu_tpu import solvers as jsolvers  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.solvers import solve  # noqa: E402
from test_torch_hybrid import N, jcoo, mixed  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)


def shifted(dt):
    """The mixed fixture with 25 added to its diagonal (BiCGSTAB
    converges on it, as in tests/test_hybrid.py)."""
    c = mixed(np.float32)
    idx = np.arange(N, dtype=np.int64)
    return CooMatrix(np.r_[c.rows, idx], np.r_[c.cols, idx],
                     np.r_[c.values, np.full(N, 25.0, np.float32)].astype(dt),
                     N, N).sum_duplicates()


def spd(dt):
    """An SPD (Hermitian PD for complex ``dt``) form of the fixture: (A +
    Aᴴ)/2 with each diagonal entry its row's off-diagonal |·|-sum + 1
    (complex: imaginary parts ``+ 1j·N(0, 1)`` first, ``default_rng(8)``)."""
    c = mixed(np.float64)
    v = c.values.astype(np.complex128 if np.dtype(dt).kind == "c" else np.float64)
    if np.dtype(dt).kind == "c":
        v = v + 1j * np.random.default_rng(8).standard_normal(c.nnz)
    v = v / 2
    sym = CooMatrix(np.r_[c.rows, c.cols], np.r_[c.cols, c.rows], np.r_[v, np.conj(v)],
                    N, N).sum_duplicates()
    off = sym.rows != sym.cols
    d = np.bincount(sym.rows[off], weights=np.abs(sym.values[off]), minlength=N) + 1.0
    idx = np.arange(N, dtype=np.int64)
    return CooMatrix(np.r_[sym.rows[off], idx], np.r_[sym.cols[off], idx],
                     np.r_[sym.values[off], d].astype(dt), N, N)


def rhs(c, dt):
    rng = np.random.default_rng(6)
    b = rng.standard_normal(N)
    if np.dtype(dt).kind == "c":
        b = b + 1j * rng.standard_normal(N)
    return b.astype(dt)


#: (route, dtype, symmetric) of the real solves; the complex overrides
SOLVES = [("hybrid", np.float32, True), ("hybrid", np.float64, False),
          ("hell", np.float32, True), ("hell", np.float64, True),
          ("hell", np.float32, False)]
OVERRIDES = [("hell", np.complex64), ("hybrid", np.complex64),
             ("blocks", np.complex128), ("pcell", np.complex64)]


def compare_solves(c, b, fmt, dt, symmetric, **kw):
    """The port's and the JAX ``solve()`` of one system: iterations within
    10 % (2 in float64 and complex128), ``x`` at the type's tolerance, and
    the port's true residual at ``tol`` (times 10)."""
    tol = 1e-10 if np.dtype(dt) in (np.float64, np.complex128) else 1e-5
    rt = solve(c, b, device="cpu", fmt=fmt, symmetric=symmetric, tol=tol,
               maxiter=2000, **kw)
    rj = jsolvers.solve(jcoo(c), b, fmt=fmt, symmetric=symmetric, tol=tol,
                        maxiter=2000, **kw)
    assert bool(rt.converged) and bool(rj.converged)
    assert rt.x.dtype == getattr(torch, np.dtype(dt).name)
    wide = np.complex128 if np.dtype(dt).kind == "c" else np.float64
    xt, xj = rt.x.numpy().astype(wide), np.asarray(rj.x).astype(wide)
    slack = 2 if tol < 1e-8 else max(1, rj.iterations // 10)
    assert abs(int(rt.iterations) - int(rj.iterations)) <= slack
    xtol = 1e-8 if tol < 1e-8 else 1e-4
    np.testing.assert_allclose(xt, xj, rtol=0, atol=xtol * np.abs(xj).max())
    assert np.linalg.norm(b - c.spmv(xt)) <= 10 * tol * np.linalg.norm(b)


@pytest.mark.parametrize("fmt,dt,symmetric", SOLVES,
                         ids=[f"{f}-{np.dtype(d).name}-{'cg' if s else 'bicgstab'}"
                              for f, d, s in SOLVES])
def test_real_routes_match_jax(fmt, dt, symmetric):
    c = spd(dt) if symmetric else shifted(dt)
    compare_solves(c, rhs(c, dt), fmt, dt, symmetric,
                   jacobi=fmt == "hell" and dt == np.float32 and symmetric)


@pytest.mark.parametrize("fmt,dt", OVERRIDES,
                         ids=[f"{f}-{np.dtype(d).name}" for f, d in OVERRIDES])
def test_complex_overrides_run_the_hell_route(monkeypatch, fmt, dt):
    """A complex system with ``fmt`` hell, hybrid, blocks or pcell runs
    the hell route (CG, Hermitian PD), as the JAX ``solve()`` does."""
    from spgpu_tpu_torch.solvers import auto

    calls = []
    op = auto.hell_spmv
    monkeypatch.setattr(auto, "hell_spmv", lambda *a, **k: calls.append(1) or op(*a, **k))
    c = spd(dt)
    compare_solves(c, rhs(c, dt), fmt, dt, True)
    assert calls
