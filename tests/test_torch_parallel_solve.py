"""The port's distributed solves (``spgpu_tpu_torch.parallel.dist_solve``)
and its classic partition against the JAX package's on the CPU.

Every case runs on 1, 2 and 4 gloo ranks spawned once per world size (a
module-scoped fixture; the JAX references are computed meanwhile, each
once, on the smallest fixtures and a 2-device mesh, the single-slab
schedule: the JAX distributed solves compile for seconds, the overlapped
ones for twice as long), and each is asserted on its own:

* ``dist_cg`` in float32, float64, complex64 and complex128 (Hermitian
  positive-definite) and ``dist_bicgstab`` in float32 against the JAX
  ``dist_cg``/``dist_bicgstab`` (``cg_dd``, ``cg_herm_planes`` and its
  double-float form there): iterations within max(1, 10 %) (float32,
  complex64) or 2 (float64, complex128), x within 1e-3 or 1e-9 of the JAX
  x (times max|x|), and a true residual of at most 1e-4 or 1e-9;
* a Jacobi-preconditioned ``dist_cg`` (``m_inv`` in lane space, 1 in the
  phantom lanes) against the host golden;
* the solve handle's two solves on one placement (``placements`` 1);
* the classic partition's SpMV (2e-5·max|z|) and CG against the JAX
  ``PartitionedWhell`` path, in float32 and in float64 (1e-12·max|z|;
  CG to 1e-11, iterations within 2, x within 1e-9 of the JAX x): the
  JAX classic partition keeps float64 slabs and ``dist_spmv`` runs them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.parallel import make_row_mesh  # noqa: E402
from spgpu_tpu.parallel.dist_solve import dist_bicgstab as j_bicgstab  # noqa: E402
from spgpu_tpu.parallel.dist_solve import dist_cg as j_cg  # noqa: E402
from spgpu_tpu.parallel.dist_spmv import dist_spmv as j_dist_spmv  # noqa: E402
from spgpu_tpu.parallel.partition_packed import (  # noqa: E402
    partition_coo_rows_packed as j_partition)
from spgpu_tpu.parallel.partition_whell import (  # noqa: E402
    partition_coo_rows_whell as j_partition_whell)
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.parallel import (  # noqa: E402
    DistSolveHandle,
    RankGroup,
    partition_coo_rows_packed,
    partition_coo_rows_whell,
    run_ranks,
)
from spgpu_tpu_torch.solvers import jacobi_preconditioner  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)

WORLDS = (1, 2, 4)


def hermitian(n, dt, seed=6):
    """A Hermitian positive-definite tridiagonal system (4 on the
    diagonal, conjugate off-diagonal pairs of size ~0.3)."""
    rng = np.random.default_rng(seed)
    r = np.arange(n)
    off = (rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)) * 0.3
    return CooMatrix(np.r_[r, r[:-1], r[1:]], np.r_[r, r[1:], r[:-1]],
                     np.r_[np.full(n, 4.0 + 0j), off, np.conj(off)].astype(dt), n, n)


def as_type(coo, dt):
    return CooMatrix(coo.rows, coo.cols, coo.values.astype(dt), coo.n_rows, coo.n_cols)


def rhs(coo, seed=1):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(coo.n_rows)
    if np.iscomplexobj(coo.values):
        b = b + 1j * rng.standard_normal(coo.n_rows)
    return b.astype(coo.values.dtype)


#: solve cases: name -> (the system's maker, solver, tol, maxiter, the JAX
#: reference's mesh size, exact type: iterations within 2, x 1e-9)
SOLVES = {
    "cg-laplace-float32": (lambda: tfix.laplacian_2d(24, 64, np.float32), "cg",
                           1e-6, 3000, 2, False),
    "cg-laplace-float64": (lambda: tfix.laplacian_2d(24, 64, np.float64), "cg",
                           1e-11, 6000, 2, True),
    "cg-hermitian-complex64": (lambda: hermitian(1024, np.complex64), "cg",
                               1e-6, 2000, 2, False),
    "cg-hermitian-complex128": (lambda: hermitian(1024, np.complex128), "cg",
                                1e-11, 2000, 2, True),
    # the uneven 2-shard system of tests/test_parallel.py (nonsymmetric,
    # diagonally dominant)
    "bicgstab-uneven-float32": (lambda: as_type(tfix.random_banded(
        700, bands=5, wander=0, seed=3).sum_duplicates(), np.float32), "bicgstab",
        1e-6, 4000, 2, False),
}


def true_residual(coo, b, x):
    wide = np.complex128 if np.iscomplexobj(coo.values) else np.float64
    b = b.astype(wide)
    return np.linalg.norm(b - coo.spmv(x.astype(wide))) / np.linalg.norm(b)


def jcoo(coo):
    return JCoo(coo.rows, coo.cols, coo.values, coo.n_rows, coo.n_cols)


@pytest.fixture(scope="module")
def ranked():
    """Every case on 1, 2 and 4 gloo ranks (one spawn per world size, in
    a thread) and the JAX references meanwhile."""
    from concurrent.futures import ThreadPoolExecutor

    systems = {name: spec[0]() for name, spec in SOLVES.items()}
    lap = tfix.laplacian_2d(24, 64, np.float32)
    b, b2 = rhs(lap, 1), rhs(lap, 2)
    lap64 = as_type(lap, np.float64)
    b64 = rhs(lap64, 1)
    m_inv = jacobi_preconditioner(lap, "cpu").numpy()
    jobs = {}
    for W in WORLDS:
        cases = []
        for name, (_, solver, tol, maxiter, _, _) in SOLVES.items():
            coo = systems[name]
            cases.append((solver, partition_coo_rows_packed(coo, W),
                          dict(b=rhs(coo), tol=tol, maxiter=maxiter)))
        pm = partition_coo_rows_packed(lap, W)
        cases.append(("cg", pm, dict(b=b, tol=1e-6, maxiter=3000, m_inv=m_inv)))
        cases.append(("handle", pm, dict(bs=[b, b2], tol=1e-6, maxiter=3000)))
        pw = partition_coo_rows_whell(lap, W)
        cases.append(("spmv", pw, dict(x=b)))
        cases.append(("cg", pw, dict(b=b, tol=1e-6, maxiter=3000)))
        pw64 = partition_coo_rows_whell(lap64, W)
        cases.append(("spmv", pw64, dict(x=b64)))
        cases.append(("cg", pw64, dict(b=b64, tol=1e-11, maxiter=6000)))
        jobs[W] = cases
    with ThreadPoolExecutor(1) as ex:
        runs = {W: ex.submit(run_ranks, W, "spgpu_tpu_torch.parallel.dryrun:run_cases",
                             jobs[W], device="cpu", timeout_s=300) for W in WORLDS}
        refs = {}
        for name, (_, solver, tol, maxiter, S, _) in SOLVES.items():
            coo = systems[name]
            fn = j_cg if solver == "cg" else j_bicgstab
            r = fn(j_partition(jcoo(coo), S, overlap=False), rhs(coo),
                   make_row_mesh(S), tol=tol, maxiter=maxiter)
            refs[name] = (np.asarray(r.x), int(r.iterations))
        jw = j_partition_whell(jcoo(lap), 2)
        refs["classic-spmv"] = np.asarray(j_dist_spmv(jw, b, make_row_mesh(2)))
        r = j_cg(jw, b, make_row_mesh(2), tol=1e-6, maxiter=3000)
        refs["classic-cg"] = (np.asarray(r.x), int(r.iterations))
        jw = j_partition_whell(jcoo(lap64), 2)
        refs["classic-spmv-float64"] = np.asarray(j_dist_spmv(jw, b64, make_row_mesh(2)))
        r = j_cg(jw, b64, make_row_mesh(2), tol=1e-11, maxiter=6000)
        refs["classic-cg-float64"] = (np.asarray(r.x), int(r.iterations))
        results = {W: f.result() for W, f in runs.items()}
    return systems, lap, (b, b2, m_inv), results, refs


def agree(results, i):
    """Case ``i``'s result on rank 0, after checking every rank's equals it."""
    first = results[0][i]
    for r in results[1:]:
        other = r[i]
        if isinstance(first, dict):
            for k, v in first.items():
                if k != "solves":
                    assert np.array_equal(np.asarray(other[k]), np.asarray(v)), k
        else:
            assert np.array_equal(other, first)
    return first


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("name", list(SOLVES))
def test_dist_solve_matches_jax(ranked, name, W):
    systems, _, _, results, refs = ranked
    coo = systems[name]
    exact = SOLVES[name][5]
    got = agree(results[W], list(SOLVES).index(name))
    x_ref, it_ref = refs[name]
    assert got["converged"]
    slack = 2 if exact else max(1, it_ref // 10)
    assert abs(got["iterations"] - it_ref) <= slack, (got["iterations"], it_ref)
    assert np.abs(got["x"] - x_ref).max() <= (1e-9 if exact else 1e-3) * np.abs(x_ref).max()
    assert true_residual(coo, rhs(coo), got["x"]) <= (1e-9 if exact else 1e-4)


@pytest.mark.parametrize("W", WORLDS)
def test_dist_cg_jacobi(ranked, W):
    _, lap, (b, _, _), results, refs = ranked
    got = agree(results[W], len(SOLVES))
    assert got["converged"]
    assert true_residual(lap, b, got["x"]) <= 1e-4


@pytest.mark.parametrize("W", WORLDS)
def test_handle_two_solves_one_placement(ranked, W):
    _, lap, (b, b2, _), results, _ = ranked
    got = agree(results[W], len(SOLVES) + 1)
    assert got["placements"] == 1 and len(got["solves"]) == 2
    for bb, s in zip((b, b2), got["solves"]):
        assert s["converged"] and true_residual(lap, bb, s["x"]) <= 1e-4


@pytest.mark.parametrize("W", WORLDS)
def test_classic_partition_matches_jax(ranked, W):
    _, lap, (b, _, _), results, refs = ranked
    z = agree(results[W], len(SOLVES) + 2)
    g = lap.spmv(b.astype(np.float64))
    for want in (g, refs["classic-spmv"]):
        assert np.abs(z - want).max() <= 2e-5 * np.abs(want).max()
    got = agree(results[W], len(SOLVES) + 3)
    x_ref, it_ref = refs["classic-cg"]
    assert got["converged"] and abs(got["iterations"] - it_ref) <= max(1, it_ref // 10)
    assert np.abs(got["x"] - x_ref).max() <= 1e-3 * np.abs(x_ref).max()
    assert true_residual(lap, b, got["x"]) <= 1e-4


@pytest.mark.parametrize("W", WORLDS)
def test_classic_partition_f64_matches_jax(ranked, W):
    """The float64 classic partition (kernel #15's float64 plain version on
    each shard) against the JAX float64 ``PartitionedWhell`` path."""
    _, lap, (b, _, _), results, refs = ranked
    lap64, b64 = as_type(lap, np.float64), rhs(as_type(lap, np.float64), 1)
    z = agree(results[W], len(SOLVES) + 4)
    assert z.dtype == np.float64
    for want in (lap64.spmv(b64), refs["classic-spmv-float64"]):
        assert np.abs(z - want).max() <= 1e-12 * np.abs(want).max()
    got = agree(results[W], len(SOLVES) + 5)
    x_ref, it_ref = refs["classic-cg-float64"]
    assert got["converged"] and got["x"].dtype == np.float64
    assert abs(got["iterations"] - it_ref) <= 2, (got["iterations"], it_ref)
    assert np.abs(got["x"] - x_ref).max() <= 1e-9 * np.abs(x_ref).max()
    assert true_residual(lap64, b64, got["x"]) <= 1e-9


def test_complex_m_inv_raises():
    """As the JAX package: no preconditioner on the complex solves (it
    raises before any collective, so one rank of no group shows it)."""
    coo = hermitian(256, np.complex64)
    h = DistSolveHandle(partition_coo_rows_packed(coo, 1),
                        RankGroup(rank=0, size=1, device=torch.device("cpu"), group=None))
    with pytest.raises(NotImplementedError):
        h.solve(rhs(coo), m_inv=np.ones(256))
