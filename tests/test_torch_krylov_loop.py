"""PyTorch port: the Krylov loop's masked steps, run in chunks on the CPU.

On a CUDA device ``cg`` and ``bicgstab`` capture ``GRAPH_STEPS`` masked
steps in a CUDA graph and replay it until a replay ends inactive (the
card tests in ``tests/test_torch_cuda.py`` hold that form).  Here the
same steps run eagerly in chunks of ``steps`` ∈ {1, 3, 8}, the host
reading the flag after each chunk, and must give bit for bit what the
plain loop (the witnesses ``_cg_eager`` and ``_bicgstab_eager``) gives:
``x``, ``iterations``, ``residual_norm`` and ``converged``, on a dense
operator and on the WHDIA, SDIA and packed WHELL routes (their plain
versions) in float32, float64, complex64 and complex128.  Edge cases:
``maxiter`` not a multiple of the chunk, ``maxiter = 0``, ``b = 0``, an
``x0`` that already converged, a BiCGSTAB breakdown that freezes the
iterate, a Jacobi-preconditioned CG.  Iteration counts against the JAX
``cg``/``bicgstab`` (float64, the same count, as
``tests/test_torch_solvers.py`` holds them) and ``cg_herm_planes``/
``bicgstab_planes`` (complex64, within max(1, 10 %), as
``tests/test_torch_complex_solve.py`` does), and the loop's counters.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu.solvers.cg import bicgstab as j_bicgstab  # noqa: E402
from spgpu_tpu.solvers.cg import bicgstab_planes, cg_herm_planes  # noqa: E402
from spgpu_tpu.solvers.cg import cg as j_cg  # noqa: E402
from spgpu_tpu_torch import kernels  # noqa: E402
from spgpu_tpu_torch.convert import coo_to_sdia, coo_to_whdia, coo_to_whell  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.kernels import whdia as kd  # noqa: E402
from spgpu_tpu_torch.ops import sdia_spmv, whdia_spmv, whell_spmv  # noqa: E402
from spgpu_tpu_torch.solvers import jacobi_preconditioner  # noqa: E402
from spgpu_tpu_torch.utils.fixtures import laplacian_2d, random_banded  # noqa: E402

#: the loop's module (``solvers.cg`` is the function of that name)
loop = importlib.import_module("spgpu_tpu_torch.solvers.cg")

DTYPES = ["float32", "float64", "complex64", "complex128"]
TOL = {"float32": 1e-5, "complex64": 1e-5, "float64": 1e-10, "complex128": 1e-10}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the loop issues
    thousands of tiny ops, which slow down many times over when every
    parallel test worker's thread pool spins on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _system(dtype, symmetric):
    """CG: the 14x12 Laplacian (complex: (A + Aᴴ)/2 of the Laplacian plus
    ``1j·N(0, 1)``, each diagonal entry its row's off-diagonal modulus sum
    + 1: Hermitian positive-definite); BiCGSTAB: a contiguous 5-band of 200
    rows (complex: plus ``1j·N(0, 1)``); ``b`` from ``default_rng(5)``."""
    cplx = np.dtype(dtype).kind == "c"
    c = laplacian_2d(14, 12) if symmetric else random_banded(200, bands=5, seed=3)
    n = c.n_rows
    v = c.values + (1j * np.random.default_rng(8).standard_normal(c.nnz) if cplx else 0)
    if symmetric and cplx:
        h = CooMatrix(np.r_[c.rows, c.cols], np.r_[c.cols, c.rows],
                      np.r_[v / 2, np.conj(v) / 2], n, n).sum_duplicates()
        off = h.rows != h.cols
        d = np.bincount(h.rows[off], weights=np.abs(h.values[off]), minlength=n) + 1.0
        i = np.arange(n)
        coo = CooMatrix(np.r_[h.rows[off], i], np.r_[h.cols[off], i],
                        np.r_[h.values[off], d].astype(dtype), n, n)
    else:
        coo = CooMatrix(c.rows, c.cols, v.astype(dtype), n, n).sum_duplicates()
    rng = np.random.default_rng(5)
    b = rng.standard_normal(n) + (1j * rng.standard_normal(n) if cplx else 0)
    return coo, torch.from_numpy(b.astype(dtype))


def _operator(op, coo, b):
    """``(matvec, b)`` on one route, ``b`` in that route's numbering."""
    if op == "dense":
        a = torch.from_numpy(coo.to_dense())
        return (lambda v: a @ v), b
    if op == "whell":
        a = coo_to_whell(coo, device="cpu")
        return (lambda v: whell_spmv(a, v)), a.embed(b, dtype=b.dtype)
    a = {"whdia": coo_to_whdia, "sdia": coo_to_sdia}[op](coo, device="cpu")
    spmv = {"whdia": whdia_spmv, "sdia": sdia_spmv}[op]
    return (lambda v: spmv(a, v)), b


def _same(got, want):
    assert got.iterations == want.iterations
    assert got.x.dtype == want.x.dtype and torch.equal(got.x, want.x)
    assert torch.equal(got.residual_norm, want.residual_norm)
    assert bool(got.converged) == bool(want.converged)


def _pair(solver):
    """The chunked driver and the eager witness of ``solver``."""
    return getattr(loop, f"_{solver}"), getattr(loop, f"_{solver}_eager")


@pytest.mark.parametrize("steps", [1, 3, 8])
@pytest.mark.parametrize("op", ["dense", "whdia", "sdia", "whell"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_chunked_steps_match_the_eager_witness(solver, dtype, op, steps):
    mv, b = _operator(op, *_system(dtype, solver == "cg"))
    chunked, eager = _pair(solver)
    want = eager(mv, b, tol=TOL[dtype], maxiter=500)
    assert bool(want.converged) and want.iterations >= 8
    _same(chunked(mv, b, tol=TOL[dtype], maxiter=500, steps=steps), want)


@pytest.mark.parametrize("steps", [3, 8])
@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_maxiter_not_a_multiple_of_the_chunk(solver, steps):
    mv, b = _operator("whdia", *_system("float64", solver == "cg"))
    chunked, eager = _pair(solver)
    got = chunked(mv, b, tol=1e-14, maxiter=7, steps=steps)
    assert got.iterations == 7 and not bool(got.converged)
    _same(got, eager(mv, b, tol=1e-14, maxiter=7))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_maxiter_zero_runs_no_iteration(solver, steps):
    mv, b = _operator("dense", *_system("float32", solver == "cg"))
    chunked, eager = _pair(solver)
    loop.STEPS = loop.HOST_READS = loop.REPLAYS = 0
    got = chunked(mv, b, tol=1e-5, maxiter=0, steps=steps)
    assert got.iterations == 0 and not bool(got.converged)
    assert torch.equal(got.x, torch.zeros_like(b))
    assert (loop.STEPS, loop.HOST_READS, loop.REPLAYS) == (steps, 1, 1)
    _same(got, eager(mv, b, tol=1e-5, maxiter=0))


@pytest.mark.parametrize("dtype", ["float64", "complex64"])
@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_zero_rhs_converges_at_once(solver, dtype):
    coo, b = _system(dtype, solver == "cg")
    mv, zero = _operator("sdia", coo, torch.zeros_like(b))
    chunked, eager = _pair(solver)
    got = chunked(mv, zero, tol=1e-5, maxiter=100, steps=3)
    assert got.iterations == 0 and bool(got.converged)
    assert not bool(got.x.abs().max() > 0)
    _same(got, eager(mv, zero, tol=1e-5, maxiter=100))


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_converged_x0_runs_no_iteration_and_is_not_written(solver):
    coo, b = _system("float64", solver == "cg")
    mv, _ = _operator("dense", coo, b)
    x0 = torch.from_numpy(np.linalg.solve(coo.to_dense(), b.numpy()))
    kept = x0.clone()
    chunked, eager = _pair(solver)
    got = chunked(mv, b, x0=x0, tol=1e-8, maxiter=100, steps=8)
    assert got.iterations == 0 and bool(got.converged)
    assert torch.equal(x0, kept) and got.x is not x0
    _same(got, eager(mv, b, x0=x0, tol=1e-8, maxiter=100))
    # an x0 that has not converged is copied too, never written
    start = torch.ones_like(b)
    got = chunked(mv, b, x0=start, tol=1e-10, maxiter=100, steps=3)
    assert torch.equal(start, torch.ones_like(b)) and got.iterations > 0
    _same(got, eager(mv, b, x0=start, tol=1e-10, maxiter=100))


@pytest.mark.parametrize("steps", [1, 3])
def test_bicgstab_breakdown_freezes_the_iterate(steps):
    """A skew-symmetric A gives ``r̂·A·r̂ = 0`` in the first step: BiCGSTAB
    breaks down, the iterate and the residual stay as they were, and no
    later step runs an iteration."""
    a = torch.tensor([[0.0, 1.0], [-1.0, 0.0]], dtype=torch.float64)
    b = torch.tensor([1.0, 2.0], dtype=torch.float64)
    loop.STEPS = loop.HOST_READS = loop.REPLAYS = 0
    got = loop._bicgstab(lambda v: a @ v, b, tol=1e-12, maxiter=50, steps=steps)
    assert got.iterations == 1 and not bool(got.converged)
    assert torch.equal(got.x, torch.zeros_like(b))
    assert float(got.residual_norm) == float(torch.linalg.norm(b))
    assert loop.REPLAYS == (2 if steps == 1 else 1)
    _same(got, loop._bicgstab_eager(lambda v: a @ v, b, tol=1e-12, maxiter=50))


@pytest.mark.parametrize("steps", [1, 3, 8])
def test_jacobi_preconditioned_cg(steps):
    """CG with a diagonal preconditioner, on an SPD band whose diagonal
    spans two decades: the chunked steps equal the eager witness and
    take fewer iterations than without."""
    c = random_banded(300, bands=5, seed=4).sum_duplicates()
    n = c.n_rows
    off = c.rows != c.cols
    sym = CooMatrix(np.r_[c.rows[off], c.cols[off]], np.r_[c.cols[off], c.rows[off]],
                    np.r_[c.values[off], c.values[off]] / 2, n, n).sum_duplicates()
    diag = (np.bincount(sym.rows, weights=np.abs(sym.values), minlength=n) + 1.0) \
        * np.geomspace(1.0, 100.0, n)
    i = np.arange(n)
    coo = CooMatrix(np.r_[sym.rows, i], np.r_[sym.cols, i], np.r_[sym.values, diag], n, n)
    b = torch.from_numpy(np.random.default_rng(2).standard_normal(n))
    m_inv = jacobi_preconditioner(coo, "cpu")
    mv, _ = _operator("whdia", coo, b)
    got = loop._cg(mv, b, tol=1e-10, maxiter=1000, m_inv=m_inv, steps=steps)
    want = loop._cg_eager(mv, b, tol=1e-10, maxiter=1000, m_inv=m_inv)
    _same(got, want)
    assert bool(got.converged)
    assert got.iterations < loop._cg_eager(mv, b, tol=1e-10, maxiter=1000).iterations


@pytest.mark.parametrize("steps", [1, 3, 8])
@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_iterations_match_jax(solver, steps):
    """On tests/test_torch_solvers.py's dense SPD operator in float64 the
    chunked loop takes the JAX loop's iteration count and lands on its x."""
    rng = np.random.default_rng(9)
    m = rng.standard_normal((60, 60))
    a = m @ m.T / 60 + np.eye(60)
    b = rng.standard_normal(60)
    j_fn = {"cg": j_cg, "bicgstab": j_bicgstab}[solver]
    rj = j_fn(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), tol=1e-12, maxiter=500)
    at = torch.from_numpy(a)
    rt = _pair(solver)[0](lambda v: at @ v, torch.from_numpy(b), tol=1e-12,
                          maxiter=500, steps=steps)
    assert bool(rt.converged) and rt.iterations == int(rj.iterations)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("steps", [3, 8])
@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_iterations_match_jax_planes(solver, steps):
    """tests/test_torch_complex_solve.py's dense complex64 operators:
    ``cg`` against ``cg_herm_planes`` (Hermitian positive-definite),
    ``bicgstab`` against ``bicgstab_planes``, within max(1, 10 %) of the
    JAX count and 1e-4·max|x|."""
    rng = np.random.default_rng(4)
    m = rng.standard_normal((80, 80)) + 1j * rng.standard_normal((80, 80))
    a = (m @ m.conj().T / 80 + np.eye(80) if solver == "cg"
         else m / 10 + 4 * np.eye(80)).astype(np.complex64)
    r6 = np.random.default_rng(6)
    b = (r6.standard_normal(80) + 1j * r6.standard_normal(80)).astype(np.complex64)
    aj = jnp.asarray(a)

    def mv_planes(v):
        z = aj @ (v[0] + 1j * v[1])
        return jnp.stack([z.real, z.imag])

    j_fn = {"cg": cg_herm_planes, "bicgstab": bicgstab_planes}[solver]
    rj = j_fn(mv_planes, jnp.asarray(np.stack([b.real, b.imag])), tol=1e-5, maxiter=300)
    at = torch.from_numpy(a)
    rt = _pair(solver)[0](lambda v: at @ v, torch.from_numpy(b), tol=1e-5,
                          maxiter=300, steps=steps)
    kj = int(rj.iterations)
    assert bool(rj.converged) and bool(rt.converged)
    assert abs(kj - rt.iterations) <= max(1, kj // 10), (kj, rt.iterations)
    xj = np.asarray(rj.x[0]) + 1j * np.asarray(rj.x[1])
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0, atol=1e-4 * np.abs(xj).max())


@pytest.mark.parametrize("steps", [1, 3, 8])
@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_counters_follow_the_chunk(solver, steps):
    """The host reads the flag once per chunk; the chunks run until the
    first that ends inactive: ceil((iterations + 1) / steps) of them, all
    their steps counted; nothing is captured on the CPU and no kernel
    launch is counted."""
    mv, b = _operator("whdia", *_system("float32", solver == "cg"))
    loop.STEPS = loop.HOST_READS = loop.REPLAYS = 0
    loop.CAPTURE_MS = 0.0
    launches = kernels.launch_counts()
    got = _pair(solver)[0](mv, b, tol=1e-5, maxiter=500, steps=steps)
    chunks = -(-(got.iterations + 1) // steps)
    assert loop.REPLAYS == loop.HOST_READS == chunks
    assert loop.STEPS == steps * chunks
    assert loop.CAPTURE_MS == 0.0 and kernels.launch_counts() == launches


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_public_solvers_step_once_per_read_on_the_cpu(solver):
    """``cg`` and ``bicgstab`` on CPU tensors: one step, then one read."""
    mv, b = _operator("sdia", *_system("float64", solver == "cg"))
    loop.STEPS = loop.HOST_READS = loop.REPLAYS = 0
    got = getattr(loop, solver)(mv, b, tol=1e-10, maxiter=500)
    assert loop.STEPS == loop.HOST_READS == loop.REPLAYS == got.iterations + 1
    _same(got, _pair(solver)[1](mv, b, tol=1e-10, maxiter=500))


def test_launch_count_helpers():
    """What a capture added, taken off and added back per replay."""
    before = kernels.launch_counts()
    assert (kd, "LAUNCHES") in before and (kd, "LAUNCHES_C128") in before
    kd.LAUNCHES += 3
    kd.LAUNCHES_F64 += 1
    added = kernels.launch_counts_since(before)
    assert added == {(kd, "LAUNCHES"): 3, (kd, "LAUNCHES_F64"): 1}
    kernels.add_launches(added, -1)
    assert kernels.launch_counts() == before
    kernels.add_launches(added, 4)
    assert kd.LAUNCHES == before[(kd, "LAUNCHES")] + 12
    kernels.add_launches(added, -4)
    assert kernels.launch_counts() == before
