"""PyTorch port: the HELL row partition (``spgpu_tpu_torch.parallel.
partition``) against the JAX package's (``spgpu_tpu.parallel.partition``)
on the CPU.

* Structure: on three fixtures in float32, float64, complex64 and
  complex128, at 2, 4 and 8 shards, the split (``chunk``, ``K``), the
  halo counts and each shard's send lists equal the JAX plan's, and each
  shard's interior and exterior HELL arrays equal the JAX partition's
  slabs of that shard with their stacking pad cut (bit for bit, in the
  same dtype); a shard without an exterior layout has an all-zero JAX
  exterior slab.
* Numbers: ``dist_spmv`` and ``dist_cg`` on 1, 2 and 4 gloo ranks (one
  spawn per world size), each rank's result the same bits as rank 0's;
  ``dist_spmv`` against the host golden and the JAX ``dist_spmv`` on the
  same world size (float32 and complex64 2e-5, float64 1e-12, times
  max|z|), ``dist_cg`` (float32, float64) against the JAX ``dist_cg``:
  iterations within max(1, 10 %) (2 in float64), x within 1e-4 (1e-9)
  of the JAX x times max|x|.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.parallel import make_row_mesh  # noqa: E402
from spgpu_tpu.parallel.dist_solve import dist_cg as j_cg  # noqa: E402
from spgpu_tpu.parallel.dist_spmv import dist_spmv as j_dist_spmv  # noqa: E402
from spgpu_tpu.parallel.partition import partition_coo_rows as j_partition  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.formats.hell import HellMatrix  # noqa: E402
from spgpu_tpu_torch.parallel import (PartitionedMatrix, partition_coo_rows,  # noqa: E402
                                      run_ranks)
from spgpu_tpu_torch.parallel.partition_packed import halo_plan  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402

FIXTURES = {
    "laplace": lambda: tfix.laplacian_2d(24, 64),
    "irregular": lambda: tfix.random_irregular(1000, 1000, avg_nnz_per_row=9.0, seed=3),
    "uneven": lambda: tfix.random_banded(700, bands=5, wander=0, seed=3),
}
DTYPES = (np.float32, np.float64, np.complex64, np.complex128)
WORLDS = (1, 2, 4)
TOL = {np.float32: 2e-5, np.complex64: 2e-5, np.float64: 1e-12, np.complex128: 1e-12}
SLABS = (("int", "interior"), ("ext", "exterior"))


def typed(name, dt):
    """Fixture ``name`` with ``dt`` values (complex: ``+ 1j·N(0, 1)``,
    ``default_rng(8)``)."""
    c = FIXTURES[name]()
    v = c.values.astype(np.float64)
    if np.dtype(dt).kind == "c":
        v = v + 1j * np.random.default_rng(8).standard_normal(c.nnz)
    return CooMatrix(c.rows, c.cols, v.astype(dt), c.n_rows, c.n_cols)


def jcoo(c):
    return JCoo(c.rows, c.cols, c.values, c.n_rows, c.n_cols)


@pytest.mark.parametrize("S", (2, 4, 8))
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_shard_slabs_equal_jax(name, dt, S):
    c = typed(name, dt)
    pm = partition_coo_rows(c, S)
    jp = j_partition(jcoo(c), S)
    assert isinstance(pm, PartitionedMatrix) and pm.dtype == getattr(torch, np.dtype(dt).name)
    assert (pm.chunk, pm.halo_width, pm.nnz, pm.n_rows) == \
        (jp.chunk, jp.halo_width, jp.nnz, jp.n_rows)
    send = np.asarray(jp.send_idx)
    assert pm.halo_counts == halo_plan(c, S)[5]
    for s, sh in enumerate(pm.shards):
        assert sh.n_local == max(0, min(pm.chunk, c.n_rows - s * pm.chunk))
        for r, lanes in sh.send_lanes.items():  # owner s -> requester r
            assert np.array_equal(lanes.numpy(), send[s, r, : pm.halo_counts[s][r]])
        for pre, side in SLABS:
            got = getattr(sh, side)
            ho = np.asarray(getattr(jp, f"{pre}_hack_offsets")[s])
            t = int(ho[-1])
            want = {"values": np.asarray(getattr(jp, f"{pre}_values")[s])[:t],
                    "col_indices": np.asarray(getattr(jp, f"{pre}_cols")[s])[:t],
                    "hack_offsets": ho,
                    "slot_to_hack": np.asarray(getattr(jp, f"{pre}_slot_to_hack")[s])[:t]}
            if got is None:
                assert side == "exterior" and not want["values"].any()
                continue
            assert isinstance(got, HellMatrix) and got.total_slots == t
            assert (got.n_rows, got.n_cols) == \
                (pm.chunk, pm.chunk if side == "interior" else S * pm.halo_width)
            for f, w in want.items():
                g = getattr(got, f).numpy()
                assert g.dtype == w.dtype and np.array_equal(g, w), (side, f)


def golden(c, x):
    wide = np.complex128 if np.iscomplexobj(c.values) else np.float64
    return c.spmv(x.astype(wide))


def x_for(c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(c.n_cols)
    if np.iscomplexobj(c.values):
        x = x + 1j * rng.standard_normal(c.n_cols)
    return x.astype(c.values.dtype)


#: the product cases: (fixture, dtype); the solve cases: dtype on the
#: float Laplacian, (tol, maxiter)
SPMV_CASES = [("irregular", np.float32), ("uneven", np.float64),
              ("laplace", np.complex64), ("uneven", np.complex128)]
CG_CASES = {np.float32: (1e-6, 2000), np.float64: (1e-10, 2000)}


def spmv_id(c):
    return f"{c[0]}-{np.dtype(c[1]).name}"


@pytest.fixture(scope="module")
def ranked():
    """Every case on 1, 2 and 4 gloo ranks (one spawn per world size, in a
    thread) and the JAX references meanwhile."""
    from concurrent.futures import ThreadPoolExecutor

    jobs, systems = {}, {}
    for name, dt in SPMV_CASES:
        c = typed(name, dt)
        systems[spmv_id((name, dt))] = (c, x_for(c))
    for dt in CG_CASES:
        c = typed("laplace", dt)
        systems[np.dtype(dt).name] = (c, x_for(c, 1))
    for W in WORLDS:
        cases = [("spmv", partition_coo_rows(c, W), dict(x=x))
                 for c, x in (systems[spmv_id(k)] for k in SPMV_CASES)]
        for dt, (tol, maxiter) in CG_CASES.items():
            c, b = systems[np.dtype(dt).name]
            cases.append(("cg", partition_coo_rows(c, W), dict(b=b, tol=tol,
                                                              maxiter=maxiter)))
        jobs[W] = cases
    with ThreadPoolExecutor(1) as ex:
        runs = {W: ex.submit(run_ranks, W, "spgpu_tpu_torch.parallel.dryrun:run_cases",
                             jobs[W], device="cpu", timeout_s=300) for W in WORLDS}
        refs = {}
        for W in WORLDS:
            mesh = make_row_mesh(W)
            for k in SPMV_CASES:
                c, x = systems[spmv_id(k)]
                refs[(W, spmv_id(k))] = np.asarray(j_dist_spmv(j_partition(jcoo(c), W),
                                                               x, mesh))
        for dt, (tol, maxiter) in CG_CASES.items():
            c, b = systems[np.dtype(dt).name]
            r = j_cg(j_partition(jcoo(c), 2), b, make_row_mesh(2), tol=tol,
                     maxiter=maxiter)
            refs[np.dtype(dt).name] = (np.asarray(r.x), int(r.iterations))
        results = {W: f.result() for W, f in runs.items()}
    return systems, results, refs


def on_every_rank(results, W, i):
    """Case ``i``'s result on rank 0, after checking every rank's equals it."""
    first = results[W][0][i]
    for other in results[W][1:]:
        if isinstance(first, dict):
            for k in ("x", "iterations", "converged", "residual_norm"):
                assert np.array_equal(np.asarray(other[i][k]), np.asarray(first[k])), k
        else:
            assert np.array_equal(other[i], first)
    return first


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("case", SPMV_CASES, ids=spmv_id)
def test_dist_spmv_matches_golden_and_jax(ranked, case, W):
    systems, results, refs = ranked
    c, x = systems[spmv_id(case)]
    z = on_every_rank(results, W, SPMV_CASES.index(case))
    g = golden(c, x)
    tol = TOL[np.dtype(case[1]).type] * np.abs(g).max()
    assert z.shape == g.shape and z.dtype == x.dtype
    assert np.abs(z - g).max() <= tol
    assert np.abs(z - refs[(W, spmv_id(case))]).max() <= tol


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("dt", list(CG_CASES), ids=lambda d: np.dtype(d).name)
def test_dist_cg_matches_jax(ranked, dt, W):
    systems, results, refs = ranked
    c, b = systems[np.dtype(dt).name]
    r = on_every_rank(results, W, len(SPMV_CASES) + list(CG_CASES).index(dt))
    xj, itj = refs[np.dtype(dt).name]
    f64 = np.dtype(dt) == np.float64
    assert r["converged"] and r["x"].dtype == np.dtype(dt)
    assert abs(r["iterations"] - itj) <= (2 if f64 else max(1, itj // 10))
    np.testing.assert_allclose(r["x"], xj, rtol=0,
                               atol=(1e-9 if f64 else 1e-4) * np.abs(xj).max())
    res = np.linalg.norm(b - c.spmv(r["x"].astype(np.float64))) / np.linalg.norm(b)
    assert res <= (1e-9 if f64 else 1e-4)
    assert r["launches"] == {}  # plain torch products: no kernel


def test_partition_refuses_rectangular_and_other_types():
    c = tfix.random_irregular(300, 200, avg_nnz_per_row=4.0, seed=1)
    with pytest.raises(ValueError, match="square"):
        partition_coo_rows(c, 2)
    c = typed("uneven", np.float32)
    with pytest.raises(NotImplementedError, match="float16"):
        partition_coo_rows(CooMatrix(c.rows, c.cols, c.values.astype(np.float16),
                                     c.n_rows, c.n_cols), 2)
