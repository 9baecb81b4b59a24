"""PyTorch port: per-cell row-routing WHELL (pcell) against the JAX package.

The converter must build the JAX ``coo_to_whell_percell`` arrays bit for
bit (the small geometry of tests/test_whell.py:427-475, the default
geometry, duplicates and the empty matrix).  The SpMV (kernel #17's plain
version: the same scan-then-difference arithmetic) is held against the
JAX ``ops.whell_spmv`` in interpret mode and the host golden at 1e-5 of
max|z| (tests/test_whell.py:445), and ``solve(fmt="pcell")`` against the
JAX ``solve(fmt="pcell")``: iterations within 2, x within 1e-4 relative.
The JAX kernel in interpret mode compiles for about half a minute at the
default geometry (128-tile chunks), so only the solve runs it there.
The card test's fixture is checked for the seams of kernel #17's warp
scan (runs across 32-lane boundaries, runs ending at lanes 0 and 127) and
for a tile count off its 4 tiles per block (7-tile chunks).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu import ops as jops  # noqa: E402
from spgpu_tpu.convert.pcell import coo_to_whell_percell as j_percell  # noqa: E402
from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.solvers import solve as j_solve  # noqa: E402
from spgpu_tpu.utils import fixtures as jfix  # noqa: E402
from spgpu_tpu_torch import ops as tops  # noqa: E402
from spgpu_tpu_torch.convert import coo_to_whell_percell  # noqa: E402
from spgpu_tpu_torch.convert import pcell as tconv  # noqa: E402
from spgpu_tpu_torch.formats import whell as twhell  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.kernels import pcell as kp  # noqa: E402
from spgpu_tpu_torch.solvers import solve  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)

ARRAYS = ("values", "residue", "page_tab", "run_hi", "run_lo", "tile_base",
          "chunk_group", "group_bases")
STATIC = ("n_rows", "n_cols", "num_hacks", "num_groups", "total_slots", "nnz",
          "x_pages", "window_pages", "group_hacks", "chunk_tiles")
SMALL = dict(group_hacks=32, chunk_tiles=16)  # tests/test_whell.py:438

CASES = {
    "fem2000": lambda f: f.random_fem_like(2000, 10.0, span=150, far_frac=0.02,
                                           seed=5, dtype=np.float32),
    "laplace": lambda f: f.laplacian_2d(23, 31, np.float32),
    "irregular": lambda f: f.random_irregular(1000, 1000, 9.0, seed=3,
                                              dtype=np.float32),
    "rect": lambda f: f.random_irregular(700, 1200, 6.0, seed=8, dtype=np.float32),
    "ctest": lambda f: f.ctest_fixture(np.float32),
}


def assert_same_layout(ja, ta):
    for f in ARRAYS:
        jv, tv = np.asarray(getattr(ja, f)), getattr(ta, f).numpy()
        assert jv.dtype == tv.dtype, (f, jv.dtype, tv.dtype)
        np.testing.assert_array_equal(jv, tv, err_msg=f)
    for f in STATIC:
        assert getattr(ja, f) == getattr(ta, f), f


def bridge(ja):
    return twhell.from_numpy_pcell({f: np.asarray(getattr(ja, f)) for f in ARRAYS},
                                   **{f: getattr(ja, f) for f in STATIC})


def _near(z, want, frac):
    """max|z - want| ≤ frac·max|want|."""
    z, want = np.asarray(z, np.float64), np.asarray(want, np.float64)
    assert z.shape == want.shape
    assert np.abs(z - want).max() <= frac * np.abs(want).max()


@pytest.mark.parametrize("name", sorted(CASES))
def test_pcell_converter_bit_identical(name):
    ja = j_percell(CASES[name](jfix), **SMALL)
    ta = coo_to_whell_percell(CASES[name](tfix), device="cpu", **SMALL)
    assert_same_layout(ja, ta)
    ta.check()


def test_pcell_converter_default_geometry_bit_identical():
    ja = j_percell(CASES["fem2000"](jfix))
    ta = coo_to_whell_percell(CASES["fem2000"](tfix), device="cpu")
    assert (ta.group_hacks, ta.chunk_tiles, ta.window_pages) == (32, 128, 32)
    assert_same_layout(ja, ta)


def test_pcell_duplicates_and_empty():
    """tests/test_whell.py:452-475: duplicates add; the empty matrix."""
    rows, cols = np.array([0, 0, 1, 300]), np.array([5, 5, 2, 300])
    vals = np.array([1.5, 2.5, -1.0, 3.0], np.float32)
    ja = j_percell(JCoo(rows, cols, vals, 400, 400), **SMALL)
    ta = coo_to_whell_percell(CooMatrix(rows, cols, vals, 400, 400), device="cpu",
                              **SMALL)
    assert_same_layout(ja, ta)
    z = tops.whell_spmv(ta, torch.ones(400))
    assert (float(z[0]), float(z[1]), float(z[300])) == (4.0, -1.0, 3.0)
    assert int((z != 0).sum()) == 3

    def empty(f):
        return f.CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0, np.float32), 256, 256)
    je = j_percell(empty(jfix), **SMALL)
    te = coo_to_whell_percell(empty(tfix), device="cpu", **SMALL)
    assert_same_layout(je, te)
    te.check()
    assert not tops.whell_spmv(te, torch.ones(256)).any()


def test_pcell_to_dense_and_bridge():
    coo = CASES["rect"](tfix)
    a = coo_to_whell_percell(coo, device="cpu", **SMALL)
    np.testing.assert_array_equal(a.to_dense(), coo.to_dense())
    ja = j_percell(CASES["rect"](jfix), **SMALL)
    b = bridge(ja)
    assert_same_layout(ja, b)
    assert_same_layout(ja, b.to("cpu"))


def test_pcell_spmv_matches_jax_and_golden():
    """tests/test_whell.py:427-449, with alpha/beta/y."""
    coo = CASES["fem2000"](tfix)
    ja = j_percell(CASES["fem2000"](jfix), **SMALL)
    ta = bridge(ja)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(2000).astype(np.float32)
    y = rng.standard_normal(2000).astype(np.float32)
    zj = np.asarray(jops.whell_spmv(ja, jnp.asarray(x), interpret=True))
    zt = tops.whell_spmv(ta, torch.from_numpy(x))
    assert zt.shape == (2000,) and zt.dtype == torch.float32
    ref = coo.spmv(x.astype(np.float64))
    _near(zt.numpy(), zj, 1e-5)
    _near(zt.numpy(), ref, 1e-5)
    zj2 = np.asarray(jops.whell_spmv(ja, jnp.asarray(x), alpha=2.0, beta=-0.5,
                                     y=jnp.asarray(y), interpret=True))
    zt2 = tops.whell_spmv(ta, torch.from_numpy(x), alpha=2.0, beta=-0.5,
                          y=torch.from_numpy(y))
    _near(zt2.numpy(), zj2, 1e-5)
    _near(zt2.numpy(), 2.0 * ref - 0.5 * y, 1e-5)


@pytest.mark.parametrize("name", ["laplace", "irregular", "rect", "ctest"])
def test_pcell_spmv_matches_golden(name):
    coo = CASES[name](tfix)
    for geometry in (SMALL, {}):
        a = coo_to_whell_percell(coo, device="cpu", **geometry)
        x = np.random.default_rng(2).standard_normal(coo.n_cols).astype(np.float32)
        _near(tops.whell_spmv(a, torch.from_numpy(x)).numpy(),
              coo.spmv(x.astype(np.float64)), 1e-5)


def test_pcell_plain_is_scan_then_difference():
    """The plain version differences an inclusive lane scan, as the kernel
    does: the same routed values as a direct per-run sum, to rounding."""
    coo = CASES["fem2000"](tfix)
    a = coo_to_whell_percell(coo, device="cpu", **SMALL)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        a.x_pages * 128).astype(np.float32)).view(a.x_pages, 128)
    z = kp.pcell_spmv_plain(a.values, a.residue, a.page_tab, a.run_hi, a.run_lo,
                            a.tile_base, a.chunk_group, a.group_bases, x,
                            chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                            window_pages=a.window_pages, num_groups=a.num_groups,
                            tile_page=a.tile_page)
    want = a.to_dense() @ x.reshape(-1)[: a.n_cols].double().numpy()
    _near(z.reshape(-1)[: a.n_rows].numpy(), want, 1e-6)


def test_pcell_spmm_loops_and_fused_raises(monkeypatch):
    a = coo_to_whell_percell(CASES["laplace"](tfix), device="cpu", **SMALL)
    calls = []
    fn = kp.pcell_spmv
    monkeypatch.setattr(kp, "pcell_spmv", lambda *p, **k: calls.append(1) or fn(*p, **k))
    X = torch.ones((3, a.n_cols))
    z = tops.whell_spmm(a, X)
    assert z.shape == (3, a.n_rows) and len(calls) == 3
    torch.testing.assert_close(z[1], tops.whell_spmv(a, X[1]), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="pcell"):
        tops.whell_spmm(a, X, fused=True)


def test_pcell_refuses_other_value_types():
    """The converter takes float32 and float64: a float64 layout equals
    the JAX one and its product the JAX op's and the golden, and
    ``solve(fmt="pcell")`` solves a float64 system in float64
    (tests/test_torch_f64_classic.py holds it to the JAX route).  Complex
    values raise in the converter, as the JAX op raises on the JAX
    converter's complex layout; ``solve(fmt="pcell")`` on a complex system
    runs the classic ``hell`` route, as the JAX ``solve()`` does, the same
    bits as ``fmt="hell"``."""
    c = CASES["laplace"](tfix)
    jc = CASES["laplace"](jfix)
    x = np.random.default_rng(5).standard_normal(c.n_cols)
    for dt in (np.float64, np.complex64):
        coo = CooMatrix(c.rows, c.cols, c.values.astype(dt), c.n_rows, c.n_cols)
        ja = j_percell(JCoo(jc.rows, jc.cols, jc.values.astype(dt), jc.n_rows,
                            jc.n_cols), **SMALL)
        xj = jnp.asarray(x.astype(dt))
        if dt == np.float64:
            ta = coo_to_whell_percell(coo, device="cpu", **SMALL)
            assert_same_layout(ja, ta)
            zt = tops.whell_spmv(ta, torch.from_numpy(x)).numpy()
            for want in (np.asarray(jops.whell_spmv(ja, xj, interpret=True)),
                         coo.spmv(x)):
                assert np.abs(zt - want).max() <= 1e-12 * np.abs(want).max()
            b = np.ones(c.n_rows, dt)
            r = solve(coo, b, device="cpu", fmt="pcell", tol=1e-10)
            assert bool(r.converged) and r.x.dtype == torch.float64
            assert np.linalg.norm(b - coo.spmv(r.x.numpy())) <= 1e-9 * np.linalg.norm(b)
            continue
        with pytest.raises(NotImplementedError, match="no complex pcell product"):
            coo_to_whell_percell(coo, device="cpu")
        with pytest.raises(NotImplementedError):
            jops.whell_spmv(ja, xj, interpret=True)
        b = np.ones(c.n_rows, dt)
        rp = solve(coo, b, device="cpu", fmt="pcell", tol=1e-5)
        rh = solve(coo, b, device="cpu", fmt="hell", tol=1e-5)
        assert bool(rp.converged) and rp.x.dtype == torch.complex64
        assert torch.equal(rp.x, rh.x) and rp.iterations == rh.iterations
        res = np.linalg.norm(b - coo.spmv(rp.x.numpy().astype(np.complex128)))
        assert res <= 1e-4 * np.linalg.norm(b)


def test_pcell_check_rejects_broken_layouts():
    a = coo_to_whell_percell(CASES["fem2000"](tfix), device="cpu", **SMALL)
    cg = a.chunk_group.clone()
    cg[-1] = 0
    with pytest.raises(ValueError, match="sentinel"):
        dataclasses.replace(a, chunk_group=cg).check()
    gb = a.group_bases.clone()
    gb[0] = a.x_pages
    with pytest.raises(ValueError, match="page range"):
        dataclasses.replace(a, group_bases=gb).check()


def test_f1_pcell_raises_past_the_group_field(monkeypatch):
    coo = CASES["fem2000"](tfix)
    a = coo_to_whell_percell(coo, device="cpu", **SMALL)
    n_groups = a.group_bases.numel() // 4
    monkeypatch.setattr(tconv, "_MAX_TILE_PAGE", n_groups - 1)
    with pytest.raises(ValueError, match="31-bit"):
        coo_to_whell_percell(coo, device="cpu", **SMALL)
    monkeypatch.setattr(twhell, "MAX_TILE_PAGE", n_groups - 1)
    with pytest.raises(ValueError, match="31-bit group"):
        a.check()


def test_cpu_path_counts_no_pcell_launches():
    a = coo_to_whell_percell(CASES["fem2000"](tfix), device="cpu", **SMALL)
    before = kp.LAUNCHES
    tops.whell_spmv(a, torch.ones(a.n_cols))
    assert kp.LAUNCHES == before


def spd_fem_1500():
    """The SPD FEM-like system of tests/test_torch_solvers.py."""
    coo0 = jfix.random_fem_like(1500, 10.0, span=120, far_frac=0.0, seed=12,
                                dtype=np.float32)
    d = coo0.to_dense()
    d = (d + d.T) / 2 + np.eye(1500) * (np.abs(d).sum(1).max() + 1)
    rows, cols = np.nonzero(d)
    return rows, cols, d[rows, cols].astype(np.float32), 1500


def test_solve_pcell_matches_jax(monkeypatch):
    """``solve(fmt="pcell")``: CG in the original numbering through the
    pcell SpMV, against the JAX route (its kernel in interpret mode)."""
    from spgpu_tpu_torch.solvers import auto

    rows, cols, vals, n = spd_fem_1500()
    b = np.random.default_rng(11).standard_normal(n).astype(np.float32)
    calls = []
    op = auto.whell_spmv
    monkeypatch.setattr(auto, "whell_spmv", lambda *a, **k: calls.append(1) or op(*a, **k))
    kw = dict(fmt="pcell", tol=1e-5, maxiter=3000)
    rj = j_solve(JCoo(rows, cols, vals, n, n), b, **kw)
    rt = solve(CooMatrix(rows, cols, vals, n, n), b, device="cpu", **kw)
    assert bool(rj.converged) and bool(rt.converged)
    assert abs(int(rj.iterations) - rt.iterations) <= 2
    assert len(calls) >= rt.iterations > 0
    xt, xj = rt.x.numpy().astype(np.float64), np.asarray(rj.x, np.float64)
    assert np.linalg.norm(xt - xj) <= 1e-4 * np.linalg.norm(xj)
    a = CooMatrix(rows, cols, vals, n, n)
    assert np.linalg.norm(b - a.spmv(xt)) <= 1e-4 * np.linalg.norm(b)
    # BiCGSTAB and Jacobi run the same route
    r2 = solve(CooMatrix(rows, cols, vals, n, n), b, device="cpu", symmetric=False,
               jacobi=True, **kw)
    assert bool(r2.converged)
    assert np.linalg.norm(b - a.spmv(r2.x.numpy().astype(np.float64))) \
        <= 1e-4 * np.linalg.norm(b)


# --------------------------------------------------------------------------
# kernel #17's seams: one warp scans a slot, each thread 4 lanes, so the
# card test's fixture must hold runs across thread groups' boundaries and
# at both ends of the lanes; and a tile count that is not a multiple of
# the kernel's 4 tiles per block

# the card test's pcell fixture "fem" (tests/test_torch_cuda.py) and its
# geometries there, with an odd chunk size for a tile count off the block
SEAM_FEM = lambda f: f.random_fem_like(4000, 16.0, span=256, far_frac=0.02,  # noqa: E731
                                       seed=5, dtype=np.float32)
SEAM_GEOMETRIES = {"default": {}, "small": SMALL,
                   "odd": dict(group_hacks=32, chunk_tiles=7)}


@pytest.mark.parametrize("geometry", sorted(SEAM_GEOMETRIES))
def test_pcell_fixture_has_warp_scan_seams(geometry):
    """Runs that cross a 32-lane boundary, and runs that end at lane 0
    and at lane 127."""
    a = coo_to_whell_percell(SEAM_FEM(tfix), device="cpu", **SEAM_GEOMETRIES[geometry])
    hi, lo = a.run_hi.long(), a.run_lo.long()
    run = hi >= 0
    first, last = lo[run] + 1, hi[run]
    assert bool((first >> 5 != last >> 5).any())
    assert bool((last == 0).any()) and bool((last == 127).any())
    assert geometry != "odd" or a.num_tiles % 4 != 0


def test_pcell_odd_chunk_tiles_matches_jax_and_golden():
    """The converter and the plain SpMV at 7-tile chunks (a tile count that
    is not a multiple of 4), against the JAX converter and the golden."""
    geo = SEAM_GEOMETRIES["odd"]
    ja = j_percell(SEAM_FEM(jfix), **geo)
    ta = coo_to_whell_percell(SEAM_FEM(tfix), device="cpu", **geo)
    assert_same_layout(ja, ta)
    ta.check()
    x = np.random.default_rng(6).standard_normal(4000).astype(np.float32)
    _near(tops.whell_spmv(ta, torch.from_numpy(x)).numpy(),
          SEAM_FEM(tfix).spmv(x.astype(np.float64)), 1e-5)
