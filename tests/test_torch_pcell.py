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


# --------------------------------------------------------------------------
# kernel #17's hack lists: each output hack's tiles that route a run, in
# ascending tile order, and the work units over them (a hack past
# PCELL_CHUNK_TILES listed tiles in chunks); the kernel sums each hack's
# tiles in registers in one fixed order and stores its 128 lanes once

def hub(f, n=1500, per_row=200, seed=4):
    """128 hub rows (hack 0) of ``per_row`` entries each beside a sparse
    rest: hack 0 lists more tiles than one work unit takes, so its sums
    come in chunks."""
    rng = np.random.default_rng(seed)
    hr = np.repeat(np.arange(128), per_row)
    hc = rng.integers(0, n, hr.size)
    rest = f.random_irregular(n, n, 4.0, seed=seed, dtype=np.float32)
    return f.CooMatrix(np.r_[hr, rest.rows], np.r_[hc, rest.cols],
                       np.r_[rng.standard_normal(hr.size).astype(np.float32),
                             rest.values], n, n)


LIST_CASES = dict(CASES, hub=hub)


def _np_hack_lists(a):
    """``hack_tile_ptr`` and ``hack_tiles`` by a direct NumPy derivation."""
    T = a.num_tiles
    live = np.flatnonzero((a.run_hi.numpy().reshape(T, -1) >= 0).any(axis=1))
    hack = (a.chunk_group.numpy()[live // a.chunk_tiles].astype(np.int64)
            * a.group_hacks + (a.tile_base.numpy()[live].astype(np.int64) >> 20))
    per = [live[hack == h] for h in range(a.num_groups * a.group_hacks)]
    return np.r_[0, np.cumsum([p.size for p in per])], np.concatenate(per)


@pytest.mark.parametrize("geometry", ["small", "default"])
@pytest.mark.parametrize("name", sorted(LIST_CASES))
def test_pcell_hack_lists_match_numpy(name, geometry):
    """The lists against a NumPy derivation; every tile that routes a run
    is listed exactly once, under its own hack, and no other tile is; the
    units cover each hack's list in chunks of at most PCELL_CHUNK_TILES."""
    a = coo_to_whell_percell(LIST_CASES[name](tfix), device="cpu",
                             **(SMALL if geometry == "small" else {}))
    ptr, tiles = _np_hack_lists(a)
    np.testing.assert_array_equal(a.hack_tile_ptr.numpy(), ptr)
    np.testing.assert_array_equal(a.hack_tiles.numpy(), tiles)
    assert a.hack_tiles.dtype == a.hack_units.dtype == torch.int32
    routes = (a.run_hi.view(a.num_tiles, -1) >= 0).any(dim=1)
    listed = torch.zeros(a.num_tiles, dtype=torch.long)
    listed.index_add_(0, a.hack_tiles.long(), torch.ones(a.hack_tiles.numel(),
                                                         dtype=torch.long))
    assert torch.equal(listed, routes.long())
    u = a.hack_units.long()
    assert bool(((u[:, 1] - u[:, 0]) <= twhell.PCELL_CHUNK_TILES).all())
    rows = a.num_groups * a.group_hacks
    assert torch.equal(torch.unique(u[:, 2]), torch.arange(rows))
    assert (u.shape[0] > rows) == (name == "hub")
    a.check()


def test_pcell_hack_lists_are_rebuilt():
    """``.to()``, ``dataclasses.replace`` and the JAX bridge derive new
    lists; a replaced ``run_hi`` that routes a run in an unlisted tile
    lists it."""
    a = coo_to_whell_percell(CASES["fem2000"](tfix), device="cpu", **SMALL)
    b = a.to("cpu")
    assert b.hack_tiles is not a.hack_tiles
    for f in ("hack_tile_ptr", "hack_tiles", "hack_units"):
        assert torch.equal(getattr(b, f), getattr(a, f))
    free = sorted(set(range(a.num_tiles)) - set(a.hack_tiles.tolist()))
    assert free, "the small geometry pads its chunks"
    hi = a.run_hi.clone()
    hi[free[0] * 8, 3] = 5
    c = dataclasses.replace(a, run_hi=hi)
    assert c.hack_tiles.numel() == a.hack_tiles.numel() + 1
    assert free[0] in c.hack_tiles.tolist()
    ptr, tiles = _np_hack_lists(c)
    np.testing.assert_array_equal(c.hack_tiles.numpy(), tiles)
    d = bridge(j_percell(CASES["fem2000"](jfix), **SMALL))
    assert torch.equal(d.hack_tiles, a.hack_tiles)
    assert torch.equal(d.hack_units, a.hack_units)


def test_pcell_check_rejects_stale_hack_lists():
    """A layout changed in place after its lists were built: a run routed
    in an unlisted tile, or a list edited by hand."""
    a = coo_to_whell_percell(CASES["fem2000"](tfix), device="cpu", **SMALL)
    a.check()
    free = sorted(set(range(a.num_tiles)) - set(a.hack_tiles.tolist()))
    a.run_hi[free[0] * 8, 3] = 5
    with pytest.raises(ValueError, match="hack_tile"):
        a.check()
    b = coo_to_whell_percell(CASES["fem2000"](tfix), device="cpu", **SMALL)
    b.hack_tiles = b.hack_tiles.flip(0).contiguous()
    with pytest.raises(ValueError, match="hack_tile"):
        b.check()
    c = coo_to_whell_percell(CASES["fem2000"](tfix), device="cpu", **SMALL)
    c.hack_units = c.hack_units[:-1]
    with pytest.raises(ValueError, match="hack_units"):
        c.check()


def test_pcell_wrapper_needs_the_hack_lists_on_cuda_only():
    """On a CUDA device the wrapper needs ``hack_tiles`` and
    ``hack_units`` (raises without); the CPU path takes them or not."""
    a = coo_to_whell_percell(CASES["fem2000"](tfix), device="cpu", **SMALL)
    rows = a.num_groups * a.group_hacks
    with pytest.raises(ValueError, match="hack lists"):
        kp._check_lists(None, a.hack_units, rows, torch.device("cuda"))
    with pytest.raises(ValueError, match="bad hack_tiles"):
        kp._check_lists(a.hack_tiles.long(), a.hack_units, rows, torch.device("cpu"))
    with pytest.raises(ValueError, match="bad hack_tiles"):
        kp._check_lists(a.hack_tiles, a.hack_units[:rows - 1], rows, torch.device("cpu"))
    args = (a.values, a.residue, a.page_tab, a.run_hi, a.run_lo, a.tile_base,
            a.chunk_group, a.group_bases,
            tops._prep_x(torch.ones(a.n_cols), a.n_cols, a.x_pages))
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  window_pages=a.window_pages, num_groups=a.num_groups,
                  tile_page=a.tile_page)
    assert torch.equal(kp.pcell_spmv(*args, **static),
                       kp.pcell_spmv(*args, **static, hack_tiles=a.hack_tiles,
                                     hack_units=a.hack_units))


def _routed(a, x2):
    """Each slot's routed sums ``(num_tiles, 8, 128)``, in the plain
    version's arithmetic (the lane scan, differenced at the run bounds)."""
    res = a.residue.long()
    d = torch.gather(a.page_tab.long(), 1, res)
    tile = torch.arange(a.total_slots) // 8
    K = a.window_pages // 8
    page = a.group_bases.long()[a.tile_page.long()[tile, None] * K + (d >> 3)] + (d & 7)
    scan = (a.values * x2.reshape(-1)[page * 128 + res]).cumsum(dim=1)
    hi, lo = a.run_hi.long(), a.run_lo.long()
    routed = (torch.where(hi >= 0, torch.gather(scan, 1, hi.clamp(min=0)), 0.0)
              - torch.where(lo >= 0, torch.gather(scan, 1, lo.clamp(min=0)), 0.0))
    return routed.view(a.num_tiles, 8, 128)


def hack_schedule(a, x2, warps=2):
    """Kernel #17's schedule on the CPU: per work unit, warp ``w`` adds
    the routed slots of listed tiles ``begin + w, begin + w + warps, ...``
    in order into its sums; the unit adds its warps' sums in warp order; a
    chunked row adds its chunks' sums in chunk order; every row is stored
    once into a NaN-filled z."""
    routed = _routed(a, x2)
    z = torch.full((a.num_groups * a.group_hacks, 128), float("nan"),
                   dtype=a.values.dtype)
    part = {}
    for u, (b, e, row, chunk) in enumerate(a.hack_units.tolist()):
        acc = [torch.zeros(128, dtype=a.values.dtype) for _ in range(warps)]
        for w in range(warps):
            for q in range(b + w, e, warps):
                for s in range(8):
                    acc[w] = acc[w] + routed[int(a.hack_tiles[q]), s]
        total = acc[0]
        for w in range(1, warps):
            total = total + acc[w]
        if chunk >= 0:
            c, k = chunk >> 16, chunk & 0xFFFF
            part[u] = total
            if c < k - 1:
                continue
            total = part[u - c]
            for i in range(1, k):
                total = total + part[u - c + i]
        z[row] = total
    return z


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["hub", "fem2000", "rect"])
def test_pcell_hack_schedule_matches_plain(name, dtype):
    """The new schedule (each hack's routed tiles summed in list order, a
    hub hack in chunks) writes every row and equals the plain version:
    fp32 within 2e-5·max|z|, float64 within 1e-12·max|z|."""
    coo = LIST_CASES[name](tfix)
    for geometry in (SMALL, {}):
        a = coo_to_whell_percell(coo, device="cpu", dtype=dtype, **geometry)
        x = np.random.default_rng(9).standard_normal(a.x_pages * 128)
        x2 = torch.from_numpy(x).to(a.values.dtype).view(a.x_pages, 128)
        z = hack_schedule(a, x2)
        assert not bool(z.isnan().any())
        plain = kp.pcell_spmv_plain(
            a.values, a.residue, a.page_tab, a.run_hi, a.run_lo, a.tile_base,
            a.chunk_group, a.group_bases, x2, chunk_tiles=a.chunk_tiles,
            group_hacks=a.group_hacks, window_pages=a.window_pages,
            num_groups=a.num_groups, tile_page=a.tile_page)
        _near(z.numpy(), plain.numpy(), 2e-5 if dtype == "float32" else 1e-12)


def test_pcell_hack_schedule_on_a_hub_matches_jax():
    """The hub fixture's chunked hack through the schedule, against the
    JAX ``_pcell_kernel`` (interpret mode, through the bridge) within
    3e-5·max|z| and the golden."""
    ja = j_percell(hub(jfix), **SMALL)
    ta = bridge(ja)
    assert ta.hack_units.shape[0] > ta.num_groups * ta.group_hacks
    x = np.random.default_rng(10).standard_normal(ta.n_cols).astype(np.float32)
    x2 = tops._prep_x(torch.from_numpy(x), ta.n_cols, ta.x_pages)
    z = hack_schedule(ta, x2).view(-1)[: ta.n_rows].numpy()
    _near(z, np.asarray(jops.whell_spmv(ja, jnp.asarray(x), interpret=True)), 3e-5)
    _near(z, hub(tfix).spmv(x.astype(np.float64)), 3e-5)


@pytest.mark.parametrize("design", ["pcell", "classic", "classic_spmm"])
def test_kernel_account_edits_apply_to_the_sources(design):
    """``sweeps.kernel_account``'s variants of #17, #15 and #16 are edits of
    the production sources: each edit finds its text exactly once, so the
    account still builds what it names; the account runs on a card only."""
    from spgpu_tpu_torch.kernels import whell_classic as kc
    from spgpu_tpu_torch.sweeps import kernel_account as ka

    with open(kp.SOURCE if design == "pcell" else kc.SOURCE) as f:
        text = f.read()
    variants = ka.DESIGNS[design]["variants"]
    assert next(iter(variants)) == "production"
    for name, (_, edits, _) in variants.items():
        out = ka.apply_edits(text, edits)
        assert (out == text) == (not edits), name
    with pytest.raises(ValueError, match="exactly|matches 0"):
        ka.apply_edits(text, [("no such text", "")])
    with pytest.raises(ValueError, match="card"):
        ka.run("cpu", design=design)


def test_loop_trace_splits_replays_on_their_flag_reads():
    """``sweeps.loop_trace`` cuts a profiled run's device events at each
    replay's flag copy: the eager window and a window of another length
    are left out, and the per-step medians count each operation, its
    time, the gaps inside a replay and the gap before it; the trace runs
    on a card only."""
    from spgpu_tpu_torch.sweeps import loop_trace as lt

    ev = [("eager", 0.0, 5.0), ("Memcpy DtoH (Device -> Pageable)", 5.0, 6.0)]
    t = 100.0
    for r in range(4):
        for _ in range(4 if r != 2 else 3):  # replay 2 lost an event
            ev += [("pcell_hack_pass", t, t + 80.0), ("Memset", t + 82.0, t + 84.0)]
            t += 85.0
        ev.append(("Memcpy DtoH (Device -> Pinned)", t, t + 1.0))
        t += 11.0
    got = lt.replay_windows(ev[::-1], 4)
    assert got["replays"] == 3
    assert got["ops_per_step"] == 9 / 4
    assert got["busy_us_per_step"] == (4 * 82.0 + 1.0) / 4
    assert got["inner_gap_us_per_step"] == (4 * 3.0) / 4
    assert got["gap_before_us_per_step"] == 10.0 / 4
    assert got["by_name_per_step"]["pcell_hack_pass"] == dict(count=1.0, us=80.0)
    assert got["by_name_per_step"]["Memset"] == dict(count=1.0, us=2.0)
    assert lt.replay_windows([], 4) == dict(replays=0)
    with pytest.raises(ValueError, match="card"):
        lt.run("cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64])
def test_spd_from_is_hermitian_and_dominant(dtype):
    """``fixtures.spd_from``: (A + Aᴴ)/2 off the diagonal, each diagonal
    entry its row's off-diagonal |·|-sum + 1, in ``dtype``."""
    coo = tfix.random_fem_like(300, 9.0, span=40, far_frac=0.05, seed=4)
    if np.dtype(dtype).kind == "c":
        coo = CooMatrix(coo.rows, coo.cols, coo.values * (1 + 0.5j), 300, 300)
    dense = np.zeros((300, 300), np.complex128)
    np.add.at(dense, (coo.rows, coo.cols), coo.values)
    s = tfix.spd_from(coo, dtype)
    assert s.values.dtype == dtype
    got = np.zeros((300, 300), np.complex128)
    np.add.at(got, (s.rows, s.cols), s.values)
    want = (dense + dense.conj().T) / 2
    off = ~np.eye(300, dtype=bool)
    np.fill_diagonal(want, np.where(off, np.abs(want), 0).sum(axis=1) + 1)
    tol = 1e-6 if dtype in (np.float32, np.complex64) else 1e-12
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
