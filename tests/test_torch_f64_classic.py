"""PyTorch port: float64 classic WHELL and float64 pcell against the JAX
package.

The JAX package keeps a float64 classic or pcell layout as one plain
float64 slab (no double-float pair) and runs its kernels #15, #16 and #17
on it in interpret mode.  The port's converters must build the same
arrays bit for bit on every classic and pcell fixture of
tests/test_torch_classic.py and tests/test_torch_pcell.py (with the OELL
order, ``row_perm``, ``ways``, the plan and the empty matrix), and its
products (the kernels' plain versions, on the CPU) must agree with the
JAX ops in interpret mode and with the float64 host golden within
1e-12·max|z|; ``whell_update_values`` refreshes a float64 classic plan
as the JAX one does, and ``solve(fmt="pcell")`` solves a float64 system
to 1e-10 within 2 iterations of the JAX route.  Complex classic and pcell
layouts raise in the port, and the JAX ops raise on the same COO (its
Pallas interpreter refuses a complex kernel output).  Each JAX
interpret-mode call compiles for seconds, so the JAX-compared cases are
few and at most 3 RHS.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu import ops as jops  # noqa: E402
from spgpu_tpu.convert.pcell import coo_to_whell_percell as j_percell  # noqa: E402
from spgpu_tpu.convert.whell import coo_to_whell as j_coo_to_whell  # noqa: E402
from spgpu_tpu.convert.whell import whell_update_values as j_update  # noqa: E402
from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.solvers import solve as j_solve  # noqa: E402
from spgpu_tpu.utils import fixtures as jfix  # noqa: E402
from spgpu_tpu_torch import ops as tops  # noqa: E402
from spgpu_tpu_torch.convert import (  # noqa: E402
    coo_to_whell,
    coo_to_whell_percell,
    whell_update_values,
)
from spgpu_tpu_torch.formats import whell as twhell  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.kernels import pcell as kp  # noqa: E402
from spgpu_tpu_torch.kernels import whell_classic as kc  # noqa: E402
from spgpu_tpu_torch.solvers import solve  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_classic import CASES as CLASSIC  # noqa: E402
from test_torch_classic import SPMM  # noqa: E402
from test_torch_classic import assert_same_layout as same_classic  # noqa: E402
from test_torch_classic import bridge as classic_bridge  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)
from test_torch_pcell import CASES as PCELL  # noqa: E402
from test_torch_pcell import SMALL, spd_fem_1500  # noqa: E402
from test_torch_pcell import assert_same_layout as same_pcell  # noqa: E402
from test_torch_pcell import bridge as pcell_bridge  # noqa: E402

#: products against the JAX ops and the golden: 1e-12 of max|z|
TIGHT = 1e-12


def f64(make):
    """A fixture maker of the float32 tables, in float64."""
    def build(f):
        c = make(f)
        return f.CooMatrix(c.rows, c.cols, c.values.astype(np.float64), c.n_rows,
                           c.n_cols)
    return build


def _near(z, want, frac=TIGHT):
    """max|z - want| ≤ frac·max|want|."""
    z, want = np.asarray(z), np.asarray(want)
    assert z.shape == want.shape and z.dtype == np.float64 == want.dtype
    assert np.abs(z - want).max() <= frac * np.abs(want).max()


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


# --------------------------------------------------------------------------
# the converters, bit for bit


@pytest.mark.parametrize("name", sorted(CLASSIC))
def test_f64_classic_converter_bit_identical(name):
    make = f64(CLASSIC[name])
    ja = j_coo_to_whell(make(jfix))
    ta = coo_to_whell(make(tfix), device="cpu", packed=False)
    assert ta.values.dtype == torch.float64 and getattr(ja, "values_lo", None) is None
    same_classic(ja, ta)
    ta.check()


@pytest.mark.parametrize("kw", [dict(sort_rows=True), dict(ways=2), dict(ways=4)],
                         ids=["sort_rows", "ways2", "ways4"])
@pytest.mark.parametrize("name", ["fem", "irregular", "rect"])
def test_f64_classic_converter_options_bit_identical(name, kw):
    make = f64(CLASSIC[name])
    ja = j_coo_to_whell(make(jfix), **kw)
    ta = coo_to_whell(make(tfix), device="cpu", packed=False, **kw)
    assert ta.values.dtype == torch.float64
    same_classic(ja, ta)
    ta.check()


def test_f64_classic_row_perm_and_plan_bit_identical():
    make = f64(CLASSIC["irregular"])
    perm = np.random.default_rng(4).permutation(1000).astype(np.int32)
    same_classic(j_coo_to_whell(make(jfix), row_perm=perm),
                 coo_to_whell(make(tfix), device="cpu", packed=False, row_perm=perm))
    for name in ("fem", "ctest"):
        ja, jplan = j_coo_to_whell(f64(CLASSIC[name])(jfix), return_plan=True)
        ta, tplan = coo_to_whell(f64(CLASSIC[name])(tfix), device="cpu",
                                 packed=False, return_plan=True)
        same_classic(ja, ta)
        for j, t in zip(jplan, tplan):
            np.testing.assert_array_equal(np.asarray(j), t)


@pytest.mark.parametrize("kw", [{}, dict(sort_rows=True), dict(ways=2)],
                         ids=["plain", "sort_rows", "ways2"])
def test_f64_classic_empty_matrix(kw):
    def empty(f):
        return f.CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0, np.float64), 300, 300)
    ta = coo_to_whell(empty(tfix), device="cpu", packed=False, **kw)
    same_classic(j_coo_to_whell(empty(jfix), **kw), ta)
    z = tops.whell_spmv(ta, torch.ones(300, dtype=torch.float64), beta=0.5,
                        y=torch.full((300,), 4.0, dtype=torch.float64))
    torch.testing.assert_close(z, torch.full((300,), 2.0, dtype=torch.float64),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(PCELL))
def test_f64_pcell_converter_bit_identical(name):
    make = f64(PCELL[name])
    ja = j_percell(make(jfix), **SMALL)
    ta = coo_to_whell_percell(make(tfix), device="cpu", **SMALL)
    assert ta.values.dtype == torch.float64
    same_pcell(ja, ta)
    ta.check()
    same_pcell(ja, pcell_bridge(ja))


def test_f64_pcell_default_geometry_duplicates_and_empty():
    make = f64(PCELL["fem2000"])
    same_pcell(j_percell(make(jfix)), coo_to_whell_percell(make(tfix), device="cpu"))
    rows, cols = np.array([0, 0, 1, 300]), np.array([5, 5, 2, 300])
    vals = np.array([1.5, 2.5, -1.0, 3.0])
    ta = coo_to_whell_percell(CooMatrix(rows, cols, vals, 400, 400), device="cpu",
                              **SMALL)
    same_pcell(j_percell(JCoo(rows, cols, vals, 400, 400), **SMALL), ta)
    z = tops.whell_spmv(ta, torch.ones(400, dtype=torch.float64))
    assert z.dtype == torch.float64
    assert (float(z[0]), float(z[1]), float(z[300])) == (4.0, -1.0, 3.0)
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))
    te = coo_to_whell_percell(CooMatrix(*empty, 256, 256), device="cpu", **SMALL)
    same_pcell(j_percell(JCoo(*empty, 256, 256), **SMALL), te)
    assert not tops.whell_spmv(te, torch.ones(256, dtype=torch.float64)).any()


# --------------------------------------------------------------------------
# products against the JAX ops (interpret mode) and the golden


@pytest.mark.parametrize("name,kw", [("fem", {}), ("rect", {}),
                                     ("fem", dict(sort_rows=True)),
                                     ("irregular", dict(ways=2))],
                         ids=["fem", "rect", "fem-oell", "irregular-ways2"])
def test_f64_classic_spmv_matches_jax_and_golden(name, kw):
    make = f64(CLASSIC[name])
    ja = j_coo_to_whell(make(jfix), **kw)
    ta = classic_bridge(ja)
    coo = make(tfix)
    rng = np.random.default_rng(1)
    x, y = _x(coo.n_cols, 2), rng.standard_normal(coo.n_rows)
    zj = np.asarray(jops.whell_spmv(ja, jnp.asarray(x), alpha=2.5, beta=-0.5,
                                    y=jnp.asarray(y), interpret=True))
    zt = tops.whell_spmv(ta, torch.from_numpy(x), alpha=2.5, beta=-0.5,
                         y=torch.from_numpy(y))
    assert zt.shape == (coo.n_rows,) and zt.dtype == torch.float64
    _near(zt.numpy(), zj)
    _near(zt.numpy(), 2.5 * coo.spmv(x) - 0.5 * y)
    # the port's own conversion, no epilogue
    a = coo_to_whell(coo, device="cpu", packed=False, **kw)
    _near(tops.whell_spmv(a, torch.from_numpy(x)).numpy(), coo.spmv(x))


@pytest.mark.parametrize("fused", [None, True], ids=["loop", "fused"])
def test_f64_classic_spmm_matches_jax_and_golden(fused, monkeypatch):
    """The default loops #15 per RHS and ``fused=True`` runs #16, as the
    JAX dispatch does on a classic float64 layout (it is not ``is_dd``)."""
    make = f64(SPMM["fem2000"])
    ja = j_coo_to_whell(make(jfix), ways=2)
    ta = classic_bridge(ja)
    coo = make(tfix)
    rng = np.random.default_rng(4)
    X, Y = rng.standard_normal((3, coo.n_cols)), rng.standard_normal((3, coo.n_rows))
    calls = {name: [] for name in ("whell_classic_spmv", "whell_classic_spmm")}
    for name, got in calls.items():
        fn = getattr(kc, name)
        monkeypatch.setattr(kc, name, lambda *a, _f=fn, _g=got, **k: _g.append(1)
                            or _f(*a, **k))
    zj = np.asarray(jops.whell_spmm(ja, jnp.asarray(X), alpha=1.5, beta=-2.0,
                                    y=jnp.asarray(Y), fused=fused, interpret=True))
    zt = tops.whell_spmm(ta, torch.from_numpy(X), alpha=1.5, beta=-2.0,
                         y=torch.from_numpy(Y), fused=fused)
    assert (len(calls["whell_classic_spmm"]), len(calls["whell_classic_spmv"])) == \
        ((1, 0) if fused else (0, 3))
    assert zt.shape == (3, coo.n_rows) and zt.dtype == torch.float64
    _near(zt.numpy(), zj)
    _near(zt.numpy(), 1.5 * coo.spmv(X) - 2.0 * Y)


@pytest.mark.parametrize("n_rhs", [1, 8, 17])
def test_f64_classic_fused_plain_matches_loop(n_rhs):
    coo = f64(SPMM["fem3000"])(tfix)
    a = coo_to_whell(coo, device="cpu", packed=False, sort_rows=True)
    X = torch.from_numpy(np.random.default_rng(n_rhs).standard_normal((n_rhs, 3000)))
    z = tops.whell_spmm(a, X, fused=True)
    loop = tops.whell_spmm(a, X)
    torch.testing.assert_close(z, loop, rtol=0, atol=TIGHT * float(loop.abs().max()))
    _near(z.numpy(), coo.spmv(X.numpy()))


def test_f64_pcell_spmv_matches_jax_and_golden():
    make = f64(PCELL["fem2000"])
    ja = j_percell(make(jfix), **SMALL)
    ta = pcell_bridge(ja)
    coo = make(tfix)
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal(2000), rng.standard_normal(2000)
    zj = np.asarray(jops.whell_spmv(ja, jnp.asarray(x), alpha=2.0, beta=-0.5,
                                    y=jnp.asarray(y), interpret=True))
    zt = tops.whell_spmv(ta, torch.from_numpy(x), alpha=2.0, beta=-0.5,
                         y=torch.from_numpy(y))
    assert zt.dtype == torch.float64
    _near(zt.numpy(), zj)
    _near(zt.numpy(), 2.0 * coo.spmv(x) - 0.5 * y)


@pytest.mark.parametrize("name", ["laplace", "irregular", "rect", "ctest"])
def test_f64_pcell_spmv_matches_golden(name):
    coo = f64(PCELL[name])(tfix)
    x = _x(coo.n_cols, 2)
    for geometry in (SMALL, {}):
        a = coo_to_whell_percell(coo, device="cpu", **geometry)
        _near(tops.whell_spmv(a, torch.from_numpy(x)).numpy(), coo.spmv(x))
    with pytest.raises(NotImplementedError, match="fused SpMM"):
        tops.whell_spmm(a, torch.ones((2, coo.n_cols), dtype=torch.float64),
                        fused=True)


def test_f64_update_values_classic_plan_matches_jax():
    make = lambda f: f.random_fem_like(2000, 10.0, span=150,  # noqa: E731
                                       far_frac=0.02, seed=11, dtype=np.float64)
    ja, jplan = j_coo_to_whell(make(jfix), return_plan=True)
    ta, tplan = coo_to_whell(make(tfix), device="cpu", packed=False, return_plan=True)
    newv = np.random.default_rng(3).standard_normal(ta.nnz)
    newv[::5] = 0  # the work list shrinks
    ja2, ta2 = j_update(ja, jplan, newv), whell_update_values(ta, tplan, newv)
    assert ta2.values.dtype == torch.float64
    same_classic(ja2, ta2)
    assert ta2.work_list.numel() < ta.work_list.numel()
    ta2.check()
    coo = make(tfix)
    x = _x(2000, 5)
    _near(tops.whell_spmv(ta2, torch.from_numpy(x)).numpy(),
          CooMatrix(coo.rows, coo.cols, newv, 2000, 2000).spmv(x))


def test_f64_solve_pcell_matches_jax():
    """``solve(fmt="pcell")`` in float64 to 1e-10: CG on the float64 pcell
    layout, against the JAX route (its kernel in interpret mode)."""
    rows, cols, vals, n = spd_fem_1500()
    vals = vals.astype(np.float64)
    b = np.random.default_rng(11).standard_normal(n)
    kw = dict(fmt="pcell", tol=1e-10, maxiter=3000)
    rj = j_solve(JCoo(rows, cols, vals, n, n), b, **kw)
    a = CooMatrix(rows, cols, vals, n, n)
    rt = solve(a, b, device="cpu", **kw)
    assert bool(rj.converged) and bool(rt.converged)
    assert rt.x.dtype == torch.float64
    assert abs(int(rj.iterations) - rt.iterations) <= 2
    xt, xj = rt.x.numpy(), np.asarray(rj.x, np.float64)
    assert np.linalg.norm(xt - xj) <= 1e-8 * np.linalg.norm(xj)
    assert np.linalg.norm(b - a.spmv(xt)) <= 1e-9 * np.linalg.norm(b)


# --------------------------------------------------------------------------
# the types: the kernels' operand pairs, complex refused in both packages


def test_f64_kernel_operand_types():
    """float64 values take a float64 x; fp32 and bf16 values an fp32 x; no
    other pairing."""
    coo = f64(CLASSIC["laplace"])(tfix)
    a = coo_to_whell(coo, device="cpu", packed=False)
    layout = (a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group)
    for dt, ok in ((torch.float64, True), (torch.float32, False)):
        x2 = torch.zeros((a.x_pages, 128), dtype=dt)
        call = lambda: kc.whell_classic_spmv(*layout, x2,  # noqa: E731
                                             num_groups=a.num_groups,
                                             tile_page=a.tile_page)
        if ok:
            assert call().dtype == torch.float64
        else:
            with pytest.raises(ValueError, match="float64 for torch.float64 values"):
                call()
    a32 = coo_to_whell(CLASSIC["laplace"](tfix), device="cpu", packed=False)
    with pytest.raises(ValueError, match="float32"):
        tops.whell_spmv(a32, torch.zeros(a32.n_cols, dtype=torch.float64))
    p = coo_to_whell_percell(coo, device="cpu", **SMALL)
    with pytest.raises(ValueError, match="values' type"):
        tops.whell_spmv(p, torch.zeros(p.n_cols, dtype=torch.float32))
    # a packed float64 layout still has no fused SpMM, as in the JAX package
    pk = coo_to_whell(coo, device="cpu")
    with pytest.raises(NotImplementedError, match="fused SpMM"):
        tops.whell_spmm(pk, torch.zeros((2, pk.n_cols), dtype=torch.float64),
                        fused=True)


def test_f64_cpu_path_counts_no_launches():
    coo = f64(CLASSIC["fem"])(tfix)
    a = coo_to_whell(coo, device="cpu", packed=False)
    p = coo_to_whell_percell(coo, device="cpu", **SMALL)
    before = (kc.LAUNCHES_F64, kc.LAUNCHES_SPMM_F64, kp.LAUNCHES_F64)
    x = torch.ones(coo.n_cols, dtype=torch.float64)
    tops.whell_spmv(a, x)
    tops.whell_spmm(a, x.repeat(2, 1), fused=True)
    tops.whell_spmv(p, x)
    assert (kc.LAUNCHES_F64, kc.LAUNCHES_SPMM_F64, kp.LAUNCHES_F64) == before


@pytest.mark.parametrize("dt", [np.complex64, np.complex128])
def test_complex_classic_and_pcell_raise_in_both_packages(dt):
    """The JAX converters build complex classic and pcell slabs, but the
    JAX ops raise on them (the Pallas interpreter refuses the kernel's
    complex output); the port refuses at conversion, and its bridges
    refuse the JAX layouts."""
    c = CLASSIC["irregular"]
    jc, tc = c(jfix), c(tfix)
    j = JCoo(jc.rows, jc.cols, jc.values.astype(dt), jc.n_rows, jc.n_cols)
    t = CooMatrix(tc.rows, tc.cols, tc.values.astype(dt), tc.n_rows, tc.n_cols)
    x = jnp.asarray(np.ones(jc.n_cols, dt))
    ja, jp = j_coo_to_whell(j), j_percell(j, **SMALL)
    for layout in (ja, jp):
        with pytest.raises(NotImplementedError):
            jops.whell_spmv(layout, x, interpret=True)
    with pytest.raises(NotImplementedError, match="no complex classic WHELL product"):
        coo_to_whell(t, device="cpu", packed=False)
    with pytest.raises(NotImplementedError, match="no complex pcell product"):
        coo_to_whell_percell(t, device="cpu")
    with pytest.raises(NotImplementedError, match="no complex classic WHELL product"):
        classic_bridge(ja)
    with pytest.raises(NotImplementedError, match="no complex pcell product"):
        twhell.from_numpy_pcell({f: np.asarray(getattr(jp, f)) for f in
                                 ("values", "residue", "page_tab", "run_hi", "run_lo",
                                  "tile_base", "chunk_group", "group_bases")},
                                **{f: getattr(jp, f) for f in
                                   ("n_rows", "n_cols", "num_hacks", "num_groups",
                                    "total_slots", "nnz", "x_pages", "window_pages",
                                    "group_hacks", "chunk_tiles")})
