"""PyTorch port, float64 (D precision) against the JAX double-float path.

The JAX package runs float64 as double-float pairs of fp32 (``values`` hi
and ``values_lo`` lo, ``ops.dd``); the port runs native float64.  So:

* the float64 converters build the JAX double-float layouts' structural
  arrays bit for bit, and values equal to the COO's float64 ones, which
  ``dd.split`` turns into exactly the JAX hi/lo pair (within 2^-47
  relative of ``hi + lo``);
* the float64 SpMVs (plain versions of kernels #4-#6 on CPU tensors)
  agree with the JAX ``*_spmv_dd_pallas`` kernels in interpret mode
  (``dd.split(x)`` in, ``dd.join(z)`` out) and with the host float64
  golden, both to 1e-12·max|z| (the pair keeps ~48 bits), alpha/beta/y
  included;
* the float64 ``solve()`` agrees with the JAX ``solve()`` (``cg_dd`` /
  ``bicgstab_dd``): iteration counts within 2, x within 1e-8 relative,
  true residual ≤ 1e-9.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu import ops as jops  # noqa: E402
from spgpu_tpu.convert import estimate_formats as j_estimate  # noqa: E402
from spgpu_tpu.convert import suggest_format as j_suggest  # noqa: E402
from spgpu_tpu.convert.sdia import coo_to_sdia as j_coo_to_sdia  # noqa: E402
from spgpu_tpu.convert.whdia import coo_to_whdia as j_coo_to_whdia  # noqa: E402
from spgpu_tpu.convert.whell import coo_to_whell as j_coo_to_whell  # noqa: E402
from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.ops import dd  # noqa: E402
from spgpu_tpu.solvers import solve as j_solve  # noqa: E402
from spgpu_tpu.utils import fixtures as jfix  # noqa: E402
from spgpu_tpu_torch import ops as tops  # noqa: E402
from spgpu_tpu_torch.convert import (  # noqa: E402
    coo_to_sdia,
    coo_to_whdia,
    coo_to_whell,
    estimate_formats,
    suggest_format,
)
from spgpu_tpu_torch.formats import dia as tdia  # noqa: E402
from spgpu_tpu_torch.formats import whdia as twhdia  # noqa: E402
from spgpu_tpu_torch.formats import whell as twhell  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.kernels import sdia as ks  # noqa: E402
from spgpu_tpu_torch.kernels import whdia as kd  # noqa: E402
from spgpu_tpu_torch.kernels import whell as kw  # noqa: E402
from spgpu_tpu_torch.ops import blas1 as tb  # noqa: E402
from spgpu_tpu_torch.solvers import solve  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)

F64 = np.float64


def _empty(f, n=300):
    return f.CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64),
                       np.zeros(0, F64), n, n)


# the float32 fixtures of tests/test_torch_convert.py, test_torch_sdia.py
# and test_torch_whdia.py, in float64
WHELL_CASES = {
    "fem": lambda f: f.random_fem_like(4000, 16.0, span=256, far_frac=0.02,
                                       seed=5, dtype=F64),
    "laplace": lambda f: f.laplacian_2d(23, 31, F64),
    "irregular": lambda f: f.random_irregular(1000, 1000, 9.0, seed=3, dtype=F64),
    "banded": lambda f: f.random_banded(900, bands=7, wander=13, seed=4, dtype=F64),
    "ctest": lambda f: f.ctest_fixture(F64),
    "empty": _empty,
}
DIA_CASES = {
    "laplace": lambda f: f.laplacian_2d(40, 40, dtype=F64),
    "laplace3d": lambda f: f.laplacian_3d(12, 11, 9, F64),
    "banded": lambda f: f.random_banded(900, bands=7, wander=13, seed=4, dtype=F64),
    "banded_wide": lambda f: f.random_banded(2000, bands=31, wander=0, seed=5,
                                             dtype=F64),
    "tall": lambda f: f.random_irregular(700, 90, avg_nnz_per_row=4.0, seed=3,
                                         dtype=F64),
    "empty": lambda f: _empty(f, 200),
}
SPMV_DIA = ("laplace", "banded", "empty")

WHELL_ARRAYS = ("residue", "page_tab", "tile_base", "chunk_group", "seg_lo",
                "seg_hi", "lane_of_row", "group_bases")
WHELL_STATIC = ("n_rows", "n_cols", "num_hacks", "num_groups", "total_slots",
                "nnz", "x_pages", "window_pages", "orig_rows", "group_hacks",
                "chunk_tiles", "unit_segments")
WHDIA_STATIC = ("n_rows", "n_cols", "num_hacks", "num_groups", "total_slots",
                "nnz", "x_pages", "window_pages", "group_hacks", "chunk_tiles")


def near(z, want, what=""):
    """|z - want| ≤ 1e-12·max|want|: float64 against a double-float pair
    (~48 bits) or the float64 golden."""
    z, want = np.asarray(z, F64), np.asarray(want, F64)
    assert z.shape == want.shape, what
    scale = max(np.abs(want).max(initial=0.0), 1e-300)
    np.testing.assert_allclose(z, want, rtol=0, atol=1e-12 * scale, err_msg=what)


def assert_splits_into(values64, hi, lo):
    """The port's float64 values split into exactly the JAX pair, and lie
    within 2^-47 relative of ``hi + lo``."""
    v = np.asarray(values64)
    assert v.dtype == F64
    pair = dd.split(v)
    np.testing.assert_array_equal(pair[0], np.asarray(hi))
    np.testing.assert_array_equal(pair[1], np.asarray(lo))
    joined = dd.join(np.stack([np.asarray(hi), np.asarray(lo)]))
    assert (np.abs(v - joined) <= np.abs(v) * 2.0 ** -47).all()


def last_write(coo):
    """The COO with duplicates resolved as the DIA class stores them."""
    d = {}
    for r, c, v in zip(coo.rows.tolist(), coo.cols.tolist(), coo.values.tolist()):
        d[(r, c)] = v
    rc = np.array(list(d), np.int64).reshape(-1, 2)
    return CooMatrix(rc[:, 0], rc[:, 1], np.array(list(d.values()), F64),
                     coo.n_rows, coo.n_cols)


# --------------------------------------------------------------------------
# converters


@pytest.mark.parametrize("name", sorted(WHELL_CASES))
def test_whell_converter_matches_dd_layout(name):
    ja = j_coo_to_whell(WHELL_CASES[name](jfix), packed=True)
    coo = WHELL_CASES[name](tfix)
    ta = coo_to_whell(coo, device="cpu")
    assert ja.is_dd and ta.values.dtype == torch.float64
    for f in WHELL_ARRAYS:
        jv, tv = getattr(ja, f), getattr(ta, f)
        assert (jv is None) == (tv is None), f
        if jv is not None:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=f)
    for f in WHELL_STATIC:
        assert getattr(ja, f) == getattr(ta, f), f
    assert_splits_into(ta.values.numpy(), ja.values, ja.values_lo)
    # the cells hold the COO's values, exactly (duplicates stay separate)
    v = ta.values.numpy()
    np.testing.assert_array_equal(np.sort(v[v != 0]),
                                  np.sort(coo.values[coo.values != 0]))


@pytest.mark.parametrize("name", sorted(DIA_CASES))
def test_sdia_converter_matches_dd_layout(name):
    ja = j_coo_to_sdia(DIA_CASES[name](jfix))
    coo = DIA_CASES[name](tfix)
    ta = coo_to_sdia(coo, device="cpu")
    assert ja.is_dd and ta.values.dtype == torch.float64
    assert ta.offsets == ja.offsets and ta.values.shape == ja.values.shape
    assert_splits_into(ta.values.numpy(), ja.values, ja.values_lo)
    ta.check()
    np.testing.assert_array_equal(ta.to_dense(), last_write(coo).to_dense())


@pytest.mark.parametrize("name", sorted(DIA_CASES))
def test_whdia_converter_matches_dd_layout(name):
    """Structure and r0 as the JAX double-float layout; where every tile's
    r0 is an arithmetic progression the port packs it per tile (pattern
    mode), which the JAX double-float kernel does not."""
    ja = j_coo_to_whdia(DIA_CASES[name](jfix))
    coo = DIA_CASES[name](tfix)
    ta = coo_to_whdia(coo, device="cpu")
    assert ja.is_dd and ja.tile_r0 is None and ta.values.dtype == torch.float64
    for f in ("tile_base", "chunk_group"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    for f in WHDIA_STATIC:
        assert getattr(ja, f) == getattr(ta, f), f
    r0t, r0j = ta.slot_r0_host(), ja.slot_r0_host()
    if ta.pattern_mode:  # dead slots (all-zero cells) repeat the last r0
        live = (np.asarray(ja.values) != 0).any(axis=1)
        r0t, r0j = r0t[live], r0j[live]
    np.testing.assert_array_equal(r0t, r0j)
    fp32 = coo_to_whdia(CooMatrix(coo.rows, coo.cols, coo.values.astype(np.float32),
                                  coo.n_rows, coo.n_cols), device="cpu")
    assert ta.pattern_mode == fp32.pattern_mode
    assert_splits_into(ta.values.numpy(), ja.values, ja.values_lo)
    ta.check()
    np.testing.assert_array_equal(ta.to_dense(), last_write(coo).to_dense())


def test_whdia_f64_r0_modes():
    band = coo_to_whdia(DIA_CASES["banded_wide"](tfix), device="cpu")
    lap = coo_to_whdia(DIA_CASES["laplace"](tfix), device="cpu")
    assert band.pattern_mode and not lap.pattern_mode


@pytest.mark.parametrize("layout", ["whell", "sdia", "whdia"])
def test_bridge_joins_double_float(layout):
    """A JAX double-float layout crosses the bridge as float64 hi + lo."""
    coo = jfix.laplacian_2d(20, 16, F64)
    if layout == "whell":
        ja = j_coo_to_whell(coo, packed=True)
        ta = twhell.from_numpy_fields(
            {f: None if getattr(ja, f) is None else np.asarray(getattr(ja, f))
             for f in WHELL_ARRAYS + ("values", "values_lo")},
            **{f: getattr(ja, f) for f in WHELL_STATIC})
    elif layout == "sdia":
        ja = j_coo_to_sdia(coo)
        ta = tdia.from_numpy_fields(np.asarray(ja.values), ja.offsets, ja.n_rows,
                                    ja.n_cols, values_lo=np.asarray(ja.values_lo))
    else:
        ja = j_coo_to_whdia(coo)
        ta = twhdia.from_numpy_fields(
            {f: None if getattr(ja, f) is None else np.asarray(getattr(ja, f))
             for f in ("values", "values_lo", "slot_r0", "tile_r0", "tile_base",
                       "chunk_group")},
            **{f: getattr(ja, f) for f in WHDIA_STATIC})
    want = np.asarray(ja.values, F64) + np.asarray(ja.values_lo, F64)
    assert ta.values.dtype == torch.float64
    np.testing.assert_array_equal(ta.values.numpy(), want)


def test_embed_extract_stay_float64():
    """``embed``/``extract`` with ``dtype=torch.float64`` keep every bit
    (the JAX ``embed`` builds in the input's dtype and, with x64 off,
    truncates a float64 input to fp32)."""
    a = coo_to_whell(WHELL_CASES["fem"](tfix), device="cpu")
    x = np.random.default_rng(3).standard_normal(a.orig_rows) * (1 + 2.0 ** -40)
    xl = a.embed(x, dtype=torch.float64)
    assert xl.dtype == torch.float64
    np.testing.assert_array_equal(a.extract(xl, dtype=torch.float64).numpy(), x)


@pytest.mark.parametrize("name", sorted(WHELL_CASES))
def test_select_with_itemsize_8_matches(name):
    j, t = WHELL_CASES[name](jfix), WHELL_CASES[name](tfix)
    je, te = j_estimate(j, itemsize=8), estimate_formats(t, itemsize=8)
    assert {k: e.json() for k, e in je.items()} == {k: e.json() for k, e in te.items()}
    assert j_suggest(j, itemsize=8) == suggest_format(t, itemsize=8)
    assert j_suggest(j) == suggest_format(t)  # solve()'s call, in both


# --------------------------------------------------------------------------
# SpMV


def _whell_pair(coo):
    ja = j_coo_to_whell(coo, packed=True)
    ta = twhell.from_numpy_fields(
        {f: None if getattr(ja, f) is None else np.asarray(getattr(ja, f))
         for f in WHELL_ARRAYS + ("values", "values_lo")},
        **{f: getattr(ja, f) for f in WHELL_STATIC})
    return ja, ta


@pytest.mark.parametrize("ab", [(1.0, 0.0), (2.5, -0.5)], ids=["plain", "alpha_beta"])
@pytest.mark.parametrize("name", ["fem", "laplace", "ctest", "empty"])
def test_whell_spmv_matches_dd_and_golden(name, ab):
    alpha, beta = ab
    coo = WHELL_CASES[name](jfix)
    ja, ta = _whell_pair(coo)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(coo.n_cols)
    y = rng.standard_normal(coo.n_rows)
    lor = np.asarray(ja.lane_of_row)
    xl = np.zeros(ja.n_rows)
    xl[lor] = x
    yl = np.zeros(ja.n_rows)
    yl[lor] = y
    kw_ = dict(alpha=alpha, beta=beta)
    zj = dd.join(np.asarray(jops.whell_spmv(ja, jnp.asarray(dd.split(xl)),
                                            y=jnp.asarray(dd.split(yl)), **kw_)))
    zt = tops.whell_spmv(ta, torch.from_numpy(xl), y=torch.from_numpy(yl), **kw_)
    assert zt.dtype == torch.float64
    golden = alpha * coo.spmv(x) + beta * y
    near(zt.numpy()[lor], zj[lor], "vs JAX dd")
    near(zt.numpy()[lor], golden, "vs golden")
    # the port's own converter (COO values, not the pair) on the same x
    a = coo_to_whell(WHELL_CASES[name](tfix), device="cpu")
    z = tops.whell_spmv(a, a.embed(x, torch.float64), y=a.embed(y, torch.float64),
                        **kw_)
    near(a.extract(z, torch.float64).numpy(), golden, "port layout vs golden")


def test_whell_f64_scattered_windows():
    """The JAX double-float layout has aligned windows only; the port's
    float64 kernel takes scattered ones too."""
    coo = WHELL_CASES["fem"](tfix)
    a = coo_to_whell(coo, device="cpu", scattered=True)
    assert a.scattered and a.values.dtype == torch.float64
    x = np.random.default_rng(1).standard_normal(coo.n_cols)
    z = tops.whell_spmv(a, a.embed(x, torch.float64))
    near(a.extract(z, torch.float64).numpy(), coo.spmv(x))


def test_whell_f64_flush_heavy_row_in_a_light_hack():
    """The flush takes ``scan[seg_hi] - scan[seg_lo]``: its error scales
    with the hack's prefix total, not with a row's own sum.  One row of
    1e6-sized values heads a hack of rows of unit-sized values: every row
    meets 1e-14 of the hack's total, and the light rows 1e-7 of their own
    sums, where fp32 sums (error ~1e-7 of a 1e8 total) would lose them
    entirely."""
    rng = np.random.default_rng(4)
    n = 512
    rows, cols, vals = [], [], []
    for r in range(n):
        k = 96 if r == 0 else 4
        c = rng.choice(n, size=k, replace=False)
        rows += [r] * k
        cols += c.tolist()
        vals += (rng.uniform(1, 2, k) * (1e6 if r == 0 else 1.0)).tolist()
    coo = CooMatrix(np.array(rows), np.array(cols), np.array(vals, F64), n, n)
    a = coo_to_whell(coo, device="cpu")
    assert not a.unit_segments
    lor = a.lane_of_row.numpy()
    hack0 = lor[lor < 128]
    assert lor[0] == 0 and hack0.size > 64  # the heavy row heads a full hack
    x = rng.uniform(0.5, 1.5, n)
    z = a.extract(tops.whell_spmv(a, a.embed(x, torch.float64)), torch.float64)
    golden = coo.spmv(x)
    prefix = np.abs(golden[lor < 128]).sum()
    err = np.abs(z.numpy() - golden)
    assert err.max() <= 1e-14 * prefix
    assert (err[1:] <= 1e-7 * np.abs(golden[1:])).all()


@pytest.mark.parametrize("ab", [(1.0, 0.0), (2.5, -0.5)], ids=["plain", "alpha_beta"])
@pytest.mark.parametrize("name", SPMV_DIA)
def test_sdia_spmv_matches_dd_and_golden(name, ab):
    alpha, beta = ab
    coo = DIA_CASES[name](jfix)
    ja = j_coo_to_sdia(coo)
    ta = tdia.from_numpy_fields(np.asarray(ja.values), ja.offsets, ja.n_rows,
                                ja.n_cols, values_lo=np.asarray(ja.values_lo))
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(coo.n_cols), rng.standard_normal(coo.n_rows)
    zj = dd.join(np.asarray(jops.sdia_spmv(ja, jnp.asarray(dd.split(x)), alpha=alpha,
                                           beta=beta, y=jnp.asarray(dd.split(y)))))
    zt = tops.sdia_spmv(ta, torch.from_numpy(x), alpha=alpha, beta=beta,
                        y=torch.from_numpy(y))
    assert zt.dtype == torch.float64
    golden = alpha * last_write(DIA_CASES[name](tfix)).spmv(x) + beta * y
    near(zt.numpy(), zj, "vs JAX dd")
    near(zt.numpy(), golden, "vs golden")
    a = coo_to_sdia(DIA_CASES[name](tfix), device="cpu")
    near(tops.sdia_spmv(a, torch.from_numpy(x), alpha=alpha, beta=beta,
                        y=torch.from_numpy(y)).numpy(), golden, "port layout")


@pytest.mark.parametrize("ab", [(1.0, 0.0), (2.5, -0.5)], ids=["plain", "alpha_beta"])
@pytest.mark.parametrize("name", SPMV_DIA)
def test_whdia_spmv_matches_dd_and_golden(name, ab):
    alpha, beta = ab
    coo = DIA_CASES[name](jfix)
    ja = j_coo_to_whdia(coo)
    ta = twhdia.from_numpy_fields(
        {f: None if getattr(ja, f) is None else np.asarray(getattr(ja, f))
         for f in ("values", "values_lo", "slot_r0", "tile_r0", "tile_base",
                   "chunk_group")},
        **{f: getattr(ja, f) for f in WHDIA_STATIC})
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(coo.n_cols), rng.standard_normal(coo.n_rows)
    zj = dd.join(np.asarray(jops.whdia_spmv(ja, jnp.asarray(dd.split(x)), alpha=alpha,
                                            beta=beta, y=jnp.asarray(dd.split(y)))))
    zt = tops.whdia_spmv(ta, torch.from_numpy(x), alpha=alpha, beta=beta,
                         y=torch.from_numpy(y))
    assert zt.dtype == torch.float64
    golden = alpha * last_write(DIA_CASES[name](tfix)).spmv(x) + beta * y
    near(zt.numpy(), zj, "vs JAX dd")
    near(zt.numpy(), golden, "vs golden")
    a = coo_to_whdia(DIA_CASES[name](tfix), device="cpu")  # pattern mode too
    near(tops.whdia_spmv(a, torch.from_numpy(x), alpha=alpha, beta=beta,
                         y=torch.from_numpy(y)).numpy(), golden, "port layout")


def test_sdia_f64_plain_is_exact_in_kernel_order():
    """The SDIA plain version multiplies and then adds, diagonal by
    diagonal in ascending order, as kernel #5 does: a NumPy loop in that
    order gives the same bits."""
    coo = DIA_CASES["banded_wide"](tfix)
    a = coo_to_sdia(coo, device="cpu")
    x = np.random.default_rng(2).standard_normal(coo.n_cols)
    z = ks.sdia_spmv_plain(a.values, a.offsets, torch.from_numpy(x),
                           n_rows=a.n_rows).numpy()
    planes = a.values.numpy().reshape(a.n_diags, -1)
    want = np.zeros(a.n_rows)
    r = np.arange(a.n_rows)
    for j, o in enumerate(a.offsets):
        ok = (r + o >= 0) & (r + o < a.n_cols)
        want[ok] = want[ok] + planes[j, r[ok]] * x[r[ok] + o]
    np.testing.assert_array_equal(z, want)


def test_float32_kernels_refuse_float64_vectors():
    """No silent precision change: an fp32 layout with a float64 vector,
    and a float64 layout with an fp32 one, raise."""
    lap32 = tfix.laplacian_2d(16, 16, np.float32)
    lap64 = tfix.laplacian_2d(16, 16, F64)
    for conv, op in ((coo_to_sdia, tops.sdia_spmv), (coo_to_whdia, tops.whdia_spmv)):
        with pytest.raises(ValueError, match="float32"):
            op(conv(lap32, device="cpu"), torch.zeros(256, dtype=torch.float64))
        with pytest.raises(ValueError, match="float64"):
            op(conv(lap64, device="cpu"), torch.zeros(256, dtype=torch.float32))
    a = coo_to_whell(lap64, device="cpu")
    with pytest.raises(ValueError, match="x2d"):
        tops.whell_spmv(a, torch.zeros(a.n_cols, dtype=torch.float32))


def test_cpu_path_counts_no_f64_launches():
    lap = tfix.laplacian_2d(16, 16, F64)
    before = (kw.LAUNCHES_F64, ks.LAUNCHES_F64, kd.LAUNCHES_F64)
    a = coo_to_whell(lap, device="cpu")
    tops.whell_spmv(a, torch.zeros(a.n_cols, dtype=torch.float64))
    tops.sdia_spmv(coo_to_sdia(lap, device="cpu"), torch.zeros(256, dtype=torch.float64))
    tops.whdia_spmv(coo_to_whdia(lap, device="cpu"), torch.zeros(256, dtype=torch.float64))
    assert (kw.LAUNCHES_F64, ks.LAUNCHES_F64, kd.LAUNCHES_F64) == before


def test_blas1_keeps_float64():
    """No BLAS-1 helper rounds a float64 operand to float32."""
    rng = np.random.default_rng(8)
    x, y, z = (torch.from_numpy(rng.standard_normal(300) * (1 + 2.0 ** -40))
               for _ in range(3))
    idx = torch.from_numpy(np.array([3, -1, 7, 299]))
    outs = [tb.scal(1.3, x), tb.axpby(1.3, x, -0.7, y), tb.axpby(1.3, x, 0.0, y),
            tb.axy(1.3, x, y), tb.axypbz(1.3, x, y, 0.5, z), tb.abs_(x, 2.0),
            tb.dot(x, y), tb.nrm2(x), tb.asum(x), tb.amax(x),
            tb.gath(x, idx), tb.scat(y, idx, x[:4], beta=0.5),
            tb.scat(y, idx, x[:4], beta=0.5, mode="add"), tb.setscal(x, 2.0, 1, 5)]
    assert all(o.dtype == torch.float64 for o in outs)
    xn, yn = x.numpy(), y.numpy()
    assert float(tb.dot(x, y)) == pytest.approx(float(xn @ yn), rel=1e-14)
    np.testing.assert_array_equal(tb.axpby(1.5, x, -0.5, y).numpy(), 1.5 * xn - 0.5 * yn)


# --------------------------------------------------------------------------
# solve()


def spd_fem(n=1500):
    c = jfix.random_fem_like(n, 10.0, span=120, far_frac=0.0, seed=12, dtype=F64)
    d = c.to_dense()
    d = (d + d.T) / 2 + np.eye(n) * (np.abs(d).sum(1).max() + 1)
    rows, cols = np.nonzero(d)
    return rows, cols, d[rows, cols], n


def lap_30x20():
    c = jfix.laplacian_2d(30, 20, F64)
    return c.rows, c.cols, c.values, c.n_rows


def banded_700():
    c = jfix.random_banded(700, bands=5, wander=0, seed=3, dtype=F64)
    return c.rows, c.cols, c.values, c.n_rows


@pytest.mark.parametrize("system,fmt,symmetric", [
    (spd_fem, "whell", True), (lap_30x20, None, True), (lap_30x20, "sdia", True),
    (lap_30x20, "whdia", True), (banded_700, "whdia", False),
    (banded_700, "whell", False)])
def test_solve_f64_matches_jax(system, fmt, symmetric):
    rows, cols, vals, n = system()
    b = np.random.default_rng(11).standard_normal(n)
    kw_ = dict(fmt=fmt, tol=1e-10, maxiter=3000, symmetric=symmetric)
    rj = j_solve(JCoo(rows, cols, vals, n, n), b, **kw_)
    rt = solve(CooMatrix(rows, cols, vals, n, n), b, device="cpu", **kw_)
    assert bool(rj.converged) and bool(rt.converged)
    assert rt.x.dtype == torch.float64
    assert abs(int(rj.iterations) - rt.iterations) <= 2
    xt, xj = rt.x.numpy(), np.asarray(rj.x, F64)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-8 * np.abs(xj).max())
    a = CooMatrix(rows, cols, vals, n, n).sum_duplicates()
    assert np.linalg.norm(b - a.spmv(xt)) <= 1e-9 * np.linalg.norm(b)


def test_solve_f64_jacobi_keeps_float64(monkeypatch):
    """The Jacobi preconditioner stays float64 on a float64 system (the
    JAX double-float route rounds it to fp32)."""
    from spgpu_tpu_torch.solvers import auto

    seen = []
    cg = auto.cg
    monkeypatch.setattr(auto, "cg", lambda *a, **k: seen.append(k["m_inv"]) or cg(*a, **k))
    rows, cols, vals, n = lap_30x20()
    b = np.random.default_rng(5).standard_normal(n)
    r = solve(CooMatrix(rows, cols, vals, n, n), b, device="cpu", fmt="whell",
              jacobi=True, tol=1e-10)
    assert seen[0].dtype == torch.float64 and bool(r.converged)
    a = CooMatrix(rows, cols, vals, n, n)
    assert np.linalg.norm(b - a.spmv(r.x.numpy())) <= 1e-9 * np.linalg.norm(b)
