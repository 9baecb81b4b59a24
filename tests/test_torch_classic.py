"""PyTorch port: classic (non-packed) WHELL against the JAX package.

The classic converter must build the JAX ``coo_to_whell(coo)`` arrays bit
for bit (on the fixtures of tests/test_whell.py:29-37, with the OELL
order, way-split rows, bf16 values, the empty matrix and the plan).  The
SpMV (kernel #15's plain version, with the op's ``row_perm`` scatter, way
reduction and epilogue) is held against ``whell_spmv_pallas`` in
interpret mode and the host golden at rtol = atol = 2e-5
(tests/test_whell.py:63), and the fused SpMM (kernel #16's plain version)
against ``whell_spmm_pallas`` at 3e-5 (tests/test_whell.py:123), at most
4 RHS: each interpret-mode compile of a WHELL kernel costs seconds.  The
two packages sum each row's products in different orders, hence the
tolerances.

The packed-field bounds (fault F1) are tested here too: each converter
raises past its bound with the bound's constant set low, and
``WhellMatrix.check`` rejects a hand-wrapped layout past it.

Kernel #15 reads only the units of the layout's work list
(``classic_work_list``): the list must cover every nonzero cell and no
all-zero unit or slot, on OELL, way-split and bf16 layouts and with
explicit zeros; every new layout (``whell_update_values``, the bridge,
``.to()``) derives its own, and ``check()`` rejects a stale one.  The JAX
kernel's NaN from an Inf behind padding, which #15 does not reproduce, is
shown on purpose.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu.convert.whell import coo_to_whell as j_coo_to_whell  # noqa: E402
from spgpu_tpu.convert.whell import degree_sort_perm as j_degree_sort_perm  # noqa: E402
from spgpu_tpu.convert.whell import whell_update_values as j_update  # noqa: E402
from spgpu_tpu.ops.pallas_kernels import whell_spmm_pallas, whell_spmv_pallas  # noqa: E402
from spgpu_tpu.utils import fixtures as jfix  # noqa: E402
from spgpu_tpu_torch import ops as tops  # noqa: E402
from spgpu_tpu_torch.convert import (  # noqa: E402
    coo_to_whell,
    coo_to_whell_percell,
    degree_sort_perm,
    whell_update_values,
)
from spgpu_tpu_torch.convert import whell as tconv  # noqa: E402
from spgpu_tpu_torch.formats import whell as twhell  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.kernels import whell_classic as kc  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)

# tests/test_whell.py:29-37
CASES = {
    "ctest": lambda f: f.ctest_fixture(np.float32),
    "laplace": lambda f: f.laplacian_2d(23, 31, np.float32),
    "laplace_wide": lambda f: f.laplacian_2d(200, 30, np.float32),
    "irregular": lambda f: f.random_irregular(1000, 1000, 9.0, seed=3,
                                              dtype=np.float32),
    "banded": lambda f: f.random_banded(900, bands=7, wander=13, seed=4,
                                        dtype=np.float32),
    "fem": lambda f: f.random_fem_like(4000, 16.0, span=256, far_frac=0.02,
                                       seed=5, dtype=np.float32),
    "rect": lambda f: f.random_irregular(700, 1200, 6.0, seed=8, dtype=np.float32),
}
# tests/test_whell.py:116,255: the SpMM and way-split fixtures
SPMM = {
    "fem3000": lambda f: f.random_fem_like(3000, 12.0, span=200, far_frac=0.02,
                                           seed=9, dtype=np.float32),
    "fem2000": lambda f: f.random_fem_like(2000, 10.0, span=150, far_frac=0.02,
                                           seed=13, dtype=np.float32),
}
TOL = dict(rtol=2e-5, atol=2e-5)
SPMM_TOL = dict(rtol=3e-5, atol=3e-5)

ARRAYS = ("values", "residue", "page_tab", "tile_base", "chunk_group",
          "row_perm", "seg_lo", "seg_hi", "lane_of_row", "group_bases")
STATIC = ("n_rows", "n_cols", "num_hacks", "num_groups", "total_slots", "nnz",
          "x_pages", "window_pages", "orig_rows", "group_hacks", "chunk_tiles",
          "unit_segments", "ways")


def _bits(a):
    """Array as comparable raw bits (bf16 has no NumPy dtype of its own)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_same_layout(ja, ta):
    for f in ARRAYS:
        jv, tv = getattr(ja, f), getattr(ta, f)
        assert (jv is None) == (tv is None), f
        if jv is not None:
            jb, tb = _bits(jv), _bits(tv)
            assert jb.dtype == tb.dtype, (f, jb.dtype, tb.dtype)
            np.testing.assert_array_equal(jb, tb, err_msg=f)
    for f in STATIC:
        assert getattr(ja, f) == getattr(ta, f), f


def _fields(m):
    return {f: None if getattr(m, f, None) is None else np.asarray(getattr(m, f))
            for f in ARRAYS + ("values_lo",)}


def bridge(ja):
    return twhell.from_numpy_fields(_fields(ja), **{f: getattr(ja, f) for f in STATIC})


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


# --------------------------------------------------------------------------
# the converter


@pytest.mark.parametrize("name", sorted(CASES))
def test_classic_converter_bit_identical(name):
    ja = j_coo_to_whell(CASES[name](jfix))
    ta = coo_to_whell(CASES[name](tfix), device="cpu", packed=False)
    assert not ta.packed and ta.row_perm is None and ta.ways == 1
    assert_same_layout(ja, ta)
    ta.check()


@pytest.mark.parametrize("kw", [dict(sort_rows=True), dict(ways=2), dict(ways=4),
                                dict(dtype="bfloat16")],
                         ids=["sort_rows", "ways2", "ways4", "bf16"])
@pytest.mark.parametrize("name", ["fem", "irregular", "rect"])
def test_classic_converter_options_bit_identical(name, kw):
    jkw = {"dtype": jnp.bfloat16} if "dtype" in kw else kw
    ja = j_coo_to_whell(CASES[name](jfix), **jkw)
    ta = coo_to_whell(CASES[name](tfix), device="cpu", packed=False, **kw)
    assert_same_layout(ja, ta)
    ta.check()


def test_classic_converter_row_perm_and_degree_sort():
    c = CASES["irregular"]
    np.testing.assert_array_equal(degree_sort_perm(c(tfix)), j_degree_sort_perm(c(jfix)))
    perm = np.random.default_rng(4).permutation(1000).astype(np.int32)
    assert_same_layout(j_coo_to_whell(c(jfix), row_perm=perm),
                       coo_to_whell(c(tfix), device="cpu", packed=False,
                                    row_perm=perm))


@pytest.mark.parametrize("kw", [{}, dict(sort_rows=True), dict(ways=2)],
                         ids=["plain", "sort_rows", "ways2"])
def test_classic_empty_matrix(kw):
    def empty(f):
        return f.CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0, np.float32), 300, 300)
    ja = j_coo_to_whell(empty(jfix), **kw)
    ta = coo_to_whell(empty(tfix), device="cpu", packed=False, **kw)
    assert_same_layout(ja, ta)
    np.testing.assert_array_equal(ta.chunk_group.numpy(), np.arange(ta.num_groups))
    assert ta.x_pages == 8
    z = tops.whell_spmv(ta, torch.ones(300), beta=0.5, y=torch.full((300,), 4.0))
    torch.testing.assert_close(z, torch.full((300,), 2.0), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["fem", "ctest"])
def test_classic_return_plan_matches_jax(name):
    ja, jplan = j_coo_to_whell(CASES[name](jfix), return_plan=True)
    ta, tplan = coo_to_whell(CASES[name](tfix), device="cpu", packed=False,
                             return_plan=True)
    assert_same_layout(ja, ta)
    assert len(tplan) == len(jplan) == 2
    for j, t in zip(jplan, tplan):
        np.testing.assert_array_equal(np.asarray(j), t)


def test_classic_argument_checks():
    coo = CASES["laplace"](tfix)
    for kw in (dict(sort_rows=True), dict(ways=2),
               dict(row_perm=np.arange(coo.n_rows))):
        with pytest.raises(ValueError, match="packed=True is incompatible"):
            coo_to_whell(coo, device="cpu", **kw)
    with pytest.raises(ValueError, match="window_pages"):
        coo_to_whell(coo, device="cpu", packed=False, window_pages=16)
    for kw in (dict(sort_rows=True), dict(return_plan=True)):
        with pytest.raises(ValueError, match="ways>1"):
            coo_to_whell(coo, device="cpu", packed=False, ways=2, **kw)
    for dt in (np.float64, np.complex64):
        c = CooMatrix(coo.rows, coo.cols, coo.values.astype(dt), coo.n_rows, coo.n_cols)
        with pytest.raises(NotImplementedError, match="item 14"):
            coo_to_whell(c, device="cpu", packed=False)


def test_classic_to_dense_in_original_numbering():
    coo = CASES["rect"](tfix)
    for kw in ({}, dict(sort_rows=True)):
        a = coo_to_whell(coo, device="cpu", packed=False, **kw)
        np.testing.assert_array_equal(a.to_dense(), coo.to_dense())
    with pytest.raises(ValueError, match="original numbering"):
        a.embed(np.ones(coo.n_cols), torch.float32)


# --------------------------------------------------------------------------
# SpMV (kernel #15's plain version) against the JAX kernel and the golden


@pytest.mark.parametrize("name", ["fem", "rect", "ctest"])
def test_classic_spmv_matches_jax_and_golden(name):
    ja = j_coo_to_whell(CASES[name](jfix))
    ta = bridge(ja)
    coo = CASES[name](tfix)
    x = _x(coo.n_cols)
    zj = np.asarray(whell_spmv_pallas(ja, jnp.asarray(x), interpret=True), np.float64)
    zt = tops.whell_spmv(ta, torch.from_numpy(x))
    assert zt.shape == (coo.n_rows,) and zt.dtype == torch.float32
    np.testing.assert_allclose(zt.double().numpy(), zj, **TOL)
    np.testing.assert_allclose(zt.double().numpy(), coo.spmv(x.astype(np.float64)), **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_classic_spmv_matches_golden(name):
    coo = CASES[name](tfix)
    a = coo_to_whell(coo, device="cpu", packed=False)
    x = _x(coo.n_cols, 1)
    z = tops.whell_spmv(a, torch.from_numpy(x))
    np.testing.assert_allclose(z.double().numpy(), coo.spmv(x.astype(np.float64)), **TOL)


def test_classic_alpha_beta_y_matches_jax():
    """tests/test_whell.py:66-75."""
    c = lambda f: f.laplacian_2d(16, 16, np.float32)  # noqa: E731
    ja = j_coo_to_whell(c(jfix))
    ta = bridge(ja)
    rng = np.random.default_rng(1)
    x, y = _x(256, 2), rng.standard_normal(256).astype(np.float32)
    zj = np.asarray(whell_spmv_pallas(ja, jnp.asarray(x), alpha=2.5, beta=-0.5,
                                      y=jnp.asarray(y), interpret=True))
    zt = tops.whell_spmv(ta, torch.from_numpy(x), alpha=2.5, beta=-0.5,
                         y=torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(zt, zj, **TOL)
    np.testing.assert_allclose(zt, 2.5 * c(tfix).spmv(x) - 0.5 * y, **TOL)
    nan_y = torch.full((256,), float("nan"))
    torch.testing.assert_close(tops.whell_spmv(ta, torch.from_numpy(x), beta=0.0, y=nan_y),
                               tops.whell_spmv(ta, torch.from_numpy(x)), rtol=0, atol=0)


@pytest.mark.parametrize("kw", [dict(sort_rows=True), dict(ways=2)],
                         ids=["oell", "ways2"])
def test_classic_oell_and_ways_match_jax(kw):
    """tests/test_whell.py:78-84 (OELL output scatter) and :329-341 (way
    groups summed back)."""
    c = SPMM["fem3000"]
    ja = j_coo_to_whell(c(jfix), **kw)
    ta = bridge(ja)
    assert (ta.row_perm is not None) == ("sort_rows" in kw)
    assert ta.ways == kw.get("ways", 1) and ta.n_rows == 3000 * ta.ways
    x = _x(3000, 7)
    zj = np.asarray(whell_spmv_pallas(ja, jnp.asarray(x), interpret=True))
    zt = tops.whell_spmv(ta, torch.from_numpy(x))
    assert zt.shape == (3000,)
    np.testing.assert_allclose(zt.numpy(), zj, **SPMM_TOL)
    np.testing.assert_allclose(zt.numpy(), c(tfix).spmv(x), **SPMM_TOL)


def test_classic_ways4_and_duplicates_match_golden():
    coo = SPMM["fem3000"](tfix)
    x = _x(3000, 7)
    z = tops.whell_spmv(coo_to_whell(coo, device="cpu", packed=False, ways=4),
                        torch.from_numpy(x))
    np.testing.assert_allclose(z.numpy(), coo.spmv(x), **SPMM_TOL)
    # ctest: every diagonal entry twice, so A @ 1 is 2 (tests/test_whell.py:98)
    a = coo_to_whell(CASES["ctest"](tfix), device="cpu", packed=False)
    torch.testing.assert_close(tops.whell_spmv(a, torch.ones(100)),
                               torch.full((100,), 2.0), rtol=1e-6, atol=0)


def test_classic_bf16_values_fp32_x_match_jax():
    """tests/test_whell.py:132-146: bf16 slabs, fp32 x and sums."""
    c = SPMM["fem3000"]
    ja = j_coo_to_whell(c(jfix), dtype=jnp.bfloat16)
    ta = bridge(ja)
    assert ta.values.dtype == torch.bfloat16
    x = _x(3000, 6)
    zj = np.asarray(whell_spmv_pallas(ja, jnp.asarray(x), interpret=True), np.float64)
    zt = tops.whell_spmv(ta, torch.from_numpy(x))
    assert zt.dtype == torch.float32
    np.testing.assert_allclose(zt.double().numpy(), zj, **TOL)
    coo = c(tfix)
    v16 = torch.from_numpy(coo.values).to(torch.bfloat16).double().numpy()
    golden = CooMatrix(coo.rows, coo.cols, v16, coo.n_rows, coo.n_cols).spmv(
        x.astype(np.float64))
    np.testing.assert_allclose(zt.double().numpy(), golden, **TOL)


# --------------------------------------------------------------------------
# SpMM: kernel #16's plain version against the JAX fused kernel; dispatch


@pytest.mark.parametrize("name,kw,n_rhs", [("fem3000", {}, 4),
                                            ("fem2000", dict(ways=2), 3),
                                            ("fem3000", dict(sort_rows=True), 2)],
                         ids=["fem", "ways2", "oell"])
def test_classic_spmm_matches_jax_and_golden(name, kw, n_rhs):
    coo = SPMM[name](tfix)
    ja = j_coo_to_whell(SPMM[name](jfix), **kw)
    ta = bridge(ja)
    rng = np.random.default_rng(4)
    X = rng.standard_normal((n_rhs, coo.n_cols)).astype(np.float32)
    Y = rng.standard_normal((n_rhs, coo.n_rows)).astype(np.float32)
    zj = np.asarray(whell_spmm_pallas(ja, jnp.asarray(X), alpha=1.5, beta=-2.0,
                                      y=jnp.asarray(Y), interpret=True))
    zt = tops.whell_spmm(ta, torch.from_numpy(X), alpha=1.5, beta=-2.0,
                         y=torch.from_numpy(Y), fused=True)
    assert zt.shape == (n_rhs, coo.n_rows)
    np.testing.assert_allclose(zt.numpy(), zj, **SPMM_TOL)
    np.testing.assert_allclose(zt.numpy(), 1.5 * coo.spmv(X) - 2.0 * Y, **SPMM_TOL)


@pytest.mark.parametrize("n_rhs", [1, 8, 17])
def test_classic_fused_plain_matches_loop(n_rhs):
    coo = SPMM["fem3000"](tfix)
    a = coo_to_whell(coo, device="cpu", packed=False)
    X = torch.from_numpy(np.random.default_rng(n_rhs).standard_normal(
        (n_rhs, coo.n_cols)).astype(np.float32))
    z = tops.whell_spmm(a, X, fused=True)
    loop = tops.whell_spmm(a, X)
    torch.testing.assert_close(z, loop, rtol=1e-6, atol=1e-6 * float(loop.abs().max()))
    np.testing.assert_allclose(z.numpy(), coo.spmv(X.double().numpy()), **SPMM_TOL)


def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


@pytest.mark.parametrize("fused,want", [(None, "loop"), (False, "loop"),
                                        (True, "spmm")])
def test_classic_spmm_dispatch(fused, want, monkeypatch):
    """As the JAX whell_spmm (``fused = packed and not special``): a classic
    layout loops kernel #15 per RHS by default and fuses on request."""
    a = coo_to_whell(CASES["laplace"](tfix), device="cpu", packed=False)
    spmm = _counting(monkeypatch, kc, "whell_classic_spmm")
    spmv = _counting(monkeypatch, kc, "whell_classic_spmv")
    z = tops.whell_spmm(a, torch.ones((5, a.n_cols)), fused=fused)
    assert z.shape == (5, a.n_rows)
    assert (len(spmm), len(spmv)) == ((1, 0) if want == "spmm" else (0, 5))


def test_classic_spmm_rejects_bad_operands():
    a = coo_to_whell(CASES["laplace"](tfix), device="cpu", packed=False)
    with pytest.raises(ValueError, match="shape"):
        tops.whell_spmm(a, torch.zeros(a.n_cols), fused=True)
    with pytest.raises(ValueError, match="float32"):
        tops.whell_spmm(a, torch.zeros((2, a.n_cols), dtype=torch.float64), fused=True)
    with pytest.raises(ValueError, match="sentinel"):
        kc.whell_classic_spmv(a.values, a.residue, a.page_tab, a.tile_base,
                              torch.cat([a.chunk_group, torch.tensor([-1], dtype=torch.int32)]),
                              torch.zeros((a.x_pages, 128)), num_groups=a.num_groups,
                              tile_page=a.tile_page)


def test_classic_wrappers_need_the_work_list_on_cuda_only():
    """#15 and #16 read only the live units of ``WhellMatrix.work_list``:
    on a CUDA device their wrappers need it and raise without; the plain
    versions, the CPU path, read every cell and need none, and the op
    passes the list either way."""
    a = coo_to_whell(CASES["fem"](tfix), device="cpu", packed=False)
    x3 = tops._prep_x(torch.ones((3, a.n_cols)), a.n_cols, a.x_pages, stack=True)
    layout = (a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group)
    for op in ("whell_classic_spmv", "whell_classic_spmm"):
        with pytest.raises(ValueError, match="work list"):
            kc._check_work(op, None, torch.device("cuda"))
        kc._check_work(op, None, torch.device("cpu"))
        with pytest.raises(ValueError, match="bad work"):
            kc._check_work(op, a.work_list.int(), torch.device("cpu"))
    plain = kc.whell_classic_spmm_plain(*layout, x3, num_groups=a.num_groups,
                                        tile_page=a.tile_page)
    for work in (None, a.work_list):
        z = kc.whell_classic_spmm(*layout, x3, num_groups=a.num_groups, work=work,
                                  tile_page=a.tile_page)
        torch.testing.assert_close(z, plain, rtol=0, atol=0)


def test_cpu_path_counts_no_classic_launches():
    a = coo_to_whell(CASES["fem"](tfix), device="cpu", packed=False)
    before = (kc.LAUNCHES, kc.LAUNCHES_SPMM)
    tops.whell_spmv(a, torch.ones(a.n_cols))
    tops.whell_spmm(a, torch.ones((2, a.n_cols)), fused=True)
    assert (kc.LAUNCHES, kc.LAUNCHES_SPMM) == before


# --------------------------------------------------------------------------
# whell_update_values and the bridge


def test_update_values_classic_plan_matches_jax():
    """tests/test_whell.py:269-287: a new matrix of the same pattern."""
    c = lambda f: f.random_fem_like(2000, 10.0, span=150, far_frac=0.02,  # noqa: E731
                                    seed=11, dtype=np.float32)
    ja, jplan = j_coo_to_whell(c(jfix), return_plan=True)
    ta, tplan = coo_to_whell(c(tfix), device="cpu", packed=False, return_plan=True)
    newv = np.random.default_rng(3).standard_normal(ta.nnz).astype(np.float32)
    ja2, ta2 = j_update(ja, jplan, newv), whell_update_values(ta, tplan, newv)
    assert_same_layout(ja2, ta2)
    coo = c(tfix)
    x = _x(2000, 5)
    np.testing.assert_allclose(
        tops.whell_spmv(ta2, torch.from_numpy(x)).numpy(),
        CooMatrix(coo.rows, coo.cols, newv, 2000, 2000).spmv(x), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_update_values_packed_plan_matches_jax(dtype):
    """The packed plan ``(panel, slot, lane)``: the same cells as the JAX
    plan; a float64 refresh stores float64 (the JAX package splits it into
    a double-float pair, joined here for the comparison)."""
    c = lambda f: f.random_fem_like(2000, 10.0, span=150, far_frac=0.02,  # noqa: E731
                                    seed=11, dtype=np.dtype(dtype))
    ja, jplan = j_coo_to_whell(c(jfix), packed=True, return_plan=True)
    ta, tplan = coo_to_whell(c(tfix), device="cpu", return_plan=True)
    assert len(tplan) == 3 and not tplan[0].any()
    for j, t in zip(jplan, tplan):
        np.testing.assert_array_equal(np.asarray(j), t)
    newv = np.random.default_rng(3).standard_normal(ta.nnz).astype(dtype)
    ja2, ta2 = j_update(ja, jplan, newv), whell_update_values(ta, tplan, newv)
    want = np.asarray(ja2.values, np.float64)
    if ja2.values_lo is not None:
        want = want + np.asarray(ja2.values_lo, np.float64)
    np.testing.assert_allclose(ta2.values.double().numpy(), want, rtol=1e-14, atol=0)
    assert ta2.values.dtype == getattr(torch, dtype)
    torch.testing.assert_close(ta2.values[torch.from_numpy(tplan[1]), torch.from_numpy(tplan[2])],
                               torch.from_numpy(newv), rtol=0, atol=0)


def test_packed_empty_plan_and_complex_plan():
    e = tfix.CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64),
                       np.zeros(0, np.float32), 300, 300)
    _, plan = coo_to_whell(e, device="cpu", return_plan=True)
    assert [p.size for p in plan] == [0, 0, 0]
    c = CASES["laplace"](tfix)
    cz = CooMatrix(c.rows, c.cols, c.values.astype(np.complex64), c.n_rows, c.n_cols)
    with pytest.raises(ValueError, match="complex"):
        coo_to_whell(cz, device="cpu", return_plan=True)


@pytest.mark.parametrize("kw", [{}, dict(sort_rows=True), dict(ways=2),
                                dict(dtype=jnp.bfloat16)],
                         ids=["plain", "oell", "ways2", "bf16"])
def test_classic_bridge_roundtrip(kw):
    ja = j_coo_to_whell(CASES["fem"](jfix), **kw)
    ta = bridge(ja)
    assert_same_layout(ja, ta)
    moved = ta.to("cpu")
    assert_same_layout(ja, moved)


def test_classic_check_rejects_broken_layouts():
    a = coo_to_whell(CASES["fem"](tfix), device="cpu", packed=False, sort_rows=True)
    bad = a.row_perm.clone()
    bad[0] = bad[1]
    with pytest.raises(ValueError, match="permutation"):
        dataclasses.replace(a, row_perm=bad).check()
    with pytest.raises(ValueError, match="chunk_group shape"):
        dataclasses.replace(a, chunk_group=torch.cat(
            [a.chunk_group, torch.tensor([-1], dtype=torch.int32)])).check()
    with pytest.raises(ValueError, match="ways"):
        dataclasses.replace(a, ways=3).check()
    meta = a.tile_base.clone()
    meta[0] |= 8 << 16  # hack-in-group 8 of an 8-hack group
    with pytest.raises(ValueError, match="hack-in-group"):
        dataclasses.replace(a, tile_base=meta).check()


# --------------------------------------------------------------------------
# fault F1: every packed field is bounded; since the full-width tile_page
# word carries the page or group, the bound is its 31 bits


def test_f1_aligned_packed_raises_past_the_page_field(monkeypatch):
    coo = CASES["laplace_wide"](tfix)  # 6,000 rows: 64 aligned x pages
    monkeypatch.setattr(tconv, "_MAX_TILE_PAGE", 48)
    with pytest.raises(ValueError, match="31-bit"):
        coo_to_whell(coo, device="cpu", scattered=False)
    with pytest.raises(ValueError, match="31-bit"):  # the JAX float64 geometry
        coo_to_whell(coo, device="cpu", dtype="float64", scattered=False)
    coo_to_whell(coo, device="cpu")  # scattered windows: 47 layout groups
    coo_to_whell(coo, device="cpu", dtype="float64")  # scattered by default too


def test_f1_scattered_packed_raises_past_the_group_field(monkeypatch):
    coo = CASES["fem"](tfix)
    n_groups = coo_to_whell(coo, device="cpu").group_bases.numel() // 4
    monkeypatch.setattr(tconv, "_MAX_TILE_PAGE", n_groups - 1)
    with pytest.raises(ValueError, match="31-bit"):
        coo_to_whell(coo, device="cpu")
    monkeypatch.setattr(tconv, "_MAX_TILE_PAGE", n_groups)
    coo_to_whell(coo, device="cpu")


def test_f1_classic_raises_past_the_page_field(monkeypatch):
    coo = CASES["rect"](tfix)  # 1,200 columns: 16 x pages
    monkeypatch.setattr(tconv, "_MAX_TILE_PAGE", 8)
    with pytest.raises(ValueError, match="31-bit"):
        coo_to_whell(coo, device="cpu", packed=False)


def test_f1_check_rejects_a_hand_wrapped_layout(monkeypatch):
    """A bridged or hand-built layout cannot wrap either: ``check()``
    rejects an aligned layout past the page word (packed or classic) and
    a scattered one past the group word."""
    coo = CASES["laplace_wide"](tfix)
    aligned = coo_to_whell(coo, device="cpu", scattered=False)
    classic = coo_to_whell(coo, device="cpu", packed=False)
    scattered = coo_to_whell(coo, device="cpu")
    for a in (aligned, classic, scattered):
        a.check()
    monkeypatch.setattr(twhell, "MAX_TILE_PAGE",
                        min(aligned.x_pages, classic.x_pages) - 1)
    for a in (aligned, classic):
        with pytest.raises(ValueError, match="31-bit base page"):
            a.check()
    scattered.check()
    monkeypatch.setattr(twhell, "MAX_TILE_PAGE",
                        scattered.group_bases.numel() // 4 - 1)
    with pytest.raises(ValueError, match="31-bit group"):
        scattered.check()
    # through the bridge too
    ja = j_coo_to_whell(CASES["laplace_wide"](jfix), packed=True, scattered=False)
    with pytest.raises(ValueError, match="31-bit base page"):
        bridge(ja)


# --------------------------------------------------------------------------
# kernel #15's work list: the live (tile, 32-lane quarter) units of a
# classic slab, each with the mask of its slots that hold a nonzero


def _explicit_zeros(f):
    """The fem fixture with every fifth entry stored as an explicit 0."""
    coo = CASES["fem"](f)
    v = coo.values.copy()
    v[::5] = 0
    return f.CooMatrix(coo.rows, coo.cols, v, coo.n_rows, coo.n_cols)


WORK_FIXTURES = {"fem": CASES["fem"], "explicit_zeros": _explicit_zeros}
WORK_OPTIONS = pytest.mark.parametrize(
    "kw", [{}, dict(sort_rows=True), dict(ways=2), dict(dtype="bfloat16")],
    ids=["plain", "oell", "ways2", "bf16"])


def _listed_cells(a):
    """(S, 128) bool: the cells in a listed unit's set slot."""
    T = a.num_tiles
    wl = a.work_list
    live = torch.zeros((T * 4, 8), dtype=torch.bool)
    live[wl >> 8] = ((wl & 0xFF).view(-1, 1) >> torch.arange(8) & 1).bool()
    # unit (t, q), slot s  ->  cells (t*8 + s, q*32 .. q*32 + 31)
    return live.view(T, 4, 8).permute(0, 2, 1).unsqueeze(-1).expand(
        T, 8, 4, 32).reshape(T * 8, 128)


@WORK_OPTIONS
@pytest.mark.parametrize("fixture", sorted(WORK_FIXTURES))
def test_classic_work_list_covers_every_nonzero(fixture, kw):
    """Every nonzero cell lies in a listed unit whose mask bit is set; no
    listed unit or set slot is all zero; the list is ascending."""
    a = coo_to_whell(WORK_FIXTURES[fixture](tfix), device="cpu", packed=False, **kw)
    wl = a.work_list
    assert wl.dtype == torch.int64 and wl.numel() > 0
    assert bool((wl[1:] >> 8 > wl[:-1] >> 8).all())
    nz = a.values != 0
    assert not bool((nz & ~_listed_cells(a)).any())
    # per unit t*4 + q: which of its 8 slots hold a nonzero
    slot_live = nz.view(a.num_tiles, 8, 4, 32).any(dim=3).permute(0, 2, 1).reshape(-1, 8)
    bits = ((wl & 0xFF).view(-1, 1) >> torch.arange(8) & 1).bool()
    assert torch.equal(slot_live[wl >> 8], bits)
    assert wl.numel() == int(slot_live.any(dim=1).sum())
    a.check()


@WORK_OPTIONS
@pytest.mark.parametrize("fixture", sorted(WORK_FIXTURES))
def test_classic_work_list_drop_unlisted_is_bit_identical(fixture, kw):
    """The full-layout plain product over the listed cells alone (every
    unlisted cell set to 0) equals the one over every cell, bit for bit."""
    coo = WORK_FIXTURES[fixture](tfix)
    a = coo_to_whell(coo, device="cpu", packed=False, **kw)
    x2 = tops._prep_x(torch.from_numpy(_x(coo.n_cols, 4)), a.n_cols, a.x_pages)
    args = (a.residue, a.page_tab, a.tile_base, a.chunk_group, x2)
    full = kc.whell_classic_spmv_plain(a.values, *args, num_groups=a.num_groups,
                                       tile_page=a.tile_page)
    kept = torch.where(_listed_cells(a), a.values, torch.zeros((), dtype=a.values.dtype))
    assert int((kept != 0).sum()) == int((a.values != 0).sum())
    assert torch.equal(kc.whell_classic_spmv_plain(kept, *args, num_groups=a.num_groups,
                                                   tile_page=a.tile_page), full)


@pytest.mark.parametrize("how", ["update_values", "bridge", "to"])
def test_classic_work_list_is_rebuilt(how):
    """A new layout derives a new list: ``whell_update_values`` when a cell
    stored as an explicit 0 becomes nonzero (the list grows), and the JAX
    bridge and ``.to()``."""
    if how == "bridge":
        ja = j_coo_to_whell(_explicit_zeros(jfix))
        a = bridge(ja)
        assert torch.equal(a.work_list, twhell.classic_work_list(a.values))
        return
    a, plan = coo_to_whell(_explicit_zeros(tfix), device="cpu", packed=False,
                           return_plan=True)
    if how == "to":
        b = a.to("cpu")
        assert b.work_list is not a.work_list
        assert torch.equal(b.work_list, a.work_list)
        return
    newv = np.random.default_rng(2).standard_normal(a.nnz).astype(np.float32)
    b = whell_update_values(a, plan, newv)
    assert b.work_list.numel() > a.work_list.numel()
    assert torch.equal(b.work_list, twhell.classic_work_list(b.values))
    assert not bool(((b.values != 0) & ~_listed_cells(b)).any())
    b.check()


@WORK_OPTIONS
def test_classic_check_rejects_a_stale_work_list(kw):
    """A slab changed in place after the list was built: a cell of an
    unlisted unit made nonzero, or every value of a listed unit zeroed."""
    a = coo_to_whell(CASES["fem"](tfix), device="cpu", packed=False, **kw)
    a.check()
    dead = (~_listed_cells(a)).nonzero()[0]
    a.values[dead[0], dead[1]] = 1.0
    with pytest.raises(ValueError, match="work_list"):
        a.check()
    b = coo_to_whell(CASES["fem"](tfix), device="cpu", packed=False, **kw)
    t, q = int(b.work_list[0] >> 10), int(b.work_list[0] >> 8 & 3)
    b.values[t * 8: t * 8 + 8, q * 32: q * 32 + 32] = 0
    with pytest.raises(ValueError, match="work_list"):
        b.check()


def test_work_list_only_on_classic_layouts():
    coo = CASES["fem"](tfix)
    packed = coo_to_whell(coo, device="cpu")
    assert packed.work_list is None
    packed.check()
    packed.work_list = twhell.classic_work_list(packed.values)
    with pytest.raises(ValueError, match="no work_list"):
        packed.check()
    assert not hasattr(coo_to_whell_percell(coo, device="cpu"), "work_list")


def test_classic_inf_behind_padding_is_nan_in_the_full_layout_product():
    """Reference behaviour: the JAX kernel, like the port's plain version
    (the CPU path), multiplies every padding cell, so an Inf in x at a
    column that only zero-valued cells reference turns lanes into NaN.
    Kernel #15 skips those cells and gives the golden (tests/
    test_torch_cuda.py::test_classic_kernel_skips_padding_inf); a
    deviation (ROADMAP §3)."""
    def cut(f):  # no entry in a column ≡ 0 (mod 128): those only padding reads
        coo = CASES["fem"](f)
        keep = coo.cols % 128 != 0
        return f.CooMatrix(coo.rows[keep], coo.cols[keep], coo.values[keep],
                           coo.n_rows, coo.n_cols)
    ja = j_coo_to_whell(cut(jfix))
    ta = bridge(ja)
    x = _x(4000, 3)
    x[::128] = np.inf
    golden = cut(tfix).spmv(x.astype(np.float64))
    assert np.isfinite(golden).all()
    zj = np.asarray(whell_spmv_pallas(ja, jnp.asarray(x), interpret=True))
    zt = tops.whell_spmv(ta, torch.from_numpy(x)).numpy()
    assert np.isnan(zj).any()
    np.testing.assert_array_equal(np.isnan(zt), np.isnan(zj))
    ok = ~np.isnan(zj)
    np.testing.assert_allclose(zt[ok], golden[ok], **TOL)
