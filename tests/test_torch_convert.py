"""PyTorch port: host side against the JAX package on the same inputs.

The port's converter, fixtures, format selection and type table must
reproduce the JAX package's exactly (bit-identical layout arrays), so the
two packages hold one layout for the same COO.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu import core as jcore  # noqa: E402
from spgpu_tpu import ops as jops  # noqa: E402
from spgpu_tpu.convert import estimate_formats as j_estimate  # noqa: E402
from spgpu_tpu.convert.whell import coo_to_whell as j_coo_to_whell  # noqa: E402
from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.utils import fixtures as jfix  # noqa: E402
from spgpu_tpu_torch import core as tcore  # noqa: E402
from spgpu_tpu_torch import ops  # noqa: E402
from spgpu_tpu_torch.convert import coo_to_whell, estimate_formats, suggest_format  # noqa: E402
from spgpu_tpu_torch.convert.whell import local_degree_perm, symmetric_relabel  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.formats.whell import from_numpy_fields  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)

# the sizes of tests/test_whell.py's cases (square ones: packed needs it)
CASES = {
    "fem": lambda f: f.random_fem_like(4000, 16.0, span=256, far_frac=0.02,
                                       seed=5, dtype=np.float32),
    "laplace": lambda f: f.laplacian_2d(23, 31, np.float32),
    "laplace_wide": lambda f: f.laplacian_2d(200, 30, np.float32),
    "irregular": lambda f: f.random_irregular(1000, 1000, 9.0, seed=3,
                                              dtype=np.float32),
    "banded": lambda f: f.random_banded(900, bands=7, wander=13, seed=4,
                                        dtype=np.float32),
    "ctest": lambda f: f.ctest_fixture(np.float32),
    "empty": lambda f: f.CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                   np.zeros(0, np.float32), 300, 300),
}

ARRAYS = ("values", "residue", "page_tab", "tile_base", "chunk_group",
          "seg_lo", "seg_hi", "lane_of_row", "group_bases")
STATIC = ("n_rows", "n_cols", "num_hacks", "num_groups", "total_slots", "nnz",
          "x_pages", "window_pages", "orig_rows", "group_hacks", "chunk_tiles",
          "unit_segments")


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


@pytest.mark.parametrize("scattered", [True, False], ids=["scattered", "aligned"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_converter_bit_identical(name, scattered):
    ja = j_coo_to_whell(CASES[name](jfix), packed=True, scattered=scattered)
    ta = coo_to_whell(CASES[name](tfix), device="cpu", scattered=scattered)
    assert_same_layout(ja, ta)


@pytest.mark.parametrize("window_pages", [8, 16])
def test_converter_window_pages_bit_identical(window_pages):
    ja = j_coo_to_whell(CASES["fem"](jfix), packed=True, scattered=False,
                        window_pages=window_pages)
    ta = coo_to_whell(CASES["fem"](tfix), device="cpu", scattered=False,
                      window_pages=window_pages)
    assert_same_layout(ja, ta)


@pytest.mark.parametrize("name", ["fem", "irregular"])
def test_converter_bf16_bit_identical(name):
    ja = j_coo_to_whell(CASES[name](jfix), packed=True, dtype=jnp.bfloat16)
    ta = coo_to_whell(CASES[name](tfix), device="cpu", dtype=torch.bfloat16)
    assert ta.values.dtype == torch.bfloat16
    assert_same_layout(ja, ta)


def test_converter_unsorted_duplicates_bit_identical():
    """A raw COO out of (row, col) order with duplicate coordinates."""
    rng = np.random.default_rng(21)
    n, m = 700, 6000
    rows = rng.integers(0, n, m)
    cols = np.clip(rows + rng.integers(-90, 91, m), 0, n - 1)
    vals = rng.standard_normal(m).astype(np.float32)
    rows, cols, vals = (np.r_[rows, rows[:50]], np.r_[cols, cols[:50]],
                        np.r_[vals, vals[:50]])
    ja = j_coo_to_whell(JCoo(rows, cols, vals, n, n), packed=True)
    ta = coo_to_whell(CooMatrix(rows, cols, vals, n, n), device="cpu")
    assert_same_layout(ja, ta)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bridge_roundtrip(name):
    """The bridge carries a JAX layout across unchanged (and checks it)."""
    ja = j_coo_to_whell(CASES[name](jfix), packed=True)
    ta = from_numpy_fields(
        {f: (None if getattr(ja, f) is None else np.asarray(getattr(ja, f)))
         for f in ARRAYS + ("row_perm", "values_lo")},
        **{f: getattr(ja, f) for f in STATIC + ("ways",)})
    assert_same_layout(ja, ta)


def test_bridge_refuses_unported_layouts():
    """Classic layouts cross now, with their ``row_perm`` and ``ways``
    (tests/test_torch_classic.py), a float64 one as its plain float64
    slab, whose product then matches the JAX op's and the golden; what
    still refuses is a complex classic layout, which the JAX op refuses
    too (its Pallas interpreter takes no complex kernel output).  A
    double-float packed slab crosses, joined into float64
    (tests/test_torch_f64.py)."""
    coo = jfix.laplacian_2d(10, 10, np.float32)
    classic = j_coo_to_whell(coo, ways=2)
    fields = {f: (None if getattr(classic, f) is None else np.asarray(getattr(classic, f)))
              for f in ARRAYS + ("row_perm",)}
    ta = from_numpy_fields(fields, ways=2, **{f: getattr(classic, f) for f in STATIC})
    assert not ta.packed and ta.ways == 2
    x = np.random.default_rng(2).standard_normal(100)
    for dt in (np.float64, np.complex64):
        c = JCoo(coo.rows, coo.cols, coo.values.astype(dt), 100, 100)
        wide = j_coo_to_whell(c)
        fields = {f: (None if getattr(wide, f) is None else np.asarray(getattr(wide, f)))
                  for f in ARRAYS + ("row_perm",)}
        xj = jnp.asarray(x.astype(dt))
        if dt == np.float64:
            ta = from_numpy_fields(fields, **{f: getattr(wide, f) for f in STATIC})
            assert not ta.packed and ta.values.dtype == torch.float64
            zt = ops.whell_spmv(ta, torch.from_numpy(x)).numpy()
            zj = np.asarray(jops.whell_spmv(wide, xj, interpret=True))
            for want in (zj, c.spmv(x)):
                assert np.abs(zt - want).max() <= 1e-12 * np.abs(want).max()
            continue
        with pytest.raises(NotImplementedError, match="no complex classic WHELL"):
            from_numpy_fields(fields, **{f: getattr(wide, f) for f in STATIC})
        with pytest.raises(NotImplementedError):
            jops.whell_spmv(wide, xj, interpret=True)


def test_bridge_check_rejects_out_of_range_pages():
    ja = j_coo_to_whell(CASES["fem"](jfix), packed=True)
    fields = {f: (None if getattr(ja, f) is None else np.array(getattr(ja, f)))
              for f in ARRAYS}
    fields["group_bases"][0] = ja.x_pages  # a window past the end of x
    with pytest.raises(ValueError, match="page range"):
        from_numpy_fields(fields, **{f: getattr(ja, f) for f in STATIC})


def test_to_dense_matches_coo_in_lane_space():
    coo = CASES["fem"](tfix)
    a = coo_to_whell(coo, device="cpu")
    lor = a.lane_of_row.numpy().astype(np.int64)
    want = np.zeros((a.n_rows, a.n_cols), np.float32)
    np.add.at(want, (lor[coo.rows], lor[coo.cols]), coo.values)
    np.testing.assert_allclose(a.to_dense(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float16, np.int32])
def test_converter_refuses_other_dtypes(dtype):
    coo = tfix.laplacian_2d(8, 8, np.float64)
    coo = CooMatrix(coo.rows, coo.cols, coo.values.astype(dtype), 64, 64)
    with pytest.raises(NotImplementedError, match="float32 or float64 values"):
        coo_to_whell(coo, device="cpu")


def test_converter_complex64_matches_jax_planes():
    """A complex64 COO converts once, into the structure of the JAX
    ``WhellComplex``'s planes and a complex slab ``ar + i·ai``
    (tests/test_torch_complex.py covers complex in full)."""
    c = CASES["laplace"](jfix)
    v = (c.values + 1j * np.random.default_rng(3).standard_normal(c.nnz)).astype(np.complex64)
    ja = j_coo_to_whell(JCoo(c.rows, c.cols, v, c.n_rows, c.n_cols), packed=True)
    ta = coo_to_whell(CooMatrix(c.rows, c.cols, v, c.n_rows, c.n_cols), device="cpu")
    assert ta.values.dtype == torch.complex64
    for f in ARRAYS[1:]:
        jv, tv = getattr(ja.ar, f), getattr(ta, f)
        assert (jv is None) == (tv is None), f
        if jv is not None:
            np.testing.assert_array_equal(np.asarray(jv), tv.numpy(), err_msg=f)
    for f in STATIC:
        assert getattr(ja.ar, f) == getattr(ta, f), f
    np.testing.assert_array_equal(ta.values.numpy().real, np.asarray(ja.ar.values))
    np.testing.assert_array_equal(ta.values.numpy().imag, np.asarray(ja.ai.values))


def test_converter_refuses_bad_shapes_and_windows():
    rect = tfix.random_irregular(70, 120, 6.0, seed=8, dtype=np.float32)
    with pytest.raises(ValueError, match="square"):
        coo_to_whell(rect, device="cpu")
    with pytest.raises(ValueError, match="window_pages"):
        coo_to_whell(tfix.laplacian_2d(8, 8, np.float32), device="cpu",
                     window_pages=24)


@pytest.mark.parametrize("name,make", [
    ("laplacian_2d", lambda f: f.laplacian_2d(17, 9)),
    ("random_fem_like", lambda f: f.random_fem_like(3000, 12.0, span=200,
                                                    far_frac=0.02, seed=9)),
    ("random_irregular", lambda f: f.random_irregular(500, 700, 7.0, seed=11,
                                                      dtype=np.complex128)),
    ("random_banded", lambda f: f.random_banded(900, bands=7, wander=13, seed=4)),
    ("ctest_fixture", lambda f: f.ctest_fixture()),
])
def test_fixtures_byte_identical(name, make):
    j, t = make(jfix), make(tfix)
    for f in ("rows", "cols", "values"):
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (name, f)
    assert j.shape == t.shape


def test_coo_host_methods_match():
    j = jfix.ctest_fixture(np.float32)
    t = tfix.ctest_fixture(np.float32)
    x = np.random.default_rng(2).standard_normal(100)
    np.testing.assert_array_equal(j.spmv(x), t.spmv(x))
    np.testing.assert_array_equal(j.to_dense(), t.to_dense())
    np.testing.assert_array_equal(j.row_lengths(), t.row_lengths())
    js, ts = j.sum_duplicates(), t.sum_duplicates()
    for f in ("rows", "cols", "values"):
        np.testing.assert_array_equal(getattr(js, f), getattr(ts, f))


@pytest.mark.parametrize("name", sorted(CASES))
def test_select_matches(name):
    j, t = CASES[name](jfix), CASES[name](tfix)
    je, te = j_estimate(j), estimate_formats(t)
    assert je.keys() == te.keys()
    for k in je:
        assert je[k].json() == te[k].json()
    from spgpu_tpu.convert import suggest_format as j_suggest

    assert j_suggest(j) == suggest_format(t)


def test_relabel_helpers_match():
    from spgpu_tpu.convert.whell import local_degree_perm as j_ldp
    from spgpu_tpu.convert.whell import symmetric_relabel as j_rel

    j, t = CASES["fem"](jfix), CASES["fem"](tfix)
    pj, pt = j_ldp(j, window=512), local_degree_perm(t, window=512)
    np.testing.assert_array_equal(pj, pt)
    rj, rt = j_rel(j, pj), symmetric_relabel(t, pt)
    np.testing.assert_array_equal(rj.rows, rt.rows)
    np.testing.assert_array_equal(rj.cols, rt.cols)


def test_core_parity():
    assert [(s.name, int(s)) for s in jcore.Status] == \
        [(s.name, int(s)) for s in tcore.Status]
    assert [(s.name, int(s)) for s in jcore.TypeCode] == \
        [(s.name, int(s)) for s in tcore.TypeCode]
    for code in jcore.TypeCode:
        assert jcore.size_of(code) == tcore.size_of(code)
    assert tcore.LANES == jcore.LANES and tcore.CHUNK_TILES == jcore.CHUNK_TILES
    assert tcore.round_up(130, 128) == jcore.round_up(130, 128) == 256
    assert tcore.cdiv(257, 128) == jcore.cdiv(257, 128) == 3


def test_require_cuda_raises_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.require_cuda()


def test_native_build_raises_without_compiler(monkeypatch, tmp_path):
    """No g++: the layout helpers raise instead of a NumPy fallback."""
    from spgpu_tpu_torch import native

    monkeypatch.setattr(native, "_SO", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.build()
