"""PyTorch port, complex64 (C) and complex128 (Z) against the JAX package.

The JAX package keeps a complex matrix as two real-plane layouts of one
structure (``WhellComplex`` or ``ComplexPlanes``: ``ar``, ``ai``; Z planes
are double-float pairs) and its vectors as ``[re, im]`` plane stacks; the
port keeps one layout with a complex slab and complex vectors.  So:

* the complex converters build the structural arrays of the JAX ``ar``
  plane bit for bit, on fixtures where a third of the entries are purely
  real and a third purely imaginary (one plane then holds explicit
  zeros), and the JAX planes themselves share one structure (the guard
  that lets the port convert the structure once);
* the bridges join ``ar + i·ai`` (double-float pairs joined first for Z);
* the complex SpMVs (plain versions of the complex kernels on CPU
  tensors) agree with the JAX ops in interpret mode and with the host
  complex128 golden: 3e-5·max|z| in complex64, 1e-12·max|z| in
  complex128 (the Z planes keep ~48 bits), complex alpha/beta/y included;
* the complex solvers: ``tests/test_torch_complex_solve.py``.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu import ops as jops  # noqa: E402
from spgpu_tpu.convert.sdia import coo_to_sdia as j_coo_to_sdia  # noqa: E402
from spgpu_tpu.convert.whdia import coo_to_whdia as j_coo_to_whdia  # noqa: E402
from spgpu_tpu.convert.whell import coo_to_whell as j_coo_to_whell  # noqa: E402
from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.utils import fixtures as jfix  # noqa: E402
from spgpu_tpu_torch import ops as tops  # noqa: E402
from spgpu_tpu_torch.convert import coo_to_sdia, coo_to_whdia, coo_to_whell  # noqa: E402
from spgpu_tpu_torch.core import join_planes, real_part_dtype, value_dtype  # noqa: E402
from spgpu_tpu_torch.formats import dia as tdia  # noqa: E402
from spgpu_tpu_torch.formats import whdia as twhdia  # noqa: E402
from spgpu_tpu_torch.formats import whell as twhell  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.kernels import sdia as ks  # noqa: E402
from spgpu_tpu_torch.kernels import whdia as kd  # noqa: E402
from spgpu_tpu_torch.kernels import whell as kw  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)

CDTYPES = ("complex64", "complex128")
TORCH = {"complex64": torch.complex64, "complex128": torch.complex128}
#: SpMV tolerance, as a fraction of max|z|
SPMV_TOL = {"complex64": 3e-5, "complex128": 1e-12}

WHELL_ARRAYS = ("residue", "page_tab", "tile_base", "chunk_group", "seg_lo",
                "seg_hi", "lane_of_row", "group_bases")
WHELL_STATIC = ("n_rows", "n_cols", "num_hacks", "num_groups", "total_slots",
                "nnz", "x_pages", "window_pages", "orig_rows", "group_hacks",
                "chunk_tiles", "unit_segments")
WHDIA_ARRAYS = ("slot_r0", "tile_r0", "tile_base", "chunk_group")
WHDIA_STATIC = ("n_rows", "n_cols", "num_hacks", "num_groups", "total_slots",
                "nnz", "x_pages", "window_pages", "group_hacks", "chunk_tiles")


def mixed(coo, dtype, seed=8):
    """``coo``'s pattern with values ``v + 1j·N(0, 1)``: a third of them
    purely real, a third purely imaginary, as ``dtype``."""
    rng = np.random.default_rng(seed)
    v = coo.values.astype(np.float64) + 1j * rng.standard_normal(coo.nnz)
    kind = rng.integers(0, 3, coo.nnz)
    v = np.where(kind == 0, v.real, np.where(kind == 1, 1j * v.imag, v))
    return v.astype(dtype)


def _pair(make, dtype):
    """The same mixed complex COO in both packages."""
    c = make(jfix)
    v = mixed(c, dtype)
    return (JCoo(c.rows, c.cols, v, c.n_rows, c.n_cols),
            CooMatrix(c.rows, c.cols, v, c.n_rows, c.n_cols))


# a 3,000-row FEM-like WHELL, a 2,000-row wandering banded-7 WHDIA and a
# 40x40 Laplacian, plus small cases for the interpret-mode products
WHELL_CASES = {
    "fem": lambda f: f.random_fem_like(3000, 12.0, span=200, far_frac=0.02, seed=9),
    "laplace": lambda f: f.laplacian_2d(23, 31),
    "ctest": lambda f: f.ctest_fixture(np.float64),
}
DIA_CASES = {
    "laplace": lambda f: f.laplacian_2d(40, 40),
    "banded": lambda f: f.random_banded(2000, bands=7, wander=7, seed=4),
    "contig": lambda f: f.random_banded(1500, bands=5, wander=0, seed=3),
}


def _fields(m, names):
    return {f: None if getattr(m, f, None) is None else np.asarray(getattr(m, f))
            for f in names}


def _near(z, want, frac, what=""):
    z, want = np.asarray(z, np.complex128), np.asarray(want, np.complex128)
    assert z.shape == want.shape, what
    scale = max(np.abs(want).max(initial=0.0), 1e-300)
    np.testing.assert_allclose(z, want, rtol=0, atol=frac * scale, err_msg=what)


def _cvec(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


# --------------------------------------------------------------------------
# value types


def test_value_dtype_admits_complex():
    for name in ("float32", "float64", "complex64", "complex128"):
        assert value_dtype(np.dtype(name), "x") == np.dtype(name)
        assert value_dtype(getattr(torch, name), "x") == np.dtype(name)
    for bad in (np.float16, np.int32):
        with pytest.raises(NotImplementedError, match="planned"):
            value_dtype(bad, "x")
    assert real_part_dtype(torch.complex64) == torch.float32
    assert real_part_dtype(torch.complex128) == torch.float64
    assert real_part_dtype(torch.float64) == torch.float64


def test_join_planes():
    rng = np.random.default_rng(1)
    ar, ai = (torch.from_numpy(rng.standard_normal(9).astype(np.float32))
              for _ in range(2))
    z = join_planes(ar, ai)
    assert z.dtype == torch.complex64
    assert torch.equal(z.real, ar) and torch.equal(z.imag, ai)
    lo = torch.full((9,), 2.0 ** -30)
    z = join_planes(ar, ai, lo, -lo)
    assert z.dtype == torch.complex128
    assert torch.equal(z.real, ar.double() + 2.0 ** -30)
    assert torch.equal(z.imag, ai.double() - 2.0 ** -30)
    with pytest.raises(ValueError, match="both planes"):
        join_planes(ar, ai, lo)
    with pytest.raises(ValueError, match="one shape"):
        join_planes(ar, ai[:3])


# --------------------------------------------------------------------------
# converters: one structure, the JAX ``ar`` plane's


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("name", sorted(WHELL_CASES))
def test_whell_converter_matches_ar_plane(name, dtype):
    jc, tc = _pair(WHELL_CASES[name], dtype)
    ja = j_coo_to_whell(jc, packed=True)
    # complex128: the JAX double-float planes' aligned windows (the port's
    # default is scattered)
    ta = coo_to_whell(tc, device="cpu", scattered=dtype == "complex64")
    assert ta.values.dtype == TORCH[dtype]
    assert ja.ar.is_dd == (dtype == "complex128")
    for f in WHELL_ARRAYS:
        jv, iv, tv = getattr(ja.ar, f), getattr(ja.ai, f), getattr(ta, f)
        assert (jv is None) == (tv is None) == (iv is None), f
        if jv is not None:
            np.testing.assert_array_equal(np.asarray(jv), np.asarray(iv), err_msg=f)
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=f)
    for f in WHELL_STATIC:
        assert getattr(ja.ar, f) == getattr(ja.ai, f) == getattr(ta, f), f
    # the cells hold the COO's complex values, exactly (duplicates stay
    # separate cells)
    v = ta.values.numpy()
    np.testing.assert_array_equal(np.sort_complex(v[v != 0]),
                                  np.sort_complex(tc.values[tc.values != 0]))
    if dtype == "complex64":  # fp32 planes: the same bits
        np.testing.assert_array_equal(v.real, np.asarray(ja.ar.values))
        np.testing.assert_array_equal(v.imag, np.asarray(ja.ai.values))


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("name", sorted(DIA_CASES))
def test_sdia_converter_matches_ar_plane(name, dtype):
    jc, tc = _pair(DIA_CASES[name], dtype)
    ja = j_coo_to_sdia(jc)
    ta = coo_to_sdia(tc, device="cpu")
    assert ta.values.dtype == TORCH[dtype]
    assert ta.offsets == ja.ar.offsets == ja.ai.offsets
    assert ta.values.shape == ja.ar.values.shape
    ta.check()
    np.testing.assert_array_equal(ta.to_dense(), tc.to_dense())
    if dtype == "complex64":
        np.testing.assert_array_equal(ta.values.numpy().real, np.asarray(ja.ar.values))
        np.testing.assert_array_equal(ta.values.numpy().imag, np.asarray(ja.ai.values))


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("name", sorted(DIA_CASES))
def test_whdia_converter_matches_ar_plane(name, dtype):
    """Structure and r0 as the JAX ``ar`` plane.  complex128 takes the
    float64 geometry and packs r0 per tile where the float64 layout
    would (the JAX double-float planes read the r0 slab only): r0 is then
    compared on the live slots."""
    jc, tc = _pair(DIA_CASES[name], dtype)
    ja = j_coo_to_whdia(jc)
    ta = coo_to_whdia(tc, device="cpu")
    assert ta.values.dtype == TORCH[dtype]
    for f in WHDIA_ARRAYS:
        jv, iv = getattr(ja.ar, f), getattr(ja.ai, f)
        assert (jv is None) == (iv is None), f
        if jv is not None:
            np.testing.assert_array_equal(np.asarray(jv), np.asarray(iv), err_msg=f)
    for f in ("tile_base", "chunk_group"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja.ar, f)), err_msg=f)
    for f in WHDIA_STATIC:
        assert getattr(ja.ar, f) == getattr(ja.ai, f) == getattr(ta, f), f
    r0t, r0j = ta.slot_r0_host(), ja.ar.slot_r0_host()
    if ta.pattern_mode != (ja.ar.tile_r0 is not None):
        live = (ta.values.numpy() != 0).any(axis=1)
        r0t, r0j = r0t[live], r0j[live]
    np.testing.assert_array_equal(r0t, r0j)
    real = value_dtype(torch.float64 if dtype == "complex128" else torch.float32, "x")
    fr = coo_to_whdia(CooMatrix(tc.rows, tc.cols, tc.values.real.astype(real),
                                tc.n_rows, tc.n_cols), device="cpu")
    assert ta.pattern_mode == fr.pattern_mode  # the real type's r0-mode rule
    ta.check()
    np.testing.assert_array_equal(ta.to_dense(), tc.to_dense())


def test_real_coo_takes_complex_slab():
    """``dtype=complex64`` on a real COO gives zero imaginary parts."""
    c = tfix.laplacian_2d(12, 9, np.float32)
    a = coo_to_whell(c, device="cpu", dtype=torch.complex64)
    b = coo_to_whell(c, device="cpu")
    assert a.values.dtype == torch.complex64
    np.testing.assert_array_equal(a.values.numpy().real, b.values.numpy())
    assert not a.values.numpy().imag.any()


# --------------------------------------------------------------------------
# bridges


def _whell_bridge(ja):
    names = WHELL_ARRAYS + ("values", "values_lo", "row_perm")
    return twhell.from_numpy_planes(_fields(ja.ar, names), _fields(ja.ai, names),
                                    **{f: getattr(ja.ar, f) for f in WHELL_STATIC})


def _sdia_bridge(ja):
    names = ("values", "values_lo", "offsets")
    return tdia.from_numpy_planes(
        {**_fields(ja.ar, names[:2]), "offsets": ja.ar.offsets},
        {**_fields(ja.ai, names[:2]), "offsets": ja.ai.offsets},
        ja.n_rows, ja.n_cols)


def _whdia_bridge(ja):
    names = WHDIA_ARRAYS + ("values", "values_lo")
    return twhdia.from_numpy_planes(_fields(ja.ar, names), _fields(ja.ai, names),
                                    **{f: getattr(ja.ar, f) for f in WHDIA_STATIC})


BRIDGES = {"whell": (j_coo_to_whell, _whell_bridge),
           "sdia": (j_coo_to_sdia, _sdia_bridge),
           "whdia": (j_coo_to_whdia, _whdia_bridge)}


def _jax_layout(layout, jc):
    conv = BRIDGES[layout][0]
    return conv(jc, packed=True) if layout == "whell" else conv(jc)


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("layout", sorted(BRIDGES))
def test_bridge_joins_planes(layout, dtype):
    """A JAX complex layout crosses as one complex slab ``ar + i·ai``,
    each double-float plane joined as ``hi + lo`` first."""
    jc, tc = _pair(WHELL_CASES["laplace"], dtype)
    ja = _jax_layout(layout, jc)
    ta = BRIDGES[layout][1](ja)
    assert ta.values.dtype == TORCH[dtype]

    def plane(p):
        v = np.asarray(p.values, np.float64)
        return v if p.values_lo is None else v + np.asarray(p.values_lo, np.float64)

    want = plane(ja.ar) + 1j * plane(ja.ai)
    np.testing.assert_array_equal(ta.values.numpy(), want.astype(dtype))
    # the port's own converter holds the COO's values in the same cells:
    # equal in complex64, within the pair's ~48 bits in complex128
    own = {"whell": coo_to_whell, "sdia": coo_to_sdia, "whdia": coo_to_whdia}[layout](
        tc, device="cpu").values.numpy()
    _near(own, ta.values.numpy(), 0 if dtype == "complex64" else 1e-14)


@pytest.mark.parametrize("layout", ["whell", "whdia"])
def test_bridge_refuses_planes_of_two_structures(layout):
    c64 = np.complex64
    ja = _jax_layout(layout, _pair(WHELL_CASES["laplace"], c64)[0])
    jb = _jax_layout(layout, _pair(WHELL_CASES["fem"], c64)[0])
    with pytest.raises(ValueError, match="share one structure"):
        BRIDGES[layout][1](types.SimpleNamespace(ar=ja.ar, ai=jb.ai))


def test_sdia_bridge_refuses_other_offsets():
    ar = {"values": np.zeros((2, 16, 128), np.float32), "values_lo": None,
          "offsets": (0, 1)}
    with pytest.raises(ValueError, match="offsets"):
        tdia.from_numpy_planes(ar, {**ar, "offsets": (0, 2)}, 100, 100)


# --------------------------------------------------------------------------
# SpMV against the JAX ops (interpret mode) and the golden


AB = {"plain": (1.0, 0.0), "alpha_beta": (2.5 - 1j, 0.5j)}


def _spmv_case(layout, name, dtype, ab):
    cases = WHELL_CASES if layout == "whell" else DIA_CASES
    jc, tc = _pair(cases[name], dtype)
    ja = _jax_layout(layout, jc)
    ta = BRIDGES[layout][1](ja)
    alpha, beta = AB[ab]
    x, y = _cvec(jc.n_cols, 0), _cvec(jc.n_rows, 1)
    zj = ja.extract_complex(np.asarray(getattr(jops, f"{layout}_spmv")(
        ja, jnp.asarray(ja.embed_complex(x)), alpha=alpha, beta=beta,
        y=jnp.asarray(ja.embed_complex(y)))))
    tdt = TORCH[dtype]
    op = getattr(tops, f"{layout}_spmv")
    if layout == "whell":
        zt = ta.extract(op(ta, ta.embed(x, tdt), alpha=alpha, beta=beta,
                           y=ta.embed(y, tdt)), tdt)
    else:
        zt = op(ta, torch.from_numpy(x).to(tdt), alpha=alpha, beta=beta,
                y=torch.from_numpy(y).to(tdt))
    assert zt.dtype == tdt
    # the golden on the values and vectors as stored in the working type
    xs, ys = (v.astype(dtype).astype(np.complex128) for v in (x, y))
    golden = alpha * tc.spmv(xs) + beta * ys
    return zt.numpy(), zj, golden


@pytest.mark.parametrize("ab", sorted(AB))
@pytest.mark.parametrize("dtype", CDTYPES)
def test_whell_spmv_matches_jax_and_golden(dtype, ab):
    """The Laplacian (unit segments); complex64 runs the JAX fused kernel
    (#7), complex128 four double-float plane products of #4."""
    zt, zj, golden = _spmv_case("whell", "laplace", dtype, ab)
    _near(zt, zj, SPMV_TOL[dtype], "vs JAX")
    _near(zt, golden, SPMV_TOL[dtype], "vs golden")


@pytest.mark.parametrize("ab", sorted(AB))
@pytest.mark.parametrize("dtype", CDTYPES)
def test_sdia_spmv_matches_jax_and_golden(dtype, ab):
    zt, zj, golden = _spmv_case("sdia", "laplace", dtype, ab)
    _near(zt, zj, SPMV_TOL[dtype], "vs JAX")
    _near(zt, golden, SPMV_TOL[dtype], "vs golden")


@pytest.mark.parametrize("ab", sorted(AB))
@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("name", ["laplace", "contig"])
def test_whdia_spmv_matches_jax_and_golden(name, dtype, ab):
    """complex64 runs the JAX fused kernel (#9, both r0 modes); complex128
    the fused Z kernel (#10) on the slab-mode Laplacian and, since the
    JAX double-float layout is slab mode throughout, there too on the
    band — the bridged port layout takes the JAX ``slot_r0`` slab, the
    port's own converter pattern mode (below)."""
    zt, zj, golden = _spmv_case("whdia", name, dtype, ab)
    _near(zt, zj, SPMV_TOL[dtype], "vs JAX")
    _near(zt, golden, SPMV_TOL[dtype], "vs golden")


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("layout", ["whell", "sdia", "whdia"])
def test_port_layouts_match_golden(layout, dtype):
    """The port's own converters on the larger fixtures (WHELL: the
    3,000-row FEM-like matrix, scattered windows by default in both types;
    SDIA: the Laplacian; WHDIA: the wandering band, pattern mode)."""
    name = {"whell": "fem", "sdia": "laplace", "whdia": "banded"}[layout]
    c = (WHELL_CASES if layout == "whell" else DIA_CASES)[name](tfix)
    tc = CooMatrix(c.rows, c.cols, mixed(c, dtype), c.n_rows, c.n_cols)
    tdt = TORCH[dtype]
    x = _cvec(c.n_cols, 3)
    xs = x.astype(dtype).astype(np.complex128)
    if layout == "whell":
        a = coo_to_whell(tc, device="cpu")
        assert a.scattered
        z = a.extract(tops.whell_spmv(a, a.embed(x, tdt)), tdt)
    else:
        a = (coo_to_sdia if layout == "sdia" else coo_to_whdia)(tc, device="cpu")
        z = getattr(tops, f"{layout}_spmv")(a, torch.from_numpy(x).to(tdt))
        if layout == "whdia":
            assert a.pattern_mode
    _near(z.numpy(), tc.spmv(xs), SPMV_TOL[dtype])


@pytest.mark.parametrize("dtype", CDTYPES)
def test_sdia_complex_plain_is_exact_in_kernel_order(dtype):
    """The complex SDIA plain version rounds ``vr·xr − vi·xi`` and
    ``vr·xi + vi·xr`` operation by operation, then adds, diagonal by
    diagonal in ascending order, as kernels #8 and #11 do: a NumPy loop in
    that order gives the same bits."""
    c = DIA_CASES["banded"](tfix)
    tc = CooMatrix(c.rows, c.cols, mixed(c, dtype), c.n_rows, c.n_cols)
    a = coo_to_sdia(tc, device="cpu")
    x = _cvec(c.n_cols, 2).astype(dtype)
    z = ks.sdia_spmv_plain(a.values, a.offsets, torch.from_numpy(x),
                           n_rows=a.n_rows).numpy()
    planes = a.values.numpy().reshape(a.n_diags, -1)
    zr = np.zeros(a.n_rows, x.real.dtype)
    zi = np.zeros(a.n_rows, x.real.dtype)
    r = np.arange(a.n_rows)
    for j, o in enumerate(a.offsets):
        ok = (r + o >= 0) & (r + o < a.n_cols)
        v, xv = planes[j, r[ok]], x[r[ok] + o]
        zr[ok] = zr[ok] + (v.real * xv.real - v.imag * xv.imag)
        zi[ok] = zi[ok] + (v.real * xv.imag + v.imag * xv.real)
    np.testing.assert_array_equal(z.real, zr)
    np.testing.assert_array_equal(z.imag, zi)


def test_wrappers_refuse_mixed_types():
    """A complex layout takes vectors of its own type only."""
    c = tfix.laplacian_2d(16, 16, np.float64)
    tc = CooMatrix(c.rows, c.cols, c.values.astype(np.complex64), 256, 256)
    for conv, op in ((coo_to_sdia, tops.sdia_spmv), (coo_to_whdia, tops.whdia_spmv)):
        with pytest.raises(ValueError, match="complex64"):
            op(conv(tc, device="cpu"), torch.zeros(256, dtype=torch.complex128))
    a = coo_to_whell(tc, device="cpu")
    with pytest.raises(ValueError, match="x2d"):
        tops.whell_spmv(a, torch.zeros(a.n_cols, dtype=torch.float32))


def test_cpu_path_counts_no_complex_launches():
    c = tfix.laplacian_2d(16, 16, np.float64)
    mods = (kw, ks, kd)
    before = [(m.LAUNCHES_C64, m.LAUNCHES_C128) for m in mods]
    for dt in (np.complex64, np.complex128):
        tc = CooMatrix(c.rows, c.cols, c.values.astype(dt), 256, 256)
        tdt = torch.from_numpy(np.zeros(1, dt)).dtype
        a = coo_to_whell(tc, device="cpu")
        tops.whell_spmv(a, torch.zeros(a.n_cols, dtype=tdt))
        tops.sdia_spmv(coo_to_sdia(tc, device="cpu"), torch.zeros(256, dtype=tdt))
        tops.whdia_spmv(coo_to_whdia(tc, device="cpu"), torch.zeros(256, dtype=tdt))
    assert [(m.LAUNCHES_C64, m.LAUNCHES_C128) for m in mods] == before
