"""PyTorch port: large systems on one layout.

Every packed layout of the port carries ``tile_page``, each tile's layout
group (scattered WHELL, pcell) or window base page (aligned and classic
WHELL, WHDIA) as a full-width int32, beside the JAX ``tile_base`` whose
low field (20 or 16 bits) bounds one JAX layout at 2**20 groups or
65,536 x pages.  Here, against the JAX package on the CPU:

* on the fixtures of the converter parity tests, ``tile_page`` is the
  JAX ``tile_base``'s page or group field and ``tile_base`` stays bit
  for bit the JAX one, through the converters and the bridges;
* the plain versions, the ops and ``to_dense`` read the page or group
  from ``tile_page`` only: zeroing ``tile_base``'s low field changes
  nothing (and ``check()`` rejects such a layout, as it rejects a
  ``tile_page`` out of range or negative); every kernel wrapper and
  plain version requires ``tile_page`` (no call falls back to the low
  field);
* ``solve(fmt="blocks")`` runs the one-layout packed-WHELL route where
  the JAX ``solve()`` builds row blocks: x within 1e-3 (fp32) or 1e-9
  (float64) of the JAX route's, iterations within max(1, 10 %) or 2, and
  the product against the JAX 2-block ``blocks_spmv`` at 2e-5;
* one float64 layout past the aligned 16-bit page bound (an 8.5M-row
  diagonal) gives the golden product.
"""

import dataclasses
import importlib
import inspect
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu.convert.pcell import coo_to_whell_percell as j_percell  # noqa: E402
from spgpu_tpu.convert.whdia import coo_to_whdia as j_coo_to_whdia  # noqa: E402
from spgpu_tpu.convert.whell import coo_to_whell as j_coo_to_whell  # noqa: E402
from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.parallel.blocks import blocks_spmv, coo_to_whell_blocks  # noqa: E402
from spgpu_tpu.solvers import solve as j_solve  # noqa: E402
from spgpu_tpu.utils import fixtures as jfix  # noqa: E402
from spgpu_tpu_torch import ops as tops  # noqa: E402
from spgpu_tpu_torch.convert import (  # noqa: E402
    coo_to_whdia,
    coo_to_whell,
    coo_to_whell_percell,
)
from spgpu_tpu_torch.formats import whdia as twhdia  # noqa: E402
from spgpu_tpu_torch.formats import whell as twhell  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.solvers import solve  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_classic import CASES as CLASSIC_CASES  # noqa: E402
from test_torch_convert import CASES as PACKED_CASES  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)
from test_torch_pcell import CASES as PCELL_CASES  # noqa: E402
from test_torch_pcell import SMALL  # noqa: E402
from test_torch_whdia import CASES as WHDIA_CASES  # noqa: E402


def _field(tile_base, bits):
    """The low ``bits`` of a JAX ``tile_base``, as int32."""
    return (np.asarray(tile_base).astype(np.int64) & ((1 << bits) - 1)).astype(np.int32)


def _assert_page_word(ja, ta, bits):
    np.testing.assert_array_equal(ta.tile_base.numpy(), np.asarray(ja.tile_base))
    np.testing.assert_array_equal(ta.tile_page.numpy(), _field(ja.tile_base, bits))


def _as(coo, dtype):
    return type(coo)(coo.rows, coo.cols, coo.values.astype(dtype), coo.n_rows,
                     coo.n_cols)


# --------------------------------------------------------------------------
# tile_page is the JAX field on every parity fixture


@pytest.mark.parametrize("layout", ["fp32_scattered", "fp32_aligned", "float64_aligned"])
@pytest.mark.parametrize("name", sorted(PACKED_CASES))
def test_packed_tile_page_is_the_jax_field(name, layout):
    """tests/test_torch_convert.py's fixtures; float64 in the JAX
    double-float geometry (aligned windows), as tests/test_torch_f64.py."""
    dtype, geom = layout.split("_")
    dtype, scattered = {"fp32": "float32"}.get(dtype, dtype), geom == "scattered"
    ja = j_coo_to_whell(_as(PACKED_CASES[name](jfix), dtype), packed=True,
                        scattered=scattered)
    ta = coo_to_whell(_as(PACKED_CASES[name](tfix), dtype), device="cpu",
                      scattered=scattered)
    assert ta.scattered == (ja.group_bases is not None)
    _assert_page_word(ja, ta, 20 if ta.scattered else 16)


@pytest.mark.parametrize("kw", [{}, dict(sort_rows=True), dict(ways=2)],
                         ids=["plain", "oell", "ways2"])
@pytest.mark.parametrize("name", sorted(CLASSIC_CASES))
def test_classic_tile_page_is_the_jax_field(name, kw):
    ja = j_coo_to_whell(CLASSIC_CASES[name](jfix), **kw)
    ta = coo_to_whell(CLASSIC_CASES[name](tfix), device="cpu", packed=False, **kw)
    _assert_page_word(ja, ta, 16)


@pytest.mark.parametrize("name", sorted(PCELL_CASES))
def test_pcell_tile_page_is_the_jax_field(name):
    ja = j_percell(PCELL_CASES[name](jfix), **SMALL)
    ta = coo_to_whell_percell(PCELL_CASES[name](tfix), device="cpu", **SMALL)
    _assert_page_word(ja, ta, 20)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(WHDIA_CASES))
def test_whdia_tile_page_is_the_jax_field(name, dtype):
    ja = j_coo_to_whdia(_as(WHDIA_CASES[name](jfix), dtype))
    ta = coo_to_whdia(_as(WHDIA_CASES[name](tfix), dtype), device="cpu")
    _assert_page_word(ja, ta, 16)


def _jfields(ja, names):
    return {f: None if getattr(ja, f, None) is None else np.asarray(getattr(ja, f))
            for f in names}


@pytest.mark.parametrize("kind", ["scattered", "aligned", "classic", "pcell", "whdia"])
def test_bridges_derive_tile_page(kind):
    """A JAX layout crosses the bridge with ``tile_page`` derived from its
    ``tile_base``: the port converter's word."""
    if kind == "whdia":
        coo = WHDIA_CASES["laplace3d"]
        ja, ta = j_coo_to_whdia(coo(jfix)), coo_to_whdia(coo(tfix), device="cpu")
        tb = twhdia.from_numpy_fields(
            _jfields(ja, ("values", "slot_r0", "tile_r0", "tile_base", "chunk_group")),
            **{f: getattr(ja, f) for f in ("n_rows", "n_cols", "num_hacks",
                                           "num_groups", "total_slots", "nnz",
                                           "x_pages", "window_pages",
                                           "group_hacks", "chunk_tiles")})
    elif kind == "pcell":
        coo = PCELL_CASES["fem2000"]
        ja = j_percell(coo(jfix), **SMALL)
        ta = coo_to_whell_percell(coo(tfix), device="cpu", **SMALL)
        tb = twhell.from_numpy_pcell(
            _jfields(ja, ("values", "residue", "page_tab", "run_hi", "run_lo",
                          "tile_base", "chunk_group", "group_bases")),
            **{f: getattr(ja, f) for f in ("n_rows", "n_cols", "num_hacks",
                                           "num_groups", "total_slots", "nnz",
                                           "x_pages", "window_pages",
                                           "group_hacks", "chunk_tiles")})
    else:
        coo = PACKED_CASES["fem"]
        kw = (dict(packed=False) if kind == "classic"
              else dict(packed=True, scattered=kind == "scattered"))
        ja = j_coo_to_whell(coo(jfix), **kw)
        ta = coo_to_whell(coo(tfix), device="cpu", **kw)
        tb = twhell.from_numpy_fields(
            _jfields(ja, ("values", "residue", "page_tab", "tile_base",
                          "chunk_group", "seg_lo", "seg_hi", "lane_of_row",
                          "group_bases", "row_perm")),
            **{f: getattr(ja, f) for f in ("n_rows", "n_cols", "num_hacks",
                                           "num_groups", "total_slots", "nnz",
                                           "x_pages", "window_pages",
                                           "orig_rows", "group_hacks",
                                           "chunk_tiles", "unit_segments",
                                           "ways")})
    assert torch.equal(tb.tile_page, ta.tile_page)
    assert torch.equal(tb.tile_base, ta.tile_base)
    assert torch.equal(tb.to("cpu").tile_page, ta.tile_page)  # .to() carries it


# --------------------------------------------------------------------------
# the plain versions, the ops and to_dense read only tile_page


def _layouts():
    """name -> (a function making the layout, its low-field mask, the op
    on an original-space x, the fused SpMM on (n_rhs, n) stacks or None,
    the COO)."""
    fem = PACKED_CASES["fem"](tfix)
    fem64 = _as(fem, np.float64)
    band = WHDIA_CASES["banded_wide"](tfix)  # pattern mode
    lap = WHDIA_CASES["laplace3d"](tfix)  # slab mode

    def packed(a, x):
        return a.extract(tops.whell_spmv(a, a.embed(x, dtype=x.dtype)), dtype=x.dtype)

    def packed_mm(a, xs):
        return a.extract(tops.whell_spmm(a, a.embed(xs, dtype=xs.dtype)), dtype=xs.dtype)

    return {
        "packed_scattered": (lambda: coo_to_whell(fem, device="cpu"), 0xFFFFF,
                             packed, packed_mm, fem),
        "packed_aligned": (lambda: coo_to_whell(fem, device="cpu", scattered=False),
                           0xFFFF, packed, packed_mm, fem),
        # float64: #4's per-hack plain form (the op passes hack_units)
        "packed_f64_aligned": (lambda: coo_to_whell(fem64, device="cpu", scattered=False),
                               0xFFFF, packed, None, fem64),
        "packed_f64_scattered": (lambda: coo_to_whell(fem64, device="cpu"), 0xFFFFF,
                                 packed, None, fem64),
        "classic": (lambda: coo_to_whell(fem, device="cpu", packed=False), 0xFFFF,
                    tops.whell_spmv,
                    lambda a, xs: tops.whell_spmm(a, xs, fused=True), fem),
        "pcell": (lambda: coo_to_whell_percell(fem, device="cpu", **SMALL), 0xFFFFF,
                  tops.whell_spmv, None, fem),
        "whdia_pattern": (lambda: coo_to_whdia(band, device="cpu"), 0xFFFF,
                          tops.whdia_spmv,
                          lambda a, xs: tops.whdia_spmm(a, xs, fused=True), band),
        "whdia_slab": (lambda: coo_to_whdia(lap, device="cpu"), 0xFFFF,
                       tops.whdia_spmv,
                       lambda a, xs: tops.whdia_spmm(a, xs, fused=True), lap),
    }


LAYOUTS = _layouts()


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
def test_plain_versions_read_only_tile_page(kind):
    make, mask, op, op_mm, coo = LAYOUTS[kind]
    a = make()
    b = dataclasses.replace(a, tile_base=a.tile_base & ~mask)
    assert not torch.equal(b.tile_base, a.tile_base)  # some low field was set
    assert torch.equal(b.tile_page, a.tile_page)
    if kind.startswith("whdia"):
        assert a.pattern_mode == (kind == "whdia_pattern")
    rng = np.random.default_rng(4)
    dt = a.values.dtype
    x = torch.from_numpy(rng.standard_normal(coo.n_cols)).to(dt)
    za = op(a, x)
    assert torch.equal(op(b, x), za)
    np.testing.assert_allclose(za.double().numpy(), coo.spmv(x.double().numpy()),
                               rtol=2e-5, atol=2e-5 * float(za.abs().max()))
    if op_mm is not None:
        xs = torch.from_numpy(rng.standard_normal((3, coo.n_cols))).to(dt)
        assert torch.equal(op_mm(b, xs), op_mm(a, xs))
    np.testing.assert_array_equal(b.to_dense(), a.to_dense())
    with pytest.raises(ValueError, match="disagrees"):
        b.check()


#: every function of the kernel modules that decodes a tile's page or group
TILE_PAGE_FUNCTIONS = {
    "whell": ("whell_packed_spmv", "whell_packed_spmm", "whell_packed_spmv_plain",
              "whell_packed_spmm_plain", "whell_cell_products", "whell_tile_sums",
              "whell_hack_sums"),
    "whell_classic": ("whell_classic_spmv", "whell_classic_spmm",
                      "whell_classic_spmv_plain", "whell_classic_spmm_plain"),
    "pcell": ("pcell_spmv", "pcell_spmv_plain"),
    "whdia": ("whdia_spmv", "whdia_spmm", "whdia_spmv_plain", "whdia_spmm_plain",
              "whdia_spmm_listed_plain", "whdia_listed_columns", "whdia_columns",
              "whdia_tile_sums"),
    "ablation": ("whdia_ablation", "whdia_ablation_plain", "whdia_hack_ablation",
                 "whdia_hack_ablation_plain", "whell_f64_ablation",
                 "whell_f64_ablation_plain"),
}


@pytest.mark.parametrize("module,name", [(m, n) for m, ns in TILE_PAGE_FUNCTIONS.items()
                                         for n in ns])
def test_tile_page_is_required(module, name):
    """No wrapper or plain version falls back to ``tile_base``'s low
    field, which past the old bounds names the wrong page or group."""
    fn = getattr(importlib.import_module(f"spgpu_tpu_torch.kernels.{module}"), name)
    param = inspect.signature(fn).parameters["tile_page"]
    assert param.default is inspect.Parameter.empty


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
def test_check_rejects_a_bad_tile_page(kind):
    make, mask, *_ = LAYOUTS[kind]
    a = make()
    a.check()
    # tile 0 holds nonzero values in every fixture: a WHDIA cell then
    # leaves [0, n_cols), a WHELL page or group its range
    assert bool((a.values[:8] != 0).any())
    cases = {"disagrees": lambda tp: tp.__setitem__(0, int(tp[0]) ^ 1),
             # the same low bits, past the page or group range
             "range|index|n_cols": lambda tp: tp.__setitem__(0, int(tp[0]) + mask + 1),
             "negative": lambda tp: tp.__setitem__(0, int(tp[0]) - (1 << 31))}
    for match, edit in cases.items():
        tp = a.tile_page.clone()
        edit(tp)
        with pytest.raises(ValueError, match=match):
            dataclasses.replace(a, tile_page=tp).check()


# --------------------------------------------------------------------------
# solve(fmt="blocks"): the one-layout packed-WHELL route


def _jax_blocks(coo_j, b, tol):
    return j_solve(coo_j, b, fmt="blocks", tol=tol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_solve_blocks_matches_jax_blocks(dtype):
    """The JAX route runs blocks_cg on its row blocks (fp32, or its
    double-float CG), the port CG on one packed layout in the system's
    type: the same system, so x agrees to the type's tolerance."""
    f64 = dtype == "float64"
    tol, x_tol = (1e-10, 1e-9) if f64 else (1e-5, 1e-3)
    coo_j, coo_t = jfix.laplacian_2d(16, 16, dtype), tfix.laplacian_2d(16, 16, dtype)
    b = np.random.default_rng(3).standard_normal(256).astype(dtype)
    rj = _jax_blocks(coo_j, b, tol)
    rt = solve(coo_t, b, device="cpu", fmt="blocks", tol=tol)
    assert bool(rj.converged) and bool(rt.converged)
    assert rt.x.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=x_tol)
    slack = 2 if f64 else max(1, int(rj.iterations) // 10)
    assert abs(int(rt.iterations) - int(rj.iterations)) <= slack
    # the packed-WHELL route itself: the same bits as fmt="whell"
    rw = solve(coo_t, b, device="cpu", fmt="whell", tol=tol)
    assert torch.equal(rw.x, rt.x) and rw.iterations == rt.iterations


def test_blocks_spmv_matches_the_one_layout_product():
    """The JAX benchmark's CPU configuration of its row-block rows
    (``bench.py:315-321``: 2**14 rows, 2 blocks) against the port's one
    packed layout."""
    kw = dict(span=200, far_frac=0.002, seed=5, dtype=np.float32)
    coo_j = jfix.random_fem_like(1 << 14, 9.0, **kw)
    coo_t = tfix.random_fem_like(1 << 14, 9.0, **kw)
    ja = coo_to_whell_blocks(coo_j, n_blocks=2)
    assert ja.n_blocks == 2
    x = np.random.default_rng(2).standard_normal(coo_t.n_rows).astype(np.float32)
    zj = ja.extract(np.asarray(blocks_spmv(ja, jnp.asarray(ja.embed(x)))))
    a = coo_to_whell(coo_t, device="cpu")
    zt = a.extract(tops.whell_spmv(a, a.embed(torch.from_numpy(x), dtype=torch.float32)),
                   dtype=torch.float64).numpy()
    np.testing.assert_allclose(zt, zj, rtol=2e-5, atol=2e-5 * np.abs(zj).max())


def test_complex_blocks_raises():
    c = tfix.laplacian_2d(8, 8, np.float64)
    coo = CooMatrix(c.rows, c.cols, c.values.astype(np.complex64), 64, 64)
    with pytest.raises(NotImplementedError, match="item 11"):
        solve(coo, np.ones(64, np.complex64), device="cpu", fmt="blocks")


def test_jax_complex_blocks_is_the_hell_route():
    """What the port raises for: the JAX ``solve()`` sends an explicit
    ``fmt="blocks"`` on complex values to its classic ``hell`` route."""
    c = jfix.laplacian_2d(6, 6, np.float64)
    coo = JCoo(c.rows, c.cols, c.values.astype(np.complex64), 36, 36)
    b = np.ones(36, np.complex64)
    rb = j_solve(coo, b, fmt="blocks", tol=1e-5)
    rh = j_solve(coo, b, fmt="hell", tol=1e-5)
    np.testing.assert_array_equal(np.asarray(rb.x), np.asarray(rh.x))


# --------------------------------------------------------------------------
# one layout past the aligned 16-bit page bound


def test_aligned_float64_past_the_page_bound():
    """An 8.5M-row float64 diagonal with aligned windows: 66,432 x pages,
    past the 65,536 of tile_base's 16-bit field.  Every row's product is
    its diagonal entry times x, exactly."""
    n = 8_500_000
    i = np.arange(n, dtype=np.int64)
    d = np.random.default_rng(1).uniform(1.0, 2.0, n)
    coo = CooMatrix(i, i, d, n, n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a diagonal pads 8 cells a nonzero
        a = coo_to_whell(coo, device="cpu", scattered=False)
    assert a.x_pages > 1 << 16 and int(a.tile_page.max()) > 0xFFFF
    assert torch.equal(a.tile_base & 0xFFFF, a.tile_page & 0xFFFF)
    x = np.random.default_rng(0).standard_normal(n)
    z = a.extract(tops.whell_spmv(a, a.embed(torch.from_numpy(x), dtype=torch.float64)),
                  dtype=torch.float64).numpy()
    np.testing.assert_array_equal(z, d * x)
