"""PyTorch port: the multi-RHS SpMMs (kernels #12-#14) against the JAX package.

One layout (built by the JAX converter, carried across by the bridges)
goes through the JAX ``whell_spmm``/``whdia_spmm``/``sdia_spmm`` with
``fused=True`` (the fused Pallas kernels in interpret mode on the CPU) and
through the port's ops on CPU tensors (the plain PyTorch versions of the
fused kernels), and both are held against the host COO golden:

- WHELL at rtol = atol = 3e-5, as tests/test_whell.py:223-236;
- WHDIA at rtol 2e-5, atol 2e-5·max|Z|, SDIA at 2e-5, as
  tests/test_spmm_fused.py.

The two packages sum each row's products in different orders, hence the
tolerances.  The interpret-mode JAX kernels unroll their RHS, so the
JAX-compared cases keep to at most 4 RHS on fixtures of a few thousand
rows; 8 and 17 RHS are held port-only against the loop of the port's own
SpMV.  float64 and complex matrices run the loop of their SpMV in both
packages, and ``fused=True`` raises for them in both.
"""

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
from spgpu_tpu_torch.formats import dia as tdia  # noqa: E402
from spgpu_tpu_torch.formats import whdia as twhdia  # noqa: E402
from spgpu_tpu_torch.formats import whell as twhell  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.kernels import sdia as ks  # noqa: E402
from spgpu_tpu_torch.kernels import whdia as kd  # noqa: E402
from spgpu_tpu_torch.kernels import whell as kw  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)

# WHELL: tests/test_whell.py:223-236 and a unit-segment Laplacian
WHELL_CASES = {
    "fem": lambda f: f.random_fem_like(3000, 12.0, span=200, far_frac=0.02,
                                       seed=9, dtype=np.float32),
    "laplace": lambda f: f.laplacian_2d(23, 31, np.float32),
}
# WHDIA: tests/test_spmm_fused.py:32-65 (pattern mode) and a Laplacian
# (slab mode); SDIA: tests/test_spmm_fused.py:18-29 and :68-77
DIA_CASES = {
    "banded": lambda f: f.random_banded(4000, bands=11, wander=7, seed=2,
                                        dtype=np.float32).sum_duplicates(),
    "banded5": lambda f: f.random_banded(2000, bands=5, wander=3, seed=4,
                                         dtype=np.float32).sum_duplicates(),
    "laplace": lambda f: f.laplacian_2d(40, 40, np.float32),
    "laplace24": lambda f: f.laplacian_2d(24, 24, np.float32),
}
WHDIA_MODE = {"banded": True, "banded5": True, "laplace": False}  # pattern?


def hub_rows(f, n=20000, step=7, seed=3):
    """A 5-band matrix plus a hub row and column 0 that meet every
    ``step``-th column (tests/test_torch_hack_runs.py's hub fixture, cut
    to size): with 8-page windows the hub's hack has a run of ~20 tiles,
    two chunks of work units."""
    b = f.random_banded(n, bands=5, wander=0, seed=seed, dtype=np.float64).sum_duplicates()
    rng = np.random.default_rng(seed)
    hub = np.arange(0, n, step)
    rows = np.r_[b.rows, np.zeros(hub.size, np.int64), hub]
    cols = np.r_[b.cols, hub, np.zeros(hub.size, np.int64)]
    vals = np.r_[b.values, rng.uniform(0.5, 1.5, 2 * hub.size)]
    return f.CooMatrix(rows, cols, vals.astype(np.float32), n, n).sum_duplicates()


WHELL_CASES["hub"] = hub_rows
WHELL_TOL = dict(rtol=3e-5, atol=3e-5)

WHELL_ARRAYS = ("values", "residue", "page_tab", "tile_base", "chunk_group",
                "seg_lo", "seg_hi", "lane_of_row", "group_bases")
WHELL_STATIC = ("n_rows", "n_cols", "num_hacks", "num_groups", "total_slots",
                "nnz", "x_pages", "window_pages", "orig_rows", "group_hacks",
                "chunk_tiles", "unit_segments")
WHDIA_ARRAYS = ("values", "slot_r0", "tile_r0", "tile_base", "chunk_group")
WHDIA_STATIC = ("n_rows", "n_cols", "num_hacks", "num_groups", "total_slots",
                "nnz", "x_pages", "window_pages", "group_hacks", "chunk_tiles")


def _fields(m, names):
    return {f: None if getattr(m, f, None) is None else np.asarray(getattr(m, f))
            for f in names}


def bridge_whell(ja):
    return twhell.from_numpy_fields(_fields(ja, WHELL_ARRAYS),
                                    **{f: getattr(ja, f) for f in WHELL_STATIC})


def bridge_whdia(ja):
    return twhdia.from_numpy_fields(_fields(ja, WHDIA_ARRAYS + ("values_lo",)),
                                    **{f: getattr(ja, f) for f in WHDIA_STATIC})


def bridge_sdia(ja):
    return tdia.from_numpy_fields(np.asarray(ja.values), ja.offsets, ja.n_rows,
                                  ja.n_cols, values_lo=ja.values_lo)


def _stack(rng, n_rhs, n, dtype=np.float32):
    return rng.standard_normal((n_rhs, n)).astype(dtype)


def _near(z, want, frac, rtol=0.0):
    """|z - want| ≤ frac·max|want| + rtol·|want| (float64/complex128)."""
    z, want = np.asarray(z), np.asarray(want)
    assert z.shape == want.shape
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    np.testing.assert_allclose(z, want, rtol=rtol, atol=frac * scale)


def _whell_pair(name, n_rhs, seed=4, **conv):
    """(JAX layout, port layout, original-space X, lane-space X)."""
    coo = WHELL_CASES[name](jfix)
    ja = j_coo_to_whell(coo, packed=True, **conv)
    X = _stack(np.random.default_rng(seed), n_rhs, coo.n_cols)
    Xl = np.zeros((n_rhs, ja.n_rows), np.float32)
    Xl[:, np.asarray(ja.lane_of_row)] = X
    return coo, ja, bridge_whell(ja), X, Xl


# --------------------------------------------------------------------------
# packed WHELL (kernel #12): fused by default for fp32 and bf16


@pytest.mark.parametrize("scattered", [True, False], ids=["scattered", "aligned"])
@pytest.mark.parametrize("name,n_rhs", [("fem", 4), ("laplace", 2)])
def test_whell_spmm_matches_jax_and_golden(name, n_rhs, scattered):
    coo, ja, ta, X, Xl = _whell_pair(name, n_rhs, scattered=scattered)
    assert ta.unit_segments == (name == "laplace")
    zj = np.asarray(jops.whell_spmm(ja, jnp.asarray(Xl), fused=True,
                                    interpret=True), np.float64)
    zt = tops.whell_spmm(ta, torch.from_numpy(Xl))
    assert zt.shape == (n_rhs, ta.n_rows) and zt.dtype == torch.float32
    zt = zt.double().numpy()
    lor = np.asarray(ja.lane_of_row)
    np.testing.assert_allclose(zt, zj, **WHELL_TOL)
    np.testing.assert_allclose(zt[:, lor], coo.spmv(X.astype(np.float64)),
                               **WHELL_TOL)


def test_whell_spmm_alpha_beta_y():
    coo, ja, ta, X, Xl = _whell_pair("fem", 4)
    Y = _stack(np.random.default_rng(5), 4, ta.n_rows)
    zj = np.asarray(jops.whell_spmm(ja, jnp.asarray(Xl), alpha=2.5, beta=-0.5,
                                    y=jnp.asarray(Y), fused=True, interpret=True))
    zt = tops.whell_spmm(ta, torch.from_numpy(Xl), alpha=2.5, beta=-0.5,
                         y=torch.from_numpy(Y)).numpy()
    np.testing.assert_allclose(zt, zj, **WHELL_TOL)
    nan_y = torch.full((4, ta.n_rows), float("nan"))
    z0 = tops.whell_spmm(ta, torch.from_numpy(Xl), beta=0.0, y=nan_y)
    torch.testing.assert_close(z0, tops.whell_spmm(ta, torch.from_numpy(Xl)),
                               rtol=0, atol=0)


def test_whell_spmm_bf16_values_fp32_x():
    """bf16 value slabs with fp32 X and sums, against the JAX fused kernel
    and the golden on the bf16-rounded values."""
    coo, ja, ta, X, Xl = _whell_pair("fem", 2, dtype=jnp.bfloat16)
    assert ta.values.dtype == torch.bfloat16
    zj = np.asarray(jops.whell_spmm(ja, jnp.asarray(Xl), interpret=True), np.float64)
    zt = tops.whell_spmm(ta, torch.from_numpy(Xl))
    assert zt.dtype == torch.float32
    np.testing.assert_allclose(zt.double().numpy(), zj, **WHELL_TOL)
    v16 = torch.from_numpy(coo.values).to(torch.bfloat16).double().numpy()
    golden = CooMatrix(coo.rows, coo.cols, v16, coo.n_rows, coo.n_cols).spmv(
        X.astype(np.float64))
    np.testing.assert_allclose(zt.double().numpy()[:, np.asarray(ja.lane_of_row)],
                               golden, **WHELL_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["fem", "hub"])
def test_whell_spmm_per_hack_plain_matches_tile_pass_and_jax(name, dtype):
    """The per-hack plain SpMM (what #12's hack pass sums: each hack's run,
    tile by tile, chunks in order, no tile outside the runs) against the
    tile-pass plain SpMM and the JAX fused kernel (interpret mode) at
    3e-5, with (``hub``: 8-page windows) and without chunked runs; the op's
    CPU path is the per-hack form."""
    conv = dict(window_pages=8) if name == "hub" else {}
    if dtype == "bfloat16":
        conv["dtype"] = jnp.bfloat16
    coo, ja, ta, X, Xl = _whell_pair(name, 2, **conv)
    assert (ta.hack_units.shape[0] > ta.seg_lo.shape[0]) == (name == "hub")
    args = (ta.values, ta.residue, ta.page_tab, ta.tile_base, ta.chunk_group,
            ta.group_bases, ta.seg_lo, ta.seg_hi,
            tops._prep_x(torch.from_numpy(Xl), ta.n_cols, ta.x_pages, stack=True))
    static = dict(chunk_tiles=ta.chunk_tiles, group_hacks=ta.group_hacks,
                  window_pages=ta.window_pages, unit_segments=ta.unit_segments,
                  tile_page=ta.tile_page)
    per_hack = kw.whell_packed_spmm_plain(*args, hack_units=ta.hack_units, **static)
    tile = kw.whell_packed_spmm_plain(*args, **static)
    np.testing.assert_allclose(per_hack.numpy(), tile.numpy(), **WHELL_TOL)
    z = per_hack.flatten(1)[:, : ta.n_rows]
    torch.testing.assert_close(tops.whell_spmm(ta, torch.from_numpy(Xl)), z,
                               rtol=0, atol=0)
    zj = np.asarray(jops.whell_spmm(ja, jnp.asarray(Xl), fused=True, interpret=True),
                    np.float64)
    np.testing.assert_allclose(z.double().numpy(), zj, **WHELL_TOL)
    v = torch.from_numpy(coo.values).to(ta.values.dtype).double().numpy()
    golden = CooMatrix(coo.rows, coo.cols, v, coo.n_rows, coo.n_cols).spmv(
        X.astype(np.float64))
    np.testing.assert_allclose(z.double().numpy()[:, np.asarray(ja.lane_of_row)],
                               golden, **WHELL_TOL)


def test_whell_spmm_needs_hack_units_on_cuda_only():
    """#12 runs the hack pass over ``WhellMatrix.hack_units``: the wrapper
    checks them wherever given and needs them on a CUDA device; on CPU
    tensors without them it runs the tile-pass plain form."""
    a = _port_layout("whell", WHELL_CASES["fem"](tfix))
    x3 = tops._prep_x(torch.ones((2, a.n_cols)), a.n_cols, a.x_pages, stack=True)
    args = (a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
            a.group_bases, a.seg_lo, a.seg_hi, x3)
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  window_pages=a.window_pages, unit_segments=a.unit_segments,
                  tile_page=a.tile_page)
    with pytest.raises(ValueError, match="hack_units"):
        kw._check_units("whell_packed_spmm", None, a.values, a.seg_lo)
    with pytest.raises(ValueError, match="hack_units"):
        kw.whell_packed_spmm(*args, **static, hack_units=a.hack_units.long())
    torch.testing.assert_close(kw.whell_packed_spmm(*args, **static),
                               kw.whell_packed_spmm_plain(*args, **static),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        kw.whell_packed_spmm(*args, **static, hack_units=a.hack_units),
        kw.whell_packed_spmm_plain(*args, **static, hack_units=a.hack_units),
        rtol=0, atol=0)


# --------------------------------------------------------------------------
# WHDIA (kernel #13) and SDIA (kernel #14): loop by default, fused opt-in


@pytest.mark.parametrize("name", sorted(WHDIA_MODE))
def test_whdia_spmm_matches_jax_and_golden(name):
    coo = DIA_CASES[name](jfix)
    ja = j_coo_to_whdia(coo)
    ta = bridge_whdia(ja)
    assert ta.pattern_mode == WHDIA_MODE[name]
    X = _stack(np.random.default_rng(2), 4, coo.n_cols)
    zj = np.asarray(jops.whdia_spmm(ja, jnp.asarray(X), fused=True), np.float64)
    zt = tops.whdia_spmm(ta, torch.from_numpy(X), fused=True)
    assert zt.shape == (4, coo.n_rows)
    g = coo.spmv(X.astype(np.float64))
    _near(zt.double().numpy(), zj, 2e-5, rtol=2e-5)
    _near(zt.double().numpy(), g, 2e-5, rtol=2e-5)
    # the default loop of the port's SpMV agrees too
    _near(tops.whdia_spmm(ta, torch.from_numpy(X)).double().numpy(), g, 2e-5,
          rtol=2e-5)


def test_whdia_spmm_alpha_beta_y():
    coo = DIA_CASES["banded"](jfix)
    ja = j_coo_to_whdia(coo)
    ta = bridge_whdia(ja)
    rng = np.random.default_rng(2)
    X, Y = _stack(rng, 4, coo.n_cols), _stack(rng, 4, coo.n_rows)
    zj = np.asarray(jops.whdia_spmm(ja, jnp.asarray(X), fused=True, alpha=2.0,
                                    beta=0.5, y=jnp.asarray(Y)), np.float64)
    for fused in (True, None):
        zt = tops.whdia_spmm(ta, torch.from_numpy(X), fused=fused, alpha=2.0,
                             beta=0.5, y=torch.from_numpy(Y))
        _near(zt.double().numpy(), zj, 2e-5, rtol=2e-5)


@pytest.mark.parametrize("name,n_rhs", [("laplace", 4), ("laplace24", 3)])
def test_sdia_spmm_matches_jax_golden_and_loop(name, n_rhs):
    coo = DIA_CASES[name](jfix)
    ja = j_coo_to_sdia(coo)
    ta = bridge_sdia(ja)
    X = _stack(np.random.default_rng(1), n_rhs, coo.n_cols)
    xt = torch.from_numpy(X)
    zj = np.asarray(jops.sdia_spmm(ja, jnp.asarray(X), fused=True), np.float64)
    zt = tops.sdia_spmm(ta, xt, fused=True)
    np.testing.assert_allclose(zt.double().numpy(), zj, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(zt.double().numpy(), coo.spmv(X.astype(np.float64)),
                               rtol=2e-5, atol=2e-5)
    # the fused plain version is the loop of the SpMV, bit for bit
    loop = torch.stack([tops.sdia_spmv(ta, xt[r]) for r in range(n_rhs)])
    torch.testing.assert_close(zt, loop, rtol=0, atol=0)
    torch.testing.assert_close(tops.sdia_spmm(ta, xt), loop, rtol=0, atol=0)


def test_sdia_spmm_alpha_beta_y():
    coo = DIA_CASES["laplace24"](jfix)
    ja = j_coo_to_sdia(coo)
    ta = bridge_sdia(ja)
    rng = np.random.default_rng(3)
    X, Y = _stack(rng, 3, coo.n_cols), _stack(rng, 3, coo.n_rows)
    zj = np.asarray(jops.sdia_spmm(ja, jnp.asarray(X), fused=True, alpha=2.0,
                                   beta=0.5, y=jnp.asarray(Y)), np.float64)
    zt = tops.sdia_spmm(ta, torch.from_numpy(X), fused=True, alpha=2.0, beta=0.5,
                        y=torch.from_numpy(Y))
    np.testing.assert_allclose(zt.double().numpy(), zj, rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------
# port-only: many RHS, one RHS, the empty matrix, the dispatch


def _port_layout(fmt, coo, **conv):
    conv_fn = {"whell": coo_to_whell, "whdia": coo_to_whdia, "sdia": coo_to_sdia}[fmt]
    return conv_fn(coo, device="cpu", **conv)


SPMM = {"whell": (tops.whell_spmm, tops.whell_spmv),
        "whdia": (tops.whdia_spmm, tops.whdia_spmv),
        "sdia": (tops.sdia_spmm, tops.sdia_spmv)}
PORT_CASES = {"whell": ("fem", WHELL_CASES), "whdia": ("banded", DIA_CASES),
              "sdia": ("laplace", DIA_CASES)}


@pytest.mark.parametrize("n_rhs", [1, 8, 17])
@pytest.mark.parametrize("fmt", sorted(SPMM))
def test_fused_plain_matches_loop_of_spmv(fmt, n_rhs):
    """The fused plain version (what kernels #12-#14 compute) against the
    loop of the port's own SpMV, at any RHS count (17: a remainder past
    two kernel blocks of 8), and the golden."""
    name, cases = PORT_CASES[fmt]
    coo = cases[name](tfix)
    a = _port_layout(fmt, coo)
    spmm, spmv = SPMM[fmt]
    X = _stack(np.random.default_rng(n_rhs), n_rhs, coo.n_cols)
    x = a.embed(torch.from_numpy(X), torch.float32) if fmt == "whell" \
        else torch.from_numpy(X)
    z = spmm(a, x, fused=True)
    loop = torch.stack([spmv(a, x[r]) for r in range(n_rhs)])
    if fmt == "sdia":
        torch.testing.assert_close(z, loop, rtol=0, atol=0)
    else:
        _near(z.double().numpy(), loop.double().numpy(), 1e-6, rtol=1e-6)
    zo = a.extract(z, torch.float64).numpy() if fmt == "whell" else z.double().numpy()
    _near(zo, coo.spmv(X.astype(np.float64)), 3e-5, rtol=3e-5)


@pytest.mark.parametrize("fused", [None, True, False])
@pytest.mark.parametrize("fmt", sorted(SPMM))
def test_empty_matrix(fmt, fused):
    coo = tfix.CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64),
                         np.zeros(0, np.float32), 300, 300)
    a = _port_layout(fmt, coo)
    x = torch.ones((3, a.n_cols))
    y = torch.full((3, a.n_rows), 2.0)
    z = SPMM[fmt][0](a, x, beta=0.5, y=y, fused=fused)
    assert z.shape == (3, a.n_rows)
    torch.testing.assert_close(z, 0.5 * y, rtol=0, atol=0)


def _counting(monkeypatch, module, name):
    """Wrap ``module.name`` so that its calls are counted in the list."""
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


@pytest.mark.parametrize("dtype,fused,want", [
    ("float32", None, "spmm"), ("float32", True, "spmm"),
    ("float32", False, "loop"), ("bfloat16", None, "spmm"),
    ("float64", None, "loop"), ("complex64", None, "loop"),
])
def test_whell_spmm_dispatch(dtype, fused, want, monkeypatch):
    """As the JAX whell_spmm: fused by default for fp32/bf16, the loop of
    the SpMV (one call per RHS) for float64 and complex or on request."""
    coo = WHELL_CASES["laplace"](tfix)
    vt = {"float64": np.float64, "complex64": np.complex64}.get(dtype, np.float32)
    coo = CooMatrix(coo.rows, coo.cols, coo.values.astype(vt), coo.n_rows, coo.n_cols)
    a = coo_to_whell(coo, device="cpu",
                     **({"dtype": "bfloat16"} if dtype == "bfloat16" else {}))
    xdt = getattr(torch, np.dtype(vt).name)
    spmm = _counting(monkeypatch, tops, "whell_packed_spmm")
    spmv = _counting(monkeypatch, tops, "whell_packed_spmv")
    z = tops.whell_spmm(a, torch.ones((5, a.n_cols), dtype=xdt), fused=fused)
    assert z.shape == (5, a.n_rows) and z.dtype == xdt
    assert (len(spmm), len(spmv)) == ((1, 0) if want == "spmm" else (0, 5))


@pytest.mark.parametrize("fused,want", [(None, "loop"), (False, "loop"),
                                        (True, "spmm")])
@pytest.mark.parametrize("fmt", ["sdia", "whdia"])
def test_dia_spmm_dispatch(fmt, fused, want, monkeypatch):
    """As the JAX sdia_spmm/whdia_spmm: the loop by default, fused on
    request."""
    mod = {"sdia": ks, "whdia": kd}[fmt]
    a = _port_layout(fmt, DIA_CASES["laplace24"](tfix))
    spmm = _counting(monkeypatch, mod, f"{fmt}_spmm")
    spmv = _counting(monkeypatch, mod, f"{fmt}_spmv")
    z = SPMM[fmt][0](a, torch.ones((5, a.n_cols)), fused=fused)
    assert z.shape == (5, a.n_rows)
    assert (len(spmm), len(spmv)) == ((1, 0) if want == "spmm" else (0, 5))


# --------------------------------------------------------------------------
# float64 and complex64: the loop of the SpMV; fused=True raises in both
# packages


def _typed(coo, dtype, seed=8):
    v = coo.values.astype(np.float64)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * np.random.default_rng(seed).standard_normal(coo.nnz)
    return v.astype(dtype)


@pytest.mark.parametrize("dtype", ["float64", "complex64"])
@pytest.mark.parametrize("fmt", sorted(SPMM))
def test_f64_complex_spmm_is_the_loop_and_fused_raises(fmt, dtype):
    name, cases = PORT_CASES[fmt]
    c = cases[name](tfix)
    v = _typed(c, dtype)
    coo = CooMatrix(c.rows, c.cols, v, c.n_rows, c.n_cols)
    a = _port_layout(fmt, coo)
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    X = rng.standard_normal((3, c.n_cols))
    if dtype == "complex64":
        X = X + 1j * rng.standard_normal((3, c.n_cols))
    x = a.embed(torch.from_numpy(X), tdt) if fmt == "whell" \
        else torch.from_numpy(X).to(tdt)
    spmm, spmv = SPMM[fmt]
    z = spmm(a, x, alpha=2.0)
    assert z.dtype == tdt
    loop = torch.stack([spmv(a, x[r], alpha=2.0) for r in range(3)])
    torch.testing.assert_close(z, loop, rtol=0, atol=0)
    torch.testing.assert_close(spmm(a, x, alpha=2.0, fused=False), loop,
                               rtol=0, atol=0)
    wide = torch.complex128 if dtype == "complex64" else torch.float64
    zo, xo = (a.extract(z, wide), a.extract(x, wide)) if fmt == "whell" \
        else (z.to(wide), x.to(wide))
    tol = 1e-12 if dtype == "float64" else 3e-5
    _near(zo.numpy(), 2.0 * coo.spmv(xo.numpy()), tol, rtol=tol)
    with pytest.raises(NotImplementedError, match="fused"):
        spmm(a, x, fused=True)
    # the JAX package refuses the same (its dd and plane-pair layouts)
    jcoo = JCoo(c.rows, c.cols, v, c.n_rows, c.n_cols)
    jconv, jop = {"whell": (lambda m: j_coo_to_whell(m, packed=True), jops.whell_spmm),
                  "whdia": (j_coo_to_whdia, jops.whdia_spmm),
                  "sdia": (j_coo_to_sdia, jops.sdia_spmm)}[fmt]
    with pytest.raises(NotImplementedError, match="fused"):
        jop(jconv(jcoo), jnp.zeros((2, 2, c.n_cols)), fused=True)


def test_spmm_rejects_bad_operands():
    a = _port_layout("whell", WHELL_CASES["laplace"](tfix))
    with pytest.raises(ValueError, match="shape"):
        tops.whell_spmm(a, torch.zeros(a.n_cols))
    with pytest.raises(ValueError, match="x3d"):
        tops.whell_spmm(a, torch.zeros((2, a.n_cols), dtype=torch.float64))
    d = _port_layout("whdia", DIA_CASES["laplace24"](tfix))
    with pytest.raises(ValueError, match="shape"):
        tops.whdia_spmm(d, torch.zeros((2, d.n_cols + 1)), fused=True)
    with pytest.raises(ValueError, match="x:"):
        kd.whdia_spmm(d.values, d.slot_r0, d.tile_r0, d.tile_base, d.chunk_group,
                      torch.zeros(d.n_cols), chunk_tiles=d.chunk_tiles,
                      group_hacks=d.group_hacks, num_groups=d.num_groups,
                      tile_page=d.tile_page)
    s = _port_layout("sdia", DIA_CASES["laplace24"](tfix))
    with pytest.raises(ValueError, match="planes take"):
        tops.sdia_spmm(s, torch.zeros((2, s.n_cols), dtype=torch.float64), fused=True)


def test_cpu_path_counts_no_spmm_launches():
    before = (kw.LAUNCHES_SPMM, kd.LAUNCHES_SPMM, ks.LAUNCHES_SPMM)
    for fmt in SPMM:
        name, cases = PORT_CASES[fmt]
        a = _port_layout(fmt, cases[name](tfix))
        SPMM[fmt][0](a, torch.ones((2, a.n_cols)), fused=True)
    assert (kw.LAUNCHES_SPMM, kd.LAUNCHES_SPMM, ks.LAUNCHES_SPMM) == before
