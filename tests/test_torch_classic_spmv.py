"""PyTorch port: the classic-layout SpMVs, csput and the format-generic
``ops.spmv`` against the JAX package's.

One layout, built by the JAX converter and carried across by the bridge
(``from_numpy_fields``), goes through the JAX op (XLA on the CPU) and the
port's (plain torch); both are held against the host golden ``beta*y +
alpha*(A @ x)`` at tests/test_spmv.py's tolerances (rtol = atol = 2e-5 in
float32 and complex64, 1e-12 in float64 and complex128), on its three
fixtures in the four types.  Also: ``beta=0`` never reads a NaN ``y``,
OELL, hacked OELL and noRs, leading batch dimensions, csput against the
JAX csput, ``impl="pallas"`` raising, and ``ops.spmv`` over every layout
type of the port (``TypeError`` for any other).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu import convert as jconv  # noqa: E402
from spgpu_tpu import ops as jops  # noqa: E402
from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu_torch import convert as tconv  # noqa: E402
from spgpu_tpu_torch import ops as tops  # noqa: E402
from spgpu_tpu_torch.formats import bcoo, dia, ell, hdia, hell  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)

FIX = {
    "laplacian": lambda: tfix.laplacian_2d(11, 9),
    "irregular": lambda: tfix.random_irregular(257, 201, avg_nnz_per_row=6.0, seed=11),
    "banded": lambda: tfix.random_banded(300, bands=7, wander=2, seed=12),
}
DTYPES = (np.float32, np.float64, np.complex64, np.complex128)
BRIDGES = {"EllMatrix": ell.from_numpy_fields, "HellMatrix": hell.from_numpy_fields,
           "DiaMatrix": dia.from_numpy_dia, "HdiaMatrix": hdia.from_numpy_fields,
           "BcooMatrix": bcoo.from_numpy_bcoo, "BhdiaMatrix": bcoo.from_numpy_bhdia}


def tol(dt):
    small = np.dtype(dt) in (np.dtype(np.float32), np.dtype(np.complex64))
    return dict(rtol=2e-5, atol=2e-5) if small else dict(rtol=1e-12, atol=1e-12)


def make(name, dt, seed=1234):
    """Fixture ``name`` in ``dt`` with an x and a y of its type (complex:
    imaginary parts drawn after the real ones), as tests/test_spmv.py's
    ``_mk``."""
    c = FIX[name]()
    rng = np.random.default_rng(seed)
    c = CooMatrix(c.rows, c.cols, c.values.astype(dt), c.n_rows, c.n_cols)
    x, y = rng.standard_normal(c.n_cols), rng.standard_normal(c.n_rows)
    if np.dtype(dt).kind == "c":
        x = x + 1j * rng.standard_normal(c.n_cols)
        y = y + 1j * rng.standard_normal(c.n_rows)
    return c, x.astype(dt), y.astype(dt)


def jcoo(c):
    return JCoo(c.rows, c.cols, c.values, c.n_rows, c.n_cols)


def bridge(ja):
    """The port's layout of a JAX classic layout, through the bridge."""
    fields = {f.name: getattr(ja, f.name) for f in dataclasses.fields(ja)}
    fields = {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in fields.items()}
    return BRIDGES[type(ja).__name__](**fields)


#: format -> (JAX converter, JAX op, port op)
OPS = {
    "ell": (jconv.coo_to_ell, jops.ell_spmv, tops.ell_spmv),
    "hell": (jconv.coo_to_hell, jops.hell_spmv, tops.hell_spmv),
    "dia": (jconv.coo_to_dia, jops.dia_spmv, tops.dia_spmv),
    "hdia": (jconv.coo_to_hdia, jops.hdia_spmv, tops.hdia_spmv),
    "bcoo": (lambda c: jconv.coo_to_bcoo(c, 8, 8), jops.bcoo_spmv, tops.bcoo_spmv),
}


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", sorted(FIX))
@pytest.mark.parametrize("fmt", sorted(OPS))
def test_op_matches_jax_and_golden(fmt, name, dt):
    c, x, y = make(name, dt)
    conv, jop, top = OPS[fmt]
    ja = conv(jcoo(c))
    alpha, beta = 1.7, -0.3
    want = alpha * c.spmv(x) + beta * y
    got = top(bridge(ja), torch.from_numpy(x), alpha, beta, torch.from_numpy(y))
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == (c.n_rows,)
    np.testing.assert_allclose(got.numpy(), want, **tol(dt))
    jz = np.asarray(jop(ja, jnp.asarray(x), alpha, beta, jnp.asarray(y)))
    np.testing.assert_allclose(got.numpy(), jz, **tol(dt))


@pytest.mark.parametrize("fmt", sorted(OPS))
def test_beta_zero_never_reads_y(fmt):
    """A static ``beta == 0`` never reads ``y``: a NaN y leaves no NaN."""
    c, x, _ = make("laplacian", np.float64)
    a = bridge(OPS[fmt][0](jcoo(c)))
    y_nan = torch.full((c.n_rows,), float("nan"), dtype=torch.float64)
    got = OPS[fmt][2](a, torch.from_numpy(x), 2.0, 0.0, y_nan)
    np.testing.assert_allclose(got.numpy(), 2.0 * c.spmv(x), rtol=1e-12)


@pytest.mark.parametrize("dt", (np.float32, np.float64), ids=lambda d: np.dtype(d).name)
def test_oell_permuted_output(dt):
    c, x, y = make("irregular", dt)
    ja = jconv.ell_to_oell(jconv.coo_to_ell(jcoo(c)))
    got = tops.ell_spmv(bridge(ja), torch.from_numpy(x), 1.5, 0.5, torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), 1.5 * c.spmv(x) + 0.5 * y, **tol(dt))
    jz = np.asarray(jops.ell_spmv(ja, jnp.asarray(x), 1.5, 0.5, jnp.asarray(y)))
    np.testing.assert_allclose(got.numpy(), jz, **tol(dt))


@pytest.mark.parametrize("dt", (np.float32, np.complex128), ids=lambda d: np.dtype(d).name)
def test_hacked_oell_spmv(dt):
    c, x, _ = make("irregular", dt)
    oell = tconv.ell_to_oell(tconv.coo_to_ell(c, device="cpu"), device="cpu")
    a = tconv.coo_to_hell(c, row_perm=oell.row_perm.numpy(), device="cpu")
    got = tops.hell_spmv(a, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), c.spmv(x), **tol(dt))
    # and OELL carried through ELL -> HELL at 32-row hacks
    a2 = tconv.ell_to_hell(oell, 32, device="cpu")
    np.testing.assert_allclose(tops.hell_spmv(a2, torch.from_numpy(x)).numpy(),
                               c.spmv(x), **tol(dt))


def test_nors_mode_spmv():
    c, x, _ = make("laplacian", np.float64)
    ja = jconv.coo_to_ell(jcoo(c), store_row_lengths=False)
    a = bridge(ja)
    assert a.row_lengths is None
    got = tops.ell_spmv(a, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), c.spmv(x), rtol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.ell_spmv(ja, jnp.asarray(x))),
                               rtol=1e-12)


@pytest.mark.parametrize("batch", [(8,), (2, 3)], ids=["8", "2x3"])
@pytest.mark.parametrize("fmt", sorted(OPS))
def test_leading_batch_dimensions(fmt, batch):
    c, _, _ = make("irregular", np.float64)
    X = np.random.default_rng(4).standard_normal(batch + (c.n_cols,))
    a = bridge(OPS[fmt][0](jcoo(c)))
    got = OPS[fmt][2](a, torch.from_numpy(X))
    assert got.shape == batch + (c.n_rows,)
    np.testing.assert_allclose(got.numpy(), c.spmv(X), rtol=1e-12, atol=1e-12)


def test_cross_format_checksum():
    """dot(z, z) the same across formats (``hellPerf.cpp:234,297,359``)."""
    c, x, _ = make("banded", np.float64)
    sums = [float(tops.dot(z, z)) for z in (
        OPS[f][2](bridge(OPS[f][0](jcoo(c))), torch.from_numpy(x)) for f in sorted(OPS))]
    np.testing.assert_allclose(sums, sums[0], rtol=1e-12)


def test_ctest_duplicate_semantics():
    """``ctest.c``: duplicated diagonal entries both add (ELL, HELL)."""
    c = tfix.ctest_fixture(np.float64)
    x = torch.ones(100, dtype=torch.float64)
    for conv, op in ((tconv.coo_to_ell, tops.ell_spmv), (tconv.coo_to_hell, tops.hell_spmv)):
        np.testing.assert_allclose(op(conv(c, device="cpu"), x).numpy(), 2.0)


@pytest.mark.parametrize("fmt", ["ell", "hell", "dia", "hdia"])
def test_impl_pallas_raises(fmt):
    """As the JAX ops: the classic layouts have no kernel; "pallas"
    raises ``ValueError`` naming the layout that has one."""
    c, x, _ = make("laplacian", np.float32)
    a = bridge(OPS[fmt][0](jcoo(c)))
    with pytest.raises(ValueError, match="layout"):
        OPS[fmt][2](a, torch.from_numpy(x), impl="pallas")
    with pytest.raises(ValueError, match="Pallas"):
        OPS[fmt][1](OPS[fmt][0](jcoo(c)), jnp.asarray(x), impl="pallas")
    OPS[fmt][2](a, torch.from_numpy(x), impl="xla")  # the JAX name of the plain path


@pytest.mark.parametrize("dt", (np.float32, np.float64, np.complex64),
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("fmt", ["ell", "hell", "oell", "hell_oell"])
def test_csput_matches_jax(fmt, dt):
    """csput against the JAX csput on the same layout: ``alpha`` honoured,
    an absent coordinate skipped, every other value unchanged, and the
    other tensors shared with the input layout."""
    c, _, _ = make("irregular", dt)
    j = jcoo(c)
    ja = {"ell": lambda: jconv.coo_to_ell(j), "hell": lambda: jconv.coo_to_hell(j),
          "oell": lambda: jconv.ell_to_oell(jconv.coo_to_ell(j)),
          "hell_oell": lambda: jconv.coo_to_hell(j, row_perm=np.asarray(
              jconv.ell_to_oell(jconv.coo_to_ell(j)).row_perm))}[fmt]()
    rng = np.random.default_rng(7)
    sel = rng.choice(c.nnz, size=10, replace=False)
    r = np.r_[c.rows[sel], 0]
    cc = np.r_[c.cols[sel], c.n_cols - 1]
    v = (rng.standard_normal(11) * 3).astype(dt)
    jop = jops.ell_csput if fmt in ("ell", "oell") else jops.hell_csput
    top = tops.ell_csput if jop is jops.ell_csput else tops.hell_csput
    a = bridge(ja)
    got = top(a, r, cc, v, alpha=2.0)
    want = jop(ja, r, cc, v, alpha=2.0)
    assert np.array_equal(got.values.numpy(), np.asarray(want.values))
    assert got.col_indices is a.col_indices and got.values is not a.values
    dense = c.to_dense()
    dense[c.rows[sel], c.cols[sel]] = 2.0 * v[:10]
    if c.to_dense()[0, c.n_cols - 1] == 0:  # absent: skipped
        np.testing.assert_allclose(got.to_dense(), dense, rtol=1e-6)


def _layouts(c):
    """Every layout type of the port but the hybrid for ``c``, each with
    its packed layout where it works in lane space (else None)."""
    lane = tconv.coo_to_whell(c, device="cpu")
    return {
        "ell": (tconv.coo_to_ell(c, device="cpu"), None),
        "hell": (tconv.coo_to_hell(c, device="cpu"), None),
        "dia": (tconv.coo_to_dia(c, device="cpu"), None),
        "sdia": (tconv.coo_to_sdia(c, device="cpu"), None),
        "hdia": (tconv.coo_to_hdia(c, device="cpu"), None),
        "bcoo": (tconv.coo_to_bcoo(c, 8, 8, device="cpu"), None),
        "whell_packed": (lane, lane),
        "whell_classic": (tconv.coo_to_whell(c, device="cpu", packed=False), None),
        "pcell": (tconv.coo_to_whell_percell(c, device="cpu"), None),
        "whdia": (tconv.coo_to_whdia(c, device="cpu"), None),
    }


LAYOUT_NAMES = ["bcoo", "dia", "ell", "hdia", "hell", "hybrid", "pcell", "sdia",
                "whdia", "whell_classic", "whell_packed"]


@pytest.fixture(scope="module")
def every_layout():
    c = tfix.laplacian_2d(16, 16, np.float32)
    mixed = tfix.random_mixed(1 << 11, bands=9, wander=3, extra_avg=4.0, span=500,
                              far_frac=0.02, seed=1, dtype=np.float32)
    out = _layouts(c)
    out["hybrid"] = (tconv.coo_to_hybrid(mixed, device="cpu"), None)
    return c, mixed, out


@pytest.mark.parametrize("name", LAYOUT_NAMES)
def test_generic_spmv_dispatch(every_layout, name):
    """``ops.spmv`` runs every layout type's own op (tests/test_spmv.py:
    183-196, and the port's other layouts); a packed WHELL in lane space."""
    c, mixed, layouts = every_layout
    a, lane = layouts[name]
    coo = mixed if name == "hybrid" else c
    rng = np.random.default_rng(0)
    x = rng.standard_normal(coo.n_cols).astype(np.float32)
    y = rng.standard_normal(coo.n_rows).astype(np.float32)
    want = 0.5 * coo.spmv(x.astype(np.float64)) - 2.0 * y
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    if lane is not None:
        z = lane.extract(tops.spmv(a, lane.embed(xt, dtype=torch.float32), 0.5, -2.0,
                                   lane.embed(yt, dtype=torch.float32)),
                         dtype=torch.float64)
    else:
        z = tops.spmv(a, xt, 0.5, -2.0, yt)
    np.testing.assert_allclose(z.numpy(), want, rtol=2e-5, atol=2e-5 * np.abs(want).max())


def test_generic_spmv_refuses_other_types():
    c = tfix.laplacian_2d(8, 8, np.float32)
    bh = tconv.bcoo_to_bhdia(tconv.coo_to_bcoo(c, 4, 4, device="cpu"), device="cpu")
    for a in (bh, c, "matrix"):
        with pytest.raises(TypeError, match="no SpMV for"):
            tops.spmv(a, torch.zeros(64))


def test_ops_all_lists_the_new_ops():
    for n in ("spmv", "ell_spmv", "hell_spmv", "dia_spmv", "hdia_spmv", "bcoo_spmv",
              "hybrid_spmv", "ell_csput", "hell_csput"):
        assert n in tops.__all__ and callable(getattr(tops, n))
