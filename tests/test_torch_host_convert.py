"""PyTorch port: the classic host conversions against the JAX package's.

Each of the nineteen names of ``spgpu_tpu.convert.host`` and
``dia_to_sdia`` runs in both packages on the same COO (the three fixtures
of tests/test_spmv.py, ``ctest_fixture`` and a small matrix of duplicates
with different values, explicit zeros, an empty row and a wide shape), in
float32, float64, complex64 and complex128.  Every array of every layout
must equal the JAX one bit for bit, in the same dtype, and every static
field must be equal: the duplicate rules (ELL keeps both slots, DIA and
HDIA keep the last write), OELL's stable order, the padding, the
``hack_offsets`` sentinel, ``dia_to_hdia``'s dropped zero blocks and
BHDIA included.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spgpu_tpu.convert import host as jhost  # noqa: E402
from spgpu_tpu.convert.sdia import dia_to_sdia as j_dia_to_sdia  # noqa: E402
from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu_torch import convert as tconv  # noqa: E402
from spgpu_tpu_torch.convert import host as thost  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.formats.dia import from_numpy_planes  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402


def _mixed_rules():
    """Duplicates with different values (the last write differs), explicit
    zeros (one alone on its diagonal), an empty row, a wide shape."""
    rows = np.array([0, 0, 2, 2, 2, 3, 5, 5, 1, 4], np.int64)
    cols = np.array([1, 1, 2, 9, 2, 0, 5, 7, 6, 8], np.int64)
    vals = np.array([1.0, 5.0, 2.0, 0.0, 7.0, 3.0, 0.0, 4.0, 6.0, 8.0])
    return CooMatrix(rows, cols, vals, 7, 10)


FIX = {
    # tests/test_spmv.py:13-17
    "laplacian": lambda: tfix.laplacian_2d(11, 9),
    "irregular": lambda: tfix.random_irregular(257, 201, avg_nnz_per_row=6.0, seed=11),
    "banded": lambda: tfix.random_banded(300, bands=7, wander=2, seed=12),
    "ctest": lambda: tfix.ctest_fixture(np.float64),
    "rules": _mixed_rules,
}
DTYPES = (np.float32, np.float64, np.complex64, np.complex128)


def typed(name, dt):
    """Fixture ``name`` with ``dt`` values (complex: ``+ 1j·N(0, 1)``,
    ``default_rng(3)``, so the imaginary parts are not all zero)."""
    c = FIX[name]()
    v = c.values.astype(np.float64)
    if np.dtype(dt).kind == "c":
        v = v + 1j * np.random.default_rng(3).standard_normal(c.nnz)
    return CooMatrix(c.rows, c.cols, v.astype(dt), c.n_rows, c.n_cols)


def jcoo(c):
    return JCoo(c.rows, c.cols, c.values, c.n_rows, c.n_cols)


def assert_same_layout(port, jax_layout):
    """Every field of the port's layout equals the JAX layout's: arrays bit
    for bit and in the same dtype (None where None), statics equal."""
    assert type(port).__name__ == type(jax_layout).__name__
    for f in dataclasses.fields(jax_layout):
        got, want = getattr(port, f.name), getattr(jax_layout, f.name)
        if f.name in type(port)._TENSORS:
            assert (got is None) == (want is None), f.name
            if want is None:
                continue
            want = np.asarray(want)
            got = got.numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, f.name
            assert np.array_equal(got, want), f.name
        else:
            assert got == want, f.name
    assert port.device.type == "cpu"
    assert port.storage_bytes == jax_layout.storage_bytes
    np.testing.assert_array_equal(port.to_dense(), jax_layout.to_dense())


#: the layout conversions: name -> (port call, JAX call), each given the
#: port's and the JAX COO
LAYOUTS = {
    "coo_to_ell": (lambda c: thost.coo_to_ell(c, device="cpu"), jhost.coo_to_ell),
    "coo_to_ell_nors": (lambda c: thost.coo_to_ell(c, store_row_lengths=False,
                                                   device="cpu"),
                        lambda c: jhost.coo_to_ell(c, store_row_lengths=False)),
    "ell_to_oell": (lambda c: thost.ell_to_oell(thost.coo_to_ell(c, device="cpu"),
                                                device="cpu"),
                    lambda c: jhost.ell_to_oell(jhost.coo_to_ell(c))),
    "ell_to_hell": (lambda c: thost.ell_to_hell(thost.coo_to_ell(c, device="cpu"),
                                                device="cpu"),
                    lambda c: jhost.ell_to_hell(jhost.coo_to_ell(c))),
    "oell_to_hell": (lambda c: thost.ell_to_hell(thost.ell_to_oell(
        thost.coo_to_ell(c, device="cpu"), device="cpu"), 32, device="cpu"),
        lambda c: jhost.ell_to_hell(jhost.ell_to_oell(jhost.coo_to_ell(c)), 32)),
    "coo_to_hell": (lambda c: thost.coo_to_hell(c, device="cpu"), jhost.coo_to_hell),
    "coo_to_hell_oell": (
        lambda c: thost.coo_to_hell(c, 64, row_perm=thost.ell_to_oell(
            thost.coo_to_ell(c, device="cpu"), device="cpu").row_perm.numpy(),
            device="cpu"),
        lambda c: jhost.coo_to_hell(c, 64, row_perm=np.asarray(
            jhost.ell_to_oell(jhost.coo_to_ell(c)).row_perm))),
    "coo_to_dia": (lambda c: thost.coo_to_dia(c, device="cpu"), jhost.coo_to_dia),
    "dia_to_hdia": (lambda c: thost.dia_to_hdia(thost.coo_to_dia(c, device="cpu"),
                                                device="cpu"),
                    lambda c: jhost.dia_to_hdia(jhost.coo_to_dia(c))),
    "coo_to_hdia": (lambda c: thost.coo_to_hdia(c, device="cpu"), jhost.coo_to_hdia),
    "coo_to_hdia_32": (lambda c: thost.coo_to_hdia(c, 32, device="cpu"),
                       lambda c: jhost.coo_to_hdia(c, 32)),
    "coo_to_bcoo": (lambda c: thost.coo_to_bcoo(c, 8, 8, device="cpu"),
                    lambda c: jhost.coo_to_bcoo(c, 8, 8)),
    "coo_to_bcoo_4x3": (lambda c: thost.coo_to_bcoo(c, 4, 3, device="cpu"),
                        lambda c: jhost.coo_to_bcoo(c, 4, 3)),
    "bcoo_to_bhdia": (lambda c: thost.bcoo_to_bhdia(thost.coo_to_bcoo(c, 4, 3,
                                                                     device="cpu"),
                                                    4, device="cpu"),
                      lambda c: jhost.bcoo_to_bhdia(jhost.coo_to_bcoo(c, 4, 3), 4)),
}


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", sorted(FIX))
@pytest.mark.parametrize("conv", sorted(LAYOUTS))
def test_layout_equals_jax(conv, name, dt):
    c = typed(name, dt)
    port_fn, jax_fn = LAYOUTS[conv]
    assert_same_layout(port_fn(c), jax_fn(jcoo(c)))


#: the helpers of spGPU's API, each given (port, JAX) module and COO
HELPERS = {
    "compute_ell_row_lengths": lambda m, c: m.compute_ell_row_lengths(c),
    "compute_ell_alloc_pitch": lambda m, c: m.compute_ell_alloc_pitch(c.n_rows),
    "compute_hell_alloc_size": lambda m, c: m.compute_hell_alloc_size(
        c.row_lengths(), c.n_rows, 32, c.values.dtype),
    "compute_dia_diagonals_count": lambda m, c: m.compute_dia_diagonals_count(c),
    "compute_dia_alloc_pitch": lambda m, c: m.compute_dia_alloc_pitch(c.n_rows),
    "get_hdia_hacks_count": lambda m, c: (m.get_hdia_hacks_count(c.n_rows),
                                          m.get_hdia_hacks_count(c.n_rows, 32)),
    "compute_hdia_hack_offsets": lambda m, c: m.compute_hdia_hack_offsets(
        m.coo_to_dia(c, **({"device": "cpu"} if m is thost else {})), 32),
    "compute_hdia_hack_offsets_from_coo":
        lambda m, c: m.compute_hdia_hack_offsets_from_coo(c, 64),
    "coo_to_hdia_size": lambda m, c: m.coo_to_hdia_size(c),
    "compute_bcoo_size": lambda m, c: (m.compute_bcoo_size(c, 8, 8),
                                       m.compute_bcoo_size(c, 4, 3)),
}


@pytest.mark.parametrize("name", sorted(FIX))
@pytest.mark.parametrize("helper", sorted(HELPERS))
def test_helper_equals_jax(helper, name):
    c = typed(name, np.float64)
    got, want = HELPERS[helper](thost, c), HELPERS[helper](jhost, jcoo(c))
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert got == want


def test_every_host_name_is_ported():
    """The port's module has the nineteen names of the JAX one, re-exported
    from ``convert`` as the JAX package does."""
    assert sorted(thost.__all__) == sorted(jhost.__all__) and len(thost.__all__) == 19
    for n in thost.__all__:
        assert getattr(tconv, n) is getattr(thost, n)


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", sorted(FIX))
def test_dia_to_sdia_equals_coo_to_sdia(name, dt):
    """``dia_to_sdia`` builds the port's ``coo_to_sdia`` layout of the same
    matrix, bit for bit (duplicates summed first: the two keep the last
    write in different orders of discovery only where a cell repeats)."""
    c = typed(name, dt).sum_duplicates()
    got = tconv.dia_to_sdia(thost.coo_to_dia(c, device="cpu"), device="cpu")
    want = tconv.coo_to_sdia(c, device="cpu")
    got.check()
    assert got.offsets == want.offsets and torch.equal(got.values, want.values)
    assert torch.equal(got.offset_table, want.offset_table)


@pytest.mark.parametrize("dt", (np.float32, np.complex64), ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", sorted(FIX))
def test_dia_to_sdia_equals_jax(name, dt):
    """Against the JAX ``dia_to_sdia``, where its planes join exactly: fp32
    planes, and complex64's two fp32 planes (float64 and complex128 are
    double-float pairs there; the previous test holds those to
    ``coo_to_sdia``, whose bridge tests/test_torch_sdia.py checks)."""
    c = typed(name, dt).sum_duplicates()
    got = tconv.dia_to_sdia(thost.coo_to_dia(c, device="cpu"), device="cpu")
    ja = j_dia_to_sdia(jhost.coo_to_dia(jcoo(c)))
    if hasattr(ja, "ar"):
        def fields(p):
            return dict(values=np.asarray(p.values), values_lo=None, offsets=p.offsets)
        want = from_numpy_planes(fields(ja.ar), fields(ja.ai), ja.n_rows, ja.n_cols)
    else:
        assert ja.values_lo is None
        want = ja
    assert got.offsets == tuple(want.offsets)
    assert np.array_equal(got.values.numpy(), np.asarray(want.values))


def test_duplicate_and_zero_rules():
    """The reference semantics on the rules fixture, stated directly: ELL
    keeps both duplicates (they add), DIA and HDIA keep the last write,
    explicit zeros keep their slot, and ``dia_to_hdia`` drops the
    all-zero (hack, diagonal) block that ``coo_to_hdia`` keeps."""
    c = typed("rules", np.float64)
    d_ell = thost.coo_to_ell(c, device="cpu").to_dense()
    assert d_ell[0, 1] == 6.0 and d_ell[2, 2] == 9.0
    d_dia = thost.coo_to_dia(c, device="cpu").to_dense()
    assert d_dia[0, 1] == 5.0 and d_dia[2, 2] == 7.0
    assert thost.coo_to_hdia(c, device="cpu").to_dense()[2, 2] == 7.0
    ell = thost.coo_to_ell(c, device="cpu")
    assert int(ell.row_lengths[5]) == 2 and int(ell.col_indices[0, 5]) == 5
    hdia_direct = thost.coo_to_hdia(c, 4, device="cpu")
    hdia_from_dia = thost.dia_to_hdia(thost.coo_to_dia(c, device="cpu"), 4, device="cpu")
    assert 0 in hdia_direct.offsets.tolist()  # row 5's explicit zero on diagonal 0
    assert hdia_from_dia.total_slots <= hdia_direct.total_slots


def test_oell_order_is_stable_descending():
    c = typed("irregular", np.float32)
    oell = thost.ell_to_oell(thost.coo_to_ell(c, device="cpu"), device="cpu")
    lens = oell.row_lengths.numpy().astype(np.int64)
    perm = oell.row_perm.numpy()
    assert np.all(np.diff(lens) <= 0)
    for v in np.unique(lens):  # equal lengths keep their original order
        assert np.all(np.diff(perm[lens == v]) > 0)
    assert set(perm[perm >= c.n_rows]) == set(range(c.n_rows, oell.rows_padded))


@pytest.mark.parametrize("conv", ["coo_to_ell", "coo_to_hell", "coo_to_dia",
                                  "coo_to_hdia"])
def test_other_value_types_raise(conv):
    c = tfix.laplacian_2d(4, 4)
    c = CooMatrix(c.rows, c.cols, c.values.astype(np.float16), 16, 16)
    with pytest.raises(NotImplementedError, match="float16"):
        getattr(thost, conv)(c, device="cpu")


def test_layouts_move_between_devices():
    """``to(device)`` moves every tensor and keeps the rest; the device is
    required."""
    c = typed("irregular", np.float32)
    for conv in (thost.coo_to_ell, thost.coo_to_hell, thost.coo_to_dia,
                 thost.coo_to_hdia):
        a = conv(c, device="cpu")
        b = a.to("meta")
        assert b.device.type == "meta" and b.shape == a.shape
        with pytest.raises(TypeError):
            conv(c)
