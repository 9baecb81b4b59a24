"""PyTorch port: SDIA converter and SpMV against the JAX package.

The port's ``coo_to_sdia`` must build the JAX converter's planes bit for
bit.  One layout (built by the JAX converter, carried across by the
bridge) goes through the JAX ``sdia_spmv`` (its Pallas kernel in
interpret mode on the CPU) and the port's ``sdia_spmv`` (the plain
PyTorch version of kernel #2 on CPU tensors); both are held against the
host float64 golden.  Tolerance as in tests/test_sdia.py: rtol 0,
atol = 5e-6·max|golden|.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu import ops as jops  # noqa: E402
from spgpu_tpu.convert.sdia import coo_to_sdia as j_coo_to_sdia  # noqa: E402
from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.utils import fixtures as jfix  # noqa: E402
from spgpu_tpu_torch import ops as tops  # noqa: E402
from spgpu_tpu_torch.convert import coo_to_sdia  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.formats.dia import from_numpy_fields  # noqa: E402
from spgpu_tpu_torch.kernels import sdia as ks  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)


def _dups(f):
    """Every diagonal entry twice, the second write different."""
    i = np.arange(6, dtype=np.int64) % 3
    return f.CooMatrix(i, i, np.asarray([1, 2, 3, 10, 20, 30], np.float32), 3, 3)


# the cases of tests/test_sdia.py:27-75, plus raw duplicates
CASES = {
    "laplace": lambda f: f.laplacian_2d(40, 40, dtype=np.float32),
    "laplace24": lambda f: f.laplacian_2d(24, 24, dtype=np.float32),
    "banded": lambda f: f.random_banded(3000, bands=9, seed=1, dtype=np.float32),
    "banded_wide": lambda f: f.random_banded(2000, bands=31, seed=2,
                                             dtype=np.float32),
    "tall": lambda f: f.random_irregular(700, 90, avg_nnz_per_row=4.0, seed=3,
                                         dtype=np.float32),
    "wide": lambda f: f.random_irregular(90, 700, avg_nnz_per_row=12.0, seed=4,
                                         dtype=np.float32),
    "empty": lambda f: f.CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                   np.zeros(0, np.float32), 64, 64),
    "dups": _dups,
}


def bridge(ja):
    return from_numpy_fields(np.asarray(ja.values), ja.offsets, ja.n_rows,
                             ja.n_cols, values_lo=ja.values_lo)


def assert_close_to(z, want):
    np.testing.assert_allclose(z, want, rtol=0,
                               atol=5e-6 * max(np.abs(want).max(initial=0), 1e-30))


@pytest.mark.parametrize("name", sorted(CASES))
def test_converter_bit_identical(name):
    ja = j_coo_to_sdia(CASES[name](jfix))
    ta = coo_to_sdia(CASES[name](tfix), device="cpu")
    jv = np.asarray(ja.values)
    assert ta.values.dtype == torch.float32 and jv.dtype == np.float32
    np.testing.assert_array_equal(ta.values.numpy(), jv)
    assert ta.offsets == ja.offsets
    assert ta.offset_table.tolist() == list(ja.offsets)
    assert (ta.n_rows, ta.n_cols, ta.n_tiles) == (ja.n_rows, ja.n_cols, ja.n_tiles)
    ta.check()
    np.testing.assert_array_equal(ta.to_dense(), ja.to_dense())


@pytest.mark.parametrize("name", sorted(CASES))
def test_spmv_matches_jax_and_golden(name):
    coo = CASES[name](jfix)
    ja = j_coo_to_sdia(coo)
    ta = bridge(ja)
    x = np.random.default_rng(0).standard_normal(coo.n_cols).astype(np.float32)
    zj = np.asarray(jops.sdia_spmv(ja, jnp.asarray(x)), np.float64)
    zt = tops.sdia_spmv(ta, torch.from_numpy(x)).double().numpy()
    golden = JCoo(*_last_write(coo)).spmv(x.astype(np.float64))
    assert zt.shape == (coo.n_rows,)
    assert_close_to(zt, golden)
    assert_close_to(zt, zj)


def _last_write(coo):
    """The COO with duplicates resolved as SDIA stores them (last wins)."""
    d = {}
    for r, c, v in zip(coo.rows.tolist(), coo.cols.tolist(), coo.values.tolist()):
        d[(r, c)] = v
    rc = np.array(list(d), np.int64).reshape(-1, 2)
    return (rc[:, 0], rc[:, 1], np.array(list(d.values()), np.float32),
            coo.n_rows, coo.n_cols)


def test_alpha_beta_y():
    coo = CASES["laplace24"](tfix)
    a = coo_to_sdia(coo, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal(coo.n_cols).astype(np.float32)
    y = rng.standard_normal(coo.n_rows).astype(np.float32)
    gold = 2.5 * coo.spmv(x.astype(np.float64)) - 0.5 * y
    z = tops.sdia_spmv(a, torch.from_numpy(x), alpha=2.5, beta=-0.5,
                       y=torch.from_numpy(y))
    assert_close_to(z.double().numpy(), gold)
    zj = jops.sdia_spmv(j_coo_to_sdia(CASES["laplace24"](jfix)), jnp.asarray(x),
                        alpha=2.5, beta=-0.5, y=jnp.asarray(y))
    assert_close_to(z.double().numpy(), np.asarray(zj, np.float64))


def test_static_beta_zero_never_reads_y():
    a = coo_to_sdia(CASES["banded"](tfix), device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(a.n_cols)
                         .astype(np.float32))
    nan_y = torch.full((a.n_rows,), float("nan"))
    z = tops.sdia_spmv(a, x, alpha=1.0, beta=0.0, y=nan_y)
    torch.testing.assert_close(z, tops.sdia_spmv(a, x), rtol=0, atol=0)


def test_empty_gives_zeros_and_beta_y():
    a = coo_to_sdia(CASES["empty"](tfix), device="cpu")
    assert a.n_diags == 0 and a.values.shape[0] == 1
    z = tops.sdia_spmv(a, torch.ones(64))
    assert z.shape == (64,) and bool((z == 0).all())
    y = torch.arange(64, dtype=torch.float32)
    torch.testing.assert_close(tops.sdia_spmv(a, torch.ones(64), 3.0, 0.5, y),
                               0.5 * y)


@pytest.mark.parametrize("dtype,item", [(np.float16, "planned")])
def test_unported_dtypes_raise(dtype, item):
    c = tfix.laplacian_2d(8, 8, np.float64)
    coo = CooMatrix(c.rows, c.cols, c.values.astype(dtype), 64, 64)
    with pytest.raises(NotImplementedError, match=item):
        coo_to_sdia(coo, device="cpu")


def test_complex64_matches_jax_planes():
    """A complex64 COO converts into the JAX ``ComplexPlanes``' offsets
    and planes ``ar + i·ai``, and its product matches the JAX one
    (tests/test_torch_complex.py covers complex in full)."""
    c = CASES["laplace24"](jfix)
    rng = np.random.default_rng(3)
    v = (c.values + 1j * rng.standard_normal(c.nnz)).astype(np.complex64)
    ja = j_coo_to_sdia(JCoo(c.rows, c.cols, v, c.n_rows, c.n_cols))
    ta = coo_to_sdia(CooMatrix(c.rows, c.cols, v, c.n_rows, c.n_cols), device="cpu")
    assert ta.values.dtype == torch.complex64 and ta.offsets == ja.ar.offsets
    np.testing.assert_array_equal(ta.values.numpy().real, np.asarray(ja.ar.values))
    np.testing.assert_array_equal(ta.values.numpy().imag, np.asarray(ja.ai.values))
    x = (rng.standard_normal(c.n_cols) + 1j * rng.standard_normal(c.n_cols)).astype(np.complex64)
    zj = ja.extract_complex(np.asarray(jops.sdia_spmv(ja, jnp.asarray(ja.embed_complex(x)))))
    zt = tops.sdia_spmv(ta, torch.from_numpy(x)).numpy()
    assert_close_to(zt, zj)


def test_bridge_rejects_double_float():
    """A double-float pair crosses joined into float64
    (tests/test_torch_f64.py); a pair whose planes do not match raises."""
    ja = j_coo_to_sdia(jfix.laplacian_2d(8, 8, np.float64))
    assert ja.is_dd
    joined = np.asarray(ja.values, np.float64) + np.asarray(ja.values_lo, np.float64)
    np.testing.assert_array_equal(bridge(ja).values.numpy(), joined)
    with pytest.raises(ValueError, match="double-float pair"):
        from_numpy_fields(np.asarray(ja.values), ja.offsets, ja.n_rows, ja.n_cols,
                          values_lo=np.asarray(ja.values_lo)[:1])


def test_cpu_path_counts_no_launches():
    a = coo_to_sdia(CASES["laplace"](tfix), device="cpu")
    before = ks.LAUNCHES
    tops.sdia_spmv(a, torch.zeros(a.n_cols))
    assert ks.LAUNCHES == before


def test_wrapper_rejects_bad_operands():
    a = coo_to_sdia(CASES["laplace"](tfix), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tops.sdia_spmv(a, torch.zeros(a.n_cols + 1))
    with pytest.raises(ValueError, match="float32"):
        tops.sdia_spmv(a, torch.zeros(a.n_cols, dtype=torch.float64))
    with pytest.raises(ValueError, match="device"):
        ks.sdia_spmv(a.values, a.offset_table,
                     torch.zeros(a.n_cols, device="meta"), n_rows=a.n_rows)
    with pytest.raises(ValueError, match="no kernel"):
        ks.sdia_spmv(a.values.to("meta"), a.offset_table.to("meta"),
                     torch.zeros(a.n_cols, device="meta"), n_rows=a.n_rows)
