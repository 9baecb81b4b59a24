"""PyTorch port: WHDIA converter and SpMV against the JAX package.

The port's ``coo_to_whdia`` must build the JAX converter's arrays bit for
bit, in both r0 modes (``slot_r0`` crosses as its first lane: the port
keeps one int16 per slot).  One layout (built by the JAX converter,
carried across by the bridge) goes through the JAX kernel in interpret
mode and the port's ``whdia_spmv`` (the plain PyTorch version of kernel
#3 on CPU tensors); both are held against the host float64 golden at
rtol = atol = 2e-5, as in tests/test_whdia.py.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu import ops as jops  # noqa: E402
from spgpu_tpu.convert.whdia import coo_to_whdia as j_coo_to_whdia  # noqa: E402
from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.ops.pallas_kernels import whdia_spmv_pallas  # noqa: E402
from spgpu_tpu.utils import fixtures as jfix  # noqa: E402
from spgpu_tpu_torch import ops as tops  # noqa: E402
from spgpu_tpu_torch.convert import coo_to_whdia  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.formats.whdia import from_numpy_fields  # noqa: E402
from spgpu_tpu_torch.kernels import whdia as kd  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)

# the cases of tests/test_whdia.py:21-28, plus the empty matrix
CASES = {
    "laplace2d": lambda f: f.laplacian_2d(23, 31, np.float32),
    "laplace2d_wide": lambda f: f.laplacian_2d(200, 30, np.float32),
    "laplace3d": lambda f: f.laplacian_3d(12, 11, 9, np.float32),
    "banded": lambda f: f.random_banded(900, bands=7, wander=13, seed=4,
                                        dtype=np.float32),
    "banded_wide": lambda f: f.random_banded(2000, bands=31, wander=0, seed=5,
                                             dtype=np.float32),
    "banded_neg": lambda f: f.random_banded(700, bands=5, wander=3, seed=6,
                                            dtype=np.float32),
    "empty": lambda f: f.CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                   np.zeros(0, np.float32), 200, 200),
}
ARRAYS = ("values", "slot_r0", "tile_r0", "tile_base", "chunk_group")
STATIC = ("n_rows", "n_cols", "num_hacks", "num_groups", "total_slots", "nnz",
          "x_pages", "window_pages", "group_hacks", "chunk_tiles")
TOL = dict(rtol=2e-5, atol=2e-5)


def bridge(ja):
    return from_numpy_fields(
        {f: None if getattr(ja, f) is None else np.asarray(getattr(ja, f))
         for f in ARRAYS + ("values_lo",)},
        **{f: getattr(ja, f) for f in STATIC})


def assert_same_layout(ja, ta):
    for f in ARRAYS:
        jv, tv = getattr(ja, f), getattr(ta, f)
        assert (jv is None) == (tv is None), f
        if jv is None:
            continue
        jv = np.asarray(jv)
        if f == "slot_r0":
            assert (jv == jv[:, :1]).all()  # lane-replicated in JAX
            jv = jv[:, 0]
        tv = tv.numpy()
        assert jv.dtype == tv.dtype, (f, jv.dtype, tv.dtype)
        np.testing.assert_array_equal(tv, jv, err_msg=f)
    for f in STATIC:
        assert getattr(ja, f) == getattr(ta, f), f


@pytest.mark.parametrize("name", sorted(CASES))
def test_converter_bit_identical(name):
    ja = j_coo_to_whdia(CASES[name](jfix))
    ta = coo_to_whdia(CASES[name](tfix), device="cpu")
    assert_same_layout(ja, ta)
    ta.check()
    np.testing.assert_array_equal(ta.slot_r0_host(), ja.slot_r0_host())


@pytest.mark.parametrize("name", sorted(CASES))
def test_layout_roundtrip(name):
    coo = CASES[name](tfix).sum_duplicates()
    a = coo_to_whdia(coo, device="cpu")
    np.testing.assert_array_equal(a.to_dense(), coo.to_dense())
    assert a.total_slots % 64 == 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_spmv_matches_jax_and_golden(name):
    coo = CASES[name](jfix)
    ja = j_coo_to_whdia(coo)
    ta = bridge(ja)
    x = np.random.default_rng(0).standard_normal(coo.n_cols).astype(np.float32)
    zj = np.asarray(whdia_spmv_pallas(ja, jnp.asarray(x), interpret=True),
                    np.float64)
    zt = tops.whdia_spmv(ta, torch.from_numpy(x)).double().numpy()
    golden = coo.spmv(x.astype(np.float64))
    assert zt.shape == (coo.n_rows,)
    np.testing.assert_allclose(zt, golden, **TOL)
    np.testing.assert_allclose(zt, zj, **TOL)


def test_r0_modes():
    """A contiguous band packs r0 per tile (pattern mode); the Laplacian's
    ±n offsets keep one r0 per slot (slab mode), in both packages."""
    for name, pattern in (("banded", True), ("banded_neg", True),
                          ("laplace2d", False), ("laplace3d", False)):
        ta = coo_to_whdia(CASES[name](tfix), device="cpu")
        assert ta.pattern_mode == pattern, name
        assert (j_coo_to_whdia(CASES[name](jfix)).tile_r0 is not None) == pattern


def test_duplicates_last_write_wins():
    i = np.arange(6, dtype=np.int64) % 3
    vals = np.asarray([1, 2, 3, 10, 20, 30], np.float32)
    a = coo_to_whdia(CooMatrix(i, i, vals, 3, 3), device="cpu")
    np.testing.assert_array_equal(np.diag(a.to_dense()), [10, 20, 30])
    z = tops.whdia_spmv(a, torch.ones(3))
    np.testing.assert_array_equal(z.numpy(), [10, 20, 30])


def test_alpha_beta_y():
    coo = tfix.laplacian_2d(16, 16, np.float32)
    a = coo_to_whdia(coo, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal(coo.n_cols).astype(np.float32)
    y = rng.standard_normal(coo.n_rows).astype(np.float32)
    z = tops.whdia_spmv(a, torch.from_numpy(x), alpha=2.0, beta=0.5,
                        y=torch.from_numpy(y))
    np.testing.assert_allclose(z.numpy(), 2.0 * coo.spmv(x) + 0.5 * y, **TOL)


def test_static_beta_zero_never_reads_y():
    a = coo_to_whdia(CASES["banded"](tfix), device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(a.n_cols)
                         .astype(np.float32))
    nan_y = torch.full((a.n_rows,), float("nan"))
    z = tops.whdia_spmv(a, x, alpha=1.0, beta=0.0, y=nan_y)
    torch.testing.assert_close(z, tops.whdia_spmv(a, x), rtol=0, atol=0)


def test_check_rejects_bad_layouts():
    a = coo_to_whdia(CASES["laplace2d"](tfix), device="cpu")
    a.check()
    bad_group = a.to("cpu")
    bad_group.chunk_group = a.chunk_group.clone().fill_(a.num_groups)
    with pytest.raises(ValueError, match="chunk_group"):
        bad_group.check()
    bad_col = a.to("cpu")
    bad_col.slot_r0 = a.slot_r0.clone() - 2000  # every column goes negative
    with pytest.raises(ValueError, match="n_cols"):
        bad_col.check()
    both = a.to("cpu")
    both.tile_r0 = torch.zeros(a.num_tiles, dtype=torch.int32)
    with pytest.raises(ValueError, match="exactly one"):
        both.check()


def test_base_page_past_16_bits_raises(monkeypatch):
    """Past 65,536 column pages the base page lives in the full-width
    ``tile_page`` (``tile_base`` keeps its low 16 bits); the converter
    raises only past the word's bound."""
    n = 9_000_000
    coo = CooMatrix(np.array([n - 1]), np.array([n - 1]),
                    np.ones(1, np.float32), n, n)
    a = coo_to_whdia(coo, device="cpu")
    page = int(a.tile_page.max())
    assert page > 0xFFFF and page * 128 <= n - 1 < (page + a.window_pages) * 128
    assert torch.equal(a.tile_base & 0xFFFF, a.tile_page & 0xFFFF)
    monkeypatch.setattr(importlib.import_module("spgpu_tpu_torch.convert.whdia"),
                        "_MAX_TILE_PAGE", 0xFFFF)
    with pytest.raises(ValueError, match="31-bit"):
        coo_to_whdia(coo, device="cpu")


@pytest.mark.parametrize("dtype,item", [(np.float16, "planned")])
def test_unported_dtypes_raise(dtype, item):
    c = tfix.laplacian_2d(8, 8, np.float64)
    coo = CooMatrix(c.rows, c.cols, c.values.astype(dtype), 64, 64)
    with pytest.raises(NotImplementedError, match=item):
        coo_to_whdia(coo, device="cpu")


def test_complex64_matches_jax_planes():
    """A complex64 COO converts into the structure of the JAX
    ``ComplexPlanes``' planes and a slab ``ar + i·ai``, and its product
    matches the JAX one (tests/test_torch_complex.py covers complex in
    full)."""
    c = CASES["laplace2d"](jfix)
    rng = np.random.default_rng(3)
    v = (c.values + 1j * rng.standard_normal(c.nnz)).astype(np.complex64)
    ja = j_coo_to_whdia(JCoo(c.rows, c.cols, v, c.n_rows, c.n_cols))
    ta = coo_to_whdia(CooMatrix(c.rows, c.cols, v, c.n_rows, c.n_cols), device="cpu")
    assert ta.values.dtype == torch.complex64
    for f in ("tile_base", "chunk_group"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(), np.asarray(getattr(ja.ar, f)))
    np.testing.assert_array_equal(ta.slot_r0_host(), ja.ar.slot_r0_host())
    np.testing.assert_array_equal(ta.values.numpy().real, np.asarray(ja.ar.values))
    np.testing.assert_array_equal(ta.values.numpy().imag, np.asarray(ja.ai.values))
    x = (rng.standard_normal(c.n_cols) + 1j * rng.standard_normal(c.n_cols)).astype(np.complex64)
    zj = ja.extract_complex(np.asarray(jops.whdia_spmv(ja, jnp.asarray(ja.embed_complex(x)))))
    zt = tops.whdia_spmv(ta, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(zt, zj, rtol=0, atol=3e-5 * np.abs(zj).max())


def test_cpu_path_counts_no_launches():
    a = coo_to_whdia(CASES["banded"](tfix), device="cpu")
    before = kd.LAUNCHES
    tops.whdia_spmv(a, torch.zeros(a.n_cols))
    assert kd.LAUNCHES == before


def test_wrapper_rejects_bad_operands():
    a = coo_to_whdia(CASES["banded"](tfix), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tops.whdia_spmv(a, torch.zeros(a.n_cols + 1))
    with pytest.raises(ValueError, match="float32"):
        tops.whdia_spmv(a, torch.zeros(a.n_cols, dtype=torch.float64))
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  num_groups=a.num_groups, tile_page=a.tile_page)
    with pytest.raises(ValueError, match="exactly one"):
        kd.whdia_spmv(a.values, torch.zeros(a.total_slots, dtype=torch.int16),
                      a.tile_r0, a.tile_base, a.chunk_group,
                      torch.zeros(a.n_cols), **static)
    with pytest.raises(ValueError, match="device"):
        kd.whdia_spmv(a.values, a.slot_r0, a.tile_r0, a.tile_base,
                      a.chunk_group, torch.zeros(a.n_cols, device="meta"),
                      **static)
