"""PyTorch port: packed WHELL SpMV against the JAX package.

One layout (built by the JAX converter, carried across by the bridge)
goes through the JAX ``whell_spmv`` (its Pallas kernel in interpret mode
on the CPU) and the port's ``whell_spmv`` (the plain PyTorch version of
kernel #1 on CPU tensors), and both are held against the host COO golden.
fp32 tolerance rtol = atol = 2e-5, as in tests/test_whell.py: the two
sum each row's products in different orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu import ops as jops  # noqa: E402
from spgpu_tpu.convert.whell import coo_to_whell as j_coo_to_whell  # noqa: E402
from spgpu_tpu.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu.utils.fixtures import (  # noqa: E402
    ctest_fixture,
    laplacian_2d,
    random_banded,
    random_fem_like,
    random_irregular,
)
from spgpu_tpu_torch import ops as tops  # noqa: E402
from spgpu_tpu_torch.formats.whell import from_numpy_fields  # noqa: E402
from spgpu_tpu_torch.kernels import whell as kw  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)

CASES = {
    "fem": lambda: random_fem_like(4000, 16.0, span=256, far_frac=0.02,
                                   seed=5, dtype=np.float32),
    "laplace": lambda: laplacian_2d(23, 31, np.float32),
    "irregular": lambda: random_irregular(1000, 1000, 9.0, seed=3,
                                          dtype=np.float32),
    "banded": lambda: random_banded(900, bands=7, wander=13, seed=4,
                                    dtype=np.float32),
    "ctest": lambda: ctest_fixture(np.float32),
    "empty": lambda: CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64),
                               np.zeros(0, np.float32), 300, 300),
}
TOL = dict(rtol=2e-5, atol=2e-5)

ARRAYS = ("values", "residue", "page_tab", "tile_base", "chunk_group",
          "seg_lo", "seg_hi", "lane_of_row", "group_bases")
STATIC = ("n_rows", "n_cols", "num_hacks", "num_groups", "total_slots", "nnz",
          "x_pages", "window_pages", "orig_rows", "group_hacks", "chunk_tiles",
          "unit_segments")


def bridge(ja):
    """The JAX layout's arrays and static fields → the port's layout."""
    return from_numpy_fields(
        {f: None if getattr(ja, f) is None else np.asarray(getattr(ja, f))
         for f in ARRAYS},
        **{f: getattr(ja, f) for f in STATIC})


def both(coo, x, alpha=1.0, beta=0.0, y=None, **conv):
    """(JAX z, port z, golden z) in original space, float64 arrays."""
    ja = j_coo_to_whell(coo, packed=True, **conv)
    ta = bridge(ja)
    xl = np.array(ja.embed(jnp.asarray(x)))
    yl = None if y is None else np.array(ja.embed(jnp.asarray(y)))
    zj = jops.whell_spmv(ja, jnp.asarray(xl), alpha=alpha, beta=beta,
                         y=None if yl is None else jnp.asarray(yl))
    zt = tops.whell_spmv(ta, torch.from_numpy(xl), alpha=alpha, beta=beta,
                         y=None if yl is None else torch.from_numpy(yl))
    lor = np.asarray(ja.lane_of_row)
    golden = alpha * coo.spmv(x.astype(np.float64))
    if y is not None:
        golden = golden + beta * y
    return (np.asarray(zj, np.float64)[lor],
            ta.extract(zt, dtype=torch.float64).numpy(), golden)


@pytest.mark.parametrize("scattered", [True, False], ids=["scattered", "aligned"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_spmv_matches_jax_and_golden(name, scattered):
    coo = CASES[name]()
    x = np.random.default_rng(0).standard_normal(coo.n_cols).astype(np.float32)
    zj, zt, golden = both(coo, x, scattered=scattered)
    np.testing.assert_allclose(zt, zj, **TOL)
    np.testing.assert_allclose(zt, golden, **TOL)


def test_unit_segments_path_taken():
    """The Laplacian has one lane per row: the flush skips the scan."""
    ja = j_coo_to_whell(CASES["laplace"](), packed=True)
    assert ja.unit_segments and bridge(ja).unit_segments
    assert not j_coo_to_whell(CASES["fem"](), packed=True).unit_segments


@pytest.mark.parametrize("name", ["fem", "laplace"])
def test_alpha_beta_y(name):
    coo = CASES[name]()
    rng = np.random.default_rng(1)
    x = rng.standard_normal(coo.n_cols).astype(np.float32)
    y = rng.standard_normal(coo.n_rows).astype(np.float32)
    zj, zt, golden = both(coo, x, alpha=2.5, beta=-0.5, y=y)
    np.testing.assert_allclose(zt, zj, **TOL)
    np.testing.assert_allclose(zt, golden, **TOL)


def test_static_beta_zero_never_reads_y():
    coo = CASES["fem"]()
    ta = bridge(j_coo_to_whell(coo, packed=True))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(ta.n_cols)
                         .astype(np.float32))
    nan_y = torch.full((ta.n_rows,), float("nan"))
    z = tops.whell_spmv(ta, x, alpha=1.0, beta=0.0, y=nan_y)
    assert torch.isfinite(z).all()
    torch.testing.assert_close(z, tops.whell_spmv(ta, x), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["fem", "irregular"])
def test_bf16_values(name):
    """bf16 value slabs with fp32 x and accumulation; the golden uses the
    bf16-rounded values, so fp32-level tolerances hold."""
    coo = CASES[name]()
    x = np.random.default_rng(6).standard_normal(coo.n_cols).astype(np.float32)
    ja = j_coo_to_whell(coo, packed=True, dtype=jnp.bfloat16)
    ta = bridge(ja)
    assert ta.values.dtype == torch.bfloat16
    xl = np.array(ja.embed(jnp.asarray(x)))
    zj = np.asarray(jops.whell_spmv(ja, jnp.asarray(xl)), np.float64)
    zt = tops.whell_spmv(ta, torch.from_numpy(xl)).double().numpy()
    np.testing.assert_allclose(zt, zj, **TOL)
    v16 = torch.from_numpy(coo.values).to(torch.bfloat16).double().numpy()
    golden = CooMatrix(coo.rows, coo.cols, v16, coo.n_rows, coo.n_cols).spmv(
        x.astype(np.float64))
    np.testing.assert_allclose(zt[np.asarray(ja.lane_of_row)], golden, **TOL)


def test_cpu_path_does_not_count_launches():
    coo = CASES["banded"]()
    ta = bridge(j_coo_to_whell(coo, packed=True))
    before = kw.LAUNCHES
    tops.whell_spmv(ta, torch.zeros(ta.n_cols))
    assert kw.LAUNCHES == before


def test_wrapper_rejects_bad_operands():
    ta = bridge(j_coo_to_whell(CASES["fem"](), packed=True))
    with pytest.raises(ValueError, match="shape"):
        tops.whell_spmv(ta, torch.zeros(ta.n_cols + 1))
    with pytest.raises(ValueError, match="x2d"):
        tops.whell_spmv(ta, torch.zeros(ta.n_cols, dtype=torch.float64))
    with pytest.raises(ValueError, match="device"):
        kw.whell_packed_spmv(
            ta.values, ta.residue, ta.page_tab, ta.tile_base, ta.chunk_group,
            ta.group_bases, ta.seg_lo, ta.seg_hi,
            torch.zeros((ta.x_pages, 128), device="meta"),
            chunk_tiles=ta.chunk_tiles, group_hacks=ta.group_hacks,
            window_pages=ta.window_pages, unit_segments=ta.unit_segments,
            tile_page=ta.tile_page)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("scattered", [True, False], ids=["scattered", "aligned"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_jax_on_cuda(name, scattered, cuda_device):
    """The hand kernel on the card against the JAX product (on the CPU)
    and the golden; the kernel adds with FMAs in the per-hack order, which
    is not the JAX kernel's tile order, hence the tolerance."""
    coo = CASES[name]()
    x = np.random.default_rng(0).standard_normal(coo.n_cols).astype(np.float32)
    ja = j_coo_to_whell(coo, packed=True, scattered=scattered)
    ta = bridge(ja).to(cuda_device)
    xl = np.array(ja.embed(jnp.asarray(x)))
    before = kw.LAUNCHES
    zt = tops.whell_spmv(ta, torch.from_numpy(xl).to(cuda_device))
    assert kw.LAUNCHES == before + 1
    zj = np.asarray(jops.whell_spmv(ja, jnp.asarray(xl)), np.float64)
    np.testing.assert_allclose(zt.double().cpu().numpy(), zj, **TOL)
