"""PyTorch port on a CUDA device: kernels #1-#19 against their plain versions.

Needs no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` skips the JAX set-up of ``tests/conftest.py``).  Every
test skips without a CUDA device.  Kernel #1 (WHELL) sums each hack's run
tile by tile and slot by slot with FMAs, as its per-hack plain version
does with rounded products, and #3 (WHDIA) each hack's live slots in
list order with FMAs, in another order than the plain version's
``index_add_``, hence rtol 1e-5 and atol 1e-5·max|z|; kernel
#2 (SDIA) owns each row in one thread and sums the diagonals in the
plain version's order, hence rtol 1e-6 and atol 1e-6·max|z|.  Against
the float64 host golden the fp32 tolerance is 2e-5.

The float64 kernels (#4 WHELL, #5 SDIA, #6 WHDIA) are held to 1e-12·max|z|
against their plain float64 versions and the golden; #5, like #2, sums in
the plain version's order with the same roundings and must match it
exactly.

The complex kernels (complex64: #7 WHELL, #8 SDIA, #9 WHDIA; complex128:
the WHELL kernel, #11 SDIA, #10 WHDIA) are held to their plain versions
with the tolerances of their real type (complex64 WHELL and WHDIA: rtol
1e-5, atol 1e-5·max|z|; complex128: 1e-12·max|z|), SDIA exactly in both;
against the complex128 golden complex64 takes 2e-5·max|z|.

The multi-RHS kernels (#12 WHELL and #13 WHDIA, hack passes: rtol 1e-5
and atol 1e-5·max|Z|, their sums in another order than the plain
version's; #14 SDIA: exact, and equal to one launch of #2 per RHS) run at
1, 3, 5, 8, 11 and 17 RHS, with their ``LAUNCHES_SPMM`` counts; the loop
path of each SpMM launches only SpMV kernels.  #12 is one launch with the
same bits every call, adds chunked runs in order, and skips an Inf in x
that only padding tiles read.  Two products of one chunked-run layout on
two streams at once stay at the golden (fault F2: the run counters are
each call's own).

#3, #6 and #10 (fp32, float64 and complex128 WHDIA, the warp pass), #9
(complex64 WHDIA) and #13 (the hack pass) read only each hack's live
slots: they are held to the full-layout plain version and to the listed
plain product (float64 and complex128 at 1e-12·max|z|), at 1, 3, 8, 9
and 17 RHS for #13, on layouts with empty row blocks whose rows the
kernel must write without a zero fill, twice with the same bits, and
shown to skip an Inf in x that only all-zero slots reach (a deviation
from the JAX kernel, which gives NaN there); without the lists, or (#3,
#6) on a slab that is not 16 B aligned, they raise.  The float64 and
complex128 WHDIA solves give the same bits graphed and eager.

Every packed-WHELL SpMV (#1 in fp32 and bf16, #4, #7, complex128) is one
launch of the hack pass over the layout's work units: the same bits
every call, chunked runs added in order, each call's own run counters,
no read of a padding tile.  Their solves give the same bits graphed and
eager.  Kernel #18's hack
levels (of #3 at 1 RHS, of #13 at 8) are held to their plain versions.

Classic WHELL (#15 SpMV, #16 SpMM; fp32 and bf16 values, OELL order and
way-split rows) and pcell (#17) sum with atomics: rtol 1e-5 and atol
1e-5·max|z| against their plain versions; 2e-5 (classic) and 1e-5·max|z|
(pcell) against the golden.  #15 and #16 read only the live units of the
work list: they are held to the full-layout plain version on layouts
with explicit zeros, all-dead tiles (for #16 also the empty list and one
unit) and after ``whell_update_values``, and shown to skip an Inf in x
that only zero-valued cells read (a deviation from the JAX kernel, which
gives NaN there).  #17 runs one warp per tile
and 4 tiles per block: it is checked on a tile count that is not a
multiple of 4.

The classic layouts (ELL, OELL, HELL, DIA, HDIA, BCOO: plain torch)
compute on the card when given CUDA tensors, at the golden and at their
CPU product; csput too.  One hybrid product launches #3 (#6) once and #1
(#4) once and gives the same bits twice; the hybrid and hell solve()
routes give the same bits graphed and eager.

Large systems on one layout: #1 and #4 (aligned packed), #15 (classic),
#3 and #6 (WHDIA) on a 9,000,000-row tridiagonal, past the 65,536 x pages
of ``tile_base``'s 16-bit page field, against their plain versions and
the golden at the tolerances above (the page read from ``tile_page``).
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spgpu_tpu_torch import convert as _conv  # noqa: E402
from spgpu_tpu_torch import ops  # noqa: E402
from spgpu_tpu_torch.convert import (  # noqa: E402
    coo_to_sdia,
    coo_to_whdia,
    coo_to_whell,
    coo_to_whell_percell,
)
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.kernels import pcell as kp  # noqa: E402
from spgpu_tpu_torch.kernels import sdia as ks  # noqa: E402
from spgpu_tpu_torch.kernels import whdia as kd  # noqa: E402
from spgpu_tpu_torch.kernels import whell as kw  # noqa: E402
from spgpu_tpu_torch.kernels import whell_classic as kc  # noqa: E402
from spgpu_tpu_torch.solvers import solve  # noqa: E402
from spgpu_tpu_torch.utils.fixtures import (  # noqa: E402
    ctest_fixture,
    laplacian_2d,
    laplacian_3d,
    random_banded,
    random_fem_like,
    random_irregular,
    random_mixed,
)

CASES = {
    "fem": lambda: random_fem_like(4000, 16.0, span=256, far_frac=0.02,
                                   seed=5, dtype=np.float32),
    "fem_large": lambda: random_fem_like(60000, 27.0, span=768, far_frac=0.01,
                                         seed=1, dtype=np.float32),
    "laplace": lambda: laplacian_2d(23, 31, np.float32),
    "laplace_wide": lambda: laplacian_2d(200, 30, np.float32),
    "irregular": lambda: random_irregular(1000, 1000, 9.0, seed=3,
                                          dtype=np.float32),
    "banded": lambda: random_banded(900, bands=7, wander=13, seed=4,
                                    dtype=np.float32),
    "ctest": lambda: ctest_fixture(np.float32),
    "empty": lambda: CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64),
                               np.zeros(0, np.float32), 300, 300),
}
# the SDIA and WHDIA fixtures (tests/test_torch_sdia.py, test_torch_whdia.py)
DIA_CASES = {
    "laplace": CASES["laplace"],
    "laplace_wide": CASES["laplace_wide"],
    "laplace3d": lambda: laplacian_3d(12, 11, 9, np.float32),
    "banded": CASES["banded"],
    "banded_wide": lambda: random_banded(2000, bands=31, seed=5, dtype=np.float32),
    "banded_neg": lambda: random_banded(700, bands=5, wander=3, seed=6,
                                        dtype=np.float32),
    "tall": lambda: random_irregular(700, 90, 4.0, seed=3, dtype=np.float32),
    "wide": lambda: random_irregular(90, 700, 12.0, seed=4, dtype=np.float32),
    "empty": CASES["empty"],
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _plain(a, xl, per_hack=True):
    """The plain product of ``a``'s kernel: the per-hack form
    (``per_hack=False``: every tile added into its hack row, the JAX
    kernels' tile pass, a second witness)."""
    units = a.hack_units if per_hack and a.values.dtype in kw.PER_HACK else None
    return kw.whell_packed_spmv_plain(
        a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
        a.group_bases, a.seg_lo, a.seg_hi, ops._prep_x(xl, a.n_cols, a.x_pages),
        chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
        window_pages=a.window_pages, unit_segments=a.unit_segments,
        hack_units=units, tile_page=a.tile_page).reshape(-1)[: a.n_rows]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scattered", [True, False], ids=["scattered", "aligned"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_and_golden(name, scattered, dtype, cuda_device):
    coo = CASES[name]()
    a = coo_to_whell(coo, device=cuda_device, scattered=scattered, dtype=dtype)
    x = np.random.default_rng(0).standard_normal(coo.n_cols).astype(np.float32)
    xl = a.embed(torch.from_numpy(x), dtype=torch.float32)
    before = kw.LAUNCHES
    z = ops.whell_spmv(a, xl)
    torch.cuda.synchronize()
    assert kw.LAUNCHES == before + 1
    zp = _plain(a, xl)
    atol = 1e-5 * max(float(zp.abs().max()), 1.0)
    torch.testing.assert_close(z, zp, rtol=1e-5, atol=atol)
    vals = torch.from_numpy(coo.values).to(a.values.dtype).double().numpy()
    golden = CooMatrix(coo.rows, coo.cols, vals, coo.n_rows, coo.n_cols).spmv(
        x.astype(np.float64))
    np.testing.assert_allclose(a.extract(z, dtype=torch.float64).cpu().numpy(),
                               golden, rtol=2e-5, atol=2e-5 * max(np.abs(golden).max(), 1))


@pytest.mark.cuda
def test_alpha_beta_y_on_cuda(cuda_device):
    coo = CASES["fem"]()
    a = coo_to_whell(coo, device=cuda_device)
    rng = np.random.default_rng(1)
    xl = a.embed(torch.from_numpy(rng.standard_normal(coo.n_cols)), torch.float32)
    yl = a.embed(torch.from_numpy(rng.standard_normal(coo.n_rows)), torch.float32)
    z = ops.whell_spmv(a, xl, alpha=2.5, beta=-0.5, y=yl)
    want = 2.5 * _plain(a, xl) - 0.5 * yl
    torch.testing.assert_close(z, want, rtol=1e-5, atol=1e-4)


def _golden(coo, x):
    return coo.spmv(x.astype(np.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DIA_CASES))
def test_sdia_kernel_matches_plain_and_golden(name, cuda_device):
    coo = DIA_CASES[name]()
    a = coo_to_sdia(coo, device=cuda_device)
    x = np.random.default_rng(0).standard_normal(coo.n_cols).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda_device)
    before = ks.LAUNCHES
    z = ops.sdia_spmv(a, xt)
    torch.cuda.synchronize()
    assert ks.LAUNCHES == before + (1 if a.n_diags else 0)
    if a.n_diags:
        zp = ks.sdia_spmv_plain(a.values, a.offsets, xt, n_rows=a.n_rows)
        atol = 1e-6 * max(float(zp.abs().max()), 1.0)
        torch.testing.assert_close(z, zp, rtol=1e-6, atol=atol)
    g = _golden(coo, x)
    np.testing.assert_allclose(z.double().cpu().numpy(), g, rtol=2e-5,
                               atol=2e-5 * max(np.abs(g).max(initial=0), 1))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DIA_CASES))
def test_whdia_kernel_matches_plain_and_golden(name, cuda_device):
    coo = DIA_CASES[name]()
    a = coo_to_whdia(coo, device=cuda_device)
    x = np.random.default_rng(0).standard_normal(coo.n_cols).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda_device)
    before = kd.LAUNCHES
    z = ops.whdia_spmv(a, xt)
    torch.cuda.synchronize()
    assert kd.LAUNCHES == before + 1
    zp = kd.whdia_spmv_plain(
        a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group, xt,
        chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
        num_groups=a.num_groups, tile_page=a.tile_page)[: a.n_rows]
    atol = 1e-5 * max(float(zp.abs().max()), 1.0)
    torch.testing.assert_close(z, zp, rtol=1e-5, atol=atol)
    zl = kd.whdia_spmm_listed_plain(
        a.values, a.slot_r0, a.tile_r0, a.tile_base, a.hack_slot_ptr, a.hack_slots,
        xt[None], group_hacks=a.group_hacks, num_groups=a.num_groups,
        tile_page=a.tile_page)[0, : a.n_rows]
    torch.testing.assert_close(z, zl, rtol=1e-5, atol=atol)
    g = _golden(coo, x)
    np.testing.assert_allclose(z.double().cpu().numpy(), g, rtol=2e-5,
                               atol=2e-5 * max(np.abs(g).max(initial=0), 1))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["sdia", "whdia"])
def test_dia_class_alpha_beta_y_on_cuda(fmt, cuda_device):
    coo = DIA_CASES["laplace_wide"]()
    conv, op = {"sdia": (coo_to_sdia, ops.sdia_spmv),
                "whdia": (coo_to_whdia, ops.whdia_spmv)}[fmt]
    a = conv(coo, device=cuda_device)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(coo.n_cols).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(coo.n_rows).astype(np.float32))
    x, y = x.to(cuda_device), y.to(cuda_device)
    z = op(a, x, alpha=2.5, beta=-0.5, y=y)
    want = 2.5 * op(a.to("cpu"), x.cpu()) - 0.5 * y.cpu()
    torch.testing.assert_close(z.cpu(), want, rtol=1e-5, atol=1e-4)
    nan_y = torch.full_like(y, float("nan"))
    assert bool(torch.isfinite(op(a, x, beta=0.0, y=nan_y)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,symmetric", [("sdia", True), ("whdia", True),
                                           ("whdia", False)])
def test_dia_class_solve_on_cuda(fmt, symmetric, cuda_device):
    if symmetric:
        coo = CASES["laplace_wide"]()
    else:  # a contiguous band: WHDIA pattern mode
        coo = random_banded(3000, bands=11, seed=2, dtype=np.float32)
    b = np.random.default_rng(11).standard_normal(coo.n_rows).astype(np.float32)
    counter = {"sdia": ks, "whdia": kd}[fmt]
    counter.LAUNCHES = 0
    res = solve(coo, b, device=cuda_device, fmt=fmt, symmetric=symmetric,
                tol=1e-5, maxiter=3000)
    assert bool(res.converged)
    assert counter.LAUNCHES >= res.iterations > 0
    x = res.x.double().cpu().numpy()
    r = b - coo.sum_duplicates().spmv(x)
    assert np.linalg.norm(r) <= 1e-4 * np.linalg.norm(b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["laplace_wide", "fem_spd"])
def test_solve_on_cuda(name, cuda_device):
    if name == "fem_spd":
        d = random_fem_like(1500, 10.0, span=120, far_frac=0.0, seed=12,
                            dtype=np.float32).to_dense().astype(np.float64)
        d = (d + d.T) / 2 + np.eye(1500) * (np.abs(d).sum(1).max() + 1)
        r, c = np.nonzero(d)
        coo = CooMatrix(r, c, d[r, c].astype(np.float32), 1500, 1500)
    else:
        coo = CASES[name]()
    b = np.random.default_rng(11).standard_normal(coo.n_rows).astype(np.float32)
    kw.LAUNCHES = 0
    res = solve(coo, b, device=cuda_device, fmt="whell", tol=1e-5, maxiter=3000)
    assert bool(res.converged)
    assert kw.LAUNCHES >= res.iterations
    x = res.x.double().cpu().numpy()
    r = b - coo.sum_duplicates().spmv(x)
    assert np.linalg.norm(r) <= 1e-4 * np.linalg.norm(b)


@pytest.mark.cuda
@pytest.mark.parametrize("attempts,source", [(3, "profiler"), (0, "cuda_events")])
def test_device_ms_sources(attempts, source, cuda_device):
    from spgpu_tpu_torch.utils.timing import device_ms

    a = coo_to_sdia(DIA_CASES["laplace_wide"](), device=cuda_device)
    x = torch.ones(a.n_cols, device=cuda_device)
    ms, got = device_ms(lambda: ops.sdia_spmv(a, x), iters=5, warmup=1,
                        attempts=attempts)
    # the profiler may record nothing now and then; the events never fail
    assert got in ({"profiler", "cuda_events"} if attempts else {source})
    assert 0 < ms < 1e3


def _f64(coo):
    return CooMatrix(coo.rows, coo.cols, coo.values.astype(np.float64),
                     coo.n_rows, coo.n_cols)


def _near(got, want, frac, rtol=0.0):
    """|got - want| ≤ frac·max|want| + rtol·|want|, in float64 or
    complex128."""
    wide = torch.complex128 if got.is_complex() or want.is_complex() else torch.float64
    got, want = got.cpu().to(wide), want.cpu().to(wide)
    atol = frac * max(float(want.abs().max()) if want.numel() else 0.0, 1e-300)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("scattered", [False, True], ids=["aligned", "scattered"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_f64_whell_kernel_matches_plain_and_golden(name, scattered, cuda_device):
    coo = _f64(CASES[name]())
    a = coo_to_whell(coo, device=cuda_device, scattered=scattered)
    x = np.random.default_rng(0).standard_normal(coo.n_cols)
    xl = a.embed(torch.from_numpy(x), dtype=torch.float64)
    before = kw.LAUNCHES_F64
    z = ops.whell_spmv(a, xl)
    torch.cuda.synchronize()
    assert kw.LAUNCHES_F64 == before + 1 and z.dtype == torch.float64
    _near(z, _plain(a, xl), 1e-12)
    _near(z, _plain(a, xl, per_hack=False), 1e-12)
    _near(a.extract(z, dtype=torch.float64), torch.from_numpy(coo.spmv(x)), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DIA_CASES))
def test_f64_sdia_kernel_matches_plain_exactly(name, cuda_device):
    coo = _f64(DIA_CASES[name]())
    a = coo_to_sdia(coo, device=cuda_device)
    xt = torch.from_numpy(np.random.default_rng(0).standard_normal(coo.n_cols)).to(cuda_device)
    before = ks.LAUNCHES_F64
    z = ops.sdia_spmv(a, xt)
    torch.cuda.synchronize()
    assert ks.LAUNCHES_F64 == before + (1 if a.n_diags else 0)
    if a.n_diags:
        zp = ks.sdia_spmv_plain(a.values, a.offsets, xt, n_rows=a.n_rows)
        torch.testing.assert_close(z, zp, rtol=0, atol=0)
    _near(z, torch.from_numpy(_golden(coo, xt.cpu().numpy())), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DIA_CASES))
def test_f64_whdia_kernel_matches_plain_and_golden(name, cuda_device):
    coo = _f64(DIA_CASES[name]())
    a = coo_to_whdia(coo, device=cuda_device)
    xt = torch.from_numpy(np.random.default_rng(0).standard_normal(coo.n_cols)).to(cuda_device)
    before = kd.LAUNCHES_F64
    z = ops.whdia_spmv(a, xt)
    torch.cuda.synchronize()
    assert kd.LAUNCHES_F64 == before + 1 and z.dtype == torch.float64
    zp = kd.whdia_spmv_plain(
        a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group, xt,
        chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
        num_groups=a.num_groups, tile_page=a.tile_page)[: a.n_rows]
    _near(z, zp, 1e-12)
    _near(z, _hack_listed(a, xt[None])[0, : a.n_rows], 1e-12)
    _near(z, torch.from_numpy(_golden(coo, xt.cpu().numpy())), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["whell", "sdia", "whdia"])
def test_f64_alpha_beta_y_on_cuda(fmt, cuda_device):
    coo = _f64(CASES["laplace_wide"]())
    conv, op = {"whell": (coo_to_whell, ops.whell_spmv),
                "sdia": (coo_to_sdia, ops.sdia_spmv),
                "whdia": (coo_to_whdia, ops.whdia_spmv)}[fmt]
    a = conv(coo, device=cuda_device)
    n = a.n_rows if fmt == "whell" else coo.n_rows
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(n)).to(cuda_device)
    y = torch.from_numpy(rng.standard_normal(n)).to(cuda_device)
    z = op(a, x, alpha=2.5, beta=-0.5, y=y)
    assert z.dtype == torch.float64
    _near(z, 2.5 * op(a.to("cpu"), x.cpu()) - 0.5 * y.cpu(), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("symmetric", [True, False], ids=["cg", "bicgstab"])
@pytest.mark.parametrize("fmt", ["whell", "sdia", "whdia"])
def test_f64_solve_on_cuda(fmt, symmetric, cuda_device):
    """float64 systems through solve() on each route, CG on the Laplacian
    and BiCGSTAB on a contiguous band, to 1e-10, counted."""
    if symmetric:
        coo = _f64(CASES["laplace_wide"]())
    else:
        coo = random_banded(3000, bands=11, seed=2, dtype=np.float64)
    b = np.random.default_rng(11).standard_normal(coo.n_rows)
    counter = {"whell": kw, "sdia": ks, "whdia": kd}[fmt]
    counter.LAUNCHES_F64 = 0
    res = solve(coo, b, device=cuda_device, fmt=fmt, symmetric=symmetric,
                tol=1e-10, maxiter=5000)
    assert bool(res.converged) and res.x.dtype == torch.float64
    assert counter.LAUNCHES_F64 >= res.iterations > 0
    x = res.x.cpu().numpy()
    r = b - coo.sum_duplicates().spmv(x)
    assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(b)


def _complex(coo, dtype, seed=8):
    """``coo`` with values ``v + 1j·N(0, 1)`` (numpy ``default_rng(seed)``)
    as ``dtype``."""
    rng = np.random.default_rng(seed)
    v = coo.values.astype(np.float64) + 1j * rng.standard_normal(coo.nnz)
    return CooMatrix(coo.rows, coo.cols, v.astype(dtype), coo.n_rows, coo.n_cols)


def _cvec(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


#: complex dtype -> (torch dtype, launch counter, atol/max|z| vs plain and
#: vs the complex128 golden)
CPLX = {"complex64": (torch.complex64, "LAUNCHES_C64", 1e-5, 2e-5),
        "complex128": (torch.complex128, "LAUNCHES_C128", 1e-12, 1e-12)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(CPLX))
@pytest.mark.parametrize("scattered", [True, False], ids=["scattered", "aligned"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_complex_whell_kernel_matches_plain_and_golden(name, scattered, dtype,
                                                       cuda_device):
    tdt, counter, tol, gtol = CPLX[dtype]
    coo = _complex(CASES[name](), dtype)
    a = coo_to_whell(coo, device=cuda_device, scattered=scattered)
    assert a.values.dtype == tdt
    x = _cvec(coo.n_cols)
    xl = a.embed(torch.from_numpy(x), dtype=tdt)
    before = getattr(kw, counter)
    z = ops.whell_spmv(a, xl)
    torch.cuda.synchronize()
    assert getattr(kw, counter) == before + 1 and z.dtype == tdt
    _near(z, _plain(a, xl), tol, rtol=tol)
    xs = xl.cpu().numpy()[a.lane_of_row.cpu().numpy()]  # x as the kernel saw it
    _near(a.extract(z, dtype=torch.complex128),
           torch.from_numpy(coo.spmv(xs.astype(np.complex128))), gtol, rtol=gtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(CPLX))
@pytest.mark.parametrize("name", sorted(DIA_CASES))
def test_complex_sdia_kernel_matches_plain_exactly(name, dtype, cuda_device):
    tdt, counter, _, gtol = CPLX[dtype]
    coo = _complex(DIA_CASES[name](), dtype)
    a = coo_to_sdia(coo, device=cuda_device)
    xt = torch.from_numpy(_cvec(coo.n_cols)).to(cuda_device, tdt)
    before = getattr(ks, counter)
    z = ops.sdia_spmv(a, xt)
    torch.cuda.synchronize()
    assert getattr(ks, counter) == before + (1 if a.n_diags else 0)
    if a.n_diags:
        zp = ks.sdia_spmv_plain(a.values, a.offsets, xt, n_rows=a.n_rows)
        torch.testing.assert_close(z, zp, rtol=0, atol=0)
    golden = coo.spmv(xt.cpu().numpy().astype(np.complex128))
    _near(z, torch.from_numpy(golden), gtol, rtol=gtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(CPLX))
@pytest.mark.parametrize("name", sorted(DIA_CASES))
def test_complex_whdia_kernel_matches_plain_and_golden(name, dtype, cuda_device):
    tdt, counter, tol, gtol = CPLX[dtype]
    coo = _complex(DIA_CASES[name](), dtype)
    a = coo_to_whdia(coo, device=cuda_device)
    xt = torch.from_numpy(_cvec(coo.n_cols)).to(cuda_device, tdt)
    before = getattr(kd, counter)
    z = ops.whdia_spmv(a, xt)
    torch.cuda.synchronize()
    assert getattr(kd, counter) == before + 1 and z.dtype == tdt
    zp = kd.whdia_spmv_plain(
        a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group, xt,
        chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
        num_groups=a.num_groups, tile_page=a.tile_page)[: a.n_rows]
    _near(z, zp, tol, rtol=tol)
    _near(z, _hack_listed(a, xt[None])[0, : a.n_rows], tol, rtol=tol)
    golden = coo.spmv(xt.cpu().numpy().astype(np.complex128))
    _near(z, torch.from_numpy(golden), gtol, rtol=gtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(CPLX))
def test_complex_whdia_both_r0_modes(dtype, cuda_device):
    """The complex WHDIA kernel in pattern mode (a contiguous band) and in
    slab mode (the Laplacian), against its plain version."""
    tdt, counter, tol, _ = CPLX[dtype]
    for coo, pattern in ((random_banded(3000, bands=11, seed=2), True),
                         (laplacian_2d(200, 30), False)):
        a = coo_to_whdia(_complex(coo, dtype), device=cuda_device)
        assert a.pattern_mode == pattern
        xt = torch.from_numpy(_cvec(coo.n_cols)).to(cuda_device, tdt)
        zp = kd.whdia_spmv_plain(
            a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group, xt,
            chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
            num_groups=a.num_groups, tile_page=a.tile_page)[: a.n_rows]
        _near(ops.whdia_spmv(a, xt), zp, tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(CPLX))
@pytest.mark.parametrize("fmt", ["whell", "sdia", "whdia"])
def test_complex_alpha_beta_y_on_cuda(fmt, dtype, cuda_device):
    tdt, _, tol, _ = CPLX[dtype]
    coo = _complex(CASES["laplace_wide"](), dtype)
    conv, op = {"whell": (coo_to_whell, ops.whell_spmv),
                "sdia": (coo_to_sdia, ops.sdia_spmv),
                "whdia": (coo_to_whdia, ops.whdia_spmv)}[fmt]
    a = conv(coo, device=cuda_device)
    n = a.n_rows if fmt == "whell" else coo.n_rows
    x = torch.from_numpy(_cvec(n, 1)).to(cuda_device, tdt)
    y = torch.from_numpy(_cvec(n, 2)).to(cuda_device, tdt)
    alpha, beta = 2.5 - 1j, 0.5j
    z = op(a, x, alpha=alpha, beta=beta, y=y)
    assert z.dtype == tdt
    _near(z, alpha * op(a.to("cpu"), x.cpu()) + beta * y.cpu(), 10 * tol)


def _hermitian(coo):
    """(A + Aᴴ)/2, duplicates summed, each diagonal entry the row's
    off-diagonal modulus sum + 1: Hermitian positive-definite."""
    n = coo.n_rows
    v = coo.values.astype(np.complex128) / 2
    h = CooMatrix(np.r_[coo.rows, coo.cols], np.r_[coo.cols, coo.rows],
                  np.r_[v, np.conj(v)], n, n).sum_duplicates()
    off = h.rows != h.cols
    d = np.bincount(h.rows[off], weights=np.abs(h.values[off]), minlength=n) + 1.0
    i = np.arange(n)
    return CooMatrix(np.r_[h.rows[off], i], np.r_[h.cols[off], i],
                     np.r_[h.values[off], d].astype(coo.values.dtype), n, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(CPLX))
@pytest.mark.parametrize("symmetric", [True, False], ids=["cg", "bicgstab"])
@pytest.mark.parametrize("fmt", ["whell", "sdia", "whdia"])
def test_complex_solve_on_cuda(fmt, symmetric, dtype, cuda_device):
    """Complex systems through solve() on each route, counted: CG on a
    Hermitian positive-definite Laplacian, BiCGSTAB on a contiguous band."""
    tdt, counter, _, _ = CPLX[dtype]
    if symmetric:
        coo = _hermitian(_complex(CASES["laplace_wide"](), dtype))
    else:
        coo = _complex(random_banded(3000, bands=11, seed=2), dtype)
    b = _cvec(coo.n_rows, 11)
    mod = {"whell": kw, "sdia": ks, "whdia": kd}[fmt]
    setattr(mod, counter, 0)
    tol, true_tol = (1e-5, 1e-4) if dtype == "complex64" else (1e-10, 1e-9)
    res = solve(coo, b, device=cuda_device, fmt=fmt, symmetric=symmetric,
                tol=tol, maxiter=5000)
    assert bool(res.converged) and res.x.dtype == tdt
    assert getattr(mod, counter) >= res.iterations > 0
    x = res.x.cpu().numpy().astype(np.complex128)
    r = b - coo.sum_duplicates().spmv(x)
    assert np.linalg.norm(r) <= true_tol * np.linalg.norm(b)


# --------------------------------------------------------------------------
# multi-RHS SpMM: kernels #12 (WHELL), #13 (WHDIA) and #14 (SDIA)


def _xs(n_rhs, n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n_rhs, n))
                            .astype(np.float32))


def _whell_spmm_plain(a, xs, per_hack=True):
    """#12's plain product: the per-hack form, the kernel's (``per_hack=False``:
    every tile added into its hack row, the tile pass's form, a second
    witness)."""
    return kw.whell_packed_spmm_plain(
        a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
        a.group_bases, a.seg_lo, a.seg_hi,
        ops._prep_x(xs, a.n_cols, a.x_pages, stack=True),
        chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
        window_pages=a.window_pages, unit_segments=a.unit_segments,
        hack_units=a.hack_units if per_hack else None,
        tile_page=a.tile_page).flatten(1)[:, : a.n_rows]


def _whdia_spmm_plain(a, xs):
    return kd.whdia_spmm_plain(
        a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group, xs,
        chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
        num_groups=a.num_groups, tile_page=a.tile_page)[:, : a.n_rows]


def _fused_spmm(fmt, a, xs):
    """The fused op on the card, its launch counted once on LAUNCHES_SPMM
    and on no SpMV counter; then the plain version on the same inputs."""
    mod = {"whell": kw, "whdia": kd, "sdia": ks}[fmt]
    before = (mod.LAUNCHES_SPMM, mod.LAUNCHES)
    z = {"whell": ops.whell_spmm, "whdia": ops.whdia_spmm,
         "sdia": ops.sdia_spmm}[fmt](a, xs, fused=True)
    torch.cuda.synchronize()
    launched = 0 if fmt == "sdia" and a.n_diags == 0 else 1
    assert (mod.LAUNCHES_SPMM, mod.LAUNCHES) == (before[0] + launched, before[1])
    if fmt == "whell":
        zp = _whell_spmm_plain(a, xs)
    elif fmt == "whdia":
        zp = _whdia_spmm_plain(a, xs)
    else:
        zp = ks.sdia_spmm_plain(a.values, a.offsets, xs, n_rows=a.n_rows)
    assert z.shape == zp.shape == (xs.shape[0], a.n_rows)
    return z, zp


def _spmm_golden(coo, xs):
    return torch.from_numpy(coo.spmv(xs.cpu().double().numpy()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scattered", [True, False], ids=["scattered", "aligned"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_whell_spmm_kernel_matches_plain_and_golden(name, scattered, dtype,
                                                    cuda_device):
    """Kernel #12 at 5 RHS (a remainder block) against its plain version;
    the kernel adds with FMAs, the plain version rounds each product,
    hence 1e-5 and 1e-5·max|Z|."""
    coo = CASES[name]()
    a = coo_to_whell(coo, device=cuda_device, scattered=scattered, dtype=dtype)
    x = _xs(5, coo.n_cols)
    xl = a.embed(x, dtype=torch.float32)
    z, zp = _fused_spmm("whell", a, xl)
    _near(z, zp, 1e-5, rtol=1e-5)
    vals = torch.from_numpy(coo.values).to(a.values.dtype).double().numpy()
    golden = CooMatrix(coo.rows, coo.cols, vals, coo.n_rows, coo.n_cols).spmv(
        x.double().numpy())
    _near(a.extract(z, dtype=torch.float64), torch.from_numpy(golden), 2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DIA_CASES))
def test_whdia_spmm_kernel_matches_plain_and_golden(name, cuda_device):
    coo = DIA_CASES[name]()
    a = coo_to_whdia(coo, device=cuda_device)
    xs = _xs(5, coo.n_cols).to(cuda_device)
    z, zp = _fused_spmm("whdia", a, xs)
    _near(z, zp, 1e-5, rtol=1e-5)
    _near(z, _spmm_golden(coo, xs), 2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DIA_CASES))
def test_sdia_spmm_kernel_is_exact(name, cuda_device):
    """Kernel #14 equals its plain version and one launch of kernel #2 per
    RHS bit for bit."""
    coo = DIA_CASES[name]()
    a = coo_to_sdia(coo, device=cuda_device)
    xs = _xs(5, coo.n_cols).to(cuda_device)
    z, zp = _fused_spmm("sdia", a, xs)
    torch.testing.assert_close(z, zp, rtol=0, atol=0)
    loop = torch.stack([ops.sdia_spmv(a, xs[r]) for r in range(5)])
    torch.testing.assert_close(z, loop, rtol=0, atol=0)
    _near(z, _spmm_golden(coo, xs), 2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rhs", [1, 3, 5, 8, 11, 17])
@pytest.mark.parametrize("fmt", ["whell", "whdia", "whdia_slab", "sdia"])
def test_spmm_kernels_take_any_rhs_count(fmt, n_rhs, cuda_device):
    """1 to 17 RHS (a full block, two and a remainder; #12's float4 pairs
    at 8, its scalar loads at counts not a multiple of 4) on kernels
    #12-#14, both WHDIA r0 modes; #14 against 8 launches of #2 too."""
    if fmt == "whell":
        coo = CASES["fem_large"]()
        a = coo_to_whell(coo, device=cuda_device)
    elif fmt == "sdia":
        coo = CASES["laplace_wide"]()
        a = coo_to_sdia(coo, device=cuda_device)
    else:  # a contiguous band (pattern mode) and the Laplacian (slab)
        coo = (random_banded(3000, bands=11, seed=2, dtype=np.float32)
               if fmt == "whdia" else laplacian_2d(200, 30, np.float32))
        a = coo_to_whdia(coo, device=cuda_device)
        assert a.pattern_mode == (fmt == "whdia")
    x = _xs(n_rhs, coo.n_cols, seed=n_rhs)
    xs = a.embed(x, dtype=torch.float32) if fmt == "whell" else x.to(cuda_device)
    z, zp = _fused_spmm(fmt.split("_")[0], a, xs)
    if fmt == "sdia":
        torch.testing.assert_close(z, zp, rtol=0, atol=0)
        torch.testing.assert_close(
            z, torch.stack([ops.sdia_spmv(a, xs[r]) for r in range(n_rhs)]),
            rtol=0, atol=0)
    else:
        _near(z, zp, 1e-5, rtol=1e-5)
    zo = a.extract(z, dtype=torch.float64) if fmt == "whell" else z
    _near(zo, _spmm_golden(coo, x), 2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["whell", "whell_loop", "whell_f64",
                                  "whell_c64", "whdia", "sdia"])
def test_spmm_loop_path_counts(case, cuda_device):
    """The loop path launches one SpMV kernel per RHS and no SpMM kernel:
    the DIA defaults, ``whell_spmm(fused=False)`` and the float64 and
    complex64 ``whell_spmm`` defaults."""
    coo = CASES["laplace_wide"]()
    fmt = case.split("_")[0]
    if case in ("whell_f64", "whell_c64"):
        vt = np.float64 if case == "whell_f64" else np.complex64
        coo = CooMatrix(coo.rows, coo.cols, coo.values.astype(vt), coo.n_rows,
                        coo.n_cols)
    a = {"whell": coo_to_whell, "whdia": coo_to_whdia,
         "sdia": coo_to_sdia}[fmt](coo, device=cuda_device)
    mod = {"whell": kw, "whdia": kd, "sdia": ks}[fmt]
    counter = {"whell_f64": "LAUNCHES_F64",
               "whell_c64": "LAUNCHES_C64"}.get(case, "LAUNCHES")
    xs = _xs(8, a.n_cols).to(cuda_device, a.values.dtype)
    before = (getattr(mod, counter), mod.LAUNCHES_SPMM)
    z = {"whell": ops.whell_spmm, "whdia": ops.whdia_spmm,
         "sdia": ops.sdia_spmm}[fmt](a, xs, fused=False if case == "whell_loop" else None)
    torch.cuda.synchronize()
    if case == "whell":  # the fp32 default is fused
        assert (getattr(mod, counter), mod.LAUNCHES_SPMM) == (before[0], before[1] + 1)
    else:
        assert (getattr(mod, counter), mod.LAUNCHES_SPMM) == (before[0] + 8, before[1])
    loop = torch.stack([{"whell": ops.whell_spmv, "whdia": ops.whdia_spmv,
                         "sdia": ops.sdia_spmv}[fmt](a, xs[r]) for r in range(8)])
    tol = 1e-12 if case == "whell_f64" else 1e-5
    _near(z, loop, tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["whell", "whdia", "sdia"])
def test_spmm_alpha_beta_y_on_cuda(fmt, cuda_device):
    coo = CASES["laplace_wide"]()
    conv, op = {"whell": (coo_to_whell, ops.whell_spmm),
                "sdia": (coo_to_sdia, ops.sdia_spmm),
                "whdia": (coo_to_whdia, ops.whdia_spmm)}[fmt]
    a = conv(coo, device=cuda_device)
    xs, ys = _xs(8, a.n_cols, 1).to(cuda_device), _xs(8, a.n_rows, 2).to(cuda_device)
    z = op(a, xs, alpha=2.5, beta=-0.5, y=ys, fused=True)
    want = 2.5 * op(a.to("cpu"), xs.cpu(), fused=True) - 0.5 * ys.cpu()
    _near(z, want, 1e-5, rtol=1e-5)
    nan_y = torch.full_like(ys, float("nan"))
    assert bool(torch.isfinite(op(a, xs, beta=0.0, y=nan_y, fused=True)).all())


# --------------------------------------------------------------------------
# classic WHELL (kernels #15 and #16) and per-cell routing (kernel #17)

CLASSIC_CASES = dict(CASES, rect=lambda: random_irregular(700, 1200, 6.0, seed=8,
                                                          dtype=np.float32))


def _bf16_golden(coo, a, x):
    """The float64 golden on the slab's (possibly bf16-rounded) values."""
    vals = torch.from_numpy(coo.values).to(a.values.dtype).double().numpy()
    return CooMatrix(coo.rows, coo.cols, vals, coo.n_rows, coo.n_cols).spmv(x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CLASSIC_CASES))
def test_classic_kernel_matches_plain_and_golden(name, dtype, cuda_device):
    """Kernel #15 through ``whell_spmv`` on a classic layout, one launch,
    against its plain version (atomics: 1e-5, 1e-5·max|z|) and the golden
    (2e-5)."""
    coo = CLASSIC_CASES[name]()
    a = coo_to_whell(coo, device=cuda_device, packed=False, dtype=dtype)
    x = _xs(1, coo.n_cols)[0]
    before = kc.LAUNCHES
    z = ops.whell_spmv(a, x.to(cuda_device))
    torch.cuda.synchronize()
    assert kc.LAUNCHES == before + 1 and z.shape == (coo.n_rows,)
    _near(z, ops.whell_spmv(a.to("cpu"), x), 1e-5, rtol=1e-5)
    _near(z, torch.from_numpy(_bf16_golden(coo, a, x.double().numpy())), 2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(sort_rows=True), dict(ways=2), dict(ways=4)],
                         ids=["oell", "ways2", "ways4"])
def test_classic_oell_ways_alpha_beta_on_cuda(kw, cuda_device):
    coo = CASES["fem"]()
    a = coo_to_whell(coo, device=cuda_device, packed=False, **kw)
    x, y = _xs(1, coo.n_cols, 1)[0], _xs(1, coo.n_rows, 2)[0]
    z = ops.whell_spmv(a, x.to(cuda_device), alpha=2.5, beta=-0.5, y=y.to(cuda_device))
    want = 2.5 * coo.spmv(x.double().numpy()) - 0.5 * y.double().numpy()
    _near(z, torch.from_numpy(want), 2e-5, rtol=2e-5)
    _near(z, ops.whell_spmv(a.to("cpu"), x, alpha=2.5, beta=-0.5, y=y), 1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rhs", [1, 3, 5, 8, 11, 17])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_classic_spmm_kernel_takes_any_rhs_count(dtype, n_rhs, cuda_device):
    """Kernel #16 (``fused=True``, over the work list): one launch, no
    launch of #15, against its plain version (1e-5·max|Z|) and the golden,
    on a way-split layout too; 3, 11 and 17 RHS take the scalar loads (a
    count that is not a multiple of 4), 8 and 17 the float4 pairs of a
    full block."""
    coo = CASES["fem_large"]()
    for kw in ({}, dict(ways=2)):
        a = coo_to_whell(coo, device=cuda_device, packed=False, dtype=dtype, **kw)
        x = _xs(n_rhs, coo.n_cols, seed=n_rhs)
        before = (kc.LAUNCHES_SPMM, kc.LAUNCHES)
        z = ops.whell_spmm(a, x.to(cuda_device), fused=True)
        torch.cuda.synchronize()
        assert (kc.LAUNCHES_SPMM, kc.LAUNCHES) == (before[0] + 1, before[1])
        assert z.shape == (n_rhs, coo.n_rows)
        _near(z, ops.whell_spmm(a.to("cpu"), x, fused=True), 1e-5, rtol=1e-5)
        _near(z, torch.from_numpy(_bf16_golden(coo, a, x.double().numpy())), 2e-5,
              rtol=2e-5)


@pytest.mark.cuda
def test_classic_spmm_default_loops_kernel_15(cuda_device):
    a = coo_to_whell(CASES["laplace_wide"](), device=cuda_device, packed=False)
    xs = _xs(8, a.n_cols).to(cuda_device)
    before = (kc.LAUNCHES, kc.LAUNCHES_SPMM)
    z = ops.whell_spmm(a, xs)
    torch.cuda.synchronize()
    assert (kc.LAUNCHES, kc.LAUNCHES_SPMM) == (before[0] + 8, before[1])
    _near(z, ops.whell_spmm(a, xs, fused=True), 1e-5, rtol=1e-5)


def _cut_columns(coo):
    """``coo`` without its entries in columns ≡ 0 (mod 128): on the fem
    fixture those columns are then read by padding cells alone."""
    keep = coo.cols % 128 != 0
    return CooMatrix(coo.rows[keep], coo.cols[keep], coo.values[keep], coo.n_rows,
                     coo.n_cols)


def _zeros_and_dead_tiles():
    """fem with every fifth entry stored as an explicit 0 and rows
    1,024-2,815 empty, so whole tiles hold no nonzero."""
    coo = CASES["fem"]()
    v = coo.values.copy()
    v[::5] = 0
    keep = (coo.rows < 1024) | (coo.rows >= 2816)
    return CooMatrix(coo.rows[keep], coo.cols[keep], v[keep], coo.n_rows, coo.n_cols)


WORK_CASES = {"zeros_dead_tiles": _zeros_and_dead_tiles,
              "cut_columns": lambda: _cut_columns(CASES["fem"]())}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [{}, dict(sort_rows=True), dict(ways=2)],
                         ids=["plain", "oell", "ways2"])
@pytest.mark.parametrize("name", sorted(WORK_CASES))
def test_classic_kernel_on_work_list_edges(name, kw, dtype, cuda_device):
    """Kernel #15 over the work list of layouts with explicit zeros,
    all-dead tiles and dead units: one launch, against the full-layout
    plain version (1e-5, 1e-5·max|z|) and the golden (2e-5)."""
    coo = WORK_CASES[name]()
    a = coo_to_whell(coo, device=cuda_device, packed=False, dtype=dtype, **kw)
    live_tiles = torch.unique(a.work_list >> 10).numel()
    assert live_tiles < a.num_tiles and a.work_list.device == a.device
    x = _xs(1, coo.n_cols, 5)[0]
    before = kc.LAUNCHES
    z = ops.whell_spmv(a, x.to(cuda_device))
    torch.cuda.synchronize()
    assert kc.LAUNCHES == before + 1
    _near(z, ops.whell_spmv(a.to("cpu"), x), 1e-5, rtol=1e-5)
    _near(z, torch.from_numpy(_bf16_golden(coo, a, x.double().numpy())), 2e-5, rtol=2e-5)


def _one_unit():
    """A single nonzero: the work list holds one unit."""
    return CooMatrix(np.array([300]), np.array([777]), np.array([1.5], np.float32),
                     1000, 1000)


SPMM_WORK_CASES = dict(WORK_CASES, empty=CASES["empty"], one_unit=_one_unit)


def _classic_spmm_checked(coo, a, x, cuda_device):
    """Kernel #16 through ``whell_spmm(fused=True)``: one launch of #16 and
    none of #15; against the full-layout plain version (atomics: 1e-5,
    1e-5·max|Z|) and the golden of the slab's values (2e-5)."""
    before = (kc.LAUNCHES_SPMM, kc.LAUNCHES)
    z = ops.whell_spmm(a, x.to(cuda_device), fused=True)
    torch.cuda.synchronize()
    assert (kc.LAUNCHES_SPMM, kc.LAUNCHES) == (before[0] + 1, before[1])
    assert z.shape == (x.shape[0], coo.n_rows)
    _near(z, ops.whell_spmm(a.to("cpu"), x, fused=True), 1e-5, rtol=1e-5)
    _near(z, torch.from_numpy(_bf16_golden(coo, a, x.double().numpy())), 2e-5,
          rtol=2e-5)
    return z


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [{}, dict(sort_rows=True), dict(ways=2)],
                         ids=["plain", "oell", "ways2"])
@pytest.mark.parametrize("name", sorted(SPMM_WORK_CASES))
def test_classic_spmm_on_work_list_edges(name, kw, dtype, cuda_device):
    """Kernel #16 over the work lists of #15's edge layouts (explicit
    zeros, all-dead tiles and units, columns read by padding alone), the
    empty list and a list of one unit, at 11 RHS."""
    coo = SPMM_WORK_CASES[name]()
    a = coo_to_whell(coo, device=cuda_device, packed=False, dtype=dtype, **kw)
    assert a.work_list.numel() == {"empty": 0, "one_unit": 1}.get(
        name, a.work_list.numel())
    _classic_spmm_checked(coo, a, _xs(11, coo.n_cols, 5), cuda_device)


@pytest.mark.cuda
def test_classic_spmm_after_update_values(cuda_device):
    """``whell_update_values`` turns explicit zeros into nonzeros: the
    rebuilt list covers them and kernel #16 follows, at 8 RHS."""
    from spgpu_tpu_torch.convert import whell_update_values

    coo = _zeros_and_dead_tiles()
    a, plan = coo_to_whell(coo, device=cuda_device, packed=False, return_plan=True)
    newv = np.random.default_rng(4).standard_normal(coo.nnz).astype(np.float32)
    b = whell_update_values(a, plan, newv)
    assert b.work_list.numel() > a.work_list.numel()
    new = CooMatrix(coo.rows, coo.cols, newv, coo.n_rows, coo.n_cols)
    _classic_spmm_checked(new, b, _xs(8, coo.n_cols, 6), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_classic_spmm_skips_padding_inf(dtype, cuda_device):
    """The deviation (ROADMAP §3), as #15: with Inf in X at columns that
    only zero-valued cells read, the full-layout product (the plain
    version, as the JAX kernel) has NaN lanes; kernel #16 gathers nothing
    for those cells and gives the golden, at 8 RHS."""
    coo = _cut_columns(CASES["fem"]())
    a = coo_to_whell(coo, device=cuda_device, packed=False, dtype=dtype)
    x = _xs(8, coo.n_cols, 7)
    x[:, ::128] = float("inf")
    z = ops.whell_spmm(a, x.to(cuda_device), fused=True)
    assert bool(ops.whell_spmm(a.to("cpu"), x, fused=True).isnan().any())
    assert bool(torch.isfinite(z).all())
    _near(z, torch.from_numpy(_bf16_golden(coo, a, x.double().numpy())), 2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_classic_kernel_after_update_values(cuda_device):
    """``whell_update_values`` on a card layout: cells stored as explicit
    zeros become nonzero, the rebuilt list covers them, and kernel #15
    matches the plain version and the golden of the new values."""
    from spgpu_tpu_torch.convert import whell_update_values

    coo = _zeros_and_dead_tiles()
    a, plan = coo_to_whell(coo, device=cuda_device, packed=False, return_plan=True)
    newv = np.random.default_rng(4).standard_normal(coo.nnz).astype(np.float32)
    b = whell_update_values(a, plan, newv)
    assert b.work_list.numel() > a.work_list.numel() and b.work_list.device == b.device
    b.check()
    x = _xs(1, coo.n_cols, 6)[0]
    z = ops.whell_spmv(b, x.to(cuda_device))
    _near(z, ops.whell_spmv(b.to("cpu"), x), 1e-5, rtol=1e-5)
    golden = CooMatrix(coo.rows, coo.cols, newv, coo.n_rows, coo.n_cols).spmv(
        x.double().numpy())
    _near(z, torch.from_numpy(golden), 2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_classic_kernel_skips_padding_inf(dtype, cuda_device):
    """The deviation (ROADMAP §3): with Inf in x at columns that only
    zero-valued cells read, the full-layout product (the plain version,
    as the JAX kernel) has NaN lanes; kernel #15 skips those cells and
    gives the golden."""
    coo = _cut_columns(CASES["fem"]())
    a = coo_to_whell(coo, device=cuda_device, packed=False, dtype=dtype)
    x = _xs(1, coo.n_cols, 7)[0]
    x[::128] = float("inf")
    z = ops.whell_spmv(a, x.to(cuda_device))
    assert bool(ops.whell_spmv(a.to("cpu"), x).isnan().any())
    assert bool(torch.isfinite(z).all())
    _near(z, torch.from_numpy(_bf16_golden(coo, a, x.double().numpy())), 2e-5, rtol=2e-5)


PCELL_CASES = {"fem": CASES["fem"], "fem_large": CASES["fem_large"],
               "irregular": CASES["irregular"], "ctest": CASES["ctest"],
               "rect": CLASSIC_CASES["rect"], "empty": CASES["empty"]}


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["default", "small"])
@pytest.mark.parametrize("name", sorted(PCELL_CASES))
def test_pcell_kernel_matches_plain_and_golden(name, geometry, cuda_device):
    """Kernel #17 through ``whell_spmv`` on a ``PcellWhell``: one launch,
    against its plain version (the same scan-then-difference arithmetic,
    atomics: 1e-5, 1e-5·max|z|) and the golden (1e-5·max|z|)."""
    coo = PCELL_CASES[name]()
    geo = {} if geometry == "default" else dict(group_hacks=32, chunk_tiles=16)
    a = coo_to_whell_percell(coo, device=cuda_device, **geo)
    x, y = _xs(1, coo.n_cols)[0], _xs(1, coo.n_rows, 3)[0]
    before = kp.LAUNCHES
    z = ops.whell_spmv(a, x.to(cuda_device))
    torch.cuda.synchronize()
    assert kp.LAUNCHES == before + 1 and z.shape == (coo.n_rows,)
    _near(z, ops.whell_spmv(a.to("cpu"), x), 1e-5, rtol=1e-5)
    _near(z, torch.from_numpy(coo.spmv(x.double().numpy())), 1e-5)
    z2 = ops.whell_spmv(a, x.to(cuda_device), alpha=2.0, beta=-0.5, y=y.to(cuda_device))
    _near(z2, 2.0 * z.cpu() - 0.5 * y, 1e-6, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fem", "irregular"])
def test_pcell_kernel_odd_tile_count_and_seams(name, cuda_device):
    """Kernel #17 at 7-tile chunks: a tile count that is not a multiple of
    its 4 tiles (warps) per block, on runs across 32-lane boundaries and
    ending at lanes 0 and 127 (tests/test_torch_pcell.py::
    test_pcell_fixture_has_warp_scan_seams); against the plain version
    (1e-5, 1e-5·max|z|) and the golden (1e-5·max|z|)."""
    coo = PCELL_CASES[name]()
    a = coo_to_whell_percell(coo, device=cuda_device, group_hacks=32, chunk_tiles=7)
    hi, lo = a.run_hi.long().cpu(), a.run_lo.long().cpu()
    assert a.num_tiles % 4 != 0
    assert bool(((lo + 1) >> 5 != hi >> 5)[hi >= 0].any())
    assert bool((hi == 0).any()) and bool((hi == 127).any())
    x = _xs(1, coo.n_cols, 8)[0]
    before = kp.LAUNCHES
    z = ops.whell_spmv(a, x.to(cuda_device))
    torch.cuda.synchronize()
    assert kp.LAUNCHES == before + 1
    _near(z, ops.whell_spmv(a.to("cpu"), x), 1e-5, rtol=1e-5)
    _near(z, torch.from_numpy(coo.spmv(x.double().numpy())), 1e-5)


@pytest.mark.cuda
def test_pcell_kernel_refuses_a_misaligned_slab(cuda_device):
    """The kernel loads 16 B of values per thread: a value slab off a
    16 B boundary raises instead of launching."""
    a = coo_to_whell_percell(CASES["fem"](), device=cuda_device)
    flat = torch.zeros(a.values.numel() + 1, device=cuda_device)
    off = flat[1:].view_as(a.values)
    off.copy_(a.values)
    before = kp.LAUNCHES
    with pytest.raises(ValueError, match="aligned"):
        kp.pcell_spmv(off, a.residue, a.page_tab, a.run_hi, a.run_lo, a.tile_base,
                      a.chunk_group, a.group_bases,
                      ops._prep_x(torch.zeros(a.n_cols, device=cuda_device), a.n_cols,
                                  a.x_pages), tile_page=a.tile_page,
                      chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                      window_pages=a.window_pages, num_groups=a.num_groups)
    assert kp.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("symmetric", [True, False], ids=["cg", "bicgstab"])
def test_solve_pcell_on_cuda(symmetric, cuda_device):
    d = random_fem_like(1500, 10.0, span=120, far_frac=0.0, seed=12,
                        dtype=np.float32).to_dense().astype(np.float64)
    d = (d + d.T) / 2 + np.eye(1500) * (np.abs(d).sum(1).max() + 1)
    r, c = np.nonzero(d)
    coo = CooMatrix(r, c, d[r, c].astype(np.float32), 1500, 1500)
    b = np.random.default_rng(11).standard_normal(1500).astype(np.float32)
    kp.LAUNCHES = 0
    res = solve(coo, b, device=cuda_device, fmt="pcell", symmetric=symmetric,
                tol=1e-5, maxiter=3000)
    assert bool(res.converged)
    assert kp.LAUNCHES >= res.iterations > 0
    x = res.x.double().cpu().numpy()
    assert np.linalg.norm(b - coo.spmv(x)) <= 1e-4 * np.linalg.norm(b)


# --------------------------------------------------------------------------
# every packed-WHELL SpMV (#1, #4, #7, complex128): one block per hack, one
# launch, the same bits twice

#: value dtype -> (x's and z's dtype, launch counter, atol/max|z| against
#: the plain versions, against the float64 or complex128 golden)
PER_HACK_TYPES = {"float32": (torch.float32, "LAUNCHES", 1e-5, 1e-4),
                  "bfloat16": (torch.float32, "LAUNCHES", 1e-5, 1e-4),
                  "complex64": (torch.complex64, "LAUNCHES_C64", 1e-5, 1e-4),
                  "float64": (torch.float64, "LAUNCHES_F64", 1e-12, 1e-12),
                  "complex128": (torch.complex128, "LAUNCHES_C128", 1e-12, 1e-12)}


def _per_hack_case(dtype, coo, device, **conv):
    """``coo`` in ``dtype`` (complex: ``v + 1j·N(0, 1)``; bf16: its values
    rounded to bf16, held in float64), its layout on ``device`` and
    :data:`PER_HACK_TYPES`' row."""
    if dtype in CPLX:
        coo = _complex(coo, dtype)
    else:
        v = torch.from_numpy(coo.values.astype(np.float64)).to(getattr(torch, dtype))
        coo = CooMatrix(coo.rows, coo.cols, v.double().numpy() if dtype == "bfloat16"
                        else v.numpy(), coo.n_rows, coo.n_cols)
    a = coo_to_whell(coo, device=device, dtype="bfloat16" if dtype == "bfloat16" else None,
                     **conv)
    assert a.values.dtype == getattr(torch, dtype)
    return coo, a, *PER_HACK_TYPES[dtype]


def _per_hack_x(a, coo, tdt, seed):
    """A random x in ``tdt`` (``default_rng(seed)``; complex: real and
    imaginary parts drawn in turn), in lane space, and the golden's
    product of it in float64 or complex128."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(coo.n_cols)
    if tdt.is_complex:
        x = x + 1j * rng.standard_normal(coo.n_cols)
    xt = torch.from_numpy(x).to(tdt)
    wide = np.complex128 if tdt.is_complex else np.float64
    g = CooMatrix(coo.rows, coo.cols, coo.values.astype(wide), coo.n_rows,
                  coo.n_cols).spmv(xt.numpy().astype(wide))
    return a.embed(xt, dtype=tdt), torch.from_numpy(g)


PER_HACK_DTYPES = list(PER_HACK_TYPES)


@pytest.mark.cuda
@pytest.mark.parametrize("scattered", [False, True], ids=["aligned", "scattered"])
@pytest.mark.parametrize("dtype", PER_HACK_DTYPES)
@pytest.mark.parametrize("name", ["fem_large", "laplace_wide", "empty"])
def test_per_hack_kernel_is_one_launch_and_reproducible(name, dtype, scattered,
                                                        cuda_device):
    """One counted launch per product and no accumulator; two launches
    give the same bits; within 1e-12·max|z| (float64, complex128) or
    1e-5·max|z| (fp32, bf16, complex64) of the per-hack plain version and
    of the tile-pass plain version, and within 1e-12 or 1e-4 of max|z| of
    the golden."""
    coo, a, tdt, counter, tol, gtol = _per_hack_case(dtype, CASES[name](), cuda_device,
                                                     scattered=scattered)
    assert a.hack_units.device == cuda_device
    xl, golden = _per_hack_x(a, coo, tdt, 7)
    before = getattr(kw, counter)
    z1 = ops.whell_spmv(a, xl)
    z2 = ops.whell_spmv(a, xl)
    torch.cuda.synchronize()
    assert getattr(kw, counter) == before + 2
    assert torch.equal(z1, z2)
    _near(z1, _plain(a, xl), tol)
    _near(z1, _plain(a, xl, per_hack=False), tol)
    _near(a.extract(z1, dtype=golden.dtype), golden, gtol)


def _hub_rows(n=160000, step=29, seed=3):
    """tests/test_torch_hack_runs.py's hub fixture: one hack's run of 40
    tiles, three chunks of work units."""
    b = random_banded(n, bands=5, wander=0, seed=seed, dtype=np.float64).sum_duplicates()
    rng = np.random.default_rng(seed)
    hub = np.arange(0, n, step)
    rows = np.r_[b.rows, np.zeros(hub.size, np.int64), hub]
    cols = np.r_[b.cols, hub, np.zeros(hub.size, np.int64)]
    vals = np.r_[b.values, rng.uniform(0.5, 1.5, 2 * hub.size)]
    return CooMatrix(rows, cols, vals, n, n).sum_duplicates()


@pytest.mark.cuda
@pytest.mark.parametrize("scattered", [False, True], ids=["aligned", "scattered"])
@pytest.mark.parametrize("dtype", PER_HACK_DTYPES)
def test_per_hack_kernel_adds_chunked_runs_in_order(dtype, scattered, cuda_device):
    """A run cut into chunks of work units: each chunk's block stores its
    sums, the last to finish adds them in chunk order; the same bits every
    launch, and the run counters are each call's own, not the layout's."""
    coo, a, tdt, _, tol, gtol = _per_hack_case(dtype, _hub_rows(), cuda_device,
                                               scattered=scattered)
    assert int((a.hack_units[:, 3] >= 0).sum()) >= 3
    xl, golden = _per_hack_x(a, coo, tdt, 5)
    zs = [ops.whell_spmv(a, xl) for _ in range(4)]
    torch.cuda.synchronize()
    assert all(torch.equal(zs[0], z) for z in zs[1:])
    assert not hasattr(a, "hack_done")
    _near(zs[0], _plain(a, xl), tol)
    _near(zs[0], _plain(a, xl, per_hack=False), tol)
    _near(a.extract(zs[0], dtype=golden.dtype), golden, gtol)


def _two_streams(a, xs, golden, product, pairs=200):
    """``pairs`` pairs of ``product(a, c*x)``, the two of each pair on two
    streams that both start behind a sleep and then run nothing but the
    products, so that their launches overlap; c = 1..5 changes from pair
    to pair, so a result that read another call's stale scratch or output
    would be wrong.  Returns each stream's worst error against
    ``c*golden``, over ``max|c*golden|``."""
    scaled = [[x * c for c in range(1, 6)] for x in xs]
    streams = [torch.cuda.Stream(xs[0].device) for _ in xs]
    outs = [[] for _ in xs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(xs[0].device))
        with torch.cuda.stream(s):
            torch.cuda._sleep(100_000_000)
    for i in range(pairs):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[k].append(product(a, scaled[k][i % 5]))
    torch.cuda.synchronize()
    return [float(max(float((z - (1 + i % 5) * g).abs().max()) / (1 + i % 5)
                      for i, z in enumerate(out)) / float(g.abs().max()))
            for out, g in zip(outs, golden)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", PER_HACK_DTYPES + ["spmm"])
def test_two_streams_share_no_run_counters(dtype, cuda_device):
    """Fault F2: 200 pairs of products of one chunked-run layout, the two
    of each pair at once on two streams, every result within 1e-12·max|z|
    of the golden (float64, complex128: #4 and its complex128 kernel),
    1e-4·max|z| (fp32, bf16, complex64: #1 and #7), or 1e-5·max|Z|
    (``spmm``: #12 on the fp32 layout, 3 RHS)."""
    if dtype == "spmm":
        c = _hub_rows()
        coo = CooMatrix(c.rows, c.cols, c.values.astype(np.float32), c.n_rows, c.n_cols)
        tdt, tol, shape = torch.float32, 1e-5, (3, coo.n_cols)
        product = ops.whell_spmm
        a = coo_to_whell(coo, device=cuda_device)
    else:
        coo, a, tdt, _, _, tol = _per_hack_case(dtype, _hub_rows(), cuda_device)
        shape = (coo.n_cols,)
        product = ops.whell_spmv
    assert int((a.hack_units[:, 3] >= 0).sum()) >= 3
    rng = np.random.default_rng(6)
    xs, golden = [], []
    wide = np.complex128 if tdt.is_complex else np.float64
    wcoo = CooMatrix(coo.rows, coo.cols, coo.values.astype(wide), coo.n_rows, coo.n_cols)
    for _ in range(2):
        x = rng.standard_normal(shape)
        if tdt.is_complex:
            x = x + 1j * rng.standard_normal(shape)
        x = torch.from_numpy(x).to(tdt)
        xs.append(a.embed(x, dtype=tdt))
        golden.append(a.embed(torch.from_numpy(wcoo.spmv(x.numpy().astype(wide))),
                              dtype=tdt))
    assert max(_two_streams(a, xs, golden, product)) <= tol


def _far_columns(n=12000, lo=6000, deg=9, seed=11):
    """Rows whose columns all lie in [lo, n): no run's tile reads the
    first aligned windows of lane space; the padding tiles read x[0]."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(lo, n, rows.size)
    return CooMatrix(rows, cols, rng.uniform(1, 2, rows.size), n, n).sum_duplicates()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", PER_HACK_DTYPES)
def test_per_hack_kernel_skips_padding_inf(dtype, cuda_device):
    """An Inf in x that only the output groups' padding tiles read (lane
    column 0, aligned windows): the hack pass reads no tile outside the
    runs and gives the golden, where the tile-pass plain version, like
    the JAX kernel, multiplies the padding tiles and gives NaN."""
    coo, a, tdt, _, _, gtol = _per_hack_case(dtype, _far_columns(), cuda_device,
                                             scattered=False)
    hp = a.hack_ptr.cpu()
    assert int((hp[:, 1] - hp[:, 0]).sum()) < a.num_tiles  # a padding tail
    xl, golden = _per_hack_x(a, coo, tdt, 9)
    xl[0] = float("inf")
    z = ops.whell_spmv(a, xl)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(z).all())
    _near(a.extract(z, dtype=golden.dtype), golden, gtol)
    assert bool(_plain(a, xl, per_hack=False).isnan().any())


# --------------------------------------------------------------------------
# #12 on the hack pass: one launch, the same bits, chunked runs, no read of
# the padding tiles


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scattered", [False, True], ids=["aligned", "scattered"])
@pytest.mark.parametrize("name", ["fem_large", "laplace_wide", "empty"])
def test_whell_spmm_is_one_launch_and_reproducible(name, scattered, dtype,
                                                   cuda_device):
    """One kernel launch per product, #12's hack pass: the wrapper runs
    the X copy and that kernel, and no flush and no accumulator fill (the
    zero fill of the run counters only where a run is chunked: the empty
    layout's padding chunk joins hack 0's run); the same bits over 4
    calls, within 1e-5·max|Z| of the per-hack and of the tile-pass plain
    versions."""
    from spgpu_tpu_torch.utils.timing import _session, device_ms_by_kernel

    coo = CASES[name]()
    a = coo_to_whell(coo, device=cuda_device, scattered=scattered, dtype=dtype)
    chunked = a.hack_units.shape[0] > a.seg_lo.shape[0]
    assert chunked == (name == "empty")
    xl = a.embed(_xs(8, coo.n_cols, 3), dtype=torch.float32)
    before = kw.LAUNCHES_SPMM
    zs = [ops.whell_spmm(a, xl) for _ in range(4)]
    torch.cuda.synchronize()
    assert kw.LAUNCHES_SPMM == before + 4
    assert all(torch.equal(zs[0], z) for z in zs[1:])
    x3 = ops._prep_x(xl, a.n_cols, a.x_pages, stack=True)
    call = lambda: kw.whell_packed_spmm(  # noqa: E731
        a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group, a.group_bases,
        a.seg_lo, a.seg_hi, x3, chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
        window_pages=a.window_pages, unit_segments=a.unit_segments,
        hack_units=a.hack_units, tile_page=a.tile_page)
    names = sorted(device_ms_by_kernel(call))
    for _ in range(5):  # sessions that lost events: short ones, names only
        names = names or sorted(_session(call, 3)[0])
    assert [n for n in names if n.startswith("whell_")] == ["whell_spmm_hack_pass"]
    assert len(names) <= 2 + chunked, names
    _near(zs[0], _whell_spmm_plain(a, xl), 1e-5, rtol=1e-5)
    _near(zs[0], _whell_spmm_plain(a, xl, per_hack=False), 1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rhs", [3, 8, 11])
@pytest.mark.parametrize("scattered", [False, True], ids=["aligned", "scattered"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whell_spmm_adds_chunked_runs_in_order(dtype, scattered, n_rhs, cuda_device):
    """#12 on a run cut into chunks (``_hub_rows``): each chunk's block
    stores its RHS block's sums, the last to finish adds them in chunk
    order; the same bits twice, against both plain versions (1e-5·max|Z|)
    and the golden of the slab's values (2e-5·max|Z|)."""
    c = _hub_rows()
    coo = CooMatrix(c.rows, c.cols, c.values.astype(np.float32), c.n_rows, c.n_cols)
    a = coo_to_whell(coo, device=cuda_device, scattered=scattered, dtype=dtype)
    assert int((a.hack_units[:, 3] >= 0).sum()) >= 3
    x = _xs(n_rhs, coo.n_cols, 4)
    xl = a.embed(x, dtype=torch.float32)
    z1, z2 = ops.whell_spmm(a, xl), ops.whell_spmm(a, xl)
    assert torch.equal(z1, z2)
    _near(z1, _whell_spmm_plain(a, xl), 1e-5, rtol=1e-5)
    _near(z1, _whell_spmm_plain(a, xl, per_hack=False), 1e-5, rtol=1e-5)
    _near(a.extract(z1, dtype=torch.float64),
          torch.from_numpy(_bf16_golden(coo, a, x.double().numpy())), 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whell_spmm_skips_padding_inf(dtype, cuda_device):
    """An Inf in X that only the output groups' padding tiles read (lane
    column 0, aligned windows): #12 reads no tile outside the runs and
    gives the golden, where the tile-pass plain version, like the JAX
    kernel, multiplies the padding tiles and gives NaN (a deviation,
    ROADMAP §3)."""
    c = _far_columns()
    coo = CooMatrix(c.rows, c.cols, c.values.astype(np.float32), c.n_rows, c.n_cols)
    a = coo_to_whell(coo, device=cuda_device, scattered=False, dtype=dtype)
    hp = a.hack_ptr.cpu()
    assert int((hp[:, 1] - hp[:, 0]).sum()) < a.num_tiles  # a padding tail
    x = _xs(3, coo.n_cols, 9)
    xl = a.embed(x, dtype=torch.float32)
    xl[:, 0] = float("inf")
    z = ops.whell_spmm(a, xl)
    assert bool(torch.isfinite(z).all())
    _near(a.extract(z, dtype=torch.float64),
          torch.from_numpy(_bf16_golden(coo, a, x.double().numpy())), 2e-5, rtol=2e-5)
    assert bool(_whell_spmm_plain(a, xl, per_hack=False).isnan().any())


@pytest.mark.cuda
def test_whell_spmm_keeps_the_rhs_guard(cuda_device):
    """65,536 RHS: more RHS blocks than the wrapper lets one launch take."""
    a = coo_to_whell(CASES["empty"](), device=cuda_device)
    x3 = torch.zeros((65536, a.x_pages, 128), device=cuda_device)
    with pytest.raises(ValueError, match="65,535"):
        kw.whell_packed_spmm(a.values, a.residue, a.page_tab, a.tile_base,
                             a.chunk_group, a.group_bases, a.seg_lo, a.seg_hi, x3,
                             chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                             window_pages=a.window_pages,
                             unit_segments=a.unit_segments, hack_units=a.hack_units,
                             tile_page=a.tile_page)


# --------------------------------------------------------------------------
# the per-op accounts: kernels #18 (WHDIA, fp32) and #19 (packed WHELL,
# float64), every level against its plain version; full against the
# production launch

ABLATION_WHDIA_CASES = {
    "band11": lambda: random_banded(3000, bands=11, wander=7, seed=2,
                                    dtype=np.float32).sum_duplicates(),
    "banded_wide": DIA_CASES["banded_wide"],
    "laplace_wide": DIA_CASES["laplace_wide"],
    "laplace3d": DIA_CASES["laplace3d"],
    "empty": CASES["empty"],
}
ABLATION_F64_CASES = {
    "laplace": lambda: laplacian_2d(60, 70, np.float64),
    "fem": lambda: _f64(CASES["fem"]()),
    "irregular": lambda: _f64(CASES["irregular"]()),
    "empty": lambda: _f64(CASES["empty"]()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("level", ["stream", "r0", "gather", "full"])
@pytest.mark.parametrize("name", sorted(ABLATION_WHDIA_CASES))
def test_whdia_ablation_matches_plain(name, level, cuda_device):
    """Kernel #18's tile levels in both r0 modes: the partial levels
    within 1e-5·max|part| of their plain versions (no atomics: the order
    of 8 slot sums only), full (the fp32 tile pass) within #3's tolerance
    of its plain version and of the production #3 (the warp pass); one
    launch counted, none of #3."""
    from spgpu_tpu_torch.kernels import ablation as ab

    coo = ABLATION_WHDIA_CASES[name]()
    a = coo_to_whdia(coo, device=cuda_device)
    assert a.pattern_mode == name.startswith("band") or name == "empty"
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(coo.n_cols)
                         .astype(np.float32)).to(cuda_device)
    args = (a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group, x)
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  num_groups=a.num_groups, tile_page=a.tile_page)
    before = (ab.LAUNCHES_WHDIA_ABLATION, kd.LAUNCHES)
    got = ab.whdia_ablation(level, *args, **static)
    torch.cuda.synchronize()
    assert (ab.LAUNCHES_WHDIA_ABLATION, kd.LAUNCHES) == (before[0] + 1, before[1])
    want = ab.whdia_ablation_plain(level, *args, **static)
    assert got.shape == want.shape and got.device == x.device
    if level == "full":
        _near(got, want, 1e-5, rtol=1e-5)
        _near(got, kd.whdia_spmv(*args, **static, hack_slot_ptr=a.hack_slot_ptr,
                                 hack_slots=a.hack_slots), 1e-5, rtol=1e-5)
    else:
        assert got.shape == (a.num_tiles, 128)
        _near(got, want, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("level", ["stream", "gather", "own", "full"])
@pytest.mark.parametrize("scattered", [False, True], ids=["aligned", "scattered"])
@pytest.mark.parametrize("name", sorted(ABLATION_F64_CASES))
def test_f64_ablation_matches_plain(name, scattered, level, cuda_device):
    """Kernel #19 (the levels of #4's hack pass) on aligned and scattered
    windows: every level within 1e-12·max|out| of its plain version, full
    of the production #4 launch too; one launch counted, none of #4."""
    from spgpu_tpu_torch.kernels import ablation as ab

    coo = ABLATION_F64_CASES[name]()
    a = coo_to_whell(coo, device=cuda_device, scattered=scattered)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(a.n_cols)).to(cuda_device)
    args = (a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
            a.group_bases, a.seg_lo, a.seg_hi, ops._prep_x(x, a.n_cols, a.x_pages))
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  window_pages=a.window_pages, unit_segments=a.unit_segments,
                  hack_units=a.hack_units, tile_page=a.tile_page)
    before = (ab.LAUNCHES_F64_ABLATION, kw.LAUNCHES_F64)
    got = ab.whell_f64_ablation(level, *args, **static)
    torch.cuda.synchronize()
    assert (ab.LAUNCHES_F64_ABLATION, kw.LAUNCHES_F64) == (before[0] + 1, before[1])
    want = ab.whell_f64_ablation_plain(level, *args, **static)
    assert got.shape == want.shape and got.dtype == torch.float64
    _near(got, want, 1e-12)
    if level == "full":
        _near(got, kw.whell_packed_spmv(*args, **static), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["whdia", "f64"])
def test_production_kernels_unchanged_beside_the_ablation(fmt, cuda_device):
    """#3 and #4, whose bodies the ablation levels share, still match
    their plain versions and the golden, counted on their own counters."""
    if fmt == "whdia":
        coo = ABLATION_WHDIA_CASES["band11"]()
        a = coo_to_whdia(coo, device=cuda_device)
        x = np.random.default_rng(5).standard_normal(coo.n_cols).astype(np.float32)
        before = kd.LAUNCHES
        z = ops.whdia_spmv(a, torch.from_numpy(x).to(cuda_device))
        torch.cuda.synchronize()
        assert kd.LAUNCHES == before + 1
        _near(z, ops.whdia_spmv(a.to("cpu"), torch.from_numpy(x)), 1e-5, rtol=1e-5)
        _near(z, torch.from_numpy(coo.spmv(x.astype(np.float64))), 2e-5, rtol=2e-5)
    else:
        coo = ABLATION_F64_CASES["fem"]()
        a = coo_to_whell(coo, device=cuda_device)
        x = np.random.default_rng(5).standard_normal(coo.n_cols)
        before = kw.LAUNCHES_F64
        z = ops.whell_spmv(a, a.embed(torch.from_numpy(x), dtype=torch.float64))
        torch.cuda.synchronize()
        assert kw.LAUNCHES_F64 == before + 1
        _near(a.extract(z, dtype=torch.float64), torch.from_numpy(coo.spmv(x)), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["whdia_ablation", "dd_ablation", "dd_geom_sweep"])
def test_sweeps_time_on_the_card(name, cuda_device):
    """A small run of each sweep on the card: every row timed warm and
    cold with its source, every level checked inside ``run`` and counted
    on its kernel's counter."""
    import importlib

    from spgpu_tpu_torch.kernels import ablation as ab

    mod = importlib.import_module(f"spgpu_tpu_torch.sweeps.{name}")
    counter = {"whdia_ablation": (ab, "LAUNCHES_WHDIA_ABLATION"),
               "dd_ablation": (ab, "LAUNCHES_F64_ABLATION"),
               "dd_geom_sweep": (kw, "LAUNCHES_F64")}[name]
    setattr(*counter, 0)
    res = mod.run(cuda_device, size={"whdia_ablation": 8192}.get(name, 96))
    rows = res["geometries" if name == "dd_geom_sweep" else "levels"]
    assert getattr(*counter) >= len(rows) == res["launches"]
    for r in rows:
        assert r["device_ms"] > 0 and r["cold_device_ms"] > 0 and r["per_call_ms"] > 0
        assert {r["device_source"], r["cold_source"]} <= {"profiler", "cuda_events"}
    assert res["gpu"] and res["library"]["per_call_ms"] > 0
    if name != "dd_geom_sweep":
        assert rows[0]["price_ms"] is None
        # a price needs both times from one source
        assert (rows[1]["price_ms"] is not None) == (
            rows[1]["device_source"] == rows[0]["device_source"])


# --------------------------------------------------------------------------
# the WHDIA live-slot kernels: #3, #6 and #10 (fp32, float64 and
# complex128 SpMV, the warp pass), #9 (complex64 SpMV) and #13 (fp32 SpMM,
# the hack pass) over each hack's live slots
# (WhdiaMatrix.hack_slot_ptr/hack_slots)


def _holes(coo):
    """``coo`` without the rows of every third hack: hacks with no live
    slot, whose rows the hack pass must still write (zeros)."""
    keep = (coo.rows // 128) % 3 != 1
    return CooMatrix(coo.rows[keep], coo.cols[keep], coo.values[keep], coo.n_rows,
                     coo.n_cols)


#: r0 mode -> a fixture in that mode, float64 values, with empty row blocks
HACK_CASES = {"slab": lambda: _holes(laplacian_2d(40, 40)),
              "pattern": lambda: _holes(random_banded(3000, bands=11, seed=2))}


#: live-slot kernel -> (value type, launch counter, atol/max|z| and rtol
#: against the plain versions, the same against the golden); "spmm" is #13
HACK_KERNELS = {"f32": (np.float32, "LAUNCHES", 1e-5, 2e-5),
                "f64": (np.float64, "LAUNCHES_F64", 1e-12, 1e-12),
                "c64": (np.complex64, "LAUNCHES_C64", 1e-5, 2e-5),
                "c128": (np.complex128, "LAUNCHES_C128", 1e-12, 1e-12),
                "spmm": (np.float32, "LAUNCHES_SPMM", 1e-5, 2e-5)}


def _hack_layout(mode, kernel, cuda_device):
    """The fixture of ``mode`` in the value type of ``kernel`` (fp32
    ``"f32"``, #3; ``"spmm"``, #13; float64 ``"f64"``, #6; complex64
    ``"c64"``, #9; complex128 ``"c128"``, #10) on the card, and its COO."""
    coo = HACK_CASES[mode]()
    dt = HACK_KERNELS[kernel][0]
    coo = (_complex(coo, dt) if np.dtype(dt).kind == "c" else
           CooMatrix(coo.rows, coo.cols, coo.values.astype(dt), coo.n_rows, coo.n_cols))
    a = coo_to_whdia(coo, device=cuda_device)
    assert a.pattern_mode == (mode == "pattern")
    return coo, a


def _hack_x(kernel, n, n_rhs=3, seed=0):
    dt = HACK_KERNELS[kernel][0]
    if np.dtype(dt).kind == "c":
        return torch.from_numpy(_cvec(n, seed).astype(dt))[None]
    return _xs(n_rhs if kernel == "spmm" else 1, n, seed).to(getattr(torch, np.dtype(dt).name))


def _hack_call(kernel, a, x):
    """The kernel itself, on the padded rows: (n_rhs, num_groups*group_hacks*128)."""
    args = (a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group)
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  num_groups=a.num_groups, hack_slot_ptr=a.hack_slot_ptr,
                  hack_slots=a.hack_slots, tile_page=a.tile_page)
    if kernel != "spmm":
        return kd.whdia_spmv(*args, x[0], **static)[None]
    return kd.whdia_spmm(*args, x, **static)


def _hack_listed(a, x):
    return kd.whdia_spmm_listed_plain(
        a.values, a.slot_r0, a.tile_r0, a.tile_base, a.hack_slot_ptr,
        a.hack_slots, x, group_hacks=a.group_hacks, num_groups=a.num_groups,
        tile_page=a.tile_page)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(HACK_CASES))
@pytest.mark.parametrize("kernel", ["c64", "spmm", "f32", "f64", "c128"])
def test_hack_pass_matches_plain_and_golden(kernel, mode, cuda_device):
    """#9, #13, #3, #6 and #10 through the op, counted once, against the
    full-layout plain version, the listed plain product (the kernel's
    order, unfused) and the golden: rtol 1e-5 and atol 1e-5·max|z|, 2e-5
    vs the golden (float64 and complex128 1e-12 in both)."""
    coo, a = _hack_layout(mode, kernel, cuda_device)
    x = _hack_x(kernel, coo.n_cols).to(cuda_device)
    _, counter, tol, gtol = HACK_KERNELS[kernel]
    before = getattr(kd, counter)
    z = ops.whdia_spmv(a, x[0])[None] if kernel != "spmm" else \
        ops.whdia_spmm(a, x, fused=True)
    torch.cuda.synchronize()
    assert getattr(kd, counter) == before + 1
    n = coo.n_rows
    zp = kd.whdia_spmm_plain(a.values, a.slot_r0, a.tile_r0, a.tile_base,
                             a.chunk_group, x, chunk_tiles=a.chunk_tiles,
                             group_hacks=a.group_hacks, num_groups=a.num_groups,
                             tile_page=a.tile_page)
    _near(z, zp[:, :n], tol, rtol=tol)
    _near(z, _hack_listed(a, x)[:, :n], tol, rtol=tol)
    wide = np.complex128 if x.is_complex() else np.float64
    golden = coo.spmv(x.cpu().numpy().astype(wide))
    _near(z, torch.from_numpy(golden), gtol, rtol=gtol)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(HACK_CASES))
@pytest.mark.parametrize("n_rhs", [1, 3, 8, 9, 17])
def test_hack_pass_spmm_takes_any_rhs_count(n_rhs, mode, cuda_device):
    """#13 at 1, 3 (a remainder only), 8 (one block), 9 and 17 (blocks
    and a remainder) RHS."""
    coo, a = _hack_layout(mode, "spmm", cuda_device)
    x = _xs(n_rhs, coo.n_cols, seed=n_rhs).to(cuda_device)
    z, zp = _fused_spmm("whdia", a, x)
    _near(z, zp, 1e-5, rtol=1e-5)
    _near(z, _spmm_golden(coo, x), 2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(HACK_CASES))
@pytest.mark.parametrize("kernel", ["c64", "spmm", "f32", "f64", "c128"])
def test_hack_pass_writes_every_row_and_repeats_its_bits(kernel, mode, cuda_device):
    """z is not zero-filled: the block the kernel writes first held NaN,
    yet every row comes out finite, a hack with no live slot as zeros; two
    launches give the same bits (no atomics)."""
    _, a = _hack_layout(mode, kernel, cuda_device)
    x = _hack_x(kernel, a.n_cols, n_rhs=9).to(cuda_device)
    rows = a.num_groups * a.group_hacks * 128
    nan = torch.full((x.shape[0] * rows,), float("nan"), dtype=x.dtype,
                     device=cuda_device)
    ptr = nan.data_ptr()
    del nan  # the caching allocator hands this block to the kernel's z
    z = _hack_call(kernel, a, x)
    torch.cuda.synchronize()
    assert z.data_ptr() == ptr
    assert bool(torch.isfinite(z).all())
    counts = (a.hack_slot_ptr[1:] - a.hack_slot_ptr[:-1]).cpu()
    empty = torch.nonzero(counts == 0).view(-1)
    assert empty.numel() > 0
    assert not bool(z.view(x.shape[0], -1, 128)[:, empty.to(cuda_device)].any())
    assert torch.equal(z, _hack_call(kernel, a, x))


def _dead_only_column(a):
    """A column in range that only all-zero slots reach."""
    vals, _, col = a._cells()
    live = (vals != 0).any(axis=1)
    inr = (col >= 0) & (col < a.n_cols)
    cols = sorted(set(col[~live][inr[~live]].tolist())
                  - set(col[live][inr[live]].tolist()))
    assert cols, "the fixture must have a column that only dead slots reach"
    return cols[len(cols) // 2]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["c64", "spmm", "f32", "f64", "c128"])
def test_hack_pass_skips_dead_slot_inf(kernel, cuda_device):
    """An Inf in x at a column that only dead slots reach: the full-layout
    plain version (the JAX semantics) gives NaN, the hack pass the golden
    (a deviation, ROADMAP §3)."""
    coo, a = _hack_layout("slab", kernel, cuda_device)
    x = _hack_x(kernel, coo.n_cols)
    x[:, _dead_only_column(a)] = float("inf")
    x = x.to(cuda_device)
    wide = np.complex128 if x.is_complex() else np.float64
    golden = torch.from_numpy(coo.spmv(x.cpu().numpy().astype(wide)))
    assert bool(torch.isfinite(golden).all())
    full = kd.whdia_spmm_plain(a.values, a.slot_r0, a.tile_r0, a.tile_base,
                               a.chunk_group, x, chunk_tiles=a.chunk_tiles,
                               group_hacks=a.group_hacks, num_groups=a.num_groups,
                               tile_page=a.tile_page)
    assert bool(torch.isnan(full[:, : coo.n_rows]).any())
    z = _hack_call(kernel, a, x)[:, : coo.n_rows]
    assert bool(torch.isfinite(z).all())
    gtol = HACK_KERNELS[kernel][3]
    _near(z, golden, gtol, rtol=gtol)


@pytest.mark.cuda
def test_hack_pass_needs_the_lists(cuda_device):
    """A CUDA call of any WHDIA live-slot kernel (#3, #6, #9, #10, #13)
    without the live-slot lists, or with a list on another device,
    raises."""
    coo, a = _hack_layout("slab", "spmm", cuda_device)
    args = (a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group)
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  num_groups=a.num_groups, tile_page=a.tile_page)
    x = _xs(2, coo.n_cols).to(cuda_device)
    with pytest.raises(ValueError, match="hack_slot_ptr"):
        kd.whdia_spmm(*args, x, **static)
    for kernel in ("f32", "f64", "c64", "c128"):
        _, ak = _hack_layout("slab", kernel, cuda_device)
        argk = (ak.values, ak.slot_r0, ak.tile_r0, ak.tile_base, ak.chunk_group)
        static = dict(chunk_tiles=ak.chunk_tiles, group_hacks=ak.group_hacks,
                      num_groups=ak.num_groups, tile_page=ak.tile_page)
        xk = _hack_x(kernel, ak.n_cols).to(cuda_device)[0]
        counter = HACK_KERNELS[kernel][1]
        before = getattr(kd, counter)
        with pytest.raises(ValueError, match="hack_slot_ptr"):
            kd.whdia_spmv(*argk, xk, **static)
        with pytest.raises(ValueError, match="hack_slot_ptr"):
            kd.whdia_spmv(*argk, xk, **static, hack_slot_ptr=ak.hack_slot_ptr.cpu(),
                          hack_slots=ak.hack_slots)
        assert getattr(kd, counter) == before


@pytest.mark.cuda
def test_warp_pass_needs_aligned_values(cuda_device):
    """#3 and #6 load each thread's lanes as 16-byte words: a slab that
    starts one element past an aligned address raises; the same values
    copied to an aligned slab give the product."""
    for kernel in ("f32", "f64"):
        coo, a = _hack_layout("slab", kernel, cuda_device)
        assert a.values.dtype in kd.ALIGNED
        S = a.values.shape[0]
        buf = torch.empty(S * 128 + 1, dtype=a.values.dtype, device=cuda_device)
        shifted = buf[1:].view(S, 128)
        shifted.copy_(a.values)
        static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                      num_groups=a.num_groups, hack_slot_ptr=a.hack_slot_ptr,
                      hack_slots=a.hack_slots, tile_page=a.tile_page)
        x = _hack_x(kernel, coo.n_cols).to(cuda_device)[0]
        rest = (a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group, x)
        with pytest.raises(ValueError, match="16 B aligned"):
            kd.whdia_spmv(shifted, *rest, **static)
        z = kd.whdia_spmv(shifted.clone(), *rest, **static)[: coo.n_rows]
        gtol = HACK_KERNELS[kernel][3]
        _near(z, torch.from_numpy(coo.spmv(x.cpu().double().numpy())), gtol, rtol=gtol)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rhs", [1, 8])
@pytest.mark.parametrize("level", ["launch", "list", "stream", "full"])
@pytest.mark.parametrize("name", sorted(ABLATION_WHDIA_CASES))
def test_whdia_hack_ablation_matches_plain(name, level, n_rhs, cuda_device):
    """Kernel #18's hack levels in both r0 modes, at 1 RHS (#3's warp
    pass) and 8 (#13's hack pass): launch and list exactly (integer
    sums), stream within 1e-5·max|out|, full within #3's tolerance of its
    plain version and equal to the production launch bit for bit; one
    launch counted, none of #3 or #13; every row written over NaN."""
    from spgpu_tpu_torch.kernels import ablation as ab

    coo = ABLATION_WHDIA_CASES[name]()
    a = coo_to_whdia(coo, device=cuda_device)
    xs = _xs(n_rhs, coo.n_cols, seed=n_rhs).to(cuda_device)
    x = xs if n_rhs > 1 else xs[0]
    args = (a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group, x)
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  num_groups=a.num_groups, hack_slot_ptr=a.hack_slot_ptr,
                  hack_slots=a.hack_slots, tile_page=a.tile_page)
    rows = a.num_groups * a.group_hacks * 128
    torch.cuda.synchronize()
    torch.full((n_rhs * rows,), float("nan"), device=cuda_device)
    before = (ab.LAUNCHES_WHDIA_ABLATION, kd.LAUNCHES, kd.LAUNCHES_SPMM)
    got = ab.whdia_hack_ablation(level, *args, **static)
    torch.cuda.synchronize()
    assert (ab.LAUNCHES_WHDIA_ABLATION, kd.LAUNCHES, kd.LAUNCHES_SPMM) == \
        (before[0] + 1, before[1], before[2])
    want = ab.whdia_hack_ablation_plain(level, *args, **static)
    assert got.shape == want.shape == ((n_rhs, rows) if n_rhs > 1 else (rows,))
    assert bool(torch.isfinite(got).all())
    if level in ("launch", "list"):
        assert torch.equal(got, want)
    elif level == "stream":
        _near(got, want, 1e-5)
    else:
        _near(got, want, 1e-5, rtol=1e-5)
        prod = kd.whdia_spmv if n_rhs == 1 else kd.whdia_spmm
        assert torch.equal(got, prod(*args, **static))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["tile", "hack"])
@pytest.mark.parametrize("matrix,size", [("banded11", 8192), ("laplace", 96)])
def test_whdia_sweep_on_both_fixtures_on_the_card(matrix, size, family, cuda_device):
    """#18's sweep on both DIA fixtures in both level sets: every row
    timed warm and cold, checked inside ``run`` and counted; the hack
    levels at 1 and 8 RHS, each group priced from its own first row."""
    from spgpu_tpu_torch.kernels import ablation as ab
    from spgpu_tpu_torch.sweeps import whdia_ablation

    ab.LAUNCHES_WHDIA_ABLATION = 0
    res = whdia_ablation.run(cuda_device, size=size, matrix=matrix, family=family)
    rows = res["levels"]
    assert res["mode"] == whdia_ablation.MATRICES[matrix]
    assert ab.LAUNCHES_WHDIA_ABLATION >= len(rows) == res["launches"]
    assert len(rows) == (4 if family == "tile" else 8)
    for r in rows:
        assert r["device_ms"] > 0 and r["cold_device_ms"] > 0 and r["per_call_ms"] > 0
    firsts = [rows[0]] if family == "tile" else [rows[0], rows[4]]
    assert all(r["price_ms"] is None for r in firsts)
    for prev, r in zip(rows, rows[1:]):  # a price needs both times from one source
        if r not in firsts:
            assert (r["price_ms"] is not None) == (
                r["device_source"] == prev["device_source"])
    assert res["library"]["per_call_ms"] > 0
    if family == "hack":
        assert [r["n_rhs"] for r in rows] == [1] * 4 + [8] * 4
        assert res["library_spmm"]["per_call_ms"] > 0


# --------------------------------------------------------------------------
# the Krylov loop: CUDA-graph replays of masked CG and BiCGSTAB steps

#: the loop's module (``solvers.cg`` is the function of that name)
loop = importlib.import_module("spgpu_tpu_torch.solvers.cg")

#: (fmt, dtype) of every solve() route -> whether its kernel gives the same
#: bits every call (SDIA #2/#5/#8/#11, WHDIA #3/#6/#9/#10, packed WHELL
#: #1/#4/#7 and complex128 on the hack pass, the hybrid split and HELL);
#: #17 sums with atomics
GRAPH_ROUTES = {("whell", "float32"): True, ("whell", "float64"): True,
                ("whell", "complex64"): True, ("whell", "complex128"): True,
                ("sdia", "float32"): True, ("sdia", "float64"): True,
                ("sdia", "complex64"): True, ("sdia", "complex128"): True,
                ("whdia", "float32"): True, ("whdia", "float64"): True,
                ("whdia", "complex64"): True, ("whdia", "complex128"): True,
                ("pcell", "float32"): False,
                # the hybrid split: #3 + #1 or #6 + #4 and an index copy each
                # way; classic HELL: plain torch, each hack summed in slot
                # order by segment_reduce (no atomics)
                ("hybrid", "float32"): True, ("hybrid", "float64"): True,
                ("hell", "float32"): True, ("hell", "float64"): True,
                ("hell", "complex64"): True, ("hell", "complex128"): True}


def _loop_system(dtype, symmetric):
    """CG: the wide Laplacian (complex: made Hermitian positive-definite);
    BiCGSTAB: a contiguous band; ``b`` from ``default_rng(11)``; the
    solver tolerance and the true-residual gate of ``dtype``."""
    cplx = np.dtype(dtype).kind == "c"
    c = CASES["laplace_wide"]() if symmetric else random_banded(3000, bands=11, seed=2)
    if cplx:
        coo = _hermitian(_complex(c, dtype)) if symmetric else _complex(c, dtype)
        b = _cvec(coo.n_rows, 11).astype(dtype)
    else:
        coo = CooMatrix(c.rows, c.cols, c.values.astype(dtype), c.n_rows, c.n_cols)
        b = np.random.default_rng(11).standard_normal(coo.n_rows).astype(dtype)
    tols = (1e-5, 1e-4) if dtype in ("float32", "complex64") else (1e-10, 1e-9)
    return coo, b, *tols


def _true_residual(coo, b, x):
    wide = np.complex128 if np.iscomplexobj(b) else np.float64
    x = x.cpu().numpy().astype(wide)
    return np.linalg.norm(b - coo.sum_duplicates().spmv(x)) / np.linalg.norm(b)


@pytest.mark.cuda
@pytest.mark.parametrize("symmetric", [True, False], ids=["cg", "bicgstab"])
@pytest.mark.parametrize("fmt,dtype", sorted(GRAPH_ROUTES))
def test_graphed_solve_matches_the_eager_witness(fmt, dtype, symmetric,
                                                 cuda_device, monkeypatch):
    """solve() on every route and type runs the graphed loop and agrees
    with the same solve() on the eager loop: bit for bit where the kernel
    gives the same bits every call, else within max(1, 10 %) of its
    iterations and the true-residual gate."""
    from spgpu_tpu_torch.solvers import auto

    coo, b, tol, true_tol = _loop_system(dtype, symmetric)
    kw_ = dict(device=cuda_device, fmt=fmt, symmetric=symmetric, tol=tol,
               maxiter=5000)
    loop.REPLAYS = 0
    graphed = solve(coo, b, **kw_)
    assert loop.REPLAYS > 0
    monkeypatch.setattr(auto, "cg", loop._cg_eager)
    monkeypatch.setattr(auto, "bicgstab", loop._bicgstab_eager)
    eager = solve(coo, b, **kw_)
    assert bool(graphed.converged) and bool(eager.converged)
    if GRAPH_ROUTES[(fmt, dtype)]:
        assert graphed.iterations == eager.iterations
        assert torch.equal(graphed.x, eager.x)
        assert torch.equal(graphed.residual_norm, eager.residual_norm)
    else:
        assert abs(graphed.iterations - eager.iterations) <= max(1, eager.iterations // 10)
    assert _true_residual(coo, b, graphed.x) <= true_tol


#: r0 mode -> the system of test_whdia_wide_solves_repeat_their_bits
WIDE_SOLVES = {"slab": lambda: laplacian_2d(40, 40),
               "pattern": lambda: random_banded(3000, bands=11, seed=2)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(WIDE_SOLVES))
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_whdia_wide_solves_repeat_their_bits(dtype, mode, cuda_device):
    """#6 and #10 read the live slots without atomics, so their WHDIA
    solve() route gives the same bits graphed and eager: CG capped at 60
    iterations (tol 0) on each r0 mode's system made Hermitian (float64:
    symmetric) positive-definite, the same x bit for bit, each launch
    counted."""
    c = WIDE_SOLVES[mode]()
    cplx = dtype == "complex128"
    h = _hermitian(_complex(c, np.complex128) if cplx else CooMatrix(
        c.rows, c.cols, c.values.astype(np.complex128), c.n_rows, c.n_cols))
    coo = h if cplx else CooMatrix(h.rows, h.cols, h.values.real.copy(), h.n_rows,
                                   h.n_cols)
    b = (_cvec(coo.n_rows, 11) if cplx else
         np.random.default_rng(11).standard_normal(coo.n_rows)).astype(dtype)
    a = coo_to_whdia(coo, device=cuda_device)
    assert a.pattern_mode == (mode == "pattern")
    bt = torch.from_numpy(b).to(cuda_device)
    counter = "LAUNCHES_C128" if cplx else "LAUNCHES_F64"
    got = {}
    for tag, fn in (("graphed", loop.cg), ("eager", loop._cg_eager)):
        setattr(kd, counter, 0)
        got[tag] = fn(lambda v: ops.whdia_spmv(a, v), bt, tol=0.0, maxiter=60)
        torch.cuda.synchronize()
        assert got[tag].iterations == 60 and getattr(kd, counter) >= 61
    assert torch.equal(got["graphed"].x, got["eager"].x)
    assert torch.equal(got["graphed"].residual_norm, got["eager"].residual_norm)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_launch_counters_count_every_replay(solver, cuda_device):
    """#3's counter counts each captured launch once per replay: one SpMV
    per CG step and two per BiCGSTAB step, beside the eager b − A·x0; the
    host reads one flag per replay, the eager step's included."""
    coo, b, tol, _ = _loop_system("float32", solver == "cg")
    a = coo_to_whdia(coo, device=cuda_device)
    bt = torch.from_numpy(b).to(cuda_device)
    kd.LAUNCHES = 0
    loop.STEPS = loop.HOST_READS = loop.REPLAYS = 0
    res = getattr(loop, solver)(lambda v: ops.whdia_spmv(a, v), bt, tol=tol,
                                maxiter=5000)
    assert bool(res.converged) and loop.REPLAYS > 0
    assert loop.STEPS == 1 + loop.GRAPH_STEPS * loop.REPLAYS > res.iterations
    assert kd.LAUNCHES == 1 + (1 if solver == "cg" else 2) * loop.STEPS
    assert loop.HOST_READS == loop.REPLAYS
    assert loop.HOST_READS <= -(-res.iterations // loop.GRAPH_STEPS) + 2


@pytest.mark.cuda
def test_graph_memory_is_released(cuda_device):
    """Two graphed solves in a row leave the same memory allocated: each
    releases its graph and its pool."""
    coo, b, tol, _ = _loop_system("float64", True)
    a = coo_to_sdia(coo, device=cuda_device)
    bt = torch.from_numpy(b).to(cuda_device)
    allocated = []
    for _ in range(3):
        res = loop.cg(lambda v: ops.sdia_spmv(a, v), bt, tol=tol, maxiter=5000)
        assert bool(res.converged)
        del res
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated(cuda_device))
    assert allocated[1] == allocated[2] <= allocated[0]


@pytest.mark.cuda
def test_a_matvec_that_reads_the_host_raises(cuda_device):
    """A matvec that reads a value back (``.item()``) cannot be captured:
    cg raises, after r0 and the one eager step, and runs nothing eagerly
    instead; the captured launches are taken back off the counter and the
    card still solves."""
    coo, b, tol, _ = _loop_system("float32", True)
    a = coo_to_whdia(coo, device=cuda_device)
    bt = torch.from_numpy(b).to(cuda_device)
    calls = []

    def reads_host(v):
        z = ops.whdia_spmv(a, v)
        calls.append(float(z.abs().max()))
        return z

    kd.LAUNCHES = 0
    with pytest.raises(RuntimeError, match="cannot be captured"):
        loop.cg(reads_host, bt, tol=tol, maxiter=5000)
    assert len(calls) == 2 and kd.LAUNCHES == 2
    res = loop.cg(lambda v: ops.whdia_spmv(a, v), bt, tol=tol, maxiter=5000)
    assert bool(res.converged)


def _spd(coo):
    """(A + Aᵀ)/2, each diagonal entry the row's off-diagonal |·|-sum + 1."""
    n = coo.n_rows
    v = coo.values / 2
    h = CooMatrix(np.r_[coo.rows, coo.cols], np.r_[coo.cols, coo.rows],
                  np.r_[v, v], n, n).sum_duplicates()
    off = h.rows != h.cols
    d = np.bincount(h.rows[off], weights=np.abs(h.values[off]), minlength=n) + 1.0
    i = np.arange(n)
    return CooMatrix(np.r_[h.rows[off], i], np.r_[h.cols[off], i],
                     np.r_[h.values[off], d], n, n)


@pytest.mark.cuda
def test_graphed_solves_on_two_streams_at_once(cuda_device):
    """Two graphed CG solves on one chunked-run float64 layout (#4, the
    hub fixture made SPD), each in its own thread on its own stream, three
    times over: each gives, bit for bit, the answer it gives alone."""
    from concurrent.futures import ThreadPoolExecutor

    coo = _spd(_hub_rows())
    a = coo_to_whell(coo, device=cuda_device)
    assert int((a.hack_units[:, 3] >= 0).sum()) >= 3
    rng = np.random.default_rng(6)
    bs = [a.embed(torch.from_numpy(rng.standard_normal(coo.n_rows)),
                  dtype=torch.float64) for _ in range(2)]

    def run(b):
        return loop.cg(lambda v: ops.whell_spmv(a, v), b, tol=1e-10, maxiter=3000)

    alone = [run(b) for b in bs]
    assert all(bool(r.converged) for r in alone)
    streams = [torch.cuda.Stream(cuda_device) for _ in bs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda_device))

    def on_stream(k):
        with torch.cuda.stream(streams[k]):
            res = run(bs[k])
            streams[k].synchronize()
            return res

    with ThreadPoolExecutor(2) as ex:
        for _ in range(3):
            both = list(ex.map(on_stream, range(2)))
            for got, want in zip(both, alone):
                assert got.iterations == want.iterations
                assert torch.equal(got.x, want.x)


# --------------------------------------------------------------------------
# large systems on one layout: each widened kernel family on a layout past
# the old 16-bit page field of tile_base (65,536 x pages), the page read
# from the full-width tile_page word


@functools.lru_cache(maxsize=1)
def _tridiagonal_9m():
    """F1's case: a 9,000,000-row tridiagonal (float64 host COO, rows in
    order), diagonally dominant: 70,313 column pages."""
    n = 9_000_000
    i = np.arange(n, dtype=np.int64)
    rng = np.random.default_rng(3)
    rows = np.concatenate([i[1:], i, i[:-1]])
    cols = np.concatenate([i[:-1], i, i[1:]])
    vals = np.concatenate([rng.uniform(-1, 0, n - 1), np.full(n, 4.0),
                           rng.uniform(-1, 0, n - 1)])
    o = np.lexsort((cols, rows))
    return CooMatrix(rows[o], cols[o], vals[o], n, n)


def _typed(coo, dtype):
    return CooMatrix(coo.rows, coo.cols, coo.values.astype(dtype), coo.n_rows,
                     coo.n_cols)


def _past_the_field(a):
    assert a.x_pages > 1 << 16 and int(a.tile_page.max()) > 0xFFFF
    assert torch.equal(a.tile_base & 0xFFFF, a.tile_page & 0xFFFF)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_aligned_packed_past_the_page_field(dtype, cuda_device):
    """#1 (fp32) and #4 (float64) on aligned windows past 65,536 x pages:
    every row against the plain version and the golden (1e-12·max|z| in
    float64: before F1's guard 611,393 of these rows were wrong)."""
    coo = _typed(_tridiagonal_9m(), dtype)
    a = coo_to_whell(coo, device=cuda_device, scattered=False)
    _past_the_field(a)
    x = np.random.default_rng(0).standard_normal(coo.n_cols).astype(dtype)
    xl = a.embed(torch.from_numpy(x), dtype=getattr(torch, dtype))
    counter = "LAUNCHES_F64" if dtype == "float64" else "LAUNCHES"
    before = getattr(kw, counter)
    z = ops.whell_spmv(a, xl)
    torch.cuda.synchronize()
    assert getattr(kw, counter) == before + 1
    units = a.hack_units if dtype == "float64" else None
    zp = kw.whell_packed_spmv_plain(
        a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
        a.group_bases, a.seg_lo, a.seg_hi, ops._prep_x(xl, a.n_cols, a.x_pages),
        chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
        window_pages=a.window_pages, unit_segments=a.unit_segments,
        hack_units=units, tile_page=a.tile_page).reshape(-1)[: a.n_rows]
    tol = 1e-12 if dtype == "float64" else 1e-5
    scale = float(zp.abs().max())
    torch.testing.assert_close(z, zp, rtol=0 if units is not None else tol,
                               atol=tol * scale)
    golden = coo.spmv(x.astype(np.float64))
    got = a.extract(z, dtype=torch.float64).cpu().numpy()
    np.testing.assert_allclose(got, golden, rtol=0,
                               atol=(1e-12 if dtype == "float64" else 2e-5)
                               * np.abs(golden).max())


@pytest.mark.cuda
def test_classic_past_the_page_field(cuda_device):
    """#15 on the fp32 classic layout past 65,536 x pages."""
    coo = _typed(_tridiagonal_9m(), np.float32)
    a = coo_to_whell(coo, device=cuda_device, packed=False)
    _past_the_field(a)
    x = np.random.default_rng(1).standard_normal(coo.n_cols).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda_device)
    before = kc.LAUNCHES
    z = ops.whell_spmv(a, xt)
    torch.cuda.synchronize()
    assert kc.LAUNCHES == before + 1
    zp = ops._classic_rows(a, kc.whell_classic_spmv_plain(
        a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
        ops._prep_x(xt, a.n_cols, a.x_pages), num_groups=a.num_groups,
        tile_page=a.tile_page).view(-1))
    torch.testing.assert_close(z, zp, rtol=1e-5, atol=1e-5 * float(zp.abs().max()))
    golden = coo.spmv(x.astype(np.float64))
    np.testing.assert_allclose(z.double().cpu().numpy(), golden, rtol=2e-5,
                               atol=2e-5 * np.abs(golden).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_whdia_past_the_page_field(dtype, cuda_device):
    """#3 (fp32, the warp pass over the live slots) and #6 (float64, the
    tile pass) on a 9M-column WHDIA layout."""
    coo = _typed(_tridiagonal_9m(), dtype)
    a = coo_to_whdia(coo, device=cuda_device)
    _past_the_field(a)
    x = np.random.default_rng(2).standard_normal(coo.n_cols).astype(dtype)
    xt = torch.from_numpy(x).to(cuda_device)
    counter = "LAUNCHES_F64" if dtype == "float64" else "LAUNCHES"
    before = getattr(kd, counter)
    z = ops.whdia_spmv(a, xt)
    torch.cuda.synchronize()
    assert getattr(kd, counter) == before + 1
    zp = kd.whdia_spmv_plain(a.values, a.slot_r0, a.tile_r0, a.tile_base,
                             a.chunk_group, xt, chunk_tiles=a.chunk_tiles,
                             group_hacks=a.group_hacks, num_groups=a.num_groups,
                             tile_page=a.tile_page)[: a.n_rows]
    tol = 1e-12 if dtype == "float64" else 1e-5
    torch.testing.assert_close(z, zp, rtol=tol, atol=tol * float(zp.abs().max()))
    golden = coo.spmv(x.astype(np.float64))
    np.testing.assert_allclose(z.double().cpu().numpy(), golden, rtol=0,
                               atol=(1e-12 if dtype == "float64" else 2e-5)
                               * np.abs(golden).max())


# --- the distributed layer: each shard's product, and NCCL at one rank ----

def _dist_system(kind):
    """A 4-shard partition of the 4,000-row FEM fixture in ``kind``'s
    type (complex: ``+ 1j·N(0, 1)``), packed or (``classic``) classic."""
    from spgpu_tpu_torch.parallel import partition_coo_rows_packed, partition_coo_rows_whell

    coo = CASES["fem"]()
    if kind == "classic":
        return coo, partition_coo_rows_whell(coo, 4)
    v = coo.values.astype(np.float64)
    if kind.startswith("complex"):
        v = v + 1j * np.random.default_rng(8).standard_normal(coo.nnz)
    coo = CooMatrix(coo.rows, coo.cols, v.astype(kind), coo.n_rows, coo.n_cols)
    return coo, partition_coo_rows_packed(coo, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "float64", "complex64", "complex128",
                                  "classic"])
def test_dist_shard_products_on_cuda(kind, cuda_device):
    """Each shard of a 4-shard partition, its halo taken from the global x
    by the plan: the overlapped product on the card (the exchange's side
    stream, the interior kernel, the exterior kernel into its prefix)
    launches one kernel for the interior and one for the exterior where
    the shard has one, and matches the same product's plain versions on
    the CPU and the golden rows."""
    from spgpu_tpu_torch.parallel.dist_spmv import _PlannedHalo as PlannedHalo

    coo, pm = _dist_system(kind)
    cplx = kind.startswith("complex")
    rng = np.random.default_rng(0)
    x = rng.standard_normal(coo.n_rows) + (1j * rng.standard_normal(coo.n_rows) if cplx else 0)
    x = x.astype(coo.values.dtype)
    g = coo.spmv(x.astype(np.complex128 if cplx else np.float64))
    mod, attr = (kc, "LAUNCHES") if kind == "classic" else (kw, {
        "float32": "LAUNCHES", "float64": "LAUNCHES_F64", "complex64": "LAUNCHES_C64",
        "complex128": "LAUNCHES_C128"}[kind])
    frac = 1e-12 if kind in ("float64", "complex128") else 1e-5
    exteriors = 0
    for s in range(4):
        h, plain = PlannedHalo(pm, s, cuda_device), PlannedHalo(pm, s, "cpu")
        before = getattr(mod, attr)
        z = h.matvec(h.set_x(x))
        torch.cuda.synchronize()
        assert getattr(mod, attr) - before == 1 + (h.exterior is not None)
        exteriors += h.exterior is not None
        zp = plain.matvec(plain.set_x(x))
        rows = g[pm.rows_of(s)]
        _near(z.cpu(), zp, frac, rtol=0 if frac < 1e-6 else 1e-5)
        _near(pm.extract_shard(z, s).cpu(), torch.from_numpy(rows),
              frac if frac < 1e-6 else 2e-5)
    assert exteriors >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "float64", "complex64", "complex128",
                                  "classic"])
def test_dist_shard_product_captured_in_a_graph(kind, cuda_device):
    """The overlapped schedule of each shard of a 4-shard partition (the
    side stream's fork and join, the send-lane gathers, the halo placed in
    the workspace, the interior kernel and the exterior kernel into its
    prefix), its halo taken from the plan, captured in one CUDA graph and
    replayed on a new x copied into the captured block and halo: equal to
    the eager product of the same x, bit for bit where the kernel gives
    the same bits every call (the packed partitions: #1, #4, #7,
    complex128), else within 1e-5·max|z| (classic: #15's atomics)."""
    from spgpu_tpu_torch.parallel.dist_spmv import _PlannedHalo as PlannedHalo

    coo, pm = _dist_system(kind)
    cplx = kind.startswith("complex")
    rng = np.random.default_rng(3)

    def draw():
        v = rng.standard_normal(coo.n_rows)
        return (v + 1j * rng.standard_normal(coo.n_rows) if cplx else v).astype(
            coo.values.dtype)

    exact = kind != "classic"
    for s in range(4):
        h = PlannedHalo(pm, s, cuda_device)
        xl = h.set_x(draw())
        side = torch.cuda.Stream(cuda_device)
        side.wait_stream(torch.cuda.current_stream(cuda_device))
        with torch.cuda.stream(side):
            h.matvec(xl)  # loads what the product reaches before the capture
        torch.cuda.current_stream(cuda_device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            z = h.matvec(xl)
        x2 = draw()
        xl.copy_(h.set_x(x2))
        graph.replay()
        torch.cuda.synchronize()
        want = h.matvec(h.set_x(x2))
        if exact:
            assert torch.equal(z, want), s
        else:
            _near(z.cpu(), want.cpu(), 1e-5)
        del graph


@pytest.mark.cuda
def test_dist_cg_world_one_graphed_equals_eager(cuda_device):
    """``dist_cg`` on one NCCL rank (a process of its own): the step's
    ``all_reduce``s and the product captured in the loop's CUDA graph; in
    float64 (#4) the graphed solve equals its eager witness bit for bit,
    and every iteration launches #4."""
    from spgpu_tpu_torch.parallel import partition_coo_rows_packed, run_ranks

    coo = laplacian_2d(64, 64, np.float64)
    b = np.random.default_rng(1).standard_normal(coo.n_rows)
    pm = partition_coo_rows_packed(coo, 1)
    kw_ = dict(b=b, tol=1e-10, maxiter=2000)
    graphed, eager = run_ranks(1, "spgpu_tpu_torch.parallel.dryrun:run_cases",
                               [("cg", pm, kw_), ("cg", pm, dict(kw_, eager=True))],
                               device="cuda")[0]
    assert graphed["converged"] and graphed["iterations"] == eager["iterations"]
    assert np.array_equal(graphed["x"], eager["x"])
    assert graphed["launches"]["whell.LAUNCHES_F64"] >= graphed["iterations"]
    r = b - coo.spmv(graphed["x"])
    assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex128"])
def test_dist_solve_on_every_card(dtype, cuda_device):
    """One NCCL rank on each card of the host (two at least): the exact-
    count exchange at its width, overlapped with the interior product,
    captured with the ``all_reduce``s in the loop's CUDA graph.  The
    product matches the golden; CG converges to its true residual and, in
    float64 and complex128 (#4 and its complex128 kernel give the same
    bits every call), equals its eager witness bit for bit."""
    from spgpu_tpu_torch.parallel import partition_coo_rows_packed, run_ranks

    W = torch.cuda.device_count()
    if W < 2:
        pytest.skip("needs two CUDA devices: NCCL runs no two ranks on one card")
    coo = laplacian_2d(48, 16 * W, np.float64)
    if dtype == "complex128":  # Hermitian positive-definite
        coo = CooMatrix(coo.rows, coo.cols, coo.values * (1 + 0j), coo.n_rows, coo.n_cols)
        up = coo.rows < coo.cols
        v = coo.values.copy()
        v[up] += 0.1j
        v[coo.rows > coo.cols] -= 0.1j
        v[coo.rows == coo.cols] += 1.0  # diagonally dominant: positive-definite
        coo = CooMatrix(coo.rows, coo.cols, v, coo.n_rows, coo.n_cols)
    coo = CooMatrix(coo.rows, coo.cols, coo.values.astype(dtype), coo.n_rows, coo.n_cols)
    rng = np.random.default_rng(2)
    b = rng.standard_normal(coo.n_rows).astype(dtype)
    pm = partition_coo_rows_packed(coo, W)
    assert sum(c > 0 for row in pm.halo_counts for c in row) >= W - 1
    tol = 1e-5 if dtype == "float32" else 1e-10
    kw_ = dict(b=b, tol=tol, maxiter=4000)
    z, graphed, eager = run_ranks(W, "spgpu_tpu_torch.parallel.dryrun:run_cases",
                                  [("spmv", pm, dict(x=b)), ("cg", pm, kw_),
                                   ("cg", pm, dict(kw_, eager=True))])[0]
    wide = np.complex128 if dtype == "complex128" else np.float64
    g = coo.spmv(b.astype(wide))
    frac = 2e-5 if dtype == "float32" else 1e-12
    assert np.abs(z - g).max() <= frac * np.abs(g).max()
    assert graphed["converged"]
    r = b - coo.spmv(graphed["x"].astype(wide))
    assert np.linalg.norm(r) <= (1e-4 if dtype == "float32" else 1e-9) * np.linalg.norm(b)
    if dtype == "float32":
        assert abs(graphed["iterations"] - eager["iterations"]) <= max(
            1, eager["iterations"] // 10)
    else:
        assert graphed["iterations"] == eager["iterations"]
        assert np.array_equal(graphed["x"], eager["x"])


@pytest.mark.cuda
def test_dryrun_on_one_cuda_rank(cuda_device):
    """The port's dry run on one NCCL rank: every case at its golden."""
    from spgpu_tpu_torch.parallel.dryrun import dryrun

    recs = dryrun(1, "cuda")
    assert all(r["ok"] for r in recs), recs


# --------------------------------------------------------------------------
# the classic layouts (plain torch on the card) and the hybrid split

#: classic layout -> its converter (to the card)
CLASSIC = {
    "ell": lambda c, d: _conv.coo_to_ell(c, device=d),
    "oell": lambda c, d: _conv.ell_to_oell(_conv.coo_to_ell(c, device="cpu"), device=d),
    "hell": lambda c, d: _conv.coo_to_hell(c, device=d),
    "dia": lambda c, d: _conv.coo_to_dia(c, device=d),
    "hdia": lambda c, d: _conv.coo_to_hdia(c, device=d),
    "bcoo": lambda c, d: _conv.coo_to_bcoo(c, 8, 8, device=d),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64", "complex128"])
@pytest.mark.parametrize("fmt", sorted(CLASSIC))
def test_classic_ops_keep_the_cuda_device(fmt, dtype, cuda_device):
    """Each classic op given CUDA tensors computes on the card: the result
    lies on it, at the golden and at the same op on the CPU (fp32 and
    complex64 2e-5, float64 and complex128 1e-12, times max|z|)."""
    c = CASES["irregular"]()
    coo = _complex(c, dtype) if "complex" in dtype else CooMatrix(
        c.rows, c.cols, c.values.astype(dtype), c.n_rows, c.n_cols)
    x = (_cvec(coo.n_cols, 3) if "complex" in dtype else
         np.random.default_rng(3).standard_normal(coo.n_cols)).astype(dtype)
    a = CLASSIC[fmt](coo, cuda_device)
    assert a.device.type == "cuda"
    z = ops.spmv(a, torch.from_numpy(x).to(cuda_device), 1.7)
    assert z.device.type == "cuda"
    g = 1.7 * coo.spmv(x.astype(np.complex128 if "complex" in dtype else np.float64))
    frac = 2e-5 if dtype in ("float32", "complex64") else 1e-12
    assert np.abs(z.cpu().numpy() - g).max() <= frac * np.abs(g).max()
    zc = ops.spmv(a.to("cpu"), torch.from_numpy(x), 1.7)
    assert np.abs(z.cpu().numpy() - zc.numpy()).max() <= frac * np.abs(g).max()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["ell", "hell"])
def test_csput_on_cuda(fmt, cuda_device):
    c = CASES["irregular"]()
    a = CLASSIC[fmt](c, cuda_device)
    sel = np.random.default_rng(2).choice(c.nnz, size=10, replace=False)
    v = np.random.default_rng(3).standard_normal(10).astype(np.float32)
    put = ops.ell_csput if fmt == "ell" else ops.hell_csput
    got = put(a, c.rows[sel], c.cols[sel], v, alpha=2.0)
    assert got.values.device.type == "cuda"
    want = put(a.to("cpu"), c.rows[sel], c.cols[sel], v, alpha=2.0)
    assert torch.equal(got.values.cpu(), want.values)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_hybrid_launches_each_kernel_once(dtype, cuda_device):
    """One hybrid product launches the WHDIA kernel (#3, #6 in float64)
    once and the packed WHELL kernel (#1, #4) once, gives the same bits
    twice, and agrees with the plain path on the CPU (rtol 1e-5, atol
    1e-5·max|z|; float64 1e-12·max|z|) and the golden."""
    mix = random_mixed(1 << 14, bands=9, wander=3, extra_avg=4.0, span=500,
                       far_frac=0.02, seed=1, dtype=np.dtype(dtype))
    h = _conv.coo_to_hybrid(mix, device=cuda_device)
    assert h.band is not None and h.rest is not None
    x = np.random.default_rng(4).standard_normal(mix.n_rows).astype(dtype)
    xt = torch.from_numpy(x).to(cuda_device)
    counter = "LAUNCHES" if dtype == "float32" else "LAUNCHES_F64"
    setattr(kd, counter, 0)
    setattr(kw, counter, 0)
    z = ops.hybrid_spmv(h, xt)
    torch.cuda.synchronize()
    assert (getattr(kd, counter), getattr(kw, counter)) == (1, 1)
    assert torch.equal(ops.hybrid_spmv(h, xt), z)
    zc = ops.hybrid_spmv(h.to("cpu"), torch.from_numpy(x))
    g = mix.spmv(x.astype(np.float64))
    frac = 1e-5 if dtype == "float32" else 1e-12
    _near(z.cpu(), zc, frac, rtol=frac if dtype == "float32" else 0.0)
    assert np.abs(z.cpu().numpy() - g).max() <= 2 * frac * np.abs(g).max()


@pytest.mark.cuda
def test_run_config_launches_kernel_1_with_no_fallback(cuda_device, monkeypatch):
    """The harness's ``run_config`` on packed WHELL launches #1 once in
    its checked product (the counters set to 0 just before it) and more
    in its timing, times it on the card, and its checksum is the host
    golden's within 1e-4; with the kernel library unloadable it raises
    instead of running the plain version."""
    from spgpu_tpu_torch.bench import harness

    coo = CASES["fem"]()
    args = ("fem", "whell_packed_k1", coo, lambda c, d: coo_to_whell(c, device=d),
            ops.whell_spmv, harness.whell_tensors)
    r = harness.run_config(*args, iters=3)
    assert r.launches == {"whell.LAUNCHES": 1} and kw.LAUNCHES > 1
    assert r.t_source in ("profiler", "cuda_events")
    assert r.device == torch.cuda.get_device_name(0)
    assert abs(r.checksum - r.golden_checksum) <= 1e-4 * r.golden_checksum

    class Unloadable:
        def load(self):
            raise RuntimeError("kernel library not built")
    monkeypatch.setattr(kw, "_LIB", Unloadable())
    with pytest.raises(RuntimeError, match="not built"):
        harness.run_config(*args, iters=3)


@pytest.mark.cuda
def test_product_after_set_stream_runs_on_that_stream(cuda_device):
    """``Context.set_stream(s)`` makes ``s`` current: a #1 product issued
    after it, behind a long sleep and a copy of the new x on ``s``, reads
    the new x (a product on any other stream would read the old one) and
    matches the golden; ``set_stream(None)`` restores the default stream
    and ``destroy`` succeeds."""
    from spgpu_tpu_torch import core

    ctx = core.create(0)
    coo = CASES["fem"]()
    a = coo_to_whell(coo, device=ctx.device)
    rng = np.random.default_rng(2)
    x_old, x_new = (rng.standard_normal(coo.n_cols).astype(np.float32) for _ in range(2))
    xl = a.embed(torch.from_numpy(x_old), torch.float32)
    new = a.embed(torch.from_numpy(x_new), torch.float32)
    torch.cuda.synchronize()
    s = ctx.stream_create()
    assert ctx.set_stream(s) == core.Status.SUCCESS
    try:
        assert ctx.get_stream() == s
        torch.cuda._sleep(50_000_000)
        xl.copy_(new)
        z = ops.whell_spmv(a, xl)
    finally:
        ctx.set_stream(None)
    assert ctx.get_stream() == torch.cuda.default_stream(ctx.device)
    s.synchronize()
    golden = coo.spmv(x_new.astype(np.float64))
    np.testing.assert_allclose(a.extract(z, torch.float64).cpu().numpy(), golden,
                               rtol=2e-5, atol=2e-5 * np.abs(golden).max())
    assert core.destroy(ctx) == core.Status.SUCCESS


@pytest.mark.cuda
def test_harness_blas1_and_weak_scaling_rows_on_cuda(cuda_device):
    """The BLAS-1 rows carry device times with their source and a
    roofline share where the card is in the bandwidth table; the
    weak-scaling row at S = 1 (one NCCL rank) is at the golden and
    launched #1."""
    from spgpu_tpu_torch import core
    from spgpu_tpu_torch.bench import run_blas1_suite, run_weak_scaling

    rows = run_blas1_suite(1 << 16, iters=5)
    assert [r["op"] for r in rows] == ["dot", "nrm2", "asum", "amax", "axpby"]
    for r in rows:
        assert r["t_source"] in ("profiler", "cuda_events") and r["t_avg_s"] > 0
        assert (r["roofline_frac"] is None) == (core.hbm_bandwidth() is None)
    (ws,) = run_weak_scaling(4096, shards=(1,), iters=3, out=None)
    assert ws["max_rel_err"] <= 2e-5 and ws["launches"] == {"whell.LAUNCHES": 1}
    assert ws["halo_slots_sent"] == ws["halo_lanes_used"] == 0
