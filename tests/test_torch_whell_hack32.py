"""PyTorch port: kernels #1 (fp32 and bf16 values) and #7 (complex64) on
the hack pass, through their plain versions on the CPU.

Every packed-WHELL SpMV runs the hack pass, so the wrapper
``kernels.whell.whell_packed_spmv`` runs the per-hack form of
``whell_packed_spmv_plain`` on CPU tensors, given the layout's work units
(``hack_units``; without them it raises on every device, which
``tests/test_torch_hack_runs.py`` checks for every type): each hack's run, tile
by tile and slot by slot, a chunked run's chunks in chunk order, then
the flush; every cell multiplied, zero-valued ones too.  That form is
held

* to the JAX op (``spgpu_tpu.ops.whell_spmv``, its Pallas kernel in
  interpret mode) on the irregular matrix, the JAX layout carried across
  by the bridges;
* to the tile-pass plain product (every tile added into its hack row, as
  the JAX kernels do) and the host golden on the irregular matrix, the
  hub rows of ``tests/test_torch_cuda.py`` (one run cut into chunks of
  work units), the empty matrix and the SPD system of ``solve()``'s
  default route;

at the tolerances of ``ROADMAP.md`` "Tolerances": fp32 and bf16 rtol
2e-5 and atol 2e-5·max(max|z|, 1) (bf16 against the golden of its
rounded values), complex64 3e-5·max|z|.  ``solve()`` in fp32 and complex64 on the CPU keeps the
iterations of the same solve on the tile-pass product, within one, and
its x within 1e-4·max|x|.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu import ops as jops  # noqa: E402
from spgpu_tpu.convert.whell import coo_to_whell as j_coo_to_whell  # noqa: E402
from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.utils import fixtures as jfix  # noqa: E402
from spgpu_tpu_torch import ops as tops  # noqa: E402
from spgpu_tpu_torch.convert import coo_to_whell  # noqa: E402
from spgpu_tpu_torch.formats import whell as twhell  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.kernels import whell as kw  # noqa: E402
from spgpu_tpu_torch.solvers import solve  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)

#: value dtype -> (x's and z's torch dtype, the golden's numpy dtype)
TYPES = {"float32": (torch.float32, np.float64),
         "bfloat16": (torch.float32, np.float64),
         "complex64": (torch.complex64, np.complex128)}
#: ROADMAP "Tolerances": fp32 and bf16 2e-5 (rtol, and atol of
#: max(max|z|, 1)), complex64 3e-5·max|z|
TOL = {"float32": 2e-5, "bfloat16": 2e-5, "complex64": 3e-5}
ARRAYS = ("values", "residue", "page_tab", "tile_base", "chunk_group",
          "seg_lo", "seg_hi", "lane_of_row", "group_bases")
STATIC = ("n_rows", "n_cols", "num_hacks", "num_groups", "total_slots", "nnz",
          "x_pages", "window_pages", "orig_rows", "group_hacks", "chunk_tiles",
          "unit_segments")


def _hub_rows(f, n=160000, step=29, seed=3):
    """tests/test_torch_cuda.py's hub fixture: one hack's run of 40
    tiles, three chunks of work units."""
    b = f.random_banded(n, bands=5, wander=0, seed=seed, dtype=np.float64).sum_duplicates()
    rng = np.random.default_rng(seed)
    hub = np.arange(0, n, step)
    rows = np.r_[b.rows, np.zeros(hub.size, np.int64), hub]
    cols = np.r_[b.cols, hub, np.zeros(hub.size, np.int64)]
    vals = np.r_[b.values, rng.uniform(0.5, 1.5, 2 * hub.size)]
    return f.CooMatrix(rows, cols, vals, n, n).sum_duplicates()


def _spd_fem(f):
    """The SPD FEM-like system of tests/test_torch_solvers.py, which
    ``solve()`` routes to packed WHELL."""
    d = f.random_fem_like(1500, 10.0, span=120, far_frac=0.0, seed=12,
                          dtype=np.float32).to_dense()
    d = (d + d.T) / 2 + np.eye(1500) * (np.abs(d).sum(1).max() + 1)
    rows, cols = np.nonzero(d)
    return f.CooMatrix(rows, cols, d[rows, cols], 1500, 1500)


CASES = {
    "irregular": lambda f: f.random_irregular(1000, 1000, 9.0, seed=3, dtype=np.float32),
    "hub": _hub_rows,
    "empty": lambda f: f.CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                   np.zeros(0, np.float32), 300, 300),
    "spd_fem": _spd_fem,
}


def _values(coo, dtype):
    """``coo``'s values as stored in ``dtype``'s slab, in the golden's
    type: bf16-rounded for bf16, ``v + 1j·N(0, 1)`` (``default_rng(8)``)
    for complex64."""
    v = coo.values.astype(np.float64)
    if dtype == "complex64":
        v = v + 1j * np.random.default_rng(8).standard_normal(coo.nnz)
        return v.astype(np.complex64).astype(np.complex128)
    return torch.from_numpy(v).to(getattr(torch, dtype)).double().numpy()


def _x(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    if dtype == "complex64":
        x = x + 1j * rng.standard_normal(n)
    return torch.from_numpy(x).to(TYPES[dtype][0])


def _args(a, xl):
    return ((a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
             a.group_bases, a.seg_lo, a.seg_hi, tops._prep_x(xl, a.n_cols, a.x_pages)),
            dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                 window_pages=a.window_pages, unit_segments=a.unit_segments,
                 tile_page=a.tile_page))


def _near(got, want, frac, what=""):
    """Real: rtol ``frac``, atol ``frac``·max(max|want|, 1) (the flush's
    prefix differences carry an error of the hack's prefix total, not of
    the row's own sum); complex: atol ``frac``·max|want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = np.abs(want).max(initial=0.0)
    if np.iscomplexobj(want):
        np.testing.assert_allclose(got, want, rtol=0, atol=frac * max(scale, 1e-300),
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=frac, atol=frac * max(scale, 1.0),
                                   err_msg=what)


@pytest.mark.parametrize("dtype", sorted(TYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_product_is_the_per_hack_form(name, dtype):
    """With ``hack_units`` the wrapper runs the per-hack plain form (its
    raise without them is in ``tests/test_torch_hack_runs.py``), counts no
    launch, and is held to the tile-pass plain product and the golden."""
    coo = CASES[name](tfix)
    vals = _values(coo, dtype)
    a = coo_to_whell(CooMatrix(coo.rows, coo.cols, vals.astype(
        np.complex64 if dtype == "complex64" else np.float32), coo.n_rows, coo.n_cols),
        device="cpu", dtype="bfloat16" if dtype == "bfloat16" else None)
    assert a.values.dtype == getattr(torch, dtype)
    if name == "hub":
        assert int((a.hack_units[:, 3] >= 0).sum()) >= 3  # a chunked run
    x = _x(coo.n_cols, dtype)
    args, static = _args(a, a.embed(x, dtype=x.dtype))
    before = (kw.LAUNCHES, kw.LAUNCHES_C64)
    z = kw.whell_packed_spmv(*args, **static, hack_units=a.hack_units)
    assert (kw.LAUNCHES, kw.LAUNCHES_C64) == before
    assert z.dtype == x.dtype
    tile = kw.whell_packed_spmv_plain(*args, **static)
    _near(z.numpy(), tile.numpy(), TOL[dtype], "vs the tile-pass plain product")
    golden = CooMatrix(coo.rows, coo.cols, vals, coo.n_rows, coo.n_cols).spmv(
        x.numpy().astype(TYPES[dtype][1]))
    got = a.extract(z.reshape(-1)[: a.n_rows], dtype=torch.from_numpy(golden).dtype)
    _near(got.numpy(), golden, TOL[dtype], "vs the golden")


@pytest.mark.parametrize("dtype", sorted(TYPES))
def test_per_hack_form_matches_jax(dtype):
    """The irregular matrix's JAX layout (fp32, bf16 values, or complex64
    as two planes) through the JAX op in interpret mode and through the
    port's op on the bridged layout, which on the CPU is the per-hack
    plain form."""
    c = CASES["irregular"](jfix)
    if dtype == "complex64":
        vals = _values(c, dtype).astype(np.complex64)
        ja = j_coo_to_whell(JCoo(c.rows, c.cols, vals, c.n_rows, c.n_cols), packed=True)
        names = ARRAYS + ("values_lo", "row_perm")

        def fields(m):
            return {f: None if getattr(m, f, None) is None else np.asarray(getattr(m, f))
                    for f in names}
        ta = twhell.from_numpy_planes(fields(ja.ar), fields(ja.ai),
                                      **{f: getattr(ja.ar, f) for f in STATIC})
        x = _x(c.n_cols, dtype).numpy().astype(np.complex128)
        zj = ja.extract_complex(np.asarray(jops.whell_spmv(
            ja, jnp.asarray(ja.embed_complex(x)))))
        zt = ta.extract(tops.whell_spmv(ta, ta.embed(x, torch.complex64)),
                        torch.complex64).numpy()
    else:
        ja = j_coo_to_whell(c, packed=True,
                            **({"dtype": jnp.bfloat16} if dtype == "bfloat16" else {}))
        ta = twhell.from_numpy_fields(
            {f: None if getattr(ja, f) is None else np.asarray(getattr(ja, f))
             for f in ARRAYS}, **{f: getattr(ja, f) for f in STATIC})
        x = _x(c.n_cols, dtype).numpy()
        xl = np.array(ja.embed(jnp.asarray(x)))
        lor = np.asarray(ja.lane_of_row)
        zj = np.asarray(jops.whell_spmv(ja, jnp.asarray(xl)), np.float64)[lor]
        zt = tops.whell_spmv(ta, torch.from_numpy(xl)).double().numpy()[lor]
    assert ta.values.dtype == getattr(torch, dtype)
    _near(zt, zj, TOL[dtype], "vs JAX")
    golden = CooMatrix(c.rows, c.cols, _values(c, dtype), c.n_rows, c.n_cols).spmv(
        x.astype(TYPES[dtype][1]))
    _near(zt, golden, TOL[dtype], "vs the golden")


def _solve_system(dtype):
    """fp32: the SPD FEM system; complex64: the Hermitian positive-definite
    tridiagonal of tests/test_torch_solvers.py; with its ``b``."""
    rng = np.random.default_rng(0)
    if dtype == "float32":
        coo = _spd_fem(tfix)
        coo = CooMatrix(coo.rows, coo.cols, coo.values.astype(np.float32), coo.n_rows,
                        coo.n_cols)
        return coo, rng.standard_normal(coo.n_rows).astype(np.float32)
    n = 300
    off = (rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1)) * 0.5
    rows = np.r_[np.arange(n), np.arange(n - 1), np.arange(1, n)]
    cols = np.r_[np.arange(n), np.arange(1, n), np.arange(n - 1)]
    vals = np.r_[np.full(n, 6.0 + 0j), off, np.conj(off)].astype(np.complex64)
    b = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    return CooMatrix(rows, cols, vals, n, n), b


@pytest.mark.parametrize("dtype", ["float32", "complex64"])
def test_solve_keeps_its_iterations(dtype, monkeypatch):
    """CG through ``solve()``'s default route (packed WHELL) on the CPU: the
    per-hack product against the same solve on the tile-pass product,
    the iterations within one and x within 1e-4·max|x|; the true
    residual within 1e-4."""
    coo, b = _solve_system(dtype)
    kwargs = dict(device="cpu", fmt="whell", symmetric=True, tol=1e-5, maxiter=2000)
    per_hack = solve(coo, b, **kwargs)

    def tile_pass(*args, hack_units=None, **static):
        return kw.whell_packed_spmv_plain(*args, **static)
    monkeypatch.setattr(tops, "whell_packed_spmv", tile_pass)
    tiles = solve(coo, b, **kwargs)
    assert bool(per_hack.converged) and bool(tiles.converged)
    assert abs(per_hack.iterations - tiles.iterations) <= 1
    x = per_hack.x.numpy()
    assert x.dtype == coo.values.dtype
    np.testing.assert_allclose(x, tiles.x.numpy(), rtol=0, atol=1e-4 * np.abs(x).max())
    wide = x.astype(np.complex128 if dtype == "complex64" else np.float64)
    assert np.linalg.norm(b - coo.spmv(wide)) <= 1e-4 * np.linalg.norm(b)
