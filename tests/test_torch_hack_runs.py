"""PyTorch port: the hack runs of packed WHELL layouts
(``WhellMatrix.hack_ptr``) and the per-hack form of the float64 and
complex128 products (kernel #4 and the complex128 kernel), against the
JAX package.

* ``hack_ptr`` covers every tile but each output group's padding tail
  exactly once, contiguously, on every WHELL fixture of
  ``tests/test_torch_convert.py``, aligned and scattered, in float32 and
  float64; the witness walks the tiles in a Python loop;
* the JAX converter's layouts, bridged through ``from_numpy_fields``, get
  the same runs as the port's own;
* ``check()`` rejects a run moved out of place and a nonzero padding
  tile;
* the work units of the hack pass (``WhellMatrix.hack_units``) cut each
  run longer than ``RUN_CHUNK_TILES`` into chunks and give every other
  output row one unit;
* the per-hack plain product (``whell_packed_spmv_plain(...,
  hack_units=...)``: each hack's run, tile by tile and slot by slot, its
  chunks in order, then the flush) matches the tile-sums-plus-flush plain product and the JAX
  double-float op (interpret mode) within 1e-12·max|z|, in float64 and
  complex128, on the heavy-row fixture of
  ``tests/test_torch_f64.py::test_whell_f64_flush_heavy_row_in_a_light_hack``
  too;
* an Inf in x that only skipped padding tiles read leaves the per-hack
  product at the golden, where the full-layout product (and the JAX
  kernel, which multiplies padding tiles) gives NaN;
* float64 and complex128 layouts take scattered windows by default.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu import ops as jops  # noqa: E402
from spgpu_tpu.convert.whell import coo_to_whell as j_coo_to_whell  # noqa: E402
from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.ops import dd  # noqa: E402
from spgpu_tpu.utils import fixtures as jfix  # noqa: E402
from spgpu_tpu_torch import ops as tops  # noqa: E402
from spgpu_tpu_torch.convert import coo_to_whell  # noqa: E402
from spgpu_tpu_torch.formats import whell as twhell  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.kernels import whell as kw  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)

#: tests/test_torch_convert.py's WHELL fixtures, in a given value type
CASES = {
    "fem": lambda f, dt: f.random_fem_like(4000, 16.0, span=256, far_frac=0.02,
                                           seed=5, dtype=dt),
    "laplace": lambda f, dt: f.laplacian_2d(23, 31, dt),
    "laplace_wide": lambda f, dt: f.laplacian_2d(200, 30, dt),
    "irregular": lambda f, dt: f.random_irregular(1000, 1000, 9.0, seed=3, dtype=dt),
    "banded": lambda f, dt: f.random_banded(900, bands=7, wander=13, seed=4, dtype=dt),
    "ctest": lambda f, dt: f.ctest_fixture(dt),
    "empty": lambda f, dt: f.CooMatrix(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                       np.zeros(0, dt), 300, 300),
}
ARRAYS = ("residue", "page_tab", "tile_base", "chunk_group", "seg_lo", "seg_hi",
          "lane_of_row", "group_bases")
STATIC = ("n_rows", "n_cols", "num_hacks", "num_groups", "total_slots", "nnz",
          "x_pages", "window_pages", "orig_rows", "group_hacks", "chunk_tiles",
          "unit_segments")
#: float64 against a double-float pair (~48 bits) and between two orders
#: of float64 sums: a fraction of max|z|
TOL = 1e-12


def near(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(initial=0.0), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=what)


def walk_runs(a):
    """The witness: walk each output group's tiles in order; the hacks are
    non-decreasing until the padding tail, whose first tile is the first
    descent.  Returns (runs {hack: [tiles]}, padding tiles)."""
    meta = a.tile_base.numpy().astype(np.int64)
    cg = a.chunk_group.numpy().astype(np.int64)
    shift = 20 if a.scattered else 16
    runs, padding = {}, []
    prev_group, prev_hack, tail = None, None, False
    for t in range(a.num_tiles):
        g = cg[t // a.chunk_tiles]
        hack = g * a.group_hacks + (meta[t] >> shift)
        if g != prev_group:
            tail = False
        elif hack < prev_hack:
            tail = True
        prev_group, prev_hack = g, hack
        if tail or hack >= a.num_hacks:
            padding.append(t)
        else:
            runs.setdefault(hack, []).append(t)
    return runs, padding


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("scattered", [False, True], ids=["aligned", "scattered"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_hack_runs_cover_every_tile_but_the_padding_tail(name, scattered, dtype):
    a = coo_to_whell(CASES[name](tfix, np.dtype(dtype)), device="cpu",
                     scattered=scattered)
    hp = a.hack_ptr
    assert hp.dtype == torch.int32 and tuple(hp.shape) == (a.num_hacks, 2)
    runs, padding = walk_runs(a)
    for h in range(a.num_hacks):
        b, e = (int(v) for v in hp[h])
        want = runs.get(h, [])
        assert list(range(b, e)) == want, h  # contiguous, in tile order
    covered = sorted(t for r in runs.values() for t in r)
    assert sorted(covered + padding) == list(range(a.num_tiles))  # once each
    # the padding is each group's tail of zero tiles, shorter than a chunk
    vals = a.values.view(a.num_tiles, -1)
    assert not bool(vals[padding].ne(0).any())
    cg = a.chunk_group.numpy()[np.asarray(padding, np.int64) // a.chunk_tiles]
    for g in set(cg.tolist()):
        tail = np.asarray(padding)[cg == g]
        last = int(np.flatnonzero(a.chunk_group.numpy()[:-1] == g)[-1])
        assert tail.size < a.chunk_tiles
        assert tail.tolist() == list(range((last + 1) * a.chunk_tiles - tail.size,
                                           (last + 1) * a.chunk_tiles))
    a.check()


def _bridged(ja):
    return twhell.from_numpy_fields(
        {f: None if getattr(ja, f) is None else np.asarray(getattr(ja, f))
         for f in ARRAYS + ("values", "values_lo")},
        **{f: getattr(ja, f) for f in STATIC})


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["fem", "banded", "ctest", "empty"])
def test_jax_layouts_give_the_same_runs(name, dtype):
    """float32: the JAX default, scattered windows; float64: the JAX
    double-float layout, aligned windows, joined into float64 (an empty
    matrix builds aligned in both packages)."""
    ja = j_coo_to_whell(CASES[name](jfix, np.dtype(dtype)), packed=True)
    ta = coo_to_whell(CASES[name](tfix, np.dtype(dtype)), device="cpu",
                      scattered=dtype == "float32")
    tb = _bridged(ja)
    assert tb.scattered == ta.scattered == (dtype == "float32" and name != "empty")
    assert torch.equal(tb.hack_ptr, ta.hack_ptr)
    assert torch.equal(tb.hack_ptr, twhell.packed_hack_ptr(
        torch.from_numpy(np.asarray(ja.tile_base)),
        torch.from_numpy(np.asarray(ja.chunk_group)), group_hacks=ja.group_hacks,
        chunk_tiles=ja.chunk_tiles, num_hacks=ja.num_hacks,
        scattered=ja.group_bases is not None))


def _fem64():
    return coo_to_whell(CASES["fem"](tfix, np.float64), device="cpu")


def test_check_rejects_a_run_moved_out_of_place():
    """Swap the first tile of the first two runs of several tiles: each
    hack's tiles are then no longer one run."""
    a = _fem64()
    hp = a.hack_ptr
    t0, t1 = (int(hp[h, 0]) for h in np.flatnonzero((hp[:, 1] - hp[:, 0]).numpy() > 1)[:2])
    perm = torch.arange(a.num_tiles)
    perm[t0], perm[t1] = t1, t0
    cells = lambda v: v.view(a.num_tiles, 8, -1)[perm].reshape(v.shape)  # noqa: E731
    b = dataclasses.replace(a, values=cells(a.values), residue=cells(a.residue),
                            page_tab=cells(a.page_tab), tile_base=a.tile_base[perm])
    with pytest.raises(ValueError, match="run"):
        b.check()


def test_check_rejects_a_nonzero_padding_tile():
    a = _fem64()
    _, padding = walk_runs(a)
    assert padding
    vals = a.values.clone()
    vals[padding[-1] * 8 + 3, 17] = 1.0
    with pytest.raises(ValueError, match="nonzero"):
        dataclasses.replace(a, values=vals).check()


def _products(a, x):
    """(per-hack plain, tile-sums-plus-flush plain) on lane-space x."""
    args = (a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
            a.group_bases, a.seg_lo, a.seg_hi, tops._prep_x(x, a.n_cols, a.x_pages))
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  window_pages=a.window_pages, unit_segments=a.unit_segments)
    return (kw.whell_packed_spmv_plain(*args, **static, hack_units=a.hack_units),
            kw.whell_packed_spmv_plain(*args, **static))


def _cvalues(coo, seed=8):
    rng = np.random.default_rng(seed)
    return coo.values.astype(np.float64) + 1j * rng.standard_normal(coo.nnz)


@pytest.mark.parametrize("scattered", [False, True], ids=["aligned", "scattered"])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("name", ["fem", "irregular", "laplace_wide", "empty"])
def test_per_hack_plain_matches_the_tile_pass_plain(name, dtype, scattered):
    c = CASES[name](tfix, np.float64)
    if dtype == "complex128":
        c = CooMatrix(c.rows, c.cols, _cvalues(c), c.n_rows, c.n_cols)
    a = coo_to_whell(c, device="cpu", scattered=scattered)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(c.n_cols) + (1j * rng.standard_normal(c.n_cols)
                                         if dtype == "complex128" else 0)
    xl = a.embed(x, getattr(torch, dtype))
    z_hack, z_tile = _products(a, xl)
    assert z_hack.dtype == getattr(torch, dtype)
    near(z_hack.numpy(), z_tile.numpy(), "per hack vs tile pass")
    near(a.extract(z_hack.reshape(-1)[: a.n_rows], getattr(torch, dtype)).numpy(),
         c.spmv(x), "per hack vs golden")


def heavy_row():
    """tests/test_torch_f64.py's heavy-row fixture: a row of 1e6-sized
    values heads a hack of rows of unit-sized values."""
    rng = np.random.default_rng(4)
    n = 512
    rows, cols, vals = [], [], []
    for r in range(n):
        k = 96 if r == 0 else 4
        c = rng.choice(n, size=k, replace=False)
        rows += [r] * k
        cols += c.tolist()
        vals += (rng.uniform(1, 2, k) * (1e6 if r == 0 else 1.0)).tolist()
    return np.array(rows), np.array(cols), np.array(vals, np.float64), n, rng


@pytest.mark.parametrize("case", ["fem", "heavy_row"])
def test_per_hack_plain_matches_jax_dd(case):
    """float64: the JAX double-float op (kernel #4 in interpret mode) on
    its own layout, bridged; the per-hack and tile-pass products on it."""
    if case == "heavy_row":
        rows, cols, vals, n, rng = heavy_row()
        jc, x = JCoo(rows, cols, vals, n, n), rng.uniform(0.5, 1.5, n)
    else:
        jc = CASES["fem"](jfix, np.float64)
        x = np.random.default_rng(3).standard_normal(jc.n_cols)
    ja = j_coo_to_whell(jc, packed=True)
    ta = _bridged(ja)
    lor = np.asarray(ja.lane_of_row)
    xl = np.zeros(ja.n_rows)
    xl[lor] = x
    zj = dd.join(np.asarray(jops.whell_spmv(ja, jnp.asarray(dd.split(xl)))))
    z_hack, z_tile = _products(ta, torch.from_numpy(xl))
    near(z_hack.reshape(-1).numpy()[lor], zj[lor], "per hack vs JAX dd")
    near(z_tile.reshape(-1).numpy()[lor], zj[lor], "tile pass vs JAX dd")
    near(z_hack.reshape(-1).numpy()[lor], jc.spmv(x), "per hack vs golden")


def test_per_hack_plain_matches_jax_complex128():
    """complex128: the JAX package's four double-float plane products of
    #4 (interpret mode) on its two-plane layout, bridged into one complex
    slab."""
    c = CASES["ctest"](jfix, np.float64)
    v = _cvalues(c, 5)
    jc = JCoo(c.rows, c.cols, v, c.n_rows, c.n_cols)
    ja = j_coo_to_whell(jc, packed=True)
    ta = twhell.from_numpy_planes(
        {f: None if getattr(ja.ar, f, None) is None else np.asarray(getattr(ja.ar, f))
         for f in ARRAYS + ("values", "values_lo")},
        {f: None if getattr(ja.ai, f, None) is None else np.asarray(getattr(ja.ai, f))
         for f in ARRAYS + ("values", "values_lo")},
        **{f: getattr(ja.ar, f) for f in STATIC})
    rng = np.random.default_rng(6)
    x = rng.standard_normal(c.n_cols) + 1j * rng.standard_normal(c.n_cols)
    zj = ja.extract_complex(np.asarray(jops.whell_spmv(
        ja, jnp.asarray(ja.embed_complex(x)))))
    z_hack, z_tile = _products(ta, ta.embed(x, torch.complex128))
    zh = ta.extract(z_hack.reshape(-1)[: ta.n_rows], torch.complex128).numpy()
    zt = ta.extract(z_tile.reshape(-1)[: ta.n_rows], torch.complex128).numpy()
    near(zh, zj, "per hack vs JAX planes")
    near(zt, zj, "tile pass vs JAX planes")
    near(zh, jc.spmv(x), "per hack vs golden")


def padding_only_column(a):
    """A lane-space column that tiles outside every run read and no cell
    of a run's tiles reads, or None."""
    _, padding = walk_runs(a)
    res = a.residue.long()
    d = torch.gather(a.page_tab.long(), 1, res)
    meta = a.tile_base.long()[torch.arange(a.total_slots) // 8, None]
    if a.scattered:
        K = a.window_pages // 8
        page = a.group_bases.long()[(meta & 0xFFFFF) * K + (d >> 3)] + (d & 7)
    else:
        page = (meta & 0xFFFF) + d
    col = (page * 128 + res).view(a.num_tiles, -1)
    live = torch.ones(a.num_tiles, dtype=torch.bool)
    live[padding] = False
    only = set(col[~live].unique().tolist()) - set(col[live].unique().tolist())
    return min(only) if only else None


def far_columns(n=12000, lo=6000, deg=9, seed=11):
    """Rows whose columns all lie in [lo, n): the first aligned windows of
    lane space hold no entry, so no run's tile reads them."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(lo, n, rows.size)
    return CooMatrix(rows, cols, rng.uniform(1, 2, rows.size), n, n).sum_duplicates()


def test_inf_read_only_by_padding_tiles_stays_out_of_the_per_hack_product():
    coo = far_columns()
    a = coo_to_whell(coo, device="cpu", scattered=False)
    col = padding_only_column(a)
    assert col == 0  # tests/test_torch_cuda.py puts its Inf there
    x = np.random.default_rng(0).standard_normal(coo.n_cols)
    xl = a.embed(x, torch.float64)
    xl[col] = float("inf")
    z_hack, z_tile = _products(a, xl)
    near(a.extract(z_hack.reshape(-1)[: a.n_rows], torch.float64).numpy(), coo.spmv(x))
    assert bool(z_tile.isnan().any())  # the full-layout product multiplies it


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_float64_and_complex128_default_to_scattered_windows(dtype):
    c = CASES["fem"](tfix, np.float64)
    if dtype == "complex128":
        c = CooMatrix(c.rows, c.cols, _cvalues(c), c.n_rows, c.n_cols)
    a = coo_to_whell(c, device="cpu")
    b = coo_to_whell(c, device="cpu", scattered=False)
    assert a.scattered and not b.scattered
    assert a.values.dtype == b.values.dtype == getattr(torch, dtype)
    assert (a.group_hacks, a.chunk_tiles) == (b.group_hacks, b.chunk_tiles)
    assert a.num_tiles < b.num_tiles


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_wrapper_takes_hack_units_for_float64_and_complex128(dtype):
    c = CASES["banded"](tfix, np.float64)
    if dtype == "complex128":
        c = CooMatrix(c.rows, c.cols, _cvalues(c), c.n_rows, c.n_cols)
    a = coo_to_whell(c, device="cpu")
    args = (a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
            a.group_bases, a.seg_lo, a.seg_hi,
            tops._prep_x(a.embed(np.ones(c.n_cols), getattr(torch, dtype)),
                         a.n_cols, a.x_pages))
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  window_pages=a.window_pages, unit_segments=a.unit_segments)
    with pytest.raises(ValueError, match="hack_units"):
        kw.whell_packed_spmv(*args, **static)
    with pytest.raises(ValueError, match="hack_units"):
        kw.whell_packed_spmv(*args, **static, hack_units=a.hack_units.long())
    z = kw.whell_packed_spmv(*args, **static, hack_units=a.hack_units)
    assert torch.equal(z, kw.whell_packed_spmv_plain(*args, **static,
                                                     hack_units=a.hack_units))


def test_work_units_cut_long_runs_into_chunks():
    from spgpu_tpu_torch.formats.whell import RUN_CHUNK_TILES, packed_hack_units

    hp = torch.tensor([[0, 3], [3, 40], [0, 0], [40, 41]], dtype=torch.int32)
    units = packed_hack_units(hp, 6)
    assert RUN_CHUNK_TILES == 16
    assert units.tolist() == [
        [0, 3, 0, -1], [3, 19, 1, 0 << 16 | 3], [19, 35, 1, 1 << 16 | 3],
        [35, 40, 1, 2 << 16 | 3], [0, 0, 2, -1], [40, 41, 3, -1],
        [0, 0, 4, -1], [0, 0, 5, -1]]


def hub_rows(n=160000, step=29, seed=3):
    """A 5-band matrix plus a hub row and column 0 that meet every
    ``step``-th column: the hub's hack has a run of 40 tiles (three chunks
    of work units), as the SPD flagship's hub rows have 75-83."""
    b = tfix.random_banded(n, bands=5, wander=0, seed=seed,
                           dtype=np.float64).sum_duplicates()
    rng = np.random.default_rng(seed)
    hub = np.arange(0, n, step)
    rows = np.r_[b.rows, np.zeros(hub.size, np.int64), hub]
    cols = np.r_[b.cols, hub, np.zeros(hub.size, np.int64)]
    vals = np.r_[b.values, rng.uniform(0.5, 1.5, 2 * hub.size)]
    return CooMatrix(rows, cols, vals, n, n).sum_duplicates()


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex128"])
def test_layout_keeps_no_run_counters(dtype):
    """Fault F2: a layout carries only what it derives from its arrays
    (``hack_ptr``, ``hack_units``), no per-product state such as the run
    counters of chunked runs, which each call of the hack pass allocates
    for itself; so products leave every tensor of the layout as it was."""
    c = hub_rows()
    v = _cvalues(c) if dtype == "complex128" else c.values.astype(dtype)
    a = coo_to_whell(CooMatrix(c.rows, c.cols, v, c.n_rows, c.n_cols), device="cpu")
    assert int((a.hack_units[:, 3] >= 0).sum()) >= 3
    fields = {f.name for f in dataclasses.fields(a)}
    assert "hack_done" not in fields and {"hack_ptr", "hack_units"} <= fields
    before = {f: getattr(a, f).clone() for f in fields
              if isinstance(getattr(a, f), torch.Tensor)}
    x = a.embed(np.ones(c.n_cols), a.values.dtype if dtype != "float32" else torch.float32)
    tops.whell_spmv(a, x)
    if dtype == "float32":
        tops.whell_spmm(a, torch.stack([x, 2 * x]))
    for f, t in before.items():
        assert torch.equal(getattr(a, f), t), f
    a.check()


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_chunked_runs_give_the_product(dtype):
    """A run cut into chunks: the per-unit plain product adds the chunks in
    order and matches the tile-pass plain product and the golden."""
    c = hub_rows()
    if dtype == "complex128":
        c = CooMatrix(c.rows, c.cols, _cvalues(c), c.n_rows, c.n_cols)
    a = coo_to_whell(c, device="cpu")
    a.check()
    chunks = a.hack_units[a.hack_units[:, 3] >= 0]
    assert chunks.shape[0] >= 3 and int(chunks[0, 3]) & 0xFFFF == chunks.shape[0]
    rng = np.random.default_rng(4)
    x = rng.standard_normal(c.n_cols) + (1j * rng.standard_normal(c.n_cols)
                                         if dtype == "complex128" else 0)
    z_hack, z_tile = _products(a, a.embed(x, getattr(torch, dtype)))
    near(z_hack.numpy(), z_tile.numpy(), "per hack vs tile pass")
    near(a.extract(z_hack.reshape(-1)[: a.n_rows], getattr(torch, dtype)).numpy(),
         c.spmv(x), "per hack vs golden")
