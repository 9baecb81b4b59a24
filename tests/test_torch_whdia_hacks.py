"""PyTorch port: the live-slot list of WHDIA layouts.

Every ``WhdiaMatrix`` derives ``hack_slot_ptr``/``hack_slots`` from its
values when it is built: the slots that hold a nonzero, grouped by hack
in tile and slot order.  Every WHDIA SpMV kernel (#3 fp32, #6 float64, #9
complex64, #10 complex128) and the fp32 SpMM (#13) read only those
slots.  Here, on the CPU:

* the list covers every nonzero, on the Laplacian (slab mode), a
  wandering band (pattern mode) and both with empty row blocks, in all
  four value types, and keeps tile order within a hack even where the
  hack's tiles are not contiguous;
* ``.to()``, ``dataclasses.replace`` and the bridges from the JAX arrays
  rebuild it, and ``check()`` rejects a stale one;
* the listed product (``whdia_spmm_listed_plain``, the kernels' order)
  matches the full-layout plain product (rtol 1e-5, atol 1e-5·max|z|;
  float64 and complex128 1e-12·max|z|) and the JAX op in interpret mode
  (fp32 the same; complex64 3e-5·max|z|, as
  ``tests/test_torch_complex.py``; float64 the double-float op and
  complex128 the Z op, bridged as ``tests/test_torch_f64.py`` and
  ``tests/test_torch_complex.py`` do, 1e-12·max|z|);
* an Inf in x at a column that only all-zero slots reach makes the full
  product NaN (the JAX semantics) and leaves the listed one at the golden.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu import ops as jops  # noqa: E402
from spgpu_tpu.convert.whdia import coo_to_whdia as j_coo_to_whdia  # noqa: E402
from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.ops import dd  # noqa: E402
from spgpu_tpu.utils import fixtures as jfix  # noqa: E402
from spgpu_tpu_torch import ops as tops  # noqa: E402
from spgpu_tpu_torch.convert import coo_to_whdia  # noqa: E402
from spgpu_tpu_torch.formats import whdia as twhdia  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.kernels import whdia as kd  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)


def _holes(c):
    """``c`` without the rows of every third hack (128-row block)."""
    keep = (c.rows // 128) % 3 != 1
    return type(c)(c.rows[keep], c.cols[keep], c.values[keep], c.n_rows, c.n_cols)


#: float64 fixtures and the r0 mode the port's converter gives them
CASES = {
    "laplace": (lambda f: f.laplacian_2d(40, 40), False),
    "banded": (lambda f: f.random_banded(2000, bands=11, wander=7, seed=2), True),
    "laplace_holes": (lambda f: _holes(f.laplacian_2d(40, 40)), False),
    "banded_holes": (lambda f: _holes(f.random_banded(2000, bands=11, wander=7,
                                                      seed=2)), True),
}
DTYPES = ("float32", "complex64", "float64", "complex128")
#: value type -> (atol/max|z| and rtol of the listed product against the
#: full plain one and the JAX op, atol/max|z| and rtol against the golden)
TOL = {"float32": (1e-5, 1e-5, 2e-5, 2e-5), "complex64": (1e-5, 1e-5, 2e-5, 0.0),
       "float64": (1e-12, 0.0, 1e-12, 0.0), "complex128": (1e-12, 0.0, 1e-12, 0.0)}
ARRAYS = ("values", "slot_r0", "tile_r0", "tile_base", "chunk_group")
STATIC = ("n_rows", "n_cols", "num_hacks", "num_groups", "total_slots", "nnz",
          "x_pages", "window_pages", "group_hacks", "chunk_tiles")


def _values(coo, dtype, seed=8):
    """``coo``'s values as ``dtype``; complex: ``v + 1j·N(0, 1)``."""
    v = coo.values.astype(np.float64)
    if dtype.startswith("complex"):
        v = v + 1j * np.random.default_rng(seed).standard_normal(coo.nnz)
    return v.astype(dtype)


def _coo(name, dtype, f=tfix):
    c = CASES[name][0](f)
    cls = CooMatrix if f is tfix else JCoo
    return cls(c.rows, c.cols, _values(c, dtype), c.n_rows, c.n_cols)


def _vec(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if dtype.startswith("complex"):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _slot_hacks(a):
    """Each slot's hack as the kernels decode it, ``(S,)`` int64."""
    return kd.whdia_tile_hacks(a.tile_base, a.chunk_group, a.chunk_tiles,
                               a.group_hacks).repeat_interleave(8)


def _listed(a, x):
    return kd.whdia_spmm_listed_plain(
        a.values, a.slot_r0, a.tile_r0, a.tile_base, a.hack_slot_ptr,
        a.hack_slots, x, group_hacks=a.group_hacks, num_groups=a.num_groups,
        tile_page=a.tile_page)


def _full(a, x):
    return kd.whdia_spmm_plain(
        a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group, x,
        chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
        num_groups=a.num_groups, tile_page=a.tile_page)


def _near(got, want, frac, rtol=0.0, what=""):
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=frac * np.abs(want).max(initial=0.0), err_msg=what)


def _assert_list(a):
    """The list is the live slots, each once, grouped by its decoded hack,
    ascending (tile order, then slot order) within each hack."""
    hacks = a.num_groups * a.group_hacks
    ptr, slots = a.hack_slot_ptr.long(), a.hack_slots.long()
    assert a.hack_slot_ptr.dtype == a.hack_slots.dtype == torch.int32
    assert ptr.shape == (hacks + 1,) and int(ptr[0]) == 0
    assert int(ptr[-1]) == slots.numel() and bool((ptr[1:] >= ptr[:-1]).all())
    live = torch.nonzero((a.values != 0).any(dim=1)).view(-1)
    assert torch.equal(torch.sort(slots).values, live)
    owner = torch.repeat_interleave(torch.arange(hacks), ptr[1:] - ptr[:-1])
    assert torch.equal(_slot_hacks(a)[slots], owner)
    for h in range(hacks):
        run = slots[ptr[h]:ptr[h + 1]]
        assert bool((run[1:] > run[:-1]).all()), h


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_list_covers_every_nonzero(name, dtype):
    coo = _coo(name, dtype)
    a = coo_to_whdia(coo, device="cpu")
    assert a.pattern_mode == CASES[name][1]
    _assert_list(a)
    # every nonzero cell's slot is listed, and only such slots
    vals, row, col = a._cells()
    nz_slots = np.unique(np.nonzero(vals != 0)[0])
    np.testing.assert_array_equal(np.sort(a.hack_slots.numpy()), nz_slots)
    assert int((vals != 0).sum()) == coo.sum_duplicates().nnz
    # exactly the hacks with a nonzero row have slots (the holes: none)
    counts = (a.hack_slot_ptr[1:] - a.hack_slot_ptr[:-1]).numpy()
    busy = np.zeros(counts.shape[0], bool)
    busy[np.unique(coo.rows // 128)] = True
    np.testing.assert_array_equal(counts > 0, busy)
    if name.endswith("holes"):
        assert not busy[1: a.num_hacks: 3].any()


def _shuffled_tiles(a, seed=3):
    """``a`` with the tiles of every chunk in a random order: each tile
    keeps its slots, base and hack, so the product is unchanged, but a
    hack's tiles are no longer contiguous."""
    T, ct = a.num_tiles, a.chunk_tiles
    rng = np.random.default_rng(seed)
    perm = torch.from_numpy(np.concatenate(
        [c * ct + rng.permutation(ct) for c in range(T // ct)]))
    slot_perm = (perm[:, None] * 8 + torch.arange(8)).view(-1)
    b = twhdia.WhdiaMatrix(
        values=a.values[slot_perm],
        slot_r0=None if a.slot_r0 is None else a.slot_r0[slot_perm],
        tile_r0=None if a.tile_r0 is None else a.tile_r0[perm],
        tile_base=a.tile_base[perm], chunk_group=a.chunk_group,
        **{f: getattr(a, f) for f in STATIC})
    b.check()
    return b


@pytest.mark.parametrize("name", ["laplace", "banded"])
def test_list_keeps_tile_order_when_tiles_are_not_contiguous(name):
    a = coo_to_whdia(_coo(name, "float32"), device="cpu")
    b = _shuffled_tiles(a)
    th = kd.whdia_tile_hacks(b.tile_base, b.chunk_group, b.chunk_tiles,
                             b.group_hacks).numpy()
    # some hack's tiles are now apart, yet its run is its own slots, ascending
    assert any(np.ptp(np.nonzero(th == h)[0]) >= (th == h).sum()
               for h in np.unique(th))
    _assert_list(b)
    x = torch.from_numpy(_vec((2, b.n_cols), "float32"))
    _near(_listed(b, x), _full(a, x), 1e-5, 1e-5)


def _bridged(name, dtype):
    """The JAX converter's layout of the case, and the port's from it."""
    jc = _coo(name, dtype, jfix)
    ja = j_coo_to_whdia(jc)
    if dtype.startswith("complex"):
        f = {p: {k: None if getattr(getattr(ja, p), k, None) is None
                 else np.asarray(getattr(getattr(ja, p), k))
                 for k in ARRAYS + ("values_lo",)} for p in ("ar", "ai")}
        return ja, twhdia.from_numpy_planes(
            f["ar"], f["ai"], **{k: getattr(ja.ar, k) for k in STATIC})
    f = {k: None if getattr(ja, k) is None else np.asarray(getattr(ja, k))
         for k in ARRAYS + ("values_lo",)}
    return ja, twhdia.from_numpy_fields(f, **{k: getattr(ja, k) for k in STATIC})


@pytest.mark.parametrize("how", ["to", "replace", "fields", "planes"])
def test_list_is_rebuilt(how):
    name = "laplace_holes"
    if how in ("fields", "planes"):
        _, a = _bridged(name, "complex64" if how == "planes" else "float32")
        _assert_list(a)
        own = coo_to_whdia(_coo(name, "complex64" if how == "planes" else "float32"),
                           device="cpu")
        assert torch.equal(a.hack_slots, own.hack_slots)
        assert torch.equal(a.hack_slot_ptr, own.hack_slot_ptr)
        return
    a = coo_to_whdia(_coo(name, "float32"), device="cpu")
    if how == "to":
        b = a.to("cpu")
        assert b.hack_slots is not a.hack_slots
        assert torch.equal(b.hack_slots, a.hack_slots)
        assert torch.equal(b.hack_slot_ptr, a.hack_slot_ptr)
    else:
        first = int(a.hack_slots[0])
        values = a.values.clone()
        values[first] = 0  # the slot goes dead: the new layout drops it
        b = dataclasses.replace(a, values=values)
        assert first not in b.hack_slots.tolist()
        assert b.hack_slots.numel() == a.hack_slots.numel() - 1
    _assert_list(b)
    b.check()


def test_check_rejects_a_stale_list():
    a = coo_to_whdia(_coo("laplace", "float32"), device="cpu")
    a.check()
    a.values[int(a.hack_slots[3])] = 0  # changed in place
    with pytest.raises(ValueError, match="hack_slots"):
        a.check()
    b = coo_to_whdia(_coo("banded", "complex64"), device="cpu")
    b.hack_slots = b.hack_slots.flip(0).contiguous()
    with pytest.raises(ValueError, match="hack_slots"):
        b.check()
    c = coo_to_whdia(_coo("banded", "float32"), device="cpu")
    c.hack_slot_ptr = None
    with pytest.raises(ValueError, match="hack_slot_ptr"):
        c.check()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["laplace", "banded"])
def test_listed_product_matches_full_plain_and_jax(name, dtype):
    """One JAX layout through the JAX op (interpret mode; complex the
    JAX plane pair, float64 and complex128 double-float planes) and,
    bridged, through the listed and the full plain products, all against
    each other and the host golden."""
    ja, a = _bridged(name, dtype)
    x = _vec(a.n_cols, dtype)
    xt = torch.from_numpy(x)[None]
    zl = _listed(a, xt)[0, : a.n_rows].numpy()
    zp = _full(a, xt)[0, : a.n_rows].numpy()
    tol, rtol, gtol, grtol = TOL[dtype]
    if dtype.startswith("complex"):
        zj = ja.extract_complex(np.asarray(jops.whdia_spmv(
            ja, jnp.asarray(ja.embed_complex(x.astype(np.complex128))))))
        jtol = 3e-5 if dtype == "complex64" else tol
    elif dtype == "float64":
        zj = dd.join(np.asarray(jops.whdia_spmv(ja, jnp.asarray(dd.split(x)))))
        jtol = tol
    else:
        zj = np.asarray(jops.whdia_spmv(ja, jnp.asarray(x)))
        jtol = 1e-5
    _near(zl, zp, tol, rtol, "listed vs full plain")
    _near(zl, zj, jtol, rtol if dtype == "float32" else 0.0, "listed vs JAX")
    golden = _coo(name, dtype).spmv(x.astype(_wide(dtype)))
    _near(zl, golden, gtol, grtol, "listed vs golden")


@pytest.mark.parametrize("n_rhs", [1, 3, 9])
@pytest.mark.parametrize("name", sorted(CASES))
def test_listed_spmm_matches_full_plain(name, n_rhs):
    a = coo_to_whdia(_coo(name, "float32"), device="cpu")
    x = torch.from_numpy(_vec((n_rhs, a.n_cols), "float32", seed=n_rhs))
    zl = _listed(a, x)
    assert zl.shape == (n_rhs, a.num_groups * a.group_hacks * 128)
    _near(zl, _full(a, x), 1e-5, 1e-5)
    # the op's CPU path (fused or not) is the full plain product
    _near(tops.whdia_spmm(a, x, fused=True), _full(a, x)[:, : a.n_rows], 0, 0)


def _wide(dtype):
    """The host golden's type: complex128 or float64."""
    return np.complex128 if dtype.startswith("complex") else np.float64


def _dead_only_columns(a):
    """Columns in range that only all-zero slots reach."""
    vals, _, col = a._cells()
    live = (vals != 0).any(axis=1)
    inr = (col >= 0) & (col < a.n_cols)
    return sorted(set(col[~live][inr[~live]].tolist())
                  - set(col[live][inr[live]].tolist()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_inf_behind_a_dead_slot(dtype):
    coo = _coo("laplace_holes", dtype)
    a = coo_to_whdia(coo, device="cpu")
    cols = _dead_only_columns(a)
    assert cols, "the fixture must have a column that only dead slots reach"
    x = _vec(a.n_cols, dtype)
    x[cols[len(cols) // 2]] = np.inf
    xt = torch.from_numpy(x)[None]
    golden = coo.spmv(x.astype(_wide(dtype)))
    assert np.isfinite(golden).all()
    full = _full(a, xt)[0, : a.n_rows].numpy()
    assert np.isnan(full).any()  # 0 * Inf in a dead slot, as the JAX kernel
    listed = _listed(a, xt)[0, : a.n_rows].numpy()
    assert np.isfinite(listed).all()
    _near(listed, golden, *TOL[dtype][2:])


def test_wrappers_need_the_list_on_cuda_only():
    """On CPU tensors the wrappers run the full plain product and ignore
    the list; the list check itself raises on a malformed list."""
    a = coo_to_whdia(_coo("banded", "complex64"), device="cpu")
    x = torch.from_numpy(_vec(a.n_cols, "complex64"))
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  num_groups=a.num_groups, tile_page=a.tile_page)
    args = (a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group)
    before = kd.LAUNCHES_C64
    torch.testing.assert_close(kd.whdia_spmv(*args, x, **static),
                               _full(a, x[None])[0], rtol=0, atol=0)
    assert kd.LAUNCHES_C64 == before
    hacks = a.num_groups * a.group_hacks
    with pytest.raises(ValueError, match="needs hack_slot_ptr"):
        kd._list_ptrs("whdia_spmv", None, a.hack_slots, hacks, x.device)
    with pytest.raises(ValueError, match="int32"):
        kd._list_ptrs("whdia_spmv", a.hack_slot_ptr.long(), a.hack_slots, hacks,
                      x.device)
    with pytest.raises(ValueError, match="entries"):
        kd._list_ptrs("whdia_spmm", a.hack_slot_ptr[:-1], a.hack_slots, hacks,
                      x.device)


@pytest.mark.parametrize("name", ["laplace_holes", "banded_holes"])
def test_listed_fp32_matches_jax_on_empty_row_blocks(name):
    """The fp32 listed product, #3's function since it reads only the
    live slots, on layouts with hacks that hold no live slot: equal to
    the JAX op (interpret mode) within rtol 1e-5 and 1e-5·max|z|, zero
    on the empty hacks' rows."""
    ja, a = _bridged(name, "float32")
    assert a.pattern_mode == CASES[name][1]
    x = _vec(a.n_cols, "float32", seed=5)
    zl = _listed(a, torch.from_numpy(x)[None])[0]
    zj = np.asarray(jops.whdia_spmv(ja, jnp.asarray(x)))
    _near(zl[: a.n_rows].numpy(), zj, 1e-5, 1e-5, "listed vs JAX")
    counts = (a.hack_slot_ptr[1:] - a.hack_slot_ptr[:-1])
    empty = torch.nonzero(counts == 0).view(-1)
    assert empty.numel() > 0
    assert not bool(zl.view(-1, 128)[empty].any())


def test_fp32_spmv_reads_the_list_on_cuda_only():
    """Every value type's SpMV reads the live slots on the card
    (``HACK_PASS``: #3, #6, #9 and #10): on CPU tensors the wrapper runs
    the full plain product without the list and counts no launch; the
    warp pass's 16-byte value loads need an aligned fp32 or float64
    slab (``ALIGNED``)."""
    assert set(kd.HACK_PASS) == {torch.float32, torch.float64, torch.complex64,
                                 torch.complex128}
    assert set(kd.ALIGNED) <= set(kd.HACK_PASS)
    for dtype in DTYPES:
        a = coo_to_whdia(_coo("laplace", dtype), device="cpu")
        x = torch.from_numpy(_vec(a.n_cols, dtype))
        args = (a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group)
        static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                      num_groups=a.num_groups, tile_page=a.tile_page)
        counter = kd._ENTRIES[a.values.dtype][1]
        before = getattr(kd, counter)
        torch.testing.assert_close(kd.whdia_spmv(*args, x, **static),
                                   _full(a, x[None])[0], rtol=0, atol=0)
        assert getattr(kd, counter) == before
        if a.values.dtype in kd.ALIGNED:
            kd._check_aligned("whdia_spmv", a.values)
            flat = torch.zeros(a.values.numel() + 1, dtype=a.values.dtype)
            with pytest.raises(ValueError, match="16 B aligned"):
                kd._check_aligned("whdia_spmv", flat[1:].view_as(a.values))


def test_listed_sum_adds_each_hack_in_list_order():
    """``whdia_listed_sum`` adds each hack's terms one listed slot after
    another (the kernels' order), for every RHS, and leaves a hack with
    no slot at 0."""
    rng = np.random.default_rng(4)
    counts = np.array([3, 0, 1, 5, 0, 2])
    ptr = np.concatenate([[0], np.cumsum(counts)])
    terms = rng.standard_normal((2, ptr[-1], 128)).astype(np.float32)
    terms[:, :, 0] = [1e8, 1.0, -1e8, 2.0, 3.0, 4.0, -5.0, 6.0, 7.0, 8.0, 9.0]
    z = kd.whdia_listed_sum(torch.from_numpy(terms),
                            torch.from_numpy(ptr.astype(np.int32)), counts.size)
    assert z.shape == (2, counts.size * 128)
    want = np.zeros((2, counts.size, 128), np.float32)
    for h in range(counts.size):
        for i in range(ptr[h], ptr[h + 1]):
            want[:, h] += terms[:, i]  # fp32, in order: 1e8 + 1 - 1e8 = 0
    np.testing.assert_array_equal(z.view(2, -1, 128).numpy(), want)
    assert want[0, 0, 0] == 0.0
