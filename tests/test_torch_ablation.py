"""PyTorch port: kernels #18 and #19 (the per-op cycle accounts of the
WHDIA and float64 packed WHELL tile passes), the sweeps that drive them
and the packed converter's geometry options, against the JAX package.

* #18 (``kernels.ablation.whdia_ablation``, the plain version on CPU
  tensors) on a JAX WHDIA layout carried across by the bridge, in pattern
  mode (a small banded-11) and slab mode (a Laplacian): ``full`` equals
  the JAX ``whdia_spmv_pallas`` in interpret mode, and so do ``gather``'s
  per-tile lane sums added into their hack rows (:data:`TOL_F32`, as
  ``tests/test_torch_whdia.py``);
* #19 (``whell_f64_ablation``) on a JAX double-float layout joined into
  float64, on a unit-segment Laplacian and a FEM-like matrix with wider
  segments: ``full``, and ``own``'s unscanned hack sums through the plain
  flush, equal ``whell_spmv_dd_pallas`` in interpret mode within
  :data:`TOL_F64` (the double-float pair keeps ~48 bits);
* the partial levels against an independent NumPy reckoning, loops over
  tiles and slots, of the function each level is defined to compute (r0
  from the JAX layout's own decoder): fp32 within 1e-5·max|out|
  (:data:`TOL_PART_F32`), float64 within 1e-12·max|out|;
* the sweeps at a small size on the CPU (the float64 account on the
  Laplacian and on a cut flagship): one row per card level, every field
  their ``main()`` prints, the absent TPU levels and the retired card
  level named with a reason, every time None and labelled so; without a
  card they raise;
* ``coo_to_whell(..., group_hacks=, chunk_tiles=)`` bit-identical to the
  JAX converter for the six geometries of ``doc/sweeps/dd_geom_sweep.py``;
* guards: a bad level or dtype raises, and CPU calls count no launch.
"""

import functools
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu.convert.whdia import coo_to_whdia as j_coo_to_whdia  # noqa: E402
from spgpu_tpu.convert.whell import coo_to_whell as j_coo_to_whell  # noqa: E402
from spgpu_tpu.ops import dd  # noqa: E402
from spgpu_tpu.ops.pallas_kernels import (  # noqa: E402
    whdia_spmv_pallas,
    whell_spmv_dd_pallas,
)
from spgpu_tpu.utils import fixtures as jfix  # noqa: E402
from spgpu_tpu_torch.convert import coo_to_whell  # noqa: E402
from spgpu_tpu_torch.formats import whdia as twhdia  # noqa: E402
from spgpu_tpu_torch.formats import whell as twhell  # noqa: E402
from spgpu_tpu_torch.kernels import ablation as ab  # noqa: E402
from spgpu_tpu_torch.kernels import whell as kw  # noqa: E402
from spgpu_tpu_torch.ops import _prep_x  # noqa: E402
from spgpu_tpu_torch.sweeps import _common  # noqa: E402
from spgpu_tpu_torch.sweeps import dd_ablation, dd_geom_sweep, whdia_ablation  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: fp32 product against the JAX kernel and its golden (tests/test_whdia.py)
TOL_F32 = dict(rtol=2e-5, atol=2e-5)
#: fp32 partial levels: atol as a fraction of max|out| (the kernel and the
#: reckoning sum each lane's 8 slots in other orders)
TOL_PART_F32 = 1e-5
#: float64 against a double-float pair (~48 bits) or float64: atol as a
#: fraction of max|out|
TOL_F64 = 1e-12

WHDIA_CASES = {
    "pattern": lambda f: f.random_banded(3000, bands=11, wander=7, seed=2,
                                         dtype=np.float32).sum_duplicates(),
    "slab": lambda f: f.laplacian_2d(40, 40, np.float32),
}
F64_CASES = {
    "laplace": lambda f: f.laplacian_2d(40, 50, np.float64),
    "fem": lambda f: f.random_fem_like(3000, 16.0, span=256, far_frac=0.02,
                                       seed=5, dtype=np.float64),
}
WHDIA_ARRAYS = ("values", "slot_r0", "tile_r0", "tile_base", "chunk_group")
WHDIA_STATIC = ("n_rows", "n_cols", "num_hacks", "num_groups", "total_slots",
                "nnz", "x_pages", "window_pages", "group_hacks", "chunk_tiles")
WHELL_ARRAYS = ("residue", "page_tab", "tile_base", "chunk_group", "seg_lo",
                "seg_hi", "lane_of_row", "group_bases")
WHELL_STATIC = ("n_rows", "n_cols", "num_hacks", "num_groups", "total_slots",
                "nnz", "x_pages", "window_pages", "orig_rows", "group_hacks",
                "chunk_tiles", "unit_segments")


def near(got, want, frac, what=""):
    """|got - want| ≤ frac·max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(initial=0.0), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale, err_msg=what)


# --------------------------------------------------------------------------
# the layouts, carried across from the JAX converters


@pytest.fixture(scope="module", params=sorted(WHDIA_CASES))
def whdia_pair(request):
    """(case, JAX layout, port layout, x, JAX interpret-mode product)."""
    coo = WHDIA_CASES[request.param](jfix)
    ja = j_coo_to_whdia(coo)
    assert (ja.tile_r0 is not None) == (request.param == "pattern")
    ta = twhdia.from_numpy_fields(
        {f: None if getattr(ja, f) is None else np.asarray(getattr(ja, f))
         for f in WHDIA_ARRAYS + ("values_lo",)},
        **{f: getattr(ja, f) for f in WHDIA_STATIC})
    x = np.random.default_rng(0).standard_normal(coo.n_cols).astype(np.float32)
    zj = np.asarray(whdia_spmv_pallas(ja, jnp.asarray(x), interpret=True), np.float64)
    return request.param, ja, ta, x, zj


def _whdia_args(ta, x):
    return ((ta.values, ta.slot_r0, ta.tile_r0, ta.tile_base, ta.chunk_group,
             torch.from_numpy(x)),
            dict(chunk_tiles=ta.chunk_tiles, group_hacks=ta.group_hacks,
                 num_groups=ta.num_groups))


@pytest.fixture(scope="module", params=sorted(F64_CASES))
def f64_pair(request):
    """(case, JAX dd layout, port float64 layout, lane-space x, JAX
    interpret-mode product joined to float64)."""
    coo = F64_CASES[request.param](jfix)
    ja = j_coo_to_whell(coo, packed=True)
    assert ja.is_dd and ja.unit_segments == (request.param == "laplace")
    ta = twhell.from_numpy_fields(
        {f: None if getattr(ja, f) is None else np.asarray(getattr(ja, f))
         for f in WHELL_ARRAYS + ("values", "values_lo")},
        **{f: getattr(ja, f) for f in WHELL_STATIC})
    xl = np.zeros(ja.n_rows)
    xl[np.asarray(ja.lane_of_row)] = np.random.default_rng(0).standard_normal(coo.n_cols)
    zj = dd.join(np.asarray(whell_spmv_dd_pallas(ja, jnp.asarray(dd.split(xl)),
                                                 interpret=True)))
    return request.param, ja, ta, xl, zj


def _f64_args(ta, xl):
    x2 = _prep_x(torch.from_numpy(xl), ta.n_cols, ta.x_pages)
    return ((ta.values, ta.residue, ta.page_tab, ta.tile_base, ta.chunk_group,
             ta.group_bases, ta.seg_lo, ta.seg_hi, x2),
            dict(chunk_tiles=ta.chunk_tiles, group_hacks=ta.group_hacks,
                 window_pages=ta.window_pages, unit_segments=ta.unit_segments,
                 hack_units=ta.hack_units))


# --------------------------------------------------------------------------
# #18 against the JAX package


def test_whdia_full_matches_jax(whdia_pair):
    name, ja, ta, x, zj = whdia_pair
    args, static = _whdia_args(ta, x)
    z = ab.whdia_ablation("full", *args, **static)
    assert z.shape == (ta.num_groups * ta.group_hacks * 128,)
    np.testing.assert_allclose(z.double().numpy()[: ta.n_rows], zj, **TOL_F32)


def test_whdia_gather_into_hack_rows_matches_jax(whdia_pair):
    """``gather`` is the production tile sum before its atomic: added into
    each tile's hack row it is the product."""
    name, ja, ta, x, zj = whdia_pair
    args, static = _whdia_args(ta, x)
    part = ab.whdia_ablation("gather", *args, **static).double().numpy()
    assert part.shape == (ta.num_tiles, 128)
    cg = np.asarray(ja.chunk_group, np.int64)
    meta = np.asarray(ja.tile_base, np.int64)
    t = np.arange(ta.num_tiles)
    hack = cg[t // ja.chunk_tiles] * ja.group_hacks + (meta >> 16)
    z = np.zeros((ja.num_groups * ja.group_hacks, 128))
    np.add.at(z, hack, part)
    np.testing.assert_allclose(z.reshape(-1)[: ta.n_rows], zj, **TOL_F32)


# --------------------------------------------------------------------------
# #19 against the JAX package


def test_f64_full_matches_jax(f64_pair):
    name, ja, ta, xl, zj = f64_pair
    args, static = _f64_args(ta, xl)
    z = ab.whell_f64_ablation("full", *args, **static)
    assert z.dtype == torch.float64 and z.shape == (ta.seg_lo.shape[0], 128)
    lor = np.asarray(ja.lane_of_row)
    near(z.numpy().reshape(-1)[lor], zj[lor], TOL_F64)


def test_f64_atomic_flushed_matches_jax(f64_pair):
    name, ja, ta, xl, zj = f64_pair
    args, static = _f64_args(ta, xl)
    acc = ab.whell_f64_ablation("own", *args, **static)
    assert acc.shape == (ta.seg_lo.shape[0], 128)
    z = kw.whell_flush_plain(acc[None], ta.seg_lo, ta.seg_hi, ta.unit_segments)[0]
    lor = np.asarray(ja.lane_of_row)
    near(z.numpy().reshape(-1)[lor], zj[lor], TOL_F64)


# --------------------------------------------------------------------------
# the partial levels against an independent NumPy reckoning


def _whdia_reckon(level, ja, x):
    """Loops over tiles and slots: stream sums 1.5·v, r0 sums v·(col &
    127), gather sums v·x[col] over in-range columns; col = base·128 + r0
    + lane with r0 from the JAX layout's decoder."""
    vals = np.asarray(ja.values, np.float64)
    r0 = ja.slot_r0_host().astype(np.int64)
    base = np.asarray(ja.tile_base, np.int64) & 0xFFFF
    lanes = np.arange(128)
    out = np.zeros((ja.num_tiles, 128))
    for t in range(ja.num_tiles):
        for s in range(8):
            v = vals[t * 8 + s]
            col = base[t] * 128 + r0[t * 8 + s] + lanes
            if level == "stream":
                out[t] += 1.5 * v
            elif level == "r0":
                out[t] += v * (col & 127)
            else:
                ok = (col >= 0) & (col < x.size)
                out[t] += np.where(ok, v * x[np.clip(col, 0, x.size - 1)], 0.0)
    return out


@pytest.mark.parametrize("level", ["stream", "r0", "gather"])
def test_whdia_partial_levels_match_numpy(whdia_pair, level):
    name, ja, ta, x, zj = whdia_pair
    args, static = _whdia_args(ta, x)
    part = ab.whdia_ablation(level, *args, **static)
    assert part.shape == (ta.num_tiles, 128) and part.dtype == torch.float32
    near(part.numpy(), _whdia_reckon(level, ja, x.astype(np.float64)), TOL_PART_F32)


def _f64_reckon(level, a, xl):
    """Loops over tiles and slots: stream sums 1.5·v + r + d over each
    cell's own bytes; gather sums v·x[page·128 + r] with d = page_tab[s,
    r] and page = base + d (aligned) or group_bases[g·K + d>>3] + (d & 7)
    (scattered)."""
    vals = a.values.numpy()
    res = a.residue.numpy().astype(np.int64)
    pt = a.page_tab.numpy().astype(np.int64)
    meta = a.tile_base.numpy().astype(np.int64)
    gb = None if a.group_bases is None else a.group_bases.numpy().astype(np.int64)
    K = a.window_pages // 8
    out = np.zeros((a.num_tiles, 128))
    for t in range(a.num_tiles):
        for s in range(8):
            c = t * 8 + s
            r = res[c]
            if level == "stream":
                out[t] += 1.5 * vals[c] + r + pt[c]
                continue
            d = pt[c][r]
            if gb is None:
                page = (meta[t] & 0xFFFF) + d
            else:
                page = gb[(meta[t] & 0xFFFFF) * K + (d >> 3)] + (d & 7)
            out[t] += vals[c] * xl[page * 128 + r]
    return out


@pytest.mark.parametrize("level", ["stream", "gather"])
@pytest.mark.parametrize("scattered", [False, True], ids=["aligned", "scattered"])
def test_f64_partial_levels_match_numpy(level, scattered):
    coo = tfix.random_fem_like(2000, 12.0, span=200, far_frac=0.02, seed=7,
                               dtype=np.float64)
    a = coo_to_whell(coo, device="cpu", scattered=scattered)
    assert a.scattered == scattered
    xl = np.zeros(a.x_pages * 128)
    xl[a.lane_of_row.numpy()] = np.random.default_rng(1).standard_normal(coo.n_cols)
    args, static = _f64_args(a, xl[: a.n_cols])
    part = ab.whell_f64_ablation(level, *args, **static)
    assert part.shape == (a.num_tiles, 128) and part.dtype == torch.float64
    near(part.numpy(), _f64_reckon(level, a, xl), TOL_F64)


# --------------------------------------------------------------------------
# the sweeps on the CPU


SWEEPS = {"whdia_ablation": (whdia_ablation, 4096, "levels"),
          "dd_ablation": (dd_ablation, 64, "levels"),
          "dd_geom_sweep": (dd_geom_sweep, 160, "geometries")}
ROW_FIELDS = ("device_ms", "device_source", "cold_device_ms", "cold_source",
              "per_call_ms", "per_call_spread_ms", "plain_per_call_ms",
              "ns_per_tile", "gflops_equiv", "output_bytes", "level_bytes",
              "max_abs_err")


def _tpu_levels(script):
    """The levels the JAX script times (its ``variants`` list)."""
    with open(os.path.join(ROOT, "doc", "sweeps", script)) as f:
        src = f.read()
    return re.findall(r'\("(\w+)", (?:mk\("\w+"\)|full_fn)\)', src)


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_runs_on_cpu(name):
    mod, size, key = SWEEPS[name]
    res = mod.run("cpu", size=size)
    assert res["timing"] == _common.CPU_TIMING and res["gpu"] is None
    assert res["launches"] == 0  # the CPU runs the plain versions
    rows = res[key]
    for r in rows:
        assert all(f in r for f in ROW_FIELDS), set(ROW_FIELDS) - set(r)
        assert r["device_ms"] is None and r["cold_device_ms"] is None
        assert r["per_call_ms"] is None and r["ns_per_tile"] is None
        assert r["max_abs_err"] == 0.0 or name == "dd_geom_sweep"
    assert res["bound"]["bound_ms"] > 0 and res["library"]["per_call_ms"] is None
    if name == "dd_geom_sweep":
        assert [(r["group_hacks"], r["chunk_tiles"]) for r in rows] == \
            list(dd_geom_sweep.GEOMETRIES)
        assert res["max_abs_err"] < 1e-10  # #4 against the float64 golden
        return
    family = "whdia" if name == "whdia_ablation" else "f64"
    levels = ab.WHDIA_LEVELS if family == "whdia" else ab.F64_LEVELS
    assert [r["level"] for r in rows] == list(levels)
    assert all(r["price_ms"] is None for r in rows)
    tpu = _tpu_levels(name + ".py")
    assert sorted(tpu) == sorted(res["tpu_levels"])
    assert {a["tpu_level"] for a in res["absent"]} == \
        {t for t, card in res["tpu_levels"].items() if card is None}
    assert all(a["reason"] for a in res["absent"])
    assert {t for r in rows for t in r["tpu_levels"]} | \
        {a["tpu_level"] for a in res["absent"]} == set(tpu)


def test_dd_ablation_names_the_double_float_levels_absent():
    res = dd_ablation.run("cpu", size=32)
    assert {a["tpu_level"] for a in res["absent"]} == {"eft", "ddrmw", "norelax"}
    assert [r["level"] for r in res["retired"]] == ["atomic"]
    assert all(r["reason"] for r in res["retired"])
    assert "atomic" not in ab.F64_LEVELS
    assert whdia_ablation.run("cpu", size=2048)["absent"] == []


def test_dd_ablation_runs_on_the_flagship_on_cpu():
    """``matrix="flagship"``: the flagship generator cut to 3,000 rows,
    every level against its plain version and ``full`` against the
    production product."""
    res = dd_ablation.run("cpu", size=3000, matrix="flagship")
    assert res["matrix"] == "flagship" and res["fixture"].startswith("random_fem_like(3000")
    assert [r["level"] for r in res["levels"]] == list(ab.F64_LEVELS)
    assert res["max_abs_err"] == 0.0 and res["full_vs_production_max_abs_err"] == 0.0
    assert not res["unit_segments"] and res["tiles"] > 0
    with pytest.raises(ValueError, match="matrix"):
        dd_ablation.run("cpu", size=32, matrix="banded")


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_main_prints_on_cpu_and_raises_without_a_card(name, monkeypatch, capsys):
    mod, size, key = SWEEPS[name]
    # main() runs the JAX script's size; here run() is cut to a small one
    monkeypatch.setattr(mod, "run", functools.partial(mod.run, size=size))
    monkeypatch.setattr(sys, "argv", [name, "--device", "cpu"])
    res = mod.main()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == (1 + len(res[key]) + len(res.get("absent", []))
                          + len(res.get("retired", [])) + 4)
    assert "GFLOPS-equiv" in lines[1] and lines[-1] == "gpu: none (cpu run)"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [name])
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        mod.main()
    monkeypatch.setattr(sys, "argv", [name, "--size", str(size)])
    with pytest.raises(SystemExit):  # the size is the JAX script's
        mod.main()


def test_prices_need_one_source():
    rows = [dict(device_ms=1.0, device_source="profiler", cold_device_ms=2.0,
                 cold_source="profiler"),
            dict(device_ms=1.5, device_source="profiler", cold_device_ms=9.0,
                 cold_source="cuda_events"),
            dict(device_ms=2.5, device_source="profiler", cold_device_ms=9.5,
                 cold_source="cuda_events")]
    _common.add_prices(rows)
    assert [r["price_ms"] for r in rows] == [None, 0.5, 1.0]
    assert [r["price_cold_ms"] for r in rows] == [None, None, 0.5]


def _unit_flush_bytes(a):
    """What #4 moves on a unit-segment layout: every layout array it reads
    (hack_units, not chunk_group; not seg_lo: the unit scan reads seg_hi
    alone), x once and z once."""
    x2 = _prep_x(torch.zeros(a.n_cols, dtype=torch.float64), a.n_cols, a.x_pages)
    return sum(t.numel() * t.element_size() for t in (
        a.values, a.residue, a.page_tab, a.tile_base, a.hack_units,
        a.group_bases, a.seg_hi, x2) if t is not None) + a.seg_hi.numel() * 8


def test_f64_bounds_leave_seg_lo_out_for_unit_segments():
    coo = tfix.laplacian_2d(40, 40, np.float64)
    res = dd_ablation.run("cpu", size=40)
    a = coo_to_whell(coo, device="cpu")
    assert res["unit_segments"] and a.unit_segments
    assert res["bound"]["bound_bytes"] == _unit_flush_bytes(a)
    geo = {(r["group_hacks"], r["chunk_tiles"]): r["bound_bytes"]
           for r in dd_geom_sweep.run("cpu", size=40)["geometries"]}
    for (gh, ct), got in geo.items():
        g = coo_to_whell(coo, device="cpu", scattered=False, group_hacks=gh,
                         chunk_tiles=ct)  # the sweep's aligned geometry
        assert got == _unit_flush_bytes(g), (gh, ct)


# --------------------------------------------------------------------------
# the converter's geometry options


@pytest.mark.parametrize("geom", dd_geom_sweep.GEOMETRIES, ids=lambda g: f"gh{g[0]}_ct{g[1]}")
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_geometry_options_match_jax(geom, dtype):
    """200 hacks: at 128 and 256 hacks per group the layouts differ from
    the default's.  float64: the JAX double-float layout's aligned windows
    (``scattered=False``; the port's default is scattered)."""
    gh, ct = geom
    ja = j_coo_to_whell(jfix.laplacian_2d(160, 160, dtype), packed=True,
                        group_hacks=gh, chunk_tiles=ct)
    ta = coo_to_whell(tfix.laplacian_2d(160, 160, dtype), device="cpu",
                      group_hacks=gh, chunk_tiles=ct,
                      scattered=False if dtype == np.float64 else None)
    for f in WHELL_ARRAYS:
        jv, tv = getattr(ja, f), getattr(ta, f)
        assert (jv is None) == (tv is None), f
        if jv is not None:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=f)
    for f in WHELL_STATIC:
        assert getattr(ja, f) == getattr(ta, f), f
    assert (ta.group_hacks, ta.chunk_tiles) == (gh, ct)
    ta.check()


def test_geometry_options_change_the_layout():
    coo = tfix.laplacian_2d(160, 160, np.float64)
    tiles = {g: coo_to_whell(coo, device="cpu", group_hacks=g[0],
                             chunk_tiles=g[1]).num_tiles
             for g in dd_geom_sweep.GEOMETRIES}
    assert len(set(tiles.values())) > 1


@pytest.mark.parametrize("kw_", [dict(group_hacks=64), dict(chunk_tiles=16)])
def test_geometry_options_need_packed(kw_):
    with pytest.raises(ValueError, match="require packed=True"):
        coo_to_whell(tfix.laplacian_2d(20, 20, np.float32), device="cpu",
                     packed=False, **kw_)


@pytest.mark.parametrize("kw_", [dict(group_hacks=0), dict(chunk_tiles=0),
                                 dict(group_hacks=4097, scattered=True),
                                 dict(group_hacks=65537, scattered=False),
                                 dict(chunk_tiles=2.5)])
def test_geometry_options_refuse_bad_values(kw_):
    with pytest.raises(ValueError):
        coo_to_whell(tfix.laplacian_2d(20, 20, np.float32), device="cpu", **kw_)


# --------------------------------------------------------------------------
# guards


def test_bad_level_raises():
    a = coo_to_whell(tfix.laplacian_2d(16, 16, np.float64), device="cpu")
    xl = torch.zeros(a.n_cols, dtype=torch.float64)
    args, static = _f64_args(a, xl.numpy())
    with pytest.raises(ValueError, match="level must be one of"):
        ab.whell_f64_ablation("eft", *args, **static)
    with pytest.raises(ValueError, match="level must be one of"):
        ab.whell_f64_ablation_plain("r0", *args, **static)
    from spgpu_tpu_torch.convert import coo_to_whdia

    d = coo_to_whdia(tfix.laplacian_2d(16, 16, np.float32), device="cpu")
    dargs, dstatic = _whdia_args(d, np.zeros(d.n_cols, np.float32))
    for bad in ("sgather", "atomic", "", None):
        with pytest.raises(ValueError, match="level must be one of"):
            ab.whdia_ablation(bad, *dargs, **dstatic)


def test_other_dtypes_raise():
    from spgpu_tpu_torch.convert import coo_to_whdia

    d = coo_to_whdia(tfix.laplacian_2d(16, 16, np.float64), device="cpu")
    dargs, dstatic = _whdia_args(d, np.zeros(d.n_cols, np.float64))
    with pytest.raises(ValueError, match="takes float32"):
        ab.whdia_ablation("stream", *dargs, **dstatic)
    a = coo_to_whell(tfix.laplacian_2d(16, 16, np.float32), device="cpu")
    args, static = _f64_args(a, np.zeros(a.n_cols))
    with pytest.raises(ValueError):  # fp32 values take fp32 x, and #19 float64
        ab.whell_f64_ablation("stream", *args, **static)
    x2 = _prep_x(torch.zeros(a.n_cols), a.n_cols, a.x_pages)
    with pytest.raises(ValueError, match="takes float64"):
        ab.whell_f64_ablation("stream", *args[:-1], x2, **static)


def test_cpu_calls_count_no_launch():
    before = (ab.LAUNCHES_WHDIA_ABLATION, ab.LAUNCHES_F64_ABLATION)
    whdia_ablation.run("cpu", size=2048)
    dd_ablation.run("cpu", size=32)
    assert (ab.LAUNCHES_WHDIA_ABLATION, ab.LAUNCHES_F64_ABLATION) == before
