"""The port's distributed layer (``spgpu_tpu_torch.parallel``) against the
JAX package's (``spgpu_tpu.parallel``) on the CPU: the partitions'
structure, the halo plan, the bridge, the launcher, and the distributed
SpMV on gloo ranks.

* Structure: the converter's ``row_degrees``/``lane_capacity`` pin the
  lane map as the JAX ones do (bit for bit); each shard's interior and
  exterior layouts from the port's
  ``build_shard_mats(coo, S, split_exterior=True)`` equal the JAX ones
  bit for bit (float32 and complex64 at the default geometry, float64 and
  complex128 with ``scattered=False``; complex against each JAX plane;
  float64 values within the double-float split's 1e-13), and so do ``K``,
  ``halo_counts`` and the send lists.  The port's plan's send and halo
  lanes equal the JAX ``send_lane_idx``/``halo_lanes`` trimmed to the
  real counts, and ``from_numpy_partition`` of a JAX partition equals the
  port's own partition.
* Numbers: every case runs on 1, 2 and 4 gloo ranks spawned once per
  world size (a module-scoped fixture; the JAX references are computed
  meanwhile), and each is asserted on its own: ``dist_spmv`` against the
  host golden (float32 2e-5, complex64 3e-5, float64 and complex128
  1e-12, each times max|z|), with ``overlap`` True and False, on a
  partition with pairs of count 0 and an exterior slab with fewer groups
  than its interior; and on partitions bridged from the JAX ones against
  the JAX ``dist_spmv`` at the same tolerances.
"""

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.parallel import make_row_mesh  # noqa: E402
from spgpu_tpu.parallel.dist_spmv import dist_spmv as j_dist_spmv  # noqa: E402
from spgpu_tpu.parallel.partition_packed import build_shard_mats as j_build  # noqa: E402
from spgpu_tpu.parallel.partition_packed import (  # noqa: E402
    partition_coo_rows_packed as j_partition)
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.parallel import (  # noqa: E402
    from_numpy_partition,
    partition_coo_rows_packed,
    run_ranks,
)
from spgpu_tpu_torch.parallel.partition_packed import build_shard_mats  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))

FIXTURES = {
    "laplace": lambda: tfix.laplacian_2d(24, 64),
    "irregular": lambda: tfix.random_irregular(1000, 1000, avg_nnz_per_row=9.0, seed=3),
    # the uneven last shard of tests/test_parallel.py (n = 700)
    "uneven": lambda: tfix.random_banded(700, bands=5, wander=0, seed=3).sum_duplicates(),
}
DTYPES = (np.float32, np.float64, np.complex64, np.complex128)
WORLDS = (1, 2, 4)
#: golden tolerance, times max|z|, by type
TOL = {np.float32: 2e-5, np.complex64: 3e-5, np.float64: 1e-12, np.complex128: 1e-12}
STRUCTURE = ("residue", "page_tab", "tile_base", "chunk_group", "seg_lo", "seg_hi",
             "lane_of_row", "group_bases")


def typed(base, dt):
    """``base`` with ``dt`` values (complex: ``+ 1j·N(0, 1)``,
    ``default_rng(8)``)."""
    v = base.values.astype(np.float64)
    if np.dtype(dt).kind == "c":
        v = v + 1j * np.random.default_rng(8).standard_normal(base.nnz)
    return CooMatrix(base.rows, base.cols, v.astype(dt), base.n_rows, base.n_cols)


def f64ish(dt) -> bool:
    return np.dtype(dt) in (np.float64, np.complex128)


def jax_planes(coo):
    """The real COOs of the JAX planes (one for a real matrix)."""
    rdt = np.float64 if f64ish(coo.values.dtype) else np.float32
    parts = (np.real, np.imag) if np.iscomplexobj(coo.values) else (np.asarray,)
    return [JCoo(coo.rows, coo.cols, f(coo.values).astype(rdt), coo.n_rows, coo.n_cols)
            for f in parts]


def port_partition(coo, S, overlap=True):
    """The port's partition in the geometry the JAX one has (float64 and
    complex128: aligned windows)."""
    return partition_coo_rows_packed(coo, S, overlap=overlap,
                                     scattered=False if f64ish(coo.values.dtype) else None)


def jax_fields(pm):
    """A JAX partition's array fields (NumPy) and static fields."""
    arrays, static = {}, {}
    for f in dataclasses.fields(pm):
        v = getattr(pm, f.name)
        if v is None or hasattr(v, "shape"):
            arrays[f.name] = None if v is None else np.asarray(v)
        else:
            static[f.name] = v
    return arrays, static


def bridged(jp):
    """``from_numpy_partition`` of a JAX partition (complex: plane pair)."""
    if hasattr(jp, "ar"):
        ar, static = jax_fields(jp.ar)
        return from_numpy_partition(ar, jax_fields(jp.ai)[0], **static)
    arrays, static = jax_fields(jp)
    return from_numpy_partition(arrays, **static)


def jax_values(m):
    """A JAX slab's values as float64 (a double-float pair joined)."""
    v = np.asarray(m.values).astype(np.float64)
    return v if m.values_lo is None else v + np.asarray(m.values_lo).astype(np.float64)


def assert_layout_equal(port, jax_planes_mats, complex_values):
    for f in STRUCTURE:
        a, b = getattr(port, f), getattr(jax_planes_mats[0], f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(a.numpy(), np.asarray(b)), f
    v = port.values.numpy()
    parts = (v.real, v.imag) if complex_values else (v,)
    for got, jm in zip(parts, jax_planes_mats):
        np.testing.assert_allclose(got, jax_values(jm), rtol=1e-13, atol=0)


@pytest.mark.parametrize("dt", (np.float32, np.float64), ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_pinned_lane_map_equals_jax(name, dt):
    """``row_degrees`` and ``lane_capacity`` size the lane segments as in
    the JAX converter: a subset of the entries converted with the whole
    set's degrees gives the JAX arrays bit for bit, and the whole set's
    lane map."""
    from spgpu_tpu.convert.whell import coo_to_whell as j_coo_to_whell
    from spgpu_tpu_torch.convert import coo_to_whell

    coo = typed(FIXTURES[name](), dt)
    keep = np.arange(coo.nnz) % 3 != 0
    sub = CooMatrix(coo.rows[keep], coo.cols[keep], coo.values[keep], coo.n_rows,
                    coo.n_cols)
    pin = dict(row_degrees=coo.row_lengths(), lane_capacity=9.5)
    got = coo_to_whell(sub, device="cpu", scattered=False if f64ish(dt) else None, **pin)
    want = j_coo_to_whell(jax_planes(sub)[0], packed=True, **pin)
    assert_layout_equal(got, [want], False)
    whole = coo_to_whell(coo, device="cpu", lane_capacity=9.5)
    assert torch.equal(got.lane_of_row, whole.lane_of_row)
    with pytest.raises(ValueError):
        coo_to_whell(sub, device="cpu", packed=False, **pin)


@pytest.mark.parametrize("S", (2, 4, 8))
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_shard_layouts_equal_jax(name, dt, S):
    coo = typed(FIXTURES[name](), dt)
    mats, send, chunk, K, counts = build_shard_mats(
        coo, S, split_exterior=True, scattered=False if f64ish(dt) else None)
    jax = [j_build(c, S, split_exterior=True) for c in jax_planes(coo)]
    j_mats, j_send, j_chunk, j_K, j_counts = jax[0]
    assert (chunk, K, counts) == (j_chunk, j_K, j_counts)
    for p in range(S):
        for s in range(S):
            assert np.array_equal(send[p][s], j_send[p, s, : counts[p][s]])
    for s in range(S):
        for side in (0, 1):
            assert_layout_equal(mats[s][side], [j[0][s][side] for j in jax],
                                np.iscomplexobj(coo.values))


@pytest.mark.parametrize("S", (2, 4, 8))
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_exchange_plan_equals_jax(name, S):
    """Each pair's send lanes (on the owner) and halo lanes (on the
    requester) are the JAX plan's, trimmed to the pair's real count; a pair
    of count 0 has no entry."""
    coo = typed(FIXTURES[name](), np.float32)
    pm = port_partition(coo, S)
    jp = j_partition(jax_planes(coo)[0], S)
    assert pm.halo_counts == jp.halo_counts
    send, halo, K = np.asarray(jp.send_lane_idx), np.asarray(jp.halo_lanes), jp.halo_width
    for p in range(S):
        for s in range(S):
            c = pm.halo_counts[p][s]
            assert (s in pm.shards[p].send_lanes) == (p in pm.shards[s].halo_lanes) == (c > 0)
            if c:
                assert np.array_equal(pm.shards[p].send_lanes[s].numpy(), send[p, s, :c])
                assert np.array_equal(pm.shards[s].halo_lanes[p].numpy(),
                                      halo[s, p * K: p * K + c])


@pytest.mark.parametrize("overlap", (True, False))
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_bridge_equals_the_ports_partition(name, dt, overlap):
    """``from_numpy_partition`` drops the JAX stacking pad: each shard's
    layouts equal the port's own partition's, array for array (float64 and
    complex128 values within the double-float split)."""
    coo = typed(FIXTURES[name](), dt)
    got = bridged(j_partition(JCoo(coo.rows, coo.cols, coo.values, coo.n_rows,
                                   coo.n_cols), 4, overlap=overlap))
    want = port_partition(coo, 4, overlap)
    assert got.halo_counts == want.halo_counts and got.overlapped == overlap
    x = torch.from_numpy(x_for(coo))
    assert torch.equal(want.extract(want.embed(x)), x)
    for g, w in zip(got.shards, want.shards):
        assert g.n_local == w.n_local
        for a, b in ((g.interior, w.interior), (g.exterior, w.exterior)):
            assert (a is None) == (b is None)
            if a is None:
                continue
            for f in STRUCTURE + ("tile_page",):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None) and (x is None or torch.equal(x, y)), f
            assert (a.num_groups, a.num_hacks, a.x_pages, a.chunk_tiles) == \
                (b.num_groups, b.num_hacks, b.x_pages, b.chunk_tiles)
            tol = 1e-13 if f64ish(dt) else 0
            torch.testing.assert_close(a.values, b.values, rtol=tol, atol=0)
        for r in w.send_lanes:
            assert torch.equal(g.send_lanes[r], w.send_lanes[r])
        for p in w.halo_lanes:
            assert torch.equal(g.halo_lanes[p], w.halo_lanes[p])


def bidiagonal(S):
    """A lower bidiagonal system of 5,000 rows a shard: the only halo is
    one lane from each shard to the next (every other pair has count 0),
    in the first hack of the requester, whose exterior slab therefore has
    fewer output groups than its interior; shard 0 has no exterior."""
    n = 5000 * S
    i = np.arange(n)
    return CooMatrix(np.r_[i, i[1:]], np.r_[i, i[:-1]],
                     np.r_[np.full(n, 4.0), np.full(n - 1, -1.0)].astype(np.float32), n, n)


def test_short_exterior_and_zero_count_pairs():
    pm = port_partition(bidiagonal(4), 4)
    assert pm.halo_counts == tuple(tuple(int(s == p + 1) for s in range(4))
                                   for p in range(4))
    assert pm.shards[0].exterior is None and not pm.shards[0].halo_lanes
    for sh in pm.shards[1:]:
        assert sh.exterior.num_groups < sh.interior.num_groups
        assert sh.exterior.n_rows < sh.interior.n_rows
    full = build_shard_mats(bidiagonal(4), 4, split_exterior=True)[0]
    for sh, (_, ext) in zip(pm.shards[1:], full[1:]):
        dense = ext.to_dense()
        cut = sh.exterior.to_dense()
        assert np.array_equal(dense[: cut.shape[0]], cut) and not dense[cut.shape[0]:].any()


# --- the launcher ---------------------------------------------------------

def test_launcher_ranks_load_no_jax(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", HERE)
    assert run_ranks(2, "torch_rank_cases:loaded_modules", device="cpu") == [[], []]


@pytest.mark.parametrize("call", ["run_ranks", "dryrun", "dryrun_cli"])
def test_ranks_default_to_the_card(monkeypatch, call):
    """The launcher, the dry run and its command line run on the card
    unless the caller asks for the CPU: with no card they raise before any
    rank starts."""
    from spgpu_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        {"run_ranks": lambda: run_ranks(1, "torch_rank_cases:loaded_modules"),
         "dryrun": lambda: dryrun.dryrun(1),
         "dryrun_cli": lambda: dryrun.main(["--ranks", "1"])}[call]()


@pytest.mark.parametrize("other,agree", [
    (dict(launches={"whell.LAUNCHES": 3}), True),
    (dict(x=np.array([1.0, 2.5])), False),
    (dict(iterations=8), False)], ids=["launches", "x", "iterations"])
def test_dryrun_ranks_agree_on_all_but_their_launches(other, agree):
    """The dry run holds every rank's result of a solve to rank 0's bit for
    bit, except each rank's own kernel launches (a shard with no halo
    launches no exterior product)."""
    from spgpu_tpu_torch.parallel.dryrun import _equal

    first = dict(x=np.array([1.0, 2.0]), iterations=7, residual_norm=1e-6,
                 converged=True, launches={"whell.LAUNCHES": 4})
    assert _equal(first, dict(first, **other)) is agree
    assert _equal([first], [dict(first, **other)]) is agree


@pytest.mark.parametrize("target,kw,err", [
    ("one_rank_never_joins", dict(group_timeout_s=2), RuntimeError),
    ("every_rank_sleeps", dict(timeout_s=2), TimeoutError)])
def test_a_stuck_rank_fails_fast(monkeypatch, target, kw, err):
    """A rank stuck in a collective fails on the group's timeout and the
    launcher kills the rest; ranks that never end are killed at the
    launcher's timeout."""
    monkeypatch.setenv("PYTHONPATH", HERE)
    t0 = time.monotonic()
    with pytest.raises(err):
        run_ranks(2, f"torch_rank_cases:{target}", device="cpu", **kw)
    assert time.monotonic() - t0 < 60


# --- the distributed SpMV on gloo ranks -----------------------------------

#: the golden cases' names: fixture, type, schedule
SPMV_NAMES = ["laplace-float32-overlap", "laplace-float32-single",
              "irregular-float32-overlap", "uneven-float64-overlap",
              "uneven-complex64-overlap", "uneven-complex128-overlap",
              "bidiagonal-float32-overlap", "bidiagonal-float32-single"]


def spmv_case(name, W):
    """The golden case ``name`` on ``W`` ranks: ``(coo, overlap)``."""
    fixture, dt, sched = name.split("-")
    coo = bidiagonal(W) if fixture == "bidiagonal" else typed(FIXTURES[fixture](), dt)
    return coo, sched == "overlap"


#: the cases on partitions bridged from the JAX ones: (world, fixture,
#: dtype, overlap), against the JAX ``dist_spmv`` on the same partition
JAX_CASES = [(4, "laplace", np.float32, True), (4, "laplace", np.float32, False),
             (2, "uneven", np.float64, True), (2, "uneven", np.complex64, True),
             (2, "uneven", np.complex128, True)]


def jax_id(case):
    W, name, dt, ov = case
    return f"{W}-{name}-{np.dtype(dt).name}-{'overlap' if ov else 'single'}"


def x_for(coo, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(coo.n_cols)
    if np.iscomplexobj(coo.values):
        x = x + 1j * rng.standard_normal(coo.n_cols)
    return x.astype(coo.values.dtype)


def golden(coo, x):
    wide = np.complex128 if np.iscomplexobj(coo.values) else np.float64
    return coo.spmv(x.astype(wide))


@pytest.fixture(scope="module")
def ranked():
    """Every case on 1, 2 and 4 gloo ranks (one spawn per world size, in
    a thread) and the JAX ``dist_spmv`` references meanwhile."""
    cases, jobs = {}, {}
    for W in WORLDS:
        for name in SPMV_NAMES:
            coo, ov = spmv_case(name, W)
            cases[(W, name)] = (coo, x_for(coo), port_partition(coo, W, ov))
    jparts = {}
    for case in JAX_CASES:
        W, name, dt, ov = case
        coo = typed(FIXTURES[name](), dt)
        jp = j_partition(JCoo(coo.rows, coo.cols, coo.values, coo.n_rows, coo.n_cols),
                         W, overlap=ov)
        jparts[case] = jp
        cases[(W, "jax-" + jax_id(case))] = (coo, x_for(coo), bridged(jp))
    for W in WORLDS:
        keys = [k for k in cases if k[0] == W]
        jobs[W] = (keys, [("spmv", cases[k][2], dict(x=cases[k][1])) for k in keys])
    with ThreadPoolExecutor(1) as ex:
        runs = {W: ex.submit(run_ranks, W, "spgpu_tpu_torch.parallel.dryrun:run_cases",
                             jobs[W][1], device="cpu", timeout_s=300) for W in WORLDS}
        refs = {case: np.asarray(j_dist_spmv(jp, cases[(case[0], "jax-" + jax_id(case))][1],
                                             make_row_mesh(case[0])))
                for case, jp in jparts.items()}
        results = {W: f.result() for W, f in runs.items()}
    got = {}
    for W, (keys, _) in jobs.items():
        for i, k in enumerate(keys):
            got[k] = [r[i] for r in results[W]]
    return cases, got, refs


@pytest.mark.parametrize("W,name", [(W, n) for W in WORLDS for n in SPMV_NAMES]
                         + [(c[0], "jax-" + jax_id(c)) for c in JAX_CASES])
def test_dist_spmv_matches_golden(ranked, W, name):
    cases, got, _ = ranked
    coo, x, _ = cases[(W, name)]
    z = got[(W, name)]
    g = golden(coo, x)
    assert z[0].shape == g.shape and np.all(np.isfinite(z[0]))
    assert np.abs(z[0] - g).max() <= TOL[coo.values.dtype.type] * np.abs(g).max()
    # every rank holds the same global product
    for zr in z[1:]:
        assert np.array_equal(zr, z[0])


@pytest.mark.parametrize("case", JAX_CASES, ids=jax_id)
def test_dist_spmv_matches_jax(ranked, case):
    cases, got, refs = ranked
    key = (case[0], "jax-" + jax_id(case))
    z, want = got[key][0], refs[case]
    assert np.abs(z - want).max() <= TOL[case[2]] * np.abs(want).max()
