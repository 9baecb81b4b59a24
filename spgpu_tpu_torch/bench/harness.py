"""Benchmark harness: spGPU's hellPerf/diaPerf protocol on the port.

Counterpart of :mod:`spgpu_tpu.bench.harness`.  :func:`run_config`
measures one (matrix, route) pair as the JAX one does (SURVEY §3.5,
``hellPerf.cpp:209-252``): convert, make x, a warm-up product, the
checksum ‖z‖², then the timed product, GFLOPS = (2·nnz − 1)/t.  Beside
the checksum it gives ``golden_checksum``, ‖z‖² of the float64 (complex128)
host product on the same x.  :func:`run_suite` runs the JAX suite's rows
at its sizes and seeds, then :func:`run_blas1_suite` and
:func:`run_baseline_rows`; :func:`run_weak_scaling` runs the distributed
SpMV on one process per shard.  Each prints one JSON line per row and
writes no file.

Timing.  On the card a row's ``t_avg_s`` is the device time of one call
(:func:`~spgpu_tpu_torch.utils.timing.device_ms`), and ``t_source`` says
where it comes from: ``"profiler"``, or ``"cuda_events"`` where no
profiling session was usable, an upper bound that counts the host's
gaps; ``t_call_s`` is the time per call from CUDA events
(:func:`~spgpu_tpu_torch.utils.timing.time_interleaved`).  On the CPU
both are the host clock's (``"host"``), and the kernels' plain versions
run.  The JAX loop chains each product into the next x to defeat a TPU
runtime's per-call cost; the port times the call itself.

Bytes.  ``bytes_moved`` is what the route reads and writes: the
:func:`~spgpu_tpu_torch.utils.measure.nbytes` of the layout tensors its
kernel (or plain product) takes, plus x and z.  The JAX formulas assume
the TPU's layouts (double-float planes, two real planes for complex,
aligned windows); the port's differ.

The suite's rows keep the JAX ``config`` names; ``fmt`` names the
port's route (the kernel numbers of ``PERF.md`` §6):

=============================================  ====================
JAX config / fmt                               port fmt
=============================================  ====================
laplacian_2d / ell_xla                         ell_torch (plain)
fem_irregular / whell_packed_pallas            whell_packed_k1
banded / whdia_pallas                          whdia_k3
banded_straight / sdia_pallas                  sdia_k2
laplacian_2d / sdia_pallas                     sdia_k2
laplacian_2d_fp64 / sdia_dd_pallas             sdia_f64_k5
laplacian_2d_fp64 / whell_dd_pallas            whell_f64_k4
fem_irregular_c64 / whell_complex_pallas       whell_c64_k7
banded_c64 / whdia_complex_pallas              whdia_c64_k9
fem_irregular / whell_pallas_spmm8             whell_spmm8_k12
fem_irregular / hell_xla_spmm8                 hell_spmm8_torch (plain)
=============================================  ====================

The double-float rows draw float64 x from the JAX draw (the JAX package
splits it into a hi/lo pair); the complex rows join its ``(2, n)`` draw
as ``x[0] + 1j·x[1]``.  :func:`run_baseline_rows` puts a
``torch_sparse_csr`` row (``torch.sparse_csr_tensor @ x``, cuSPARSE on
the card, never on a path) where the JAX one has ``jax_sparse_bcoo``.

:func:`run_weak_scaling` sends exactly the halo lanes each pair needs,
so ``halo_slots_sent`` (the lanes the ranks' send buffers held) equals
``halo_lanes_used`` (the plan's) and ``k_padding_waste`` is 0 by
design, where the JAX exchange pads each pair to a common width.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise.

    python -m spgpu_tpu_torch.bench.harness [--chip] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from spgpu_tpu_torch.core import hbm_bandwidth, require_cuda
from spgpu_tpu_torch.formats.hybrid import layout_bytes
from spgpu_tpu_torch.utils.measure import nbytes
from spgpu_tpu_torch.utils.timing import (device_ms, loop_seconds, squared_norm,
                                          time_interleaved)

__all__ = ["BenchResult", "run_config", "run_suite", "run_weak_scaling",
           "run_blas1_suite", "run_baseline_rows", "suite_rows"]


@dataclasses.dataclass
class BenchResult:
    config: str
    fmt: str
    n_rows: int
    nnz: int
    storage_bytes: int
    pad_factor: float
    t_avg_s: float
    gflops: float
    eff_bandwidth_gbs: float
    roofline_frac: Optional[float]
    checksum: float
    #: where ``t_avg_s`` comes from: "profiler", "cuda_events" or "host"
    t_source: str
    #: seconds per call from CUDA events (the host clock's on the CPU)
    t_call_s: float
    golden_checksum: float
    bytes_moved: int
    #: the kernel launches of the checked product, ``{"module.NAME": n}``
    #: (every counter set to 0 just before it; none on the CPU)
    launches: dict
    #: the card's name, or "cpu"
    device: str

    def json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def _device(device) -> torch.device:
    """``device``, or the first card (raising without one) for ``None``."""
    return require_cuda() if device is None else torch.device(device)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn: Callable[[], object], device: torch.device, iters: int):
    """``(seconds, source, seconds per call)`` of one ``fn()``: device
    time and CUDA events on a card, the host clock (after one call)
    elsewhere."""
    if device.type == "cuda":
        ms, src = device_ms(fn, iters=iters)
        call = time_interleaved({"fn": fn}, iters=iters)["fn"]["best_ms"]
        return ms / 1e3, src, call / 1e3
    fn()
    t = loop_seconds(fn, iters)
    return t, "host", t


def _counted(fn: Callable[[], object], device: torch.device):
    """``fn()`` with every kernel launch counter set to 0 just before and
    read just after it (the device synchronised between): its result and
    the counters it moved, ``{"module.NAME": n}``."""
    from spgpu_tpu_torch import kernels

    kernels.reset_launch_counts()
    out = fn()
    _sync(device)
    return out, {kernels.counter_name(k): n for k, n in kernels.launch_counts().items() if n}


def _golden_checksum(coo, x: np.ndarray) -> float:
    """‖A @ x‖² of the host COO in float64 (complex128), duplicates added,
    for ``x`` ``(..., n_cols)`` in the original numbering."""
    import scipy.sparse as sp

    wide = np.complex128 if np.iscomplexobj(coo.values) or np.iscomplexobj(x) \
        else np.float64
    a = sp.csr_matrix((coo.values.astype(wide), (coo.rows, coo.cols)), shape=coo.shape)
    z = a @ np.asarray(x, wide).reshape(-1, coo.n_cols).T
    return float(np.sum(np.abs(z) ** 2))


def _original_x(a, x: torch.Tensor) -> np.ndarray:
    """``x`` in the original numbering: a packed WHELL layout's lane-space
    x read at each original column's lane (the matrices here are square)."""
    lor = getattr(a, "lane_of_row", None)
    if lor is not None:
        x = x[..., lor.long()]
    return x.detach().cpu().numpy()


def run_config(config: str, fmt: str, coo, convert: Callable, spmv: Callable,
               tensors: Callable, iters: int = 20, seed: int = 1,
               flops_factor: float = 1.0, make_x: Optional[Callable] = None,
               device=None) -> BenchResult:
    """Measure one (matrix, route) pair with spGPU's protocol.

    ``convert(coo, device)`` builds the layout, ``spmv(a, x)`` is the
    product, ``tensors(a)`` the layout tensors it reads; ``make_x(a, coo,
    rng)`` (default: a normal draw of ``a.n_cols``, lane space for a
    packed layout, in the values' type) gives x, moved to the device.
    ``device=None`` is the card (raises without one); ``"cpu"`` runs the
    plain versions, timed by the host clock.  The checked product runs
    with every kernel launch counter set to 0 just before it; the row's
    ``launches`` is what they read after it."""
    device = _device(device)
    a = convert(coo, device)
    rng = np.random.default_rng(seed)
    if make_x is not None:
        x = make_x(a, coo, rng)
    else:
        x = rng.standard_normal(getattr(a, "n_cols", coo.n_cols)).astype(coo.values.dtype)
    x = torch.as_tensor(x).to(device)
    z, launches = _counted(lambda: spmv(a, x), device)
    checksum = squared_norm(z)
    golden = _golden_checksum(coo, _original_x(a, x))
    t, source, t_call = _time(lambda: spmv(a, x), device, iters)
    moved = nbytes(*tensors(a)) + nbytes(x, z)
    bw = hbm_bandwidth(device)
    return BenchResult(
        config=config, fmt=fmt, n_rows=coo.n_rows, nnz=coo.nnz,
        storage_bytes=layout_bytes(a), pad_factor=a.values.numel() / max(coo.nnz, 1),
        t_avg_s=t, gflops=flops_factor * (2.0 * coo.nnz - 1.0) / t * 1e-9,
        eff_bandwidth_gbs=moved / t / 1e9,
        roofline_frac=(moved / t) / bw if bw else None, checksum=checksum,
        t_source=source, t_call_s=t_call, golden_checksum=golden, bytes_moved=moved,
        launches=launches, device=_device_name(device))


# -- the tensors each route reads ---------------------------------------


def whell_tensors(a):
    """Packed WHELL's hack pass (#1, #4, #7, #12): the slab, its index
    bytes, the tile pages, the runs' work units and the output segments."""
    return (a.values, a.residue, a.page_tab, a.tile_page, a.group_bases,
            a.hack_units, a.seg_lo, a.seg_hi)


def whdia_tensors(a):
    """WHDIA's live-slot passes (#3, #9): the slab, its r0 words, the tile
    pages and the live-slot list."""
    return (a.values, a.slot_r0, a.tile_r0, a.tile_page, a.hack_slot_ptr,
            a.hack_slots)


def sdia_tensors(a):
    """SDIA (#2, #5): the diagonal planes and their offset table."""
    return (a.values, a.offset_table)


def ell_tensors(a):
    """ELL's plain product: the slab, its columns and the OELL row order."""
    return (a.values, a.col_indices, a.row_perm)


def hell_tensors(a):
    """HELL's plain product: the slab, its columns, the hack ranges and the
    row order."""
    return (a.values, a.col_indices, a.hack_offsets, a.row_perm)


def _with_imag(coo, seed: int, dtype):
    """``coo`` plus ``1j·N(0, 1)`` (``default_rng(seed)``) on each entry."""
    from spgpu_tpu_torch.formats.coo import CooMatrix

    im = np.random.default_rng(seed).standard_normal(coo.nnz)
    return CooMatrix(coo.rows, coo.cols, (coo.values + 1j * im).astype(dtype),
                     coo.n_rows, coo.n_cols)


def _complex_x(a, coo, rng):
    """The JAX complex rows' ``(2, n)`` draw joined as ``x[0] + 1j·x[1]``."""
    x = rng.standard_normal((2, a.n_cols))
    return (x[0] + 1j * x[1]).astype(np.complex64)


def suite_rows(size: str, device):
    """The SpMV/SpMM rows of :func:`run_suite` on ``device``, in order:
    ``(config, fmt, coo, convert, spmv, tensors, options)``, the
    arguments of :func:`run_config` (``options`` its keywords), the
    fixtures made as each row is reached."""
    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.convert import (coo_to_ell, coo_to_hell, coo_to_sdia,
                                         coo_to_whdia, coo_to_whell)
    from spgpu_tpu_torch.utils.fixtures import laplacian_2d, random_banded, random_fem_like

    device = torch.device(device)
    big = size == "chip"
    fp = np.float32 if device.type == "cuda" else np.float64
    whell = (lambda c, d: coo_to_whell(c, device=d), ops.whell_spmv, whell_tensors)
    whdia = (lambda c, d: coo_to_whdia(c, device=d), ops.whdia_spmv, whdia_tensors)
    sdia = (lambda c, d: coo_to_sdia(c, device=d), ops.sdia_spmv, sdia_tensors)

    side = 64 if big else 48
    yield ("laplacian_2d", "ell_torch", laplacian_2d(side, side, fp),
           lambda c, d: coo_to_ell(c, device=d), ops.ell_spmv, ell_tensors, dict(iters=5))

    fem = random_fem_like((1 << 18) if big else 20000, 27.0, span=768,
                          far_frac=0.01, seed=0, dtype=np.float32)
    yield ("fem_irregular", "whell_packed_k1", fem, *whell,
           dict(iters=200 if big else 5))

    band = random_banded((1 << 19) if big else 20000, bands=11, wander=7, seed=2,
                         dtype=np.float32).sum_duplicates()
    yield "banded", "whdia_k3", band, *whdia, dict(iters=200 if big else 5)

    band_s = random_banded((1 << 19) if big else 20000, bands=11, wander=0, seed=2,
                           dtype=np.float32).sum_duplicates()
    yield "banded_straight", "sdia_k2", band_s, *sdia, dict(iters=200 if big else 5)
    side = 1024 if big else 48
    yield ("laplacian_2d", "sdia_k2", laplacian_2d(side, side, np.float32), *sdia,
           dict(iters=200 if big else 5))

    side = 1024 if big else 32
    yield ("laplacian_2d_fp64", "sdia_f64_k5", laplacian_2d(side, side, np.float64),
           *sdia, dict(iters=100 if big else 3,
                       make_x=lambda a, coo, rng: rng.standard_normal(coo.n_cols)))
    side = 512 if big else 32
    yield ("laplacian_2d_fp64", "whell_f64_k4", laplacian_2d(side, side, np.float64),
           *whell, dict(iters=50 if big else 3,
                        make_x=lambda a, coo, rng: rng.standard_normal(a.n_cols)))

    fem_c = _with_imag(random_fem_like((1 << 18) if big else 1500, 27.0, span=768,
                                       far_frac=0.01, seed=5, dtype=np.float32),
                       6, np.complex64)
    yield ("fem_irregular_c64", "whell_c64_k7", fem_c, *whell,
           dict(iters=50 if big else 3, flops_factor=4.0, make_x=_complex_x))
    band_c = _with_imag(random_banded((1 << 19) if big else 1200, bands=11, wander=7,
                                      seed=2, dtype=np.float64).sum_duplicates(),
                        8, np.complex64)
    yield ("banded_c64", "whdia_c64_k9", band_c, *whdia,
           dict(iters=50 if big else 3, flops_factor=4.0, make_x=_complex_x))

    yield ("fem_irregular", "whell_spmm8_k12", fem, whell[0], ops.whell_spmm,
           whell_tensors, dict(iters=50 if big else 3, flops_factor=8.0, make_x=lambda
                               a, coo, rng: rng.standard_normal((8, a.n_cols)).astype(
                                   np.float32)))
    fem_s = random_fem_like(20000, 27.0, span=768, far_frac=0.01, seed=0,
                            dtype=np.float32)
    yield ("fem_irregular", "hell_spmm8_torch", fem_s,
           lambda c, d: coo_to_hell(c, device=d), ops.hell_spmv, hell_tensors,
           dict(iters=3, seed=3, flops_factor=8.0, make_x=lambda a, coo, rng:
                rng.standard_normal((8, coo.n_cols)).astype(np.float32)))


def run_suite(size: str = "small", out=print, device=None) -> list:
    """The JAX suite's rows (``spgpu_tpu/bench/harness.py:144-327``) at its
    sizes and seeds (:func:`suite_rows`), then the BLAS-1 and baseline
    rows; one JSON line per row through ``out``.  ``size``: "small" or
    "chip".  Values are float32 on the card and float64 on the CPU where
    the JAX suite picks by platform (its ELL row).  ``device=None`` is the
    card (raises without one).  Returns the :class:`BenchResult` s and the
    BLAS-1 and baseline dicts, in order."""
    device = _device(device)
    big = size == "chip"
    results = []

    def emit(r):
        results.append(r)
        out(r.json() if isinstance(r, BenchResult) else json.dumps(r))

    fem = None
    for config, fmt, coo, convert, spmv, tensors, options in suite_rows(size, device):
        if fmt == "whell_packed_k1":
            fem = coo
        emit(run_config(config, fmt, coo, convert, spmv, tensors, device=device,
                        **options))
    for r in run_blas1_suite(n=(1 << 26) if big else (1 << 16), iters=50 if big else 5,
                             device=device):
        emit(r)
    for r in run_baseline_rows(fem, big, device=device):
        emit(r)
    return results


def run_blas1_suite(n: int, iters: int = 200, device=None) -> list:
    """BLAS-1 rows: ``dot``, ``nrm2``, ``asum``, ``amax`` and ``axpby``
    of :mod:`spgpu_tpu_torch.ops.blas1` on float32 vectors of ``n``
    (``default_rng(7)``), each timed as :func:`run_config` times a
    product, with the JAX byte counts (each input read once, ``axpby``'s
    output written once; ``harness.py:490-515``) and their share of the
    card's HBM rate.  ``device=None`` is the card."""
    from spgpu_tpu_torch.ops import blas1

    device = _device(device)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)
    bw = hbm_bandwidth(device)
    cases = {
        "dot": (lambda: blas1.dot(x, y), 2 * n * 4),
        "nrm2": (lambda: blas1.nrm2(x), n * 4),
        "asum": (lambda: blas1.asum(x), n * 4),
        "amax": (lambda: blas1.amax(x), n * 4),
        "axpby": (lambda: blas1.axpby(1.000001, x, 0.999999, y), 3 * n * 4),
    }
    rows = []
    for op, (fn, moved) in cases.items():
        t, source, t_call = _time(fn, device, iters)
        rows.append({"config": "blas1", "op": op, "n": n, "t_avg_s": t,
                     "eff_bandwidth_gbs": moved / t / 1e9,
                     "roofline_frac": (moved / t) / bw if bw else None,
                     "bytes_moved": moved, "t_source": source, "t_call_s": t_call,
                     "device": _device_name(device)})
    return rows


def run_baseline_rows(fem, big: bool, device=None) -> list:
    """Anchoring rows: the packed-WHELL conversion of ``fem`` cold and
    warm (the second call finds the host's pages resident), scipy's CSR
    SpMV on the host, and ``torch.sparse_csr_tensor @ x`` on the device
    (cuSPARSE on the card), on the same matrix and x."""
    import scipy.sparse as sp

    from spgpu_tpu_torch.convert import coo_to_whell

    device = _device(device)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        coo_to_whell(fem, device=device)
        _sync(device)
        times.append(time.perf_counter() - t0)
    rows = [{"config": "conversion", "op": "coo_to_whell_packed", "nnz": fem.nnz,
             "t_cold_s": times[0], "t_s": times[1], "nnz_per_s": fem.nnz / times[1],
             "device": _device_name(device)}]

    csr = sp.coo_matrix((fem.values, (fem.rows, fem.cols)), shape=fem.shape).tocsr()
    xh = np.random.default_rng(1).standard_normal(fem.n_cols).astype(np.float32)
    t = loop_seconds(lambda: csr @ xh, 10)
    rows.append({"config": "vendor", "op": "scipy_csr_cpu", "nnz": fem.nnz,
                 "t_avg_s": t, "gflops": 2 * fem.nnz / t / 1e9})

    a = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr.astype(np.int64)),
        torch.from_numpy(csr.indices.astype(np.int64)),
        torch.from_numpy(csr.data), size=fem.shape, check_invariants=True).to(device)
    x = torch.from_numpy(xh).to(device)
    t, source, t_call = _time(lambda: a @ x, device, 50 if big else 5)
    rows.append({"config": "vendor", "op": "torch_sparse_csr", "nnz": fem.nnz,
                 "t_avg_s": t, "gflops": 2 * fem.nnz / t / 1e9, "t_source": source,
                 "t_call_s": t_call, "device": _device_name(device)})
    return rows


# -- weak scaling over ranks --------------------------------------------


def _rank_seconds(fn: Callable[[], object], rg, iters: int) -> float:
    """Seconds per ``fn()`` on this rank: two warm-up calls, a barrier,
    then ``iters`` calls between CUDA events (card) or host clock reads."""
    import torch.distributed as dist

    fn()
    fn()
    _sync(rg.device)
    dist.barrier(group=rg.group)
    if rg.device.type == "cuda":
        return time_interleaved({"fn": fn}, reps=1, iters=iters,
                                warmup=0)["fn"]["best_ms"] / 1e3
    return loop_seconds(fn, iters)


def _weak_scaling_rank(rg, pm, x: np.ndarray, iters: int, breakdown: bool) -> dict:
    """One rank of :func:`run_weak_scaling`: its shard's product, checked
    once (the global z gathered) with the kernel counters set to 0 just
    before it and read after it, and the halo lanes it sent, then timed
    whole and, with ``breakdown``, by stage: the exchange, the interior
    product, the exterior product."""
    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.parallel.dist_spmv import ShardedHandle

    h = ShardedHandle(pm, rg)
    xl = h.embed(x)
    z, launches = _counted(lambda: h.matvec(xl), rg.device)
    out = {"z": h.extract(z).cpu().numpy(), "launches": launches,
           "lanes_sent": h.lanes_sent,
           "t_s": _rank_seconds(lambda: h.matvec(xl), rg, iters)}
    if breakdown:
        out["t_coll_s"] = _rank_seconds(lambda: h.exchange(xl), rg, iters)
        out["t_int_s"] = _rank_seconds(lambda: ops.spmv(h.interior, xl), rg, iters)
        # every rank times every stage (the barriers pair up); a shard with
        # no exterior times nothing there
        out["t_ext_s"] = _rank_seconds(
            (lambda: None) if h.exterior is None
            else lambda: ops.spmv(h.exterior, h.work), rg, iters)
    return out


def run_weak_scaling(rows_per_shard: int = 65536, shards=(1, 2, 4, 8), iters: int = 20,
                     out=print, breakdown: bool = True, device: str = "cuda") -> list:
    """Weak scaling of the packed distributed SpMV (``harness.py:332-446``):
    ``random_banded(rows_per_shard·S, 11, wander=3, seed=2)``, duplicates
    summed, in an S-shard packed partition on S ranks
    (:func:`~spgpu_tpu_torch.parallel.group.run_ranks`, one process a
    shard: NCCL on the cards, gloo with ``device="cpu"``); S beyond the
    cards present is skipped.  Efficiency = (nnz/s at S) / (S × nnz/s per
    shard at the smallest S run).

    Each row is rank 0's, its ``t_avg_s`` the slowest rank's time per
    product (CUDA events on the card: ``t_source`` "cuda_events", an upper
    bound on the device time; the host clock on the CPU).  ``breakdown``
    adds rank 0's exchange, interior and exterior times, the overlap gain
    (their sum less rank 0's whole product) and the halo: the lanes the
    plan uses, the lanes the ranks' checked products sent (equal: exact
    counts), bytes per product, and ``k_padding_waste`` 0.
    ``max_rel_err`` is the gathered product's against the host golden;
    ``launches`` rank 0's kernel launches in that product (its counters
    set to 0 just before it)."""
    from spgpu_tpu_torch.parallel.group import run_ranks
    from spgpu_tpu_torch.parallel.partition_packed import partition_coo_rows_packed
    from spgpu_tpu_torch.utils.fixtures import random_banded

    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    cards = torch.cuda.device_count() if device == "cuda" else None
    if device == "cuda":
        require_cuda()
    rows, base_rate = [], None
    for S in shards:
        if cards is not None and S > cards:
            continue
        n = rows_per_shard * S
        coo = random_banded(n, bands=11, wander=3, seed=2,
                            dtype=np.float32).sum_duplicates()
        pm = partition_coo_rows_packed(coo, S)
        x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
        res = run_ranks(S, "spgpu_tpu_torch.bench.harness:_weak_scaling_rank", pm, x,
                        iters, breakdown, device=device)
        golden = coo.spmv(x.astype(np.float64))
        t = max(r["t_s"] for r in res)
        rate = coo.nnz / t
        if base_rate is None:
            base_rate = rate / S
        r0 = res[0]
        row = {"config": "weak_scaling", "fmt": "packed_dist_spmv", "shards": S,
               "n_rows": n, "nnz": coo.nnz, "t_avg_s": t, "nnz_per_s": rate,
               "efficiency": rate / (S * base_rate),
               "t_source": "cuda_events" if device == "cuda" else "host",
               "max_rel_err": float(np.abs(r0["z"] - golden).max() / np.abs(golden).max()),
               "launches": r0["launches"],
               "device": _device_name(torch.device(device, 0) if device == "cuda"
                                      else torch.device("cpu"))}
        if breakdown:
            sent = sum(r["lanes_sent"] for r in res)
            row.update(t_coll_s=r0["t_coll_s"], t_int_s=r0["t_int_s"],
                       t_ext_s=r0["t_ext_s"],
                       overlap_gain_s=r0["t_coll_s"] + r0["t_int_s"] + r0["t_ext_s"]
                       - r0["t_s"],
                       halo_lanes_used=sum(sum(c) for c in pm.halo_counts),
                       halo_slots_sent=sent, halo_bytes_per_iter=sent * 4,
                       k_padding_waste=0.0)
        rows.append(row)
        if out:
            out(json.dumps(row))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--chip", action="store_true", help="the full single-card sizes")
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain versions on the host (default: the card)")
    args = p.parse_args(argv)
    run_suite("chip" if args.chip else "small", device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
