#!/usr/bin/env python3
"""Smoke test of the PyTorch port (spgpu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels and the host layout helpers from the checkout's
sources, then drives the port's two routes at full size and checks them:

1. env       — GPU name and power limit, CUDA version, nvcc and g++;
2. build     — seconds and ptxas register/spill lines for each library,
               the three nvcc builds started together (into
               spgpu_tpu_torch/_build/);
3. spmv      — the flagship FEM-like matrix (262,144 rows, 6.7M nnz):
               convert, ``whell_spmv`` through kernel #1, held against the
               plain PyTorch version on the card and against the host COO
               golden in float64; kernel and plain times (CUDA events and
               profiler device time);
4. bf16      — the same with bf16 values and float32 x;
5. solve     — ``solve()`` on the SPD system (A+Aᵀ)/2 with a dominant
               diagonal, auto-selected format (whell), CG to 1e-5; the
               true residual is checked on the host in float64, and the
               kernel's launch count must cover every CG iteration;
6. sdia      — the 1024x1024 2-D Laplacian (1,048,576 rows) through
               ``coo_to_sdia`` and ``sdia_spmv`` (kernel #2), checked and
               timed as in 3;
7. whdia     — ``coo_to_whdia`` and ``whdia_spmv`` (kernel #3) on the
               banded-11 fixture (524,288 rows, pattern mode) and on the
               Laplacian (slab mode), checked and timed as in 3;
8. solve_dia — three solves through ``solve()``: CG on the Laplacian
               with auto-selection (whdia), CG with ``fmt="sdia"``, and
               BiCGSTAB on a contiguous banded-11 system with
               ``fmt="whdia"``; each is checked as in 5 against its
               route's launch count.

Each phase prints one JSON line.  Then it prints the kernel table (one
JSON line), the ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
then non-zero and no result line is printed.  It needs a CUDA device and
the rest of the repository, and exits non-zero without either.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: kernel name -> (route, source, the TPU kernel it replaces)
KERNELS = {
    "whell_packed_spmv": ("cuda", "spgpu_tpu_torch/csrc/whell_packed_spmv.cu",
                          "spgpu_tpu/ops/pallas_kernels.py:120"),
    "sdia_spmv": ("cuda", "spgpu_tpu_torch/csrc/sdia_spmv.cu",
                  "spgpu_tpu/ops/pallas_kernels.py:2264"),
    "whdia_spmv": ("cuda", "spgpu_tpu_torch/csrc/whdia_spmv.cu",
                   "spgpu_tpu/ops/pallas_kernels.py:1283"),
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def flagship(dtype=np.float32):
    """The flagship SpMV fixture of the JAX package's benchmark."""
    from spgpu_tpu_torch.utils.fixtures import random_fem_like

    return random_fem_like(262144, 27.0, span=768, far_frac=0.01, seed=0,
                           dtype=dtype)


def spd_from(coo):
    """(A + Aᵀ)/2 with duplicates summed and each diagonal entry set to
    its row's off-diagonal |·|-sum + 1 (strictly dominant: SPD)."""
    from spgpu_tpu_torch.formats.coo import CooMatrix

    n = coo.n_rows
    v = coo.values.astype(np.float64) / 2
    sym = CooMatrix(np.concatenate([coo.rows, coo.cols]),
                    np.concatenate([coo.cols, coo.rows]),
                    np.concatenate([v, v]), n, n).sum_duplicates()
    off = sym.rows != sym.cols
    diag = np.bincount(sym.rows[off], weights=np.abs(sym.values[off]),
                       minlength=n) + 1.0
    idx = np.arange(n, dtype=np.int64)
    return CooMatrix(np.concatenate([sym.rows[off], idx]),
                     np.concatenate([sym.cols[off], idx]),
                     np.concatenate([sym.values[off], diag]).astype(np.float32),
                     n, n).sum_duplicates()


def check_close(got, want, rtol, atol_frac, what):
    """allclose with ``atol = atol_frac * max|want|``; returns max|err|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{what}: shape {got.shape} vs {want.shape} or "
                             "non-finite values")
    atol = atol_frac * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    return float(np.abs(got - want).max())


def timed_pair(kernel, plain):
    """Times per call of a kernel and its plain version: CUDA events
    around interleaved runs of 20 calls (host-bound when the Python
    wrapper outlasts the kernel) and device time, with its source
    (``profiler``, or ``cuda_events`` when no profiling session recorded
    device activity)."""
    from spgpu_tpu_torch.utils.timing import device_ms, time_interleaved

    t = time_interleaved({"kernel": kernel, "plain": plain}, reps=5, iters=20)
    kdev, ksrc = device_ms(kernel)
    pdev, psrc = device_ms(plain)
    return dict(
        kernel_ms=t["kernel"]["best_ms"], kernel_spread_ms=t["kernel"]["spread_ms"],
        plain_ms=t["plain"]["best_ms"], plain_spread_ms=t["plain"]["spread_ms"],
        kernel_device_ms=kdev, plain_device_ms=pdev,
        kernel_device_source=ksrc, plain_device_source=psrc)


def spmv_phase(coo, a, device, label):
    """Kernel vs plain vs host golden on one converted matrix, and both
    versions' times."""
    import torch

    from spgpu_tpu_torch.kernels import whell as kw
    from spgpu_tpu_torch.ops import _prep_x, whell_spmv

    x = np.random.default_rng(7).standard_normal(coo.n_cols).astype(np.float32)
    xl = a.embed(torch.from_numpy(x), dtype=torch.float32)
    before = kw.LAUNCHES
    z = whell_spmv(a, xl)
    torch.cuda.synchronize(device)
    if kw.LAUNCHES != before + 1:
        raise AssertionError("whell_spmv did not launch the kernel")
    args = (a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
            a.group_bases, a.seg_lo, a.seg_hi, _prep_x(xl, a.n_cols, a.x_pages))
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  window_pages=a.window_pages, unit_segments=a.unit_segments)
    zp = kw.whell_packed_spmv_plain(*args, **static).view(-1)[: a.n_rows]
    zc, pc = z.cpu().numpy(), zp.cpu().numpy()
    # atomics sum each lane's tiles in another order than index_add_
    err_plain = check_close(zc, pc, 1e-5, 1e-5, f"{label}: kernel vs plain")
    # host golden in float64
    golden = coo.spmv(x.astype(np.float64))
    z_orig = a.extract(z, dtype=torch.float64).cpu().numpy()
    err_golden = check_close(z_orig, golden, 1e-4, 1e-4,
                             f"{label}: kernel vs host golden")
    slab_bytes = a.total_slots * 128 * (a.values.element_size() + 2)
    t = timed_pair(lambda: kw.whell_packed_spmv(*args, **static),
                   lambda: kw.whell_packed_spmv_plain(*args, **static))
    return dict(
        nnz=coo.nnz, tiles=a.num_tiles, lane_space=a.n_rows,
        padding=a.total_slots * 128 / coo.nnz, slab_mib=slab_bytes / 2**20,
        max_abs_err_vs_plain=err_plain, max_abs_err_vs_golden=err_golden, **t,
        kernel_gflops=2 * coo.nnz / (t["kernel_ms"] * 1e6),
        kernel_device_gflops=2 * coo.nnz / (t["kernel_device_ms"] * 1e6),
        plain_gflops=2 * coo.nnz / (t["plain_ms"] * 1e6),
        kernel_device_slab_gbytes_per_s=slab_bytes / (t["kernel_device_ms"] * 1e6))


def dia_phase(coo, kernel, plain, op_z, nbytes, rtol_plain, label, device):
    """A DIA-class kernel on the card against its plain version (at
    ``rtol_plain``, atol rtol_plain·max|z|) and the float64 host golden
    (rtol = atol/max|golden| = 2e-5), then both versions' times.
    ``kernel``/``plain`` map x to the padded product, ``op_z`` to the
    op's ``(n_rows,)`` result; ``nbytes`` is values + x + z."""
    import torch

    x = np.random.default_rng(7).standard_normal(coo.n_cols).astype(np.float32)
    xt = torch.from_numpy(x).to(device)
    z = op_z(xt)
    torch.cuda.synchronize(device)
    n = coo.n_rows
    zp = plain(xt)[:n]
    err_plain = check_close(z.cpu().numpy(), zp.cpu().numpy(), rtol_plain,
                            rtol_plain, f"{label}: kernel vs plain")
    err_golden = check_close(z.cpu().numpy(), coo.spmv(x.astype(np.float64)),
                             2e-5, 2e-5, f"{label}: kernel vs host golden")
    t = timed_pair(lambda: kernel(xt), lambda: plain(xt))
    return dict(
        rows=n, nnz=coo.nnz, max_abs_err_vs_plain=err_plain,
        max_abs_err_vs_golden=err_golden, **t,
        kernel_gflops=2 * coo.nnz / (t["kernel_ms"] * 1e6),
        kernel_device_gflops=2 * coo.nnz / (t["kernel_device_ms"] * 1e6),
        plain_device_gflops=2 * coo.nnz / (t["plain_device_ms"] * 1e6),
        bytes_mib=nbytes / 2**20,
        kernel_device_gbytes_per_s=nbytes / (t["kernel_device_ms"] * 1e6))


def counted_solve(coo, b, counter, device, **kw):
    """``solve()`` with ``counter.LAUNCHES`` set to 0 just before and read
    just after; checks convergence, one launch per iteration at least,
    and the float64 host true residual ≤ 1e-4."""
    import torch

    from spgpu_tpu_torch.solvers import solve

    counter.LAUNCHES = 0
    t0 = time.perf_counter()
    res = solve(coo, b, device=device, **kw)
    torch.cuda.synchronize(device)
    solve_s = time.perf_counter() - t0
    launches = counter.LAUNCHES
    if not bool(res.converged):
        raise AssertionError(f"solve({kw}) did not converge in "
                             f"{res.iterations} iterations (residual "
                             f"{float(res.residual_norm)})")
    if launches < res.iterations:
        raise AssertionError(f"solve({kw}): {launches} kernel launches for "
                             f"{res.iterations} iterations")
    xs = res.x.cpu().double().numpy()
    bb = np.asarray(b, np.float64)
    true_res = float(np.linalg.norm(bb - coo.spmv(xs)) / np.linalg.norm(bb))
    if not true_res <= 1e-4:
        raise AssertionError(f"solve({kw}): true residual {true_res} > 1e-4")
    return res, xs, dict(iterations=res.iterations, launches=launches,
                         solve_total_s=solve_s, true_residual=true_res,
                         solver_residual=float(res.residual_norm
                                               / np.linalg.norm(bb)))


def loop_timing(solver, mv, b, tol):
    """ms per iteration of the Krylov loop alone (host clock to a
    synchronise) and device ms per iteration of 20 fixed iterations
    (tol=0 never stops early), as in the solve phase.  The idle share is
    null when the device time is not the profiler's (see ``timed_pair``)."""
    import torch

    from spgpu_tpu_torch.utils.timing import device_ms

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = solver(mv, b, tol=tol, maxiter=5000)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / max(r.iterations, 1)
    dev, src = device_ms(lambda: solver(mv, b, tol=0.0, maxiter=20), iters=1,
                         warmup=1)
    dev /= 20
    return dict(loop_iterations=r.iterations, ms_per_iter=ms,
                device_ms_per_iter=dev, device_source=src,
                device_idle_share=1 - dev / ms if src == "profiler" else None)


def build_all():
    """The host helpers, then the three kernel libraries, all nvcc
    builds started together."""
    from spgpu_tpu_torch import native
    from spgpu_tpu_torch.kernels import sdia, whdia, whell

    host_s = native.build()
    libs = {"whell_packed_spmv": whell, "sdia_spmv": sdia, "whdia_spmv": whdia}
    with ThreadPoolExecutor(len(libs)) as ex:
        futs = {name: ex.submit(m.build) for name, m in libs.items()}
        done = {name: f.result() for name, f in futs.items()}
    return dict(host_lib_s=host_s, cuda_libs={
        name: dict(seconds=sec, ptxas=[ln.strip() for ln in log.splitlines()
                                       if "registers" in ln or "spill" in ln])
        for name, (sec, log) in done.items()})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spgpu_tpu_torch.convert import (coo_to_sdia, coo_to_whdia,
                                         coo_to_whell, suggest_format)
    from spgpu_tpu_torch.kernels import sdia as ks
    from spgpu_tpu_torch.kernels import whdia as kd
    from spgpu_tpu_torch.kernels import whell as kw
    from spgpu_tpu_torch.ops import sdia_spmv, whdia_spmv, whell_spmv
    from spgpu_tpu_torch.solvers import bicgstab, cg
    from spgpu_tpu_torch.utils.fixtures import laplacian_2d, random_banded

    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit("env", gpu=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         nvcc=shutil.which("nvcc") or (
             "/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc")
             else None),
         gxx=shutil.which("g++"))

    emit("build", **build_all())

    # --- flagship SpMV, fp32 ------------------------------------------
    coo = flagship()
    fmt = suggest_format(coo)
    t0 = time.perf_counter()
    a = coo_to_whell(coo, device=device)
    torch.cuda.synchronize(device)
    convert_s = time.perf_counter() - t0
    spmv = spmv_phase(coo, a, device, "spmv fp32")
    emit("spmv", fmt=fmt, convert_s=convert_s, **spmv)
    del a

    # --- bf16 values, fp32 x -------------------------------------------
    a16 = coo_to_whell(coo, device=device, dtype="bfloat16")
    from spgpu_tpu_torch.formats.coo import CooMatrix

    v16 = torch.from_numpy(coo.values).to(torch.bfloat16).double().numpy()
    coo16 = CooMatrix(coo.rows, coo.cols, v16, coo.n_rows, coo.n_cols)
    emit("bf16", **spmv_phase(coo16, a16, device, "spmv bf16"))
    del a16

    # --- SPD solve: the main path, counted -----------------------------
    spd = spd_from(coo)
    fmt_spd = suggest_format(spd)
    if fmt_spd != "whell":
        raise AssertionError(f"auto-selection chose {fmt_spd!r}, not whell")
    x_true = np.random.default_rng(1).standard_normal(spd.n_rows)
    b = spd.spmv(x_true).astype(np.float32)
    _, xs, solved = counted_solve(spd, b, kw, device, tol=1e-5, maxiter=1000)
    launches = solved["launches"]
    # the CG loop alone, on a fresh layout, for ms/iteration
    a_spd = coo_to_whell(spd, device=device)
    b_l = a_spd.embed(torch.from_numpy(b), dtype=torch.float32)
    emit("solve", fmt=fmt_spd, nnz=spd.nnz, max_row_degree=int(spd.row_lengths().max()),
         tiles=a_spd.num_tiles, lane_space=a_spd.n_rows,
         padding=a_spd.total_slots * 128 / spd.nnz, **solved,
         **loop_timing(cg, lambda v: whell_spmv(a_spd, v), b_l, 1e-5),
         x_err_vs_true=float(np.abs(xs - x_true).max()))
    del a_spd

    # --- SDIA: the 2-D Laplacian, kernel #2 -----------------------------
    lap = laplacian_2d(1024, 1024, np.float32)
    t0 = time.perf_counter()
    sa = coo_to_sdia(lap, device=device)
    torch.cuda.synchronize(device)
    convert_s = time.perf_counter() - t0
    sdia = dia_phase(
        lap, lambda x: ks.sdia_spmv(sa.values, sa.offset_table, x, n_rows=sa.n_rows),
        lambda x: ks.sdia_spmv_plain(sa.values, sa.offsets, x, n_rows=sa.n_rows),
        lambda x: sdia_spmv(sa, x),
        4 * (sa.values.numel() + lap.n_cols + lap.n_rows), 1e-6, "sdia laplace",
        device)
    emit("sdia", fixture="laplacian_2d(1024, 1024)", convert_s=convert_s,
         offsets=list(sa.offsets), value_mib=4 * sa.values.numel() / 2**20, **sdia)
    del sa

    # --- WHDIA: banded-11 (pattern mode) and the Laplacian (slab) --------
    whdia = {}
    for label, coo, mode in (
            ("banded11", random_banded(2**19, 11, wander=7, seed=2,
                                       dtype=np.float32), "pattern"),
            ("laplace", lap, "slab")):
        t0 = time.perf_counter()
        wa = coo_to_whdia(coo, device=device)
        torch.cuda.synchronize(device)
        convert_s = time.perf_counter() - t0
        got = "pattern" if wa.pattern_mode else "slab"
        if got != mode:
            raise AssertionError(f"whdia {label}: {got} mode, expected {mode}")
        args = (wa.values, wa.slot_r0, wa.tile_r0, wa.tile_base, wa.chunk_group)
        static = dict(chunk_tiles=wa.chunk_tiles, group_hacks=wa.group_hacks,
                      num_groups=wa.num_groups)
        r0_bytes = 0 if wa.pattern_mode else 2 * wa.total_slots
        whdia[label] = dia_phase(
            coo, lambda x: kd.whdia_spmv(*args, x, **static),
            lambda x: kd.whdia_spmv_plain(*args, x, **static),
            lambda x: whdia_spmv(wa, x),
            4 * (wa.values.numel() + coo.n_cols + coo.n_rows) + r0_bytes,
            1e-5, f"whdia {label}", device)
        whdia[label].update(mode=got, window_pages=wa.window_pages,
                            tiles=wa.num_tiles,
                            padding=wa.total_slots * 128 / coo.nnz,
                            value_mib=4 * wa.values.numel() / 2**20,
                            convert_s=convert_s)
        del wa, args
    emit("whdia", **whdia)

    # --- DIA-class solves through solve(): the second route, counted -----
    x_true = np.random.default_rng(1).standard_normal(lap.n_rows)
    b_lap = lap.spmv(x_true).astype(np.float32)
    fmt_lap = suggest_format(lap)
    if fmt_lap != "whdia":
        raise AssertionError(f"auto-selection chose {fmt_lap!r} on the "
                             "Laplacian, not whdia")
    solves = {}
    _, xs, solves["cg_auto_whdia"] = counted_solve(lap, b_lap, kd, device,
                                                   tol=1e-5, maxiter=5000)
    solves["cg_auto_whdia"]["x_err_vs_true"] = float(np.abs(xs - x_true).max())
    _, xs, solves["cg_sdia"] = counted_solve(lap, b_lap, ks, device, fmt="sdia",
                                             tol=1e-5, maxiter=5000)
    solves["cg_sdia"]["x_err_vs_true"] = float(np.abs(xs - x_true).max())
    # a contiguous band: the wandering bench fixture moves the dominant
    # entry off the diagonal and BiCGSTAB breaks down on it
    band = random_banded(2**19, 11, wander=0, seed=2, dtype=np.float32)
    b_band = band.spmv(np.random.default_rng(1).standard_normal(band.n_rows)
                       ).astype(np.float32)
    _, _, solves["bicgstab_whdia"] = counted_solve(
        band, b_band, kd, device, fmt="whdia", symmetric=False, tol=1e-5,
        maxiter=5000)
    whdia_launches = (solves["cg_auto_whdia"]["launches"]
                      + solves["bicgstab_whdia"]["launches"])
    # the Krylov loops alone, on fresh layouts, for ms/iteration
    wl = coo_to_whdia(lap, device=device)
    sl = coo_to_sdia(lap, device=device)
    wb = coo_to_whdia(band, device=device)
    bl = torch.from_numpy(b_lap).to(device)
    solves["cg_auto_whdia"].update(loop_timing(cg, lambda v: whdia_spmv(wl, v), bl, 1e-5))
    solves["cg_sdia"].update(loop_timing(cg, lambda v: sdia_spmv(sl, v), bl, 1e-5))
    solves["bicgstab_whdia"].update(loop_timing(
        bicgstab, lambda v: whdia_spmv(wb, v), torch.from_numpy(b_band).to(device),
        1e-5))
    emit("solve_dia", **solves)
    del wl, sl, wb

    lap_w = whdia["laplace"]
    print(json.dumps({"kernels": [
        {"name": name, "route": KERNELS[name][0], "source": KERNELS[name][1],
         "replaces": KERNELS[name][2], "launches": n, "max_abs_err": err,
         "ms": ms, "plain_ms": plain_ms}
        for name, n, err, ms, plain_ms in (
            ("whell_packed_spmv", launches, spmv["max_abs_err_vs_plain"],
             spmv["kernel_ms"], spmv["plain_ms"]),
            ("sdia_spmv", solves["cg_sdia"]["launches"],
             sdia["max_abs_err_vs_plain"], sdia["kernel_ms"], sdia["plain_ms"]),
            ("whdia_spmv", whdia_launches,
             max(w["max_abs_err_vs_plain"] for w in whdia.values()),
             lap_w["kernel_ms"], lap_w["plain_ms"]))]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
