#!/usr/bin/env python3
"""Smoke test of the PyTorch port (spgpu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels and the host layout helpers from the checkout's
sources, then drives the port's routes at full size, in float32,
float64, complex64 and complex128, and its multi-RHS products, then
runs the per-op accounts of kernels #3 and #4 (kernels #18 and #19) and
the float64 geometry sweep, and checks them:

1. env       — GPU name and power limit, CUDA version, nvcc and g++;
2. build     — seconds and ptxas register/spill lines for each library
               and for each kernel instance, the five nvcc builds started
               together (into spgpu_tpu_torch/_build/);
3. spmv      — the flagship FEM-like matrix (262,144 rows, 6.7M nnz):
               convert, ``whell_spmv`` through kernel #1 (the hack pass),
               held against the plain PyTorch version (its per-hack form)
               on the card and against the host COO golden in float64;
               one call must run exactly one device operation
               (``whell_hack_pass``: no zero fill, no flush), write every
               row of a z whose block first held NaN, and give the same
               bits twice; kernel, plain and library (cuSPARSE CSR,
               ``torch.sparse_csr_tensor @ x``) times (CUDA events and
               profiler device time), and the kernel's bound over the
               runs' bytes beside the whole slab's;
4. bf16      — the same with bf16 values and float32 x;
5. solve     — ``solve()`` on the SPD system (A+Aᵀ)/2 with a dominant
               diagonal, auto-selected format (whell), CG to 1e-5; the
               true residual is checked on the host in float64, and the
               kernel's launch count must cover every CG iteration (each
               launch captured in the loop's CUDA graph counts once per
               replay), the host may read at most ceil(iterations / K) + 2
               flags; then the Krylov loop alone on a fresh layout, the
               graphed loop (K steps a CUDA graph, ``solvers.cg``) beside
               its eager witness (``_cg_eager``, one host read per
               iteration): for each, ms per iteration, device ms per step
               (device time over the steps run, masked ones included) and
               per iteration, the idle share; for the graphed loop K, its
               steps, host reads, replays and capture ms; the two held to
               each other: the same iterations and x bit for bit on a
               route whose kernel gives the same bits every call (SDIA
               #2/#5/#8/#11, WHDIA #3, #6, #9, #10, packed WHELL #1, #4,
               #7, complex128), else iterations
               within max(1, 10 %) and the true-residual gate (every solve
               phase below does the same); and the layout's chunked runs
               (work units, rows with chunks) with, where there are
               any, the time of the counters' zero fill each product
               runs beside the kernel;
6. sdia      — the 1024x1024 2-D Laplacian (1,048,576 rows) through
               ``coo_to_sdia`` and ``sdia_spmv`` (kernel #2), checked and
               timed as in 3;
7. whdia     — ``coo_to_whdia`` and ``whdia_spmv`` (kernel #3, the warp
               pass over each hack's live slots) on the banded-11 fixture
               (524,288 rows, pattern mode) and on the Laplacian (slab
               mode), checked and timed as in 3, and also against the
               listed plain product, twice with the same bits and with
               every row written over a NaN-filled buffer, with the
               live-slot share, the live and full bounds and the kernel's
               share of each;
8. solve_dia — three solves through ``solve()``: CG on the Laplacian
               with auto-selection (whdia), CG with ``fmt="sdia"``, and
               BiCGSTAB on a contiguous banded-11 system with
               ``fmt="whdia"``; each is checked as in 5 against its
               route's launch count, and the two WHDIA solves within 10 %
               of the iterations of the same solvers on the plain version
               (every cell: the JAX kernel's product);
9. spmv_f64  — the flagship in float64 (scattered windows, the port's
               default) through kernel #4, held to 1e-12·max|z| against
               its plain float64 version (the per-hack form) and the
               golden; one call must run exactly one device operation
               (``whell_hack_pass``) and two calls give the same bits;
               timed as in 3;
10. dd_laplacian — the 512x512 Laplacian in float64 through kernel #4
               (the JAX benchmark's double-float row), checked as in 9;
11. sdia_f64 — the Laplacian in float64 through kernel #5, which must
               match its plain version exactly;
12. whdia_f64 — banded-11 (pattern mode) and the Laplacian (slab mode) in
               float64 through kernel #6 (the warp pass over each hack's
               live slots), checked as in 7 at 1e-12·max|z|;
13. solve_f64 — four float64 solves to 1e-10 through ``solve()``, each
               with a true residual ≤ 1e-9: CG on the SPD system
               (auto, whell), CG on the Laplacian auto-selected (whdia)
               and with ``fmt="sdia"``, and BiCGSTAB on the contiguous
               banded-11 system with ``fmt="whdia"``;
13a. loop_k  — the graph's K: CG at K = 4, 8, 16 and 32 in turns, twice,
               on the SPD flagship (fp32 whell), the Laplacian (fp32
               whdia) and the float64 Laplacian (sdia): ms per
               iteration, steps past convergence, host reads, capture ms;
13b. mtx_solve — ``bench.py --mtx`` on the port: the Laplacian's lower
               triangle written by ``io.write_mm`` under a ``symmetric``
               banner, read back by ``io.read_mm`` equal to the COO, then
               the bench's stages (load, convert: auto whdia, spmv: #6
               against the golden, solve: the graphed CG to 1e-5, true
               residual ≤ 1e-4);
14. spmv_c64 — the flagship with values ``v + 1j·N(0, 1)``
               (``default_rng(8)``) as complex64 through kernel #7, held
               against its plain version and the complex128 host golden,
               timed as in 3;
15. spmv_c128 — the same matrix as complex128 through the complex128
               WHELL kernel (1e-12·max|z|), checked as in 9;
16. sdia_c64, sdia_c128 — the Laplacian plus ``1j·N(0, 1)``
               (``default_rng(12)``) through kernels #8 and #11, exact
               against their plain versions;
17. whdia_c64, whdia_c128 — banded-11 (summed duplicates) plus
               ``1j·N(0, 1)`` (``default_rng(8)``), pattern mode, and the
               complex Laplacian, slab mode, through kernels #9 (the
               hack pass) and #10 (the warp pass), each over each hack's
               live slots and checked as in 7 (complex128 at
               1e-12·max|z|);
18. solve_complex — through ``solve()``, in complex64 to 1e-5 (true
               residual ≤ 1e-4) and complex128 to 1e-10 (≤ 1e-9): CG on
               the Hermitian positive-definite system made from the
               complex flagship (auto, whell), CG on the same construction
               from the complex Laplacian (auto, whdia; and
               ``fmt="sdia"``), BiCGSTAB on a non-Hermitian, diagonally
               dominant complex banded-11 system with ``fmt="whdia"``;
               each counted on its route's launch counter; the complex64
               whdia CG and BiCGSTAB within 10 % of the iterations of the
               same solvers on the plain version (every cell: the JAX
               kernel's product);
19. spmm     — the multi-RHS product on 8 RHS (``default_rng(3)``, the JAX
               benchmark's SpMM row ``bench.py:233-243``): ``whell_spmm``
               (fused by default: kernel #12, the hack pass over the
               layout's work units) on the flagship's fp32 and bf16
               layouts, one launch each, held against the plain version
               (its per-hack form) on the card and the float64 golden per
               RHS; one wrapper call must run one kernel (the X copy
               aside) and two give the same bits; timed beside the loop of
               kernel #1 (``fused=False``) and cuSPARSE SpMM
               (``csr @ X.T``);
20. spmm_dia — ``sdia_spmm(fused=True)`` (kernel #14) on the Laplacian,
               equal to 8 launches of kernel #2 bit for bit, and
               ``whdia_spmm(fused=True)`` (kernel #13, the hack pass) on
               banded-11 (pattern mode) and the Laplacian (slab mode),
               checked and timed as in 19 (the loop is the op's default),
               twice with the same bits, with the live-slot share, the
               live and full bounds and the kernel's share of each;
21. spmm_loop — the loop paths, counted: the SDIA and WHDIA defaults,
               ``whell_spmm(fused=False)``, and the float64 and complex64
               ``whell_spmm`` defaults each launch their SpMV kernel 8
               times and no SpMM kernel;
22. classic  — the README quick start: the flagship relabelled
               (``symmetric_relabel(coo, local_degree_perm(coo))``) through
               ``coo_to_whell(..., packed=False)`` in fp32 and bf16 and
               ``whell_spmv`` (kernel #15, over the layout's work list of
               live units), held against the
               full-layout plain version and the golden, timed; with the
               work list's live-unit and live-warp-slot shares and four
               bounds (the full layout's, the live warp-slots', and the
               live 32 B sectors' (``bound_ms``) and 64 B segments') and
               the kernel's share of each; then ``whell_update_values`` on
               the fp32 layout (every third entry zeroed, then all
               refreshed), each through #15
               against the plain version and its golden; then the raw
               flagship with ``sort_rows=True`` (OELL) and ``ways=2``
               through #15, against the plain version and the golden;
23. classic_spmm — ``whell_spmm(fused=True)`` (kernel #16, over the work
               list as #15) on the relabelled classic fp32 and bf16
               layouts, 8 RHS, one launch each, beside the default loop of
               #15 (8 launches, none of #16) and cuSPARSE SpMM, with its
               device time by kernel, the bounds of 22 for 8 RHS and the
               kernel's share of each;
24. pcell    — ``coo_to_whell_percell`` on the raw flagship and
               ``whell_spmv`` (kernel #17, the hack pass over the layout's
               hack lists), against the plain version and the golden,
               written over a NaN-filled z and the same bits twice, timed
               with its bound (the listed tiles') and its share of it
               (``bound_share``) beside the full layout's, beside kernel
               #1's device time from 3;
25. solve_pcell — ``solve(spd, b, fmt="pcell", tol=1e-5)`` on the SPD
               system of 5, counted on kernel #17's counter, then the
               graphed CG loop beside its eager witness as in 5 (bit for
               bit), with the layout's work units and chunked rows;
25a. classic_f64, classic_spmm_f64, pcell_f64, solve_pcell_f64 — the
               float64 entries of #15, #16 and #17: the relabelled
               flagship's fp32 values in float64 through
               ``coo_to_whell(..., packed=False)`` and ``whell_spmv``
               (#15 f64, one launch on ``LAUNCHES_F64``) and, on the same
               layout, ``whell_update_values`` as in 22 and
               ``whell_spmm(fused=True)`` at 8 RHS (#16 f64) beside the
               loop of #15 f64 and cuSPARSE SpMM; the raw float64 flagship
               through ``coo_to_whell_percell`` (#17 f64) beside #4; each
               held to its plain version and the golden at 1e-12·max|z|,
               timed warm and cold with their bounds (a float64 classic
               cell's 8 B value only in its live sector, 12 B a listed
               pcell cell) and cuSPARSE CSR in float64, #17's ptxas line
               beside it; then ``solve(fmt="pcell", tol=1e-10)`` on the
               float64 SPD flagship (true residual ≤ 1e-9), its graphed
               loop beside its eager witness bit for bit;
26. ablation_whdia, ablation_whdia_hack, ablation_whdia_laplace,
               ablation_whdia_hack_laplace — the per-op account of #3
               (kernel #18, ``spgpu_tpu_torch.sweeps.whdia_ablation``) on
               banded-11 (524,288 rows, duplicates summed, pattern mode)
               and on the Laplacian (slab mode), in two level sets: the
               tile levels stream, r0, gather, full of the fp32 tile pass
               (the design #3, #6 and #10 ran before they read only the
               live slots), each held against its plain
               version (1e-5·max|part|; full within #3's tolerance, and
               of the production #3); and the hack levels launch, list,
               stream, full of the production #3 (1 RHS) and of #13 (8
               RHS), each against its plain version and full against the
               production launch bit for bit; timed warm and cold (the L2
               flushed before each call: 4x its size written, then 4x
               read), with each op family's price, the bytes, #3's bound
               and cuSPARSE CSR; each counted on
               ``LAUNCHES_WHDIA_ABLATION`` from 0;
27. ablation_dd, ablation_dd_flagship — the same for #4 in float64
               (kernel #19, ``sweeps.dd_ablation``) on the 512x512 float64
               Laplacian and on the flagship: levels stream, gather, own,
               full of #4's hack pass (1e-12·max|out|), the TPU's
               double-float levels and the tile pass's atomic level named
               absent; each counted on ``LAUNCHES_F64_ABLATION`` from 0;
28. dd_geom  — #4 on the same Laplacian at the six (group_hacks,
               chunk_tiles) geometries of the JAX geometry sweep
               (``sweeps.dd_geom_sweep``), each within 1e-12·max|z| of the
               float64 golden, timed warm and cold with its padding and
               bound; counted on #4's ``LAUNCHES_F64`` from 0.

29. kernel_times — kernels #15 and #17 alone, warm and cold (L2
               flushed), through ``whell_spmv`` on the layouts of 22 and
               24 and in float64 (25a), beside cuSPARSE CSR on the same
               matrices in both types; then #1, #4 and
               the complex128 kernel on the flagship with aligned and
               scattered windows and #4 on the dd-Laplacian, each op's
               device time (every device operation of one call) and its
               kernels' own, warm and cold, #19's levels on the
               flagship's two float64 layouts, and cuSPARSE CSR in
               float64 and complex128; then #9 (complex64) and #13 (8
               RHS) on the Laplacian and banded-11, each op's and each
               kernel's device time, warm and cold, with the live and full
               bounds, beside #3, the 8-launch loop of #3, #6, #10 and
               cuSPARSE CSR (in each SpMV's type) and SpMM on the same
               matrices; #7 on the flagship beside cuSPARSE CSR complex64;
               then #12 (flagship) and #16 (relabelled, classic) at 8 RHS
               in fp32 and bf16 (#16 also in float64), op and kernels,
               warm and cold, with their
               bounds, beside cuSPARSE SpMM; then #17's account on the
               float64 pcell layout (``sweeps.kernel_account``: the
               production kernel and its builds without the x gathers and
               without the lane scan, warm and cold, with each family's
               price) (``kernel_times``; ``python3 chip_smoke.py
               --kernel-times`` runs this phase alone, also from an older
               checkout's root, where the account is None).

30. large    — the JAX benchmark's row-block cells (``bench.py:306-389``)
               at its TPU size, on one packed layout: the fp32
               ``random_fem_like(2**22, 9.0, span=1200, far_frac=0.005,
               seed=5)`` through #1 and its complex64 form
               (``with_imag(fem, 9, complex64)``) through #7, each checked
               as in 3 with cuSPARSE CSR in its type and both bounds; its
               float64 system (the symmetrised
               ``random_banded(2**22, bands=9, wander=3, seed=6)``, 30 on
               the diagonal) through ``solve(..., fmt="blocks", tol=1e-12,
               maxiter=60)`` twice (the second warm), #4 on that solve's
               layout and the graphed loop beside its eager witness;
31. past_bounds — systems past each old field of ``tile_base``: the
               3072x3072 Laplacian (9.4M rows, 73,728 x pages past the
               65,536 of the 16-bit page field) in fp32 and float64
               through auto-selected ``solve()`` (whdia: #3, #6), capped at
               ``LARGE["lap_maxiter"]`` CG iterations, graphed against
               eager; banded-11 at 9M rows (pattern mode, #3); F1's 9M-row
               float64 tridiagonal on aligned windows (#4, every row at
               1e-12·max|z|) and in fp32 as a classic layout (#15); the
               same Laplacian in complex128 (``+ 1j·N(0, 1)``,
               ``default_rng(12)``) through #10, the product only; a
               4.5M-row permutation-coupled matrix past 2**20 scattered
               layout groups (#1, checked as in 3 against its per-hack
               plain version summed in batches of rows and the tile-pass
               one in chunks of tiles).  Each product prints its layout (rows, nonzeros, x
               pages or groups, tiles, slab bytes, converter seconds), its
               kernel's device time warm and cold, the plain version's,
               cuSPARSE CSR's and the bound (``python3 chip_smoke.py
               --large`` runs 30 and 31 alone).
32. dist_local — the distributed layer (``spgpu_tpu_torch.parallel``),
               each shard's product on the card with its halo taken from
               the global x by the plan (``_PlannedHalo``: the schedule
               of a rank, the side stream and both slabs, eager and
               captured in a CUDA graph): the SPD flagship
               of 5 in 4- and 8-shard packed partitions in fp32 (#1) and
               float64 (#4), and the relabelled flagship of 22 in a
               4-shard classic partition (#15); each shard's rows held to
               the golden, its launches counted; per shard the interior
               and exterior products' device µs and the halo lanes and
               bytes it receives and sends; the graphed product equal to
               the eager one bit for bit on the packed partitions;
33. dist_solve — ``dist_cg`` on one NCCL rank (its ``all_reduce``s in
               the loop's CUDA graph) on the SPD flagship in fp32,
               float64, complex64 and complex128 and on the float64 1024²
               Laplacian (packed WHELL, #4), each twice, beside the
               single-device ``cg`` on the same layout (float64 and
               complex128 bit for bit) and, in float64, its eager witness
               (bit for bit); iterations, host ms per iteration, device
               ms per step, ``all_reduce`` device µs per step, idle share,
               true residual;
34. dist_plan — the JAX weak-scaling fixture (``random_banded(65536·S,
               11, wander=3, seed=2)``) at S = 1, 2, 4, 8: the S-shard
               plan's halo lanes and bytes per pair, and the matrix's
               product at world size 1 (#1), device and per-call ms.
               The host has one card: no rank runs on a second card
               (``python3 chip_smoke.py --dist`` runs 32-34 alone).
               Phases 32 and 33 also run the SPD flagship in a 4-shard
               HELL partition (plain torch products) and ``dist_cg`` on it
               at world size 1 beside the single-device hell route;
35. classic_formats — the classic layouts through ``ops.spmv`` on CUDA
               tensors (plain torch on the card, no kernel): ELL, OELL and
               HELL on the flagship, DIA and HDIA on the 1024² Laplacian,
               HDIA on banded-11 and DIA on its contiguous form (27,192
               diagonals in the wandering one), BCOO (8x8) on the
               Laplacian, float32 and
               float64 (complex64 and complex128 on the Laplacian); each
               on the card, at the host golden with alpha 1.7 and beta
               -0.3, with its converter seconds, bytes, per-call and device
               ms beside cuSPARSE CSR; csput on the card against the host
               (``classic`` is phase 22's name);
36. hybrid   — ``random_mixed(2**19)`` (the JAX defaults) in the hybrid
               split, fp32 and float64: ``tau_lanes``, band fraction and
               padding; one ``hybrid_spmv`` launches #3 (#6) once and #1
               (#4) once, is at the golden and gives the same bits twice;
               device ms of the op, of each kernel and of the crossing,
               beside pure packed WHELL, pure WHDIA and cuSPARSE CSR;
37. solve_classic — ``solve(fmt="hybrid")`` on the mixed fixture's SPD
               form (fp32, float64) and ``solve(fmt="hell")`` on the SPD
               flagship (fp32, float64) and its Hermitian complex64 form,
               each with its graphed loop beside its eager witness and the
               hell solves within 10 % of the whell route's iterations
               (``python3 chip_smoke.py --classic`` runs 35-37 alone).
38. tooling  — the context API and the tooling: ``create(0)``, its
               device facts and stream calls (an SDIA product issued
               after ``set_stream(s)`` behind a copy of x on ``s`` reads
               the copy), ``destroy``; ``bench.run_suite("chip")``, the JAX
               suite's rows on the port's routes (#1, #2, #3, #4, #5, #7,
               #9, #12 and two plain-torch rows), each SpMV/SpMM row's
               ‖z‖² within rtol 1e-4 (1e-10 in float64) of the host
               golden's on the same x and its kernel's counter moved, then
               its BLAS-1 rows at n = 2**26 and its baseline rows
               (conversion, scipy, cuSPARSE CSR); ``run_weak_scaling`` (S =
               1 on one card); ``time_op`` and ``roofline_report`` on #1;
               a ``trace`` of #1 naming ``whell_hack_pass``.  The parent
               adds the harness's device times of #1, #2, #3 and #12
               beside the earlier phases' (``harness_beside``;
               ``python3 chip_smoke.py --tooling`` runs 38 alone).

Phases 26-28, 29, 30-31, 32-34, 35-37 and 38 run in fresh processes of
this script (``chip_smoke.py --sweeps``, ``--kernel-times``, ``--large``,
``--dist``, ``--classic``, ``--tooling``, which print their lines for
this one to emit): after the earlier phases' profiling sessions,
sessions in this process lose events, and the distributed phases open
and destroy their own NCCL group.  The child phases' main-path launches
(their checked op calls and solves, one per harness row) add to the
kernel table's.

Every time a solve phase prints carries the card's name and power limit
(``card``).

The library yardstick of a complex phase is the same CSR call in the
complex type; where PyTorch refuses it, the row's ``library_ms`` holds
the error text.

The build phase gives each library's ptxas register and spill lines, and
the same by kernel instance (``ptxas_by_kernel``: the name and its
mangled template arguments), so the production instances can be compared
across versions.  Each phase prints one JSON line (with ``elapsed_s``,
the seconds since the start).  Then it prints the kernel table (one
JSON line: each kernel's launches on the main path, its error against its
plain version, its time, the plain version's and the library call's, and
its bound), the ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``; nothing prints after that line.  Any
failure raises: the exit code is then non-zero and no result line is
printed.  It needs a CUDA device and the rest of the repository, and
exits non-zero without either.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# the port itself: this import fails, with no result line, where chip_smoke.py
# stands without the rest of the repository
from spgpu_tpu_torch.utils.measure import (HBM_BYTES_PER_S, bound, check_close, nbytes,
                                           nvidia_smi)

#: kernel name -> (route, source, the TPU kernel it replaces)
KERNELS = {
    "whell_packed_spmv": ("cuda", "spgpu_tpu_torch/csrc/whell_packed_spmv.cu",
                          "spgpu_tpu/ops/pallas_kernels.py:120"),
    "sdia_spmv": ("cuda", "spgpu_tpu_torch/csrc/sdia_spmv.cu",
                  "spgpu_tpu/ops/pallas_kernels.py:2264"),
    "whdia_spmv": ("cuda", "spgpu_tpu_torch/csrc/whdia_spmv.cu",
                   "spgpu_tpu/ops/pallas_kernels.py:1283"),
    "whell_packed_spmv_f64": ("cuda", "spgpu_tpu_torch/csrc/whell_packed_spmv.cu",
                              "spgpu_tpu/ops/pallas_kernels.py:548"),
    "sdia_spmv_f64": ("cuda", "spgpu_tpu_torch/csrc/sdia_spmv.cu",
                      "spgpu_tpu/ops/pallas_kernels.py:2766"),
    "whdia_spmv_f64": ("cuda", "spgpu_tpu_torch/csrc/whdia_spmv.cu",
                       "spgpu_tpu/ops/pallas_kernels.py:1989"),
    "whell_packed_spmv_c64": ("cuda", "spgpu_tpu_torch/csrc/whell_packed_spmv.cu",
                              "spgpu_tpu/ops/pallas_kernels.py:356"),
    # the JAX package runs complex128 WHELL as four plane products of #4
    "whell_packed_spmv_c128": ("cuda", "spgpu_tpu_torch/csrc/whell_packed_spmv.cu",
                               "spgpu_tpu/ops/pallas_kernels.py:548"),
    "sdia_spmv_c64": ("cuda", "spgpu_tpu_torch/csrc/sdia_spmv.cu",
                      "spgpu_tpu/ops/pallas_kernels.py:2383"),
    "sdia_spmv_c128": ("cuda", "spgpu_tpu_torch/csrc/sdia_spmv.cu",
                       "spgpu_tpu/ops/pallas_kernels.py:2624"),
    "whdia_spmv_c64": ("cuda", "spgpu_tpu_torch/csrc/whdia_spmv.cu",
                       "spgpu_tpu/ops/pallas_kernels.py:1637"),
    "whdia_spmv_c128": ("cuda", "spgpu_tpu_torch/csrc/whdia_spmv.cu",
                        "spgpu_tpu/ops/pallas_kernels.py:1805"),
    "whell_packed_spmm": ("cuda", "spgpu_tpu_torch/csrc/whell_packed_spmv.cu",
                          "spgpu_tpu/ops/pallas_kernels.py:795"),
    "whdia_spmm": ("cuda", "spgpu_tpu_torch/csrc/whdia_spmv.cu",
                   "spgpu_tpu/ops/pallas_kernels.py:1459"),
    "sdia_spmm": ("cuda", "spgpu_tpu_torch/csrc/sdia_spmv.cu",
                  "spgpu_tpu/ops/pallas_kernels.py:2500"),
    "whell_classic_spmv": ("cuda", "spgpu_tpu_torch/csrc/whell_classic_spmv.cu",
                           "spgpu_tpu/ops/pallas_kernels.py:42"),
    "whell_classic_spmm": ("cuda", "spgpu_tpu_torch/csrc/whell_classic_spmv.cu",
                           "spgpu_tpu/ops/pallas_kernels.py:1011"),
    "pcell_spmv": ("cuda", "spgpu_tpu_torch/csrc/pcell_spmv.cu",
                   "spgpu_tpu/ops/pallas_kernels.py:1133"),
    # the same three TPU kernels, which the JAX package runs on float64
    # classic and pcell slabs (in interpret mode)
    "whell_classic_spmv_f64": ("cuda", "spgpu_tpu_torch/csrc/whell_classic_spmv.cu",
                               "spgpu_tpu/ops/pallas_kernels.py:42"),
    "whell_classic_spmm_f64": ("cuda", "spgpu_tpu_torch/csrc/whell_classic_spmv.cu",
                               "spgpu_tpu/ops/pallas_kernels.py:1011"),
    "pcell_spmv_f64": ("cuda", "spgpu_tpu_torch/csrc/pcell_spmv.cu",
                       "spgpu_tpu/ops/pallas_kernels.py:1133"),
    # the per-op accounts' pallas_call closures (their ``call`` functions)
    "whdia_ablation": ("cuda", "spgpu_tpu_torch/csrc/whdia_spmv.cu",
                       "doc/sweeps/whdia_ablation.py:118"),
    "whell_packed_ablation_f64": ("cuda", "spgpu_tpu_torch/csrc/whell_packed_spmv.cu",
                                  "doc/sweeps/dd_ablation.py:140"),
}

#: the fixtures' sizes: flagship rows, Laplacian side, banded rows, and
#: the side of the double-float benchmark row's Laplacian
SIZES = dict(flagship=262144, lap=1024, band=2 ** 19, dd_lap=512)

#: RHS of the SpMM phases, as the JAX benchmark's SpMM row
#: (``bench.py:233-243``)
N_RHS = 8

#: value dtype name -> the launch counter of its kernel in every kernel
#: module (bf16 values count with fp32)
COUNTER = {"float32": "LAUNCHES", "bfloat16": "LAUNCHES",
           "float64": "LAUNCHES_F64", "complex64": "LAUNCHES_C64",
           "complex128": "LAUNCHES_C128"}

_closed = False
_T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One phase's JSON line, with the seconds since the script started
    (``elapsed_s``)."""
    if _closed:
        raise RuntimeError(f"phase {phase!r} after the result line")
    print(json.dumps({"phase": phase, "elapsed_s": time.perf_counter() - _T0, **kw}),
          flush=True)


def flagship(dtype=np.float32):
    """The flagship SpMV fixture of the JAX package's benchmark."""
    from spgpu_tpu_torch.utils.fixtures import random_fem_like

    return random_fem_like(SIZES["flagship"], 27.0, span=768, far_frac=0.01,
                           seed=0, dtype=dtype)


def spd_from(coo, dtype=np.float32):
    """The SPD (or Hermitian positive-definite) form of ``coo`` with
    ``dtype`` values (:func:`spgpu_tpu_torch.utils.fixtures.spd_from`)."""
    from spgpu_tpu_torch.utils.fixtures import spd_from as spd

    return spd(coo, dtype)


def with_imag(coo, seed, dtype):
    """``coo`` with values ``v + 1j·N(0, 1)`` (``default_rng(seed)``), as
    ``dtype``: the JAX benchmark's complex fixtures."""
    from spgpu_tpu_torch.formats.coo import CooMatrix

    rng = np.random.default_rng(seed)
    v = coo.values.astype(np.float64) + 1j * rng.standard_normal(coo.nnz)
    return CooMatrix(coo.rows, coo.cols, v.astype(dtype), coo.n_rows, coo.n_cols)


def dominant(coo):
    """``coo`` (duplicates summed) with each diagonal entry's real part set
    to its row's off-diagonal |·|-sum + 1: strictly diagonally dominant,
    and as (non-)Hermitian as ``coo``."""
    from spgpu_tpu_torch.formats.coo import CooMatrix

    c = coo.sum_duplicates()
    n = c.n_rows
    off = c.rows != c.cols
    d = np.bincount(c.rows[off], weights=np.abs(c.values[off]), minlength=n) + 1.0
    di = np.zeros(n)
    np.add.at(di, c.rows[~off], c.values[~off].imag)
    idx = np.arange(n, dtype=np.int64)
    return CooMatrix(np.concatenate([c.rows[off], idx]),
                     np.concatenate([c.cols[off], idx]),
                     np.concatenate([c.values[off], d + 1j * di]).astype(c.values.dtype),
                     n, n).sum_duplicates()


def rand_vector(n, seed, dtype):
    """A random x of ``dtype`` from ``default_rng(seed)`` (complex: real
    and imaginary parts drawn in turn)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(n)
    return x.astype(dtype)


def wide(dtype):
    """The host golden's type for ``dtype``: float64 or complex128."""
    return np.complex128 if np.dtype(dtype).kind == "c" else np.float64


def csr_of(coo, dtype, device):
    """The COO as a ``torch.sparse_csr_tensor`` on ``device`` (duplicates
    summed): the library yardstick, ``A @ x`` through cuSPARSE."""
    import torch

    c = coo.sum_duplicates()
    crow = np.zeros(c.n_rows + 1, np.int64)
    np.cumsum(np.bincount(c.rows, minlength=c.n_rows), out=crow[1:])
    return torch.sparse_csr_tensor(
        torch.from_numpy(crow), torch.from_numpy(c.cols),
        torch.from_numpy(c.values.astype(dtype)), size=c.shape,
        check_invariants=True).to(device)


def library_call(coo, x, device):
    """The yardstick ``csr @ x`` in x's type (an ``(n_rhs, n)`` stack:
    ``csr @ x.T``, cuSPARSE SpMM with a dense ``(n, n_rhs)``), called once,
    and None in its place with the error text when PyTorch refuses it."""
    b = x if x.dim() == 1 else x.T
    try:
        csr = csr_of(coo, str(x.dtype).removeprefix("torch."), device)
        csr @ b
        return (lambda: csr @ b), None
    except RuntimeError as e:
        return None, f"refused: {e}".splitlines()[0]


def kernel_names(fn, prefixes, by_op=None):
    """The names of the device operations one call of ``fn`` runs that
    start with one of ``prefixes``: from ``by_op`` (a session's times by
    name) where it holds one, else from :func:`launched`."""
    names = [k for k in sorted(by_op or {}) if k.startswith(prefixes)]
    return names or [k for k in launched(fn) if k.startswith(prefixes)]


def launched(fn):
    """The names of the device operations one call of ``fn`` runs, from
    a usable profiling session, else from short ones (names only)."""
    from spgpu_tpu_torch.utils.timing import _session, device_ms_by_kernel

    names = sorted(device_ms_by_kernel(fn))
    for _ in range(5):
        if names:
            break
        names = sorted(_session(fn, 3)[0])
    return names


def timed(kernel, plain, library, refused=None, **more):
    """Times per call of a kernel, its plain version, the library call and
    any ``more`` calls (``name=fn``): CUDA events around interleaved runs
    of 20 calls (host-bound when the Python wrapper outlasts the kernel)
    and device time, with its source (``profiler``, or ``cuda_events``
    when no profiling session recorded device activity).  Without a
    library call (``library`` None) its times hold ``refused``, the error
    text."""
    from spgpu_tpu_torch.utils.timing import device_ms, time_interleaved

    fns = {"kernel": kernel, "plain": plain, "library": library, **more}
    fns = {k: f for k, f in fns.items() if f is not None}
    t = time_interleaved(fns, reps=5, iters=20)
    out = {}
    for name, fn in fns.items():
        dev, src = device_ms(fn)
        out.update({f"{name}_ms": t[name]["best_ms"],
                    f"{name}_spread_ms": t[name]["spread_ms"],
                    f"{name}_device_ms": dev, f"{name}_device_source": src})
    if library is None:
        out.update(library_ms=refused, library_device_ms=refused)
    return out


def spmv_phase(coo, a, device, label):
    """Kernel vs plain vs host golden on one converted WHELL matrix (fp32
    or bf16 values: kernel #1; float64: #4; complex64: #7; complex128:
    the complex128 kernel), and the times of both versions and of the
    library call on the same matrix.  Every one is the hack pass: one
    call must run one ``whell_hack_pass`` and nothing else, two calls
    the same bits, and it must write every row of a z whose block first
    held NaN; its bound is over the runs' bytes, printed beside the
    whole slab's (:func:`whell_bounds`).  The plain version is the
    per-hack form."""
    import torch

    from spgpu_tpu_torch.kernels import whell as kw
    from spgpu_tpu_torch.ops import _prep_x, whell_spmv

    vdt = a.values.dtype
    name = str(vdt).removeprefix("torch.")
    xdt = torch.float32 if vdt in (torch.float32, torch.bfloat16) else vdt
    tight = xdt in (torch.float64, torch.complex128)
    x = rand_vector(coo.n_cols, 7, str(xdt).removeprefix("torch."))
    xl = a.embed(torch.from_numpy(x), dtype=xdt)
    counter = COUNTER[name]
    setattr(kw, counter, 0)
    z = whell_spmv(a, xl)
    torch.cuda.synchronize(device)
    launches = getattr(kw, counter)
    if launches != 1:
        raise AssertionError(f"{label}: whell_spmv launched the kernel {launches} times")
    x2 = _prep_x(xl, a.n_cols, a.x_pages)
    args = (a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
            a.group_bases, a.seg_lo, a.seg_hi, x2)
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  window_pages=a.window_pages, unit_segments=a.unit_segments,
                  hack_units=a.hack_units, tile_page=a.tile_page)
    plain = lambda v: kw.whell_packed_spmv_plain(  # noqa: E731
        *args[:-1], v, **static)
    zp = plain(x2).reshape(-1)[: a.n_rows]
    zc, pc = z.cpu().numpy(), zp.cpu().numpy()
    # the kernels sum in the per-hack plain version's order, with FMAs
    # (the plain version rounds each product)
    tol_plain, tol_golden = ((0, 1e-12), (0, 1e-12)) if tight else \
        ((1e-5, 1e-5), (1e-4, 1e-4))
    err_plain = check_close(zc, pc, *tol_plain, f"{label}: kernel vs plain")
    call = lambda: kw.whell_packed_spmv(*args, **static)  # noqa: E731
    per_hack = hack_pass_checks(call, a, xdt, device, label)
    # host golden in float64 or complex128
    golden = coo.spmv(x.astype(wide(x.dtype)))
    z_orig = a.extract(z, dtype=torch.from_numpy(golden).dtype).cpu().numpy()
    err_golden = check_close(z_orig, golden, *tol_golden,
                             f"{label}: kernel vs host golden")
    slab_bytes = a.total_slots * 128 * (a.values.element_size() + 2)
    xo = torch.from_numpy(x).to(device)
    library, refused = library_call(coo, xo, device)
    t = timed(call, lambda: plain(x2), library, refused)
    flops = (8 if xdt.is_complex else 2) * coo.nnz
    bounds = whell_bounds(a, x2, z, flops, str(xdt).removeprefix("torch."))
    return dict(
        nnz=coo.nnz, tiles=a.num_tiles, lane_space=a.n_rows, launches=launches,
        **per_hack, padding=a.total_slots * 128 / coo.nnz, slab_mib=slab_bytes / 2**20,
        max_abs_err_vs_plain=err_plain, max_abs_err_vs_golden=err_golden, **t,
        kernel_gflops=flops / (t["kernel_ms"] * 1e6),
        kernel_device_gflops=flops / (t["kernel_device_ms"] * 1e6),
        plain_gflops=flops / (t["plain_ms"] * 1e6),
        kernel_device_slab_gbytes_per_s=slab_bytes / (t["kernel_device_ms"] * 1e6),
        **bounds, bound_share=bounds["bound_ms"] / t["kernel_device_ms"],
        full_bound_share=bounds["full_bound_ms"] / t["kernel_device_ms"])


def hack_pass_checks(call, a, dtype, device, label):
    """What the hack pass must show on layout ``a`` (``call``: one
    ``whell_packed_spmv`` of z's ``dtype``): one kernel, a
    ``whell_hack_pass`` (no accumulator fill, no flush), and beside it only
    the zero fill of the launch's own run counters where a run is chunked
    (more work units than rows), whose device time it returns; every row
    written over a NaN-filled block; the same bits on two calls."""
    import torch

    from spgpu_tpu_torch.utils.timing import device_ms_by_kernel

    by_op = device_ms_by_kernel(call)
    ops_ = sorted(by_op) or launched(call)
    chunked = a.hack_units.shape[0] > a.seg_lo.shape[0]
    kernels = [k for k in ops_ if k.startswith("whell_hack_pass")]
    others = [k for k in ops_ if k not in kernels]
    if len(kernels) != 1 or others != (["vectorized_elementwise_kernel"] if chunked
                                       else []):
        raise AssertionError(f"{label}: the call ran {ops_}, not one whell_hack_pass"
                             + (" and the run counters' fill" if chunked else ""))
    z = written_over_nan(call, a.seg_lo.shape[0] * 128, dtype, device, label)
    if not torch.equal(z, call()):
        raise AssertionError(f"{label}: two launches differ")
    return dict(device_ops=ops_, chunked_runs=chunked, bit_identical=True,
                rows_written_over_nan=True,
                counter_fill_device_ms=by_op.get("vectorized_elementwise_kernel"))


def written_over_nan(call, numel, dtype, device, label):
    """``call()``, a kernel with no zero fill, run where the block its
    output of ``numel`` elements gets first held NaN (the caching
    allocator hands the freed block back): raises unless it got that
    block and wrote every element finite; returns the output."""
    import torch

    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    nan = torch.full((numel,), float("nan"), dtype=dtype, device=device)
    ptr = nan.data_ptr()
    del nan
    z = call()
    torch.cuda.synchronize(device)
    if z.data_ptr() != ptr or not bool(torch.isfinite(z).all()):
        raise AssertionError(f"{label}: a row of the NaN-filled z was not written "
                             f"(same block: {z.data_ptr() == ptr})")
    return z


def dia_phase(coo, kernel, plain, op_z, moved, tol_plain, label, device, counter):
    """A DIA-class kernel on the card against its plain version (rtol and
    atol/max|z| both ``tol_plain``) and the float64 or complex128 host
    golden (2e-5 in float32 and complex64, 1e-12·max|z| in float64 and
    complex128), then the times of both versions and of the library call.
    ``kernel``/``plain`` map x to the padded product, ``op_z`` to the
    op's ``(n_rows,)`` result, whose launches of the kernel (``counter``:
    module, attribute name) are counted from 0 and must be one; ``moved``
    is the bytes the kernel must read and write."""
    import torch

    vdt = np.dtype(coo.values.dtype)
    tight = vdt in (np.float64, np.complex128)
    x = rand_vector(coo.n_cols, 7, vdt)
    xt = torch.from_numpy(x).to(device)
    mod, attr = counter
    setattr(mod, attr, 0)
    z = op_z(xt)
    torch.cuda.synchronize(device)
    launches = getattr(mod, attr)
    if launches != 1:
        raise AssertionError(f"{label}: the op launched the kernel {launches} times")
    n = coo.n_rows
    zp = plain(xt)[:n]
    err_plain = check_close(z.cpu().numpy(), zp.cpu().numpy(), tol_plain,
                            tol_plain, f"{label}: kernel vs plain")
    tol_golden = (0, 1e-12) if tight else (2e-5, 2e-5)
    err_golden = check_close(z.cpu().numpy(), coo.spmv(x.astype(wide(vdt))),
                             *tol_golden, f"{label}: kernel vs host golden")
    library, refused = library_call(coo, xt, device)
    t = timed(lambda: kernel(xt), lambda: plain(xt), library, refused)
    flops = (8 if vdt.kind == "c" else 2) * coo.nnz
    return dict(
        rows=n, nnz=coo.nnz, launches=launches, max_abs_err_vs_plain=err_plain,
        max_abs_err_vs_golden=err_golden, **t,
        kernel_gflops=flops / (t["kernel_ms"] * 1e6),
        kernel_device_gflops=flops / (t["kernel_device_ms"] * 1e6),
        plain_device_gflops=flops / (t["plain_device_ms"] * 1e6),
        bytes_mib=moved / 2**20,
        kernel_device_gbytes_per_s=moved / (t["kernel_device_ms"] * 1e6),
        **bound(moved, flops, vdt.name))


def sdia_phase(coo, device, label):
    """``dia_phase`` for SDIA (kernel #2; #5 in float64, #8 in complex64,
    #11 in complex128): the kernel sums in its plain version's order with
    the same roundings, so the two must agree exactly."""
    from spgpu_tpu_torch.convert import coo_to_sdia
    from spgpu_tpu_torch.kernels import sdia as ks
    from spgpu_tpu_torch.ops import sdia_spmv

    t0 = time.perf_counter()
    sa = coo_to_sdia(coo, device=device)
    convert_s = time.perf_counter() - t0
    out = dia_phase(
        coo, lambda x: ks.sdia_spmv(sa.values, sa.offset_table, x, n_rows=sa.n_rows),
        lambda x: ks.sdia_spmv_plain(sa.values, sa.offsets, x, n_rows=sa.n_rows),
        lambda x: sdia_spmv(sa, x),
        nbytes(sa.values, sa.offset_table) + sa.values.element_size()
        * (coo.n_cols + coo.n_rows), 0.0, label, device,
        (ks, COUNTER[np.dtype(coo.values.dtype).name]))
    return dict(convert_s=convert_s, offsets=list(sa.offsets),
                value_mib=nbytes(sa.values) / 2**20, **out)


def whdia_phase(coo, mode, device, label, wa=None, convert_s=None):
    """``dia_phase`` for WHDIA (kernel #3; #6 in float64, #9 in complex64,
    #10 in complex128); the list order reorders the sums, hence 1e-5
    (1e-12·max|z| in float64 and complex128) against the plain version.
    ``mode`` is the r0 mode the layout must take.  Each kernel reads only
    the live slots: it is also held to the listed plain product at the
    same tolerance and to itself (two launches, the same bits), must write
    every row of a NaN-filled buffer, and its bound is the live slots'
    (``whdia_bounds``), printed beside the full layout's."""
    import torch

    from spgpu_tpu_torch.convert import coo_to_whdia
    from spgpu_tpu_torch.kernels import whdia as kd
    from spgpu_tpu_torch.ops import whdia_spmv

    if wa is None:  # else a layout of coo built before, in convert_s
        t0 = time.perf_counter()
        wa = coo_to_whdia(coo, device=device)
        torch.cuda.synchronize(device)
        convert_s = time.perf_counter() - t0
    got = "pattern" if wa.pattern_mode else "slab"
    if got != mode:
        raise AssertionError(f"{label}: {got} mode, expected {mode}")
    args = (wa.values, wa.slot_r0, wa.tile_r0, wa.tile_base, wa.chunk_group)
    static = dict(chunk_tiles=wa.chunk_tiles, group_hacks=wa.group_hacks,
                  num_groups=wa.num_groups, tile_page=wa.tile_page)
    lists = dict(hack_slot_ptr=wa.hack_slot_ptr, hack_slots=wa.hack_slots)
    tol = 1e-12 if wa.values.dtype in (torch.float64, torch.complex128) else 1e-5
    b = whdia_bounds(wa, 1)
    out = dia_phase(
        coo, lambda x: kd.whdia_spmv(*args, x, **static, **lists),
        lambda x: kd.whdia_spmv_plain(*args, x, **static),
        lambda x: whdia_spmv(wa, x), b["live_bytes"],
        tol, label, device, (kd, COUNTER[np.dtype(coo.values.dtype).name]))
    x = torch.from_numpy(rand_vector(coo.n_cols, 7, np.dtype(coo.values.dtype))
                         ).to(device)
    z = written_over_nan(lambda: kd.whdia_spmv(*args, x, **static, **lists),
                         wa.num_groups * wa.group_hacks * 128, x.dtype, device, label)
    if not torch.equal(z, kd.whdia_spmv(*args, x, **static, **lists)):
        raise AssertionError(f"{label}: two launches of the live-slot kernel "
                             "differ")
    listed = kd.whdia_spmm_listed_plain(
        wa.values, wa.slot_r0, wa.tile_r0, wa.tile_base, wa.hack_slot_ptr,
        wa.hack_slots, x[None], group_hacks=wa.group_hacks,
        num_groups=wa.num_groups, tile_page=wa.tile_page)[0]
    out.update(
        bit_identical=True, rows_written_over_nan=True, **b,
        max_abs_err_vs_listed=check_close(z, listed, tol, tol,
                                          f"{label}: kernel vs listed plain"),
        live_bound_share=b["live_bound_ms"] / out["kernel_device_ms"],
        full_bound_share=b["full_bound_ms"] / out["kernel_device_ms"])
    out.update(mode=got, window_pages=wa.window_pages, tiles=wa.num_tiles,
               padding=wa.total_slots * 128 / coo.nnz,
               value_mib=nbytes(wa.values) / 2**20, convert_s=convert_s)
    return out


#: (fmt, value dtype name) of the solve routes whose kernel gives the same
#: bits every call (SDIA #2/#5/#8/#11, WHDIA #3/#6/#9/#10, packed WHELL
#: #1/#4/#7 and complex128 on the hack pass, pcell #17 on its hack pass,
#: the hybrid split's #3 + #1 and #6 + #4 with its index copies, and
#: HELL's plain products, each hack summed in slot order): their graphed
#: solves must equal the eager witness bit for bit
BIT_REPRODUCIBLE = {("pcell", "float32"), ("pcell", "float64"),
                    ("sdia", "float32"), ("sdia", "float64"), ("sdia", "complex64"),
                    ("sdia", "complex128"), ("whdia", "float32"),
                    ("whdia", "float64"), ("whdia", "complex64"),
                    ("whdia", "complex128"), ("whell", "float32"),
                    ("whell", "float64"), ("whell", "complex64"),
                    ("whell", "complex128"), ("hybrid", "float32"),
                    ("hybrid", "float64"), ("hell", "float32"), ("hell", "float64"),
                    ("hell", "complex64"), ("hell", "complex128")}


def krylov_loop():
    """The Krylov loop's module (``solvers.cg`` is the function)."""
    import importlib

    return importlib.import_module("spgpu_tpu_torch.solvers.cg")


def loop_counts(reset=False) -> dict:
    """The loop's counters (set to 0 first with ``reset``)."""
    loop = krylov_loop()
    if reset:
        loop.STEPS = loop.HOST_READS = loop.REPLAYS = 0
        loop.CAPTURE_MS = 0.0
    return dict(device_steps=loop.STEPS, host_reads=loop.HOST_READS,
                replays=loop.REPLAYS, capture_ms=loop.CAPTURE_MS)


def check_reads(what, iterations, counts):
    """At most one host read per graph of K steps, and two more."""
    k = krylov_loop().GRAPH_STEPS
    if counts["host_reads"] > -(-iterations // k) + 2:
        raise AssertionError(f"{what}: {counts['host_reads']} host reads for "
                             f"{iterations} iterations at K = {k}")


def true_residual(coo, b, x) -> float:
    """‖b − A·x‖ / ‖b‖ on the host in float64 (complex128)."""
    x = np.asarray(x.cpu() if hasattr(x, "cpu") else x)
    x = x.astype(wide(x.dtype))
    bb = np.asarray(b).astype(wide(np.asarray(b).dtype))
    return float(np.linalg.norm(bb - coo.spmv(x)) / np.linalg.norm(bb))


def counted_solve(coo, b, counter, device, tol, true_tol, **kw):
    """``solve()`` with the kernel's launch counter (``counter``: module,
    attribute name) and the Krylov loop's counters set to 0 just before
    and read just after; checks convergence, one launch per iteration at
    least (each captured launch counts once per graph replay), at most
    ``ceil(iterations / K) + 2`` host reads, and the float64 (or
    complex128) host true residual ≤ ``true_tol``."""
    import torch

    from spgpu_tpu_torch.solvers import solve

    mod, attr = counter
    setattr(mod, attr, 0)
    loop_counts(reset=True)
    t0 = time.perf_counter()
    res = solve(coo, b, device=device, tol=tol, **kw)
    torch.cuda.synchronize(device)
    solve_s = time.perf_counter() - t0
    launches = getattr(mod, attr)
    counts = loop_counts()
    if not bool(res.converged):
        raise AssertionError(f"solve({kw}) did not converge in "
                             f"{res.iterations} iterations (residual "
                             f"{float(res.residual_norm)})")
    if launches < res.iterations:
        raise AssertionError(f"solve({kw}): {launches} kernel launches for "
                             f"{res.iterations} iterations")
    check_reads(f"solve({kw})", res.iterations, counts)
    xs = res.x.cpu().numpy()
    xs = xs.astype(wide(xs.dtype))
    true_res = true_residual(coo, b, xs)
    if not true_res <= true_tol:
        raise AssertionError(f"solve({kw}): true residual {true_res} > {true_tol}")
    bb = np.asarray(b).astype(wide(np.asarray(b).dtype))
    return res, xs, dict(iterations=res.iterations, launches=launches,
                         graph_steps=krylov_loop().GRAPH_STEPS, **counts,
                         solve_total_s=solve_s, true_residual=true_res,
                         solver_residual=float(res.residual_norm
                                               / np.linalg.norm(bb)),
                         x_dtype=str(res.x.dtype))


#: iterations of each loop's profiled run (tol = 0: only ``maxiter`` or a
#: BiCGSTAB breakdown stops it): a short window, as profiling thousands
#: of iterations in one session leaves later sessions losing events
PROFILED_ITERATIONS = 64


def loop_pair(solver, mv, b, tol, exact, gate, smi, maxiter=20000):
    """The Krylov loop alone on one layout: the graphed loop (``solver``:
    "cg" or "bicgstab") and its eager witness, each solved to ``tol`` on
    the host clock (to a synchronise), then run for
    :data:`PROFILED_ITERATIONS` iterations in a profiling session.  Per
    loop: ms per iteration of the solve; device ms per step of the
    profiled run (its device time over the steps it ran: the graphed
    loop's ``STEPS``, masked ones included; the eager loop's iterations),
    its six largest device operations per step by name; device ms per
    iteration of the solve (per step times its steps, over its
    iterations); and the idle share of the solve (null when the device
    time is not the profiler's); for the graphed loop also K, its steps,
    host reads, replays and capture ms, with the card (``smi``).  Holds the
    graphed solve to the witness: where ``exact`` (a kernel with the same
    bits every call) the same iterations and ``x`` bit for bit, else
    iterations within max(1, 10 %) and ``gate(x)`` (the true-residual
    check, which raises) passing."""
    import torch

    from spgpu_tpu_torch.utils.timing import device_ms, device_ms_by_kernel

    loop = krylov_loop()
    out = dict(card=smi, graph_steps=loop.GRAPH_STEPS)
    got = {}
    for tag, fn in (("graphed", getattr(loop, solver)),
                    ("eager", getattr(loop, f"_{solver}_eager"))):
        graphed = tag == "graphed"
        runs = []

        def run(tol, maxiter, fn=fn, runs=runs):
            loop_counts(reset=True)
            r = fn(mv, b, tol=tol, maxiter=maxiter)
            counts = loop_counts()
            runs.append((r, counts["device_steps"] if graphed else r.iterations,
                         counts))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(tol, maxiter)
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
        (r, steps, counts), = runs
        window = lambda: run(0.0, PROFILED_ITERATIONS)  # noqa: E731
        by_kernel = device_ms_by_kernel(window, iters=1, warmup=0, attempts=3)
        dev, src = sum(by_kernel.values()), "profiler"
        if not by_kernel:
            dev, src = device_ms(window, iters=1, warmup=0, attempts=1)
        steps_prof = max(runs[-1][1], 1)
        per_step = dev / steps_prof
        pre = "" if graphed else "eager_"
        out.update({f"{pre}loop_iterations": r.iterations,
                    f"{pre}solve_ms": host_ms,
                    f"{pre}ms_per_iter": host_ms / max(r.iterations, 1),
                    f"{pre}device_ms_per_step": per_step,
                    f"{pre}device_ms_per_iter": per_step * steps / max(r.iterations, 1),
                    f"{pre}device_source": src,
                    f"{pre}profiled_steps": steps_prof,
                    f"{pre}device_ms_per_step_by_kernel": {
                        k: v / steps_prof for k, v in sorted(
                            by_kernel.items(), key=lambda kv: -kv[1])[:6]},
                    f"{pre}device_idle_share": (1 - per_step * steps / host_ms
                                                if src == "profiler" else None)})
        if graphed:
            check_reads(f"{solver} graphed", r.iterations, counts)
            out.update(counts)
        got[tag] = r
    g, e = got["graphed"], got["eager"]
    if not (bool(g.converged) and bool(e.converged)):
        raise AssertionError(f"{solver}: graphed or eager loop did not converge")
    if exact:
        if g.iterations != e.iterations or not torch.equal(g.x, e.x):
            raise AssertionError(f"{solver}: graphed {g.iterations} iterations, "
                                 f"eager {e.iterations}, or x not bit-identical")
        out["vs_eager"] = "bit_identical"
    else:
        if abs(g.iterations - e.iterations) > max(1, e.iterations // 10):
            raise AssertionError(f"{solver}: graphed {g.iterations} iterations, "
                                 f"eager {e.iterations}")
        out["vs_eager"] = "within_gate"
    out["true_residual_graphed"] = gate(g.x)
    return out


def residual_gate(coo, b, true_tol, what, extract=None):
    """``x`` (through ``extract`` first, for a lane-space x) → its true
    residual, raising past ``true_tol``."""
    def gate(x):
        res = true_residual(coo, b, x if extract is None else extract(x))
        if not res <= true_tol:
            raise AssertionError(f"{what}: true residual {res} > {true_tol}")
        return res
    return gate


def dia_solves(lap, band, device, dtype, tol, true_tol, smi):
    """CG on the Laplacian (or, complex, a Hermitian positive-definite
    system of its structure) auto-selected (whdia) and with
    ``fmt="sdia"``, BiCGSTAB on the contiguous band with ``fmt="whdia"``,
    each counted on its kernel's launch counter, then the graphed loop
    against its eager witness on a fresh layout."""
    import torch

    from spgpu_tpu_torch.convert import coo_to_sdia, coo_to_whdia, suggest_format
    from spgpu_tpu_torch.kernels import sdia as ks
    from spgpu_tpu_torch.kernels import whdia as kd
    from spgpu_tpu_torch.ops import sdia_spmv, whdia_spmv

    name = np.dtype(dtype).name
    attr = COUNTER[name]
    x_true = rand_vector(lap.n_rows, 1, wide(dtype))
    b_lap = lap.spmv(x_true).astype(dtype)
    fmt_lap = suggest_format(lap)
    if fmt_lap != "whdia":
        raise AssertionError(f"auto-selection chose {fmt_lap!r} on the "
                             "Laplacian, not whdia")
    solves = {}
    _, xs, solves["cg_auto_whdia"] = counted_solve(
        lap, b_lap, (kd, attr), device, tol, true_tol, maxiter=20000)
    solves["cg_auto_whdia"]["x_err_vs_true"] = float(np.abs(xs - x_true).max())
    _, xs, solves["cg_sdia"] = counted_solve(
        lap, b_lap, (ks, attr), device, tol, true_tol, fmt="sdia", maxiter=20000)
    solves["cg_sdia"]["x_err_vs_true"] = float(np.abs(xs - x_true).max())
    # a contiguous band: the wandering bench fixture moves the dominant
    # entry off the diagonal and BiCGSTAB breaks down on it
    b_band = band.spmv(rand_vector(band.n_rows, 1, wide(dtype))).astype(dtype)
    _, _, solves["bicgstab_whdia"] = counted_solve(
        band, b_band, (kd, attr), device, tol, true_tol, fmt="whdia",
        symmetric=False, maxiter=5000)
    # the Krylov loops alone, on fresh layouts: graphed against eager
    wl = coo_to_whdia(lap, device=device)
    sl = coo_to_sdia(lap, device=device)
    wb = coo_to_whdia(band, device=device)
    bl = torch.from_numpy(b_lap).to(device)
    bb = torch.from_numpy(b_band).to(device)
    for key, solver, fmt, mv, coo, rhs, b_host in (
            ("cg_auto_whdia", "cg", "whdia", lambda v: whdia_spmv(wl, v), lap, bl, b_lap),
            ("cg_sdia", "cg", "sdia", lambda v: sdia_spmv(sl, v), lap, bl, b_lap),
            ("bicgstab_whdia", "bicgstab", "whdia", lambda v: whdia_spmv(wb, v),
             band, bb, b_band)):
        solves[key]["loop"] = loop_pair(
            solver, mv, rhs, tol, (fmt, name) in BIT_REPRODUCIBLE,
            residual_gate(coo, b_host, true_tol, f"{key} {name}"), smi)
    if np.dtype(dtype) in (np.float32, np.complex64):
        # #3 and #9 read only live slots and sum in their list's order:
        # their iteration counts stay within 10 % of the same solvers on
        # the plain version (every cell, the JAX kernel's product)
        loop = krylov_loop()
        for key, solver, lay, rhs in (("cg_auto_whdia", loop._cg_eager, wl, bl),
                                      ("bicgstab_whdia", loop._bicgstab_eager, wb, bb)):
            mv = lambda v, lay=lay: kd.whdia_spmv_plain(  # noqa: E731
                lay.values, lay.slot_r0, lay.tile_r0, lay.tile_base,
                lay.chunk_group, v, chunk_tiles=lay.chunk_tiles,
                group_hacks=lay.group_hacks, num_groups=lay.num_groups,
                tile_page=lay.tile_page)[: lay.n_rows]
            ref = solver(mv, rhs, tol=tol, maxiter=20000).iterations
            got = solves[key]["iterations"]
            if abs(got - ref) > max(1, ref // 10):
                raise AssertionError(f"{key} {np.dtype(dtype)}: {got} iterations, "
                                     f"{ref} on the plain version")
            solves[key]["plain_iterations"] = ref
    return solves


def spd_solve(spd, device, dtype, tol, true_tol, smi):
    """CG on the SPD (or Hermitian positive-definite) system through
    ``solve()`` with auto-selection (must be whell), counted on the launch
    counter of the WHELL kernel of ``dtype``, then the graphed loop
    against its eager witness on a fresh layout."""
    import torch

    from spgpu_tpu_torch.convert import coo_to_whell, suggest_format
    from spgpu_tpu_torch.kernels import whell as kw
    from spgpu_tpu_torch.ops import whell_spmv

    fmt = suggest_format(spd)
    if fmt != "whell":
        raise AssertionError(f"auto-selection chose {fmt!r}, not whell")
    x_true = rand_vector(spd.n_rows, 1, wide(dtype))
    b = spd.spmv(x_true).astype(dtype)
    name = np.dtype(dtype).name
    _, xs, solved = counted_solve(spd, b, (kw, COUNTER[name]), device, tol,
                                  true_tol, maxiter=5000)
    work = getattr(torch, name)
    a = coo_to_whell(spd, device=device)
    b_l = a.embed(torch.from_numpy(b), dtype=work)
    gate = residual_gate(spd, b, true_tol, f"cg whell {name}",
                         extract=lambda x: a.extract(x, dtype=work))
    return dict(fmt=fmt, nnz=spd.nnz, max_row_degree=int(spd.row_lengths().max()),
                tiles=a.num_tiles, lane_space=a.n_rows, **chunked_runs(a, device),
                padding=a.total_slots * 128 / spd.nnz, **solved,
                loop=loop_pair("cg", lambda v: whell_spmv(a, v), b_l, tol,
                               ("whell", name) in BIT_REPRODUCIBLE, gate, smi),
                x_err_vs_true=float(np.abs(xs - x_true).max()))


def chunked_runs(a, device):
    """Layout ``a``'s chunked runs (a hack's run cut into chunks of work
    units, one block each): the work units, the rows with chunks, and
    where there are any, the time of the zero fill of the launch's own
    counters that every product then runs beside the hack pass (one int32
    per row, as ``kernels.whell.hack_pass_args`` allocates it): the fill
    alone, device ms, warm, with its source."""
    import torch

    from spgpu_tpu_torch.utils.timing import device_ms

    rows = a.seg_lo.shape[0]
    units = a.hack_units.shape[0]
    chunk_rows = int(torch.unique(a.hack_units[a.hack_units[:, 3] >= 0, 2]).numel())
    fill, src = (device_ms(lambda: torch.zeros(rows, dtype=torch.int32, device=device))
                 if units > rows else (None, None))
    return dict(work_units=units, rows=rows, rows_with_chunks=chunk_rows,
                counter_fill_device_ms=fill, counter_fill_source=src)


def loop_k_phase(spd, lap, lap64, device, smi):
    """The graph's K: ``_cg`` at each K of 4, 8, 16 and 32 on three
    systems (the flagship SPD system on fp32 whell, the Laplacian on fp32
    whdia and on float64 sdia: 53 to 2,409 iterations), K in turns, twice
    each; per run the host ms to a synchronise, ms per iteration, steps
    run past convergence, host reads and capture ms."""
    import torch

    from spgpu_tpu_torch.convert import coo_to_sdia, coo_to_whdia, coo_to_whell
    from spgpu_tpu_torch.ops import sdia_spmv, whdia_spmv, whell_spmv

    loop = krylov_loop()
    a = coo_to_whell(spd, device=device)
    wl = coo_to_whdia(lap, device=device)
    sl = coo_to_sdia(lap64, device=device)
    x1 = rand_vector(lap.n_rows, 1, np.float64)
    systems = {
        "whell_fp32_spd": (lambda v: whell_spmv(a, v), a.embed(
            torch.from_numpy(spd.spmv(rand_vector(spd.n_rows, 1, np.float64))
                             .astype(np.float32)), dtype=torch.float32), 1e-5),
        "whdia_fp32_laplace": (lambda v: whdia_spmv(wl, v), torch.from_numpy(
            lap.spmv(x1).astype(np.float32)).to(device), 1e-5),
        "sdia_f64_laplace": (lambda v: sdia_spmv(sl, v), torch.from_numpy(
            lap64.spmv(x1)).to(device), 1e-10)}
    table = {}
    for name, (mv, b, tol) in systems.items():
        rows = {k: [] for k in (4, 8, 16, 32)}
        for _ in range(2):
            for k in rows:
                loop_counts(reset=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = loop._cg(mv, b, tol=tol, maxiter=20000, steps=k)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                counts = loop_counts()
                rows[k].append(dict(ms=ms, ms_per_iter=ms / r.iterations,
                                    iterations=r.iterations,
                                    past_convergence=counts["device_steps"] - r.iterations,
                                    **counts))
        table[name] = {str(k): v for k, v in rows.items()}
    return dict(card=smi, chosen=loop.GRAPH_STEPS, systems=table)


def mtx_solve(device, smi):
    """``bench.py --mtx`` (``bench.py:39-161``) on the port: the
    Laplacian's lower triangle written with ``write_mm`` into a temporary
    directory under a ``symmetric`` banner, read back with ``read_mm`` as
    the bench reads it (float64 values) and held equal to the COO, then
    the bench's stages with its keys: ``load`` (properties, seconds),
    ``convert`` (auto-selected: must be whdia), ``spmv`` (``whdia_spmv``,
    kernel #6, against the float64 golden; CUDA-event time) and ``solve``
    (``solve()``'s graphed CG to 1e-5 on the bench's random ``b``, true
    residual ≤ 1e-4)."""
    import tempfile

    import torch

    from spgpu_tpu_torch.convert import coo_to_whdia, suggest_format
    from spgpu_tpu_torch.formats.coo import CooMatrix
    from spgpu_tpu_torch.io import read_mm, read_mm_properties, write_mm
    from spgpu_tpu_torch.ops import whdia_spmv
    from spgpu_tpu_torch.utils.fixtures import laplacian_2d
    from spgpu_tpu_torch.utils.timing import time_interleaved

    side = SIZES["lap"]
    lap = laplacian_2d(side, side)
    n = lap.n_rows
    low = lap.rows >= lap.cols
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"laplace{side}.mtx")
        t0 = time.perf_counter()
        write_mm(path, CooMatrix(lap.rows[low], lap.cols[low], lap.values[low], n, n))
        with open(path, "rb") as f:
            banner, body = f.read().split(b"\n", 1)
        with open(path, "wb") as f:
            f.write(banner.replace(b"general", b"symmetric") + b"\n" + body)
        write_s = time.perf_counter() - t0
        del body
        props = read_mm_properties(path)
        t0 = time.perf_counter()
        coo = read_mm(path).sum_duplicates()
        load_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(path)
    ref = lap.sum_duplicates()
    if not (coo.shape == ref.shape and np.array_equal(coo.rows, ref.rows)
            and np.array_equal(coo.cols, ref.cols)
            and np.array_equal(coo.values, ref.values)):
        raise AssertionError("mtx_solve: read_mm did not give back the Laplacian")
    load = dict(stage="load", file=os.path.basename(path), symmetry=props.symmetry,
                field=props.field, n_rows=coo.n_rows, n_cols=coo.n_cols, nnz=coo.nnz,
                t_s=load_s, write_s=write_s, file_bytes=file_bytes,
                lower_triangle_nnz=props.nnz, equals_coo=True)
    fmt = suggest_format(coo)
    fmt = {"dia": "sdia", "ell": "whell"}.get(fmt, fmt)
    if fmt != "whdia":
        raise AssertionError(f"mtx_solve: auto-selection chose {fmt!r}, not whdia")
    t0 = time.perf_counter()
    a = coo_to_whdia(coo, device=device)
    torch.cuda.synchronize(device)
    arrays = (a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group,
              a.hack_slot_ptr, a.hack_slots)
    convert = dict(stage="convert", fmt=fmt, t_s=time.perf_counter() - t0,
                   pad_factor=a.values.numel() / coo.nnz,
                   storage_bytes=nbytes(*arrays))
    rng = np.random.default_rng(1)  # as the bench draws x, then b
    x = rng.standard_normal(n)
    xt = torch.from_numpy(x).to(device)
    z = whdia_spmv(a, xt)
    err = check_close(z, coo.spmv(x), 0.0, 1e-12, "mtx_solve: spmv vs golden")
    t = time_interleaved({"spmv": lambda: whdia_spmv(a, xt)})["spmv"]["best_ms"] / 1e3
    spmv = dict(stage="spmv", fmt=fmt, t_avg_s=t, gflops=2.0 * coo.nnz / t * 1e-9,
                checksum=float((z.double() * z.double()).sum()),
                roofline_frac=(convert["storage_bytes"] + n * 8) / t / HBM_BYTES_PER_S,
                max_abs_err_vs_golden=err, card=smi)
    b = rng.standard_normal(n)
    from spgpu_tpu_torch.kernels import whdia as kd

    _, _, solved = counted_solve(coo, b, (kd, "LAUNCHES_F64"), device, 1e-5, 1e-4,
                                 symmetric=props.is_symmetric, maxiter=5000)
    solve = dict(stage="solve", solver="cg" if props.is_symmetric else "bicgstab",
                 true_resid=solved["true_residual"], t_s=solved["solve_total_s"],
                 card=smi, **solved)
    return dict(fixture=f"laplacian_2d({side}, {side}) lower triangle, symmetric banner",
                load=load, convert=convert, spmv=spmv, solve=solve)


def rhs_stack(n, dtype=np.float32):
    """The SpMM phases' X: ``(N_RHS, n)`` from ``default_rng(3)``, as the
    JAX benchmark's SpMM row draws it."""
    return np.random.default_rng(3).standard_normal((N_RHS, n)).astype(dtype)


def spmm_summary(out, flops, kernel):
    """Rates over the device times of a SpMM phase's timed calls, and
    where the device time of one ``kernel()`` call goes, by kernel."""
    from spgpu_tpu_torch.utils.timing import device_ms_by_kernel

    out = dict(out, **{f"{k}_device_gflops": flops / (out[f"{k}_device_ms"] * 1e6)
                       for k in ("kernel", "loop", "library")
                       if isinstance(out.get(f"{k}_device_ms"), float)})
    out["kernel_device_ms_by_kernel"] = device_ms_by_kernel(kernel)
    return out


def whell_spmm_phase(coo, a, device, label):
    """Kernel #12 through ``ops.whell_spmm`` (the fused default for fp32
    and bf16 values) on 8 lane-space RHS, its one launch counted; held
    against its plain version (the per-hack form) on the card (1e-5,
    1e-5·max|Z|: its sums in another order) and the float64 golden per
    RHS (1e-4); one wrapper call must run one kernel, the hack pass, and
    no flush (the X copy aside), and two calls give the same bits; then
    the kernel, the plain version, the fused op, the loop of kernel #1
    (``fused=False``) and cuSPARSE SpMM timed, with the bound: every
    layout array the kernel reads once, X and Z for every RHS."""
    import torch

    from spgpu_tpu_torch.kernels import whell as kw
    from spgpu_tpu_torch.ops import _prep_x, whell_spmm

    X = rhs_stack(a.n_cols)
    xs = torch.from_numpy(X).to(device)
    kw.LAUNCHES_SPMM = 0
    z = whell_spmm(a, xs)
    torch.cuda.synchronize(device)
    launches = kw.LAUNCHES_SPMM
    if launches != 1:
        raise AssertionError(f"{label}: whell_spmm launched kernel #12 "
                             f"{launches} times, not once")
    layout = (a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
              a.group_bases, a.seg_lo, a.seg_hi)
    x3 = _prep_x(xs, a.n_cols, a.x_pages, stack=True)
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  window_pages=a.window_pages, unit_segments=a.unit_segments,
                  hack_units=a.hack_units, tile_page=a.tile_page)
    zp = kw.whell_packed_spmm_plain(*layout, x3, **static).flatten(1)[:, : a.n_rows]
    err_plain = check_close(z.cpu().numpy(), zp.cpu().numpy(), 1e-5, 1e-5,
                            f"{label}: kernel vs plain")
    call = lambda: kw.whell_packed_spmm(*layout, x3, **static)  # noqa: E731
    ops_ = launched(call)
    own = [n for n in ops_ if n.startswith("whell_")]
    if own != ["whell_spmm_hack_pass"]:
        raise AssertionError(f"{label}: the call ran {ops_}, not one whell_spmm_hack_pass")
    if not torch.equal(call(), call()):
        raise AssertionError(f"{label}: two launches differ")
    lor = a.lane_of_row.cpu().numpy()
    golden = coo.spmv(X[:, lor].astype(np.float64))
    err_golden = check_close(a.extract(z, dtype=torch.float64).cpu().numpy(),
                             golden, 1e-4, 1e-4, f"{label}: kernel vs host golden")
    library, refused = library_call(coo, torch.from_numpy(X[:, lor]).to(device),
                                    device)
    t = timed(call, lambda: kw.whell_packed_spmm_plain(*layout, x3, **static),
              library, refused, op=lambda: whell_spmm(a, xs),
              loop=lambda: whell_spmm(a, xs, fused=False))
    flops = 2 * coo.nnz * N_RHS
    # the hack pass reads hack_units, not chunk_group; the unit scan seg_hi alone
    moved = (nbytes(*layout, a.hack_units, x3, z) - nbytes(a.chunk_group)
             - a.unit_segments * nbytes(a.seg_lo))
    out = dict(n_rhs=N_RHS, nnz=coo.nnz, tiles=a.num_tiles, launches=launches,
               device_ops=ops_, bit_identical=True,
               max_abs_err_vs_plain=err_plain, max_abs_err_vs_golden=err_golden,
               **t, **bound(moved, flops, "float32"))
    return spmm_summary(out, flops, call)


def dia_spmm_phase(coo, fmt, golden, device, label, mode=None):
    """Kernel #14 (``fmt="sdia"``) or #13 (``"whdia"``, r0 ``mode``)
    through the op with ``fused=True`` on 8 RHS, its one launch counted
    and no SpMV launch; #14 must equal its plain version and 8 launches of
    kernel #2 bit for bit, #13 its plain version within 1e-5 (atomics);
    both the float64 ``golden`` within 2e-5.  Then timed as
    ``whell_spmm_phase``, the loop being the op's default."""
    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.convert import coo_to_sdia, coo_to_whdia
    from spgpu_tpu_torch.kernels import sdia as ks
    from spgpu_tpu_torch.kernels import whdia as kd

    mod = ks if fmt == "sdia" else kd
    t0 = time.perf_counter()
    a = (coo_to_sdia if fmt == "sdia" else coo_to_whdia)(coo, device=device)
    torch.cuda.synchronize(device)
    convert_s = time.perf_counter() - t0
    if mode is not None and ("pattern" if a.pattern_mode else "slab") != mode:
        raise AssertionError(f"{label}: not in {mode} mode")
    op = ops.sdia_spmm if fmt == "sdia" else ops.whdia_spmm
    X = rhs_stack(coo.n_cols)
    xs = torch.from_numpy(X).to(device)
    mod.LAUNCHES_SPMM, mod.LAUNCHES = 0, 0
    z = op(a, xs, fused=True)
    torch.cuda.synchronize(device)
    launches = mod.LAUNCHES_SPMM
    if (launches, mod.LAUNCHES) != (1, 0):
        raise AssertionError(f"{label}: {launches} fused and {mod.LAUNCHES} "
                             "SpMV launches, not 1 and 0")
    if fmt == "sdia":
        layout = (a.values, a.offset_table)
        kernel = lambda: ks.sdia_spmm(*layout, xs, n_rows=a.n_rows)  # noqa: E731
        plain = lambda: ks.sdia_spmm_plain(a.values, a.offsets, xs,  # noqa: E731
                                           n_rows=a.n_rows)
        zl = torch.stack([ks.sdia_spmv(*layout, xs[r], n_rows=a.n_rows)
                          for r in range(N_RHS)])
        if not torch.equal(z, zl):
            raise AssertionError(f"{label}: kernel #14 differs from 8 launches "
                                 "of kernel #2")
        tol_plain = 0.0
    else:
        layout = (a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group)
        static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                      num_groups=a.num_groups, tile_page=a.tile_page)
        lists = dict(hack_slot_ptr=a.hack_slot_ptr, hack_slots=a.hack_slots)
        kernel = lambda: kd.whdia_spmm(*layout, xs, **static, **lists)  # noqa: E731
        plain = lambda: kd.whdia_spmm_plain(*layout, xs, **static)  # noqa: E731
        if not torch.equal(kernel(), kernel()):
            raise AssertionError(f"{label}: two launches of the hack pass differ")
        tol_plain = 1e-5
    zp = plain()[:, : a.n_rows]
    err_plain = check_close(z.cpu().numpy(), zp.cpu().numpy(), tol_plain,
                            tol_plain, f"{label}: kernel vs plain")
    err_golden = check_close(z.cpu().numpy(), golden, 2e-5, 2e-5,
                             f"{label}: kernel vs host golden")
    library, refused = library_call(coo, xs, device)
    t = timed(kernel, plain, library, refused,
              op=lambda: op(a, xs, fused=True), loop=lambda: op(a, xs))
    flops = 2 * coo.nnz * N_RHS
    out_bytes = N_RHS * (a.n_rows if fmt == "sdia"
                         else a.num_groups * a.group_hacks * 128) * 4
    # #13 reads only the live slots: its bound is theirs (whdia_bounds)
    moved = (whdia_bounds(a, N_RHS)["live_bytes"] if fmt == "whdia"
             else nbytes(*layout, xs) + out_bytes)
    out = dict(n_rhs=N_RHS, rows=coo.n_rows, nnz=coo.nnz, convert_s=convert_s,
               launches=launches, max_abs_err_vs_plain=err_plain,
               max_abs_err_vs_golden=err_golden, **t,
               **bound(moved, flops, "float32"))
    if fmt == "whdia":
        b = whdia_bounds(a, N_RHS)
        out.update(mode=mode, tiles=a.num_tiles, bit_identical=True,
                   padding=a.total_slots * 128 / coo.nnz, **b,
                   live_bound_share=b["live_bound_ms"] / out["kernel_device_ms"],
                   full_bound_share=b["full_bound_ms"] / out["kernel_device_ms"])
    return spmm_summary(out, flops, kernel)


def loop_path(op, a, xs, mod, counter, label, want, tol, **kw):
    """One SpMM call on its loop path (the op's default, or ``kw``), with
    the SpMV kernel's counter and the module's ``LAUNCHES_SPMM`` set to 0
    just before and read just after: ``N_RHS`` SpMV launches and no SpMM
    launch; the result within ``tol``·max|Z| of ``want()``."""
    import torch

    setattr(mod, counter, 0)
    mod.LAUNCHES_SPMM = 0
    z = op(a, xs, **kw)
    torch.cuda.synchronize()
    got = (getattr(mod, counter), mod.LAUNCHES_SPMM)
    if got != (N_RHS, 0):
        raise AssertionError(f"{label}: {got[0]} SpMV and {got[1]} SpMM "
                             f"launches, not {N_RHS} and 0")
    err = check_close(z.cpu().numpy(), want().cpu().numpy(), tol, tol,
                      f"{label}: loop vs reference")
    return dict(spmv_launches=got[0], spmm_launches=got[1], dtype=str(z.dtype),
                max_abs_err=err)


def spmm_loop_phase(lap, band, a32, a64, ac64, device):
    """``loop_path`` on every loop of the SpMMs on 8 RHS: the SDIA and
    WHDIA defaults (the Laplacian, banded-11), ``whell_spmm(fused=False)``
    on the fp32 flagship layout ``a32``, and the float64 and complex64
    ``whell_spmm`` defaults (``a64``, ``ac64``), each held against the
    plain fused product (exact for SDIA)."""
    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.convert import coo_to_sdia, coo_to_whdia
    from spgpu_tpu_torch.kernels import sdia as ks
    from spgpu_tpu_torch.kernels import whdia as kd
    from spgpu_tpu_torch.kernels import whell as kw

    def stack(n, dtype=torch.float32):
        return torch.from_numpy(rhs_stack(n)).to(device, dtype)

    def plain_whell(a, xs):
        x3 = ops._prep_x(xs, a.n_cols, a.x_pages, stack=True)
        return lambda: kw.whell_packed_spmm_plain(
            a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
            a.group_bases, a.seg_lo, a.seg_hi, x3, chunk_tiles=a.chunk_tiles,
            group_hacks=a.group_hacks, window_pages=a.window_pages,
            unit_segments=a.unit_segments, tile_page=a.tile_page).flatten(1)[:, : a.n_rows]

    sl, x_lap = coo_to_sdia(lap, device=device), stack(lap.n_cols)
    wl, x_band = coo_to_whdia(band, device=device), stack(band.n_cols)
    x_fl = stack(a32.n_cols)
    out = {
        "sdia_default": loop_path(
            ops.sdia_spmm, sl, x_lap, ks, "LAUNCHES", "loop sdia",
            lambda: ks.sdia_spmm_plain(sl.values, sl.offsets, x_lap,
                                       n_rows=sl.n_rows), 0.0),
        "whdia_default": loop_path(
            ops.whdia_spmm, wl, x_band, kd, "LAUNCHES", "loop whdia",
            lambda: kd.whdia_spmm_plain(
                wl.values, wl.slot_r0, wl.tile_r0, wl.tile_base,
                wl.chunk_group, x_band, chunk_tiles=wl.chunk_tiles,
                group_hacks=wl.group_hacks, num_groups=wl.num_groups,
                tile_page=wl.tile_page)[:, : wl.n_rows], 1e-5),
        "whell_fused_false": loop_path(
            ops.whell_spmm, a32, x_fl, kw, "LAUNCHES", "loop whell fp32",
            plain_whell(a32, x_fl), 1e-5, fused=False)}
    for a, dt, counter, tol in ((a64, torch.float64, "LAUNCHES_F64", 1e-12),
                                (ac64, torch.complex64, "LAUNCHES_C64", 1e-5)):
        xs = stack(a.n_cols, dt)
        out[f"whell_{str(dt).removeprefix('torch.')}_default"] = loop_path(
            ops.whell_spmm, a, xs, kw, counter, f"loop whell {dt}",
            plain_whell(a, xs), tol)
    return out


def classic_live(a, x2, n_rhs=1):
    """What kernels #15 and #16 read of a classic layout: the work list's
    share of the (tile, 32-lane quarter) units and of the (slot, 32-lane)
    warp-slots, and four bounds: the full layout (every layout array once,
    x and the stored-row z once per RHS: what the first designs read);
    the live warp-slots' (their whole 32 lanes of values and residues, the
    32 B page-table sectors their nonzero cells touch, the work list, x
    and z once per RHS: what #15 read before its sector list and #16
    reads); and the live sectors' at 32 B and at 64 B (values only in the
    32 B sectors, or 64 B segments, that hold a nonzero, the rest as the
    warp-slots', plus the sector list, 8 B a live unit, where the layout
    carries one: a float64 layout's, which #15 and #16 read).
    ``live_bound_bytes`` is the 32 B one.  Beside the bounds, not one of
    them: ``gather_mb``, the X bytes the nonzero cells gather through the
    L2 (one x row of ``n_rhs`` items each), which the bounds count once
    per x.  ``x2`` is the padded x,
    ``(x_pages, 128)``, or the ``(n_rhs, x_pages, 128)`` stack of
    ``n_rhs`` RHS; z has its type.  Computed from the values and the work
    list, so an older checkout (no sector list) is priced too."""
    import torch

    wl = a.work_list
    S = a.total_slots
    live_slots = int(((wl & 0xFF).view(-1, 1) >> torch.arange(8, device=wl.device)
                      & 1).sum())
    nz = a.values != 0
    sectors = torch.zeros((S, 4), dtype=torch.bool, device=a.device)
    slot, lane = torch.nonzero(nz, as_tuple=True)
    sectors[slot, a.residue[slot, lane].long() >> 5] = True
    isz, zsz = a.values.element_size(), x2.element_size()
    dt = str(x2.dtype).removeprefix("torch.")
    rest = (live_slots * 32 + int(sectors.sum()) * 32 + nbytes(wl, x2)
            + n_rhs * a.rows_padded * zsz)
    value_bytes = {g: int(nz.view(S, 128 * isz // g, g // isz).any(dim=2).sum()) * g
                   for g in (32, 64)}
    warp_slot = live_slots * 32 * isz + rest
    listed = nbytes(getattr(a, "work_sectors", None))
    sector = {g: value_bytes[g] + rest + listed for g in (32, 64)}
    full = nbytes(a.values, a.residue, a.page_tab, a.tile_base,
                  getattr(a, "tile_page", None), a.chunk_group, x2) \
        + n_rhs * a.rows_padded * zsz
    return dict(units=a.num_tiles * 4, live_units=wl.numel(),
                live_unit_share=wl.numel() / (a.num_tiles * 4),
                warp_slots=S * 4, live_warp_slots=live_slots,
                live_warp_slot_share=live_slots / (S * 4),
                live_slab_mib=live_slots * 32 * (isz + 2) / 2**20,
                live_sector_value_mb=value_bytes[32] / 1e6,
                live_segment_value_mb=value_bytes[64] / 1e6,
                gather_mb=int(nz.sum()) * n_rhs * zsz / 1e6,
                warp_slot_value_mb=live_slots * 32 * isz / 1e6,
                full_bound_ms=bound(full, 0, dt)["bound_ms"], full_bound_bytes=full,
                warp_slot_bound_ms=bound(warp_slot, 0, dt)["bound_ms"],
                warp_slot_bound_bytes=warp_slot,
                segment_bound_ms=bound(sector[64], 0, dt)["bound_ms"],
                segment_bound_bytes=sector[64], live_bound_bytes=sector[32])


def classic_shares(out, ms):
    """The kernel's share (``bound / ms``) of each bound of
    :func:`classic_live` in ``out`` (``bound_ms`` is the 32 B sectors')."""
    return dict(live_bound_share=out["bound_ms"] / ms,
                warp_slot_bound_share=out["warp_slot_bound_ms"] / ms,
                segment_bound_share=out["segment_bound_ms"] / ms,
                full_bound_share=out["full_bound_ms"] / ms)


def classic_types(a):
    """A classic layout's x type (NumPy), its kernels' launch counters
    (#15, #16) and the tolerances (rtol, atol·max|z|) against the plain
    version and against the golden: fp32 or bf16 values take an fp32 x
    (atomics: 1e-5; the golden 1e-4), float64 ones a float64 x
    (1e-12·max|z| against both)."""
    import torch

    if a.values.dtype == torch.float64:
        return np.float64, "LAUNCHES_F64", "LAUNCHES_SPMM_F64", (0, 1e-12), (0, 1e-12)
    return np.float32, "LAUNCHES", "LAUNCHES_SPMM", (1e-5, 1e-5), (1e-4, 1e-4)


def classic_phase(coo, a, device, label, cold=False):
    """Kernel #15 through ``whell_spmv`` on a classic layout (fp32 or bf16
    values and an fp32 x, or float64 values and x: ``classic_types``), its
    one launch counted from 0 on its type's counter; the op's result held
    against the full-layout plain version's and the float64 golden; then
    the kernel (over the layout's work list), the plain version and the
    library call (cuSPARSE CSR in x's type) timed, with both bounds of
    ``classic_live`` (``bound_ms`` is the live one) and the kernel's share
    of each; with ``cold``, also the kernel's own device time warm and
    cold (``kernel_device``)."""
    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.kernels import whell_classic as kc

    xdt, counter, _, tol_plain, tol_golden = classic_types(a)
    x = rand_vector(coo.n_cols, 7, xdt)
    xt = torch.from_numpy(x).to(device)
    setattr(kc, counter, 0)
    z = ops.whell_spmv(a, xt)
    torch.cuda.synchronize(device)
    launches = getattr(kc, counter)
    if launches != 1:
        raise AssertionError(f"{label}: whell_spmv launched kernel #15 {launches} times")
    layout = (a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group)
    x2 = ops._prep_x(xt, a.n_cols, a.x_pages)
    zp = ops._classic_rows(a, kc.whell_classic_spmv_plain(
        *layout, x2, num_groups=a.num_groups, tile_page=a.tile_page).view(-1))
    err_plain = check_close(z.cpu().numpy(), zp.cpu().numpy(), *tol_plain,
                            f"{label}: kernel vs plain")
    err_golden = check_close(z.cpu().numpy(), coo.spmv(x.astype(np.float64)),
                             *tol_golden, f"{label}: kernel vs host golden")
    library, refused = library_call(coo, xt, device)
    kernel = lambda: kc.whell_classic_spmv(  # noqa: E731
        *layout, x2, num_groups=a.num_groups, work=a.work_list,
        work_sectors=a.work_sectors, tile_page=a.tile_page)
    t = timed(kernel,
              lambda: kc.whell_classic_spmv_plain(*layout, x2, num_groups=a.num_groups,
                                                  tile_page=a.tile_page),
              library, refused)
    flops = 2 * coo.nnz
    slab_bytes = a.total_slots * 128 * (a.values.element_size() + 2)
    live = classic_live(a, x2)
    out = dict(
        nnz=coo.nnz, tiles=a.num_tiles, launches=launches,
        padding=a.total_slots * 128 / coo.nnz, slab_mib=slab_bytes / 2**20,
        max_abs_err_vs_plain=err_plain, max_abs_err_vs_golden=err_golden, **t,
        kernel_device_gflops=flops / (t["kernel_device_ms"] * 1e6),
        kernel_device_slab_gbytes_per_s=slab_bytes / (t["kernel_device_ms"] * 1e6),
        **live, **bound(live["live_bound_bytes"], flops, np.dtype(xdt).name))
    if cold:
        out["kernel_device"] = kernel_cold(kernel, ("classic_spmv",))
    return dict(out, **classic_shares(out, t["kernel_device_ms"]))


def classic_variant(coo, device, label, **kw):
    """The raw flagship through ``coo_to_whell(packed=False, **kw)`` (OELL
    order or way-split rows) and kernel #15 through ``whell_spmv``, its
    one launch counted from 0, held against the full-layout plain version
    (1e-5, 1e-5·max|z|) and the float64 golden (1e-4); the layout's
    padding, slab size and work-list shares, the kernel's device time and
    its share of both bounds."""
    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.convert import coo_to_whell
    from spgpu_tpu_torch.kernels import whell_classic as kc
    from spgpu_tpu_torch.utils.timing import device_ms

    t0 = time.perf_counter()
    a = coo_to_whell(coo, device=device, packed=False, **kw)
    torch.cuda.synchronize(device)
    convert_s = time.perf_counter() - t0
    x = rand_vector(coo.n_cols, 7, np.float32)
    xt = torch.from_numpy(x).to(device)
    kc.LAUNCHES = 0
    z = ops.whell_spmv(a, xt)
    torch.cuda.synchronize(device)
    launches = kc.LAUNCHES
    if launches != 1:
        raise AssertionError(f"{label}: whell_spmv launched kernel #15 {launches} times")
    x2 = ops._prep_x(xt, a.n_cols, a.x_pages)
    layout = (a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group)
    zp = ops._classic_rows(a, kc.whell_classic_spmv_plain(
        *layout, x2, num_groups=a.num_groups, tile_page=a.tile_page).view(-1))
    err_plain = check_close(z.cpu().numpy(), zp.cpu().numpy(), 1e-5, 1e-5,
                            f"{label}: kernel vs plain")
    del zp
    err = check_close(z.cpu().numpy(), coo.spmv(x.astype(np.float64)), 1e-4, 1e-4,
                      f"{label}: kernel vs host golden")
    dev, src = device_ms(lambda: kc.whell_classic_spmv(*layout, x2,
                                                       num_groups=a.num_groups,
                                                       work=a.work_list,
                                                       work_sectors=a.work_sectors,
                                                       tile_page=a.tile_page))
    op_dev, _ = device_ms(lambda: ops.whell_spmv(a, xt))
    slab_bytes = a.total_slots * 128 * (a.values.element_size() + 2)
    live = classic_live(a, x2)
    out = dict(options=kw, convert_s=convert_s, tiles=a.num_tiles, launches=launches,
               rows_padded=a.rows_padded, padding=a.total_slots * 128 / coo.nnz,
               slab_mib=slab_bytes / 2**20, max_abs_err_vs_plain=err_plain,
               max_abs_err_vs_golden=err, kernel_device_ms=dev,
               kernel_device_source=src, op_device_ms=op_dev, **live,
               **bound(live["live_bound_bytes"], 2 * coo.nnz, "float32"))
    return dict(out, **classic_shares(out, dev))


def classic_update(coo, a, plan, device, label):
    """``whell_update_values`` on a classic fp32 or float64 layout: first
    with every third entry set to 0 (the work list shrinks), then with new
    values at every entry (``default_rng(5)``; it grows back); after each,
    kernel #15 through ``whell_spmv`` (one launch on its type's counter)
    against the full-layout plain version and the golden of the new
    values, at ``classic_types``' tolerances."""
    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.convert import whell_update_values
    from spgpu_tpu_torch.formats.coo import CooMatrix
    from spgpu_tpu_torch.kernels import whell_classic as kc

    xdt, counter, _, tol_plain, tol_golden = classic_types(a)
    rng = np.random.default_rng(5)
    thinned = coo.values.copy()
    thinned[::3] = 0
    x = rand_vector(coo.n_cols, 9, xdt)
    xt = torch.from_numpy(x).to(device)
    out = dict(launches=0)
    for tag, vals in (("thinned", thinned),
                      ("refreshed", rng.standard_normal(coo.nnz).astype(xdt))):
        b = whell_update_values(a, plan, vals)
        setattr(kc, counter, 0)
        z = ops.whell_spmv(b, xt)
        torch.cuda.synchronize(device)
        got = getattr(kc, counter)
        if got != 1:
            raise AssertionError(f"{label} {tag}: {got} launches of #15")
        out["launches"] += got
        zp = ops._classic_rows(b, kc.whell_classic_spmv_plain(
            b.values, b.residue, b.page_tab, b.tile_base, b.chunk_group,
            ops._prep_x(xt, b.n_cols, b.x_pages), num_groups=b.num_groups,
            tile_page=b.tile_page).view(-1))
        golden = CooMatrix(coo.rows, coo.cols, vals, coo.n_rows, coo.n_cols).spmv(
            x.astype(np.float64))
        out[tag] = dict(
            live_units=b.work_list.numel(),
            max_abs_err_vs_plain=check_close(z, zp, *tol_plain,
                                             f"{label} {tag}: kernel vs plain"),
            max_abs_err_vs_golden=check_close(z, golden, *tol_golden,
                                              f"{label} {tag}: kernel vs golden"))
        del b
    return out


def classic_spmm_phase(coo, a, device, label, cold=False):
    """Kernel #16 through ``whell_spmm(fused=True)`` on a classic layout, 8
    RHS (fp32 X for fp32 or bf16 values, float64 for float64), its one
    launch counted from 0 on its type's counter (and none of #15); the
    default (the loop of #15: 8 launches, none of #16) counted the same
    way; both held against the plain fused product and the fused one
    against the float64 golden per RHS, at ``classic_types``' tolerances;
    then the kernel (over the layout's work list), the plain version, the
    fused op, the loop and cuSPARSE SpMM timed, with both bounds of
    ``classic_live`` for 8 RHS (``bound_ms`` is the live one: X and the
    stored-row Z for every RHS) and the kernel's share of each; with
    ``cold``, also the kernel's own device time warm and cold."""
    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.kernels import whell_classic as kc

    xdt, c15, c16, tol_plain, tol_golden = classic_types(a)
    X = rhs_stack(coo.n_cols, xdt)
    xs = torch.from_numpy(X).to(device)
    counted, counts = {}, {}
    for name, fused, want in (("fused", True, (1, 0)), ("loop", None, (0, N_RHS))):
        setattr(kc, c16, 0)
        setattr(kc, c15, 0)
        counted[name] = ops.whell_spmm(a, xs, fused=fused)
        torch.cuda.synchronize(device)
        got = counts[name] = (getattr(kc, c16), getattr(kc, c15))
        if got != want:
            raise AssertionError(f"{label} {name}: {got[0]} launches of #16 and "
                                 f"{got[1]} of #15, not {want}")
    z = counted["fused"]
    layout = (a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group)
    x3 = ops._prep_x(xs, a.n_cols, a.x_pages, stack=True)
    static = dict(num_groups=a.num_groups, tile_page=a.tile_page)
    zp = ops._classic_rows(a, kc.whell_classic_spmm_plain(*layout, x3, **static)
                           .flatten(1))
    err_plain = check_close(z.cpu().numpy(), zp.cpu().numpy(), *tol_plain,
                            f"{label}: kernel vs plain")
    err_loop = check_close(counted["loop"].cpu().numpy(), zp.cpu().numpy(), *tol_plain,
                           f"{label}: loop of #15 vs plain")
    err_golden = check_close(z.cpu().numpy(), coo.spmv(X.astype(np.float64)),
                             *tol_golden, f"{label}: kernel vs host golden")
    library, refused = library_call(coo, xs, device)
    kernel = lambda: kc.whell_classic_spmm(*layout, x3, work=a.spmm_work,  # noqa: E731
                                           work_sectors=a.spmm_work_sectors, **static)
    t = timed(kernel, lambda: kc.whell_classic_spmm_plain(*layout, x3, **static),
              library, refused, op=lambda: ops.whell_spmm(a, xs, fused=True),
              loop=lambda: ops.whell_spmm(a, xs))
    flops = 2 * coo.nnz * N_RHS
    live = classic_live(a, x3, n_rhs=N_RHS)
    out = dict(n_rhs=N_RHS, nnz=coo.nnz, tiles=a.num_tiles, launches=counts["fused"][0],
               loop_spmv_launches=counts["loop"][1], max_abs_err_vs_plain=err_plain,
               loop_max_abs_err_vs_plain=err_loop, max_abs_err_vs_golden=err_golden,
               **t, **live, **bound(live["live_bound_bytes"], flops, np.dtype(xdt).name))
    if cold:
        out["kernel_device"] = kernel_cold(kernel, ("classic_spmm",))
    out.update(classic_shares(out, t["kernel_device_ms"]))
    return spmm_summary(out, flops, kernel)


def pcell_phase(coo, device, spmv, label, ptxas=None):
    """``coo_to_whell_percell`` (timed) in the COO's type (float32 or
    float64) and kernel #17 through ``whell_spmv``, its one launch counted
    from 0 on its type's counter; held against the plain version and the
    float64 golden (fp32: 1e-5 and 1e-4; float64: 1e-12·max|z| against
    both); its z written over a NaN-filled block and the same bits twice;
    then timed with its bound (the listed tiles' cells once, 8 B a cell in
    fp32, 12 in float64, their pages, the hack lists, x and z once: what
    the hack pass reads) beside the full one (every layout array once),
    beside the packed WHELL kernel's device time and bound on the same
    matrix in the same type (``spmv``, the spmv or spmv_f64 phase's
    result); a float64 one also with its kernel's own device time warm and
    cold and its ptxas line (``ptxas``)."""
    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.convert import coo_to_whell_percell
    from spgpu_tpu_torch.kernels import pcell as kp

    t0 = time.perf_counter()
    p = coo_to_whell_percell(coo, device=device)
    torch.cuda.synchronize(device)
    convert_s = time.perf_counter() - t0
    f64 = p.values.dtype == torch.float64
    xdt, counter = (np.float64, "LAUNCHES_F64") if f64 else (np.float32, "LAUNCHES")
    tol_plain, tol_golden = ((0, 1e-12), (0, 1e-12)) if f64 else \
        ((1e-5, 1e-5), (1e-4, 1e-4))
    x = rand_vector(coo.n_cols, 7, xdt)
    xt = torch.from_numpy(x).to(device)
    setattr(kp, counter, 0)
    z = ops.whell_spmv(p, xt)
    torch.cuda.synchronize(device)
    launches = getattr(kp, counter)
    if launches != 1:
        raise AssertionError(f"{label}: whell_spmv launched kernel #17 {launches} times")
    layout = (p.values, p.residue, p.page_tab, p.run_hi, p.run_lo, p.tile_base,
              p.chunk_group, p.group_bases)
    x2 = ops._prep_x(xt, p.n_cols, p.x_pages)
    static = dict(chunk_tiles=p.chunk_tiles, group_hacks=p.group_hacks,
                  window_pages=p.window_pages, num_groups=p.num_groups,
                  tile_page=p.tile_page)
    zp = kp.pcell_spmv_plain(*layout, x2, **static).view(-1)[: p.n_rows]
    err_plain = check_close(z.cpu().numpy(), zp.cpu().numpy(), *tol_plain,
                            f"{label}: kernel vs plain")
    err_golden = check_close(z.cpu().numpy(), coo.spmv(x.astype(np.float64)),
                             *tol_golden, f"{label}: kernel vs host golden")
    library, refused = library_call(coo, xt, device)
    kernel = lambda: kp.pcell_spmv(*layout, x2, **static,  # noqa: E731
                                   hack_tiles=p.hack_tiles, hack_units=p.hack_units)
    zk = written_over_nan(kernel, p.num_groups * p.group_hacks * 128, p.values.dtype,
                          device, label)
    if not torch.equal(zk, kernel()):
        raise AssertionError(f"{label}: two launches differ")
    t = timed(kernel, lambda: kp.pcell_spmv_plain(*layout, x2, **static), library,
              refused)
    flops = 2 * coo.nnz
    slab_bytes = p.total_slots * 128 * (p.values.element_size() + 4)
    listed = p.hack_tiles.numel()
    moved = (listed * (1024 * (p.values.element_size() + 4) + 4)
             + nbytes(p.group_bases, p.hack_tiles, p.hack_units, x2, z))
    out = dict(
        nnz=coo.nnz, convert_s=convert_s, tiles=p.num_tiles, listed_tiles=listed,
        work_units=p.hack_units.shape[0], bit_identical=True, rows_written_over_nan=True,
        full_bound_ms=bound(nbytes(*layout, x2, z), flops,
                            np.dtype(xdt).name)["bound_ms"],
        group_hacks=p.group_hacks, chunk_tiles=p.chunk_tiles,
        layout_groups=p.group_bases.numel() // (p.window_pages // 8),
        padding=p.total_slots * 128 / coo.nnz, slab_mib=slab_bytes / 2**20,
        max_abs_err_vs_plain=err_plain, max_abs_err_vs_golden=err_golden, **t,
        kernel_device_gflops=flops / (t["kernel_device_ms"] * 1e6),
        packed_whell_device_ms=spmv["kernel_device_ms"],
        packed_whell_bound_ms=spmv["bound_ms"], packed_whell_padding=spmv["padding"],
        **bound(moved, flops, np.dtype(xdt).name))
    if f64:
        out.update(kernel_device=kernel_cold(kernel, ("pcell_hack_pass",)), ptxas=ptxas)
    return dict(out, bound_share=out["bound_ms"] / t["kernel_device_ms"])


def solve_pcell(spd, device, smi):
    """``solve(spd, b, fmt="pcell")`` in the system's type (float32: tol
    1e-5, true residual ≤ 1e-4; float64: 1e-10, ≤ 1e-9), counted on kernel
    #17's counter of that type from 0, then the graphed CG loop against
    its eager witness on the pcell layout that ``solve()`` built (kept by
    wrapping its converter: a second conversion of the SPD system takes
    about 20 s), held to each other bit for bit (#17 gives the same bits
    every call), with the layout's listed tiles and work units."""
    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.kernels import pcell as kp
    from spgpu_tpu_torch.solvers import auto

    f64 = spd.values.dtype == np.float64
    dt, counter = (np.float64, "LAUNCHES_F64") if f64 else (np.float32, "LAUNCHES")
    tol, true_tol = (1e-10, 1e-9) if f64 else (1e-5, 1e-4)
    x_true = rand_vector(spd.n_rows, 1, np.float64)
    b = spd.spmv(x_true).astype(dt)
    built = []
    convert = auto.coo_to_whell_percell
    auto.coo_to_whell_percell = lambda *a, **k: built.append(convert(*a, **k)) or built[-1]
    try:
        _, xs, solved = counted_solve(spd, b, (kp, counter), device, tol, true_tol,
                                      fmt="pcell", maxiter=5000)
    finally:
        auto.coo_to_whell_percell = convert
    p, = built
    rows = p.num_groups * p.group_hacks
    return dict(nnz=spd.nnz, tiles=p.num_tiles, padding=p.total_slots * 128 / spd.nnz,
                listed_tiles=p.hack_tiles.numel(), work_units=p.hack_units.shape[0],
                chunked_rows=int(((p.hack_units[:, 3] >= 0)
                                  & (p.hack_units[:, 3] >> 16 == 0)).sum()),
                rows=rows, tol=tol, **solved,
                loop=loop_pair("cg", lambda v: ops.whell_spmv(p, v),
                               torch.from_numpy(b).to(device), tol,
                               ("pcell", np.dtype(dt).name) in BIT_REPRODUCIBLE,
                               residual_gate(spd, b, true_tol, f"cg pcell {dt.__name__}"),
                               smi),
                x_err_vs_true=float(np.abs(xs - x_true).max()))


#: the sizes of the large phases (30, 31): the rows of the JAX benchmark's
#: row-block cells (``bench.py:306-389``, its TPU size), the side of the
#: 9.4M-row Laplacian (the smallest 1024-multiple side whose x pages pass
#: the 16-bit page field) and the CG iterations its solves run, the rows of
#: banded-11, of the tridiagonal and of the permutation-coupled matrix
LARGE = dict(bench=1 << 22, lap=3072, lap_maxiter=400, band=9_000_000,
             tri=9_000_000, perm=4_500_000)

#: the old widths of tile_base's low field: aligned base pages (16 bits)
#: and scattered layout groups (20 bits)
OLD_PAGES, OLD_GROUPS = 1 << 16, 1 << 20


def converted(make):
    """``make()``, a layout on the card, and its converter's seconds."""
    import torch

    t0 = time.perf_counter()
    a = make()
    torch.cuda.synchronize()
    return a, time.perf_counter() - t0


def layout_summary(a, coo, convert_s):
    """What a large phase prints of each layout: rows, nonzeros, x pages,
    layout groups (scattered), tiles, slab bytes (values and per-cell
    index bytes), the converter's seconds, the largest tile_page word and
    the old field it passes."""
    groups = (None if getattr(a, "group_bases", None) is None
              else a.group_bases.numel() // (a.window_pages // 8))
    slab = nbytes(*(getattr(a, f, None) for f in ("values", "residue", "page_tab",
                                                  "slot_r0", "tile_r0")))
    top = int(a.tile_page.max())
    past = (f"{groups} layout groups > 2**20" if groups is not None and groups > OLD_GROUPS
            else f"{a.x_pages} x pages > 65,536" if groups is None and a.x_pages > OLD_PAGES
            else "within the old fields")
    return dict(rows=coo.n_rows, nnz=coo.nnz, x_pages=a.x_pages, layout_groups=groups,
                tiles=a.num_tiles, slab_bytes=slab, convert_s=convert_s,
                max_tile_page=top, past=past)


def tridiagonal(n, dtype):
    """A diagonally dominant tridiagonal system (4 on the diagonal,
    ``-U(0, 1)`` beside it, ``default_rng(3)``), rows in order: F1's
    case at 9M rows."""
    from spgpu_tpu_torch.formats.coo import CooMatrix

    i = np.arange(n, dtype=np.int64)
    rng = np.random.default_rng(3)
    rows = np.concatenate([i[1:], i, i[:-1]])
    cols = np.concatenate([i[:-1], i, i[1:]])
    vals = np.concatenate([rng.uniform(-1, 0, n - 1), np.full(n, 4.0),
                           rng.uniform(-1, 0, n - 1)])
    o = np.lexsort((cols, rows))
    return CooMatrix(rows[o], cols[o], vals[o].astype(dtype), n, n)


def permutation_coupled(n):
    """Row ``i`` couples to ``i`` (2) and to ``π(i)`` (``U(-1, 1)``) for a
    permutation ``π`` of ``default_rng(11)``, fp32: each 128-row hack
    reaches about 128 scattered superpages, so its scattered windows need
    about 33 layout groups, past 2**20 at 4.5M rows."""
    from spgpu_tpu_torch.formats.coo import CooMatrix

    rng = np.random.default_rng(11)
    pi = rng.permutation(n)
    i = np.arange(n, dtype=np.int64)
    rows, cols = np.concatenate([i, i]), np.concatenate([i, pi])
    vals = np.concatenate([np.full(n, 2.0), rng.uniform(-1, 1, n)]).astype(np.float32)
    o = np.lexsort((cols, rows))
    return CooMatrix(rows[o], cols[o], vals[o], n, n).sum_duplicates()


def chunked_plain(a, x2, tiles=1 << 16):
    """The plain product of #1 (:func:`~spgpu_tpu_torch.kernels.whell.
    whell_tile_sums`, ``index_add_`` into the hack rows, the flush) over
    runs of ``tiles`` tiles (whole chunks), so that a layout of a billion
    cells needs no more than a few GB for its index tensors."""
    import torch

    from spgpu_tpu_torch.kernels import whell as kw

    T, ct = a.num_tiles, a.chunk_tiles
    step = max(tiles // ct, 1) * ct
    acc = torch.zeros((1, a.seg_lo.shape[0], 128), dtype=torch.float32, device=a.device)
    for t0 in range(0, T, step):
        t1 = min(t0 + step, T)
        cells = slice(8 * t0, 8 * t1)
        sums, hack = kw.whell_tile_sums(
            a.values[cells], a.residue[cells], a.page_tab[cells], a.tile_base[t0:t1],
            a.chunk_group[t0 // ct: t1 // ct + 1], a.group_bases, x2[None],
            chunk_tiles=ct, group_hacks=a.group_hacks, window_pages=a.window_pages,
            tile_page=a.tile_page[t0:t1])
        acc.index_add_(1, hack, sums)
    return kw.whell_flush_plain(acc, a.seg_lo, a.seg_hi, a.unit_segments)[0]


def chunked_hack_plain(a, x2, rows=1024):
    """The kernels' per-hack plain product (:func:`~spgpu_tpu_torch.kernels.
    whell.whell_hack_sums`, then the flush) over batches of ``rows`` output
    rows, each batch's work units on their own tiles gathered apart (a
    row's chunks stay in one batch, so each row adds its chunks in chunk
    order as in one call), so that a layout of a billion cells needs no
    more than a few GB for its index tensors."""
    import torch

    from spgpu_tpu_torch.kernels import whell as kw

    dev = x2.device
    units = a.hack_units.long()
    R = a.seg_lo.shape[0]
    acc = torch.zeros((1, R, 128), dtype=x2.dtype, device=dev)
    for r0 in range(0, R, rows):
        u = units[(units[:, 2] >= r0) & (units[:, 2] < r0 + rows)]
        n = u[:, 1] - u[:, 0]
        begin = torch.cumsum(n, 0) - n
        tiles = (torch.repeat_interleave(u[:, 0] - begin, n)
                 + torch.arange(int(n.sum()), device=dev))
        cells = (tiles[:, None] * 8 + torch.arange(8, device=dev)).view(-1)
        local = torch.stack([begin, begin + n, u[:, 2], u[:, 3]], 1).int()
        acc += kw.whell_hack_sums(
            a.values[cells], a.residue[cells], a.page_tab[cells], a.tile_base[tiles],
            a.group_bases, local, x2[None], num_rows=R, window_pages=a.window_pages,
            tile_page=a.tile_page[tiles])
    return kw.whell_flush_plain(acc, a.seg_lo, a.seg_hi, a.unit_segments)[0]


def kernel_cold(fn, prefixes):
    """The kernel's device times of :func:`op_times`, warm and cold."""
    t = op_times(fn, prefixes)
    return {k: t[k] for k in ("kernels", "device_ms", "cold_device_ms",
                              "device_source", "cold_source", "op_device_ms")}


def large_phase(device, smi):
    """Phase 30 (``--large``): the JAX benchmark's row-block cells at its
    TPU size, on one packed layout: ``random_fem_like(2**22, 9.0,
    span=1200, far_frac=0.005, seed=5)`` in fp32 through ``whell_spmv``
    (#1) and in complex64 (``with_imag(fem, 9, complex64)``) through #7,
    and its float64 system (``random_banded(2**22, bands=9,
    wander=3, seed=6)`` symmetrised, 30 on the diagonal, duplicates
    summed, as ``bench.py:356-366`` builds it) through ``solve(...,
    fmt="blocks", tol=1e-12, maxiter=60)`` twice with the ``b`` of
    ``default_rng(3)`` (the second call warm), then, on the layout that
    route builds (the packed converter, timed alone), through #4 and the
    graphed loop alone beside its eager witness (``loop_pair``, the
    counterpart of the bench's warm ``blocks_cg``).  Each product is held
    to its plain version and the golden (``spmv_phase``), with its
    layout, its kernel's device time warm and cold, the plain version's,
    cuSPARSE CSR's and the bound.  Returns the phase and its main-path
    launches by kernel: the solves' and each checked op call's, each
    counted from 0."""
    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.convert import coo_to_whell
    from spgpu_tpu_torch.formats.coo import CooMatrix
    from spgpu_tpu_torch.kernels import whell as kw
    from spgpu_tpu_torch.utils.fixtures import random_banded, random_fem_like

    nb = LARGE["bench"]
    out = dict(card=smi)
    t0 = time.perf_counter()
    fem = random_fem_like(nb, 9.0, span=1200, far_frac=0.005, seed=5, dtype=np.float32)
    a, convert_s = converted(lambda: coo_to_whell(fem, device=device))
    xl = a.embed(torch.from_numpy(rand_vector(nb, 7, np.float32)), dtype=torch.float32)
    check = spmv_phase(fem, a, device, "large fem fp32")
    out["fem_fp32"] = dict(
        fixture="random_fem_like(2**22, 9.0, span=1200, far_frac=0.005, seed=5)",
        **layout_summary(a, fem, convert_s) | check,
        kernel_device=kernel_cold(lambda: ops.whell_spmv(a, xl), ("whell_",)),
        item_s=time.perf_counter() - t0)
    del a, xl

    t0 = time.perf_counter()
    fem = with_imag(fem, 9, np.complex64)
    a, convert_s = converted(lambda: coo_to_whell(fem, device=device))
    xl = a.embed(torch.from_numpy(rand_vector(nb, 7, np.complex64)),
                 dtype=torch.complex64)
    check = spmv_phase(fem, a, device, "large fem complex64")
    out["fem_c64"] = dict(
        fixture="with_imag(random_fem_like(2**22, 9.0, span=1200, far_frac=0.005, "
        "seed=5), 9, complex64)", **layout_summary(a, fem, convert_s) | check,
        kernel_device=kernel_cold(lambda: ops.whell_spmv(a, xl), ("whell_",)),
        item_s=time.perf_counter() - t0)
    del a, xl, fem
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    bl = random_banded(nb, bands=9, wander=3, seed=6, dtype=np.float64)
    idx = np.arange(nb, dtype=np.int64)
    band = CooMatrix(np.concatenate([bl.rows, bl.cols, idx]),
                     np.concatenate([bl.cols, bl.rows, idx]),
                     np.concatenate([bl.values * 0.5, bl.values * 0.5,
                                     np.full(nb, 30.0)]), nb, nb).sum_duplicates()
    del bl
    b = np.random.default_rng(3).standard_normal(nb)
    solves = {}
    for call in ("cold", "warm"):
        _, _, solves[call] = counted_solve(band, b, (kw, "LAUNCHES_F64"), device,
                                           1e-12, 1e-10, fmt="blocks", maxiter=60)
        solves[call]["ms_per_iter"] = 1e3 * solves[call]["solve_total_s"] / max(
            solves[call]["iterations"], 1)
    # the layout fmt="blocks" builds: the packed converter, timed alone
    a, convert_s = converted(lambda: coo_to_whell(band, device=device))
    b_l = a.embed(torch.from_numpy(b), dtype=torch.float64)
    loop = loop_pair("cg", lambda v: ops.whell_spmv(a, v), b_l, 1e-12,
                     ("whell", "float64") in BIT_REPRODUCIBLE,
                     residual_gate(band, b, 1e-10, "large blocks cg",
                                   extract=lambda v: a.extract(v, dtype=torch.float64)),
                     smi, maxiter=60)
    xl = a.embed(torch.from_numpy(rand_vector(nb, 7, np.float64)), dtype=torch.float64)
    check = spmv_phase(band, a, device, "large band float64")
    out["band_f64"] = dict(
        fixture="random_banded(2**22, bands=9, wander=3, seed=6) symmetrised, "
        "30 on the diagonal", **layout_summary(a, band, convert_s) | check,
        kernel_device=kernel_cold(lambda: ops.whell_spmv(a, xl), ("whell_",)),
        solve_blocks=dict(solves, fmt="blocks", tol=1e-12, maxiter=60, loop=loop),
        item_s=time.perf_counter() - t0)
    launches = {"whell_packed_spmv": out["fem_fp32"]["launches"],
                "whell_packed_spmv_c64": out["fem_c64"]["launches"],
                "whell_packed_spmv_f64": out["band_f64"]["launches"]
                + sum(v["launches"] for v in solves.values())}
    return out, launches


def capped_pair(mv, b, maxiter, exact, limit, smi):
    """The graphed CG and its eager witness for exactly ``maxiter``
    iterations (tol 0) on the host clock: ms per iteration and the
    relative residual of each, both at most ``limit``; where ``exact`` (a
    kernel with the same bits every call) the same x bit for bit, else
    residuals within a factor of 2 of each other."""
    import torch

    loop = krylov_loop()
    out, got = dict(card=smi, graph_steps=loop.GRAPH_STEPS), {}
    bn = float(torch.linalg.vector_norm(b))
    for tag, fn in (("graphed", loop.cg), ("eager", loop._cg_eager)):
        counts = loop_counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(mv, b, tol=0.0, maxiter=maxiter)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = loop_counts()
        got[tag] = r
        pre = "" if tag == "graphed" else "eager_"
        out.update({f"{pre}iterations": r.iterations, f"{pre}ms_per_iter": ms / maxiter,
                    f"{pre}relative_residual": float(r.residual_norm) / bn})
        if tag == "graphed":
            out.update(counts)
    g, e = got["graphed"], got["eager"]
    if g.iterations != maxiter or e.iterations != maxiter:
        raise AssertionError(f"capped loop: {g.iterations}/{e.iterations} iterations")
    rg, re_ = out["relative_residual"], out["eager_relative_residual"]
    if not (rg <= limit and re_ <= limit):
        raise AssertionError(f"capped loop: residuals {rg} and {re_} (limit {limit})")
    if exact:
        if not torch.equal(g.x, e.x):
            raise AssertionError("capped loop: graphed and eager x differ")
        out["vs_eager"] = "bit_identical"
    else:
        if not max(rg, re_) <= 2 * min(rg, re_):
            raise AssertionError(f"capped loop: residuals {rg} and {re_} differ")
        out["vs_eager"] = "within_gate"
    return out


def laplace_product(lap32, dt, device):
    """The product of the past-bounds Laplacian ``lap32`` (fp32 values) in
    ``dt`` on the layout WHDIA's converter builds (timed alone):
    ``whdia_phase`` in the layout's r0 mode (#6 in float64; #10 in
    complex128, values ``v + 1j·N(0, 1)``, ``default_rng(12)``), its
    kernel's device time warm and cold and the layout.  Returns the row
    and the op call's launches (counted from 0)."""
    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.convert import coo_to_whdia
    from spgpu_tpu_torch.formats.coo import CooMatrix

    t0 = time.perf_counter()
    n = lap32.n_rows
    name = np.dtype(dt).name
    cplx = np.dtype(dt).kind == "c"
    lap = (with_imag(lap32, 12, dt) if cplx else
           CooMatrix(lap32.rows, lap32.cols, lap32.values.astype(dt), n, n))
    a, convert_s = converted(lambda: coo_to_whdia(lap, device=device))
    x = torch.from_numpy(rand_vector(n, 7, dt)).to(device)
    product = whdia_phase(lap, "pattern" if a.pattern_mode else "slab", device,
                          f"laplace {LARGE['lap']}² {name}", wa=a, convert_s=convert_s)
    row = dict(fixture=f"laplacian_2d({LARGE['lap']}, {LARGE['lap']})"
               + (" + 1j*N(0,1)" if cplx else ""),
               **layout_summary(a, lap, convert_s) | product,
               kernel_device=kernel_cold(lambda: ops.whdia_spmv(a, x), TIMED_KERNELS),
               item_s=time.perf_counter() - t0)
    return row, product["launches"]


def past_bounds_phase(device, smi):
    """Phase 31 (``--large``): systems past each old field of tile_base,
    each product held to its plain version and the golden, with its
    layout, its kernel's device time warm and cold, the plain version's,
    cuSPARSE CSR's and the bound.

    - ``laplacian_2d(3072, 3072)`` (9,437,184 rows, 47,173,632
      nonzeros, 73,728 x pages: past the 65,536 of the old page field)
      in fp32 and float64 through auto-selected ``solve()``
      (auto-selection must name WHDIA: #3, #6), CG to 1e-5 / 1e-10 for
      at most :data:`LARGE` ``lap_maxiter`` iterations: ms per
      iteration, the true relative residual, launches and host reads.
      fp32 must converge with a true residual of at most 1e-4; float64
      stops at ``lap_maxiter`` and must reach 1e-5.  Then on the layout
      WHDIA's converter builds (timed alone) the graphed loop against
      its eager witness for as many iterations (the same bits on #3,
      the same bits on #6); then the product (``whdia_phase``, in the
      layout's r0 mode); then the product in complex128 through #10
      (:func:`laplace_product`).
    - banded-11's generator at 9M rows (pattern mode) through #3;
    - F1's case, the 9M-row float64 tridiagonal, aligned packed (#4),
      every row at 1e-12·max|z| of the golden; the same in fp32 as a
      classic layout (#15);
    - the permutation-coupled matrix at 4.5M rows, scattered windows
      past 2**20 layout groups (#1), against the per-hack plain version
      summed in batches of rows and the tile-pass one in chunks of tiles,
      with the hack pass's checks (:func:`hack_pass_checks`).
    Returns the phase and its main-path launches by kernel: the solves'
    and each checked op call's, each counted from 0."""
    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.convert import coo_to_whdia, coo_to_whell, suggest_format
    from spgpu_tpu_torch.formats.coo import CooMatrix
    from spgpu_tpu_torch.kernels import whdia as kd
    from spgpu_tpu_torch.kernels import whell as kw
    from spgpu_tpu_torch.solvers import solve
    from spgpu_tpu_torch.utils.fixtures import laplacian_2d, random_banded
    from spgpu_tpu_torch.utils.timing import time_interleaved

    out, launches = dict(card=smi), {}
    side, maxiter = LARGE["lap"], LARGE["lap_maxiter"]
    t0 = time.perf_counter()
    lap32 = laplacian_2d(side, side, np.float32).sum_duplicates()
    n = lap32.n_rows
    out["laplace_gen_s"] = time.perf_counter() - t0
    for dt, tol, true_tol in ((np.float32, 1e-5, 1e-4), (np.float64, 1e-10, 1e-5)):
        t0 = time.perf_counter()
        name = np.dtype(dt).name
        lap = CooMatrix(lap32.rows, lap32.cols, lap32.values.astype(dt), n, n)
        picked = suggest_format(lap)
        if picked != "whdia":
            raise AssertionError(f"past_bounds: auto-selection names {picked}, not whdia")
        b = lap.spmv(rand_vector(n, 1, np.float64)).astype(dt)
        attr = COUNTER[name]
        setattr(kd, attr, 0)
        loop_counts(reset=True)
        t1 = time.perf_counter()
        res = solve(lap, b, device=device, tol=tol, maxiter=maxiter)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t1
        counts, solve_launches = loop_counts(), getattr(kd, attr)
        if solve_launches < res.iterations:
            raise AssertionError(f"past_bounds: {solve_launches} launches for "
                                 f"{res.iterations} iterations")
        check_reads("past_bounds laplace", res.iterations, counts)
        rel = true_residual(lap, b, res.x)
        # fp32 converges to tol within maxiter; float64 stops at maxiter
        if not (rel <= true_tol and (bool(res.converged) or dt == np.float64)):
            raise AssertionError(f"past_bounds laplace {name}: converged "
                                 f"{bool(res.converged)}, true residual {rel} "
                                 f"(limit {true_tol})")
        # the layout solve() built: WHDIA's converter, timed alone
        a, convert_s = converted(lambda: coo_to_whdia(lap, device=device))
        if not a.x_pages > OLD_PAGES:
            raise AssertionError(f"past_bounds laplace: {a.x_pages} x pages, not "
                                 "past the 16-bit page field")
        bt = torch.from_numpy(b).to(device)
        pair = capped_pair(lambda v: ops.whdia_spmv(a, v), bt, res.iterations,
                           ("whdia", name) in BIT_REPRODUCIBLE, true_tol, smi)
        x = torch.from_numpy(rand_vector(n, 7, dt)).to(device)
        product = whdia_phase(lap, "pattern" if a.pattern_mode else "slab", device,
                              f"past_bounds laplace {name}", wa=a, convert_s=convert_s)
        out[f"laplace_{name}"] = dict(
            fixture=f"laplacian_2d({side}, {side})", fmt="whdia (auto)",
            **layout_summary(a, lap, convert_s) | product,
            solve=dict(tol=tol, maxiter=maxiter, iterations=res.iterations,
                       converged=bool(res.converged), solve_total_s=solve_s,
                       ms_per_iter_with_setup=1e3 * solve_s / max(res.iterations, 1),
                       true_relative_residual=rel, true_residual_limit=true_tol,
                       launches=solve_launches, **counts, loop=pair),
            kernel_device=kernel_cold(lambda: ops.whdia_spmv(a, x), TIMED_KERNELS),
            item_s=time.perf_counter() - t0)
        key = "whdia_spmv" if dt == np.float32 else "whdia_spmv_f64"
        launches[key] = launches.get(key, 0) + solve_launches + product["launches"]
        del a, x, bt, lap
        torch.cuda.empty_cache()
    out["laplace_complex128"], launches["whdia_spmv_c128"] = laplace_product(
        lap32, np.complex128, device)
    del lap32
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    band = random_banded(LARGE["band"], 11, wander=7, seed=2, dtype=np.float32)
    a, convert_s = converted(lambda: coo_to_whdia(band, device=device))
    x = torch.from_numpy(rand_vector(band.n_cols, 7, np.float32)).to(device)
    product = whdia_phase(band, "pattern", device, "past_bounds banded11 9M", wa=a,
                          convert_s=convert_s)
    out["banded11_9m"] = dict(
        fixture="random_banded(9M, 11, wander=7, seed=2)",
        **layout_summary(a, band, convert_s) | product,
        kernel_device=kernel_cold(lambda: ops.whdia_spmv(a, x), TIMED_KERNELS),
        item_s=time.perf_counter() - t0)
    launches["whdia_spmv"] += product["launches"]
    del a, x, band
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tri = tridiagonal(LARGE["tri"], np.float64)
    a, convert_s = converted(lambda: coo_to_whell(tri, device=device, scattered=False))
    xl = a.embed(torch.from_numpy(rand_vector(tri.n_cols, 7, np.float64)),
                 dtype=torch.float64)
    product = spmv_phase(tri, a, device, "F1 float64")
    out["tridiagonal_f64_aligned"] = dict(
        fixture="tridiagonal(9M), float64, scattered=False (F1)",
        **layout_summary(a, tri, convert_s) | product,
        kernel_device=kernel_cold(lambda: ops.whell_spmv(a, xl), ("whell_",)),
        item_s=time.perf_counter() - t0)
    launches["whell_packed_spmv_f64"] = product["launches"]
    del a, xl
    tri32 = CooMatrix(tri.rows, tri.cols, tri.values.astype(np.float32), tri.n_rows,
                      tri.n_cols)
    del tri
    t0 = time.perf_counter()
    a, convert_s = converted(lambda: coo_to_whell(tri32, device=device, packed=False))
    x = torch.from_numpy(rand_vector(tri32.n_cols, 7, np.float32)).to(device)
    product = classic_phase(tri32, a, device, "F1 classic")
    out["tridiagonal_fp32_classic"] = dict(
        fixture="tridiagonal(9M), fp32, packed=False",
        **layout_summary(a, tri32, convert_s) | product,
        kernel_device=kernel_cold(lambda: ops.whell_spmv(a, x), ("classic_spmv",)),
        item_s=time.perf_counter() - t0)
    launches["whell_classic_spmv"] = product["launches"]
    del a, x, tri32
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    perm = permutation_coupled(LARGE["perm"])
    a, convert_s = converted(lambda: coo_to_whell(perm, device=device))
    summary = layout_summary(a, perm, convert_s)
    if not summary["layout_groups"] > OLD_GROUPS:
        raise AssertionError(f"past_bounds: {summary['layout_groups']} groups, not "
                             "past 2**20")
    xh = rand_vector(perm.n_cols, 7, np.float32)
    xl = a.embed(torch.from_numpy(xh), dtype=torch.float32)
    x2 = ops._prep_x(xl, a.n_cols, a.x_pages)
    kw.LAUNCHES = 0
    z = ops.whell_spmv(a, xl)
    torch.cuda.synchronize()
    perm_launches = kw.LAUNCHES
    if perm_launches != 1:
        raise AssertionError(f"past_bounds permutation: whell_spmv launched #1 "
                             f"{perm_launches} times")
    zp = chunked_hack_plain(a, x2).reshape(-1)[: a.n_rows]
    err_plain = check_close(z, zp, 1e-5, 1e-5, "permutation: kernel vs plain")
    # the JAX kernels' tile pass, every tile added into its hack row
    err_tiles = check_close(z, chunked_plain(a, x2).reshape(-1)[: a.n_rows], 1e-5,
                            1e-5, "permutation: kernel vs the tile-pass plain")
    golden = perm.spmv(xh.astype(np.float64))
    err_golden = check_close(a.extract(z, dtype=torch.float64).cpu().numpy(), golden,
                             1e-4, 1e-4, "permutation: kernel vs golden")
    fn = lambda: ops.whell_spmv(a, xl)  # noqa: E731
    static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                  window_pages=a.window_pages, unit_segments=a.unit_segments,
                  hack_units=a.hack_units, tile_page=a.tile_page)
    checks = hack_pass_checks(lambda: kw.whell_packed_spmv(
        a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group, a.group_bases,
        a.seg_lo, a.seg_hi, x2, **static), a, torch.float32, device, "permutation")
    t = time_interleaved({"kernel": fn, "plain": lambda: chunked_hack_plain(a, x2)},
                         reps=2, iters=2, warmup=1)
    out["permutation_scattered"] = dict(
        fixture=f"row i couples to i and pi(i), {LARGE['perm']} rows, fp32", **summary,
        launches=perm_launches, **checks,
        max_abs_err_vs_plain=err_plain, max_abs_err_vs_tile_plain=err_tiles,
        max_abs_err_vs_golden=err_golden,
        kernel_ms=t["kernel"]["best_ms"], plain_ms=t["plain"]["best_ms"],
        kernel_device=kernel_cold(fn, ("whell_",)),
        library=library_times(perm, torch.from_numpy(xh).to(device), device),
        **whell_bounds(a, x2, z, 2 * perm.nnz, "float32"),
        item_s=time.perf_counter() - t0)
    launches["whell_packed_spmv"] = perm_launches
    return out, launches


def large_phases(device, smi):
    """Phases 30 and 31 in this process (``--large``), each with its
    main-path launches by kernel (``launches``: the checked op calls and
    the solves', counted from 0; the timing calls are not counted)."""
    for phase, fn in (("large", large_phase), ("past_bounds", past_bounds_phase)):
        res, launches = fn(device, smi)
        yield phase, dict(res, launches=launches)



#: the distributed phases' sizes: the shard counts of the flagship's
#: partitions (classic: the first), the weak-scaling fixture's rows a
#: shard and shard counts (``spgpu_tpu/bench/harness.py:332-372``), and the
#: float64 Laplacian's side
DIST = dict(shards=(4, 8), plan_rows=65536, plan_shards=(1, 2, 4, 8), lap=1024)

#: the kernels a distributed product launches: name -> (kernel module,
#: launch counter)
DIST_KERNELS = {"whell_packed_spmv": ("whell", "LAUNCHES"),
                "whell_packed_spmv_f64": ("whell", "LAUNCHES_F64"),
                "whell_packed_spmv_c64": ("whell", "LAUNCHES_C64"),
                "whell_packed_spmv_c128": ("whell", "LAUNCHES_C128"),
                "whell_classic_spmv": ("whell_classic", "LAUNCHES")}

#: what every distributed phase says of the ranks it ran
ONE_CARD = ("world size 1 only: this host has one card, and NCCL runs no "
            "two ranks on one card; no multi-card run was possible")


def kernel_counts(table: dict, reset=False) -> dict:
    """The launch counters of ``table`` (kernel name -> (kernel module,
    counter)) by kernel name (set to 0 first with ``reset``)."""
    import importlib

    out = {}
    for name, (mod, attr) in table.items():
        m = importlib.import_module(f"spgpu_tpu_torch.kernels.{mod}")
        if reset:
            setattr(m, attr, 0)
        out[name] = getattr(m, attr)
    return out


def dist_counts(reset=False) -> dict:
    """The launch counters of :data:`DIST_KERNELS` by kernel name (set to
    0 first with ``reset``)."""
    return kernel_counts(DIST_KERNELS, reset)


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def counted(fn, launches: dict, table=None):
    """``fn()`` with the counters of ``table`` (default
    :data:`DIST_KERNELS`) set to 0 just before and read just after (a
    synchronise between), added into ``launches``; returns ``fn``'s result
    and the counts."""
    import torch

    table = DIST_KERNELS if table is None else table
    kernel_counts(table, reset=True)
    out = fn()
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernel_counts(table).items() if v}
    add_counts(launches, counts)
    return out, counts


def dist_local_phase(device, smi):
    """Phase 32 (``--dist``): each shard's product on the card, its halo
    taken by the plan from the global x (``parallel.dist_spmv._PlannedHalo``:
    the schedule of a rank, the exchange's values from the plan instead of
    from peers).  The SPD flagship (the ``solve`` phase's system) in
    4- and 8-shard packed partitions, fp32 (#1) and float64 (#4), and the
    relabelled flagship of the ``classic`` phase in a 4-shard classic
    partition (#15), and the SPD flagship in a 4-shard HELL partition
    (``partition_coo_rows``, plain torch products: no kernel).  Each
    shard's rows held to the golden (fp32 2e-5, float64 1e-12, times
    max|z|), its kernels' launches counted (one for the interior, one for
    the exterior where it has one; none on HELL), and the same schedule
    captured in a CUDA graph (:func:`graphed_product`: bit for bit where
    the products give the same bits every call, the packed partitions'
    #1 and #4 and HELL's ordered sums; within 1e-5 of max|z| on the
    classic one, #15's atomics); per shard the interior and exterior
    products' device µs, the halo lanes it receives and sends and their
    bytes."""
    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.convert import local_degree_perm, symmetric_relabel
    from spgpu_tpu_torch.parallel import (partition_coo_rows, partition_coo_rows_packed,
                                          partition_coo_rows_whell)
    from spgpu_tpu_torch.parallel.dist_spmv import _PlannedHalo as PlannedHalo
    from spgpu_tpu_torch.utils.timing import device_ms

    out, launches = dict(card=smi, ranks=ONE_CARD), {}
    raw = flagship()
    spd = spd_from(raw)
    # (tag, system, partition, shard counts, tolerance, graphed product
    # bit for bit)
    systems = [("fp32", spd, partition_coo_rows_packed, DIST["shards"], 2e-5, True),
               ("float64", spd_from(flagship(np.float64), np.float64),
                partition_coo_rows_packed, DIST["shards"], 1e-12, True),
               ("classic_fp32", symmetric_relabel(raw, local_degree_perm(raw)),
                partition_coo_rows_whell, DIST["shards"][:1], 2e-5, False),
               ("hell_fp32", spd, partition_coo_rows, DIST["shards"][:1], 2e-5,
                ("hell", "float32") in BIT_REPRODUCIBLE)]
    for tag, coo, make, shard_counts, tol, exact in systems:
        hell = make is partition_coo_rows
        dt = coo.values.dtype
        x = rand_vector(coo.n_rows, 7, dt)
        g = coo.spmv(x.astype(wide(dt)))
        for S in shard_counts:
            t0 = time.perf_counter()
            pm = make(coo, S)
            build_s = time.perf_counter() - t0
            per_shard = []
            for s in range(S):
                h = PlannedHalo(pm, s, device)
                xl = h.set_x(x)
                z, counts = counted(lambda: h.matvec(xl), launches)
                want = 0 if hell else 1 + (h.exterior is not None)
                if sum(counts.values()) != want:
                    raise AssertionError(f"dist_local {tag} S={S} shard {s}: launches "
                                         f"{counts}, not {want}")
                err = check_close(pm.extract_shard(z, s), g[pm.rows_of(s)], 0.0, tol,
                                  f"dist_local {tag} S={S} shard {s}")
                graph = graphed_product(h, xl, rand_vector(coo.n_rows, 8 + s, dt),
                                        exact, f"dist_local {tag} S={S} shard {s}")
                item = torch.empty((), dtype=pm.dtype).element_size()
                ext = h.exterior
                if hell:  # HELL slabs: slots of 128 lanes, no tiles or groups
                    sizes = dict(interior_slots=h.interior.total_slots,
                                 exterior_slots=None if ext is None else ext.total_slots)
                else:
                    sizes = dict(interior_tiles=h.interior.num_tiles,
                                 exterior_tiles=None if ext is None else ext.num_tiles,
                                 exterior_groups=None if ext is None else ext.num_groups,
                                 interior_groups=h.interior.num_groups)
                per_shard.append(dict(
                    shard=s, rows=pm.shards[s].n_local, vector=h.n, **sizes,
                    halo_lanes_in=h.recv.numel(),
                    halo_lanes_out=sum(i.numel() for _, i in h.sends),
                    bytes_in=h.recv.numel() * item,
                    bytes_out=sum(i.numel() for _, i in h.sends) * item,
                    launches=counts, max_abs_err=err, graph=graph,
                    interior_device_us=1e3 * device_ms(
                        lambda: ops.spmv(h.interior, xl), iters=10)[0],
                    exterior_device_us=None if ext is None else 1e3 * device_ms(
                        lambda: ops.spmv(ext, h.work), iters=10)[0],
                    product_device_us=1e3 * device_ms(lambda: h.matvec(xl), iters=10)[0]))
                del h, z
            out[f"{tag}_S{S}"] = dict(
                rows=coo.n_rows, nnz=coo.nnz, shards=S, chunk=pm.chunk,
                halo_width=pm.halo_width, build_s=build_s,
                halo_lanes=sum(map(sum, pm.halo_counts)),
                halo_bytes=sum(r["bytes_out"] for r in per_shard),
                live_pairs=sum(c > 0 for row in pm.halo_counts for c in row),
                per_shard=per_shard)
            del pm
            torch.cuda.empty_cache()
    return out, launches


def graphed_product(h, xl, x2, exact: bool, what: str):
    """The planned-halo product ``h.matvec(xl)`` captured in one CUDA graph
    (the side stream's fork and join, the send gathers, the workspace, both
    kernels), replayed on ``x2`` copied into the captured block and halo,
    and held to the eager product of ``x2``: bit for bit where ``exact``
    (a kernel that gives the same bits every call), else within 1e-5 of
    max|z|.  Returns ``"bit_identical"`` or the largest relative gap."""
    import torch

    if xl.device.type != "cuda":  # a CPU rehearsal of the phase
        return "not captured on the CPU"
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        z = h.matvec(xl)
    xl.copy_(h.set_x(x2))
    graph.replay()
    torch.cuda.synchronize()
    want = h.matvec(h.set_x(x2))
    gap = float((z - want).abs().max() / want.abs().max())
    del graph
    if (exact and not torch.equal(z, want)) or gap > 1e-5:
        raise AssertionError(f"{what}: the graphed product differs from the eager "
                             f"one by {gap} of max|z|")
    return "bit_identical" if torch.equal(z, want) else gap


def dist_loop(h, b, tol, maxiter, launches):
    """Two graphed distributed solves on the handle ``h`` (the first
    loads what the step reaches; host ms of each to a synchronise,
    launches counted) and a profiled window of
    :data:`PROFILED_ITERATIONS` steps: device ms per step, the
    ``all_reduce``s' device µs per step (the device operations NCCL's
    ``all_reduce`` issues inside the graph; an in-place one on one rank
    issues none) and the idle share of the second solve."""
    import torch

    from spgpu_tpu_torch.utils.timing import device_ms_by_kernel

    loop = krylov_loop()
    runs = {}
    for call in ("cold", "warm"):
        loop_counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r, counts = counted(lambda: h.solve(b, tol=tol, maxiter=maxiter), launches)
        host_ms = 1e3 * (time.perf_counter() - t0)
        runs[call] = dict(iterations=r.iterations, converged=bool(r.converged),
                          host_ms=host_ms, ms_per_iter=host_ms / max(r.iterations, 1),
                          launches=counts, **loop_counts())
    run = dict(runs["warm"], cold=runs["cold"])
    steps = run["device_steps"]
    loop_counts(reset=True)
    by_kernel = device_ms_by_kernel(
        lambda: h.solve(b, tol=0.0, maxiter=PROFILED_ITERATIONS), iters=1, warmup=0,
        attempts=3)
    prof_steps = max(loop.STEPS, 1)
    if by_kernel:
        per_step = sum(by_kernel.values()) / prof_steps
        reduce_ops = sorted(k for k in by_kernel
                            if "allreduce" in re.sub(r"[^a-z]", "", k.lower()))
        run.update(device_ms_per_step=per_step,
                   allreduce_device_us_per_step=1e3 * sum(
                       by_kernel[k] for k in reduce_ops) / prof_steps,
                   allreduce_ops=reduce_ops,
                   device_idle_share=1 - per_step * steps / run["host_ms"],
                   device_ms_per_step_by_kernel={
                       k: v / prof_steps for k, v in sorted(
                           by_kernel.items(), key=lambda kv: -kv[1])[:8]})
    else:
        run.update(device_ms_per_step=None, allreduce_device_us_per_step=None,
                   device_idle_share=None, device_source="no usable profiling session")
    return r, run


def dist_solve_phase(device, smi, rg):
    """Phase 33 (``--dist``): ``dist_cg`` at world size 1 (an NCCL group
    of one rank, the step's ``all_reduce``s captured in the loop's CUDA
    graph) on the SPD flagship in fp32 (#1), float64 (#4), complex64 (#7)
    and complex128 (its values ``v + 1j·N(0, 1)`` as ``solve_complex``
    builds them), on the float64 1024² Laplacian through packed WHELL
    (#4), and on the SPD fp32 flagship in a HELL partition (plain torch
    products).  Each beside the single-device ``cg`` on the same layout
    (the handle's): the same iterations and x bit for bit where the
    product gives the same bits every call (:data:`BIT_REPRODUCIBLE`),
    else within max(1, 10 %); the float64 solves also
    beside their eager witness (``eager=True``), bit for bit.  Each prints
    iterations, host ms per iteration of a first and a second solve (the
    handle's embed of ``b``, capture and gather of ``x`` included), device
    ms per step, the ``all_reduce``s' device µs per step, the idle share
    and the true residual."""
    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.parallel import (DistSolveHandle, partition_coo_rows,
                                          partition_coo_rows_packed)
    from spgpu_tpu_torch.utils.fixtures import laplacian_2d

    loop = krylov_loop()
    out, launches = dict(card=smi, ranks=ONE_CARD, graph_steps=loop.GRAPH_STEPS), {}
    coo64 = flagship(np.float64)
    spd32 = spd_from(flagship())
    packed = ("whell", partition_coo_rows_packed)
    systems = [("flagship_fp32", spd32, 1e-5, 1e-4, packed),
               ("flagship_float64", spd_from(coo64, np.float64), 1e-10, 1e-9, packed),
               ("flagship_complex64", spd_from(with_imag(coo64, 8, np.complex64),
                                               np.complex64), 1e-5, 1e-4, packed),
               ("flagship_complex128", spd_from(with_imag(coo64, 8, np.complex128),
                                                np.complex128), 1e-10, 1e-9, packed),
               (f"laplace{DIST['lap']}_float64",
                laplacian_2d(DIST["lap"], DIST["lap"], np.float64), 1e-10, 1e-9, packed),
               ("flagship_hell_fp32", spd32, 1e-5, 1e-4, ("hell", partition_coo_rows))]
    for tag, coo, tol, true_tol, (route, make) in systems:
        t0 = time.perf_counter()
        dt = coo.values.dtype
        x_true = rand_vector(coo.n_rows, 1, wide(dt))
        b = coo.spmv(x_true).astype(dt)
        h = DistSolveHandle(make(coo, 1), rg)
        r, run = dist_loop(h, b, tol, 20000, launches)
        if not run["converged"]:
            raise AssertionError(f"dist_solve {tag}: did not converge")
        run["true_residual"] = true_residual(coo, b, r.x)
        if not run["true_residual"] <= true_tol:
            raise AssertionError(f"dist_solve {tag}: true residual "
                                 f"{run['true_residual']} > {true_tol}")
        a = h.op.interior
        b_l = h.op.embed(b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        # the comparisons (single-device and eager) are not the main path:
        # their launches are shown beside them and kept out of ``launches``
        one, counts = counted(lambda: loop.cg(lambda v: ops.spmv(a, v), b_l,
                                              tol=tol, maxiter=20000), {})
        single_ms = 1e3 * (time.perf_counter() - t1)
        x_one = h.pm.extract_shard(one.x, 0)
        exact = (route, np.dtype(dt).name) in BIT_REPRODUCIBLE
        if exact:
            if one.iterations != r.iterations or not torch.equal(x_one, r.x):
                raise AssertionError(f"dist_solve {tag}: {r.iterations} iterations, "
                                     f"single-device {one.iterations}, or x differs")
        elif abs(one.iterations - r.iterations) > max(1, one.iterations // 10):
            raise AssertionError(f"dist_solve {tag}: {r.iterations} iterations, "
                                 f"single-device {one.iterations}")
        run["single_device"] = dict(iterations=one.iterations, host_ms=single_ms,
                                    ms_per_iter=single_ms / max(one.iterations, 1),
                                    launches=counts,
                                    vs_dist="bit_identical" if exact else "within_gate")
        if dt == np.float64:
            e, counts = counted(lambda: h.solve(b, tol=tol, maxiter=20000, eager=True),
                                {})
            if e.iterations != r.iterations or not torch.equal(e.x, r.x):
                raise AssertionError(f"dist_solve {tag}: eager {e.iterations} "
                                     f"iterations, graphed {r.iterations}, or x differs")
            run["vs_eager"] = "bit_identical"
            run["eager_launches"] = counts
        out[tag] = dict(rows=coo.n_rows, nnz=coo.nnz, tol=tol, placements=h.placements,
                        item_s=time.perf_counter() - t0, **run)
        del h, a, b_l, one
        torch.cuda.empty_cache()
    return out, launches


def dist_plan_phase(device, smi, rg):
    """Phase 34 (``--dist``): the JAX weak-scaling fixture
    (``random_banded(65536·S, 11, wander=3, seed=2)``, duplicates summed,
    ``spgpu_tpu/bench/harness.py:332-372``) for S = 1, 2, 4 and 8: the
    host plan of its S-shard packed partition (halo lanes and bytes of
    each live pair, seconds to build), and the matrix's product on the
    card at world size 1 (``dist_spmv``'s handle, #1; device and per-call
    ms, held to the golden).  Ranks above 1 were not run."""
    import torch

    from spgpu_tpu_torch.parallel import ShardedHandle, partition_coo_rows_packed
    from spgpu_tpu_torch.utils.fixtures import random_banded
    from spgpu_tpu_torch.utils.timing import device_ms, time_interleaved

    out, launches = dict(card=smi), {}
    for S in DIST["plan_shards"]:
        n = DIST["plan_rows"] * S
        coo = random_banded(n, 11, wander=3, seed=2, dtype=np.float32).sum_duplicates()
        t0 = time.perf_counter()
        pm = partition_coo_rows_packed(coo, S)
        build_s = time.perf_counter() - t0
        pairs = {f"{p}->{s}": dict(lanes=c, bytes=4 * c)
                 for p, row in enumerate(pm.halo_counts) for s, c in enumerate(row) if c}
        h = ShardedHandle(partition_coo_rows_packed(coo, 1), rg)
        x = rand_vector(n, 7, np.float32)
        xl = h.embed(x)
        z, counts = counted(lambda: h.matvec(xl), launches)
        err = check_close(h.extract(z), coo.spmv(x.astype(np.float64)), 0.0, 2e-5,
                          f"dist_plan S={S}")
        dev, src = device_ms(lambda: h.matvec(xl))
        per_call = time_interleaved({"matvec": lambda: h.matvec(xl)})["matvec"]["best_ms"]
        out[f"S{S}"] = dict(
            rows=n, nnz=coo.nnz, shards=S, build_s=build_s, halo_width=pm.halo_width,
            halo_lanes=sum(p["lanes"] for p in pairs.values()),
            halo_bytes=sum(p["bytes"] for p in pairs.values()), pairs=pairs,
            world1_device_ms=dev, world1_device_source=src, world1_per_call_ms=per_call,
            world1_launches=counts, max_abs_err=err,
            ranks=f"the plan only for S > 1: {ONE_CARD}")
        del h, pm
        torch.cuda.empty_cache()
    return out, launches


def dist_phases(device, smi):
    """Phases 32-34 in this process (``--dist``), the last two in an NCCL
    group of one rank that this process opens and destroys; each with its
    main-path launches by kernel (counted from 0 around each checked
    product and graphed ``dist_cg`` solve; timing calls and the
    single-device and eager comparisons are not counted)."""
    import tempfile

    from spgpu_tpu_torch.parallel import destroy_rank_group, init_rank_group

    res, launches = dist_local_phase(device, smi)
    yield "dist_local", dict(res, launches=launches)
    with tempfile.TemporaryDirectory() as d:
        rg = init_rank_group(os.path.join(d, "store"), 0, 1, device)
        try:
            for phase, fn in (("dist_solve", dist_solve_phase),
                              ("dist_plan", dist_plan_phase)):
                res, launches = fn(device, smi, rg)
                yield phase, dict(res, launches=launches)
        finally:
            destroy_rank_group()


# --------------------------------------------------------------------------
# the classic surface (``--classic``): the classic layouts' plain products,
# the hybrid split and the hybrid and hell solve() routes

#: the mixed fixture's rows (DESIGN §2i's "mixed banded-11+overlay 524k")
#: and its other arguments, the JAX ``random_mixed`` defaults
MIXED = dict(n=2 ** 19, bands=11, wander=3, extra_avg=4.0, span=768, far_frac=0.02,
             seed=0)

#: the kernels the classic phases launch (the hybrid's): name -> (kernel
#: module, launch counter)
CLASSIC_KERNELS = {"whell_packed_spmv": ("whell", "LAUNCHES"),
                   "whell_packed_spmv_f64": ("whell", "LAUNCHES_F64"),
                   "whdia_spmv": ("whdia", "LAUNCHES"),
                   "whdia_spmv_f64": ("whdia", "LAUNCHES_F64")}

#: the products of phase 35: (fixture, value types, layouts).  DIA runs
#: on banded-11's contiguous form: the wandering band holds 27,192
#: diagonals, a DIA slab of 27,192 x 524,288 cells (57 GB in float32)
CLASSIC_PRODUCTS = (("flagship", ("float32", "float64"), ("ell", "oell", "hell")),
                    ("laplace", ("float32", "float64", "complex64", "complex128"),
                     ("dia", "hdia", "bcoo")),
                    ("banded11", ("float32", "float64"), ("hdia",)),
                    ("banded11_contiguous", ("float32", "float64"), ("dia",)))


def mixed(dtype=np.float64):
    from spgpu_tpu_torch.utils.fixtures import random_mixed

    return random_mixed(MIXED["n"], **{k: v for k, v in MIXED.items() if k != "n"},
                        dtype=dtype)


def op_vs_library(fn, coo, x, device, **more):
    """:func:`timed` of ``fn`` (``op_*``) and of any ``more`` calls beside
    the library call (cuSPARSE CSR in x's type) on the same x."""
    library, refused = library_call(coo, x, device)
    return timed(None, None, library, refused, op=fn, **more)


def classic_product(coo, fmt, device, label):
    """One classic layout of ``coo`` built on the card and its product
    through ``ops.spmv`` with alpha 1.7 and beta -0.3 on CUDA tensors: the
    result must lie on the card and be at the host golden (float32 and
    complex64 1e-4·max|z|, float64 and complex128 1e-12·max|z|); the
    converter's seconds, the layout's bytes, the op's per-call and device
    ms beside cuSPARSE CSR's."""
    import torch

    from spgpu_tpu_torch import convert, ops

    conv = {"ell": lambda: convert.coo_to_ell(coo, device=device),
            "oell": lambda: convert.ell_to_oell(convert.coo_to_ell(coo, device=device),
                                                device=device),
            "hell": lambda: convert.coo_to_hell(coo, device=device),
            "dia": lambda: convert.coo_to_dia(coo, device=device),
            "hdia": lambda: convert.coo_to_hdia(coo, device=device),
            "bcoo": lambda: convert.coo_to_bcoo(coo, 8, 8, device=device)}[fmt]
    dt = coo.values.dtype
    t0 = time.perf_counter()
    a = conv()
    torch.cuda.synchronize(device)
    convert_s = time.perf_counter() - t0
    x, y = rand_vector(coo.n_cols, 7, dt), rand_vector(coo.n_rows, 9, dt)
    xt, yt = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    call = lambda: ops.spmv(a, xt, 1.7, -0.3, yt)  # noqa: E731
    z = call()
    if z.device.type != device.type or a.device.type != device.type:
        raise AssertionError(f"{label}: the product left the card ({z.device})")
    g = 1.7 * coo.spmv(x.astype(wide(dt))) - 0.3 * y.astype(wide(dt))
    frac = 1e-4 if dt in (np.float32, np.complex64) else 1e-12
    err = check_close(z, g, 0.0, frac, f"{label}: vs host golden")
    times = op_vs_library(call, coo, xt, device)
    return dict(convert_s=convert_s, storage_bytes=a.storage_bytes, nnz=coo.nnz,
                max_abs_err_vs_golden=err, on_device=z.device.type, **times,
                item_s=time.perf_counter() - t0)


def classic_csput(coo, device):
    """``ell_csput`` and ``hell_csput`` of 1,000 stored coordinates (alpha
    2) on the card, the new values equal bit for bit to the same update
    on the host."""
    import torch

    from spgpu_tpu_torch import convert, ops

    sel = np.random.default_rng(3).choice(coo.nnz, size=1000, replace=False)
    v = rand_vector(1000, 4, coo.values.dtype)
    out = {}
    for fmt, conv, put in (("ell", convert.coo_to_ell, ops.ell_csput),
                           ("hell", convert.coo_to_hell, ops.hell_csput)):
        a = conv(coo, device=device)
        t0 = time.perf_counter()
        got = put(a, coo.rows[sel], coo.cols[sel], v, alpha=2.0)
        torch.cuda.synchronize(device)
        ms = 1e3 * (time.perf_counter() - t0)
        want = put(a.to("cpu"), coo.rows[sel], coo.cols[sel], v, alpha=2.0)
        if got.values.device.type != device.type or not torch.equal(got.values.cpu(),
                                                                     want.values):
            raise AssertionError(f"classic_formats {fmt}_csput: the card's values "
                                 "differ from the host's")
        out[f"{fmt}_csput"] = dict(updates=1000, host_ms=ms, vs_host="bit_identical")
    return out


def classic_formats_phase(device, smi):
    """Phase 35 (``--classic``): the classic layouts through ``ops.spmv``
    on CUDA tensors (plain torch on the card), each checked and timed by
    :func:`classic_product`: ELL, OELL and HELL on the flagship, DIA and
    HDIA on the 1024² Laplacian, HDIA on banded-11 and DIA on its
    contiguous form (:data:`CLASSIC_PRODUCTS`), BCOO (8x8 blocks) on the
    Laplacian; float32 and float64 on every fixture, complex64 and
    complex128 on the Laplacian (``+ 1j·N(0, 1)``, ``default_rng(12)``);
    then csput on the card against the host."""
    from spgpu_tpu_torch.formats.coo import CooMatrix
    from spgpu_tpu_torch.utils.fixtures import laplacian_2d, random_banded

    n = SIZES["lap"]
    base = {"flagship": flagship(np.float64), "laplace": laplacian_2d(n, n, np.float64),
            "banded11": random_banded(SIZES["band"], 11, wander=7, seed=2,
                                      dtype=np.float64),
            "banded11_contiguous": random_banded(SIZES["band"], 11, wander=0, seed=2,
                                                 dtype=np.float64)}
    out = dict(card=smi, fixtures={
        "flagship": f"random_fem_like({SIZES['flagship']}, 27.0, span=768, "
                    "far_frac=0.01, seed=0)",
        "laplace": f"laplacian_2d({n}, {n}); complex: + 1j*N(0,1), default_rng(12)",
        "banded11": f"random_banded({SIZES['band']}, 11, wander=7, seed=2)",
        "banded11_contiguous": f"random_banded({SIZES['band']}, 11, wander=0, seed=2)"})
    for fix, types, fmts in CLASSIC_PRODUCTS:
        c = base[fix]
        for name in types:
            coo = (with_imag(c, 12, name) if name.startswith("complex") else
                   CooMatrix(c.rows, c.cols, c.values.astype(name), c.n_rows, c.n_cols))
            for fmt in fmts:
                out[f"{fix}_{fmt}_{name}"] = classic_product(
                    coo, fmt, device, f"classic_formats {fix} {fmt} {name}")
    out.update(classic_csput(flagship(), device))
    return out, {}


def hybrid_phase(device, smi):
    """Phase 36 (``--classic``): the mixed fixture (:data:`MIXED`) in the
    hybrid split, fp32 and float64: ``tau_lanes``, the band fraction and
    each part's padding; one ``hybrid_spmv`` (alpha 1.7, beta -0.3),
    counted from 0, must launch the WHDIA kernel (#3, #6) once and the
    packed WHELL kernel (#1, #4) once, be at the golden (1e-4·max|z|,
    float64 1e-12) and give the same bits twice; the device ms of the whole
    op, of each kernel and of the crossing (every other device operation:
    the index copy into lane space, its zero fill, the gather back and the
    sum); and beside them, on the same matrix, pure packed WHELL (#1/#4),
    pure WHDIA (#3/#6) and cuSPARSE CSR."""
    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.convert import coo_to_hybrid, coo_to_whdia, coo_to_whell
    from spgpu_tpu_torch.formats.coo import CooMatrix
    from spgpu_tpu_torch.formats.hybrid import layout_bytes
    from spgpu_tpu_torch.utils.timing import device_ms_by_kernel

    out, launches = dict(card=smi, fixture=f"random_mixed({MIXED})"), {}
    m64 = mixed()
    for name in ("float32", "float64"):
        coo = CooMatrix(m64.rows, m64.cols, m64.values.astype(name), m64.n_rows,
                        m64.n_cols)
        t0 = time.perf_counter()
        h = coo_to_hybrid(coo, device=device)
        torch.cuda.synchronize(device)
        convert_s = time.perf_counter() - t0
        x, y = rand_vector(coo.n_cols, 7, name), rand_vector(coo.n_rows, 9, name)
        xt, yt = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
        call = lambda: ops.hybrid_spmv(h, xt, 1.7, -0.3, yt)  # noqa: E731
        z, counts = counted(call, launches, CLASSIC_KERNELS)
        sfx = "" if name == "float32" else "_f64"
        if counts != {f"whdia_spmv{sfx}": 1, f"whell_packed_spmv{sfx}": 1}:
            raise AssertionError(f"hybrid {name}: one product launched {counts}")
        if not torch.equal(call(), z):
            raise AssertionError(f"hybrid {name}: two products differ")
        g = 1.7 * coo.spmv(x.astype(np.float64)) - 0.3 * y.astype(np.float64)
        err = check_close(z, g, 0.0, 1e-4 if name == "float32" else 1e-12,
                          f"hybrid {name}: vs host golden")
        by_op = device_ms_by_kernel(lambda: ops.hybrid_spmv(h, xt))
        band_ms = sum(v for k, v in by_op.items() if k.startswith("whdia_spmv_warps"))
        rest_ms = sum(v for k, v in by_op.items() if k.startswith("whell_hack_pass"))
        # the whole matrix on each single layout, and the library
        t1 = time.perf_counter()
        aw = coo_to_whell(coo, device=device)
        ad = coo_to_whdia(coo, device=device)
        torch.cuda.synchronize(device)
        single_convert_s = time.perf_counter() - t1
        xl = aw.embed(torch.from_numpy(x), dtype=getattr(torch, name))
        t = op_vs_library(lambda: ops.hybrid_spmv(h, xt), coo, xt, device,
                          whell=lambda: ops.whell_spmv(aw, xl),
                          whdia=lambda: ops.whdia_spmv(ad, xt))
        rest_nnz = h.nnz - h.band_nnz
        out[name] = dict(
            rows=coo.n_rows, nnz=coo.nnz, convert_s=convert_s, tau_lanes=h.tau_lanes,
            band_nnz=h.band_nnz, band_frac=h.band_nnz / h.nnz,
            band_padding=h.band.values.numel() / max(h.band_nnz, 1),
            rest_padding=h.rest.total_slots * 128 / max(rest_nnz, 1),
            pad_factor=h.pad_factor, storage_bytes=h.storage_bytes,
            whell_storage_bytes=layout_bytes(aw), whdia_storage_bytes=layout_bytes(ad),
            whell_padding=aw.total_slots * 128 / coo.nnz,
            whdia_padding=ad.values.numel() / coo.nnz, single_convert_s=single_convert_s,
            launches=counts, bit_identical=True, max_abs_err_vs_golden=err,
            device_ms_by_op=by_op, band_kernel_device_ms=band_ms,
            rest_kernel_device_ms=rest_ms,
            crossing_device_ms=sum(by_op.values()) - band_ms - rest_ms if by_op else None,
            **t)
        del h, aw, ad
        torch.cuda.empty_cache()
    return out, launches


def solve_classic_phase(device, smi):
    """Phase 37 (``--classic``): ``solve(fmt="hybrid")`` on the SPD form
    of the mixed fixture (fp32 to 1e-5, true residual ≤ 1e-4; float64 to
    1e-10, ≤ 1e-9), each kernel's launches (#3 and #1, #6 and #4)
    covering the iterations, then the graphed loop beside its eager
    witness, bit for bit; ``solve(fmt="hell")`` on the SPD flagship in fp32
    and float64 and on its Hermitian complex64 form, each within
    max(1, 10 %) of the whell route's iterations on the same system, at
    the true-residual gate, and its graphed loop beside the eager one
    (bit for bit where :data:`BIT_REPRODUCIBLE` holds it).  Each prints
    ms per iteration, device ms per step and the idle share
    (:func:`loop_pair`)."""
    import torch

    from spgpu_tpu_torch.convert import coo_to_hell, coo_to_hybrid
    from spgpu_tpu_torch.ops import hell_spmv, hybrid_spmv
    from spgpu_tpu_torch.solvers import solve

    out, launches = dict(card=smi), {}
    m64 = mixed()
    coo64 = flagship(np.float64)
    runs = [("hybrid", "mixed", spd_from(m64, np.float32), 1e-5, 1e-4),
            ("hybrid", "mixed", spd_from(m64, np.float64), 1e-10, 1e-9),
            ("hell", "flagship", spd_from(flagship()), 1e-5, 1e-4),
            ("hell", "flagship", spd_from(coo64, np.float64), 1e-10, 1e-9),
            ("hell", "flagship", spd_from(with_imag(coo64, 8, np.complex64),
                                          np.complex64), 1e-5, 1e-4)]
    for fmt, fix, spd, tol, true_tol in runs:
        name = np.dtype(spd.values.dtype).name
        what = f"solve_classic {fmt} {name}"
        x_true = rand_vector(spd.n_rows, 1, wide(name))
        b = spd.spmv(x_true).astype(name)
        loop_counts(reset=True)
        t0 = time.perf_counter()
        res, counts = counted(lambda: solve(spd, b, device=device, fmt=fmt, tol=tol,
                                            maxiter=20000), launches, CLASSIC_KERNELS)
        solve_s = time.perf_counter() - t0
        reads = loop_counts()
        if not bool(res.converged):
            raise AssertionError(f"{what}: did not converge in {res.iterations}")
        if fmt == "hybrid" and (len(counts) != 2 or min(counts.values()) < res.iterations):
            raise AssertionError(f"{what}: launches {counts} for {res.iterations} "
                                 "iterations")
        check_reads(what, res.iterations, reads)
        gate = residual_gate(spd, b, true_tol, what)
        item = dict(fixture=fix, rows=spd.n_rows, nnz=spd.nnz, iterations=res.iterations,
                    launches=counts, **reads, solve_total_s=solve_s,
                    true_residual=gate(res.x), x_dtype=str(res.x.dtype),
                    x_err_vs_true=float(np.abs(res.x.cpu().numpy() - x_true).max()))
        if fmt == "hell":
            ref = solve(spd, b, device=device, fmt="whell", tol=tol, maxiter=20000)
            if abs(res.iterations - ref.iterations) > max(1, ref.iterations // 10):
                raise AssertionError(f"{what}: {res.iterations} iterations, the whell "
                                     f"route {ref.iterations}")
            item["whell_iterations"] = ref.iterations
            a = coo_to_hell(spd, device=device)
            mv = lambda v, a=a: hell_spmv(a, v)  # noqa: E731
            item.update(slots=a.total_slots, storage_bytes=a.storage_bytes)
        else:
            a = coo_to_hybrid(spd, device=device)
            mv = lambda v, a=a: hybrid_spmv(a, v)  # noqa: E731
            item.update(tau_lanes=a.tau_lanes, band_frac=a.band_nnz / a.nnz,
                        storage_bytes=a.storage_bytes)
        bt = torch.from_numpy(b).to(device)
        item["loop"] = loop_pair("cg", mv, bt, tol, (fmt, name) in BIT_REPRODUCIBLE,
                                 gate, smi)
        out[f"{fmt}_{name}"] = item
        del a, mv
        torch.cuda.empty_cache()
    return out, launches


def classic_phases(device, smi):
    """Phases 35-37 in this process (``--classic``), each with its
    main-path launches by kernel (the counted hybrid product and the
    hybrid solves).  They run in the order 36, 37, 35: the hybrid's
    device time by kernel needs the process's first profiling sessions
    (later ones lose events, ``PERF.md`` §7), and phase 35 times many
    products."""
    for phase, fn in (("hybrid", hybrid_phase),
                      ("solve_classic", solve_classic_phase),
                      ("classic_formats", classic_formats_phase)):
        res, launches = fn(device, smi)
        yield phase, dict(res, launches=launches)


# --------------------------------------------------------------------------
# the context API and the tooling (``--tooling``): create/destroy and the
# stream calls, the bench harness's suite, BLAS-1 and weak-scaling rows,
# time_op/roofline_report and trace

#: the harness suite's routes by its ``fmt``: the kernel table's name of
#: the hand kernel and its launch counter (``kernels.counter_name``);
#: None for the rows that run plain torch
SUITE_KERNELS = {
    "ell_torch": None,
    "whell_packed_k1": ("whell_packed_spmv", "whell.LAUNCHES"),
    "whdia_k3": ("whdia_spmv", "whdia.LAUNCHES"),
    "sdia_k2": ("sdia_spmv", "sdia.LAUNCHES"),
    "sdia_f64_k5": ("sdia_spmv_f64", "sdia.LAUNCHES_F64"),
    "whell_f64_k4": ("whell_packed_spmv_f64", "whell.LAUNCHES_F64"),
    "whell_c64_k7": ("whell_packed_spmv_c64", "whell.LAUNCHES_C64"),
    "whdia_c64_k9": ("whdia_spmv_c64", "whdia.LAUNCHES_C64"),
    "whell_spmm8_k12": ("whell_packed_spmm", "whell.LAUNCHES_SPMM"),
    "hell_spmm8_torch": None,
}


def context_check(device):
    """``create(0)``, its device facts and stream calls: an SDIA product
    (kernel #2) issued after ``set_stream(s)`` behind a copy of x on
    ``s`` must read the copied x, so it ran on ``s``; then
    ``set_stream(None)`` and ``destroy``."""
    import torch

    from spgpu_tpu_torch import core, ops
    from spgpu_tpu_torch.convert import coo_to_sdia
    from spgpu_tpu_torch.utils.fixtures import laplacian_2d

    ctx = core.create(0)
    lap = laplacian_2d(256, 256, np.float32)
    a = coo_to_sdia(lap, device=ctx.device)
    x_old, x_new = (torch.from_numpy(rand_vector(lap.n_cols, s, np.float32)).to(ctx.device)
                    for s in (3, 4))
    xt = x_old.clone()
    torch.cuda.synchronize(ctx.device)
    s = ctx.stream_create()
    status = ctx.set_stream(s)
    try:
        current = ctx.get_stream() == s
        torch.cuda._sleep(50_000_000)
        xt.copy_(x_new)
        z = ops.sdia_spmv(a, xt)
    finally:
        ctx.set_stream(None)
    s.synchronize()
    err = check_close(z, lap.spmv(x_new.cpu().numpy().astype(np.float64)), 2e-5, 2e-5,
                      "a product after set_stream(s)")
    if status != core.Status.SUCCESS or not current \
            or ctx.get_stream() != torch.cuda.default_stream(ctx.device):
        raise AssertionError(f"stream calls: set_stream gave {status!r}, current "
                             f"stream was s: {current}")
    facts = dict(device=str(ctx.device), platform=ctx.platform, lanes=ctx.lanes,
                 sublanes_bf16=ctx.sublanes(torch.bfloat16),
                 hbm_bandwidth=ctx.hbm_bandwidth, set_stream=int(status),
                 product_on_stream_max_abs_err=err)
    facts["destroy"] = int(core.destroy(ctx))
    return facts


def suite_phase(device):
    """``bench.run_suite("chip")`` with every kernel counter set to 0
    before it and read and set to 0 again after each row: every SpMV/SpMM
    row's checksum within rtol 1e-4 (float32, complex64) or 1e-10
    (float64) of its float64/complex128 host golden's, its hand kernel's
    counter moved and no other's (the plain-torch rows and the BLAS-1 and
    baseline rows none), in the row's checked product (its ``launches``:
    the counters set to 0 just before that product and read just after)
    and over the whole row.  Returns the rows, each with the counters it
    moved, and the checked products' launches by kernel name."""
    from spgpu_tpu_torch import kernels
    from spgpu_tpu_torch.bench import run_suite

    lines = []

    def collect(line):
        row = json.loads(line)
        row["counters_moved"] = {kernels.counter_name(k): n
                                 for k, n in kernels.launch_counts().items() if n}
        kernels.reset_launch_counts()
        lines.append(row)

    kernels.reset_launch_counts()
    run_suite("chip", out=collect, device=device)
    launches = {}
    for row in lines:
        what = f"suite {row['config']} {row.get('fmt', row.get('op'))}"
        route = SUITE_KERNELS.get(row.get("fmt"))
        if "checksum" in row:
            tol = 1e-10 if "f64" in row["fmt"] else 1e-4
            row["checksum_rel_err"] = abs(row["checksum"] - row["golden_checksum"]) \
                / abs(row["golden_checksum"])
            if not row["checksum_rel_err"] <= tol:
                raise AssertionError(f"{what}: checksum {row['checksum']} against the "
                                     f"golden's {row['golden_checksum']} (rtol {tol})")
        want = set() if route is None else {route[1]}
        checked = row.get("launches", {})
        if set(row["counters_moved"]) != want or set(checked) != want:
            raise AssertionError(f"{what}: moved {row['counters_moved']} (checked product "
                                 f"{checked}), expected {sorted(want) or 'no kernel counter'}")
        if route is not None:
            add_counts(launches, {route[0]: checked[route[1]]})
    return lines, launches


def tooling_phase(device, smi):
    """Phase 38 (``--tooling``): the context (:func:`context_check`), a
    ``trace`` of three #1 products on the flagship, whose Chrome trace
    must name ``whell_hack_pass``, ``time_op`` and ``roofline_report`` on
    #1 there, then the harness's suite (:func:`suite_phase`: its rows,
    BLAS-1 at n = 2**26 among them, and the baseline rows) and its
    weak-scaling rows (S beyond the cards present skipped: S = 1 on one
    card, one NCCL rank, checked against the golden)."""
    import glob
    import tempfile

    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.bench import run_weak_scaling
    from spgpu_tpu_torch.bench.harness import whell_tensors
    from spgpu_tpu_torch.convert import coo_to_whell
    from spgpu_tpu_torch.utils import roofline_report, time_op, trace

    out = dict(card=smi, context=context_check(device))
    # the trace first: this process's later profiling sessions lose events
    coo = flagship()
    a = coo_to_whell(coo, device=device)
    xl = a.embed(torch.from_numpy(rand_vector(coo.n_cols, 7, np.float32)), torch.float32)
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            for _ in range(3):
                ops.whell_spmv(a, xl)
            torch.cuda.synchronize(device)
        texts = [open(f).read() for f in glob.glob(os.path.join(d, "*.json"))]
    named = [t for t in texts if "whell_hack_pass" in t]
    if not named:
        kinds = sorted({e.get("cat") for t in texts for e in json.loads(t)["traceEvents"]
                        if isinstance(e, dict)} - {None})
        raise AssertionError(f"trace: no file of {len(texts)} names whell_hack_pass "
                             f"(event categories {kinds})")
    out["trace"] = dict(files=len(texts), naming_whell_hack_pass=len(named))
    t = time_op(ops.whell_spmv, a, xl)
    z = ops.whell_spmv(a, xl)
    moved = nbytes(*whell_tensors(a), xl, z)
    out["time_op"] = roofline_report("whell_packed_spmv", t, moved, 2 * coo.nnz, device)
    del a, xl, z

    out["suite"], launches = suite_phase(device)
    ws = run_weak_scaling(out=None)
    for row in ws:
        n = row["launches"].get("whell.LAUNCHES", 0)
        if not (row["max_rel_err"] <= 2e-5 and n >= 1
                and row["halo_slots_sent"] == row["halo_lanes_used"]):
            raise AssertionError(f"weak scaling S={row['shards']}: max_rel_err "
                                 f"{row['max_rel_err']}, launches {row['launches']}, halo "
                                 f"{row['halo_slots_sent']} sent of "
                                 f"{row['halo_lanes_used']} planned")
        add_counts(launches, {"whell_packed_spmv": n})
    out["weak_scaling"] = ws
    return out, launches


def harness_beside(res, earlier: dict) -> dict:
    """The harness's device time of #1, #2, #3 and #12 (its op call, from
    the ``--tooling`` child) beside the same kernel's device time and per
    call time from the earlier phases of this run (``earlier``: kernel
    name -> (that phase's result, its fixture)), and their gap."""
    rows = {(r["config"], r.get("fmt")): r for r in res["suite"]}
    keys = {"whell_packed_spmv": ("fem_irregular", "whell_packed_k1"),
            "sdia_spmv": ("laplacian_2d", "sdia_k2"),
            "whdia_spmv": ("banded", "whdia_k3"),
            "whell_packed_spmm": ("fem_irregular", "whell_spmm8_k12")}
    out = {}
    for name, key in keys.items():
        r, (ph, fixture) = rows[key], earlier[name]
        out[name] = dict(
            harness=f"{key[0]} / {key[1]}", harness_device_ms=1e3 * r["t_avg_s"],
            harness_source=r["t_source"], harness_per_call_ms=1e3 * r["t_call_s"],
            earlier=fixture, earlier_kernel_device_ms=ph["kernel_device_ms"],
            earlier_source=ph["kernel_device_source"], earlier_per_call_ms=ph["kernel_ms"],
            device_gap=1e3 * r["t_avg_s"] / ph["kernel_device_ms"] - 1)
    return out


def build_all():
    """The host helpers, then the five kernel libraries (the packed WHELL,
    SDIA and WHDIA ones each hold the float32, float64, complex64 and
    complex128 kernels of their route), all nvcc builds started together."""
    from spgpu_tpu_torch import native
    from spgpu_tpu_torch.kernels import pcell, sdia, whdia, whell, whell_classic
    from spgpu_tpu_torch.kernels._build import ptxas_by_kernel

    host_s = native.build()
    libs = {"whell_packed_spmv": whell, "sdia_spmv": sdia, "whdia_spmv": whdia,
            "whell_classic_spmv": whell_classic, "pcell_spmv": pcell}
    with ThreadPoolExecutor(len(libs)) as ex:
        futs = {name: ex.submit(m.build) for name, m in libs.items()}
        done = {name: f.result() for name, f in futs.items()}
    return dict(host_lib_s=host_s, cuda_libs={
        name: dict(seconds=sec, ptxas=[ln.strip() for ln in log.splitlines()
                                       if "registers" in ln or "spill" in ln],
                   ptxas_by_kernel=ptxas_by_kernel(log))
        for name, (sec, log) in done.items()})


def kernel_row(name, launches, phase):
    """One entry of the kernel table from the phase that timed it; a
    kernel that reads only live slots (#9, #13) or live units (#15, #16)
    also carries the full layout's bound and the live share beside its
    live ``bound_ms``."""
    route, source, replaces = KERNELS[name]
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": phase["max_abs_err_vs_plain"],
            "ms": phase["kernel_ms"], "plain_ms": phase["plain_ms"],
            "bound_ms": phase["bound_ms"], "bound_by": phase["bound_by"],
            "library_ms": phase["library_ms"],
            **{k: phase[k] for k in ("full_bound_ms", "live_slot_share",
                                     "live_warp_slot_share") if k in phase}}


#: phases 26-28 (26 on two matrices in two level sets, 27 on two
#: matrices): (phase, sweep module, its size, launch counter (kernel
#: module, name), the result's rows, run()'s other arguments)
SWEEP_PHASES = (("ablation_whdia", "whdia_ablation", "band",
                 ("ablation", "LAUNCHES_WHDIA_ABLATION"), "levels", {}),
                ("ablation_whdia_hack", "whdia_ablation", "band",
                 ("ablation", "LAUNCHES_WHDIA_ABLATION"), "levels",
                 {"family": "hack"}),
                ("ablation_whdia_laplace", "whdia_ablation", "lap",
                 ("ablation", "LAUNCHES_WHDIA_ABLATION"), "levels",
                 {"matrix": "laplace"}),
                ("ablation_whdia_hack_laplace", "whdia_ablation", "lap",
                 ("ablation", "LAUNCHES_WHDIA_ABLATION"), "levels",
                 {"matrix": "laplace", "family": "hack"}),
                ("ablation_dd", "dd_ablation", "dd_lap",
                 ("ablation", "LAUNCHES_F64_ABLATION"), "levels", {}),
                ("ablation_dd_flagship", "dd_ablation", "flagship",
                 ("ablation", "LAUNCHES_F64_ABLATION"), "levels",
                 {"matrix": "flagship"}),
                ("dd_geom", "dd_geom_sweep", "dd_lap", ("whell", "LAUNCHES_F64"),
                 "geometries", {}))


def sweep_phases(device):
    """Phases 26-28 in this process: each sweep's ``run()`` at the JAX
    scripts' sizes, with its launch counter set to 0 just before and read
    just after (``counted_launches``); each checks its levels inside
    ``run``, and every row must carry its warm and cold device times.
    Yields ``(phase, result)``."""
    import importlib

    for phase, name, size, (kmod, counter), key, more in SWEEP_PHASES:
        mod = importlib.import_module(f"spgpu_tpu_torch.sweeps.{name}")
        kernels = importlib.import_module(f"spgpu_tpu_torch.kernels.{kmod}")
        setattr(kernels, counter, 0)
        res = mod.run(device, size=SIZES[size], **more)
        res["counted_launches"] = getattr(kernels, counter)
        if res["counted_launches"] < len(res[key]) or any(
                r["device_ms"] is None or r["cold_device_ms"] is None
                for r in res[key]):
            raise AssertionError(f"{phase}: a row was not launched or not timed")
        yield phase, res


def child_phases(flag: str, count: int, extra=None):
    """The phases a fresh process of this script runs (``flag``:
    ``--sweeps``, phases 26-28; ``--kernel-times``, phase 29): in this
    one, the earlier phases' profiling sessions of loops with host reads
    leave later sessions losing events, and these device times need whole
    sessions (``PERF.md`` §7).  Emits each phase's line here, with
    ``extra(result)``'s keys added where ``extra`` is given, and returns
    the results."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                          capture_output=True, text=True, timeout=900)
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"chip_smoke.py {flag} exited {proc.returncode}")
    out = []
    for line in proc.stdout.splitlines():
        res = json.loads(line)
        if extra is not None:
            res.update(extra(res))
        emit(res.pop("phase"), **res)
        out.append(res)
    if len(out) != count:
        raise RuntimeError(f"chip_smoke.py {flag} gave {len(out)} phases")
    return out


#: the profiler names of the kernels phase 29 times alone start so: #15
#: (``classic_spmv_tile`` before its work list, ``classic_spmv_units``
#: since), #17 (``pcell_tile`` before its hack pass, ``pcell_hack_pass``
#: since), and #3, #9 and #13 (``whdia_tile_pass`` and
#: ``whdia_spmm_tile_pass`` before the hack pass, ``whdia_hack_pass`` since;
#: #3, #6 and #10 ``whdia_spmv_warps`` since they read only the live
#: slots, ``whdia_tile_pass`` before)
TIMED_KERNELS = ("classic_spmv", "pcell_tile", "pcell_hack_pass", "whdia_tile_pass",
                 "whdia_spmm_tile_pass", "whdia_hack_pass", "whdia_spmv_warps")


def kernel_times(device):
    """Phase 29, in a fresh process (``--kernel-times``): the device time
    of kernel #15 or #17 alone (its own events, by name, from whole
    profiler sessions), warm and cold (the L2 flushed before each call),
    through ``whell_spmv`` on the layouts of phases 22 and 24: the
    relabelled flagship in fp32 and bf16, the raw one in OELL order and
    with ``ways=2``, and the raw flagship's pcell layout; and of their
    float64 entries on the relabelled flagship's classic layout and the
    raw one's pcell layout in float64 (a float64 x).  It calls only the
    converters and ``whell_spmv``, so it also times an older checkout of
    the port (this file copied into that checkout's root; before float64
    classic and pcell, their two rows raise there).  Beside them, the
    device time of the library call (cuSPARSE CSR, ``csr @ x``) on the
    relabelled and the raw flagship, in fp32 and float64, in the same
    process; then :func:`whell_kernel_times`, :func:`whdia_kernel_times`
    and :func:`spmm_kernel_times`; then #17's account on the float64 pcell
    layout (:func:`pcell_account`).  The fp32 pcell layout is the float64
    one's structure with its values in fp32 (the converter's structure
    does not depend on the type; the values are the fp32 flagship's
    either way), so the converter runs once."""
    import dataclasses

    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.convert import (coo_to_whell, coo_to_whell_percell,
                                         local_degree_perm, symmetric_relabel)
    from spgpu_tpu_torch.utils.timing import kernel_device_ms

    coo = flagship()
    rel = symmetric_relabel(coo, local_degree_perm(coo))
    x = torch.from_numpy(rand_vector(coo.n_cols, 7, np.float32)).to(device)
    x64 = torch.from_numpy(rand_vector(coo.n_cols, 7, np.float64)).to(device)
    out = {f"{tag}{sfx}": library_times(c, v, device)
           for tag, c in (("library_relabelled", rel), ("library_raw", coo))
           for sfx, v in (("", x), ("_f64", x64))}
    layouts = {
        "classic_fp32": lambda: coo_to_whell(rel, device=device, packed=False),
        "classic_bf16": lambda: coo_to_whell(rel, device=device, dtype="bfloat16",
                                             packed=False),
        "classic_oell": lambda: coo_to_whell(coo, device=device, packed=False,
                                             sort_rows=True),
        "classic_ways2": lambda: coo_to_whell(coo, device=device, packed=False, ways=2),
        "pcell_f64": lambda: coo_to_whell_percell(coo, device=device, dtype="float64"),
        "pcell": lambda: dataclasses.replace(p64, values=p64.values.float()),
        "classic_f64": lambda: coo_to_whell(rel, device=device, dtype="float64",
                                            packed=False)}
    p64 = None
    for tag, make in layouts.items():
        a = make()
        if tag == "pcell_f64":
            p64 = a
        xa = x64 if a.values.dtype == torch.float64 else x
        fn = lambda: ops.whell_spmv(a, xa)  # noqa: E731
        names = kernel_names(fn, TIMED_KERNELS)
        if len(names) != 1:
            raise AssertionError(f"kernel_times {tag}: kernels {names}")
        warm, src = kernel_device_ms(fn, names)
        cold, cold_src = kernel_device_ms(fn, names, cold=True)
        out[tag] = dict(kernel=names[0], device_ms=warm, device_source=src,
                        cold_device_ms=cold, cold_source=cold_src)
        del a
    out.update(whell_kernel_times(device))
    out.update(whdia_kernel_times(device))
    out.update(spmm_kernel_times(device))
    out["pcell_account"] = pcell_account(device, p64)
    return out


def pcell_account(device, p64):
    """#17's account on the raw flagship's float64 pcell layout
    (:mod:`spgpu_tpu_torch.sweeps.kernel_account`, the hack pass): the
    production kernel and its builds without the x gathers and without
    the lane scan, each timed warm and cold, with each family's price.  An
    older checkout (no account) gives None."""
    import importlib.util

    if importlib.util.find_spec("spgpu_tpu_torch.sweeps.kernel_account") is None:
        return None
    from spgpu_tpu_torch.sweeps import kernel_account as acc

    res = acc.run(device, design="pcell", layout=p64,
                  variants=("production", "no_gather", "no_scan"))
    for r in res["variants"]:
        print(f"kernel_times: pcell account {r['variant']} warm {r['device_ms']} "
              f"cold {r['cold_device_ms']} price {r['price_ms']} {r['ptxas']}",
              file=sys.stderr, flush=True)
    return res


def op_times(fn, prefixes):
    """Phase 29's times of one op call ``fn``: the device time of every
    device operation it runs (``op_device_ms``, and by name), and of its
    own kernels alone (the names that start with one of ``prefixes``),
    warm and cold (the L2 flushed before each call).  The op's cold time
    is its kernels' cold time plus its other operations' warm time: a
    zero fill shares its profiler name with the L2 flush's.  Where no
    profiling session records any device event (sessions after a profiled
    graph loop can lose them all), every time is the whole call's from
    CUDA events, an upper bound, and ``kernels`` is empty; where sessions
    record device events but none of ``prefixes``, it raises."""
    from spgpu_tpu_torch.utils.timing import (_call_events_ms, _l2_flush, device_ms,
                                              device_ms_by_kernel, kernel_device_ms)

    by_op = device_ms_by_kernel(fn)
    names = kernel_names(fn, prefixes, by_op)
    if not names:
        if by_op or launched(fn):
            raise AssertionError(f"kernel_times: no kernel named {prefixes} launched")
        # no session recorded any device event: the whole call, by events
        warm, cold = _call_events_ms(fn, 20, None), _call_events_ms(fn, 20, _l2_flush())
        return dict(kernels=[], op_by_name_ms={}, op_device_ms=warm,
                    op_device_source="cuda_events", op_cold_device_ms=cold,
                    device_ms=warm, device_source="cuda_events", cold_device_ms=cold,
                    cold_source="cuda_events")
    warm, src = kernel_device_ms(fn, names)
    cold, cold_src = kernel_device_ms(fn, names, cold=True)
    op_ms, op_src = device_ms(fn)
    others = sum(v for k, v in by_op.items() if k not in names)
    return dict(kernels=names, op_by_name_ms=by_op, op_device_ms=op_ms,
                op_device_source=op_src, op_cold_device_ms=cold + others,
                device_ms=warm, device_source=src, cold_device_ms=cold,
                cold_source=cold_src)


def library_times(coo, x, device):
    """The device time of the library call on ``coo`` and ``x`` (cuSPARSE
    CSR, or SpMM for an ``(n_rhs, n)`` stack); raises if PyTorch refuses
    it."""
    from spgpu_tpu_torch.utils.timing import device_ms

    call, refused = library_call(coo, x, device)
    if call is None:
        raise RuntimeError(f"kernel_times: the library call was {refused}")
    ms, src = device_ms(call)
    return dict(device_ms=ms, device_source=src)


def spmm_kernel_times(device):
    """Phase 29's multi-RHS WHELL rows, 8 RHS: #12 (``ops.whell_spmm``,
    fused by default) on the flagship's fp32 and bf16 packed layouts, and
    #16 (``ops.whell_spmm(fused=True)``) on the relabelled flagship's
    classic fp32, bf16 and float64 layouts (a float64 X for the last);
    each op's device time and its own kernels' (profiler names
    ``whell_*``, ``classic_*``), warm and cold, with the full bound
    (every layout array once, X and Z once per RHS), for #16 also the
    live bound of :func:`classic_live`, and the share of each; beside
    them cuSPARSE SpMM on the raw and the relabelled flagship (the
    relabelled one in float64 too), in this process.  It calls only the
    converters and the ops, so it also times an older checkout (whose
    float64 classic row raises before float64 classic layouts)."""
    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.convert import (coo_to_whell, local_degree_perm,
                                         symmetric_relabel)

    coo = flagship()
    rel = symmetric_relabel(coo, local_degree_perm(coo))
    xs = torch.from_numpy(rhs_stack(coo.n_cols)).to(device)
    out = {"library_spmm_raw": library_times(coo, xs, device),
           "library_spmm_relabelled": library_times(rel, xs, device),
           "library_spmm_relabelled_f64": library_times(rel, xs.double(), device)}
    flops = 2 * coo.nnz * N_RHS
    for dt in ("float32", "bfloat16"):
        a = coo_to_whell(coo, device=device, dtype=dt)
        xl = a.embed(xs, dtype=torch.float32)
        t = op_times(lambda: ops.whell_spmm(a, xl), ("whell_",))
        rows = a.seg_lo.shape[0]
        full = (nbytes(a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
                       a.group_bases, None if a.unit_segments else a.seg_lo, a.seg_hi)
                + N_RHS * 4 * (a.x_pages + rows) * 128)
        b = bound(full, flops, "float32")
        out[f"whell_spmm_{dt}"] = dict(
            t, tiles=a.num_tiles, **b, bound_share=b["bound_ms"] / t["device_ms"],
            cold_bound_share=b["bound_ms"] / t["cold_device_ms"])
        del a
        a = coo_to_whell(rel, device=device, dtype=dt, packed=False)
        t = op_times(lambda: ops.whell_spmm(a, xs, fused=True), ("classic_spmm",))
        live = classic_live(a, ops._prep_x(xs, a.n_cols, a.x_pages, stack=True),
                            n_rhs=N_RHS)
        b = bound(live["live_bound_bytes"], flops, "float32")
        out[f"classic_spmm_{dt}"] = dict(
            t, tiles=a.num_tiles, **live, **b,
            live_bound_share=b["bound_ms"] / t["device_ms"],
            full_bound_share=live["full_bound_ms"] / t["device_ms"],
            cold_live_bound_share=b["bound_ms"] / t["cold_device_ms"])
        del a
        for k in (f"whell_spmm_{dt}", f"classic_spmm_{dt}"):
            print(f"kernel_times: {k} {out[k]['kernels']} warm {out[k]['device_ms']} "
                  f"cold {out[k]['cold_device_ms']} op {out[k]['op_device_ms']}",
                  file=sys.stderr, flush=True)
    # #16 in float64 on the relabelled flagship, a float64 X
    a = coo_to_whell(rel, device=device, dtype="float64", packed=False)
    xs64 = xs.double()
    t = op_times(lambda: ops.whell_spmm(a, xs64, fused=True), ("classic_spmm",))
    live = classic_live(a, ops._prep_x(xs64, a.n_cols, a.x_pages, stack=True),
                        n_rhs=N_RHS)
    b = bound(live["live_bound_bytes"], flops, "float64")
    out["classic_spmm_float64"] = dict(
        t, tiles=a.num_tiles, **live, **b,
        live_bound_share=b["bound_ms"] / t["device_ms"],
        full_bound_share=live["full_bound_ms"] / t["device_ms"],
        cold_live_bound_share=b["bound_ms"] / t["cold_device_ms"])
    del a
    return out


def whdia_bounds(a, n_rhs):
    """The bytes and bounds of a WHDIA product with ``n_rhs`` RHS: the
    full layout's (every layout array once, x and z once per RHS) and the
    live slots' (the values of the slots that hold a nonzero, their r0
    (slab mode) or tile words (pattern mode) and tile pages, the per-hack
    slot list, x and z once per RHS), with the live-slot share.  Computed
    from the values, so older checkouts (no ``hack_slots``, no
    ``tile_page``) run too."""
    from spgpu_tpu_torch.utils.measure import HBM_BYTES_PER_S

    isz = a.values.element_size()
    hacks = a.num_groups * a.group_hacks
    live = (a.values != 0).any(dim=1)
    n_live = int(live.sum())
    live_tiles = int(live.view(-1, 8).any(dim=1).sum())
    vectors = n_rhs * isz * (a.n_cols + hacks * 128)
    full = nbytes(a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group,
                  getattr(a, "tile_page", None)) + vectors
    live_bytes = (n_live * (128 * isz + 4 + (0 if a.pattern_mode else 2))
                  + live_tiles * 4 * (2 if a.pattern_mode else 1)
                  + 4 * (hacks + 1) + vectors)
    return dict(live_slot_share=n_live / a.total_slots, live_slots=n_live,
                slots=a.total_slots, live_bytes=live_bytes, full_bytes=full,
                live_bound_ms=1e3 * live_bytes / HBM_BYTES_PER_S,
                full_bound_ms=1e3 * full / HBM_BYTES_PER_S)


def whdia_kernel_times(device):
    """Phase 29's WHDIA rows: #9 (complex64, ``ops.whdia_spmv``) and #13
    (fp32, 8 RHS, ``ops.whdia_spmm(fused=True)``) on the Laplacian (slab
    mode) and banded-11 (pattern mode), with the default 8-launch loop of
    #3 (``ops.whdia_spmm``) on the same fp32 layouts, #3 itself and the
    SpMVs #6 (float64) and #10 (complex128): each op's device time (every
    device operation of one call, by name) and its WHDIA kernels' own
    (``TIMED_KERNELS``), warm and cold, with the live and full bounds and
    the kernel's share of each; beside them cuSPARSE CSR in each SpMV's
    type (complex64, fp32, float64, complex128) and cuSPARSE SpMM in fp32
    on the same matrices, in this process.  It
    calls only the converters and the ops, so it also times an older
    checkout."""
    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.convert import coo_to_whdia
    from spgpu_tpu_torch.utils.fixtures import laplacian_2d, random_banded

    def row(a, fn, n_rhs):
        t = op_times(fn, TIMED_KERNELS)
        b = whdia_bounds(a, n_rhs)
        return dict(t, tiles=a.num_tiles, **b,
                    live_bound_share=b["live_bound_ms"] / t["device_ms"],
                    full_bound_share=b["full_bound_ms"] / t["device_ms"],
                    cold_live_bound_share=b["live_bound_ms"] / t["cold_device_ms"])

    def library(c, x):
        return library_times(c, x, device)

    n = SIZES["lap"]
    lap64 = laplacian_2d(n, n, np.float64)
    band_sum = random_banded(SIZES["band"], 11, wander=7, seed=2,
                             dtype=np.float64).sum_duplicates()
    band64 = random_banded(SIZES["band"], 11, wander=7, seed=2, dtype=np.float64)
    tile_types = {"laplace": (lap64, with_imag(lap64, 12, np.complex128)),
                  "banded11": (band64, with_imag(band_sum, 8, np.complex128))}
    fixtures = {
        "laplace": (laplacian_2d(n, n, np.float32), with_imag(lap64, 12, np.complex64)),
        "banded11": (random_banded(SIZES["band"], 11, wander=7, seed=2, dtype=np.float32),
                     with_imag(band_sum, 8, np.complex64))}
    out = {}
    for fix, (c32, c64) in fixtures.items():
        a = coo_to_whdia(c64, device=device)
        x = torch.from_numpy(rand_vector(c64.n_cols, 7, np.complex64)).to(device)
        out[f"whdia_c64_{fix}"] = row(a, lambda: ops.whdia_spmv(a, x), 1)
        out[f"library_c64_{fix}"] = library(c64, x)
        del a
        a = coo_to_whdia(c32, device=device)
        xs = torch.from_numpy(rhs_stack(c32.n_cols)).to(device)
        out[f"whdia_spmm_{fix}"] = row(a, lambda: ops.whdia_spmm(a, xs, fused=True),
                                       N_RHS)
        out[f"whdia_loop_{fix}"] = row(a, lambda: ops.whdia_spmm(a, xs), N_RHS)
        out[f"library_spmm_{fix}"] = library(c32, xs)
        # #3, #6 and #10 beside them, each with its library call (cuSPARSE
        # CSR in its type)
        x32 = xs[0].contiguous()
        out[f"whdia_f32_{fix}"] = row(a, lambda: ops.whdia_spmv(a, x32), 1)
        out[f"library_f32_{fix}"] = library(c32, x32)
        del a
        for tag, c in (("f64", tile_types[fix][0]), ("c128", tile_types[fix][1])):
            a = coo_to_whdia(c, device=device)
            xt = torch.from_numpy(rand_vector(c.n_cols, 7, c.values.dtype)).to(device)
            out[f"whdia_{tag}_{fix}"] = row(a, lambda: ops.whdia_spmv(a, xt), 1)
            out[f"library_{tag}_{fix}"] = library(c, xt)
            del a
        for k in (f"whdia_c64_{fix}", f"whdia_spmm_{fix}", f"whdia_loop_{fix}",
                  f"whdia_f32_{fix}", f"whdia_f64_{fix}", f"whdia_c128_{fix}"):
            print(f"kernel_times: {k} {out[k]['kernels']} warm {out[k]['device_ms']} "
                  f"cold {out[k]['cold_device_ms']}", file=sys.stderr, flush=True)
    return out


def whell_kernel_times(device):
    """Phase 29's packed-WHELL rows: #1 (fp32), #4, the complex128
    kernel and #7 (complex64) through ``whell_spmv`` on the flagship,
    aligned and scattered windows, and #4 on the dd-Laplacian,
    each with the device time of the whole op (every device operation of
    one call, and each by name) and of its own kernels (profiler names
    ``whell_*``), warm and cold (:func:`op_times`); then #19's levels (the tree's
    ``F64_LEVELS``) on the flagship's two float64 layouts, warm and cold;
    and cuSPARSE CSR on each matrix and type, all in this process, each
    with both bounds (:func:`whell_bounds`).  Older checkouts with
    ``hack_ptr`` run too."""
    import torch

    from spgpu_tpu_torch import ops
    from spgpu_tpu_torch.convert import coo_to_whell
    from spgpu_tpu_torch.kernels import ablation as ab
    from spgpu_tpu_torch.utils.fixtures import laplacian_2d

    coo64 = flagship(np.float64)
    m = SIZES["dd_lap"]
    fixtures = (("flagship", "f32", flagship()), ("flagship", "f64", coo64),
                ("flagship", "c128", with_imag(coo64, 8, np.complex128)),
                ("flagship", "c64", with_imag(coo64, 8, np.complex64)),
                ("dd_lap", "f64", laplacian_2d(m, m, np.float64)))
    out = {}
    for fix, tag, c in fixtures:
        dt = c.values.dtype
        x = torch.from_numpy(rand_vector(c.n_cols, 7, dt)).to(device)
        out[f"library_{fix}_{tag}"] = library_times(c, x, device)
        for scattered in (False, True):
            a = coo_to_whell(c, device=device, scattered=scattered)
            xl = a.embed(x, dtype=x.dtype)
            t = op_times(lambda: ops.whell_spmv(a, xl), ("whell_",))
            z = torch.empty((a.num_groups * a.group_hacks, 128), dtype=x.dtype)
            geom = "scattered" if scattered else "aligned"
            print(f"kernel_times: whell_{fix}_{tag}_{geom} {t['kernels']}",
                  file=sys.stderr, flush=True)
            out[f"whell_{fix}_{tag}_{geom}"] = dict(
                t, tiles=a.num_tiles, padding=a.total_slots * 128 / c.nnz,
                group_hacks=a.group_hacks, chunk_tiles=a.chunk_tiles,
                window_pages=a.window_pages,
                **whell_bounds(a, ops._prep_x(xl, a.n_cols, a.x_pages), z,
                               (8 if tag.startswith("c") else 2) * c.nnz, str(dt)))
            if fix == "flagship" and tag == "f64":
                x2 = ops._prep_x(xl, a.n_cols, a.x_pages)
                args = (a.values, a.residue, a.page_tab, a.tile_base,
                        a.chunk_group, a.group_bases, a.seg_lo, a.seg_hi, x2)
                static = dict(chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
                              window_pages=a.window_pages,
                              unit_segments=a.unit_segments)
                # older checkouts: no work units, or run counters on the
                # layout, and no page words
                for f in ("hack_units", "hack_done", "tile_page"):
                    if hasattr(a, f):
                        static[f] = getattr(a, f)
                out[f"ablation_flagship_f64_{geom}"] = {
                    lv: op_times(lambda lv=lv: ab.whell_f64_ablation(lv, *args, **static),
                                 ("whell_",))
                    for lv in ab.F64_LEVELS}
            del a
    return out


def whell_bounds(a, x2, z, flops, dtype):
    """A packed-WHELL product's two bounds: over the bytes the hack pass
    reads (``bound_ms``: the runs' tiles of the slab, their page words,
    the work units, the group bases, the segments, x and z once) and over
    every layout array (``full_bound_ms``: the whole slab, ct-padding
    tiles included, with tile_base and chunk_group, as the tile pass
    read it), with the runs' share of the tiles."""
    hp = a.hack_ptr.long()
    run_tiles = int((hp[:, 1] - hp[:, 0]).sum())
    seg = (None if a.unit_segments else a.seg_lo, a.seg_hi)
    cell = a.values.element_size() + 2
    runs = run_tiles * (8 * 128 * cell + 4) + nbytes(a.hack_units, a.group_bases,
                                                     *seg, x2, z)
    full = nbytes(a.values, a.residue, a.page_tab, a.tile_base, a.tile_page,
                  a.chunk_group, a.group_bases, *seg, x2, z)
    fb = bound(full, flops, dtype)
    return dict(**bound(runs, flops, dtype), full_bound_ms=fb["bound_ms"],
                full_bound_bytes=fb["bound_bytes"], run_tiles=run_tiles,
                run_tile_share=run_tiles / max(a.num_tiles, 1))


def ablation_row(name, accs):
    """An ablation kernel's row from its phases' results ``accs``: the
    sum of their launches, the largest error of any level against its
    plain version, the first result's full level's per-call times
    (kernel, plain), #3's or #4's bound on its fixture and cuSPARSE CSR's
    per-call time, and every level's device times with their sources (a
    price is None where a level's source and the one before's differ),
    keyed by level, or with several results by matrix, level set, level
    and RHS."""
    route, source, replaces = KERNELS[name]
    acc = accs[0]
    full = acc["levels"][-1]

    def key(a, r):
        if len(accs) == 1:
            return r["level"]
        return (f"{a['matrix']} {a['family']} {r['level']}"
                + (f" x{r['n_rhs']}" if "n_rhs" in r else ""))
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": sum(a["counted_launches"] for a in accs),
            "max_abs_err": max(a["max_abs_err"] for a in accs),
            "ms": full["per_call_ms"], "plain_ms": full["plain_per_call_ms"],
            "bound_ms": acc["bound"]["bound_ms"], "bound_by": acc["bound"]["bound_by"],
            "library_ms": acc["library"]["per_call_ms"],
            "levels": {key(a, r): {k: r[k] for k in (
                "device_ms", "device_source", "cold_device_ms", "cold_source",
                "per_call_ms", "price_ms", "price_cold_ms")}
                for a in accs for r in a["levels"]}}


def close(kernels, smi, torch) -> None:
    """The last three lines: the kernel table, the ``nvidia-smi`` line and
    the result line; no phase may print after them."""
    global _closed
    _closed = True
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if sys.argv[1:] in (["--sweeps"], ["--kernel-times"], ["--large"], ["--dist"],
                        ["--classic"], ["--tooling"]):
        # every library up to date before the first profiling session: a
        # phase run alone from a fresh checkout lost its kernels' events
        # where the build ran between sessions
        build_all()
    if sys.argv[1:] == ["--sweeps"]:  # phases 26-28, for child_phases
        for phase, res in sweep_phases(device):
            print(json.dumps({"phase": phase, **res}), flush=True)
        return 0
    if sys.argv[1:] == ["--kernel-times"]:  # phase 29, for child_phases
        print(json.dumps({"phase": "kernel_times", **kernel_times(device)}), flush=True)
        return 0
    if sys.argv[1:] == ["--large"]:  # phases 30 and 31, for child_phases
        for phase, res in large_phases(device, nvidia_smi()):
            print(json.dumps({"phase": phase, **res}), flush=True)
        return 0
    if sys.argv[1:] == ["--dist"]:  # phases 32-34, for child_phases
        for phase, res in dist_phases(device, nvidia_smi()):
            print(json.dumps({"phase": phase, **res}), flush=True)
        return 0
    if sys.argv[1:] == ["--classic"]:  # phases 35-37, for child_phases
        for phase, res in classic_phases(device, nvidia_smi()):
            print(json.dumps({"phase": phase, **res}), flush=True)
        return 0
    if sys.argv[1:] == ["--tooling"]:  # phase 38, for child_phases
        res, launches = tooling_phase(device, nvidia_smi())
        print(json.dumps({"phase": "tooling", **res, "launches": launches}), flush=True)
        return 0
    from spgpu_tpu_torch.convert import (coo_to_whell, local_degree_perm,
                                         suggest_format, symmetric_relabel)
    from spgpu_tpu_torch.formats.coo import CooMatrix
    from spgpu_tpu_torch.utils.fixtures import laplacian_2d, random_banded

    smi = nvidia_smi()
    emit("env", gpu=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         nvcc=shutil.which("nvcc") or (
             "/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc")
             else None),
         gxx=shutil.which("g++"))

    built = build_all()
    emit("build", **built)

    # --- flagship SpMV, fp32 ------------------------------------------
    coo = flagship()
    fmt = suggest_format(coo)
    t0 = time.perf_counter()
    a32 = coo_to_whell(coo, device=device)  # kept for the spmm phase
    torch.cuda.synchronize(device)
    convert_s = time.perf_counter() - t0
    spmv = spmv_phase(coo, a32, device, "spmv fp32")
    emit("spmv", fmt=fmt, convert_s=convert_s, **spmv)

    # --- bf16 values, fp32 x -------------------------------------------
    a16 = coo_to_whell(coo, device=device, dtype="bfloat16")
    v16 = torch.from_numpy(coo.values).to(torch.bfloat16).double().numpy()
    coo16 = CooMatrix(coo.rows, coo.cols, v16, coo.n_rows, coo.n_cols)
    emit("bf16", **spmv_phase(coo16, a16, device, "spmv bf16"))

    # --- SPD solve: the main path, counted -----------------------------
    spd = spd_from(coo)  # kept for the solve_pcell phase
    solve = spd_solve(spd, device, np.float32, 1e-5, 1e-4, smi)
    emit("solve", **solve)

    # --- SDIA: the 2-D Laplacian, kernel #2 -----------------------------
    n = SIZES["lap"]
    lap = laplacian_2d(n, n, np.float32)
    sdia = sdia_phase(lap, device, "sdia laplace")
    emit("sdia", fixture=f"laplacian_2d({n}, {n})", **sdia)

    # --- WHDIA: banded-11 (pattern mode) and the Laplacian (slab) --------
    band11 = random_banded(SIZES["band"], 11, wander=7, seed=2, dtype=np.float32)
    whdia = {"banded11": whdia_phase(band11, "pattern", device, "whdia banded11"),
             "laplace": whdia_phase(lap, "slab", device, "whdia laplace")}
    emit("whdia", **whdia)

    # --- DIA-class solves through solve(): the second route, counted -----
    band = random_banded(SIZES["band"], 11, wander=0, seed=2, dtype=np.float32)
    solves = dia_solves(lap, band, device, np.float32, 1e-5, 1e-4, smi)
    emit("solve_dia", **solves)

    # --- float64: the flagship through kernel #4 --------------------------
    coo64 = flagship(np.float64)
    t0 = time.perf_counter()
    a64 = coo_to_whell(coo64, device=device)  # kept for the spmm_loop phase
    torch.cuda.synchronize(device)
    convert_s = time.perf_counter() - t0
    spmv64 = spmv_phase(coo64, a64, device, "spmv float64")
    emit("spmv_f64", fmt=suggest_format(coo64), convert_s=convert_s,
         window_pages=a64.window_pages, scattered=a64.scattered,
         group_hacks=a64.group_hacks, chunk_tiles=a64.chunk_tiles, **spmv64)

    # --- the JAX benchmark's double-float row: the Laplacian on #4 -------
    m = SIZES["dd_lap"]
    ddl = laplacian_2d(m, m, np.float64)
    a = coo_to_whell(ddl, device=device)
    emit("dd_laplacian", fixture=f"laplacian_2d({m}, {m}, float64)",
         **spmv_phase(ddl, a, device, "dd laplacian"))
    del a

    # --- float64 DIA class: kernels #5 and #6 -----------------------------
    lap64 = laplacian_2d(n, n, np.float64)
    sdia64 = sdia_phase(lap64, device, "sdia laplace float64")
    emit("sdia_f64", fixture=f"laplacian_2d({n}, {n}, float64)", **sdia64)
    band11_64 = random_banded(SIZES["band"], 11, wander=7, seed=2, dtype=np.float64)
    whdia64 = {
        "banded11": whdia_phase(band11_64, "pattern", device, "whdia banded11 float64"),
        "laplace": whdia_phase(lap64, "slab", device, "whdia laplace float64")}
    emit("whdia_f64", **whdia64)

    # --- float64 solves through solve(), counted --------------------------
    solve64 = {"cg_auto_whell": spd_solve(spd_from(coo64, np.float64), device,
                                          np.float64, 1e-10, 1e-9, smi)}
    band64 = random_banded(SIZES["band"], 11, wander=0, seed=2, dtype=np.float64)
    solve64.update(dia_solves(lap64, band64, device, np.float64, 1e-10, 1e-9, smi))
    emit("solve_f64", **solve64)

    # --- the graph's K, and a Matrix Market file through the graphed CG ---
    emit("loop_k", **loop_k_phase(spd, lap, lap64, device, smi))
    emit("mtx_solve", **mtx_solve(device, smi))

    # --- complex64 and complex128 (C and Z): kernels #7-#11 and the ------
    # --- complex128 WHELL kernel, on the JAX benchmark's complex fixtures
    spmv_c, sdia_c, whdia_c, solve_c = {}, {}, {}, {}
    band_sum = random_banded(SIZES["band"], 11, wander=7, seed=2,
                             dtype=np.float64).sum_duplicates()
    for dt, tol, true_tol in ((np.complex64, 1e-5, 1e-4),
                              (np.complex128, 1e-10, 1e-9)):
        tag = "c64" if dt == np.complex64 else "c128"
        cz = with_imag(coo64, 8, dt)
        t0 = time.perf_counter()
        a = coo_to_whell(cz, device=device)
        torch.cuda.synchronize(device)
        convert_s = time.perf_counter() - t0
        spmv_c[tag] = spmv_phase(cz, a, device, f"spmv {tag}")
        emit(f"spmv_{tag}", fmt=suggest_format(cz), convert_s=convert_s,
             window_pages=a.window_pages, scattered=a.scattered,
             group_hacks=a.group_hacks, chunk_tiles=a.chunk_tiles,
             **spmv_c[tag])
        if tag == "c64":
            ac64 = a  # kept for the spmm_loop phase
        del a
        lap_c = with_imag(lap64, 12, dt)
        sdia_c[tag] = sdia_phase(lap_c, device, f"sdia laplace {tag}")
        emit(f"sdia_{tag}", fixture=f"laplacian_2d({n}, {n}) + 1j*N(0,1), {tag}",
             **sdia_c[tag])
        whdia_c[tag] = {
            "banded11": whdia_phase(with_imag(band_sum, 8, dt), "pattern", device,
                                    f"whdia banded11 {tag}"),
            "laplace": whdia_phase(lap_c, "slab", device, f"whdia laplace {tag}")}
        emit(f"whdia_{tag}", **whdia_c[tag])
        solve_c[tag] = {"cg_auto_whell": spd_solve(spd_from(cz, dt), device, dt,
                                                   tol, true_tol, smi)}
        solve_c[tag].update(dia_solves(spd_from(lap_c, dt),
                                       dominant(with_imag(band64, 8, dt)),
                                       device, dt, tol, true_tol, smi))
        del cz, lap_c
    emit("solve_complex", **solve_c)

    # --- multi-RHS SpMM (kernels #12-#14), 8 RHS: the fused kernels -------
    spmm = {"fp32": whell_spmm_phase(coo, a32, device, "spmm fp32"),
            "bf16": whell_spmm_phase(coo16, a16, device, "spmm bf16")}
    emit("spmm", fixture="flagship", **spmm)
    g_lap = lap.spmv(rhs_stack(lap.n_cols, np.float64))
    spmm_dia = {
        "sdia_laplace": dia_spmm_phase(lap, "sdia", g_lap, device, "spmm sdia"),
        "whdia_banded11": dia_spmm_phase(
            band11, "whdia", band11.spmv(rhs_stack(band11.n_cols, np.float64)),
            device, "spmm whdia banded11", mode="pattern"),
        "whdia_laplace": dia_spmm_phase(lap, "whdia", g_lap, device,
                                        "spmm whdia laplace", mode="slab")}
    emit("spmm_dia", **spmm_dia)

    # --- the loop-of-SpMV paths: the DIA defaults, whell fused=False, and -
    # --- the float64 and complex64 whell defaults, counted ----------------
    emit("spmm_loop", n_rhs=N_RHS, **spmm_loop_phase(lap, band11, a32, a64, ac64,
                                                     device))
    del a64, ac64

    # --- classic WHELL, the README quick start: kernel #15 ----------------
    rel = symmetric_relabel(coo, local_degree_perm(coo))
    rel16 = CooMatrix(rel.rows, rel.cols, coo16.values, rel.n_rows, rel.n_cols)
    classic, layouts, plans = {}, {}, {}
    for tag, c, dt in (("fp32", rel, None), ("bf16", rel16, "bfloat16")):
        t0 = time.perf_counter()
        layouts[tag], plans[tag] = coo_to_whell(rel, device=device, dtype=dt,
                                                packed=False, return_plan=True)
        torch.cuda.synchronize(device)
        convert_s = time.perf_counter() - t0
        classic[tag] = dict(convert_s=convert_s, **classic_phase(
            c, layouts[tag], device, f"classic {tag}"))
    classic["update_values"] = classic_update(rel, layouts["fp32"], plans["fp32"],
                                              device, "classic update_values")
    del plans
    classic["oell"] = classic_variant(coo, device, "classic oell", sort_rows=True)
    classic["ways2"] = classic_variant(coo, device, "classic ways2", ways=2)
    emit("classic", fixture="flagship, symmetric_relabel(local_degree_perm); "
         "oell and ways2 on the raw flagship", **classic)

    # --- classic SpMM: kernel #16 (fused=True) beside the loop of #15 -----
    classic_spmm = {tag: classic_spmm_phase(c, layouts[tag], device,
                                            f"classic spmm {tag}")
                    for tag, c in (("fp32", rel), ("bf16", rel16))}
    emit("classic_spmm", fixture="flagship relabelled, classic", **classic_spmm)
    del layouts

    # --- per-cell routing: kernel #17 on the raw flagship, then solve() ---
    pcell = pcell_phase(coo, device, spmv, "pcell")
    emit("pcell", fixture="flagship", **pcell)
    solve_p = solve_pcell(spd, device, smi)
    emit("solve_pcell", fixture="flagship SPD form", **solve_p)

    # --- float64 classic WHELL and pcell: #15, #16 and #17 in float64 -----
    rel64 = CooMatrix(rel.rows, rel.cols, rel.values.astype(np.float64), rel.n_rows,
                      rel.n_cols)
    t0 = time.perf_counter()
    a, plan = coo_to_whell(rel64, device=device, packed=False, return_plan=True)
    torch.cuda.synchronize(device)
    convert_s = time.perf_counter() - t0
    classic64 = dict(convert_s=convert_s, **classic_phase(rel64, a, device,
                                                          "classic float64", cold=True))
    classic64["update_values"] = classic_update(rel64, a, plan, device,
                                                "classic float64 update_values")
    del plan
    emit("classic_f64", fixture="flagship, symmetric_relabel(local_degree_perm), "
         "its fp32 values in float64", **classic64)
    classic_spmm64 = classic_spmm_phase(rel64, a, device, "classic spmm float64",
                                        cold=True)
    emit("classic_spmm_f64", fixture="flagship relabelled, classic, its fp32 "
         "values in float64",
         **classic_spmm64)
    del a, rel64
    ptx = built["cuda_libs"]["pcell_spmv"]["ptxas_by_kernel"]
    pcell64 = pcell_phase(coo64, device, spmv64, "pcell float64",
                          ptxas={k: v for k, v in ptx.items() if k.endswith("<d>")})
    emit("pcell_f64", fixture="flagship, float64", **pcell64)
    solve_p64 = solve_pcell(spd_from(coo64, np.float64), device, smi)
    emit("solve_pcell_f64", fixture="flagship SPD form, float64", **solve_p64)

    # --- the per-op accounts (kernels #18, #19) and #4's geometries -------
    *acc18, acc19_lap, acc19, _ = child_phases("--sweeps", len(SWEEP_PHASES))
    acc19 = dict(acc19, counted_launches=acc19["counted_launches"]
                 + acc19_lap["counted_launches"])

    # --- #15 and #17 alone, warm and cold, in a fresh process -------------
    child_phases("--kernel-times", 1)

    # --- large systems on one layout, in a fresh process: the JAX ---------
    # --- benchmark's row-block cells and systems past the old fields ------
    torch.cuda.empty_cache()
    large_launches = {}
    for res in child_phases("--large", 2):
        add_counts(large_launches, res["launches"])

    # --- the distributed layer, in a fresh process with its own NCCL ------
    # --- group of one rank: shard products, world-size-1 solves, plans ----
    for res in child_phases("--dist", 3):
        add_counts(large_launches, res["launches"])

    # --- the classic surface, in a fresh process: the classic layouts' -----
    # --- plain products, the hybrid split (#3 + #1, #6 + #4), the hybrid ---
    # --- and hell solve() routes --------------------------------------------
    torch.cuda.empty_cache()
    for res in child_phases("--classic", 3):
        add_counts(large_launches, res["launches"])

    # --- the context API and the tooling, in a fresh process: the bench ---
    # --- harness's suite, BLAS-1 and weak-scaling rows beside this run's ---
    torch.cuda.empty_cache()
    earlier = {"whell_packed_spmv": (spmv, "flagship, phase spmv"),
               "sdia_spmv": (sdia, "Laplacian 1024², phase sdia"),
               "whdia_spmv": (whdia["banded11"], "banded-11, phase whdia"),
               "whell_packed_spmm": (spmm["fp32"], "flagship 8 RHS, phase spmm")}
    for res in child_phases("--tooling", 1,
                            extra=lambda r: {"harness_beside": harness_beside(r, earlier)}):
        add_counts(large_launches, res["launches"])

    def whdia_row(name, solves, phases):
        """WHDIA's row: the Laplacian's times, the larger error of its two
        fixtures, the launches of both WHDIA solves."""
        return kernel_row(name, solves["cg_auto_whdia"]["launches"]
                          + solves["bicgstab_whdia"]["launches"],
                          dict(phases["laplace"], max_abs_err_vs_plain=max(
                              w["max_abs_err_vs_plain"] for w in phases.values())))

    rows = [
        kernel_row("whell_packed_spmv", solve["launches"], spmv),
        kernel_row("sdia_spmv", solves["cg_sdia"]["launches"], sdia),
        whdia_row("whdia_spmv", solves, whdia),
        kernel_row("whell_packed_spmv_f64", solve64["cg_auto_whell"]["launches"],
                   spmv64),
        kernel_row("sdia_spmv_f64", solve64["cg_sdia"]["launches"], sdia64),
        whdia_row("whdia_spmv_f64", solve64, whdia64)]
    for tag in ("c64", "c128"):
        rows += [
            kernel_row(f"whell_packed_spmv_{tag}",
                       solve_c[tag]["cg_auto_whell"]["launches"], spmv_c[tag]),
            kernel_row(f"sdia_spmv_{tag}", solve_c[tag]["cg_sdia"]["launches"],
                       sdia_c[tag]),
            whdia_row(f"whdia_spmv_{tag}", solve_c[tag], whdia_c[tag])]

    def spmm_row(name, phases, timed_by):
        """A fused kernel's row: the times of its ``timed_by`` fixture, the
        larger error and the sum of the launches of all its fixtures."""
        return kernel_row(name, sum(p["launches"] for p in phases),
                          dict(timed_by, max_abs_err_vs_plain=max(
                              p["max_abs_err_vs_plain"] for p in phases)))

    rows += [
        spmm_row("whell_packed_spmm", spmm.values(), spmm["fp32"]),
        spmm_row("whdia_spmm", [spmm_dia["whdia_banded11"], spmm_dia["whdia_laplace"]],
                 spmm_dia["whdia_banded11"]),
        spmm_row("sdia_spmm", [spmm_dia["sdia_laplace"]], spmm_dia["sdia_laplace"]),
        # #15: the counted op calls of the classic phase and the counted
        # default loops of the classic_spmm phase
        kernel_row("whell_classic_spmv",
                   sum(c["launches"] for c in classic.values())
                   + sum(c["loop_spmv_launches"] for c in classic_spmm.values()),
                   dict(classic["fp32"], max_abs_err_vs_plain=max(
                       classic[t]["max_abs_err_vs_plain"] for t in ("fp32", "bf16")))),
        spmm_row("whell_classic_spmm", classic_spmm.values(), classic_spmm["fp32"]),
        kernel_row("pcell_spmv", solve_p["launches"], pcell),
        # the float64 entries: #15 the counted op calls of classic_f64 and
        # the default loop of classic_spmm_f64, #17 the float64 pcell solve
        kernel_row("whell_classic_spmv_f64",
                   classic64["launches"] + classic64["update_values"]["launches"]
                   + classic_spmm64["loop_spmv_launches"], classic64),
        spmm_row("whell_classic_spmm_f64", [classic_spmm64], classic_spmm64),
        kernel_row("pcell_spmv_f64", solve_p64["launches"], pcell64),
        ablation_row("whdia_ablation", acc18),
        ablation_row("whell_packed_ablation_f64", [acc19])]
    for row in rows:  # the child phases' main-path launches
        row["launches"] += large_launches.get(row["name"], 0)
    close(rows, smi, torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
