"""Accounts of kernels #17, #15 and #16 by source variant: builds of a
kernel's source, each with one edit, timed side by side on the flagship.

Each variant is the production source with one op family taken out or one
choice changed (a textual edit of the source, built into its own
library; no variant is kept in the source), launched through the same C
entry on the same layout and x.  For #17 on the flagship's pcell layout
(``design="pcell"``, the hack pass; ``--matrix spd`` its SPD form, the
pcell CG's system): the x gathers (each product multiplies by a value of
its column instead), the lane scan (the warp shuffles and the shared
prefix row: each output lane reads its thread's own 4-lane sums), the
slot batch, register caps, the warps a block and the chunk length of the
work units.  For #15 on the relabelled flagship's classic layout
(``design="classic"``): predicated loads of the live sectors in every
type, plain loads of whole live warp-slots in every type, and a branch
around each slot's predicated loads.  For #16 on the same layout at
``n_rhs`` RHS (``design="classic_spmm"``): the x gathers (each product
multiplies by a value of its address instead), Z's writes (none, or
plain stores in place of the atomics: wrong sums, priced only), the
sums carried over a row block, the list's order and the entries a warp
takes at a time, the stage's overlap with the gathers, values only in
live sectors, the blocks an SM asked of ptxas, the RHS of a register
block and cache hints (X without its ``L2::evict_last``, the stage's
copies ``L2::evict_first``).  Every variant's warm and cold device time of the kernel, the
whole call's warm device time, the price of its family (the production
time less the variant's), its kernel's ptxas lines and its largest
difference from the production product; a variant that does not build
gives its compiler error in place of times.

    python -m spgpu_tpu_torch.sweeps.kernel_account
        [--design pcell|classic|classic_spmm] [--dtype float64|float32|bfloat16]
        [--matrix raw|spd] [--n-rhs N] [--variants NAME ...]

Card only: the variants are builds of CUDA source.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import torch

from spgpu_tpu_torch.formats.whell import classic_work_sectors, packed_hack_units
from spgpu_tpu_torch.kernels import pcell as kp
from spgpu_tpu_torch.kernels import whell_classic as kc
from spgpu_tpu_torch.kernels._build import compile_library, ptxas_by_kernel
from spgpu_tpu_torch.native import BUILD_DIR
from spgpu_tpu_torch.sweeps import _common as c
from spgpu_tpu_torch.utils.measure import bound, nbytes
from spgpu_tpu_torch.utils.timing import device_ms, kernel_device_ms

__all__ = ["DESIGNS", "FLAGSHIP_ROWS", "apply_edits", "main", "run"]

#: rows of the flagship (``chip_smoke.py``'s, the JAX benchmark's)
FLAGSHIP_ROWS = 262144

_GATHER = ("        p[b][k] = v[b].v[k] * __ldg(x + col);",
           "        p[b][k] = v[b].v[k] * T(col & 1);")
_SCAN = ("""      T incl = a[3];  // inclusive scan of the thread totals
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const T up = __shfl_up_sync(0xffffffffu, incl, o);
        if (l >= o) incl += up;
      }
      T excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (l == 0) excl = T(0);
      __syncwarp();  // the last slot's reads of the buffer are done
      store4(scan + j0, excl + a[0], excl + a[1], excl + a[2], excl + a[3]);
      __syncwarp();  // the slot's 128 prefix sums are written
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int h = lane_byte(hi[s], k), b = lane_byte(lo[s], k);
        out[k] += (h >= 0 ? scan[h] : T(0)) - (b >= 0 ? scan[b] : T(0));
      }""", """#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int h = lane_byte(hi[s], k), b = lane_byte(lo[s], k);
        out[k] += (h >= 0 ? a[k] : T(0)) - (b >= 0 ? a[3] : T(0));
      }""")
_MIN_BLOCKS = "template <typename T> constexpr int kMinBlocks = sizeof(T) == 8 ? 8 : 1;"
_SECTOR_RULE = "constexpr bool kSectorLoads = sizeof(V) == 8;"
_PREDICATED_LOADS = """      v[s] = value_if(values, row + j, (bits >> g & 1u) != 0);
      r[s] = load_if(residue + row + j, slot);
      pw[s] = load_if(reinterpret_cast<const uint32_t*>(page_tab + row) + lane, slot);"""
_BRANCHED_LOADS = """      v[s] = T(0);
      r[s] = 0;
      pw[s] = 0;
      if (slot) {
        v[s] = value_if(values, row + j, (bits >> g & 1u) != 0);
        r[s] = load_if(residue + row + j, true);
        pw[s] = load_if(reinterpret_cast<const uint32_t*>(page_tab + row) + lane, true);
      }"""


# #16's choices (csrc/whell_classic_spmv.cu) as the production source
# states them, and the variants' replacements
_SPMM_SECTORS = "template <typename V> constexpr bool kSpmmSectors = sizeof(V) == 8;"
_SPMM_BLOCKS = "template <typename V> constexpr int kSpmmMinBlocks = sizeof(V) == 8 ? 3 : 4;"
_STORES = ("if (q < rw && sum[q] != T(0)) atomicAdd(o + (r0 + q) * rows_padded, sum[q]);",
           "if (q < rw && sum[q] != T(0)) o[(r0 + q) * rows_padded] = sum[q];")
_SPMM_CHUNK = "constexpr int kSpmmChunk = 4;"
_CARRY = "    if (n_rhs <= kRhs) {  // warp-uniform: a new row block flushes the last"
_NO_CARRY = (_CARRY, _CARRY.replace("n_rhs <= kRhs", "false"))
_NO_WRITES = (_STORES[0], _STORES[0].replace("sum[q] != T(0)", "sum[q] == T(-1e300)"))
_RHS4 = ("constexpr int kRhs = 8;", "constexpr int kRhs = 4;")
_COMMIT = r"""  asm volatile("cp.async.commit_group;\n" ::: "memory");
  return UnitWords"""
_STAGE_NOW = (_COMMIT, _COMMIT.replace("\n  return", r"""
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  return"""))
_COPY = r"""  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(on ? 16 : 0) : "memory");"""
_SLAB_EVICT_FIRST = (_COPY, r"""  asm volatile("{\n .reg .b64 pol;\n"
               " createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
               " cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, pol;\n}\n"
               :: "r"(d), "l"(src), "r"(on ? 16 : 0) : "memory");""")
_X_PLAIN = ("template <typename X> __device__ __forceinline__ X x_load(const X* p) "
            "{ return __ldg(p); }")
_X_FAKE = """__device__ __forceinline__ float x_fake(const void* p) {
  return static_cast<float>(reinterpret_cast<uintptr_t>(p) >> 4 & 1);
}
__device__ __forceinline__ float x_load(const float* p) { return x_fake(p); }
__device__ __forceinline__ double x_load(const double* p) { return x_fake(p); }
__device__ __forceinline__ float4 x_load(const float4* p) {
  const float f = x_fake(p);
  return make_float4(f, f, f, f);
}
__device__ __forceinline__ double2 x_load(const double2* p) {
  const double f = x_fake(p);
  return make_double2(f, f);
}"""
_X_EVICT_LAST = """__device__ __forceinline__ uint64_t x_policy() {
  uint64_t q;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(q));
  return q;
}
__device__ __forceinline__ float x_load(const float* p) {
  float r;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(r) : "l"(p), "l"(x_policy()));
  return r;
}
__device__ __forceinline__ double x_load(const double* p) {
  double r;
  asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;" : "=d"(r) : "l"(p), "l"(x_policy()));
  return r;
}
__device__ __forceinline__ float4 x_load(const float4* p) {
  float4 r;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w) : "l"(p), "l"(x_policy()));
  return r;
}
__device__ __forceinline__ double2 x_load(const double2* p) {
  double2 r;
  asm("ld.global.nc.L2::cache_hint.v2.f64 {%0, %1}, [%2], %3;"
      : "=d"(r.x), "=d"(r.y) : "l"(p), "l"(x_policy()));
  return r;
}"""


def _spmm_blocks(n: int) -> tuple:
    """The edit that asks ptxas for ``n`` blocks an SM of #16 in every type."""
    return _SPMM_BLOCKS, _SPMM_BLOCKS.replace("sizeof(V) == 8 ? 3 : 4", str(n))


def _spmm_chunk(n: int) -> tuple:
    """The edit that deals #16's list ``n`` entries at a time."""
    return _SPMM_CHUNK, _SPMM_CHUNK.replace("4", str(n))


def _spmm_sectors(on: bool) -> tuple:
    """The edit that makes #16 read values by sector in every type or in none."""
    return _SPMM_SECTORS, _SPMM_SECTORS.replace("sizeof(V) == 8", str(on).lower())


def _blocks(n: int) -> tuple:
    """The edit that asks ptxas for ``n`` blocks an SM in both types."""
    return _MIN_BLOCKS, _MIN_BLOCKS.replace("sizeof(T) == 8 ? 8 : 1", str(n))


def _warps(n: int) -> tuple:
    return "constexpr int kHackWarps = 2;", f"constexpr int kHackWarps = {n};"


#: per design: the kernel's profiler name and each variant's (family or
#: choice, source edits, an option: the work units' chunk tiles for
#: ``pcell``, None for the layout's; the list's order for
#: ``classic_spmm``, None for the layout's SpMM order, "tile" for tile
#: order)
DESIGNS = {
    "pcell": dict(kernel="pcell_hack_pass", variants={
        "production": ("none", [], None),
        "no_gather": ("x gathers", [_GATHER], None),
        "no_scan": ("lane scan (shuffles, shared prefix row)", [_SCAN], None),
        "batch8": ("all 8 slots at once, 1 block an SM asked",
                   [("constexpr int kSlotBatch = 4;", "constexpr int kSlotBatch = 8;"),
                    _blocks(1)], None),
        "b10": ("10 blocks an SM (102 registers)", [_blocks(10)], None),
        "b12": ("12 blocks an SM (85 registers)", [_blocks(12)], None),
        "chunk16": ("16-tile chunks of work units", [], 16),
        "chunk4": ("4-tile chunks of work units", [], 4),
        "warps4": ("4 warps a block", [_warps(4)], None),
    }),
    "classic": dict(kernel="classic_spmv_units", variants={
        "production": ("none", [], None),
        "sectors_all": ("predicated loads of live sectors in every type",
                        [(_SECTOR_RULE, "constexpr bool kSectorLoads = true;")], None),
        "plain_all": ("plain loads of whole live warp-slots in every type",
                      [(_SECTOR_RULE, "constexpr bool kSectorLoads = false;")], None),
        "slot_branch": ("predicated loads of live sectors behind a branch per slot",
                        [(_SECTOR_RULE, "constexpr bool kSectorLoads = true;"),
                         (_PREDICATED_LOADS, _BRANCHED_LOADS)], None),
    }),
    "classic_spmm": dict(kernel="classic_spmm_units", variants={
        "production": ("none", [], None),
        "no_gather": ("x gathers", [(_X_EVICT_LAST, _X_FAKE)], None),
        "plain_stores": ("atomics (plain stores: wrong sums)", [_STORES], None),
        "no_writes": ("Z's writes (none: wrong sums)", [_NO_WRITES], None),
        "no_gather_writes": ("x gathers and Z's writes",
                             [(_X_EVICT_LAST, _X_FAKE), _NO_WRITES], None),
        "sectors_all": ("values only in live 32 B sectors, every type",
                        [_spmm_sectors(True)], None),
        "no_sectors": ("whole live warp-slots, every type", [_spmm_sectors(False)], None),
        "stage_now": ("the overlap: each stage waited for where it is issued",
                      [_STAGE_NOW], None),
        **{f"blocks{n}": (f"{n} blocks an SM asked", [_spmm_blocks(n)], None)
           for n in (3, 4, 5)},
        "x_evict_normal": ("X gathers without the L2 hint", [(_X_EVICT_LAST, _X_PLAIN)],
                           None),
        "slab_evict_first": ("the stage's copies L2::evict_first", [_SLAB_EVICT_FIRST],
                             None),
        "rhs4": ("4 RHS a register block", [_RHS4], None),
        **{f"chunk{n}": (f"the list dealt {n} entries at a time", [_spmm_chunk(n)], None)
           for n in (1, 8)},
        "tile_order": ("the list in tile order (the layout's work_list)", [], "tile"),
        "no_carry": ("sums added into z for each entry", [_NO_CARRY], None),
    }),
}


def apply_edits(text: str, edits) -> str:
    """``text`` with each ``(old, new)`` of ``edits`` applied; each ``old``
    must occur exactly once (raises otherwise: the source moved on)."""
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"account edit matches {text.count(old)} times: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def _call_pcell(lib, p, x2, chunk) -> torch.Tensor:
    """One product of the hack pass on the layout's units or on units of
    ``chunk``-tile chunks."""
    rows = p.num_groups * p.group_hacks
    units = p.hack_units if chunk is None else packed_hack_units(
        torch.stack([p.hack_tile_ptr[:-1], p.hack_tile_ptr[1:]], 1), rows, chunk)
    return kp.launch(lib, p.values, p.residue, p.page_tab, p.run_hi, p.run_lo,
                     p.tile_page, p.group_bases, p.hack_tiles, units, x2,
                     rows=rows, window_pages=p.window_pages)


def _call_classic(lib, a, x2, sectors) -> torch.Tensor:
    """One product of #15; ``sectors`` is the layout's sector list, derived
    here for fp32 and bf16 (whose production build reads none of it)."""
    return kc.launch_spmv(lib, a.values, a.residue, a.page_tab, a.tile_base,
                          a.tile_page, a.chunk_group, a.work_list, sectors, x2,
                          num_groups=a.num_groups)


def _call_classic_spmm(lib, a, x3, lists) -> torch.Tensor:
    """One product of #16 (X interleaved, Z zeroed, one launch) over
    ``lists``, a work list and its sector words."""
    return kc.launch_spmm(lib, a.values, a.residue, a.page_tab, a.tile_base,
                          a.tile_page, a.chunk_group, *lists, x3, num_groups=a.num_groups)


def _pcell_bytes(p, x2, z) -> int:
    return nbytes(p.values, p.residue, p.page_tab, p.run_hi, p.run_lo, p.tile_base,
                  p.tile_page, p.chunk_group, p.group_bases, x2, z)


def _classic_bytes(a, x2, z) -> int:
    return nbytes(a.values, a.residue, a.page_tab, a.tile_base, a.tile_page,
                  a.chunk_group, x2, z)


#: per design: (bind, call, the source, bytes of the full-layout bound)
_ENTRIES = {"pcell": (kp._bind, _call_pcell, kp.SOURCE, _pcell_bytes),
            "classic": (kc._bind, _call_classic, kc.SOURCE, _classic_bytes),
            "classic_spmm": (kc._bind, _call_classic_spmm, kc.SOURCE, _classic_bytes)}


def _build(design: str, text: str, names) -> dict:
    """The variants ``names`` of ``design``, each built from ``text`` into
    its own library, all nvcc runs started together:
    ``{name: (lib, ptxas lines of the design's kernel)}``, or ``(None,
    the compiler's error)`` for a variant that does not build (the
    production one raises)."""
    out_dir = os.path.join(BUILD_DIR, "account")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name in names:
        src = os.path.join(out_dir, f"{design}_{name}.cu")
        with open(src, "w") as f:
            f.write(apply_edits(text, DESIGNS[design]["variants"][name][1]))
        jobs[name] = (src, os.path.join(out_dir, f"lib{design}_{name}.so"))
    def compile_one(job):
        try:
            return True, compile_library(*job)[1]
        except RuntimeError as err:
            return False, str(err)

    with ThreadPoolExecutor(len(jobs)) as ex:
        logs = dict(zip(jobs, ex.map(compile_one, jobs.values())))
    out = {}
    for name, (_, path) in jobs.items():
        built, log = logs[name]
        if not built:
            if name == "production":
                raise RuntimeError(log)
            out[name] = (None, log[-2000:])
            continue
        lib = ctypes.CDLL(path)
        _ENTRIES[design][0](lib)
        out[name] = (lib, [f"{k}: {v}" for k, v in ptxas_by_kernel(log).items()
                           if k.startswith(DESIGNS[design]["kernel"] + "<")])
    return out


def _layout(design: str, dtype: str, size: int, matrix: str, dev: torch.device):
    """The flagship's layout of ``design`` in ``dtype``: the pcell layout
    of the raw one (``matrix="raw"``) or of its SPD form (``"spd"``), or
    the relabelled one's classic layout (#15's and #16's)."""
    from spgpu_tpu_torch.convert import (coo_to_whell, coo_to_whell_percell,
                                         local_degree_perm, symmetric_relabel)
    from spgpu_tpu_torch.utils.fixtures import random_fem_like, spd_from

    coo = random_fem_like(size, 27.0, span=768, far_frac=0.01, seed=0, dtype=np.float32)
    if matrix == "spd":
        coo = spd_from(coo)
    if design.startswith("classic"):
        return coo_to_whell(symmetric_relabel(coo, local_degree_perm(coo)), device=dev,
                            dtype=dtype, packed=False)
    return coo_to_whell_percell(coo, device=dev, dtype=dtype)


def run(device="cuda", *, design: str = "pcell", dtype: str = "float64",
        layout=None, size: int = FLAGSHIP_ROWS, matrix: str = "raw",
        n_rhs: int = 8, variants=None) -> dict:
    """The account of ``design`` on the card: its production source built
    once per variant (``variants``, default all; the first is the
    production one), each timed on ``layout`` (default: the flagship's
    layout of the design in ``dtype``, of ``matrix``, its values the fp32
    flagship's, converted here), #16 with ``n_rhs`` RHS."""
    names = list(DESIGNS[design]["variants"] if variants is None else variants)
    if names[0] != "production":
        raise ValueError("the account's first variant is the production one")
    dev = c.sweep_device(device)
    if dev.type != "cuda":
        raise ValueError("the kernel account builds CUDA variants: it runs on a card")
    from spgpu_tpu_torch.ops import _prep_x

    a = _layout(design, dtype, size, matrix, dev) if layout is None else layout
    _, call, source, full_bytes = _ENTRIES[design]
    with open(source) as f:
        built = _build(design, f.read(), names)
    xdt = torch.float64 if a.values.dtype == torch.float64 else torch.float32
    spmm = design == "classic_spmm"
    shape = (n_rhs, a.n_cols) if spmm else (a.n_cols,)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(shape)).to(dev, xdt)
    x2 = _prep_x(x, a.n_cols, a.x_pages, stack=spmm)
    kname = (DESIGNS[design]["kernel"],)
    if design == "classic":  # #15's option: the sector list, in every type
        sectors = (a.work_sectors if a.work_sectors is not None
                   else classic_work_sectors(a.values, a.work_list))
    # #16's option: the layout's list in its SpMM order (None) or in tile
    # order ("tile"), with the sector words in every type
    lists = {o: (wl, classic_work_sectors(a.values, wl))
             for o, wl in ((None, a.spmm_work), ("tile", a.work_list))} if spmm else {}
    ref, out = None, []
    for name in names:
        family, _, option = DESIGNS[design]["variants"][name]
        if design == "classic":
            option = sectors
        elif spmm:
            option = lists[option]
        lib, ptxas = built[name]
        if lib is None:
            out.append(dict(variant=name, family=family, build_error=ptxas))
            continue
        fn = lambda lib=lib, option=option: call(lib, a, x2, option)  # noqa: E731
        z = fn()
        torch.cuda.synchronize(dev)
        if ref is None:
            ref = z.clone()
        warm, warm_src = kernel_device_ms(fn, kname)
        cold, cold_src = kernel_device_ms(fn, kname, cold=True)
        op, op_src = device_ms(fn)
        out.append(dict(variant=name, family=family, ptxas=ptxas,
                        device_ms=warm, device_source=warm_src, cold_device_ms=cold,
                        cold_source=cold_src, op_device_ms=op, op_device_source=op_src,
                        max_abs_diff_vs_production=float((z - ref).abs().max())))
    prod = out[0]
    for r in out:
        if "build_error" in r:
            continue
        r["price_ms"] = prod["device_ms"] - r["device_ms"]
        r["price_cold_ms"] = prod["cold_device_ms"] - r["cold_device_ms"]
        r["op_price_ms"] = prod["op_device_ms"] - r["op_device_ms"]
    return dict(sweep="kernel_account", design=design, dtype=str(a.values.dtype),
                matrix=matrix if layout is None else "given",
                kernel=kname[0], source=source, **c.card(dev),
                rows=a.n_rows, nnz=a.nnz, tiles=a.num_tiles,
                n_rhs=n_rhs if spmm else 1, variants=out,
                full_bound=bound(full_bytes(a, x2, ref), 2 * a.nnz * (n_rhs if spmm else 1),
                                 str(xdt).removeprefix("torch.")))


def main() -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--design", choices=sorted(DESIGNS), default="pcell")
    ap.add_argument("--dtype", choices=("float64", "float32", "bfloat16"),
                    default="float64")
    ap.add_argument("--matrix", choices=("raw", "spd"), default="raw")
    ap.add_argument("--n-rhs", type=int, default=8, help="RHS of #16 (classic_spmm)")
    ap.add_argument("--variants", nargs="+", default=None)
    res = run("cuda", **vars(ap.parse_args()))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
