// Classic (non-packed) WHELL SpMV and SpMM on Hopper (sm_90a), with a
// plain C interface for ctypes.
//
// Entry whell_classic_spmv replaces spgpu_tpu/ops/pallas_kernels.py::
// _whell_kernel (kernel #15, called through _whell_spmv_call and the
// classic branch of whell_spmv_pallas); entry whell_classic_spmm replaces
// _whell_spmm_kernel (kernel #16, _whell_spmm_call, whell_spmm_pallas).
// fp32 or bf16 values with fp32 x and sums; entries whell_classic_spmv_f64
// and whell_classic_spmm_f64 are the same two kernels on float64 values,
// x and sums (the JAX classic layout's plain float64 slab, run there in
// interpret mode).  Both compute, on the classic layout arrays
// (spgpu_tpu_torch/formats/whell.py):
//
//   for every cell (slot s, lane j) of tile t = s / 8:
//     r = residue[s, j];  d = page_tab[s, r]        (indexed by residue)
//     col = (tile_page[t] + d) * 128 + r
//     hack = chunk_group[t / 64] * 8 + (tile_base[t] >> 16)
//     z[hack*128 + j] += T(values[s, j]) * x[col]     (T: float or double)
//
// i.e. the stored row hack*128 + j.  The base page comes from the layout's
// full-width tile_page word (int32), not from tile_base's 16-bit field,
// which bounds the JAX layout at 65,536 x pages; columns are int64.  The
// OELL output scatter (row_perm), the way-split reduction and the
// alpha/beta epilogue stay in the op
// (spgpu_tpu_torch/ops/__init__.py), as the JAX wrapper keeps them outside
// its kernel.  Padding cells hold value 0 and an in-range page (a window's
// base + 7 < x_pages).  A classic chunk_group has no trailing sentinel:
// one entry per 64-tile chunk.
//
// SpMV (kernel #15) over a work list.  The classic layout pads much more
// than the packed one (7.54 cells per nonzero on the relabelled flagship
// FEM matrix against 1.74: about 289 MiB of slab at 6 B/cell in fp32),
// and its padding lies in whole blocks: on that matrix 51.5 % of the
// (tile, 32-lane quarter) units hold no nonzero, and only 39.8 % of the
// (slot, 32-lane) warp-slots hold any (115 MiB of the 289; counts of the
// layout, not times).  The first design (one 128-thread block per
// tile, the tile's 8x128 page table staged in shared memory behind a
// block barrier, every cell streamed) read the whole slab, ~305 MB with
// x and z: a bound of ~0.091 ms at 3.35 TB/s (H100 SXM, 700 W), and it
// ran at 85 % of it.  This one reads only what a nonzero needs.  The
// layout carries classic_work_list(values): one int64 per live unit,
// (t*4 + q) << 8 | mask, bit s of mask set when slot s of the unit holds
// a nonzero.  One warp per entry, kUnitWarps = 4 entries per block, so a
// dead unit launches nothing and a dead slot costs no load.  For each set
// bit the warp loads, all at once before any gather: its 32 values (128 B
// coalesced, 64 B in bf16), its 32 residues, and the slot's whole 128 B
// page-table row, 4 entries a lane.  A lane then takes its page entry
// page_tab[s, r] from that row with one __shfl_sync (byte r & 3 of lane r
// >> 2): no shared memory, no barrier, and no load that waits on the
// residue but the x gather.  Lanes whose value is 0 gather no x.  Each
// lane sums in a register and issues one atomicAdd into z (none when its
// sum is 0).  The bound is then the bytes of the live warp-slots (value +
// residue), the page-table sectors their nonzero cells touch, the work
// list, x and z: chip_smoke.py computes it from the layout it runs (~129
// MB, ~0.038 ms at 3.35 TB/s on the relabelled flagship in fp32; the
// row prefetch reads whole rows, up to 4x those sectors, and the 4 units
// of a tile share them in L2).
//
// Choices, each timed against the others on the flagship layouts on an
// H100 (variants not kept in the source): gathering page_tab[s, r] from global
// memory after the residue arrived put a second dependent DRAM round trip
// on every warp's path and cost most of the kernel's time, so the row is
// prefetched with the values; atomics replaced by plain stores and x
// gathers left out each changed little; two or four units per warp and 8
// or 16 warps per block were no faster.  Values, residues and rows go
// through plain loads: through __ldg/__ldcs (ld.global.nc) the bf16
// instance ran far slower with the row prefetch, the fp32 one did not
// (why was not established).
// ptxas (CUDA 12.9, sm_90a): classic_spmv_units<f> and <t>: 40
// registers, no spills, no barriers, no shared memory (the first design:
// 32 registers, 1 barrier, 1,024 bytes of shared memory).
//
// Live sectors.  A live warp-slot holds a nonzero in only about a
// third of its cells on the relabelled flagship, so in float64 the
// kernel also takes the layout's sector list (classic_work_sectors, one
// 64-bit word per work-list entry, bit 8*s + g for each 32 B value sector
// g of slot s that holds a nonzero), loaded with the entry, and a lane
// loads its value only where its sector is live: 91.3 of the 160.7 MB of live
// warp-slot values (chip_smoke.py's classic_live).  Every load of such a
// unit is a predicated load with no branch around it (load_if): the first
// versions kept a branch per slot (a lane branch around the value load, a
// dead lane borrowing a live lane's address, 64 B and 128 B segments), and
// ptxas made each slot a reconvergence point (BSSY/BSYNC) that waited for
// the slot's loads before the next slot's were issued, 8 round trips a
// unit where the parent's plain loads, if-converted by ptxas, took one:
// 101-125 us on the flagship, 1.2-2.1x slower (SASS by cuobjdump; times
// by sweeps/kernel_account.py, NVIDIA H100 80GB HBM3, 700 W).
// Predicated, warm device us: float64 70.5-71.1 against 82.3-84.3
// for whole live warp-slots; fp32 58.6-59.7 against 59.9-61.1; bf16
// 55.7-56.0 against 54.6.  In fp32 and bf16 the parent's plain loads of
// whole live warp-slots stay (kSectorLoads): 56.8-57.0 and 50.3-50.5 in
// the same runs, so the predicated loads cost more there than the
// sectors save.
//
// Semantics: a cell whose value is 0 contributes nothing, so for finite x
// the product equals the full-layout one (the plain version, which stays
// the full-layout product).  The TPU kernel multiplies every padding cell,
// so an Inf or NaN in x at a column that only zero-valued cells reference
// turns their lanes into NaN there; here it does not.  Atomic order
// varies, so sums are not bit-reproducible.
//
// SpMM (kernel #16) runs over the same work list (classic_spmm_units).  As
// kernel #12's wrapper does, the wrapper copies X into an RHS-interleaved
// (x_pages*128, n_rhs) buffer, so one cell's 8 RHS sit in one 32 B
// sector (64 B in float64): 16 B vector loads when n_rhs is a multiple of
// the vector's RHS, else masked scalar loads, in blocks of kRhs = 8
// register sums with a runtime remainder (any n_rhs).  Cells whose value
// is 0 gather nothing; a lane adds its sums into z (n_rhs, rows_padded)
// by atomicAdd, none where a sum is 0 (when: the design below).  Bound:
// #15's live bytes with x and z once per RHS (chip_smoke.py's
// classic_live); the gathers themselves move nnz x 8 RHS x 8 B = 428.6 MB
// through the L2 in float64 on the relabelled flagship, 2.5x the live
// bound's DRAM bytes, and columns repeat too little (1.14 nonzeros a
// distinct column in a unit, 2.22 in a hack) for staging x to pay.
//
// Design (since the redesign for Hopper): persistent warps over the
// layout's list in its SpMM order (spmm_work: classic_spmm_order, by
// output row block, then tile).  The host launches as many 4-warp blocks
// as the card holds at once (3 an SM in float64 at 168 registers, 4 in
// fp32 and bf16 at 128), and the list is dealt kSpmmChunk = 4 entries at
// a time round-robin (the tail one entry at a time, so no warp takes
// more than one entry over another): at any moment the card works on one window
// of the list, whose x rows stay in the L2, and a warp's consecutive
// entries mostly add into one row block, so at <= 8 RHS it carries its
// register sums over them and adds them into z once (one atomicAdd per
// row and RHS when the block changes).  A warp's stage in shared memory
// (Stage<V>: 3,328 B in float64) receives the next entry's slab bytes by
// cp.async (16 B pieces, through the L2 only: the live slots' values, in
// float64 only their live 32 B sectors from spmm_work_sectors, their
// residues and 128 B page-table rows; dead pieces zero-filled) while the
// warp gathers x for the current entry, and the entry after that is
// loaded from the list: the decode (page entry by residue, from shared
// memory) waits for no DRAM round trip of its own.  X is read with an
// L2::evict_last hint.
//
// The account before it (sweeps/kernel_account.py --design classic_spmm on
// the parent's kernel, relabelled flagship, 8 RHS, warm device us; NVIDIA
// H100 80GB HBM3, 700 W): one short-lived warp per entry, its work-list
// load, slab loads, decode, gathers and atomics one dependent chain;
// float64 192.2 (128 registers), 118.0 without the x gathers, the
// atomics and the sector list about 1 each, 6 blocks an SM 167.2 (80
// registers, spilling), 8 blocks 187.9; pairs of lanes sharing a cell's
// X row (each loading half of every 32 B piece) 237.0, slower in every
// type; fp32 105.0, 27.0 of it the gathers.  The account of this design
// (same script, float64 / fp32): 147.9 / 89.0; without the x gathers
// 108.4 / 76.4; without Z's writes 143.1 / 84.8; each entry's sums added
// into z (no carry) 160.4 / 101.2, the list in tile order 161.0 / 94.5,
// dealt one entry at a time 156.2 / 89.3 (8 at a time no better); each
// stage waited for where it is issued 157.6 / 97.3; float64 at 4 blocks
// an SM 249.4 (128 registers, 160 B spilled), fp32 at 3 97.8; 4 RHS a
// register block 167.7 / 110.8; X without the L2 hint, the slab's copies
// L2::evict_first and float64 without the sector list each within 2 us.
// Beside the parent in one call (chip_smoke.py --kernel-times): float64
// 192.4-192.7 -> 147.9-148.1, fp32 105.6-105.9 -> 88.3-88.7, bf16
// 101.9-102.0 -> 84.0-84.2.  What is left: the x gathers (40 us in
// float64; a cell's 8 RHS are one 64 B row) and the slab's stream with
// its decode (107 us without gathers or writes, against a 72 us bound for
// the live warp-slots); the TPU kernel's per-RHS fori loop and X VMEM
// staging have no counterpart.
//
// float64.  The same two kernels, instantiated on the stored and
// summed type (Acc<V>: float for fp32 and bf16 values, double for
// double): a float64 cell is 8 B of value beside the int8 residue and the
// page-table byte, 10 B a cell where fp32 reads 6, and x, z and the
// interleaved X are doubles.  #15 keeps one register sum per lane over a
// unit's 8 slots, one atomicAdd(double*) per live unit and lane (native
// since sm_60), the work list, the zero-cell skip and the 4 B-a-lane
// page-table row prefetch; a warp's 32 values are one 256 B load.  #16
// keeps kRhs = 8 register sums, now doubles, and loads a cell's 8 RHS as
// four 16 B double2 loads when n_rhs is even (its rows then start 16 B
// aligned), else as masked scalar loads.  ptxas (sm_90a):
// classic_spmv_units<d> 46 registers, no spills; classic_spmm_units<d> 168
// registers with 12 bytes of spill stores, <f> and <t> 128 registers, no
// spills, with 13,312, 9,216 and 7,168 bytes of shared memory (the four
// warps' stages); the fp32 and bf16 SpMV instances 40.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kLanes = 128;
constexpr int kSlots = 8;
constexpr int kChunkTiles = 64;  // spgpu_tpu_torch.core.CHUNK_TILES
constexpr int kGroupHacks = 8;
constexpr int kRhs = 8;
constexpr int kUnitWarps = 4;  // kernels #15, #16: work-list entries (warps) per block

// the sum type of a stored value type: fp32 for fp32 and bf16 bits, double
// for double; Vec is its 16 B vector (#16's RHS loads)
template <typename V> struct Acc {
  using T = float;
  using Vec = float4;
};
template <> struct Acc<double> {
  using T = double;
  using Vec = double2;
};

// #16's choices by stored type (sizeof(V): 8 float64, 4 fp32, 2 bf16
// bits), each timed against the others by sweeps/kernel_account.py
// --design classic_spmm: kSpmmSectors, values only in the live 32 B
// sectors of the layout's work_sectors (float64 layouts carry one);
// kSpmmMinBlocks, the blocks an SM asked of ptxas (its register cap: 168
// in float64, where the carried sums spill at 128, else 128); kSpmmChunk,
// the consecutive list entries a warp takes at a time.
template <typename V> constexpr bool kSpmmSectors = sizeof(V) == 8;
template <typename V> constexpr int kSpmmMinBlocks = sizeof(V) == 8 ? 3 : 4;
constexpr int kSpmmChunk = 4;

// *p where `on`, else 0, by a predicated load that a lane off does not
// issue.  No branch around a load: ptxas turns a branch per slot into a
// reconvergence point that waits for the slot's loads before the next
// slot's issue (8 round trips a unit in place of one: the kernel ran 1.4-2x
// slower, sweeps/kernel_account.py); volatile, so each stays where it
// stands, with the unit's other loads, ahead of the gathers.
#define SPGPU_LOAD_IF(NAME, TYPE, REG, PTX, CON)                                  \
  __device__ __forceinline__ REG NAME(const TYPE* p, bool on) {                 \
    REG r = 0;                                                                  \
    asm volatile("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n @q " PTX " %0, [%1];\n}" \
                 : "+" CON(r) : "l"(p), "r"(static_cast<unsigned>(on)));        \
    return r;                                                                   \
  }
SPGPU_LOAD_IF(load_if, float, float, "ld.global.f32", "f")
SPGPU_LOAD_IF(load_if, double, double, "ld.global.f64", "d")
SPGPU_LOAD_IF(load_if, uint16_t, unsigned short, "ld.global.u16", "h")
SPGPU_LOAD_IF(load_if, uint32_t, uint32_t, "ld.global.u32", "r")
SPGPU_LOAD_IF(load_if, int8_t, int, "ld.global.s8", "r")
#undef SPGPU_LOAD_IF

// a value in its sum type by a plain load, and where `on` (else 0) by a
// predicated one (bf16 bits: the top half of an fp32)
__device__ __forceinline__ float value_at(const float* v, int64_t i) { return v[i]; }
__device__ __forceinline__ double value_at(const double* v, int64_t i) { return v[i]; }
__device__ __forceinline__ float value_at(const uint16_t* v, int64_t i) {
  return __uint_as_float(static_cast<uint32_t>(v[i]) << 16);
}
__device__ __forceinline__ float value_if(const float* v, int64_t i, bool on) {
  return load_if(v + i, on);
}
__device__ __forceinline__ double value_if(const double* v, int64_t i, bool on) {
  return load_if(v + i, on);
}
__device__ __forceinline__ float value_if(const uint16_t* v, int64_t i, bool on) {
  return __uint_as_float(static_cast<uint32_t>(load_if(v + i, on)) << 16);
}

__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }

// sum[k0 + i] += v * (the i-th component of a), for a 16 B vector of RHS
__device__ __forceinline__ void add_vec(float (&sum)[kRhs], int k0, float v, float4 a) {
  sum[k0] = fmaf(v, a.x, sum[k0]);
  sum[k0 + 1] = fmaf(v, a.y, sum[k0 + 1]);
  sum[k0 + 2] = fmaf(v, a.z, sum[k0 + 2]);
  sum[k0 + 3] = fmaf(v, a.w, sum[k0 + 3]);
}
__device__ __forceinline__ void add_vec(double (&sum)[kRhs], int k0, double v, double2 a) {
  sum[k0] = fma(v, a.x, sum[k0]);
  sum[k0 + 1] = fma(v, a.y, sum[k0 + 1]);
}

// #16's loads of the RHS-interleaved X, 16 B or one RHS: the read-only
// path, marked evict_last in the L2, so X (16.8 MB in float64 at 8 RHS on
// the relabelled flagship) stays there while the slab streams past it
__device__ __forceinline__ uint64_t x_policy() {
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
}

// lanes of a 32 B value sector, as a shift: 32 B / sizeof(V) lanes (4 of
// a double, 8 of a float, 16 of bf16 bits), so a slot's 32 lanes of a
// unit hold sizeof(V) sectors
template <typename V> constexpr int kSectorShift = sizeof(V) == 8 ? 2 : sizeof(V) == 4 ? 3 : 4;

// #15 reads a lane's value only where its 32 B sector is live in float64,
// and only there reads the sector list; in fp32 and bf16 it reads whole
// live warp-slots by plain loads, faster there (see the note above)
template <typename V> constexpr bool kSectorLoads = sizeof(V) == 8;

// every sector of each slot in `mask`: byte s of the word is 0xFF where
// bit s of mask is set (#16 in fp32 and bf16, which copies whole live
// warp-slots)
__device__ __forceinline__ uint64_t slot_sectors(unsigned mask) {
  uint64_t w = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
    if (mask >> s & 1u) w |= uint64_t{0xFF} << (8 * s);
  return w;
}

// the stored-row hack of tile t: its chunk's 8-hack group, then hh
__device__ __forceinline__ int64_t tile_hack(const int32_t* __restrict__ chunk_group,
                                             int64_t t, uint32_t meta) {
  return static_cast<int64_t>(chunk_group[t / kChunkTiles]) * kGroupHacks + (meta >> 16);
}

// This lane's cells of work-list entry e (tile t, quarter q, slot mask), #15's:
// every load of the unit up front (the live slots' residues and 128 B
// page-table rows, 4 entries a lane, and values), then each live cell's
// page entry by residue with one __shfl_sync: value v[s] (0 in a dead
// slot or sector) and x column col[s].  kPredicated: every load a
// predicated one, values only where the sector word `live` marks them
// (bit 8*s + g: sector g of slot s); else plain loads of whole live
// warp-slots in a warp-uniform branch per slot, which ptxas if-converts
// (`live` unread).  Returns the tile; j is the lane's output lane, meta
// the tile's word (its hh), the base page from tile_page.
template <typename V, bool kPredicated, typename T>
__device__ __forceinline__ int64_t unit_cells(const V* __restrict__ values,
                                              const int8_t* __restrict__ residue,
                                              const int8_t* __restrict__ page_tab,
                                              const int32_t* __restrict__ tile_base,
                                              const int32_t* __restrict__ tile_page,
                                              int64_t e, uint64_t live, int lane, int& j,
                                              uint32_t& meta, T (&v)[kSlots],
                                              int64_t (&col)[kSlots]) {
  const unsigned mask = static_cast<unsigned>(e & 0xFF);
  const int64_t t = e >> 10;  // unit = e >> 8 = t*4 + q
  j = static_cast<int>((e >> 8) & 3) * 32 + lane;
  meta = static_cast<uint32_t>(tile_base[t]);
  const int64_t base = static_cast<int64_t>(tile_page[t]) * kLanes;
  const int64_t cell0 = t * (kSlots * kLanes);
  const int g = lane >> kSectorShift<V>;  // the lane's sector in each slot
  int r[kSlots];
  uint32_t pw[kSlots];  // 4 page entries of the slot's page-table row a lane
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int64_t row = cell0 + s * kLanes;
    const bool slot = mask >> s & 1u;  // warp-uniform
    if constexpr (kPredicated) {  // predicated loads, no branch
      const unsigned bits = static_cast<unsigned>(live >> (8 * s)) & 0xFFu;
      v[s] = value_if(values, row + j, (bits >> g & 1u) != 0);
      r[s] = load_if(residue + row + j, slot);
      pw[s] = load_if(reinterpret_cast<const uint32_t*>(page_tab + row) + lane, slot);
    } else {
      v[s] = T(0);
      r[s] = 0;
      pw[s] = 0;
      if (slot) {
        v[s] = value_at(values, row + j);
        r[s] = residue[row + j];
        pw[s] = reinterpret_cast<const uint32_t*>(page_tab + row)[lane];
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {  // page entry by residue: byte r of the row
    int d = 0;
    if (mask >> s & 1u)  // warp-uniform
      d = (__shfl_sync(0xffffffffu, pw[s], r[s] >> 2) >> (8 * (r[s] & 3))) & 0xFF;
    col[s] = base + d * kLanes + r[s];
  }
  return t;
}

// Kernel #15: one warp per work-list entry, with its sector word.
template <typename V>
__global__ void __launch_bounds__(kUnitWarps * 32)
classic_spmv_units(const V* __restrict__ values,
                   const int8_t* __restrict__ residue,
                   const int8_t* __restrict__ page_tab,
                   const int32_t* __restrict__ tile_base,
                   const int32_t* __restrict__ tile_page,
                   const int32_t* __restrict__ chunk_group,
                   const int64_t* __restrict__ work,
                   const uint64_t* __restrict__ sectors, int64_t n_work,
                   const typename Acc<V>::T* __restrict__ x,
                   typename Acc<V>::T* __restrict__ z) {
  using T = typename Acc<V>::T;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kUnitWarps + (threadIdx.x >> 5);
  if (w >= n_work) return;  // whole warps only: the kernel has no barrier
  int j;
  uint32_t meta;
  T v[kSlots];
  int64_t col[kSlots];
  const int64_t e = work[w];
  // the entry's sector word, loaded with it, not after it (float64 only)
  const uint64_t live = kSectorLoads<V> ? sectors[w] : 0;
  const int64_t t = unit_cells<V, kSectorLoads<V>>(values, residue, page_tab, tile_base,
                                                   tile_page, e, live, threadIdx.x & 31, j,
                                                   meta, v, col);
  T sum = T(0);
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
    if (v[s] != T(0)) sum = mul_add(v[s], __ldg(x + col[s]), sum);
  if (sum != T(0)) atomicAdd(z + tile_hack(chunk_group, t, meta) * kLanes + j, sum);
}

// One work-list entry's slab bytes in shared memory (#16's stage): its 32
// lanes' values of each slot (zero where the slot, or the value's sector,
// is dead), their residues and the slots' whole 128 B page-table rows.
template <typename V> struct Stage {
  alignas(16) V vals[kSlots][32];
  alignas(16) int8_t res[kSlots][32];
  alignas(16) int8_t pg[kSlots][kLanes];
};

// dst <- the 16 B at src where `on`, else 16 zero bytes (src-size 0), by
// cp.async through the L2 only; complete at cp.async.wait_group
__device__ __forceinline__ void copy16_or_zero(void* dst, const void* src, bool on) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(on ? 16 : 0) : "memory");
}

// #16's per-entry words beside the stage: the tile's hh word, base page
// and chunk group (the stored-row hack), and the entry's quarter
struct UnitWords {
  uint32_t meta;
  int32_t page, group, q;
};

// The warp's copies of entry e into `st` (the live sectors `live`, bit
// 8*s + g; dead cells come in as zeros) and the plain loads of its words:
// all issued, none waited for.  Lane l copies 16 B pieces l, l+32, ...
// of the unit's values, then of its residues and page rows.
template <typename V>
__device__ __forceinline__ UnitWords stage_unit(Stage<V>& st, const V* __restrict__ values,
                                                const int8_t* __restrict__ residue,
                                                const int8_t* __restrict__ page_tab,
                                                const int32_t* __restrict__ tile_base,
                                                const int32_t* __restrict__ tile_page,
                                                const int32_t* __restrict__ chunk_group,
                                                int64_t e, uint64_t live, int lane) {
  constexpr int kPieces = 32 * static_cast<int>(sizeof(V)) / 16;  // a slot's value pieces
  constexpr int kPieceLanes = 16 / static_cast<int>(sizeof(V));
  const unsigned mask = static_cast<unsigned>(e & 0xFF);
  const int64_t t = e >> 10;
  const int q = static_cast<int>((e >> 8) & 3);
  const int64_t cell0 = t * (kSlots * kLanes);
#pragma unroll
  for (int i = 0; i < kSlots * kPieces / 32; ++i) {
    const int k = i * 32 + lane, s = k / kPieces, c = k % kPieces;
    const bool on = (live >> (8 * s + (c >> 1)) & 1u) != 0;  // piece c: sector c / 2
    copy16_or_zero(&st.vals[s][c * kPieceLanes],
                   values + cell0 + s * kLanes + q * 32 + c * kPieceLanes, on);
  }
  if (lane < 2 * kSlots) {
    const int s = lane >> 1, h = lane & 1;
    copy16_or_zero(&st.res[s][16 * h], residue + cell0 + s * kLanes + q * 32 + 16 * h,
                   (mask >> s & 1u) != 0);
  }
#pragma unroll
  for (int i = 0; i < kSlots * kLanes / 16 / 32; ++i) {
    const int k = i * 32 + lane, s = k >> 3, c = k & 7;
    copy16_or_zero(&st.pg[s][16 * c], page_tab + cell0 + s * kLanes + 16 * c,
                   (mask >> s & 1u) != 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  return UnitWords{static_cast<uint32_t>(tile_base[t]), tile_page[t],
                   chunk_group[t / kChunkTiles], q};
}

// the live sector word of entry e: the sector list's word where #16 reads
// by sector, else every sector of each live slot
template <typename V>
__device__ __forceinline__ uint64_t entry_live(int64_t e, uint64_t listed) {
  return kSpmmSectors<V> ? listed : slot_sectors(static_cast<unsigned>(e & 0xFF));
}

// Kernel #16: persistent warps over the list in the layout's SpMM order
// (classic_spmm_order: by row block, then tile), dealt kSpmmChunk entries
// at a time round-robin, so a warp's consecutive entries mostly add into
// one row block; kRhs register sums per RHS block, and where n_rhs <= kRhs
// the sums carry over the warp's entries of one row block and go into z
// (n_rhs, rows_padded) by one atomicAdd per (RHS, lane) when the block
// changes (past kRhs RHS, once per entry and RHS block).  While a unit
// gathers x, the next one's slab bytes come into the warp's stage by
// cp.async and the entry after it is loaded: a unit's decode waits for no
// DRAM round trip of its own.  See the note at the top.
template <typename V>
__global__ void __launch_bounds__(kUnitWarps * 32, kSpmmMinBlocks<V>)
classic_spmm_units(const V* __restrict__ values,
                   const int8_t* __restrict__ residue,
                   const int8_t* __restrict__ page_tab,
                   const int32_t* __restrict__ tile_base,
                   const int32_t* __restrict__ tile_page,
                   const int32_t* __restrict__ chunk_group,
                   const int64_t* __restrict__ work,
                   const uint64_t* __restrict__ sectors, int64_t n_work,
                   const typename Acc<V>::T* __restrict__ x,
                   typename Acc<V>::T* __restrict__ z,
                   int64_t rows_padded, int n_rhs) {
  using T = typename Acc<V>::T;
  using Vec = typename Acc<V>::Vec;
  constexpr int kVec = sizeof(Vec) / sizeof(T);  // RHS a 16 B load
  __shared__ Stage<V> stages[kUnitWarps];
  Stage<V>& st = stages[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kUnitWarps + (threadIdx.x >> 5);
  const int64_t G = static_cast<int64_t>(gridDim.x) * kUnitWarps;
  // the warp's k-th entry: whole rounds of G chunks of kSpmmChunk entries,
  // chunk r*G + g the warp's in round r, then the rest one entry at a time
  // round-robin, so no warp takes more than one entry over another
  const int64_t rounds = n_work / (G * kSpmmChunk);
  auto at = [&](int64_t k) -> int64_t {
    return k < rounds * kSpmmChunk
               ? (k / kSpmmChunk * G + g) * kSpmmChunk + k % kSpmmChunk
               : rounds * G * kSpmmChunk + g + (k - rounds * kSpmmChunk) * G;
  };
  // z's rows at o += sum for RHS r0 + q, q < rw (none where a sum is 0)
  auto flush = [&](T* o, const T (&sum)[kRhs], int r0, int rw) {
#pragma unroll
    for (int q = 0; q < kRhs; ++q)
      if (q < rw && sum[q] != T(0)) atomicAdd(o + (r0 + q) * rows_padded, sum[q]);
  };
  int64_t w = at(0), w1 = at(1);
  if (w >= n_work) return;  // whole warps only: the kernel has no barrier
  // the next entry and its sector word, one unit ahead of its stage
  int64_t e1 = w1 < n_work ? work[w1] : 0;
  uint64_t l1 = kSpmmSectors<V> && w1 < n_work ? sectors[w1] : 0;
  const int64_t e0 = work[w];
  UnitWords u = stage_unit(st, values, residue, page_tab, tile_base, tile_page, chunk_group,
                           e0, entry_live<V>(e0, kSpmmSectors<V> ? sectors[w] : 0), lane);
  const bool vec = n_rhs % kVec == 0;  // a full block's 8 RHS: 16 B loads
  T acc[kRhs];  // the carried sums of row block `held` (n_rhs <= kRhs)
#pragma unroll
  for (int q = 0; q < kRhs; ++q) acc[q] = T(0);
  T* held = nullptr;
  for (int64_t k = 0; w < n_work; ++k) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();  // every lane's copies of the stage have landed
    T v[kSlots];
    int64_t xrow[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {  // decode: the page entry by residue
      v[s] = value_at(&st.vals[s][0], lane);
      const int r = st.res[s][lane];
      const int d = static_cast<uint8_t>(st.pg[s][r]);
      xrow[s] = ((static_cast<int64_t>(u.page) + d) * kLanes + r) * n_rhs;
    }
    __syncwarp();  // every lane has read the stage
    T* out = z + (static_cast<int64_t>(u.group) * kGroupHacks + (u.meta >> 16)) * kLanes +
             u.q * 32 + lane;
    const int64_t w2 = at(k + 2);
    if (w1 < n_work) {  // warp-uniform: the next unit's stage and words
      u = stage_unit(st, values, residue, page_tab, tile_base, tile_page, chunk_group, e1,
                     entry_live<V>(e1, l1), lane);
      e1 = w2 < n_work ? work[w2] : 0;
      l1 = kSpmmSectors<V> && w2 < n_work ? sectors[w2] : 0;
    }
    w = w1;
    w1 = w2;
    // sum[q] += this unit's product with RHS r0 + q, q < rw
    auto gather = [&](T (&sum)[kRhs], int r0, int rw) {
      if (vec && rw == kRhs) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (v[s] != T(0)) {
            const Vec* xs = reinterpret_cast<const Vec*>(x + xrow[s] + r0);
#pragma unroll
            for (int i = 0; i < kRhs / kVec; ++i)
              add_vec(sum, i * kVec, v[s], x_load(xs + i));
          }
        }
      } else {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (v[s] != T(0)) {
#pragma unroll
            for (int q = 0; q < kRhs; ++q)
              if (q < rw) sum[q] = mul_add(v[s], x_load(x + xrow[s] + r0 + q), sum[q]);
          }
        }
      }
    };
    if (n_rhs <= kRhs) {  // warp-uniform: a new row block flushes the last
      if (out != held) {
        if (held != nullptr) flush(held, acc, 0, n_rhs);
#pragma unroll
        for (int q = 0; q < kRhs; ++q) acc[q] = T(0);
        held = out;
      }
      gather(acc, 0, n_rhs);
    } else {
      for (int r0 = 0; r0 < n_rhs; r0 += kRhs) {
        const int rw = min(kRhs, n_rhs - r0);
        T sum[kRhs];
#pragma unroll
        for (int q = 0; q < kRhs; ++q) sum[q] = T(0);
        gather(sum, r0, rw);
        flush(out, sum, r0, rw);
      }
    }
  }
  if (held != nullptr) flush(held, acc, 0, n_rhs);
}

template <typename V>
int classic_spmv(const void* values, const void* residue, const void* page_tab,
                 const void* tile_base, const void* tile_page,
                 const void* chunk_group, const void* work, const void* sectors,
                 int64_t n_work, const void* x, void* z, cudaStream_t st) {
  using T = typename Acc<V>::T;
  // an empty list (no nonzero) still launches, one block that exits
  const int64_t blocks = n_work > 0 ? (n_work + kUnitWarps - 1) / kUnitWarps : 1;
  classic_spmv_units<V><<<static_cast<unsigned>(blocks), kUnitWarps * 32, 0, st>>>(
      static_cast<const V*>(values), static_cast<const int8_t*>(residue),
      static_cast<const int8_t*>(page_tab), static_cast<const int32_t*>(tile_base),
      static_cast<const int32_t*>(tile_page), static_cast<const int32_t*>(chunk_group),
      static_cast<const int64_t*>(work), static_cast<const uint64_t*>(sectors), n_work,
      static_cast<const T*>(x), static_cast<T*>(z));
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int classic_spmm(const void* values, const void* residue, const void* page_tab,
                 const void* tile_base, const void* tile_page,
                 const void* chunk_group, const void* work, const void* sectors,
                 int64_t n_work, const void* x, void* z, int64_t rows_padded,
                 int n_rhs, cudaStream_t st) {
  using T = typename Acc<V>::T;
  // persistent: as many blocks as the card holds at once, none past the
  // list (an empty list still launches one block, which exits)
  static int resident = 0;  // blocks of the kernel the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, classic_spmm_units<V>,
                                                  kUnitWarps * 32, 0);
    resident = sms * per_sm;
  }
  const int64_t blocks = std::max<int64_t>(
      1, std::min<int64_t>(resident, (n_work + kUnitWarps - 1) / kUnitWarps));
  if (n_rhs > 0)
    classic_spmm_units<V><<<static_cast<unsigned>(blocks), kUnitWarps * 32, 0, st>>>(
        static_cast<const V*>(values), static_cast<const int8_t*>(residue),
        static_cast<const int8_t*>(page_tab), static_cast<const int32_t*>(tile_base),
        static_cast<const int32_t*>(tile_page), static_cast<const int32_t*>(chunk_group),
        static_cast<const int64_t*>(work), static_cast<const uint64_t*>(sectors), n_work,
        static_cast<const T*>(x), static_cast<T*>(z), rows_padded, n_rhs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kernel #15: z (num_groups*8*128, stored rows) += the classic product
// over the n_work entries of work (classic_work_list of the values).  x
// is the (x_pages*128) fp32 vector, z fp32 and zeroed by the caller;
// values_bf16 selects bf16 values over fp32 ones.  sectors is read only
// where a build loads fp32 or bf16 values by sector (kSectorLoads), so
// null here.  Launches on `stream`,
// does not synchronise, and returns cudaGetLastError().
int whell_classic_spmv(const void* values, int values_bf16, const void* residue,
                       const void* page_tab, const void* tile_base,
                       const void* tile_page, const void* chunk_group,
                       const void* work, const void* sectors, int64_t n_work,
                       const void* x, void* z, void* stream) {
  auto* fn = values_bf16 ? classic_spmv<uint16_t> : classic_spmv<float>;
  return fn(values, residue, page_tab, tile_base, tile_page, chunk_group, work, sectors,
            n_work, x, z, static_cast<cudaStream_t>(stream));
}

// Kernel #15 in float64: as whell_classic_spmv, with float64 values, x and
// z, and sectors the layout's classic_work_sectors, aligned with work.
int whell_classic_spmv_f64(const void* values, const void* residue,
                           const void* page_tab, const void* tile_base,
                           const void* tile_page, const void* chunk_group,
                           const void* work, const void* sectors, int64_t n_work,
                           const void* x, void* z, void* stream) {
  return classic_spmv<double>(values, residue, page_tab, tile_base, tile_page,
                              chunk_group, work, sectors, n_work, x, z,
                              static_cast<cudaStream_t>(stream));
}

// Kernel #16: Z (n_rhs x rows_padded) += the classic product with each of
// n_rhs RHS over the n_work entries of work (as kernel #15).  x is the
// RHS-interleaved (x_pages*128, n_rhs) fp32 stack, Z fp32 and zeroed by
// the caller; sectors as for whell_classic_spmv (null here).  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError().
int whell_classic_spmm(const void* values, int values_bf16, const void* residue,
                       const void* page_tab, const void* tile_base,
                       const void* tile_page, const void* chunk_group,
                       const void* work, const void* sectors, int64_t n_work,
                       const void* x, void* z, int64_t rows_padded, int n_rhs,
                       void* stream) {
  auto* fn = values_bf16 ? classic_spmm<uint16_t> : classic_spmm<float>;
  return fn(values, residue, page_tab, tile_base, tile_page, chunk_group, work, sectors,
            n_work, x, z, rows_padded, n_rhs, static_cast<cudaStream_t>(stream));
}

// Kernel #16 in float64: as whell_classic_spmm, with float64 values, the
// RHS-interleaved float64 X, float64 Z, and sectors the layout's
// classic_work_sectors, aligned with work.
int whell_classic_spmm_f64(const void* values, const void* residue,
                           const void* page_tab, const void* tile_base,
                           const void* tile_page, const void* chunk_group,
                           const void* work, const void* sectors, int64_t n_work,
                           const void* x, void* z, int64_t rows_padded, int n_rhs,
                           void* stream) {
  return classic_spmm<double>(values, residue, page_tab, tile_base, tile_page,
                              chunk_group, work, sectors, n_work, x, z, rows_padded,
                              n_rhs, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
