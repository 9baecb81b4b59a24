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
// #16's unit_cells loads whole warp-slots predicated in every type: at 8
// RHS 0.1035 ms against the plain loads' 0.1339 in fp32, 0.1924 against
// 0.2023 in float64 (chip_smoke.py's phase 29).
//
// Semantics: a cell whose value is 0 contributes nothing, so for finite x
// the product equals the full-layout one (the plain version, which stays
// the full-layout product).  The TPU kernel multiplies every padding cell,
// so an Inf or NaN in x at a column that only zero-valued cells reference
// turns their lanes into NaN there; here it does not.  Atomic order
// varies, so sums are not bit-reproducible.
//
// SpMM (kernel #16) runs over the same work list (classic_spmm_units):
// one warp per live unit, its live slots' values, residues and page-table
// rows prefetched and its cells decoded as #15's (unit_cells, shared by
// both kernels), each lane's <= 8 live cells' values and x rows then
// held in registers for every RHS, in blocks of kRhs = 8 register sums
// with a runtime remainder (any n_rhs).  As kernel #12's wrapper does,
// the wrapper copies X into an RHS-interleaved (x_pages*128, n_rhs)
// buffer, so one cell's 8 RHS sit in one 32 B sector: two float4 loads
// when n_rhs is a multiple of 4, else masked scalar loads.  Cells whose
// value is 0 gather nothing; each lane issues one atomicAdd per RHS into
// z (n_rhs, rows_padded), none where that sum is 0.  The first design
// (one 128-thread block per tile over the full layout, the page
// table staged in shared memory behind a barrier) took 219.0 us for 8
// RHS on the relabelled flagship (full-layout bound 95.6 us; NVIDIA H100
// 80GB HBM3, 700 W, chip_smoke.py).  Bound: #15's live bytes with x and
// z once per RHS (chip_smoke.py's classic_live).  What holds it back is
// the x gathers: timed side by side on that card and layout (8 RHS,
// fp32, variants not kept), the kernel took 149-150 us uncapped (96
// registers), 60.8 without the x loads, 146.6 with plain stores in place
// of the atomics (wrong sums: the atomics cost ~4 us, so a warp per
// (hack, quarter) summing in registers would gain little), 190 with
// scalar loads only, 167-186 with one block per 64-tile chunk (for L1
// reuse of x), 134-136 with the 64-register cap kept here (a few
// spills; a 40-register cap spilled more and took 313), and 122-123 with
// lanes l and l^16 loading the two halves of one cell's 8 RHS (48
// registers; not kept: full 8-RHS blocks only, a second gather path for
// the rest, for under 10 %).  The TPU
// kernel's per-RHS fori loop and X VMEM staging have no counterpart.
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
// aligned), else as masked scalar loads.  Its register cap is 128 in
// float64 (4 blocks an SM, Acc<double>): the sums, the 8 values and the
// 8 x rows alone take 48 registers.  ptxas (sm_90a, with the predicated
// loads): classic_spmv_units<d> 46 registers, no spills;
// classic_spmm_units<d> 128 registers, no spills (32 bytes of spill
// stores before); classic_spmm_units<f>/<t> 64 registers with 16 bytes of
// spill stores (80 before), the fp32 and bf16 SpMV instances 40.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kSlots = 8;
constexpr int kChunkTiles = 64;  // spgpu_tpu_torch.core.CHUNK_TILES
constexpr int kGroupHacks = 8;
constexpr int kRhs = 8;
constexpr int kUnitWarps = 4;  // kernels #15, #16: work-list entries (warps) per block

// the sum type of a stored value type: fp32 for fp32 and bf16 bits, double
// for double; Vec is its 16 B vector (#16's RHS loads), kMinBlocks #16's
// blocks an SM (its register cap: 64 in fp32, 128 in float64)
template <typename V> struct Acc {
  using T = float;
  using Vec = float4;
  static constexpr int kMinBlocks = 8;
};
template <> struct Acc<double> {
  using T = double;
  using Vec = double2;
  static constexpr int kMinBlocks = 4;
};

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

// lanes of a 32 B value sector, as a shift: 32 B / sizeof(V) lanes (4 of
// a double, 8 of a float, 16 of bf16 bits), so a slot's 32 lanes of a
// unit hold sizeof(V) sectors
template <typename V> constexpr int kSectorShift = sizeof(V) == 8 ? 2 : sizeof(V) == 4 ? 3 : 4;

// #15 reads a lane's value only where its 32 B sector is live in float64,
// and only there reads the sector list; in fp32 and bf16 it reads whole
// live warp-slots by plain loads, faster there (see the note above)
template <typename V> constexpr bool kSectorLoads = sizeof(V) == 8;

// every sector of each slot in `mask`: byte s of the word is 0xFF where
// bit s of mask is set (#16, which loads whole warp-slots)
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

// This lane's cells of work-list entry e (tile t, quarter q, slot mask):
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

// Kernel #16: #15's warp per work-list entry, with kRhs register sums per
// RHS block and one atomicAdd per (RHS, lane) into z (n_rhs, rows_padded).
// At most 64 registers in fp32 (8 blocks an SM), 128 in float64, see the
// note above.
template <typename V>
__global__ void __launch_bounds__(kUnitWarps * 32, Acc<V>::kMinBlocks)
classic_spmm_units(const V* __restrict__ values,
                   const int8_t* __restrict__ residue,
                   const int8_t* __restrict__ page_tab,
                   const int32_t* __restrict__ tile_base,
                   const int32_t* __restrict__ tile_page,
                   const int32_t* __restrict__ chunk_group,
                   const int64_t* __restrict__ work, int64_t n_work,
                   const typename Acc<V>::T* __restrict__ x,
                   typename Acc<V>::T* __restrict__ z,
                   int64_t rows_padded, int n_rhs) {
  using T = typename Acc<V>::T;
  using Vec = typename Acc<V>::Vec;
  constexpr int kVec = sizeof(Vec) / sizeof(T);  // RHS a 16 B load
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kUnitWarps + (threadIdx.x >> 5);
  if (w >= n_work) return;  // whole warps only: the kernel has no barrier
  int j;
  uint32_t meta;
  T v[kSlots];
  int64_t xrow[kSlots];
  const int64_t e = work[w];
  const int64_t t = unit_cells<V, true>(values, residue, page_tab, tile_base, tile_page, e,
                                         slot_sectors(static_cast<unsigned>(e & 0xFF)),
                                         threadIdx.x & 31, j, meta, v, xrow);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) xrow[s] *= n_rhs;
  T* out = z + tile_hack(chunk_group, t, meta) * kLanes + j;
  const bool vec = n_rhs % kVec == 0;  // a full block's 8 RHS: 16 B loads
  for (int r0 = 0; r0 < n_rhs; r0 += kRhs) {
    const int rw = min(kRhs, n_rhs - r0);
    T sum[kRhs];
#pragma unroll
    for (int q = 0; q < kRhs; ++q) sum[q] = T(0);
    if (vec && rw == kRhs) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (v[s] != T(0)) {
          const Vec* xs = reinterpret_cast<const Vec*>(x + xrow[s] + r0);
#pragma unroll
          for (int k = 0; k < kRhs / kVec; ++k) add_vec(sum, k * kVec, v[s], __ldg(xs + k));
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (v[s] != T(0)) {
#pragma unroll
          for (int q = 0; q < kRhs; ++q)
            if (q < rw) sum[q] = mul_add(v[s], __ldg(x + xrow[s] + r0 + q), sum[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRhs; ++q)
      if (q < rw && sum[q] != T(0)) atomicAdd(out + (r0 + q) * rows_padded, sum[q]);
  }
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
                 const void* chunk_group, const void* work, int64_t n_work,
                 const void* x, void* z, int64_t rows_padded,
                 int n_rhs, cudaStream_t st) {
  using T = typename Acc<V>::T;
  // an empty list (no nonzero) still launches, one block that exits
  const int64_t blocks = n_work > 0 ? (n_work + kUnitWarps - 1) / kUnitWarps : 1;
  if (n_rhs > 0)
    classic_spmm_units<V><<<static_cast<unsigned>(blocks), kUnitWarps * 32, 0, st>>>(
        static_cast<const V*>(values), static_cast<const int8_t*>(residue),
        static_cast<const int8_t*>(page_tab), static_cast<const int32_t*>(tile_base),
        static_cast<const int32_t*>(tile_page), static_cast<const int32_t*>(chunk_group),
        static_cast<const int64_t*>(work), n_work, static_cast<const T*>(x),
        static_cast<T*>(z), rows_padded, n_rhs);
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
// the caller.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
int whell_classic_spmm(const void* values, int values_bf16, const void* residue,
                       const void* page_tab, const void* tile_base,
                       const void* tile_page, const void* chunk_group,
                       const void* work, int64_t n_work, const void* x, void* z,
                       int64_t rows_padded, int n_rhs, void* stream) {
  auto* fn = values_bf16 ? classic_spmm<uint16_t> : classic_spmm<float>;
  return fn(values, residue, page_tab, tile_base, tile_page, chunk_group, work, n_work,
            x, z, rows_padded, n_rhs, static_cast<cudaStream_t>(stream));
}

// Kernel #16 in float64: as whell_classic_spmm, with float64 values, the
// RHS-interleaved float64 X and float64 Z.
int whell_classic_spmm_f64(const void* values, const void* residue,
                           const void* page_tab, const void* tile_base,
                           const void* tile_page, const void* chunk_group,
                           const void* work, int64_t n_work, const void* x, void* z,
                           int64_t rows_padded, int n_rhs, void* stream) {
  return classic_spmm<double>(values, residue, page_tab, tile_base, tile_page,
                              chunk_group, work, n_work, x, z, rows_padded, n_rhs,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
