// Classic (non-packed) WHELL SpMV and SpMM on Hopper (sm_90a), with a
// plain C interface for ctypes.
//
// Entry whell_classic_spmv replaces spgpu_tpu/ops/pallas_kernels.py::
// _whell_kernel (kernel #15, called through _whell_spmv_call and the
// classic branch of whell_spmv_pallas); entry whell_classic_spmm replaces
// _whell_spmm_kernel (kernel #16, _whell_spmm_call, whell_spmm_pallas).
// fp32 or bf16 values, fp32 x and sums.  Both compute, on the classic
// layout arrays (spgpu_tpu_torch/formats/whell.py):
//
//   for every cell (slot s, lane j) of tile t = s / 8:
//     r = residue[s, j];  d = page_tab[s, r]        (indexed by residue)
//     col = (tile_page[t] + d) * 128 + r
//     hack = chunk_group[t / 64] * 8 + (tile_base[t] >> 16)
//     z[hack*128 + j] += float(values[s, j]) * x[col]
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kSlots = 8;
constexpr int kChunkTiles = 64;  // spgpu_tpu_torch.core.CHUNK_TILES
constexpr int kGroupHacks = 8;
constexpr int kRhs = 8;
constexpr int kUnitWarps = 4;  // kernels #15, #16: work-list entries (warps) per block

// a value as fp32, by a plain load (bf16 bits: exact, the top half of an fp32)
__device__ __forceinline__ float value_at(const float* v, int64_t i) { return v[i]; }
__device__ __forceinline__ float value_at(const uint16_t* v, int64_t i) {
  return __uint_as_float(static_cast<uint32_t>(v[i]) << 16);
}

// the stored-row hack of tile t: its chunk's 8-hack group, then hh
__device__ __forceinline__ int64_t tile_hack(const int32_t* __restrict__ chunk_group,
                                             int64_t t, uint32_t meta) {
  return static_cast<int64_t>(chunk_group[t / kChunkTiles]) * kGroupHacks + (meta >> 16);
}

// This lane's cells of work-list entry e (tile t, quarter q, slot mask):
// every load of the unit up front (the live slots' values, residues and
// 128 B page-table rows, 4 entries a lane), then each live cell's page
// entry by residue with one __shfl_sync: value v[s] (0 in a dead slot)
// and x column col[s].  Returns the tile; j is the lane's output lane,
// meta the tile's word (its hh), the base page from tile_page.  Plain
// loads, not __ldg (see the note above).
template <typename V>
__device__ __forceinline__ int64_t unit_cells(const V* __restrict__ values,
                                              const int8_t* __restrict__ residue,
                                              const int8_t* __restrict__ page_tab,
                                              const int32_t* __restrict__ tile_base,
                                              const int32_t* __restrict__ tile_page,
                                              int64_t e, int lane, int& j,
                                              uint32_t& meta, float (&v)[kSlots],
                                              int64_t (&col)[kSlots]) {
  const unsigned mask = static_cast<unsigned>(e & 0xFF);
  const int64_t t = e >> 10;  // unit = e >> 8 = t*4 + q
  j = static_cast<int>((e >> 8) & 3) * 32 + lane;
  meta = static_cast<uint32_t>(tile_base[t]);
  const int64_t base = static_cast<int64_t>(tile_page[t]) * kLanes;
  const int64_t cell0 = t * (kSlots * kLanes);
  int r[kSlots];
  uint32_t pw[kSlots];  // 4 page entries of the slot's page-table row a lane
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    v[s] = 0.0f;
    r[s] = 0;
    pw[s] = 0;
    if (mask >> s & 1u) {
      const int64_t c = cell0 + s * kLanes + j;
      v[s] = value_at(values, c);
      r[s] = residue[c];
      pw[s] = reinterpret_cast<const uint32_t*>(page_tab + cell0 + s * kLanes)[lane];
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

// Kernel #15: one warp per work-list entry.
template <typename V>
__global__ void __launch_bounds__(kUnitWarps * 32)
classic_spmv_units(const V* __restrict__ values,
                   const int8_t* __restrict__ residue,
                   const int8_t* __restrict__ page_tab,
                   const int32_t* __restrict__ tile_base,
                   const int32_t* __restrict__ tile_page,
                   const int32_t* __restrict__ chunk_group,
                   const int64_t* __restrict__ work, int64_t n_work,
                   const float* __restrict__ x, float* __restrict__ z) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kUnitWarps + (threadIdx.x >> 5);
  if (w >= n_work) return;  // whole warps only: the kernel has no barrier
  int j;
  uint32_t meta;
  float v[kSlots];
  int64_t col[kSlots];
  const int64_t t = unit_cells(values, residue, page_tab, tile_base, tile_page,
                               work[w], threadIdx.x & 31, j, meta, v, col);
  float sum = 0.0f;
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
    if (v[s] != 0.0f) sum = fmaf(v[s], __ldg(x + col[s]), sum);
  if (sum != 0.0f) atomicAdd(z + tile_hack(chunk_group, t, meta) * kLanes + j, sum);
}

// Kernel #16: #15's warp per work-list entry, with kRhs register sums per
// RHS block and one atomicAdd per (RHS, lane) into z (n_rhs, rows_padded).
// At most 64 registers (8 blocks an SM), see the note above.
template <typename V>
__global__ void __launch_bounds__(kUnitWarps * 32, 8)
classic_spmm_units(const V* __restrict__ values,
                   const int8_t* __restrict__ residue,
                   const int8_t* __restrict__ page_tab,
                   const int32_t* __restrict__ tile_base,
                   const int32_t* __restrict__ tile_page,
                   const int32_t* __restrict__ chunk_group,
                   const int64_t* __restrict__ work, int64_t n_work,
                   const float* __restrict__ x, float* __restrict__ z,
                   int64_t rows_padded, int n_rhs) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kUnitWarps + (threadIdx.x >> 5);
  if (w >= n_work) return;  // whole warps only: the kernel has no barrier
  int j;
  uint32_t meta;
  float v[kSlots];
  int64_t xrow[kSlots];
  const int64_t t = unit_cells(values, residue, page_tab, tile_base, tile_page,
                               work[w], threadIdx.x & 31, j, meta, v, xrow);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) xrow[s] *= n_rhs;
  float* out = z + tile_hack(chunk_group, t, meta) * kLanes + j;
  const bool vec = n_rhs % 4 == 0;  // a full block's 8 RHS: two 16 B loads
  for (int r0 = 0; r0 < n_rhs; r0 += kRhs) {
    const int rw = min(kRhs, n_rhs - r0);
    float sum[kRhs];
#pragma unroll
    for (int q = 0; q < kRhs; ++q) sum[q] = 0.0f;
    if (vec && rw == kRhs) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (v[s] != 0.0f) {
          const float4* xs = reinterpret_cast<const float4*>(x + xrow[s] + r0);
          const float4 a = __ldg(xs), b = __ldg(xs + 1);
          sum[0] = fmaf(v[s], a.x, sum[0]);
          sum[1] = fmaf(v[s], a.y, sum[1]);
          sum[2] = fmaf(v[s], a.z, sum[2]);
          sum[3] = fmaf(v[s], a.w, sum[3]);
          sum[4] = fmaf(v[s], b.x, sum[4]);
          sum[5] = fmaf(v[s], b.y, sum[5]);
          sum[6] = fmaf(v[s], b.z, sum[6]);
          sum[7] = fmaf(v[s], b.w, sum[7]);
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (v[s] != 0.0f) {
#pragma unroll
          for (int q = 0; q < kRhs; ++q)
            if (q < rw) sum[q] = fmaf(v[s], __ldg(x + xrow[s] + r0 + q), sum[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRhs; ++q)
      if (q < rw && sum[q] != 0.0f) atomicAdd(out + (r0 + q) * rows_padded, sum[q]);
  }
}

template <typename V>
int classic_spmv(const void* values, const void* residue, const void* page_tab,
                 const void* tile_base, const void* tile_page,
                 const void* chunk_group, const void* work, int64_t n_work,
                 const void* x, void* z, cudaStream_t st) {
  // an empty list (no nonzero) still launches, one block that exits
  const int64_t blocks = n_work > 0 ? (n_work + kUnitWarps - 1) / kUnitWarps : 1;
  classic_spmv_units<V><<<static_cast<unsigned>(blocks), kUnitWarps * 32, 0, st>>>(
      static_cast<const V*>(values), static_cast<const int8_t*>(residue),
      static_cast<const int8_t*>(page_tab), static_cast<const int32_t*>(tile_base),
      static_cast<const int32_t*>(tile_page), static_cast<const int32_t*>(chunk_group),
      static_cast<const int64_t*>(work), n_work, static_cast<const float*>(x),
      static_cast<float*>(z));
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int classic_spmm(const void* values, const void* residue, const void* page_tab,
                 const void* tile_base, const void* tile_page,
                 const void* chunk_group, const void* work, int64_t n_work,
                 const void* x, void* z, int64_t rows_padded,
                 int n_rhs, cudaStream_t st) {
  // an empty list (no nonzero) still launches, one block that exits
  const int64_t blocks = n_work > 0 ? (n_work + kUnitWarps - 1) / kUnitWarps : 1;
  if (n_rhs > 0)
    classic_spmm_units<V><<<static_cast<unsigned>(blocks), kUnitWarps * 32, 0, st>>>(
        static_cast<const V*>(values), static_cast<const int8_t*>(residue),
        static_cast<const int8_t*>(page_tab), static_cast<const int32_t*>(tile_base),
        static_cast<const int32_t*>(tile_page), static_cast<const int32_t*>(chunk_group),
        static_cast<const int64_t*>(work), n_work, static_cast<const float*>(x),
        static_cast<float*>(z), rows_padded, n_rhs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kernel #15: z (num_groups*8*128, stored rows) += the classic product
// over the n_work entries of work (classic_work_list of the values).  x is
// the (x_pages*128) fp32 vector, z fp32 and zeroed by the caller;
// values_bf16 selects bf16 values over fp32 ones.  Launches on `stream`,
// does not synchronise, and returns cudaGetLastError().
int whell_classic_spmv(const void* values, int values_bf16, const void* residue,
                       const void* page_tab, const void* tile_base,
                       const void* tile_page, const void* chunk_group,
                       const void* work, int64_t n_work, const void* x, void* z,
                       void* stream) {
  auto* fn = values_bf16 ? classic_spmv<uint16_t> : classic_spmv<float>;
  return fn(values, residue, page_tab, tile_base, tile_page, chunk_group, work, n_work,
            x, z, static_cast<cudaStream_t>(stream));
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

}  // extern "C"
