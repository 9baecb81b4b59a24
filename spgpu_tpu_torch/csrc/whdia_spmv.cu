// Windowed hacked DIA (WHDIA) SpMV on Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces spgpu_tpu/ops/pallas_kernels.py::_whdia_kernel (kernel #3; body
// _whdia_kernel_body, r0 unpacking _whdia_tile_r0; called through
// _whdia_spmv_call and whdia_spmv_pallas; entry whdia_spmv, fp32, both r0
// modes: the warp pass below) and
// _whdia_dd_kernel (_whdia_dd_call, whdia_spmv_dd_pallas; entry
// whdia_spmv_f64, float64 where the TPU kernel emulates it with
// double-float pairs and slab-mode r0 only; here both modes: the warp
// pass below), _whdia_cplx_kernel (_whdia_cplx_call,
// whdia_spmv_cplx_pallas; entry whdia_spmv_c64, complex64, both r0 modes:
// the hack pass below) and _whdia_z_kernel (_whdia_z_call,
// whdia_spmv_z_pallas; entry whdia_spmv_c128, complex128 where the TPU
// kernel runs four double-float slabs, slab-mode r0 only; here both
// modes: the warp pass).  It computes the
// same product on the same layout arrays (spgpu_tpu_torch/formats/whdia.py):
//
//   for every cell (slot s, lane j) of tile t = s / 8:
//     base = tile_page[t],  hh = tile_base[t] >> 16
//     r0   = slot_r0[s]                                     (slab mode)
//          = r00 + step*min(s % 8, F-1) from tile_r0[t]     (pattern mode)
//     hack = chunk_group[t / chunk_tiles] * group_hacks + hh
//     z[hack*128 + j] += values[s, j] * x[base*128 + r0 + j]
//
// with x[c] read as 0 outside [0, n_cols).  The TPU kernel reaches x
// through a window-clamped rotation of VMEM-resident pages; for every
// nonzero cell the column base*128 + r0 + j is the cell's own column, and
// dead slots and diagonal ends hold 0, so the direct guarded read gives
// the same product for finite x.  The base page comes from the layout's
// full-width tile_page word (int32), not from tile_base's 16-bit field,
// which bounds the JAX layout at 65,536 x pages (about 8.4M columns):
// one more 4 B load per tile in the tile pass (#18's tile levels), and in
// the live-slot passes the same one load per listed slot that read
// tile_base before.
//
// Bound on the H100: the value slab streams once, and x and z once; on
// the 2-D Laplacian (1,048,576 rows) the full fp32 layout is 16,384 tiles,
// 64 MiB of values (3.2 cells per nonzero, 31 % of the slots live), and
// its bound 22.6 us at 3.35 TB/s.  float64 doubles the value bytes and
// the vectors: about 128 MiB of slab and 16 MiB of x and z, ~45 us
// (25.1 us on the float64 layout's 8,192 tiles).  complex64 moves 8 B per
// cell (an interleaved re/im float2) on the fp32 geometry: 151.3 MB over
// the full layout on the Laplacian, 45.2 us, and 75.6 MB on banded-11,
// 22.6 us; complex128 16 B per cell on the float64 geometry: 167.9 MB on
// the Laplacian (8,192 tiles), 50.1 us, and 147.4 MB on banded-11, 44.0 us
// (chip_smoke.py's counts).  A kernel that reads only the live slots is
// bound by their bytes (their values, r0 or tile words and tile bases,
// the slot list, x and z): 29.7 MB and 8.9 us for #3 on the Laplacian,
// 26.3 MB and 7.9 us on banded-11 (chip_smoke.py's whdia_bounds).
//
// Every SpMV of this file, #3, #6, #9 and #10, and the SpMM (entry
// whdia_spmm, kernel #13, which replaces _whdia_spmm_kernel, called
// through _whdia_spmm_call and whdia_spmm_pallas; fp32, both r0 modes,
// Z[r] = A x[r] for any n_rhs) reads only the live slots.  A tile pass
// (one block per tile over all 8 slots, one atomicAdd per lane into a
// zero-filled z: kernel #1's design without pages, which #6 and #10 ran
// before) reads every slot, and on the Laplacian only 31 % of the slots
// hold a nonzero (two tiles per hack, 4 and 1 of their 8 slots live;
// banded-11 67 %; the float64 4096^2 Laplacian, pattern mode, 20.8 %):
// the full slab's bound, 45.2 us for #9, is already above cuSPARSE CSR's
// time, and #13's dead slots cost 8 RHS x 512 B of x reads each.  The
// tile pass also pays two atomics per output element (two tiles per hack)
// into a zero-filled z.  WHDIA has no lane routing: lane j of a hack feeds only row
// hack*128 + j.  So each hack is summed over its live slots, from the
// layout's list (hack_slot_ptr, hack_slots), in list order, in registers,
// and each row is stored once with a plain store: no atomics, no zero
// fill, and the same bits from run to run.  Columns are int32: the
// launches refuse n_cols past INT32_MAX - 2^16, which bounds a cell's
// column base*128 + r0 + j (r0 is an int16, base*128 < n_cols + 128).
//
// The hack pass (#9, #13): one block per hack, one warp per 32-lane
// quarter.  Each warp reads the live slots' values, their r0 and tile
// words and x once per RHS, and sums in registers (kSpmmRhs = 8 floats
// per RHS block, a runtime remainder for any n_rhs, or one float2).  Live
// bounds: #9 about 59 MB on the Laplacian, 17.6 us; #13 for 8 RHS about
// 88 MB (Laplacian) and 56 MB (banded-11).
//
// The warp pass (#3 fp32, #6 float64, #10 complex128; warp_hack<T>):
// a hack is 128 / kVec threads, thread t of it owning lanes
// kVec*t .. kVec*t + kVec - 1 (its values and its row as 16-byte loads
// and stores), and a block of kThreads threads holds kThreads * kVec /
// 128 hacks.  Every warp of a hack walks the hack's list; each thread
// loads kBatch slots' values and guarded x entries before their FMAs, and
// the blocks' registers are capped by kBlocksPerSm resident blocks
// (WarpShape<T>).  In fp32 a warp moves only 128 B per slot and a
// Laplacian hack holds 5 live slots (2.5 KB of values), so a block per
// hack spends its time on the chain of dependent loads that precedes the
// first value (hack_slot_ptr, then hack_slots, then tile_page and r0) and
// on its own start, and 8,192 such blocks run in four waves.  #3 is one
// warp per hack (kVec = 4: one 16-byte value load per slot), 4 hacks a
// block, 2 slots in flight, in 32 registers, so 16 blocks, the whole
// Laplacian's 2,048, are resident at once and every warp's chain overlaps
// the others' streams; chosen among 22 shapes timed on the H100 (batches
// of 1 to 8 slots, 2 to 8 warps a block, 4 to 16 blocks an SM, strided
// lanes, and a derived per-slot column word, which cuts one link of the
// chain and gained little; PERF.md §6).  float64 and complex128 move 2x
// and 4x the bytes per cell through the same chain, so their shapes are
// their own, chosen among 18 each timed on the H100 (NVIDIA H100 80GB
// HBM3, 700 W), each built from this source with its WarpShape changed,
// in a sweep not kept (as #3's 22; PERF.md §6).  Shape V,B,N,M = lanes a
// thread, slots in flight, threads a block, blocks an SM; then registers
// / spilled bytes; then warm device time on the 1024^2 Laplacian (us),
// banded-11 (us) and the 4096^2 Laplacian (ms):
//   float64                               complex128
//   1,3,128,16 32/0    24.8 21.2 0.332    1,3,128,16 32/60   44.8 42.3 0.652
//   1,2,128,16 32/0    25.9 22.5 0.358    1,2,128,16 32/44   45.4 42.8 0.652
//   2,2,128,16 32/80   25.7 23.3 0.338    1,4,128,8  56/0    45.4 38.8 0.658
//   2,3,128,16 32/44   24.1 23.4 0.321    2,1,128,16 32/148  54.0 46.5 0.778
//   2,4,128,8  54/0    26.2 22.0 0.345   *2,2,128,8  56/0    43.4 38.8 0.619
//   4,1,128,16 32/184  29.0 24.4 0.403    2,3,128,8  64/92   43.9 40.4 0.633
//  *4,2,128,8  60/0    23.1 23.8 0.313    4,1,128,8  64/0    48.8 42.2 0.648
//   4,2,128,16 32/280  37.6 33.4 0.523    4,2,128,4  100/0   45.3 39.4 0.643
//   4,3,128,8  64/0    23.1 20.3 0.310    1,2,256,8  32/44   45.9 43.1 0.654
//   4,4,128,8  64/348  37.2 29.4 0.514    2,2,256,4  56/0    44.0 38.7 0.626
//   4,2,256,4  60/0    23.2 20.9 0.315    1,1,128,16 32/12   43.8 40.0 0.651
//   2,2,256,8  32/80   25.9 23.6 0.339    2,2,128,16 32/412 109.2 95.9 1.661
//   4,3,256,4  64/0    23.3 20.5 0.311    2,3,128,6  72/0    42.8 39.8 0.621
//   4,3,128,6  72/0    24.1 23.5 0.313    2,4,128,6  80/136  48.7 40.7 0.684
//   4,4,128,6  80/20   26.1 22.9 0.338    2,2,128,6  62/0    43.6 39.4 0.625
//   4,2,128,6  60/0    22.5 20.5 0.313    1,2,128,12 40/0    45.0 36.1 0.642
//   4,3,512,2  64/0    23.6 20.5 0.313    1,3,128,12 40/0    43.0 38.4 0.622
//   4,5,128,6  80/384  31.2 33.2 0.421    2,3,256,4  64/92   44.8 40.7 0.636
// (* the shapes kept; 1 lane a thread is the hack pass's shape, a block a
// hack.)  The shapes that spill nothing at 2 or 4 lanes a thread lie
// within 5 % of each other on the two Laplacians; the kept float64
// shape's banded-11 reading here (23.8 warm, 19.7 cold) is an outlier,
// 20.3 warm in chip_smoke.py's phase 29 of the same call.  A shape that
// spills is slower by up to 150 %.  #6 keeps one warp a hack (two
// 16-byte value loads a slot), 2 slots in flight, 8 blocks an SM; #10
// two warps a hack, 2 in flight, 8 blocks.
// Live bounds (whdia_bounds): #6 17.6 us on the 1024^2 Laplacian, 15.6 us
// on banded-11 and 0.282 ms on the 4096^2 Laplacian (against 25.1 us,
// 22.0 us and 1.043 ms for every slot); #10 35.1 us, 31.2 us and 0.563
// ms.
//
// A deviation of the live-slot kernels: a dead slot is not read, so an
// Inf or NaN in x at a column that only all-zero slots reference no
// longer gives NaN (the JAX kernel and the plain versions multiply every
// cell; for finite x they agree).
//
// Ablation (entries whdia_ablation and whdia_hack_ablation, kernel #18)
// replaces the `call` closure of doc/sweeps/whdia_ablation.py (its
// pallas_call body adds one op family of _whdia_kernel at a time, at the
// production geometry): the per-op account of #3 in fp32.  Two sets of
// levels, each a production body cut after one op family:
//  - the tile levels (whdia_tile, which whdia_tile_pass instantiates at
//    kFull: the tile pass above, in fp32): stream (the value slab, 4
//    B/cell), r0 (+ the r0 decode and the column), gather (+ the guarded x
//    read: the tile sum) and full (+ one atomicAdd per lane: the fp32 tile
//    pass).  Below full each lane's sum is stored to a (num_tiles, 128)
//    part array, 512 B per tile, the same in every level, so the
//    differences between levels price one family each.  The TPU's
//    sublane and lane gathers are one cached global load here, and its
//    dual-plane accumulate and flush one atomic: those TPU levels have no
//    separate counterpart.
//  - the hack levels, of #3's warp pass (warp_hack; whdia_spmv_warps is
//    its kHackFull) and, at 8 RHS, of #13's hack pass (hack_body;
//    whdia_hack_pass is its kHackFull): launch (each hack's list bounds,
//    its live-slot count stored in each row), list (+ the list entries,
//    their tile words and r0 and the column: each cell adds its key
//    (column + slot) & 127), stream (+ the live values: v * key) and full
//    (+ the guarded x gathers: the production launch).  Every level
//    stores each row once, as the production kernels do.
// A level's sum depends on every value it loads, so nvcc drops none.
// Bound: that of #3 on the same layout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kSlots = 8;
// The hack pass's shape: RHS per block of the SpMM's register sums, the
// slots whose loads a warp issues before their FMAs, and the resident
// blocks per SM, which cap the registers (16: 32 a thread, 8: 64).  Chosen
// from fourteen shapes timed on the H100 (PERF.md §6): the SpMV gains from
// full occupancy, the SpMM from four slots' loads in flight.
constexpr int kSpmmRhs = 8;
constexpr int kSpmvBatch = 3;
constexpr int kSpmmBatch = 4;
constexpr int kSpmvBlocksPerSm = 16;
constexpr int kSpmmBlocksPerSm = 8;
// The warp pass's shape for a value type: kVec lanes a thread (a hack is
// 128 / kVec threads), kBatch slots whose loads a thread issues before
// their FMAs, kThreads a block and kBlocksPerSm resident blocks, which cap
// the registers at 65,536 / (kThreads * kBlocksPerSm) a thread.  #3 (fp32):
// one warp per hack, 4 hacks a block, 16 blocks (32 registers, every warp
// slot of the SM filled); #6 (float64): one warp per hack, 8 blocks (64
// registers); #10 (complex128): two warps per hack, 8 blocks.
template <int V, int B, int N, int M>
struct Shape {
  static_assert(V == 1 || V == 2 || V == 4, "a hack is 1, 2 or 4 warps");
  static_assert(N % (kLanes / V) == 0, "whole hacks a block");
  static constexpr int kVec = V, kBatch = B, kThreads = N, kBlocksPerSm = M;
};
template <typename T> struct WarpShape;
template <> struct WarpShape<float> : Shape<4, 2, 128, 16> {};
template <> struct WarpShape<double> : Shape<4, 2, 128, 8> {};
template <> struct WarpShape<double2> : Shape<2, 2, 128, 8> {};
// The live-slot passes' int32 columns: base*128 + r0 + j stays below 2^31
// for n_cols up to this (base*128 < n_cols + 128, |r0| < 2^15)
constexpr int64_t kMaxCols = INT32_MAX - (1 << 16);

// sum + v*x: one FMA for a real type; four for a complex one, in the order
// re += vr*xr; re -= vi*xi; im += vr*xi; im += vi*xr
__device__ __forceinline__ float mac(float v, float x, float sum) {
  return fmaf(v, x, sum);
}

__device__ __forceinline__ double mac(double v, double x, double sum) {
  return fma(v, x, sum);
}

template <typename C>
__device__ __forceinline__ C cmac(C v, C x, C sum) {
  C out;
  out.x = mac(-v.y, x.y, mac(v.x, x.x, sum.x));
  out.y = mac(v.y, x.x, mac(v.x, x.y, sum.y));
  return out;
}

__device__ __forceinline__ float2 mac(float2 v, float2 x, float2 sum) {
  return cmac(v, x, sum);
}

__device__ __forceinline__ double2 mac(double2 v, double2 x, double2 sum) {
  return cmac(v, x, sum);
}

// p[0 .. kVec) where live, else zeros: 16-byte loads where the run is
// whole 16-byte words (p then 16 B aligned), else one load per element.
// Each load is predicated on live (a branch around the loads cost #3 a
// spilled register and 5 % on the H100)
template <typename T, int kVec>
__device__ __forceinline__ void load_lanes(const T* __restrict__ p, bool live,
                                           T (&v)[kVec]) {
  if constexpr (sizeof(T) * kVec % 16 == 0) {
    constexpr int kWords = sizeof(T) * kVec / 16;
    union { uint4 u[kWords]; T t[kVec]; } buf;
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      buf.u[i] = live ? __ldg(reinterpret_cast<const uint4*>(p) + i) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = buf.t[i];
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = live ? __ldg(p + i) : T{};
  }
}

// p[0 .. kVec) = v, as load_lanes reads it
template <typename T, int kVec>
__device__ __forceinline__ void store_lanes(T* __restrict__ p, const T (&v)[kVec]) {
  if constexpr (sizeof(T) * kVec % 16 == 0) {
    constexpr int kWords = sizeof(T) * kVec / 16;
    union { uint4 u[kWords]; T t[kVec]; } buf;
#pragma unroll
    for (int i = 0; i < kVec; ++i) buf.t[i] = v[i];
#pragma unroll
    for (int i = 0; i < kWords; ++i) reinterpret_cast<uint4*>(p)[i] = buf.u[i];
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) p[i] = v[i];
  }
}

// r0 of slot s of tile t: its slab entry, or (pattern mode) the tile's
// word as _whdia_tile_r0 unpacks it (mask, logical shift, bias):
// r00 + step*min(s, F-1)
template <bool kPattern>
__device__ __forceinline__ int slot_r0_of(const int16_t* __restrict__ slot_r0,
                                          const int32_t* __restrict__ tile_r0,
                                          int64_t t, int s) {
  if constexpr (kPattern) {
    const uint32_t w = static_cast<uint32_t>(tile_r0[t]);
    const int r00 = static_cast<int>(w & 0xFFFFu) - 1024;
    const int f1 = static_cast<int>((w >> 16) & 0x7u);
    const int step = static_cast<int>((w >> 19) & 0x1FFFu) - 4096;
    return r00 + step * min(s, f1);
  } else {
    return slot_r0[t * kSlots + s];
  }
}

// The op families of the tile pass, added one at a time (kernel #18's
// tile levels): kStream reads the values only, kR0 adds the r0 decode and
// the column, kGather the guarded x read (the tile sum), kFull the
// atomicAdd into the hack row.  Below kFull the lane's sum goes to z[t, j]
// with a plain store (z is then the (num_tiles, 128) part array).
enum Level : int { kStream = 0, kR0 = 1, kGather = 2, kFull = 3 };

// The op families of the live-slot passes, added one at a time (kernel
// #18's hack levels): kLaunch reads the hack's list bounds and stores its
// live-slot count in each row, kList adds the list entries, their tile
// words and r0 and the column (each cell adds its key (column + slot) &
// 127), kValues the live values (v * key), kHackFull the guarded x
// gathers (the product).  Every level stores each row once.
enum HackLevel : int { kLaunch = 0, kList = 1, kValues = 2, kHackFull = 3 };

// The fp32 tile pass (kernel #18's tile levels): one 128-thread block per
// tile; thread j reads its lane of the 8 slots (coalesced), gathers x at
// the slot's contiguous shifted run, sums in a register and (kFull) adds
// the sum into the zeroed row hack*128 + j with one atomicAdd.
template <bool kPattern, int kLevel>
__device__ __forceinline__ void whdia_tile(const float* __restrict__ values,
                                           const int16_t* __restrict__ slot_r0,
                                           const int32_t* __restrict__ tile_r0,
                                           const int32_t* __restrict__ tile_base,
                                           const int32_t* __restrict__ tile_page,
                                           const int32_t* __restrict__ chunk_group,
                                           const float* __restrict__ x,
                                           float* __restrict__ z, int64_t n_cols,
                                           int chunk_tiles, int group_hacks) {
  const int64_t t = blockIdx.x;
  const int j = threadIdx.x;
  float sum = 0.f;
  if constexpr (kLevel == kStream) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      sum = fmaf(__ldg(values + (t * kSlots + s) * kLanes + j), 1.5f, sum);
    z[t * kLanes + j] = sum;
  } else {
    const int64_t c0 = static_cast<int64_t>(tile_page[t]) * kLanes + j;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int64_t slot = t * kSlots + s;
      const int64_t c = c0 + slot_r0_of<kPattern>(slot_r0, tile_r0, t, s);
      const float v = __ldg(values + slot * kLanes + j);
      if constexpr (kLevel == kR0)  // keeps the column live: v * (c & 127)
        sum = fmaf(v, static_cast<float>(c & (kLanes - 1)), sum);
      else if (c >= 0 && c < n_cols)
        sum = fmaf(v, __ldg(x + c), sum);
    }
    if constexpr (kLevel == kFull) {
      const uint32_t hh = static_cast<uint32_t>(tile_base[t]) >> 16;
      const int64_t hack =
          static_cast<int64_t>(chunk_group[t / chunk_tiles]) * group_hacks + hh;
      atomicAdd(z + hack * kLanes + j, sum);
    } else {
      z[t * kLanes + j] = sum;
    }
  }
}

template <bool kPattern>
__global__ void __launch_bounds__(kLanes)
whdia_tile_pass(const float* __restrict__ values,
                const int16_t* __restrict__ slot_r0,
                const int32_t* __restrict__ tile_r0,
                const int32_t* __restrict__ tile_base,
                const int32_t* __restrict__ tile_page,
                const int32_t* __restrict__ chunk_group,
                const float* __restrict__ x, float* __restrict__ z,
                int64_t n_cols, int chunk_tiles, int group_hacks) {
  whdia_tile<kPattern, kFull>(values, slot_r0, tile_r0, tile_base, tile_page,
                              chunk_group, x, z, n_cols, chunk_tiles, group_hacks);
}

// kernel #18's tile levels below kFull, fp32: the tile pass cut after one
// op family, its lane sums stored to part (num_tiles, 128)
template <bool kPattern, int kLevel>
__global__ void __launch_bounds__(kLanes)
whdia_ablation_pass(const float* __restrict__ values,
                    const int16_t* __restrict__ slot_r0,
                    const int32_t* __restrict__ tile_r0,
                    const int32_t* __restrict__ tile_base,
                    const int32_t* __restrict__ tile_page,
                    const int32_t* __restrict__ chunk_group,
                    const float* __restrict__ x, float* __restrict__ part,
                    int64_t n_cols, int chunk_tiles, int group_hacks) {
  whdia_tile<kPattern, kLevel>(values, slot_r0, tile_r0, tile_base, tile_page,
                               chunk_group, x, part, n_cols, chunk_tiles, group_hacks);
}

// The hack pass (kernel #9, complex64 SpMV, kRhs = 1; kernel #13, fp32
// SpMM, kRhs = 8) at kHackFull, and #18's 8-RHS hack levels below it: one
// block of 128 threads per hack, four warps, one per 32-lane quarter,
// with no block barrier.  Each warp walks the hack's live slots
// (hack_slots[hack_slot_ptr[hack] .. hack_slot_ptr[hack + 1]]) in list
// order, warp-uniformly: lane k of the warp decodes list entry k of each
// run of 32 (its slot id and first column base*128 + r0), and the warp
// takes them in turn by shuffles.  For a batch of kBatch slots it loads
// the lane's cells and the guarded x entries of every RHS of the block
// before the FMAs; sums stay in registers, and each (RHS, lane) gets one
// plain store of its row, zeros for a hack with no live slot.
template <typename T, bool kPattern, int kRhs, int kLevel>
__device__ __forceinline__ void hack_body(const T* __restrict__ values,
                                          const int16_t* __restrict__ slot_r0,
                                          const int32_t* __restrict__ tile_r0,
                                          const int32_t* __restrict__ tile_page,
                                          const int32_t* __restrict__ hack_slot_ptr,
                                          const int32_t* __restrict__ hack_slots,
                                          const T* __restrict__ x, T* __restrict__ z,
                                          int n_cols, int64_t z_rows, int n_rhs) {
  constexpr int kBatch = kRhs == 1 ? kSpmvBatch : kSpmmBatch;
  const int64_t hack = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int begin = __ldg(hack_slot_ptr + hack);
  const int end = __ldg(hack_slot_ptr + hack + 1);
  for (int rb = 0; rb < n_rhs; rb += kRhs) {
    const int w = min(kRhs, n_rhs - rb);
    const T* xr = x + static_cast<int64_t>(rb) * n_cols;
    T sum[kRhs];
#pragma unroll
    for (int q = 0; q < kRhs; ++q) sum[q] = T{};
    if constexpr (kLevel == kLaunch) {
#pragma unroll
      for (int q = 0; q < kRhs; ++q) sum[q] = T(end - begin);
    }
    for (int p = begin; kLevel != kLaunch && p < end; p += 32) {
      const int n = min(32, end - p);
      int sid = 0, col0 = 0;
      if (lane < n) {
        sid = __ldg(hack_slots + p + lane);
        const int t = sid >> 3;
        col0 = __ldg(tile_page + t) * kLanes +
               slot_r0_of<kPattern>(slot_r0, tile_r0, t, sid & (kSlots - 1));
      }
      for (int k = 0; k < n; k += kBatch) {
        T v[kBatch];
        T xv[kBatch][kRhs];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int s = __shfl_sync(0xFFFFFFFFu, sid, (k + b) & 31);
          const int c = __shfl_sync(0xFFFFFFFFu, col0, (k + b) & 31) + j;
          const bool live = k + b < n;
          if constexpr (kLevel == kHackFull) {
            const bool in = live && static_cast<unsigned>(c) < static_cast<unsigned>(n_cols);
            v[b] = live ? __ldg(values + static_cast<int64_t>(s) * kLanes + j) : T{};
#pragma unroll
            for (int q = 0; q < kRhs; ++q)
              xv[b][q] = in && q < w ? __ldg(xr + static_cast<int64_t>(q) * n_cols + c) : T{};
          } else {  // the cell's key stands in for x
            v[b] = kLevel == kList ? T(1)
                   : live          ? __ldg(values + static_cast<int64_t>(s) * kLanes + j)
                                   : T{};
#pragma unroll
            for (int q = 0; q < kRhs; ++q) xv[b][q] = T((c + s) & (kLanes - 1));
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (k + b < n) {
#pragma unroll
            for (int q = 0; q < kRhs; ++q) sum[q] = mac(v[b], xv[b][q], sum[q]);
          }
        }
      }
    }
    T* out = z + static_cast<int64_t>(rb) * z_rows + hack * kLanes + j;
#pragma unroll
    for (int q = 0; q < kRhs; ++q)
      if (q < w) out[q * z_rows] = sum[q];
  }
}

template <typename T, bool kPattern, int kRhs>
__global__ void __launch_bounds__(kLanes, kRhs == 1 ? kSpmvBlocksPerSm : kSpmmBlocksPerSm)
whdia_hack_pass(const T* __restrict__ values,
                const int16_t* __restrict__ slot_r0,
                const int32_t* __restrict__ tile_r0,
                const int32_t* __restrict__ tile_page,
                const int32_t* __restrict__ hack_slot_ptr,
                const int32_t* __restrict__ hack_slots,
                const T* __restrict__ x, T* __restrict__ z,
                int n_cols, int64_t z_rows, int n_rhs) {
  hack_body<T, kPattern, kRhs, kHackFull>(values, slot_r0, tile_r0, tile_page,
                                          hack_slot_ptr, hack_slots, x, z, n_cols,
                                          z_rows, n_rhs);
}

// kernel #18's hack levels below kHackFull at 8 RHS: #13's hack pass cut
// after one op family
template <bool kPattern, int kLevel>
__global__ void __launch_bounds__(kLanes, kSpmmBlocksPerSm)
whdia_hack_ablation(const float* __restrict__ values,
                    const int16_t* __restrict__ slot_r0,
                    const int32_t* __restrict__ tile_r0,
                    const int32_t* __restrict__ tile_page,
                    const int32_t* __restrict__ hack_slot_ptr,
                    const int32_t* __restrict__ hack_slots,
                    const float* __restrict__ x, float* __restrict__ z,
                    int n_cols, int64_t z_rows, int n_rhs) {
  hack_body<float, kPattern, kSpmmRhs, kLevel>(values, slot_r0, tile_r0, tile_page,
                                               hack_slot_ptr, hack_slots, x, z, n_cols,
                                               z_rows, n_rhs);
}

// The warp pass (kernel #3 fp32, #6 float64, #10 complex128) at
// kHackFull, and #18's 1-RHS hack levels below it (fp32): the kHackThreads
// = 128 / kVec threads h*kHackThreads .. of a block sum hack
// blockIdx.x * kThreads / kHackThreads + h over its live slots in list
// order, each warp warp-uniformly, as the hack pass does (lane k decodes
// list entry k of each run of 32, the warp takes them in turn by
// shuffles), thread t of the hack owning lanes kVec*t .. kVec*t + kVec - 1:
// per slot kVec values (16-byte loads) and kVec guarded x reads, kBatch
// slots loaded before their FMAs, kVec register sums, one store of the
// thread's kVec rows (zeros for a hack with no live slot).
template <typename T, bool kPattern, int kLevel>
__device__ __forceinline__ void warp_hack(const T* __restrict__ values,
                                          const int16_t* __restrict__ slot_r0,
                                          const int32_t* __restrict__ tile_r0,
                                          const int32_t* __restrict__ tile_page,
                                          const int32_t* __restrict__ hack_slot_ptr,
                                          const int32_t* __restrict__ hack_slots,
                                          const T* __restrict__ x, T* __restrict__ z,
                                          int n_cols, int num_hacks) {
  using S = WarpShape<T>;
  constexpr int kVec = S::kVec, kBatch = S::kBatch, kHackThreads = kLanes / kVec;
  const int lane = threadIdx.x & 31;
  const int hack = blockIdx.x * (S::kThreads / kHackThreads) + threadIdx.x / kHackThreads;
  if (hack >= num_hacks) return;  // uniform over each warp
  const int j0 = threadIdx.x % kHackThreads * kVec;  // the thread's first lane
  const int begin = __ldg(hack_slot_ptr + hack);
  const int end = __ldg(hack_slot_ptr + hack + 1);
  T acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = T{};
  if constexpr (kLevel == kLaunch) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = T(end - begin);
  }
  for (int p = begin; kLevel != kLaunch && p < end; p += 32) {
    const int n = min(32, end - p);
    int sid = 0, col0 = 0;
    if (lane < n) {
      sid = __ldg(hack_slots + p + lane);
      const int t = sid >> 3;
      col0 = __ldg(tile_page + t) * kLanes +
             slot_r0_of<kPattern>(slot_r0, tile_r0, t, sid & (kSlots - 1));
    }
    for (int k = 0; k < n; k += kBatch) {
      T v[kBatch][kVec], xv[kBatch][kVec];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int s = __shfl_sync(0xFFFFFFFFu, sid, (k + b) & 31);
        const int c = __shfl_sync(0xFFFFFFFFu, col0, (k + b) & 31) + j0;
        const bool live = k + b < n;
        if constexpr (kLevel == kList) {  // no values
#pragma unroll
          for (int i = 0; i < kVec; ++i) v[b][i] = T(1);
        } else {
          load_lanes<T, kVec>(values + static_cast<int64_t>(s) * kLanes + j0, live, v[b]);
        }
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          if constexpr (kLevel == kHackFull)
            xv[b][i] = live && static_cast<unsigned>(c + i) < static_cast<unsigned>(n_cols)
                           ? __ldg(x + c + i) : T{};
          else  // the cell's key stands in for x
            xv[b][i] = T((c + i + s) & (kLanes - 1));
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (k + b < n)
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[i] = mac(v[b][i], xv[b][i], acc[i]);
    }
  }
  store_lanes<T, kVec>(z + static_cast<int64_t>(hack) * kLanes + j0, acc);
}

template <typename T, bool kPattern>
__global__ void __launch_bounds__(WarpShape<T>::kThreads, WarpShape<T>::kBlocksPerSm)
whdia_spmv_warps(const T* __restrict__ values,
                 const int16_t* __restrict__ slot_r0,
                 const int32_t* __restrict__ tile_r0,
                 const int32_t* __restrict__ tile_page,
                 const int32_t* __restrict__ hack_slot_ptr,
                 const int32_t* __restrict__ hack_slots,
                 const T* __restrict__ x, T* __restrict__ z,
                 int n_cols, int num_hacks) {
  warp_hack<T, kPattern, kHackFull>(values, slot_r0, tile_r0, tile_page, hack_slot_ptr,
                                    hack_slots, x, z, n_cols, num_hacks);
}

// kernel #18's hack levels below kHackFull at 1 RHS: #3's warp pass cut
// after one op family
template <bool kPattern, int kLevel>
__global__ void __launch_bounds__(WarpShape<float>::kThreads,
                                  WarpShape<float>::kBlocksPerSm)
whdia_warps_ablation(const float* __restrict__ values,
                     const int16_t* __restrict__ slot_r0,
                     const int32_t* __restrict__ tile_r0,
                     const int32_t* __restrict__ tile_page,
                     const int32_t* __restrict__ hack_slot_ptr,
                     const int32_t* __restrict__ hack_slots,
                     const float* __restrict__ x, float* __restrict__ z,
                     int n_cols, int num_hacks) {
  warp_hack<float, kPattern, kLevel>(values, slot_r0, tile_r0, tile_page, hack_slot_ptr,
                                     hack_slots, x, z, n_cols, num_hacks);
}

// the fp32 tile pass (#18's tile level kFull)
int launch_tiles(const void* values, const void* slot_r0, const void* tile_r0,
                 const void* tile_base, const void* tile_page, const void* chunk_group,
                 const void* x, void* z, int64_t num_tiles, int64_t n_cols,
                 int chunk_tiles, int group_hacks, void* stream) {
  if (num_tiles > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(static_cast<unsigned>(num_tiles));
    auto* v = static_cast<const float*>(values);
    auto* sr = static_cast<const int16_t*>(slot_r0);
    auto* tr = static_cast<const int32_t*>(tile_r0);
    auto* tb = static_cast<const int32_t*>(tile_base);
    auto* tp = static_cast<const int32_t*>(tile_page);
    auto* cg = static_cast<const int32_t*>(chunk_group);
    auto* xt = static_cast<const float*>(x);
    auto* zt = static_cast<float*>(z);
    if (tr != nullptr)
      whdia_tile_pass<true><<<grid, kLanes, 0, st>>>(
          v, sr, tr, tb, tp, cg, xt, zt, n_cols, chunk_tiles, group_hacks);
    else
      whdia_tile_pass<false><<<grid, kLanes, 0, st>>>(
          v, sr, tr, tb, tp, cg, xt, zt, n_cols, chunk_tiles, group_hacks);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kLevel>
void launch_ablation(const float* v, const int16_t* sr, const int32_t* tr,
                     const int32_t* tb, const int32_t* tp, const int32_t* cg,
                     const float* x, float* part, int64_t num_tiles, int64_t n_cols,
                     int chunk_tiles, int group_hacks, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(num_tiles));
  if (tr != nullptr)
    whdia_ablation_pass<true, kLevel><<<grid, kLanes, 0, st>>>(
        v, sr, tr, tb, tp, cg, x, part, n_cols, chunk_tiles, group_hacks);
  else
    whdia_ablation_pass<false, kLevel><<<grid, kLanes, 0, st>>>(
        v, sr, tr, tb, tp, cg, x, part, n_cols, chunk_tiles, group_hacks);
}

// the hack pass (#9, #13) at kHackFull; #18's 8-RHS hack levels below
template <typename T, int kRhs, int kLevel = kHackFull>
int launch_hacks(const void* values, const void* slot_r0, const void* tile_r0,
                 const void* tile_page, const void* hack_slot_ptr,
                 const void* hack_slots, const void* x, void* z,
                 int64_t num_hacks, int64_t n_cols, int64_t z_rows, int n_rhs,
                 void* stream) {
  if (n_cols > kMaxCols || num_hacks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_hacks > 0 && n_rhs > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(static_cast<unsigned>(num_hacks));
    auto* v = static_cast<const T*>(values);
    auto* sr = static_cast<const int16_t*>(slot_r0);
    auto* tr = static_cast<const int32_t*>(tile_r0);
    auto* tp = static_cast<const int32_t*>(tile_page);
    auto* hp = static_cast<const int32_t*>(hack_slot_ptr);
    auto* hs = static_cast<const int32_t*>(hack_slots);
    auto* xt = static_cast<const T*>(x);
    auto* zt = static_cast<T*>(z);
    const int nc = static_cast<int>(n_cols);
    if constexpr (kLevel == kHackFull) {
      if (tr != nullptr)
        whdia_hack_pass<T, true, kRhs><<<grid, kLanes, 0, st>>>(
            v, sr, tr, tp, hp, hs, xt, zt, nc, z_rows, n_rhs);
      else
        whdia_hack_pass<T, false, kRhs><<<grid, kLanes, 0, st>>>(
            v, sr, tr, tp, hp, hs, xt, zt, nc, z_rows, n_rhs);
    } else if (tr != nullptr) {
      whdia_hack_ablation<true, kLevel><<<grid, kLanes, 0, st>>>(
          v, sr, tr, tp, hp, hs, xt, zt, nc, z_rows, n_rhs);
    } else {
      whdia_hack_ablation<false, kLevel><<<grid, kLanes, 0, st>>>(
          v, sr, tr, tp, hp, hs, xt, zt, nc, z_rows, n_rhs);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// the warp pass (#3, #6, #10) at kHackFull; #18's 1-RHS hack levels below
// (fp32)
template <typename T, int kLevel = kHackFull>
int launch_warps(const void* values, const void* slot_r0, const void* tile_r0,
                 const void* tile_page, const void* hack_slot_ptr,
                 const void* hack_slots, const void* x, void* z,
                 int64_t num_hacks, int64_t n_cols, void* stream) {
  if (n_cols > kMaxCols || num_hacks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_hacks > 0) {
    using S = WarpShape<T>;
    constexpr int kHacks = S::kThreads * S::kVec / kLanes;  // hacks a block
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(static_cast<unsigned>((num_hacks + kHacks - 1) / kHacks));
    auto* v = static_cast<const T*>(values);
    auto* sr = static_cast<const int16_t*>(slot_r0);
    auto* tr = static_cast<const int32_t*>(tile_r0);
    auto* tp = static_cast<const int32_t*>(tile_page);
    auto* hp = static_cast<const int32_t*>(hack_slot_ptr);
    auto* hs = static_cast<const int32_t*>(hack_slots);
    auto* xt = static_cast<const T*>(x);
    auto* zt = static_cast<T*>(z);
    const int nc = static_cast<int>(n_cols), nh = static_cast<int>(num_hacks);
    constexpr int kThreads = S::kThreads;
    if constexpr (kLevel == kHackFull) {
      if (tr != nullptr)
        whdia_spmv_warps<T, true><<<grid, kThreads, 0, st>>>(v, sr, tr, tp, hp, hs, xt, zt,
                                                             nc, nh);
      else
        whdia_spmv_warps<T, false><<<grid, kThreads, 0, st>>>(v, sr, tr, tp, hp, hs, xt, zt,
                                                              nc, nh);
    } else if (tr != nullptr) {
      whdia_warps_ablation<true, kLevel><<<grid, kThreads, 0, st>>>(
          v, sr, tr, tp, hp, hs, xt, zt, nc, nh);
    } else {
      whdia_warps_ablation<false, kLevel><<<grid, kThreads, 0, st>>>(
          v, sr, tr, tp, hp, hs, xt, zt, nc, nh);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kernel #18's tile levels, fp32, either r0 mode: level 0 (stream), 1
// (r0) or 2 (gather) writes every lane sum of the cut tile pass to out
// (num_tiles x 128); level 3 (full) is the fp32 tile pass (one atomicAdd
// per lane), out then the zeroed z.  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError()
// (cudaErrorInvalidValue for another level).
int whdia_ablation(int level, const void* values, const void* slot_r0,
                   const void* tile_r0, const void* tile_base, const void* tile_page,
                   const void* chunk_group, const void* x, void* out,
                   int64_t num_tiles, int64_t n_cols, int chunk_tiles,
                   int group_hacks, void* stream) {
  if (level == kFull)
    return launch_tiles(values, slot_r0, tile_r0, tile_base, tile_page, chunk_group,
                        x, out, num_tiles, n_cols, chunk_tiles, group_hacks, stream);
  if (level < kStream || level > kFull)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles > 0) {
    auto* fn = level == kStream ? launch_ablation<kStream>
               : level == kR0   ? launch_ablation<kR0>
                                : launch_ablation<kGather>;
    fn(static_cast<const float*>(values), static_cast<const int16_t*>(slot_r0),
       static_cast<const int32_t*>(tile_r0), static_cast<const int32_t*>(tile_base),
       static_cast<const int32_t*>(tile_page), static_cast<const int32_t*>(chunk_group),
       static_cast<const float*>(x),
       static_cast<float*>(out), num_tiles, n_cols, chunk_tiles, group_hacks,
       static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel #18's hack levels, fp32, either r0 mode, over the live-slot list
// as whdia_spmv: level 0 (launch), 1 (list), 2 (stream) or 3 (full) of
// #3's warp pass (spmm 0; x (n_cols), out (num_hacks*128)) or of #13's
// hack pass (spmm 1; x (n_rhs x n_cols), out (n_rhs x z_rows)); level 3
// is the production launch (whdia_spmv, whdia_spmm).  Every row of out is
// written.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for another level).
int whdia_hack_ablation(int level, int spmm, const void* values,
                        const void* slot_r0, const void* tile_r0,
                        const void* tile_page, const void* hack_slot_ptr,
                        const void* hack_slots, const void* x, void* out,
                        int64_t num_hacks, int64_t n_cols, int64_t z_rows,
                        int n_rhs, void* stream) {
  if (level < kLaunch || level > kHackFull)
    return static_cast<int>(cudaErrorInvalidValue);
  if (spmm) {
    auto* fn = level == kLaunch  ? launch_hacks<float, kSpmmRhs, kLaunch>
               : level == kList  ? launch_hacks<float, kSpmmRhs, kList>
               : level == kValues ? launch_hacks<float, kSpmmRhs, kValues>
                                  : launch_hacks<float, kSpmmRhs, kHackFull>;
    return fn(values, slot_r0, tile_r0, tile_page, hack_slot_ptr, hack_slots, x, out,
              num_hacks, n_cols, z_rows, n_rhs, stream);
  }
  auto* fn = level == kLaunch  ? launch_warps<float, kLaunch>
             : level == kList  ? launch_warps<float, kList>
             : level == kValues ? launch_warps<float, kValues>
                                : launch_warps<float, kHackFull>;
  return fn(values, slot_r0, tile_r0, tile_page, hack_slot_ptr, hack_slots, x, out,
            num_hacks, n_cols, stream);
}

// Kernel #3: z (num_hacks*128; every row written, no zero fill needed) =
// the WHDIA product of the fp32 slab (16 B aligned) and x (n_cols), over
// the live slots of each hack (hack_slot_ptr, num_hacks + 1, and
// hack_slots, int32, as WhdiaMatrix.hack_slot_list builds them); r0 from
// exactly one of slot_r0 (slab mode) and tile_r0 (pattern mode).
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue past kMaxCols columns or 2^31
// hacks).
int whdia_spmv(const void* values, const void* slot_r0, const void* tile_r0,
               const void* tile_page, const void* hack_slot_ptr,
               const void* hack_slots, const void* x, void* z,
               int64_t num_hacks, int64_t n_cols, void* stream) {
  return launch_warps<float>(values, slot_r0, tile_r0, tile_page, hack_slot_ptr,
                             hack_slots, x, z, num_hacks, n_cols, stream);
}

// Kernels #6 and #10: z (num_hacks*128; every row written) = the WHDIA
// product of the float64 slab (16 B aligned) or the complex128 one
// (interleaved re/im) and x (n_cols) of the same type, over the live slots
// of each hack as in whdia_spmv (the warp pass at WarpShape<double> and
// WarpShape<double2>).  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (cudaErrorInvalidValue past kMaxCols columns
// or 2^31 hacks).
int whdia_spmv_f64(const void* values, const void* slot_r0, const void* tile_r0,
                   const void* tile_page, const void* hack_slot_ptr,
                   const void* hack_slots, const void* x, void* z,
                   int64_t num_hacks, int64_t n_cols, void* stream) {
  return launch_warps<double>(values, slot_r0, tile_r0, tile_page, hack_slot_ptr,
                              hack_slots, x, z, num_hacks, n_cols, stream);
}

int whdia_spmv_c128(const void* values, const void* slot_r0, const void* tile_r0,
                    const void* tile_page, const void* hack_slot_ptr,
                    const void* hack_slots, const void* x, void* z,
                    int64_t num_hacks, int64_t n_cols, void* stream) {
  return launch_warps<double2>(values, slot_r0, tile_r0, tile_page, hack_slot_ptr,
                               hack_slots, x, z, num_hacks, n_cols, stream);
}

// Kernel #9: z (num_hacks*128; every row written) = the WHDIA product of
// the complex64 slab (interleaved re/im) and x (n_cols), over the live
// slots of each hack as in whdia_spmv.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (cudaErrorInvalidValue past
// kMaxCols columns or 2^31 hacks).
int whdia_spmv_c64(const void* values, const void* slot_r0, const void* tile_r0,
                   const void* tile_page, const void* hack_slot_ptr,
                   const void* hack_slots, const void* x, void* z,
                   int64_t num_hacks, int64_t n_cols, void* stream) {
  return launch_hacks<float2, 1>(values, slot_r0, tile_r0, tile_page,
                                 hack_slot_ptr, hack_slots, x, z, num_hacks,
                                 n_cols, 0, 1, stream);
}

// Kernel #13: z (n_rhs x z_rows, z_rows >= num_hacks*128; rows below
// num_hacks*128 all written) = the WHDIA product with each row of x
// (n_rhs x n_cols), fp32, over the live slots of each hack as in
// whdia_spmv.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
int whdia_spmm(const void* values, const void* slot_r0, const void* tile_r0,
               const void* tile_page, const void* hack_slot_ptr,
               const void* hack_slots, const void* x, void* z,
               int64_t num_hacks, int64_t n_cols, int64_t z_rows, int n_rhs,
               void* stream) {
  return launch_hacks<float, kSpmmRhs>(values, slot_r0, tile_r0, tile_page,
                                   hack_slot_ptr, hack_slots, x, z, num_hacks,
                                   n_cols, z_rows, n_rhs, stream);
}

}  // extern "C"
