// Packed-lane WHELL SpMV on Hopper (sm_90a), with a plain C interface
// for ctypes.
//
// Replaces spgpu_tpu/ops/pallas_kernels.py::_whell_packed_kernel (called
// through _whell_packed_call and whell_spmv_pallas; entry whell_packed_spmv,
// fp32 or bf16 values, fp32 x and sums) and _whell_packed_dd_kernel
// (_whell_packed_dd_call, whell_spmv_dd_pallas; entry whell_packed_spmv_f64,
// float64 values, x and sums, where the TPU kernel emulates them with
// double-float pairs), and _whell_packed_cplx_kernel (_whell_packed_cplx_call,
// whell_spmv_cplx_pallas; entry whell_packed_spmv_c64, complex64 values, x
// and sums).  Entry whell_packed_spmv_c128 is the complex128 product, which
// the JAX package runs as four double-float plane products of
// _whell_packed_dd_kernel (spgpu_tpu/ops/__init__.py, whell_spmv on a
// WhellComplex); it has no Pallas kernel of its own.  It computes the same
// product on the same layout arrays (spgpu_tpu_torch/formats/whell.py):
//
//   for every cell (slot s, lane j) of tile t = s / 8:
//     r = residue[s, j];  d = page_tab[s, r]        (indexed by residue)
//     scattered: g = tile_base[t] & 0xFFFFF, hh = tile_base[t] >> 20,
//                page = group_bases[g*K + (d >> 3)] + (d & 7)
//     aligned:   page = (tile_base[t] & 0xFFFF) + d, hh = tile_base[t] >> 16
//     hack = chunk_group[t / chunk_tiles] * group_hacks + hh
//     acc[hack, j] += T(values[s, j]) * x[page*128 + r]
//       (T = float, double, or the complex float2 / double2)
//   then per hack row, with p the inclusive lane prefix sum of acc[hack, :]:
//     z[hack, o] = (hi >= 0 ? p[hi] : 0) - (lo >= 0 ? p[lo] : 0)
//   or, with unit segments, z[hack, o] = hi >= 0 ? acc[hack, hi] : 0.
//
// Bound on the H100: the slabs stream once per product at 6 B/cell for
// fp32 values (4 B value + int8 residue + int8 page entry; 4 B/cell for
// bf16), about 67 MiB per product on the flagship FEM matrix against
// 3.35 TB/s of HBM, i.e. ~21 us at best.  x (1.4 MB there) and the
// accumulator (1.6 MB) stay resident in the 50 MB L2.  float64 streams
// 10 B/cell (8 B value + the two index bytes): on the flagship 15,168
// tiles (155 MB) with aligned 32-page windows, 10,944 (112 MB) with
// scattered ones.  complex64 streams 10 B/cell (an interleaved re/im float2
// and the two index bytes) on the fp32 geometry: on the flagship 11,392
// tiles (11.7M cells, 111 MiB of slab), 123.0 MB with x and z, a bound of
// 36.7 us; complex128 18 B/cell (a double2): 15,168 tiles (280 MB) aligned,
// 10,944 (202 MB) scattered (chip_smoke.py's counts on an NVIDIA H100
// 80GB HBM3, 700 W).  x (4.2 MB in complex128) stays resident in L2.
// fp64 FMA is native on Hopper, so there are no error-free transforms.
//
// #1 and #7 (fp32, bf16, complex64): the TPU kernel stages x in VMEM and
// resolves pages with sublane gathers, select trees and dual accumulator
// planes; none of that is needed here.  x is read straight from global
// memory through L2/L1, so each cell costs one coalesced slab read plus
// one cached gather.  Tile pass: one 128-thread block per tile; the
// tile's 8x128 page table goes to shared memory for the by-residue
// lookup, each thread sums its lane over the 8 slots in a register and
// issues one atomicAdd into the (hack, lane) accumulator.  Flush pass:
// one block per hack row, a warp-shuffle inclusive scan over the 128
// lanes, then the segment difference.  Atomic order varies, so results
// are not bit-reproducible (rounding in T only).  The difference of two
// prefix sums carries an error of the order of eps(T) times the hack's
// prefix total, not of the row's own sum: a light row behind a heavy one
// in the same hack has a larger relative error (fp64: ~1e-16 of the
// prefix, which the double-float TPU kernel matches at ~2^-48).
//
// #4 and complex128 (whell_hack_pass): one launch per product, no
// accumulator, no atomics on the lanes, bit-reproducible.  The converter
// places each hack's tiles in one contiguous run of the slab (its layout
// groups are keyed hack first), so the layout's hack_ptr (formats/whell.py)
// gives each hack its run, and each output group's trailing ct-padding
// tiles belong to no run and are never read.  One 128-thread block owns
// one hack row, thread j lane j, when the run has at most 16 tiles (every
// hack of the flagship: 4-8); a longer run (the hub rows of the flagship's
// SPD form: 75-83 tiles, which one block took 80 us to walk) is cut into
// 16-tile chunks of work units (hack_units), one block each, and the
// block whose atomicAdd on the row's counter is the k-th adds the k
// chunks' sums in chunk order and scans.  Thread 0 keeps kStages = 4
// tiles of the run in flight in a ring of shared-memory stages, each
// tile's residue and page table (2 KiB) brought by the TMA's 1-D bulk
// copies onto one mbarrier per stage; each thread streams its 8 values of a tile straight from
// global memory (evict-first loads) and reads the tile's word and its
// superpage bases while the copies fly.  It decodes its 8 cells from
// shared memory, issues their 8 x gathers together, and adds the
// products to one register sum, tile by tile and slot by slot; then the
// block scans the 128 sums (the flush's warp-shuffle scan, segment_sum)
// and stores z.  A stage is refilled once all 128 threads have arrived on
// its second mbarrier, each after a fence.proxy.async: the arrive orders
// the threads' reads of the stage for the generic proxy only, and without
// the fence a refill overwrote stages still being read (float64 sums
// went wrong from run to run on the H100).  What bounds it is bytes: the
// run's slab once, x from L2, z once.  The design takes away what the
// tile pass and flush add to those bytes: the accumulator's zero fill,
// one atomic per lane and tile (two in complex128) and a second launch
// that reads the accumulator back (the flush: 27-31 % of #4 on the
// dd-Laplacian in kernel #19's account of the tile pass).  A hack with no
// tiles stores zeros.  Measured on the H100 and not kept: the values in
// the ring too (10-18 KiB stages: 2-3 stages ran 12-25 % slower on the
// flagship, more stages slower still, with the L1 that the x gathers use
// given over to shared memory), 2 and 8 index stages (no better than 4),
// and loading the next tile's values during the current tile's FMAs
// (faster on scattered float64, slower on aligned and on the Laplacian).

// Complex: a cell is one aligned float2 / double2 value, x one more.  Each
// thread keeps re and im sums and adds four FMAs per cell, in this order:
// re += vr*xr; re -= vi*xi; im += vr*xi; im += vi*xr.  #7's tile pass then
// issues two atomicAdds, on the re and on the im word of the accumulator
// (componentwise adds are exact in meaning: there is no complex atomic).
// The scan runs over re and im separately (a shuffle per component).
//
// SpMM (entry whell_packed_spmm, kernel #12) replaces
// _whell_packed_spmm_kernel (_whell_packed_spmm_call,
// whell_spmm_packed_pallas): Z[r] = A x[r] for n_rhs RHS, fp32 or bf16
// values, fp32 x, sums and Z (n_rhs, rows, 128).  It runs the hack pass
// of #4 (whell_spmm_hack_pass): one launch per product, one block per
// (work unit, block of kRhs = 8 RHS), no accumulator, no zero fill, no
// lane atomics and no flush launch, bit-reproducible.  Each thread
// decodes its 8 cells of a tile once (the ring's residue and page-table
// bytes, as in #4), then gathers each live cell's 8 RHS, which sit in one
// 32 B sector of the RHS-interleaved x (x_pages*128, n_rhs) that the
// wrapper copies X into (two float4 loads when n_rhs is a multiple of 4,
// else masked scalar loads), into 8 register sums; the block's scan then
// runs the 8 RHS together (one scan array per RHS, 4 KiB) and stores z.
// Cells whose value is 0 gather nothing (as #15 and #16), so a run's
// padding cells cost no x read.  The first design (a tile pass of
// one block per tile with one atomicAdd per (RHS, lane) into a zeroed
// accumulator, then a flush launch per (hack row, RHS)) took 136.3-137.3
// us on the flagship for 8 RHS: 107.2 in the tile pass, 16.0 in the flush
// (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py).  Bound: the slab once
// (6 B/cell fp32, 4 B bf16) plus X and Z once per RHS, ~95 MB and 28 us
// for 8 RHS on the flagship.  What holds it back is the x gathers: timed
// side by side on that card and matrix (8 RHS, fp32, variants not kept),
// the kernel took 75-76 us, 30.2 without the x loads (the stream alone,
// near the bound), 69.6 without the scan; gathering the zero cells too
// 78.9, all 16 loads of a tile hoisted ahead of the FMAs 74.1-74.5, the
// next tile's values prefetched 78.4, the stage released after the
// gathers (as #4) 73.6, 8 stages 76.2, a 42-register cap 115.9, 2 or 4
// consecutive hacks per block (for L1 reuse of x; group-local barriers)
// 73.1 and 82.6, and lanes l and l^16 loading the two halves of one
// cell's 8 RHS 77.8.  The TPU kernel's RHS passes, unroll budget
// and VMEM checks are Mosaic and VMEM limits and have no counterpart.
//
// Ablation (entry whell_packed_ablation_f64, kernel #19) replaces the `call`
// closure of doc/sweeps/dd_ablation.py (its pallas_call body adds one op
// family of _whell_packed_dd_kernel at a time, at the production
// geometry): the per-op account of #4 in float64.  The levels are the
// production hack pass (whell_hack_pass, which #4 instantiates at kFull)
// cut after one family: stream (the streamed values and the ring's
// copies, every byte consumed: 10 B/cell), gather (+ the decode and the x gather), own (+ the per-hack
// register sum over the run, stored unscanned) and full (+ the scan: the
// production launch).  stream and gather store each tile's lane sums to a
// (num_tiles, 128) part array, 1 KiB per tile.  The TPU levels eft, ddrmw
// and norelax price double-float arithmetic, which native float64 does
// not have; the atomic level of the tile pass's account priced its
// atomics, which the hack pass does not have.  Bound: that of #4 on the
// same layout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kSlots = 8;

__device__ __forceinline__ float load_value(const float* v, int64_t i) {
  return __ldg(v + i);
}

// bf16 bits -> fp32 (exact: a bf16 is the top half of an fp32)
__device__ __forceinline__ float load_value(const uint16_t* v, int64_t i) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(v + i)) << 16);
}

__device__ __forceinline__ float2 load_value(const float2* v, int64_t i) {
  return __ldg(v + i);
}

// sum + v*x: one FMA for a real type, four for a complex one
__device__ __forceinline__ float mac(float v, float x, float sum) {
  return fmaf(v, x, sum);
}

__device__ __forceinline__ double mac(double v, double x, double sum) {
  return fma(v, x, sum);
}

// re += vr*xr; re -= vi*xi; im += vr*xi; im += vi*xr, each a rounded FMA
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

// componentwise sum and difference (the flush's scan arithmetic)
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 add(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float sub(float a, float b) { return a - b; }
__device__ __forceinline__ double sub(double a, double b) { return a - b; }
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double2 sub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float shfl_up(float v, int o) {
  return __shfl_up_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ double shfl_up(double v, int o) {
  return __shfl_up_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ float2 shfl_up(float2 v, int o) {
  return make_float2(__shfl_up_sync(0xffffffffu, v.x, o),
                     __shfl_up_sync(0xffffffffu, v.y, o));
}
__device__ __forceinline__ double2 shfl_up(double2 v, int o) {
  return make_double2(__shfl_up_sync(0xffffffffu, v.x, o),
                      __shfl_up_sync(0xffffffffu, v.y, o));
}

// *p += v; a complex sum takes two atomics, one per component
__device__ __forceinline__ void atomic_add(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void atomic_add(float2* p, float2 v) {
  atomicAdd(&p->x, v.x);
  atomicAdd(&p->y, v.y);
}

// The tile's 8x128 page table, staged in shared memory by the block, and
// the decode of one cell: x-column page*128 + r of slot s's cell whose
// residue is r (tile word `meta`; `bases` = group_bases, ntab per group).
template <bool kScattered>
__device__ __forceinline__ int64_t cell_column(const int8_t (&pt)[kSlots][kLanes],
                                               int s, int r, uint32_t meta,
                                               const int32_t* __restrict__ bases,
                                               int ntab) {
  const int d = pt[s][r];
  if constexpr (kScattered) {
    const int32_t* b = bases + static_cast<int64_t>(meta & 0xFFFFFu) * ntab;
    return (static_cast<int64_t>(b[d >> 3]) + (d & 7)) * kLanes + r;
  } else {
    return (static_cast<int64_t>(meta & 0xFFFFu) + d) * kLanes + r;
  }
}

// the accumulator row of tile t: its chunk's group, then the hack in it
template <bool kScattered>
__device__ __forceinline__ int64_t tile_hack(const int32_t* __restrict__ chunk_group,
                                             int64_t t, uint32_t meta,
                                             int chunk_tiles, int group_hacks) {
  const uint32_t hh = kScattered ? meta >> 20 : meta >> 16;
  return static_cast<int64_t>(chunk_group[t / chunk_tiles]) * group_hacks + hh;
}

// The tile pass of #1 and #7 (V: value storage type; T: x, accumulator
// and output type, T{} is zero): the tile's page table goes to shared
// memory, each thread sums its lane over the 8 slots in a register and
// adds the sum into the (hack, lane) accumulator with one atomic.
template <typename V, typename T, bool kScattered>
__device__ __forceinline__ void whell_tile(const V* __restrict__ values,
                                           const int8_t* __restrict__ residue,
                                           const int8_t* __restrict__ page_tab,
                                           const int32_t* __restrict__ tile_base,
                                           const int32_t* __restrict__ chunk_group,
                                           const int32_t* __restrict__ group_bases,
                                           const T* __restrict__ x, T* __restrict__ acc,
                                           int chunk_tiles, int group_hacks, int ntab) {
  const int64_t t = blockIdx.x;
  const int j = threadIdx.x;
  const int64_t cell0 = t * (kSlots * kLanes);
  __shared__ int8_t pt[kSlots][kLanes];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) pt[s][j] = page_tab[cell0 + s * kLanes + j];
  const uint32_t meta = static_cast<uint32_t>(tile_base[t]);
  __syncthreads();

  T sum{};
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int64_t c = cell0 + s * kLanes + j;
    const int64_t col =
        cell_column<kScattered>(pt, s, residue[c], meta, group_bases, ntab);
    sum = mac(load_value(values, c), __ldg(x + col), sum);
  }
  const int64_t hack =
      tile_hack<kScattered>(chunk_group, t, meta, chunk_tiles, group_hacks);
  atomic_add(acc + hack * kLanes + j, sum);
}

template <typename V, typename T, bool kScattered>
__global__ void __launch_bounds__(kLanes)
whell_tile_pass(const V* __restrict__ values,
                const int8_t* __restrict__ residue,
                const int8_t* __restrict__ page_tab,
                const int32_t* __restrict__ tile_base,
                const int32_t* __restrict__ chunk_group,
                const int32_t* __restrict__ group_bases,
                const T* __restrict__ x, T* __restrict__ acc,
                int chunk_tiles, int group_hacks, int ntab) {
  whell_tile<V, T, kScattered>(values, residue, page_tab, tile_base,
                               chunk_group, group_bases, x, acc,
                               chunk_tiles, group_hacks, ntab);
}

// Lane j's output of one hack row of the hack pass from its lane sum a,
// in a block of 128 threads that all call it: the flush pass's scan (kept
// as its own copy there, whose shared-memory layout ptxas would otherwise
// change).  With p the inclusive prefix sum of the row's lane sums,
// (hi >= 0 ? p[hi] : 0) - (lo >= 0 ? p[lo] : 0), lo read from *lo_at
// after the scan; with unit segments, the sum of lane hi.  The scan
// array p is 128 T: 1 KiB for double, 2 KiB for double2.
template <typename T, bool kUnit>
__device__ __forceinline__ T segment_sum(T a, int hi,
                                         const int8_t* __restrict__ lo_at) {
  __shared__ T p[kLanes];
  __shared__ T warp_total[kLanes / 32];
  const int j = threadIdx.x;
  if constexpr (kUnit) {
    p[j] = a;
    __syncthreads();
    return hi >= 0 ? p[hi] : T{};
  }
  const int lane = j & 31, warp = j >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T up = shfl_up(a, o);
    if (lane >= o) a = add(a, up);
  }
  if (lane == 31) warp_total[warp] = a;
  __syncthreads();
  for (int w = 0; w < warp; ++w) a = add(a, warp_total[w]);
  p[j] = a;
  __syncthreads();
  const int lo = *lo_at;
  return sub(hi >= 0 ? p[hi] : T{}, lo >= 0 ? p[lo] : T{});
}

// ---------------------------------------------------------------------------
// #4 and complex128: one block per hack row (whell_hack_pass)

// The levels of the hack pass, which add one op family at a time (kernel
// #19): kStream consumes every cell's streamed value and bulk-copied
// residue and page-table bytes, kGather adds the decode and the x gather, kOwn the
// lane's register sum over the hack's run, kFull the scan and segment
// difference: the production launch.  kStream and kGather store each
// tile's lane sums to out[t, j] ((num_tiles, 128) part array), kOwn each
// hack's unscanned lane sums to out[h, j].
enum Level : int { kStream = 0, kGather = 1, kOwn = 2, kFull = 3 };

// tiles of a run in flight per block (the ring's stages)
constexpr int kStages = 4;

// The index bytes of one tile as the bulk copies land them in shared
// memory: 2 KiB.
struct Stage {
  int8_t res[kSlots][kLanes];
  int8_t pt[kSlots][kLanes];
};

__device__ __forceinline__ double load_streaming(const double* p) { return __ldcs(p); }
__device__ __forceinline__ double2 load_streaming(const double2* p) { return __ldcs(p); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

// one arrival (release: this thread's earlier reads of the stage are
// performed before the arrival is seen)
__device__ __forceinline__ void barrier_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// the barrier's phase completes when `bytes` have landed
__device__ __forceinline__ void barrier_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// waits for the phase of `parity` to complete; a copy that never lands
// traps (a launch error) after about 2^34 cycles instead of hanging
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// the TMA's 1-D bulk copy global -> shared, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ double load_global(const double* p) { return __ldcg(p); }
__device__ __forceinline__ double2 load_global(const double2* p) { return __ldcg(p); }

// Block u runs work unit u = (begin, end, row, chunk) of hack_units
// (formats/whell.py): the tiles [begin, end) of output row `row`'s run,
// all of it (chunk -1) or its c-th chunk of k (chunk = c << 16 | k); thread
// j is lane j.  Thread 0 keeps kStages tiles in flight with bulk copies
// (a stage is refilled once all 128 threads have arrived on its `emptied`
// barrier: their reads of it are then done); each thread decodes its 8
// cells of a landed tile from shared memory, issues their 8 x gathers
// together and adds the products to its register sum in slot order, tile
// by tile.  A whole run's block then scans its sums into z[row, :] (out).
// A chunk's block stores its sums to part[u, :]; the block that counts
// the row's k-th arrival on done[row] adds the k chunks' sums in chunk
// order (the same bits whichever block comes last) and scans.  The
// counters are the launch's own (the caller zeroes them per call), so
// launches on several streams share no state.
template <typename T, bool kScattered, int kLevel, bool kUnit>
__global__ void __launch_bounds__(kLanes)
whell_hack_pass(const T* __restrict__ values,
                const int8_t* __restrict__ residue,
                const int8_t* __restrict__ page_tab,
                const int32_t* __restrict__ tile_base,
                const int32_t* __restrict__ group_bases,
                const int4* __restrict__ units, int* __restrict__ done,
                T* __restrict__ part, const int8_t* __restrict__ seg_lo,
                const int8_t* __restrict__ seg_hi,
                const T* __restrict__ x, T* __restrict__ out, int ntab) {
  __shared__ __align__(128) Stage ring[kStages];
  __shared__ __align__(8) uint64_t landed[kStages];
  __shared__ __align__(8) uint64_t emptied[kStages];
  const int4 unit = units[blockIdx.x];
  const int64_t begin = unit.x, n = unit.y - unit.x, row = unit.z;
  const int j = threadIdx.x;
  if (j == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      barrier_init(&landed[s], 1);
      barrier_init(&emptied[s], kLanes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // thread 0: tile begin + i of the run into stage i % kStages
  auto fetch = [&](int64_t i) {
    Stage& st = ring[i % kStages];
    uint64_t* bar = &landed[i % kStages];
    const int64_t c = (begin + i) * (kSlots * kLanes);
    barrier_expect(bar, sizeof(Stage));
    bulk_copy(st.res, residue + c, sizeof(st.res), bar);
    bulk_copy(st.pt, page_tab + c, sizeof(st.pt), bar);
  };
  if (j == 0)
    for (int64_t i = 0; i < n && i < kStages; ++i) fetch(i);

  [[maybe_unused]] T sum{};
  for (int64_t i = 0; i < n; ++i) {
    const int64_t t = begin + i;
    // what does not wait for the copies: the lane's values (streamed from
    // global memory), the tile's word and its superpage bases (scattered)
    T v[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      v[s] = load_streaming(values + t * (kSlots * kLanes) + s * kLanes + j);
    [[maybe_unused]] uint32_t meta = 0;
    [[maybe_unused]] int32_t base[4] = {0, 0, 0, 0};
    if constexpr (kLevel != kStream) {
      meta = static_cast<uint32_t>(__ldg(tile_base + t));
      if constexpr (kScattered) {
        const int32_t* b = group_bases + static_cast<int64_t>(meta & 0xFFFFFu) * ntab;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < ntab) base[q] = __ldg(b + q);
      }
    }
    const Stage& st = ring[i % kStages];
    const uint32_t parity = static_cast<uint32_t>(i / kStages) & 1u;
    barrier_wait(&landed[i % kStages], parity);
    if constexpr (kLevel == kStream) {  // every byte consumed: v*1.5 + (r + d)
      T tile{};
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        tile = add(mac(v[s], T(1.5), tile), T(st.res[s][j] + st.pt[s][j]));
      out[t * kLanes + j] = tile;
    } else {
      int64_t col[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int r = st.res[s][j];
        const int d = st.pt[s][r];
        int64_t page;
        if constexpr (kScattered) {
          const int q = d >> 3;
          page = static_cast<int64_t>(q == 0 ? base[0] : q == 1 ? base[1]
                                      : q == 2 ? base[2] : base[3]) + (d & 7);
        } else {
          page = static_cast<int64_t>(meta & 0xFFFFu) + d;
        }
        col[s] = page * kLanes + r;
      }
      T xv[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) xv[s] = __ldg(x + col[s]);
      if constexpr (kLevel == kGather) {
        T tile{};
#pragma unroll
        for (int s = 0; s < kSlots; ++s) tile = mac(v[s], xv[s], tile);
        out[t * kLanes + j] = tile;
      } else {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) sum = mac(v[s], xv[s], sum);
      }
    }
    // This thread's reads of the stage are done.  The refill writes it
    // through the async proxy, which the arrive alone does not order
    // after generic-proxy reads: without the proxy fence a refill raced
    // the reads on the H100 and corrupted float64 sums.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    barrier_arrive(&emptied[i % kStages]);
    if (j == 0 && i + kStages < n) {  // refill the stage once all have read it
      barrier_wait(&emptied[i % kStages], parity);
      fetch(i + kStages);
    }
  }
  if constexpr (kLevel >= kOwn) {
    if (unit.w >= 0) {  // a chunk: the row's last block adds the chunks
      __shared__ bool last;
      const int c = unit.w >> 16, k = unit.w & 0xFFFF;
      part[static_cast<int64_t>(blockIdx.x) * kLanes + j] = sum;
      __threadfence();
      __syncthreads();
      if (j == 0) last = atomicAdd(done + row, 1) == k - 1;
      __syncthreads();
      if (!last) return;
      __threadfence();
      const T* chunks = part + (static_cast<int64_t>(blockIdx.x) - c) * kLanes + j;
      sum = T{};
      for (int q = 0; q < k; ++q) sum = add(sum, load_global(chunks + q * kLanes));
      // the counters are this launch's own and need no reset; the store
      // stays because without it ptxas allots #4 and complex128 another
      // register count (55 and 74 against 56 and 73 on sm_90a)
      if (j == 0) done[row] = 0;
    }
    const int64_t o = row * kLanes + j;
    if constexpr (kLevel == kOwn) out[o] = sum;
    else out[o] = segment_sum<T, kUnit>(sum, seg_hi[o], seg_lo + o);
  }
}

// ---------------------------------------------------------------------------
// #12: the hack pass with kRhs register sums (whell_spmm_hack_pass)

constexpr int kRhs = 8;

__device__ __forceinline__ float load_streaming(const float* p) { return __ldcs(p); }

// bf16 bits -> fp32 (exact: a bf16 is the top half of an fp32)
__device__ __forceinline__ float load_streaming(const uint16_t* p) {
  return __uint_as_float(
      static_cast<uint32_t>(__ldcs(reinterpret_cast<const unsigned short*>(p))) << 16);
}

// Lane j's outputs of one hack row for w <= kRhs RHS from its lane sums,
// in a block of 128 threads that all call it: segment_sum's scan for the
// kRhs sums together, each RHS with its own scan array (so no RHS's
// writes race another's reads), stored to out[q * rhs_stride], q < w.
template <bool kUnit>
__device__ __forceinline__ void store_segment_sums(float (&sum)[kRhs], int w, int hi,
                                                   const int8_t* __restrict__ lo_at,
                                                   float* __restrict__ out,
                                                   int64_t rhs_stride) {
  __shared__ float p[kRhs][kLanes];
  __shared__ float warp_total[kRhs][kLanes / 32];
  const int j = threadIdx.x;
  if constexpr (kUnit) {
#pragma unroll
    for (int q = 0; q < kRhs; ++q) p[q][j] = sum[q];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRhs; ++q)
      if (q < w) out[q * rhs_stride] = hi >= 0 ? p[q][hi] : 0.0f;
    return;
  }
  const int lane = j & 31, warp = j >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int q = 0; q < kRhs; ++q) {
      const float up = __shfl_up_sync(0xffffffffu, sum[q], o);
      if (lane >= o) sum[q] += up;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int q = 0; q < kRhs; ++q) warp_total[q][warp] = sum[q];
  }
  __syncthreads();
  for (int v = 0; v < warp; ++v) {
#pragma unroll
    for (int q = 0; q < kRhs; ++q) sum[q] += warp_total[q][v];
  }
#pragma unroll
  for (int q = 0; q < kRhs; ++q) p[q][j] = sum[q];
  __syncthreads();
  const int lo = *lo_at;
#pragma unroll
  for (int q = 0; q < kRhs; ++q)
    if (q < w) out[q * rhs_stride] = (hi >= 0 ? p[q][hi] : 0.0f) - (lo >= 0 ? p[q][lo] : 0.0f);
}

// Block (u, b) runs work unit u of hack_units (as whell_hack_pass) for
// RHS r0 = 8b .. r0 + w - 1 (w = min(8, n_rhs - r0)): thread 0 keeps
// kStages tiles' index bytes in flight by bulk copies; each thread
// streams its 8 values of a tile, decodes its 8 cells from the landed
// stage (and releases the stage at once), then for each nonzero cell
// adds v * x[col*n_rhs + r0 + q] to sum[q], tile by tile and slot by
// slot.  A chunked run's blocks store their sums to part (U, n_rhs, 128)
// and the k-th arrival on done[row * gridDim.y + b] adds the k chunks in
// chunk order.  Then the block scans and stores z[r0 + q, row, :].
template <typename V, bool kScattered, bool kUnit>
__global__ void __launch_bounds__(kLanes)
whell_spmm_hack_pass(const V* __restrict__ values,
                     const int8_t* __restrict__ residue,
                     const int8_t* __restrict__ page_tab,
                     const int32_t* __restrict__ tile_base,
                     const int32_t* __restrict__ group_bases,
                     const int4* __restrict__ units, int* __restrict__ done,
                     float* __restrict__ part, const int8_t* __restrict__ seg_lo,
                     const int8_t* __restrict__ seg_hi,
                     const float* __restrict__ x, float* __restrict__ z,
                     int64_t num_rows, int n_rhs, int ntab) {
  __shared__ __align__(128) Stage ring[kStages];
  __shared__ __align__(8) uint64_t landed[kStages];
  __shared__ __align__(8) uint64_t emptied[kStages];
  const int4 unit = units[blockIdx.x];
  const int64_t begin = unit.x, n = unit.y - unit.x, row = unit.z;
  const int j = threadIdx.x;
  const int r0 = blockIdx.y * kRhs;
  const int w = min(kRhs, n_rhs - r0);
  // a cell's 8 RHS as two 16 B loads: a full block at a 16 B aligned offset
  const bool vec = w == kRhs && n_rhs % 4 == 0;
  if (j == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      barrier_init(&landed[s], 1);
      barrier_init(&emptied[s], kLanes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto fetch = [&](int64_t i) {
    Stage& st = ring[i % kStages];
    uint64_t* bar = &landed[i % kStages];
    const int64_t c = (begin + i) * (kSlots * kLanes);
    barrier_expect(bar, sizeof(Stage));
    bulk_copy(st.res, residue + c, sizeof(st.res), bar);
    bulk_copy(st.pt, page_tab + c, sizeof(st.pt), bar);
  };
  if (j == 0)
    for (int64_t i = 0; i < n && i < kStages; ++i) fetch(i);

  float sum[kRhs];
#pragma unroll
  for (int q = 0; q < kRhs; ++q) sum[q] = 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t t = begin + i;
    float v[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      v[s] = load_streaming(values + t * (kSlots * kLanes) + s * kLanes + j);
    const uint32_t meta = static_cast<uint32_t>(__ldg(tile_base + t));
    [[maybe_unused]] int32_t base[4] = {0, 0, 0, 0};
    if constexpr (kScattered) {
      const int32_t* b = group_bases + static_cast<int64_t>(meta & 0xFFFFFu) * ntab;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < ntab) base[q] = __ldg(b + q);
    }
    const Stage& st = ring[i % kStages];
    const uint32_t parity = static_cast<uint32_t>(i / kStages) & 1u;
    barrier_wait(&landed[i % kStages], parity);
    const float* xs[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int r = st.res[s][j];
      const int d = st.pt[s][r];
      int64_t page;
      if constexpr (kScattered) {
        const int q = d >> 3;
        page = static_cast<int64_t>(q == 0 ? base[0] : q == 1 ? base[1]
                                    : q == 2 ? base[2] : base[3]) + (d & 7);
      } else {
        page = static_cast<int64_t>(meta & 0xFFFFu) + d;
      }
      xs[s] = x + (page * kLanes + r) * n_rhs + r0;
    }
    // the stage's bytes are decoded: release it (the proxy fence as in
    // whell_hack_pass) before the gathers, so its refill starts sooner
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    barrier_arrive(&emptied[i % kStages]);
    if (j == 0 && i + kStages < n) {
      barrier_wait(&emptied[i % kStages], parity);
      fetch(i + kStages);
    }
    if (vec) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (v[s] != 0.0f) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(xs[s]));
          const float4 b = __ldg(reinterpret_cast<const float4*>(xs[s]) + 1);
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
            if (q < w) sum[q] = fmaf(v[s], __ldg(xs[s] + q), sum[q]);
        }
      }
    }
  }
  const int64_t rhs_stride = num_rows * kLanes;
  if (unit.w >= 0) {  // a chunk: the row's last block adds the chunks
    __shared__ bool last;
    const int c = unit.w >> 16, k = unit.w & 0xFFFF;
    float* mine = part + (static_cast<int64_t>(blockIdx.x) * n_rhs + r0) * kLanes + j;
#pragma unroll
    for (int q = 0; q < kRhs; ++q)
      if (q < w) mine[q * kLanes] = sum[q];
    __threadfence();
    __syncthreads();
    if (j == 0) last = atomicAdd(done + row * gridDim.y + blockIdx.y, 1) == k - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const float* chunks = mine - static_cast<int64_t>(c) * n_rhs * kLanes;
#pragma unroll
    for (int q = 0; q < kRhs; ++q) sum[q] = 0.0f;
    for (int cc = 0; cc < k; ++cc) {
#pragma unroll
      for (int q = 0; q < kRhs; ++q)
        if (q < w) sum[q] += __ldcg(chunks + (static_cast<int64_t>(cc) * n_rhs + q) * kLanes);
    }
  }
  const int64_t o = row * kLanes + j;
  store_segment_sums<kUnit>(sum, w, seg_hi[o], seg_lo + o,
                            z + static_cast<int64_t>(r0) * rhs_stride + o, rhs_stride);
}

// Block (h, r) flushes hack row h of RHS r; acc and z hold gridDim.x rows
// per RHS, seg_lo/seg_hi one set.  (Since #12 moved to the hack pass,
// the SpMVs #1 and #7 launch it with one RHS.)
template <typename T, bool kUnit>
__global__ void __launch_bounds__(kLanes)
whell_flush_pass(const T* __restrict__ acc,
                 const int8_t* __restrict__ seg_lo,
                 const int8_t* __restrict__ seg_hi, T* __restrict__ z) {
  __shared__ T p[kLanes];
  __shared__ T warp_total[kLanes / 32];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kLanes + threadIdx.x;
  const int j = threadIdx.x;
  acc += static_cast<int64_t>(blockIdx.y) * gridDim.x * kLanes;
  z += static_cast<int64_t>(blockIdx.y) * gridDim.x * kLanes;
  T a = acc[i];
  const int hi = seg_hi[i];
  if constexpr (kUnit) {
    p[j] = a;
    __syncthreads();
    z[i] = hi >= 0 ? p[hi] : T{};
    return;
  }
  const int lane = j & 31, warp = j >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T up = shfl_up(a, o);
    if (lane >= o) a = add(a, up);
  }
  if (lane == 31) warp_total[warp] = a;
  __syncthreads();
  for (int w = 0; w < warp; ++w) a = add(a, warp_total[w]);
  p[j] = a;
  __syncthreads();
  const int lo = seg_lo[i];
  z[i] = sub(hi >= 0 ? p[hi] : T{}, lo >= 0 ? p[lo] : T{});
}

// the flush of the accumulator's num_rows hack rows
template <typename T>
void launch_flush(const T* acc, const void* seg_lo, const void* seg_hi,
                  void* z, int64_t num_rows, int unit_segments, cudaStream_t st) {
  if (num_rows <= 0) return;
  auto* lo = static_cast<const int8_t*>(seg_lo);
  auto* hi = static_cast<const int8_t*>(seg_hi);
  auto* zt = static_cast<T*>(z);
  const dim3 grid(static_cast<unsigned>(num_rows));
  if (unit_segments)
    whell_flush_pass<T, true><<<grid, kLanes, 0, st>>>(acc, lo, hi, zt);
  else
    whell_flush_pass<T, false><<<grid, kLanes, 0, st>>>(acc, lo, hi, zt);
}

// tile pass on values of type V, then the flush; returns cudaGetLastError()
template <typename V, typename T>
int whell_spmv(const void* values, const void* residue, const void* page_tab,
               const void* tile_base, const void* chunk_group,
               const void* group_bases, const void* seg_lo, const void* seg_hi,
               const void* x, void* acc, void* z, int64_t num_tiles,
               int64_t num_rows, int chunk_tiles, int group_hacks,
               int window_pages, int unit_segments, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntab = window_pages / 8;
  auto* v = static_cast<const V*>(values);
  auto* res = static_cast<const int8_t*>(residue);
  auto* pt = static_cast<const int8_t*>(page_tab);
  auto* tb = static_cast<const int32_t*>(tile_base);
  auto* cg = static_cast<const int32_t*>(chunk_group);
  auto* gb = static_cast<const int32_t*>(group_bases);
  auto* xt = static_cast<const T*>(x);
  auto* a = static_cast<T*>(acc);
  if (num_tiles > 0) {
    const dim3 grid(static_cast<unsigned>(num_tiles));
    if (gb != nullptr)
      whell_tile_pass<V, T, true><<<grid, kLanes, 0, st>>>(
          v, res, pt, tb, cg, gb, xt, a, chunk_tiles, group_hacks, ntab);
    else
      whell_tile_pass<V, T, false><<<grid, kLanes, 0, st>>>(
          v, res, pt, tb, cg, gb, xt, a, chunk_tiles, group_hacks, ntab);
  }
  launch_flush<T>(a, seg_lo, seg_hi, z, num_rows, unit_segments, st);
  return static_cast<int>(cudaGetLastError());
}

// Kernel #12: one launch of whell_spmm_hack_pass on values of type V, a
// block per (work unit, RHS block); returns cudaGetLastError()
template <typename V>
int spmm_hack_pass(const void* values, const void* residue, const void* page_tab,
                   const void* tile_base, const void* group_bases, const void* units,
                   void* done, void* part, const void* seg_lo, const void* seg_hi,
                   const void* x, void* z, int64_t num_units, int64_t num_rows,
                   int n_rhs, int window_pages, int unit_segments, void* stream) {
  if (num_units > 0 && n_rhs > 0) {
    const bool scattered = group_bases != nullptr;
    auto* kernel = scattered
        ? (unit_segments ? &whell_spmm_hack_pass<V, true, true>
                         : &whell_spmm_hack_pass<V, true, false>)
        : (unit_segments ? &whell_spmm_hack_pass<V, false, true>
                         : &whell_spmm_hack_pass<V, false, false>);
    const dim3 grid(static_cast<unsigned>(num_units),
                    static_cast<unsigned>((n_rhs + kRhs - 1) / kRhs));
    kernel<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const V*>(values), static_cast<const int8_t*>(residue),
        static_cast<const int8_t*>(page_tab), static_cast<const int32_t*>(tile_base),
        static_cast<const int32_t*>(group_bases), static_cast<const int4*>(units),
        static_cast<int*>(done), static_cast<float*>(part),
        static_cast<const int8_t*>(seg_lo), static_cast<const int8_t*>(seg_hi),
        static_cast<const float*>(x), static_cast<float*>(z), num_rows, n_rhs,
        window_pages / 8);
  }
  return static_cast<int>(cudaGetLastError());
}

// The hack pass at level kLevel on values, x and out of type T, one block
// per work unit; returns cudaGetLastError().
template <typename T, int kLevel>
int hack_pass(const void* values, const void* residue, const void* page_tab,
              const void* tile_base, const void* group_bases, const void* units,
              void* done, void* part, const void* seg_lo, const void* seg_hi,
              const void* x, void* out, int64_t num_units, int window_pages,
              int unit_segments, void* stream) {
  constexpr bool kScan = kLevel == kFull;  // only the scan reads segments
  if (num_units > 0) {
    auto* kernel = group_bases != nullptr
        ? (kScan && unit_segments ? &whell_hack_pass<T, true, kLevel, kScan>
                                  : &whell_hack_pass<T, true, kLevel, false>)
        : (kScan && unit_segments ? &whell_hack_pass<T, false, kLevel, kScan>
                                  : &whell_hack_pass<T, false, kLevel, false>);
    kernel<<<static_cast<unsigned>(num_units), kLanes, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(values), static_cast<const int8_t*>(residue),
        static_cast<const int8_t*>(page_tab), static_cast<const int32_t*>(tile_base),
        static_cast<const int32_t*>(group_bases), static_cast<const int4*>(units),
        static_cast<int*>(done), static_cast<T*>(part),
        static_cast<const int8_t*>(seg_lo), static_cast<const int8_t*>(seg_hi),
        static_cast<const T*>(x), static_cast<T*>(out), window_pages / 8);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// z (num_rows x 128) = segment flush of acc after the tile pass.  acc
// (num_rows x 128) must be zeroed by the caller; group_bases may be null
// (aligned windows).  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError().
//
// fp32 x, acc and z; values_bf16 selects bf16 values over fp32 ones.
int whell_packed_spmv(const void* values, int values_bf16,
                      const void* residue, const void* page_tab,
                      const void* tile_base, const void* chunk_group,
                      const void* group_bases, const void* seg_lo,
                      const void* seg_hi, const void* x, void* acc, void* z,
                      int64_t num_tiles, int64_t num_rows, int chunk_tiles,
                      int group_hacks, int window_pages, int unit_segments,
                      void* stream) {
  if (values_bf16)
    return whell_spmv<uint16_t, float>(
        values, residue, page_tab, tile_base, chunk_group, group_bases,
        seg_lo, seg_hi, x, acc, z, num_tiles, num_rows, chunk_tiles,
        group_hacks, window_pages, unit_segments, stream);
  return whell_spmv<float, float>(
      values, residue, page_tab, tile_base, chunk_group, group_bases, seg_lo,
      seg_hi, x, acc, z, num_tiles, num_rows, chunk_tiles, group_hacks,
      window_pages, unit_segments, stream);
}

// The same with complex64 values, x, acc and z, interleaved re/im.
int whell_packed_spmv_c64(const void* values, const void* residue,
                          const void* page_tab, const void* tile_base,
                          const void* chunk_group, const void* group_bases,
                          const void* seg_lo, const void* seg_hi, const void* x,
                          void* acc, void* z, int64_t num_tiles, int64_t num_rows,
                          int chunk_tiles, int group_hacks, int window_pages,
                          int unit_segments, void* stream) {
  return whell_spmv<float2, float2>(
      values, residue, page_tab, tile_base, chunk_group, group_bases, seg_lo,
      seg_hi, x, acc, z, num_tiles, num_rows, chunk_tiles, group_hacks,
      window_pages, unit_segments, stream);
}

// Kernel #4 (_f64: float64 values, x and z) and the complex128 kernel
// (_c128, interleaved re/im): z (num_rows x 128), one block per work unit
// of `units` ((num_units, 4) int32, WhellMatrix.hack_units, covering every
// output row).  done (num_rows int32, zeroed) and part (num_units x 128
// of T) are the launch's scratch for chunked runs, and may both be null
// when no unit is chunked (num_units == num_rows).  values, residue and
// page_tab must be 16 B aligned (the bulk
// copies); group_bases may be null (aligned windows).  Launches once on
// `stream`, does not synchronise, and returns cudaGetLastError().
#define HACK_ENTRY(NAME, T)                                                    \
  int NAME(const void* values, const void* residue, const void* page_tab,    \
           const void* tile_base, const void* group_bases,                   \
           const void* units, void* done, void* part, const void* seg_lo,    \
           const void* seg_hi, const void* x, void* z, int64_t num_units,    \
           int window_pages, int unit_segments, void* stream) {              \
    return hack_pass<T, kFull>(values, residue, page_tab, tile_base,         \
                               group_bases, units, done, part, seg_lo,       \
                               seg_hi, x, z, num_units, window_pages,        \
                               unit_segments, stream);                       \
  }

HACK_ENTRY(whell_packed_spmv_f64, double)
HACK_ENTRY(whell_packed_spmv_c128, double2)

#undef HACK_ENTRY

// Kernel #19, the hack pass of #4 at `level` (0 stream, 1 gather, 2 own,
// 3 full), with whell_packed_spmv_f64's arguments: out is the part array
// (num_tiles x 128; rows of tiles outside every run are not written) at
// stream and gather, the unscanned row sums (num_rows x 128) at own, z at
// full (whell_packed_spmv_f64 itself).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (cudaErrorInvalidValue for
// another level).
int whell_packed_ablation_f64(int level, const void* values, const void* residue,
                              const void* page_tab, const void* tile_base,
                              const void* group_bases, const void* units,
                              void* done, void* part, const void* seg_lo,
                              const void* seg_hi, const void* x, void* out,
                              int64_t num_units, int window_pages,
                              int unit_segments, void* stream) {
  auto* fn = level == kStream ? &hack_pass<double, kStream>
           : level == kGather ? &hack_pass<double, kGather>
           : level == kOwn    ? &hack_pass<double, kOwn>
           : level == kFull   ? &hack_pass<double, kFull>
                              : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(values, residue, page_tab, tile_base, group_bases, units, done, part,
            seg_lo, seg_hi, x, out, num_units, window_pages, unit_segments,
            stream);
}

// Kernel #12: Z (n_rhs x num_rows x 128) = the packed-WHELL product with
// each of n_rhs RHS (at most 65,535 blocks of 8), one block per (work
// unit, RHS block) of `units` (WhellMatrix.hack_units).  x is the
// RHS-interleaved (x_pages*128, n_rhs) fp32 stack; fp32 or bf16 values
// (values_bf16), fp32 z.  done (num_rows x RHS blocks int32, zeroed) and
// part (num_units x n_rhs x 128 fp32) are the launch's scratch for chunked
// runs, and may both be null when no unit is chunked (num_units ==
// num_rows).  values, residue and page_tab must be 16 B aligned;
// group_bases may be null (aligned windows).  Launches once on `stream`,
// does not synchronise, and returns cudaGetLastError().
int whell_packed_spmm(const void* values, int values_bf16, const void* residue,
                      const void* page_tab, const void* tile_base,
                      const void* group_bases, const void* units, void* done,
                      void* part, const void* seg_lo, const void* seg_hi,
                      const void* x, void* z, int64_t num_units, int64_t num_rows,
                      int n_rhs, int window_pages, int unit_segments, void* stream) {
  auto* fn = values_bf16 ? &spmm_hack_pass<uint16_t> : &spmm_hack_pass<float>;
  return fn(values, residue, page_tab, tile_base, group_bases, units, done, part,
            seg_lo, seg_hi, x, z, num_units, num_rows, n_rhs, window_pages,
            unit_segments, stream);
}

}  // extern "C"
