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
// 10 B/cell (8 B value + the two index bytes) on the double-float layout
// geometry, about 117 MiB and ~37 us on the flagship; fp64 FMA and
// atomicAdd(double) are native on Hopper, so no error-free transforms.
// complex64 streams 10 B/cell (an interleaved re/im float2 and the two
// index bytes) on the fp32 geometry: on the flagship 11,392 tiles (11.7M
// cells, 111 MiB of slab), 123.0 MB with x and z, a bound of 36.7 us;
// complex128 18 B/cell (a double2) on the double-float geometry: 15,168
// tiles (15.5M cells, 267 MiB), 291.4 MB, 87.0 us (chip_smoke.py's counts
// on an NVIDIA H100 80GB HBM3, 700 W).  x (4.2 MB in complex128) stays
// resident in L2.
//
// What the design does about it: the TPU kernel stages x in VMEM and
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
// prefix, which the double-float TPU kernel matches at ~2^-48).  wgmma
// and TMA have no role in a gather-bound product; deterministic per-hack
// ownership and several tiles per block are later work.
//
// Complex: a cell is one aligned float2 / double2 load of the interleaved
// slab (PyTorch's complex64 / complex128), x one more.  Each thread keeps
// re and im sums and adds four FMAs per cell, in this order:
// re += vr*xr; re -= vi*xi; im += vr*xi; im += vi*xr.  The tile pass then
// issues two atomicAdds, on the re and on the im word of the accumulator
// (componentwise adds are exact in meaning: there is no complex atomic).
// The flush scans re and im separately (a shuffle per component); its
// shared scan array is 128 T, 2 KiB for complex128.
//
// SpMM (entry whell_packed_spmm, kernel #12) replaces
// _whell_packed_spmm_kernel (_whell_packed_spmm_call,
// whell_spmm_packed_pallas): Z[r] = A x[r] for n_rhs RHS, fp32 or bf16
// values, fp32 x and sums.  Each lane's 8 cells are decoded once (page
// table in shared memory, value and x row in registers) and serve every
// RHS, in blocks of kRhs = 8 held in registers (a remainder block takes
// any n_rhs), with one atomicAdd per (RHS, lane) into acc[r, hack, lane];
// the flush runs one block per (hack row, RHS).  Layout of x: the wrapper
// copies X into an RHS-interleaved (x_pages*128, n_rhs) buffer, so one
// cell's 8 RHS sit in one 32 B sector and a lane's gathers for a block
// touch one sector where (n_rhs, x_pages*128) would touch eight.  acc and
// z stay (n_rhs, rows, 128): a warp's atomics and stores for one RHS are
// then 128 contiguous bytes.  Bound: the slab once (6 B/cell fp32, 4 B
// bf16) plus x and z per RHS, about 95 MB and 28 us for 8 RHS on the
// flagship.  The TPU kernel's RHS passes, unroll budget and VMEM checks
// are Mosaic and VMEM limits and have no counterpart: one launch takes
// any n_rhs.  Atomic order varies, so sums are not bit-reproducible.
//
// Ablation (entry whell_packed_ablation_f64, kernel #19) replaces the `call`
// closure of doc/sweeps/dd_ablation.py (its pallas_call body adds one op
// family of _whell_packed_dd_kernel at a time, at the production
// geometry): the per-op account of #4 in float64.  The levels are the
// production tile body (whell_tile, which whell_tile_pass instantiates at
// kAtomic) cut after one family: stream (the value, residue and page-table
// bytes of every cell, 10 B/cell, each consumed), gather (+ the page table
// in shared memory, the decode and the x gather: the production tile sum),
// atomic (+ one atomicAdd(double) per lane: the production tile pass
// alone) and full (+ the flush: the production launch).  Below atomic each
// lane's sum is stored to a (num_tiles, 128) part array, 1 KiB per tile, the
// same in both levels.  The TPU levels eft, ddrmw and norelax price
// double-float arithmetic, which native float64 does not have.  Bound:
// that of #4 on the same layout.

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

__device__ __forceinline__ double load_value(const double* v, int64_t i) {
  return __ldg(v + i);
}

__device__ __forceinline__ float2 load_value(const float2* v, int64_t i) {
  return __ldg(v + i);
}

__device__ __forceinline__ double2 load_value(const double2* v, int64_t i) {
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
__device__ __forceinline__ void atomic_add(double* p, double v) { atomicAdd(p, v); }
__device__ __forceinline__ void atomic_add(float2* p, float2 v) {
  atomicAdd(&p->x, v.x);
  atomicAdd(&p->y, v.y);
}
__device__ __forceinline__ void atomic_add(double2* p, double2 v) {
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

// The op families of the tile pass, added one at a time (kernel #19's
// levels): kStream reads the value, residue and page-table bytes of each
// cell, kGather adds the page table in shared memory, the decode and the x
// gather (the production tile sum), kAtomic the atomicAdd into the hack
// row (the production tile pass); kFull, the tile pass and the flush, is
// the production launch.  Below kAtomic the lane's sum goes to acc[t, j]
// with a plain store (acc is then the (num_tiles, 128) part array).
enum Level : int { kStream = 0, kGather = 1, kAtomic = 2, kFull = 3 };

// V: value storage type; T: x, accumulator and output type (T{} is zero)
template <typename V, typename T, bool kScattered, int kLevel>
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
  if constexpr (kLevel == kStream) {  // every byte consumed: v*1.5 + (r + d)
    T sum{};
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int64_t c = cell0 + s * kLanes + j;
      sum = mac(load_value(values, c), T(1.5), sum) + T(residue[c] + page_tab[c]);
    }
    acc[t * kLanes + j] = sum;
  } else {
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
    if constexpr (kLevel == kAtomic) {
      const int64_t hack =
          tile_hack<kScattered>(chunk_group, t, meta, chunk_tiles, group_hacks);
      atomic_add(acc + hack * kLanes + j, sum);
    } else {
      acc[t * kLanes + j] = sum;
    }
  }
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
  whell_tile<V, T, kScattered, kAtomic>(values, residue, page_tab, tile_base,
                                        chunk_group, group_bases, x, acc,
                                        chunk_tiles, group_hacks, ntab);
}

// kernel #19's levels below the production tile pass, float64: the tile
// pass cut after one op family, its lane sums stored to part (num_tiles, 128)
template <bool kScattered, int kLevel>
__global__ void __launch_bounds__(kLanes)
whell_ablation_pass(const double* __restrict__ values,
                    const int8_t* __restrict__ residue,
                    const int8_t* __restrict__ page_tab,
                    const int32_t* __restrict__ tile_base,
                    const int32_t* __restrict__ chunk_group,
                    const int32_t* __restrict__ group_bases,
                    const double* __restrict__ x, double* __restrict__ part,
                    int chunk_tiles, int group_hacks, int ntab) {
  whell_tile<double, double, kScattered, kLevel>(values, residue, page_tab,
                                                 tile_base, chunk_group,
                                                 group_bases, x, part,
                                                 chunk_tiles, group_hacks, ntab);
}

// SpMM tile pass (kernel #12): the 8 cells of each lane are decoded once
// (value in a register, x-row index col*n_rhs), then every RHS block of
// kRhs takes 8 gathers and products per lane and one atomicAdd per RHS
// into acc (n_rhs, num_rows, 128).  x is RHS-interleaved,
// (x_pages*128, n_rhs).
constexpr int kRhs = 8;

template <typename V, bool kScattered>
__global__ void __launch_bounds__(kLanes)
whell_spmm_tile_pass(const V* __restrict__ values,
                     const int8_t* __restrict__ residue,
                     const int8_t* __restrict__ page_tab,
                     const int32_t* __restrict__ tile_base,
                     const int32_t* __restrict__ chunk_group,
                     const int32_t* __restrict__ group_bases,
                     const float* __restrict__ x, float* __restrict__ acc,
                     int64_t num_rows, int n_rhs, int chunk_tiles,
                     int group_hacks, int ntab) {
  __shared__ int8_t pt[kSlots][kLanes];
  const int64_t t = blockIdx.x;
  const int j = threadIdx.x;
  const int64_t cell0 = t * (kSlots * kLanes);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) pt[s][j] = page_tab[cell0 + s * kLanes + j];
  const uint32_t meta = static_cast<uint32_t>(tile_base[t]);
  __syncthreads();

  float v[kSlots];
  int64_t xrow[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int64_t c = cell0 + s * kLanes + j;
    v[s] = load_value(values, c);
    xrow[s] = cell_column<kScattered>(pt, s, residue[c], meta, group_bases, ntab) * n_rhs;
  }
  const int64_t hack =
      tile_hack<kScattered>(chunk_group, t, meta, chunk_tiles, group_hacks);
  float* out = acc + hack * kLanes + j;
  const int64_t rhs_stride = num_rows * kLanes;
  for (int r0 = 0; r0 < n_rhs; r0 += kRhs) {
    const int w = min(kRhs, n_rhs - r0);
    float sum[kRhs];
#pragma unroll
    for (int q = 0; q < kRhs; ++q) sum[q] = 0.0f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const float* xs = x + xrow[s] + r0;
#pragma unroll
      for (int q = 0; q < kRhs; ++q)
        if (q < w) sum[q] = mac(v[s], __ldg(xs + q), sum[q]);
    }
#pragma unroll
    for (int q = 0; q < kRhs; ++q)
      if (q < w) atomicAdd(out + (r0 + q) * rhs_stride, sum[q]);
  }
}

// the scan array p is 128 T: 512 B for float, 1 KiB for double and float2,
// 2 KiB for double2.  Block (h, r) flushes hack row h of RHS r (SpMV: r =
// 0 only); acc and z hold gridDim.x rows per RHS, seg_lo/seg_hi one set.
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

// the flush of n_rhs stacked accumulators of num_rows hack rows each
template <typename T>
void launch_flush(const T* acc, const void* seg_lo, const void* seg_hi,
                  void* z, int64_t num_rows, int n_rhs, int unit_segments,
                  cudaStream_t st) {
  if (num_rows <= 0 || n_rhs <= 0) return;
  auto* lo = static_cast<const int8_t*>(seg_lo);
  auto* hi = static_cast<const int8_t*>(seg_hi);
  auto* zt = static_cast<T*>(z);
  const dim3 grid(static_cast<unsigned>(num_rows), static_cast<unsigned>(n_rhs));
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
  launch_flush<T>(a, seg_lo, seg_hi, z, num_rows, 1, unit_segments, st);
  return static_cast<int>(cudaGetLastError());
}

// SpMM: the tile pass of kernel #12 on values of type V, then the flush
// of every (hack row, RHS); returns cudaGetLastError()
template <typename V>
int whell_spmm(const void* values, const void* residue, const void* page_tab,
               const void* tile_base, const void* chunk_group,
               const void* group_bases, const void* seg_lo, const void* seg_hi,
               const void* x, void* acc, void* z, int64_t num_tiles,
               int64_t num_rows, int n_rhs, int chunk_tiles, int group_hacks,
               int window_pages, int unit_segments, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntab = window_pages / 8;
  auto* v = static_cast<const V*>(values);
  auto* res = static_cast<const int8_t*>(residue);
  auto* pt = static_cast<const int8_t*>(page_tab);
  auto* tb = static_cast<const int32_t*>(tile_base);
  auto* cg = static_cast<const int32_t*>(chunk_group);
  auto* gb = static_cast<const int32_t*>(group_bases);
  auto* xt = static_cast<const float*>(x);
  auto* a = static_cast<float*>(acc);
  if (n_rhs <= 0) return static_cast<int>(cudaGetLastError());
  if (num_tiles > 0) {
    const dim3 grid(static_cast<unsigned>(num_tiles));
    if (gb != nullptr)
      whell_spmm_tile_pass<V, true><<<grid, kLanes, 0, st>>>(
          v, res, pt, tb, cg, gb, xt, a, num_rows, n_rhs, chunk_tiles,
          group_hacks, ntab);
    else
      whell_spmm_tile_pass<V, false><<<grid, kLanes, 0, st>>>(
          v, res, pt, tb, cg, gb, xt, a, num_rows, n_rhs, chunk_tiles,
          group_hacks, ntab);
  }
  launch_flush<float>(a, seg_lo, seg_hi, z, num_rows, n_rhs, unit_segments, st);
  return static_cast<int>(cudaGetLastError());
}

// kernel #19's stream and gather levels on float64 values, x and part
template <int kLevel>
void launch_ablation(const double* v, const int8_t* res, const int8_t* pt,
                     const int32_t* tb, const int32_t* cg, const int32_t* gb,
                     const double* x, double* part, int64_t num_tiles,
                     int chunk_tiles, int group_hacks, int ntab, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(num_tiles));
  if (gb != nullptr)
    whell_ablation_pass<true, kLevel><<<grid, kLanes, 0, st>>>(
        v, res, pt, tb, cg, gb, x, part, chunk_tiles, group_hacks, ntab);
  else
    whell_ablation_pass<false, kLevel><<<grid, kLanes, 0, st>>>(
        v, res, pt, tb, cg, gb, x, part, chunk_tiles, group_hacks, ntab);
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

// The same with float64 values, x, acc and z (_f64), with complex64 ones
// (_c64) and with complex128 ones (_c128), interleaved re/im.
#define WHELL_ENTRY(NAME, T)                                                   \
  int NAME(const void* values, const void* residue, const void* page_tab,    \
           const void* tile_base, const void* chunk_group,                   \
           const void* group_bases, const void* seg_lo, const void* seg_hi,  \
           const void* x, void* acc, void* z, int64_t num_tiles,             \
           int64_t num_rows, int chunk_tiles, int group_hacks,               \
           int window_pages, int unit_segments, void* stream) {              \
    return whell_spmv<T, T>(values, residue, page_tab, tile_base,            \
                            chunk_group, group_bases, seg_lo, seg_hi, x, acc, \
                            z, num_tiles, num_rows, chunk_tiles, group_hacks, \
                            window_pages, unit_segments, stream);            \
  }

WHELL_ENTRY(whell_packed_spmv_f64, double)
WHELL_ENTRY(whell_packed_spmv_c64, float2)
WHELL_ENTRY(whell_packed_spmv_c128, double2)

#undef WHELL_ENTRY

// Kernel #19, float64 values, x, acc and z, aligned or scattered windows:
// level 0 (stream) or 1 (gather) writes every lane sum of the cut tile pass
// to acc (num_tiles x 128; z unused); level 2 (atomic) is the production
// tile pass alone into acc (num_rows x 128, zeroed by the caller; z
// unused); level 3 (full) is whell_packed_spmv_f64.  Launches on `stream`,
// does not synchronise, and returns cudaGetLastError()
// (cudaErrorInvalidValue for another level).
int whell_packed_ablation_f64(int level, const void* values, const void* residue,
                              const void* page_tab, const void* tile_base,
                              const void* chunk_group, const void* group_bases,
                              const void* seg_lo, const void* seg_hi,
                              const void* x, void* acc, void* z,
                              int64_t num_tiles, int64_t num_rows,
                              int chunk_tiles, int group_hacks, int window_pages,
                              int unit_segments, void* stream) {
  if (level == kFull)
    return whell_spmv<double, double>(
        values, residue, page_tab, tile_base, chunk_group, group_bases, seg_lo,
        seg_hi, x, acc, z, num_tiles, num_rows, chunk_tiles, group_hacks,
        window_pages, unit_segments, stream);
  if (level < kStream || level > kFull)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* v = static_cast<const double*>(values);
  auto* res = static_cast<const int8_t*>(residue);
  auto* pt = static_cast<const int8_t*>(page_tab);
  auto* tb = static_cast<const int32_t*>(tile_base);
  auto* cg = static_cast<const int32_t*>(chunk_group);
  auto* gb = static_cast<const int32_t*>(group_bases);
  auto* xt = static_cast<const double*>(x);
  auto* a = static_cast<double*>(acc);
  const int ntab = window_pages / 8;
  if (num_tiles > 0) {
    const dim3 grid(static_cast<unsigned>(num_tiles));
    if (level == kAtomic && gb != nullptr)
      whell_tile_pass<double, double, true><<<grid, kLanes, 0, st>>>(
          v, res, pt, tb, cg, gb, xt, a, chunk_tiles, group_hacks, ntab);
    else if (level == kAtomic)
      whell_tile_pass<double, double, false><<<grid, kLanes, 0, st>>>(
          v, res, pt, tb, cg, gb, xt, a, chunk_tiles, group_hacks, ntab);
    else
      (level == kStream ? launch_ablation<kStream> : launch_ablation<kGather>)(
          v, res, pt, tb, cg, gb, xt, a, num_tiles, chunk_tiles, group_hacks,
          ntab, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel #12: Z (n_rhs x num_rows x 128) = the packed-WHELL product with
// each of n_rhs RHS.  x is the RHS-interleaved (x_pages*128, n_rhs) fp32
// stack; acc (n_rhs x num_rows x 128) must be zeroed by the caller.  fp32
// or bf16 values (values_bf16), fp32 x, acc and z.  Launches on `stream`,
// does not synchronise, and returns cudaGetLastError().
int whell_packed_spmm(const void* values, int values_bf16,
                      const void* residue, const void* page_tab,
                      const void* tile_base, const void* chunk_group,
                      const void* group_bases, const void* seg_lo,
                      const void* seg_hi, const void* x, void* acc, void* z,
                      int64_t num_tiles, int64_t num_rows, int n_rhs,
                      int chunk_tiles, int group_hacks, int window_pages,
                      int unit_segments, void* stream) {
  auto* fn = values_bf16 ? whell_spmm<uint16_t> : whell_spmm<float>;
  return fn(values, residue, page_tab, tile_base, chunk_group, group_bases,
            seg_lo, seg_hi, x, acc, z, num_tiles, num_rows, n_rhs, chunk_tiles,
            group_hacks, window_pages, unit_segments, stream);
}

}  // extern "C"
