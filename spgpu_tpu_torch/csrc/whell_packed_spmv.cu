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

// V: value storage type; T: x, accumulator and output type (T{} is zero)
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
  __shared__ int8_t pt[kSlots][kLanes];
  const int64_t t = blockIdx.x;
  const int j = threadIdx.x;
  const int64_t cell0 = t * (kSlots * kLanes);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) pt[s][j] = page_tab[cell0 + s * kLanes + j];
  const uint32_t meta = static_cast<uint32_t>(tile_base[t]);
  __syncthreads();

  T sum{};
  uint32_t hh;
  if constexpr (kScattered) {
    hh = meta >> 20;
    const int32_t* bases = group_bases + static_cast<int64_t>(meta & 0xFFFFFu) * ntab;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int64_t c = cell0 + s * kLanes + j;
      const int r = residue[c];
      const int d = pt[s][r];
      const int64_t page = bases[d >> 3] + (d & 7);
      sum = mac(load_value(values, c), __ldg(x + page * kLanes + r), sum);
    }
  } else {
    hh = meta >> 16;
    const int64_t base = meta & 0xFFFFu;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int64_t c = cell0 + s * kLanes + j;
      const int r = residue[c];
      const int64_t page = base + pt[s][r];
      sum = mac(load_value(values, c), __ldg(x + page * kLanes + r), sum);
    }
  }
  const int64_t hack = static_cast<int64_t>(chunk_group[t / chunk_tiles]) * group_hacks + hh;
  atomic_add(acc + hack * kLanes + j, sum);
}

// the scan array p is 128 T: 512 B for float, 1 KiB for double and float2,
// 2 KiB for double2
template <typename T, bool kUnit>
__global__ void __launch_bounds__(kLanes)
whell_flush_pass(const T* __restrict__ acc,
                 const int8_t* __restrict__ seg_lo,
                 const int8_t* __restrict__ seg_hi, T* __restrict__ z) {
  __shared__ T p[kLanes];
  __shared__ T warp_total[kLanes / 32];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kLanes + threadIdx.x;
  const int j = threadIdx.x;
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
  if (num_rows > 0) {
    auto* lo = static_cast<const int8_t*>(seg_lo);
    auto* hi = static_cast<const int8_t*>(seg_hi);
    auto* zt = static_cast<T*>(z);
    const dim3 grid(static_cast<unsigned>(num_rows));
    if (unit_segments)
      whell_flush_pass<T, true><<<grid, kLanes, 0, st>>>(a, lo, hi, zt);
    else
      whell_flush_pass<T, false><<<grid, kLanes, 0, st>>>(a, lo, hi, zt);
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

}  // extern "C"
