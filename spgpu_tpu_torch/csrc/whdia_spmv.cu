// Windowed hacked DIA (WHDIA) SpMV on Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces spgpu_tpu/ops/pallas_kernels.py::_whdia_kernel (kernel #3; body
// _whdia_kernel_body, r0 unpacking _whdia_tile_r0; called through
// _whdia_spmv_call and whdia_spmv_pallas; entry whdia_spmv, fp32) and
// _whdia_dd_kernel (_whdia_dd_call, whdia_spmv_dd_pallas; entry
// whdia_spmv_f64, float64 where the TPU kernel emulates it with
// double-float pairs and slab-mode r0 only), _whdia_cplx_kernel
// (_whdia_cplx_call, whdia_spmv_cplx_pallas; entry whdia_spmv_c64, complex64,
// both r0 modes) and _whdia_z_kernel (_whdia_z_call, whdia_spmv_z_pallas;
// entry whdia_spmv_c128, complex128 where the TPU kernel runs four
// double-float slabs, slab-mode r0 only; here both modes).  It computes the
// same product on the same layout arrays (spgpu_tpu_torch/formats/whdia.py):
//
//   for every cell (slot s, lane j) of tile t = s / 8:
//     base = tile_base[t] & 0xFFFF,  hh = tile_base[t] >> 16
//     r0   = slot_r0[s]                                     (slab mode)
//          = r00 + step*min(s % 8, F-1) from tile_r0[t]     (pattern mode)
//     hack = chunk_group[t / chunk_tiles] * group_hacks + hh
//     z[hack*128 + j] += values[s, j] * x[base*128 + r0 + j]
//
// with x[c] read as 0 outside [0, n_cols).  The TPU kernel reaches x
// through a window-clamped rotation of VMEM-resident pages; for every
// nonzero cell the column base*128 + r0 + j is the cell's own column, and
// dead slots and diagonal ends hold 0, so the direct guarded read gives
// the same product for finite x.
//
// Bound on the H100: the value slab streams once, 4 B per cell (+2 B per
// slot of r0 in slab mode), and the chunk padding tiles stream too.  On
// the 1,048,576-row 2-D Laplacian the layout is 16,384 tiles, 64 MiB of
// values (3.2 cells per nonzero), about 20 us at 3.35 TB/s; x (4 MiB) and
// z (4 MiB) stay in the 50 MB L2.  float64 doubles the value bytes and the
// vectors: about 128 MiB of slab and 16 MiB of x and z on the Laplacian,
// ~45 us.  complex64 moves 8 B per cell (an interleaved re/im float2) on
// the fp32 geometry: 151.3 MB on the Laplacian (16,384 tiles), 45.2 us, and
// 75.6 MB on banded-11, 22.6 us; complex128 16 B per cell on the float64
// geometry: 167.9 MB on the Laplacian (8,192 tiles), 50.1 us, and 147.4 MB
// on banded-11, 44.0 us (chip_smoke.py's counts).
//
// What the design does about it: kernel #1's tile pass, without pages.
// One 128-thread block per tile; thread j reads its lane of the 8 slots
// (coalesced), gathers x at the slot's contiguous shifted run (coalesced,
// from L2), sums in a register and issues one atomicAdd into the zeroed
// row hack*128 + j (atomicAdd(double) is native on Hopper).  WHDIA has no
// lane segments, so there is no flush pass.  Atomic order varies, so
// results are not bit-reproducible.  Complex: one float2 / double2 load per
// cell and per x entry, four FMAs per cell (re += vr*xr; re -= vi*xi;
// im += vr*xi; im += vi*xr) into re and im sums, and two atomicAdds, one
// on each component of the row's output.
//
// SpMM (entry whdia_spmm, kernel #13) replaces _whdia_spmm_kernel
// (_whdia_spmm_call, whdia_spmm_pallas), fp32, both r0 modes: Z[r] = A x[r]
// for n_rhs RHS.  r0 is decoded once per slot (slab or pattern word), the
// column and its [0, n_cols) guard once per cell, the value once into a
// register; then RHS blocks of kRhs = 8 (a remainder block takes any
// n_rhs) read x[r] at the slot's shifted run (coalesced across the warp,
// so x keeps its natural (n_rhs, n_cols) layout) and issue one atomicAdd
// per (RHS, lane).  Bound: the slab and r0 once plus x and z per RHS,
// about 67 MB and 20 us for 8 RHS on banded-11.  No RHS passes or VMEM
// checks: one launch takes any n_rhs.  Atomic order varies.
//
// Ablation (entry whdia_ablation, kernel #18) replaces the `call` closure of
// doc/sweeps/whdia_ablation.py (its pallas_call body adds one op family of
// _whdia_kernel at a time, at the production geometry): the per-op account
// of #3 in fp32.  The levels are the production tile body (whdia_tile, which
// whdia_tile_pass instantiates at kFull) cut after one family: stream (the
// value slab, 4 B/cell), r0 (+ the r0 decode and the column), gather (+ the
// guarded x read: the production tile sum) and full (+ one atomicAdd per
// lane: the production launch).  Below full each lane's sum is stored to a
// (num_tiles, 128) part array, 512 B per tile, the same in every level, so
// the differences between levels price one family each; a level's sum
// depends on every value it loads, so nvcc drops none.  The TPU's sublane
// and lane gathers are one cached global load here, and its dual-plane
// accumulate and flush one atomic: those TPU levels have no separate
// counterpart.  Bound: that of #3 on the same layout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kSlots = 8;

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
// levels): kStream reads the values only, kR0 adds the r0 decode and the
// column, kGather the guarded x read (the production tile sum), kFull the
// atomicAdd into the hack row.  Below kFull the lane's sum goes to z[t, j]
// with a plain store (z is then the (num_tiles, 128) part array).
enum Level : int { kStream = 0, kR0 = 1, kGather = 2, kFull = 3 };

template <typename T, bool kPattern, int kLevel>
__device__ __forceinline__ void whdia_tile(const T* __restrict__ values,
                                           const int16_t* __restrict__ slot_r0,
                                           const int32_t* __restrict__ tile_r0,
                                           const int32_t* __restrict__ tile_base,
                                           const int32_t* __restrict__ chunk_group,
                                           const T* __restrict__ x, T* __restrict__ z,
                                           int64_t n_cols, int chunk_tiles,
                                           int group_hacks) {
  const int64_t t = blockIdx.x;
  const int j = threadIdx.x;
  T sum{};
  if constexpr (kLevel == kStream) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s)
      sum = mac(__ldg(values + (t * kSlots + s) * kLanes + j), T(1.5f), sum);
    z[t * kLanes + j] = sum;
  } else {
    const uint32_t meta = static_cast<uint32_t>(tile_base[t]);
    const int64_t c0 = static_cast<int64_t>(meta & 0xFFFFu) * kLanes + j;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int64_t slot = t * kSlots + s;
      const int64_t c = c0 + slot_r0_of<kPattern>(slot_r0, tile_r0, t, s);
      const T v = __ldg(values + slot * kLanes + j);
      if constexpr (kLevel == kR0)  // keeps the column live: v * (c & 127)
        sum = mac(v, static_cast<T>(c & (kLanes - 1)), sum);
      else if (c >= 0 && c < n_cols)
        sum = mac(v, __ldg(x + c), sum);
    }
    if constexpr (kLevel == kFull) {
      const int64_t hack =
          static_cast<int64_t>(chunk_group[t / chunk_tiles]) * group_hacks + (meta >> 16);
      atomic_add(z + hack * kLanes + j, sum);
    } else {
      z[t * kLanes + j] = sum;
    }
  }
}

template <typename T, bool kPattern>
__global__ void __launch_bounds__(kLanes)
whdia_tile_pass(const T* __restrict__ values,
                const int16_t* __restrict__ slot_r0,
                const int32_t* __restrict__ tile_r0,
                const int32_t* __restrict__ tile_base,
                const int32_t* __restrict__ chunk_group,
                const T* __restrict__ x, T* __restrict__ z,
                int64_t n_cols, int chunk_tiles, int group_hacks) {
  whdia_tile<T, kPattern, kFull>(values, slot_r0, tile_r0, tile_base, chunk_group,
                                 x, z, n_cols, chunk_tiles, group_hacks);
}

// kernel #18's levels below kFull, fp32: the production tile pass cut
// after one op family, its lane sums stored to part (num_tiles, 128)
template <bool kPattern, int kLevel>
__global__ void __launch_bounds__(kLanes)
whdia_ablation_pass(const float* __restrict__ values,
                    const int16_t* __restrict__ slot_r0,
                    const int32_t* __restrict__ tile_r0,
                    const int32_t* __restrict__ tile_base,
                    const int32_t* __restrict__ chunk_group,
                    const float* __restrict__ x, float* __restrict__ part,
                    int64_t n_cols, int chunk_tiles, int group_hacks) {
  whdia_tile<float, kPattern, kLevel>(values, slot_r0, tile_r0, tile_base,
                                      chunk_group, x, part, n_cols, chunk_tiles,
                                      group_hacks);
}

// SpMM tile pass (kernel #13): r0 and the x column of each of the lane's 8
// slots are decoded once, with the [0, n_cols) guard and the value kept in
// registers; then every RHS block of kRhs takes 8 guarded reads of x[r]
// (n_rhs, n_cols) and one atomicAdd per (RHS, lane) into z[r]
// (n_rhs, z_rows).
constexpr int kRhs = 8;

template <bool kPattern>
__global__ void __launch_bounds__(kLanes)
whdia_spmm_tile_pass(const float* __restrict__ values,
                     const int16_t* __restrict__ slot_r0,
                     const int32_t* __restrict__ tile_r0,
                     const int32_t* __restrict__ tile_base,
                     const int32_t* __restrict__ chunk_group,
                     const float* __restrict__ x, float* __restrict__ z,
                     int64_t n_cols, int64_t z_rows, int n_rhs,
                     int chunk_tiles, int group_hacks) {
  const int64_t t = blockIdx.x;
  const int j = threadIdx.x;
  const uint32_t meta = static_cast<uint32_t>(tile_base[t]);
  const int64_t c0 = static_cast<int64_t>(meta & 0xFFFFu) * kLanes + j;
  float v[kSlots];
  int64_t col[kSlots];
  bool in[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int64_t slot = t * kSlots + s;
    col[s] = c0 + slot_r0_of<kPattern>(slot_r0, tile_r0, t, s);
    in[s] = col[s] >= 0 && col[s] < n_cols;
    v[s] = __ldg(values + slot * kLanes + j);
  }
  const int64_t hack =
      static_cast<int64_t>(chunk_group[t / chunk_tiles]) * group_hacks + (meta >> 16);
  for (int rb = 0; rb < n_rhs; rb += kRhs) {
    const int w = min(kRhs, n_rhs - rb);
    float sum[kRhs];
#pragma unroll
    for (int q = 0; q < kRhs; ++q) sum[q] = 0.0f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (!in[s]) continue;
      const float* xs = x + (static_cast<int64_t>(rb) * n_cols + col[s]);
#pragma unroll
      for (int q = 0; q < kRhs; ++q)
        if (q < w) sum[q] = mac(v[s], __ldg(xs + q * n_cols), sum[q]);
    }
    float* out = z + static_cast<int64_t>(rb) * z_rows + hack * kLanes + j;
#pragma unroll
    for (int q = 0; q < kRhs; ++q)
      if (q < w) atomicAdd(out + q * z_rows, sum[q]);
  }
}

template <typename T>
int launch(const void* values, const void* slot_r0, const void* tile_r0,
           const void* tile_base, const void* chunk_group, const void* x,
           void* z, int64_t num_tiles, int64_t n_cols, int chunk_tiles,
           int group_hacks, void* stream) {
  if (num_tiles > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(static_cast<unsigned>(num_tiles));
    auto* v = static_cast<const T*>(values);
    auto* sr = static_cast<const int16_t*>(slot_r0);
    auto* tr = static_cast<const int32_t*>(tile_r0);
    auto* tb = static_cast<const int32_t*>(tile_base);
    auto* cg = static_cast<const int32_t*>(chunk_group);
    auto* xt = static_cast<const T*>(x);
    auto* zt = static_cast<T*>(z);
    if (tr != nullptr)
      whdia_tile_pass<T, true><<<grid, kLanes, 0, st>>>(
          v, sr, tr, tb, cg, xt, zt, n_cols, chunk_tiles, group_hacks);
    else
      whdia_tile_pass<T, false><<<grid, kLanes, 0, st>>>(
          v, sr, tr, tb, cg, xt, zt, n_cols, chunk_tiles, group_hacks);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kLevel>
void launch_ablation(const float* v, const int16_t* sr, const int32_t* tr,
                     const int32_t* tb, const int32_t* cg, const float* x,
                     float* part, int64_t num_tiles, int64_t n_cols,
                     int chunk_tiles, int group_hacks, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(num_tiles));
  if (tr != nullptr)
    whdia_ablation_pass<true, kLevel><<<grid, kLanes, 0, st>>>(
        v, sr, tr, tb, cg, x, part, n_cols, chunk_tiles, group_hacks);
  else
    whdia_ablation_pass<false, kLevel><<<grid, kLanes, 0, st>>>(
        v, sr, tr, tb, cg, x, part, n_cols, chunk_tiles, group_hacks);
}

}  // namespace

extern "C" {

// Kernel #18, fp32, either r0 mode: level 0 (stream), 1 (r0) or 2
// (gather) writes every lane sum of the cut tile pass to out (num_tiles x
// 128); level 3 (full) is whdia_spmv, out then the zeroed z.  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError()
// (cudaErrorInvalidValue for another level).
int whdia_ablation(int level, const void* values, const void* slot_r0,
                   const void* tile_r0, const void* tile_base,
                   const void* chunk_group, const void* x, void* out,
                   int64_t num_tiles, int64_t n_cols, int chunk_tiles,
                   int group_hacks, void* stream) {
  if (level == kFull)
    return launch<float>(values, slot_r0, tile_r0, tile_base, chunk_group, x,
                         out, num_tiles, n_cols, chunk_tiles, group_hacks, stream);
  if (level < kStream || level > kFull)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_tiles > 0) {
    auto* fn = level == kStream ? launch_ablation<kStream>
               : level == kR0   ? launch_ablation<kR0>
                                : launch_ablation<kGather>;
    fn(static_cast<const float*>(values), static_cast<const int16_t*>(slot_r0),
       static_cast<const int32_t*>(tile_r0), static_cast<const int32_t*>(tile_base),
       static_cast<const int32_t*>(chunk_group), static_cast<const float*>(x),
       static_cast<float*>(out), num_tiles, n_cols, chunk_tiles, group_hacks,
       static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

// z (num_groups*group_hacks*128, zeroed by the caller) += WHDIA product of
// the slab and x (n_cols).  Exactly one of slot_r0 (slab mode) and tile_r0
// (pattern mode) is non-null.  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError().  whdia_spmv takes fp32 values, x and z,
// whdia_spmv_f64 float64 ones, whdia_spmv_c64 complex64 and whdia_spmv_c128
// complex128 ones (interleaved re/im).
#define WHDIA_ENTRY(NAME, T)                                                  \
  int NAME(const void* values, const void* slot_r0, const void* tile_r0,     \
           const void* tile_base, const void* chunk_group, const void* x,    \
           void* z, int64_t num_tiles, int64_t n_cols, int chunk_tiles,      \
           int group_hacks, void* stream) {                                  \
    return launch<T>(values, slot_r0, tile_r0, tile_base, chunk_group, x, z, \
                     num_tiles, n_cols, chunk_tiles, group_hacks, stream);   \
  }

WHDIA_ENTRY(whdia_spmv, float)
WHDIA_ENTRY(whdia_spmv_f64, double)
WHDIA_ENTRY(whdia_spmv_c64, float2)
WHDIA_ENTRY(whdia_spmv_c128, double2)

#undef WHDIA_ENTRY

// Kernel #13: z (n_rhs x z_rows, zeroed by the caller; z_rows =
// num_groups*group_hacks*128) += the WHDIA product with each row of x
// (n_rhs x n_cols), fp32.  r0 as in whdia_spmv.  Launches on `stream`,
// does not synchronise, and returns cudaGetLastError().
int whdia_spmm(const void* values, const void* slot_r0, const void* tile_r0,
               const void* tile_base, const void* chunk_group, const void* x,
               void* z, int64_t num_tiles, int64_t n_cols, int64_t z_rows,
               int n_rhs, int chunk_tiles, int group_hacks, void* stream) {
  if (num_tiles > 0 && n_rhs > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(static_cast<unsigned>(num_tiles));
    auto* v = static_cast<const float*>(values);
    auto* sr = static_cast<const int16_t*>(slot_r0);
    auto* tr = static_cast<const int32_t*>(tile_r0);
    auto* tb = static_cast<const int32_t*>(tile_base);
    auto* cg = static_cast<const int32_t*>(chunk_group);
    auto* xt = static_cast<const float*>(x);
    auto* zt = static_cast<float*>(z);
    if (tr != nullptr)
      whdia_spmm_tile_pass<true><<<grid, kLanes, 0, st>>>(
          v, sr, tr, tb, cg, xt, zt, n_cols, z_rows, n_rhs, chunk_tiles,
          group_hacks);
    else
      whdia_spmm_tile_pass<false><<<grid, kLanes, 0, st>>>(
          v, sr, tr, tb, cg, xt, zt, n_cols, z_rows, n_rhs, chunk_tiles,
          group_hacks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
