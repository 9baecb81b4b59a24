// Static-offset DIA (SDIA) SpMV on Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces spgpu_tpu/ops/pallas_kernels.py::_sdia_kernel (called through
// _sdia_spmv_call and sdia_spmv_pallas; entry sdia_spmv, fp32) and
// _sdia_dd_kernel (_sdia_dd_call, sdia_spmv_dd_pallas with the geometry of
// _sdia_geometry(dd=True); entry sdia_spmv_f64, float64 where the TPU
// kernel emulates it with double-float pairs), _sdia_cplx_kernel
// (_sdia_cplx_call, sdia_spmv_cplx_pallas; entry sdia_spmv_c64, complex64)
// and _sdia_z_kernel with _sdia_xwin (_sdia_z_call, sdia_spmv_z_pallas;
// entry sdia_spmv_c128, complex128 where the TPU kernel runs four
// double-float planes).  It computes the same product on the same planes
// (spgpu_tpu_torch/formats/dia.py):
//
//   z[r] = sum_j values[j*R + r] * x[r + offsets[j]]     (0 <= r < n_rows)
//
// with R = n_tiles*1024 the plane length and x[c] read as 0 outside
// [0, n_cols).
//
// Bound on the H100: every plane streams once, 4 B per cell, plus x and
// z: on the 1,048,576-row 2-D Laplacian (5 diagonals) 20 MiB of values,
// 4 MiB of x and 4 MiB of z, about 8.8 us at 3.35 TB/s.  float64 doubles
// every byte: 40 + 8 + 8 = 56 MiB, about 17.5 us, a working set that
// still nearly fits the 50 MB L2.  complex64 moves float64's bytes (8 B
// per cell, an interleaved re/im float2): 58.7 MB, 17.5 us; complex128
// twice that (16 B per cell, a double2): 117.4 MB, 35.1 us (chip_smoke.py's
// counts on the Laplacian).
//
// What the design does about it: the TPU kernel compiles the offsets into
// the program and builds each diagonal's x operand from VMEM-resident x
// with lane rotations.  Here one thread owns one row: plane reads are
// coalesced (neighbouring threads, neighbouring rows), x reads are
// coalesced shifted runs served from L2, and the row's sum stays in a
// register, so there are no atomics and the result is deterministic.  Each
// step is a rounded multiply and then a rounded add (no fused
// multiply-add), in ascending diagonal order: the plain PyTorch version's
// arithmetic, so the two agree bit for bit.  A complex cell is one float2 /
// double2 load, and its step rounds every operation, in the order of the
// JAX kernel (pallas_kernels.py, _sdia_cplx_kernel): cr = vr*xr - vi*xi,
// ci = vr*xi + vi*xr, then sum.re += cr and sum.im += ci.  The
// plain version does the same on the real and imaginary components with
// separate multiplies, subtract and adds, so complex agrees bit for bit
// too.  The
// offsets live in a small device table and are staged through shared
// memory in chunks of one block's width, as spGPU's DIA kernel stages its
// offset list (dia_spmv_base_template.cuh:35-49); any number of diagonals
// works.
//
// SpMM (entry sdia_spmm, kernel #14) replaces _sdia_spmm_kernel
// (_sdia_spmm_call, sdia_spmm_pallas), fp32: Z[r] = A x[r] for n_rhs RHS,
// x (n_rhs, n_cols), z (n_rhs, n_rows).  The same thread per row holds the
// sums of a block of kRhs = 8 RHS in registers (a remainder block takes
// any n_rhs), so each value values[j, row] is read once per block and
// serves all of its RHS; every RHS is summed in ascending diagonal order
// with __fmul_rn then __fadd_rn, the order and roundings of kernel #2, so
// the result equals n_rhs launches of sdia_spmv bit for bit.  Bound: the
// planes once plus x and z per RHS, about 88 MB and 26 us for 8 RHS on
// the Laplacian.  No RHS passes or VMEM checks: one launch takes any n_rhs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// sum + v*x with two roundings, never contracted into an FMA
__device__ __forceinline__ float mul_add(float v, float x, float sum) {
  return __fadd_rn(sum, __fmul_rn(v, x));
}

__device__ __forceinline__ double mul_add(double v, double x, double sum) {
  return __dadd_rn(sum, __dmul_rn(v, x));
}

__device__ __forceinline__ float2 mul_add(float2 v, float2 x, float2 sum) {
  const float cr = __fsub_rn(__fmul_rn(v.x, x.x), __fmul_rn(v.y, x.y));
  const float ci = __fadd_rn(__fmul_rn(v.x, x.y), __fmul_rn(v.y, x.x));
  return make_float2(__fadd_rn(sum.x, cr), __fadd_rn(sum.y, ci));
}

__device__ __forceinline__ double2 mul_add(double2 v, double2 x, double2 sum) {
  const double cr = __dsub_rn(__dmul_rn(v.x, x.x), __dmul_rn(v.y, x.y));
  const double ci = __dadd_rn(__dmul_rn(v.x, x.y), __dmul_rn(v.y, x.x));
  return make_double2(__dadd_rn(sum.x, cr), __dadd_rn(sum.y, ci));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sdia_spmv_kernel(const T* __restrict__ values,
                 const int32_t* __restrict__ offsets,
                 const T* __restrict__ x, T* __restrict__ z,
                 int n_diags, int64_t plane, int64_t n_rows, int64_t n_cols) {
  __shared__ int32_t off[kThreads];
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  T sum{};
  for (int j0 = 0; j0 < n_diags; j0 += kThreads) {
    const int nj = min(kThreads, n_diags - j0);
    __syncthreads();  // the previous chunk is no longer read
    if (threadIdx.x < nj) off[threadIdx.x] = offsets[j0 + threadIdx.x];
    __syncthreads();
    if (r < n_rows) {
      const T* v = values + static_cast<int64_t>(j0) * plane + r;
      for (int j = 0; j < nj; ++j) {
        const int64_t c = r + off[j];
        if (c >= 0 && c < n_cols) sum = mul_add(__ldg(v), __ldg(x + c), sum);
        v += plane;
      }
    }
  }
  if (r < n_rows) z[r] = sum;
}

// SpMM (kernel #14): one thread per row, offsets staged as above; each
// value is loaded once per RHS block of kRhs and used for every RHS in
// it, each RHS summed in kernel #2's order with its roundings
constexpr int kRhs = 8;

__global__ void __launch_bounds__(kThreads)
sdia_spmm_kernel(const float* __restrict__ values,
                 const int32_t* __restrict__ offsets,
                 const float* __restrict__ x, float* __restrict__ z,
                 int n_diags, int64_t plane, int64_t n_rows, int64_t n_cols,
                 int n_rhs) {
  __shared__ int32_t off[kThreads];
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (int rb = 0; rb < n_rhs; rb += kRhs) {
    const int w = min(kRhs, n_rhs - rb);
    const float* xb = x + static_cast<int64_t>(rb) * n_cols;
    float sum[kRhs];
#pragma unroll
    for (int q = 0; q < kRhs; ++q) sum[q] = 0.0f;
    for (int j0 = 0; j0 < n_diags; j0 += kThreads) {
      const int nj = min(kThreads, n_diags - j0);
      __syncthreads();  // the previous chunk is no longer read
      if (threadIdx.x < nj) off[threadIdx.x] = offsets[j0 + threadIdx.x];
      __syncthreads();
      if (r < n_rows) {
        const float* v = values + static_cast<int64_t>(j0) * plane + r;
        for (int j = 0; j < nj; ++j) {
          const int64_t c = r + off[j];
          if (c >= 0 && c < n_cols) {
            const float vj = __ldg(v);
#pragma unroll
            for (int q = 0; q < kRhs; ++q)
              if (q < w) sum[q] = mul_add(vj, __ldg(xb + q * n_cols + c), sum[q]);
          }
          v += plane;
        }
      }
    }
    if (r < n_rows) {
#pragma unroll
      for (int q = 0; q < kRhs; ++q)
        if (q < w) z[(rb + q) * n_rows + r] = sum[q];
    }
  }
}

template <typename T>
int launch(const void* values, const void* offsets, const void* x, void* z,
           int n_diags, int64_t plane, int64_t n_rows, int64_t n_cols,
           void* stream) {
  if (n_rows > 0) {
    const dim3 grid(static_cast<unsigned>((n_rows + kThreads - 1) / kThreads));
    sdia_spmv_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(values), static_cast<const int32_t*>(offsets),
        static_cast<const T*>(x), static_cast<T*>(z), n_diags, plane, n_rows,
        n_cols);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// z (n_rows) = SDIA product of values (n_diags planes of `plane` entries
// each) and x (n_cols); offsets is a device int32 table of n_diags
// entries.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().  sdia_spmv takes fp32 arrays, sdia_spmv_f64 float64,
// sdia_spmv_c64 complex64 and sdia_spmv_c128 complex128 (interleaved re/im).
#define SDIA_ENTRY(NAME, T)                                                \
  int NAME(const void* values, const void* offsets, const void* x, void* z, \
           int n_diags, int64_t plane, int64_t n_rows, int64_t n_cols,     \
           void* stream) {                                                 \
    return launch<T>(values, offsets, x, z, n_diags, plane, n_rows, n_cols, \
                     stream);                                              \
  }

SDIA_ENTRY(sdia_spmv, float)
SDIA_ENTRY(sdia_spmv_f64, double)
SDIA_ENTRY(sdia_spmv_c64, float2)
SDIA_ENTRY(sdia_spmv_c128, double2)

#undef SDIA_ENTRY

// Kernel #14: z (n_rhs x n_rows) = the SDIA product with each row of x
// (n_rhs x n_cols), fp32; bit-identical to n_rhs launches of sdia_spmv.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
int sdia_spmm(const void* values, const void* offsets, const void* x, void* z,
              int n_diags, int64_t plane, int64_t n_rows, int64_t n_cols,
              int n_rhs, void* stream) {
  if (n_rows > 0 && n_rhs > 0) {
    const dim3 grid(static_cast<unsigned>((n_rows + kThreads - 1) / kThreads));
    sdia_spmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(values), static_cast<const int32_t*>(offsets),
        static_cast<const float*>(x), static_cast<float*>(z), n_diags, plane,
        n_rows, n_cols, n_rhs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
