// Static-offset DIA (SDIA) SpMV on Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces spgpu_tpu/ops/pallas_kernels.py::_sdia_kernel (called through
// _sdia_spmv_call and sdia_spmv_pallas; entry sdia_spmv, fp32) and
// _sdia_dd_kernel (_sdia_dd_call, sdia_spmv_dd_pallas with the geometry of
// _sdia_geometry(dd=True); entry sdia_spmv_f64, float64 where the TPU
// kernel emulates it with double-float pairs).  It computes the same
// product on the same planes (spgpu_tpu_torch/formats/dia.py):
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
// still nearly fits the 50 MB L2.
//
// What the design does about it: the TPU kernel compiles the offsets into
// the program and builds each diagonal's x operand from VMEM-resident x
// with lane rotations.  Here one thread owns one row: plane reads are
// coalesced (neighbouring threads, neighbouring rows), x reads are
// coalesced shifted runs served from L2, and the row's sum stays in a
// register, so there are no atomics and the result is deterministic.  Each
// step is a rounded multiply and then a rounded add (no fused
// multiply-add), in ascending diagonal order: the plain PyTorch version's
// arithmetic, so the two agree bit for bit.  The
// offsets live in a small device table and are staged through shared
// memory in chunks of one block's width, as spGPU's DIA kernel stages its
// offset list (dia_spmv_base_template.cuh:35-49); any number of diagonals
// works.

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
sdia_spmv_kernel(const T* __restrict__ values,
                 const int32_t* __restrict__ offsets,
                 const T* __restrict__ x, T* __restrict__ z,
                 int n_diags, int64_t plane, int64_t n_rows, int64_t n_cols) {
  __shared__ int32_t off[kThreads];
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  T sum = 0;
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
// cudaGetLastError().  sdia_spmv takes fp32 arrays, sdia_spmv_f64 float64.
int sdia_spmv(const void* values, const void* offsets, const void* x, void* z,
              int n_diags, int64_t plane, int64_t n_rows, int64_t n_cols,
              void* stream) {
  return launch<float>(values, offsets, x, z, n_diags, plane, n_rows, n_cols,
                       stream);
}

int sdia_spmv_f64(const void* values, const void* offsets, const void* x,
                  void* z, int n_diags, int64_t plane, int64_t n_rows,
                  int64_t n_cols, void* stream) {
  return launch<double>(values, offsets, x, z, n_diags, plane, n_rows, n_cols,
                        stream);
}

}  // extern "C"
