// Static-offset DIA (SDIA) SpMV on Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces spgpu_tpu/ops/pallas_kernels.py::_sdia_kernel (called through
// _sdia_spmv_call and sdia_spmv_pallas).  It computes the same product on
// the same planes (spgpu_tpu_torch/formats/dia.py):
//
//   z[r] = sum_j values[j*R + r] * x[r + offsets[j]]     (0 <= r < n_rows)
//
// with R = n_tiles*1024 the plane length and x[c] read as 0 outside
// [0, n_cols).
//
// Bound on the H100: every plane streams once, 4 B per cell, plus x and
// z: on the 1,048,576-row 2-D Laplacian (5 diagonals) 20 MiB of values,
// 4 MiB of x and 4 MiB of z, about 8.8 us at 3.35 TB/s.
//
// What the design does about it: the TPU kernel compiles the offsets into
// the program and builds each diagonal's x operand from VMEM-resident x
// with lane rotations.  Here one thread owns one row: plane reads are
// coalesced (neighbouring threads, neighbouring rows), x reads are
// coalesced shifted runs served from L2, and the row's sum stays in a
// register, so there are no atomics and the result is deterministic.  The
// offsets live in a small device table and are staged through shared
// memory in chunks of one block's width, as spGPU's DIA kernel stages its
// offset list (dia_spmv_base_template.cuh:35-49); any number of diagonals
// works.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sdia_spmv_kernel(const float* __restrict__ values,
                 const int32_t* __restrict__ offsets,
                 const float* __restrict__ x, float* __restrict__ z,
                 int n_diags, int64_t plane, int64_t n_rows, int64_t n_cols) {
  __shared__ int32_t off[kThreads];
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  float sum = 0.f;
  for (int j0 = 0; j0 < n_diags; j0 += kThreads) {
    const int nj = min(kThreads, n_diags - j0);
    __syncthreads();  // the previous chunk is no longer read
    if (threadIdx.x < nj) off[threadIdx.x] = offsets[j0 + threadIdx.x];
    __syncthreads();
    if (r < n_rows) {
      const float* v = values + static_cast<int64_t>(j0) * plane + r;
      for (int j = 0; j < nj; ++j) {
        const int64_t c = r + off[j];
        if (c >= 0 && c < n_cols) sum = fmaf(__ldg(v), __ldg(x + c), sum);
        v += plane;
      }
    }
  }
  if (r < n_rows) z[r] = sum;
}

}  // namespace

extern "C" {

// z (n_rows fp32) = SDIA product of values (n_diags planes of `plane`
// fp32 each) and x (n_cols fp32); offsets is a device int32 table of
// n_diags entries.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError().
int sdia_spmv(const void* values, const void* offsets, const void* x, void* z,
              int n_diags, int64_t plane, int64_t n_rows, int64_t n_cols,
              void* stream) {
  if (n_rows > 0) {
    const dim3 grid(static_cast<unsigned>((n_rows + kThreads - 1) / kThreads));
    sdia_spmv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(values), static_cast<const int32_t*>(offsets),
        static_cast<const float*>(x), static_cast<float*>(z), n_diags, plane,
        n_rows, n_cols);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
