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
//     col = ((tile_base[t] & 0xFFFF) + d) * 128 + r
//     hack = chunk_group[t / 64] * 8 + (tile_base[t] >> 16)
//     z[hack*128 + j] += float(values[s, j]) * x[col]
//
// i.e. the stored row hack*128 + j.  The OELL output scatter (row_perm),
// the way-split reduction and the alpha/beta epilogue stay in the op
// (spgpu_tpu_torch/ops/__init__.py), as the JAX wrapper keeps them outside
// its kernel.  Padding cells hold value 0 and an in-range page (a window's
// base + 7 < x_pages), so they need no branch.  A classic chunk_group has
// no trailing sentinel: one entry per 64-tile chunk.
//
// Bound on the H100: the slab streams once per product at 6 B/cell for
// fp32 values (4 B value + int8 residue + int8 page entry; 4 B/cell for
// bf16), x and z once.  The classic layout pads more than the packed one
// (7.54 cells per nonzero on the relabelled flagship FEM matrix against
// 1.74): about 289 MiB of slab there, ~0.091 ms at 3.35 TB/s.  Every
// cell's x gather is one cached 4 B read; x (1 MiB) stays in L2.
//
// What the design does about it: the TPU kernel stages x in VMEM, routes
// pages by sublane gathers and carries an (8, 8, 128) accumulator block
// across the sequential chunk grid; none of that is needed here.  One
// 128-thread block per tile: the tile's 8x128 page table goes to shared
// memory for the by-residue lookup, each thread sums its lane over the 8
// slots in a register and issues one atomicAdd into z (none when the sum
// is 0, as on an all-padding lane).  A hack's tiles are contiguous inside
// its 8-hack group, so per-hack ownership without atomics is possible;
// it is later work.  Atomic order varies, so sums are not
// bit-reproducible.
//
// SpMM (kernel #16): each lane's 8 cells are decoded once (value and x
// row in registers) and serve every RHS in blocks of kRhs = 8 held in
// registers, with a runtime remainder (any n_rhs), and one atomicAdd per
// (RHS, lane) into z (n_rhs, rows_padded).  As kernel #12's wrapper does,
// the wrapper copies X into an RHS-interleaved (x_pages*128, n_rhs)
// buffer, so one cell's 8 RHS sit in one 32 B sector.  The TPU kernel's
// per-RHS fori loop and X VMEM staging have no counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kSlots = 8;
constexpr int kChunkTiles = 64;  // spgpu_tpu_torch.core.CHUNK_TILES
constexpr int kGroupHacks = 8;
constexpr int kRhs = 8;

__device__ __forceinline__ float load_value(const float* v, int64_t i) {
  return __ldg(v + i);
}

// bf16 bits -> fp32 (exact: a bf16 is the top half of an fp32)
__device__ __forceinline__ float load_value(const uint16_t* v, int64_t i) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(v + i)) << 16);
}

// x column of slot s's cell whose residue is r, through the tile's page
// table (staged in shared memory) and its window's base page
__device__ __forceinline__ int64_t cell_column(const int8_t (&pt)[kSlots][kLanes],
                                               int s, int r, uint32_t meta) {
  return (static_cast<int64_t>(meta & 0xFFFFu) + pt[s][r]) * kLanes + r;
}

// the stored-row hack of tile t: its chunk's 8-hack group, then hh
__device__ __forceinline__ int64_t tile_hack(const int32_t* __restrict__ chunk_group,
                                             int64_t t, uint32_t meta) {
  return static_cast<int64_t>(chunk_group[t / kChunkTiles]) * kGroupHacks + (meta >> 16);
}

// stage tile t's 8x128 page table in shared memory (thread j copies its
// lane of every slot); returns the tile's meta word.  Every thread of the
// block calls it: it ends with a barrier.
__device__ __forceinline__ uint32_t stage_tile(int8_t (&pt)[kSlots][kLanes],
                                               const int8_t* __restrict__ page_tab,
                                               const int32_t* __restrict__ tile_base,
                                               int64_t t, int j) {
  const int64_t cell0 = t * (kSlots * kLanes);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) pt[s][j] = page_tab[cell0 + s * kLanes + j];
  const uint32_t meta = static_cast<uint32_t>(tile_base[t]);
  __syncthreads();
  return meta;
}

template <typename V>
__global__ void __launch_bounds__(kLanes)
classic_spmv_tile(const V* __restrict__ values,
                  const int8_t* __restrict__ residue,
                  const int8_t* __restrict__ page_tab,
                  const int32_t* __restrict__ tile_base,
                  const int32_t* __restrict__ chunk_group,
                  const float* __restrict__ x, float* __restrict__ z) {
  __shared__ int8_t pt[kSlots][kLanes];
  const int64_t t = blockIdx.x;
  const int j = threadIdx.x;
  const int64_t cell0 = t * (kSlots * kLanes);
  const uint32_t meta = stage_tile(pt, page_tab, tile_base, t, j);
  float sum = 0.0f;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int64_t c = cell0 + s * kLanes + j;
    sum = fmaf(load_value(values, c), __ldg(x + cell_column(pt, s, residue[c], meta)), sum);
  }
  if (sum != 0.0f) atomicAdd(z + tile_hack(chunk_group, t, meta) * kLanes + j, sum);
}

template <typename V>
__global__ void __launch_bounds__(kLanes)
classic_spmm_tile(const V* __restrict__ values,
                  const int8_t* __restrict__ residue,
                  const int8_t* __restrict__ page_tab,
                  const int32_t* __restrict__ tile_base,
                  const int32_t* __restrict__ chunk_group,
                  const float* __restrict__ x, float* __restrict__ z,
                  int64_t rows_padded, int n_rhs) {
  __shared__ int8_t pt[kSlots][kLanes];
  const int64_t t = blockIdx.x;
  const int j = threadIdx.x;
  const int64_t cell0 = t * (kSlots * kLanes);
  const uint32_t meta = stage_tile(pt, page_tab, tile_base, t, j);
  float v[kSlots];
  int64_t xrow[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int64_t c = cell0 + s * kLanes + j;
    v[s] = load_value(values, c);
    xrow[s] = cell_column(pt, s, residue[c], meta) * n_rhs;
  }
  float* out = z + tile_hack(chunk_group, t, meta) * kLanes + j;
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
        if (q < w) sum[q] = fmaf(v[s], __ldg(xs + q), sum[q]);
    }
#pragma unroll
    for (int q = 0; q < kRhs; ++q)
      if (q < w && sum[q] != 0.0f) atomicAdd(out + (r0 + q) * rows_padded, sum[q]);
  }
}

template <typename V>
int classic_spmv(const void* values, const void* residue, const void* page_tab,
                 const void* tile_base, const void* chunk_group, const void* x,
                 void* z, int64_t num_tiles, cudaStream_t st) {
  if (num_tiles > 0)
    classic_spmv_tile<V><<<static_cast<unsigned>(num_tiles), kLanes, 0, st>>>(
        static_cast<const V*>(values), static_cast<const int8_t*>(residue),
        static_cast<const int8_t*>(page_tab), static_cast<const int32_t*>(tile_base),
        static_cast<const int32_t*>(chunk_group), static_cast<const float*>(x),
        static_cast<float*>(z));
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int classic_spmm(const void* values, const void* residue, const void* page_tab,
                 const void* tile_base, const void* chunk_group, const void* x,
                 void* z, int64_t num_tiles, int64_t rows_padded, int n_rhs,
                 cudaStream_t st) {
  if (num_tiles > 0 && n_rhs > 0)
    classic_spmm_tile<V><<<static_cast<unsigned>(num_tiles), kLanes, 0, st>>>(
        static_cast<const V*>(values), static_cast<const int8_t*>(residue),
        static_cast<const int8_t*>(page_tab), static_cast<const int32_t*>(tile_base),
        static_cast<const int32_t*>(chunk_group), static_cast<const float*>(x),
        static_cast<float*>(z), rows_padded, n_rhs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kernel #15: z (num_groups*8*128, stored rows) += the classic product.
// x is the (x_pages*128) fp32 vector, z fp32 and zeroed by the caller;
// values_bf16 selects bf16 values over fp32 ones.  Launches on `stream`,
// does not synchronise, and returns cudaGetLastError().
int whell_classic_spmv(const void* values, int values_bf16, const void* residue,
                       const void* page_tab, const void* tile_base,
                       const void* chunk_group, const void* x, void* z,
                       int64_t num_tiles, void* stream) {
  auto* fn = values_bf16 ? classic_spmv<uint16_t> : classic_spmv<float>;
  return fn(values, residue, page_tab, tile_base, chunk_group, x, z, num_tiles,
            static_cast<cudaStream_t>(stream));
}

// Kernel #16: Z (n_rhs x rows_padded) += the classic product with each of
// n_rhs RHS.  x is the RHS-interleaved (x_pages*128, n_rhs) fp32 stack, Z
// fp32 and zeroed by the caller.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError().
int whell_classic_spmm(const void* values, int values_bf16, const void* residue,
                       const void* page_tab, const void* tile_base,
                       const void* chunk_group, const void* x, void* z,
                       int64_t num_tiles, int64_t rows_padded, int n_rhs,
                       void* stream) {
  auto* fn = values_bf16 ? classic_spmm<uint16_t> : classic_spmm<float>;
  return fn(values, residue, page_tab, tile_base, chunk_group, x, z, num_tiles,
            rows_padded, n_rhs, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
