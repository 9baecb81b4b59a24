// Per-cell row-routing WHELL SpMV (pcell) on Hopper (sm_90a), with a
// plain C interface for ctypes.
//
// Entry pcell_spmv replaces spgpu_tpu/ops/pallas_kernels.py::_pcell_kernel
// (kernel #17, called through _pcell_spmv_call and pcell_spmv_pallas):
// fp32 values, x and sums, on the PcellWhell layout arrays
// (spgpu_tpu_torch/formats/whell.py, built by convert/pcell.py):
//
//   for every slot s of tile t = s / 8 (meta = tile_base[t]):
//     for every lane j:  r = residue[s, j];  d = page_tab[s, r]
//       col = (group_bases[(meta & 0xFFFFF)*K + (d >> 3)] + (d & 7)) * 128 + r
//       p[j] = values[s, j] * x[col]
//     P = the inclusive prefix sum of p over the 128 lanes
//     for every output lane o:  hi = run_hi[s, o];  lo = run_lo[s, o]
//       routed[o] = (hi >= 0 ? P[hi] : 0) - (lo >= 0 ? P[lo] : 0)
//   z[hack*128 + o] += sum over the tile's 8 slots of routed[o], with
//   hack = chunk_group[t / chunk_tiles] * group_hacks + (meta >> 20)
//
// i.e. every row's run of cells in a slot, summed by the difference of two
// prefix sums and sent to its output lane row % 128; z is in the original
// numbering.  Padding cells hold value 0 and in-range pages.
//
// Bound on the H100: the slab streams once per product at 8 B/cell (4 B
// value + int8 residue, page entry, run_hi and run_lo), plus the per-tile
// words, x and z.  On the raw flagship FEM matrix the layout pads 1.33
// cells per nonzero (8,704 tiles, about 68 MiB of slab): ~0.022 ms at
// 3.35 TB/s.  x (1 MiB) stays in L2.
//
// What the design does about it: the TPU kernel builds the lane scan from
// seven lane rolls and two extra lane gathers, which its hardware issues
// serially, and carries parity-split accumulator planes across its
// sequential chunk grid; here the scan is a few warp shuffles.  One 128-thread block per tile.  For each slot, each
// thread forms its lane's product (page table in shared memory for the
// by-residue lookup), the four warps scan with __shfl_up_sync, warp totals
// combine through shared memory, the block's scan goes to shared memory,
// and thread o reads the two run bounds of its output lane.  Two barriers
// per slot keep the shared scan and warp totals free of reuse races.
// After the 8 slots, one atomicAdd per output lane into z (none when its
// sum is 0, as on a lane with no runs).  A difference of two prefix sums
// carries an error of eps times the slot's prefix total, not of the run's
// own sum; the plain version uses the same scan-then-difference
// arithmetic, so the two agree to rounding.  Atomic order varies, so sums
// are not bit-reproducible.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kSlots = 8;
constexpr int kWarps = kLanes / 32;

__global__ void __launch_bounds__(kLanes)
pcell_tile(const float* __restrict__ values,
           const int8_t* __restrict__ residue,
           const int8_t* __restrict__ page_tab,
           const int8_t* __restrict__ run_hi,
           const int8_t* __restrict__ run_lo,
           const int32_t* __restrict__ tile_base,
           const int32_t* __restrict__ chunk_group,
           const int32_t* __restrict__ group_bases,
           const float* __restrict__ x, float* __restrict__ z,
           int chunk_tiles, int group_hacks, int ntab) {
  __shared__ int8_t pt[kSlots][kLanes];
  __shared__ float scan[kLanes];
  __shared__ float warp_total[kWarps];
  const int64_t t = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;
  const int64_t cell0 = t * (kSlots * kLanes);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) pt[s][j] = page_tab[cell0 + s * kLanes + j];
  const uint32_t meta = static_cast<uint32_t>(tile_base[t]);
  const int32_t* bases = group_bases + static_cast<int64_t>(meta & 0xFFFFFu) * ntab;
  __syncthreads();

  float out = 0.0f;
#pragma unroll 1
  for (int s = 0; s < kSlots; ++s) {
    const int64_t c = cell0 + s * kLanes + j;
    const int r = residue[c];
    const int d = pt[s][r];
    const int64_t col = (static_cast<int64_t>(__ldg(bases + (d >> 3))) + (d & 7)) * kLanes + r;
    float p = __ldg(values + c) * __ldg(x + col);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, p, o);
      if (lane >= o) p += up;
    }
    if (lane == 31) warp_total[warp] = p;
    __syncthreads();  // warp totals written; last slot's scan reads done
    for (int w = 0; w < warp; ++w) p += warp_total[w];
    scan[j] = p;
    __syncthreads();  // the block's scan complete
    const int hi = run_hi[c], lo = run_lo[c];
    out += (hi >= 0 ? scan[hi] : 0.0f) - (lo >= 0 ? scan[lo] : 0.0f);
  }
  if (out != 0.0f) {
    const int64_t hack =
        static_cast<int64_t>(chunk_group[t / chunk_tiles]) * group_hacks + (meta >> 20);
    atomicAdd(z + hack * kLanes + j, out);
  }
}

}  // namespace

extern "C" {

// Kernel #17: z (num_groups*group_hacks*128, original rows) += the pcell
// product.  x is the (x_pages*128) fp32 vector, z fp32 and zeroed by the
// caller; ntab = window_pages / 8 superpage bases per layout group.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
int pcell_spmv(const void* values, const void* residue, const void* page_tab,
               const void* run_hi, const void* run_lo, const void* tile_base,
               const void* chunk_group, const void* group_bases, const void* x,
               void* z, int64_t num_tiles, int chunk_tiles, int group_hacks,
               int ntab, void* stream) {
  if (num_tiles > 0)
    pcell_tile<<<static_cast<unsigned>(num_tiles), kLanes, 0,
                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(values), static_cast<const int8_t*>(residue),
        static_cast<const int8_t*>(page_tab), static_cast<const int8_t*>(run_hi),
        static_cast<const int8_t*>(run_lo), static_cast<const int32_t*>(tile_base),
        static_cast<const int32_t*>(chunk_group),
        static_cast<const int32_t*>(group_bases), static_cast<const float*>(x),
        static_cast<float*>(z), chunk_tiles, group_hacks, ntab);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
