// Per-cell row-routing WHELL SpMV (pcell) on Hopper (sm_90a), with a
// plain C interface for ctypes.
//
// Entry pcell_spmv replaces spgpu_tpu/ops/pallas_kernels.py::_pcell_kernel
// (kernel #17, called through _pcell_spmv_call and pcell_spmv_pallas):
// fp32 values, x and sums; entry pcell_spmv_f64 is the same kernel on
// float64 values, x and sums (the JAX pcell layout's float64 slab, run
// there in interpret mode).  Both work on the PcellWhell layout arrays
// (spgpu_tpu_torch/formats/whell.py, built by convert/pcell.py):
//
//   for every slot s of tile t = s / 8 (meta = tile_base[t]):
//     for every lane j:  r = residue[s, j];  d = page_tab[s, r]
//       col = (group_bases[tile_page[t]*K + (d >> 3)] + (d & 7)) * 128 + r
//       p[j] = values[s, j] * x[col]
//     P = the inclusive prefix sum of p over the 128 lanes
//     for every output lane o:  hi = run_hi[s, o];  lo = run_lo[s, o]
//       routed[o] = (hi >= 0 ? P[hi] : 0) - (lo >= 0 ? P[lo] : 0)
//   z[hack*128 + o] += sum over the tile's 8 slots of routed[o], with
//   hack = chunk_group[t / chunk_tiles] * group_hacks + (meta >> 20)
//
// i.e. every row's run of cells in a slot, summed by the difference of two
// prefix sums and sent to its output lane row % 128; z is in the original
// numbering.  Padding cells hold value 0 and in-range pages.  The layout
// group comes from the layout's full-width tile_page word (int32), not from
// tile_base's 20-bit field, which bounds the JAX layout at 2^20 groups.
//
// Bound on the H100 (3.35 TB/s, SXM at 700 W): the slab streams once per
// product at 8 B/cell (4 B value + int8 residue, page entry, run_hi and
// run_lo), plus the per-tile words, x and z.  On the raw flagship FEM
// matrix the layout pads 1.33 cells per nonzero (8,704 tiles, about 68
// MiB of slab): ~0.022 ms.  x (1 MiB) stays in L2.
//
// What the design does about it.  The TPU kernel builds the lane scan from
// seven lane rolls and two extra lane gathers, which its hardware issues
// serially, and carries parity-split accumulator planes across its
// sequential chunk grid.  The first design here ran one 128-thread
// block per tile with a block scan per slot: warp shuffles, warp totals
// through shared memory, the scan in shared memory, and two
// __syncthreads() per slot (16 per tile), inside a loop kept rolled.  So
// each slot's loads (value, residue, page entry, group base, x) were
// issued only after the previous slot's scan had finished: one slot of
// one tile in flight per block, at 31 % of the bound on the H100 (SXM,
// 700 W).
//
// Now one warp owns a tile and nothing crosses warps.  Thread l holds the
// 4 consecutive lanes 4l..4l+3 of every slot: one 16 B value load and one
// 4 B load each of residue, run_hi and run_lo per slot, all 8 slots'
// loads issued before the first scan (the slot loop is unrolled), with
// the tile's 1 KiB page table (two 16 B loads a thread) and its layout
// group's window_pages/8 bases, which go to the warp's own shared memory
// behind one __syncwarp().  Then all 32 page-entry and base lookups come
// from shared memory and the 32 x gathers from L2.  Per slot: the
// thread's inclusive scan of its 4 products, a 5-step __shfl_up_sync scan
// of the thread totals, the slot's 128 prefix sums into the warp's own
// 512 B of shared memory behind __syncwarp() (a second __syncwarp()
// before the next slot overwrites it), and P[hi] - P[lo] read for each of
// the thread's 4 output lanes.  No block barrier anywhere: kTileWarps
// warps per block share nothing but the launch.  After the 8 slots, one
// atomicAdd per output lane into z (none when its sum is 0, as on a lane
// with no runs).  Choices, each timed against the others on the raw
// flagship on an H100 (variants not kept in the source): the page table from
// shared memory beat its 32 byte gathers a thread from global memory;
// streaming (__ldcs) loads, 1, 2 or 8 warps per block and a register cap
// for more resident warps (it spilled) were no faster.  ptxas (CUDA 12.9,
// sm_90a): pcell_tile 64 registers, no spills, no barriers, 6,272 bytes of
// shared memory (the first design, a block scan: 30 registers, 1 barrier).
// A difference of two prefix sums carries an error of eps times the
// slot's prefix total, not of the run's own sum; the plain version uses
// the same scan-then-difference arithmetic, so the two agree to rounding.
// Atomic order varies, so sums are not bit-reproducible.
//
// float64: pcell_tile<double>, the same design on 12 B a cell (8 B
// value, the four int8 bytes): one warp a tile, each thread's 4 lanes
// scanned, the __shfl_up_sync scan of the thread totals in doubles, the
// warp's own prefix row, P[hi] - P[lo], one atomicAdd(double*) per output
// lane.  Where the type changes the work: a thread's 4 values are two 16 B
// double2 loads a slot (Hopper has no 32 B load a thread); the prefix row
// is 1 KiB a warp; and the 8 slots' products, p[8][4], are 64 registers on
// their own, where the fp32 kernel takes 64 in all, so the kernel runs
// under __launch_bounds__(128) alone (at most 255 registers).  ptxas
// (sm_90a): pcell_tile<d> 104 registers, no spills, no barriers, 8,320
// bytes of shared memory; pcell_tile<f> 64 registers, 6,272 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kSlots = 8;
constexpr int kTileWarps = 4;  // tiles (one per warp) per block
constexpr int kMaxTab = 8;     // superpage bases per layout group (64-page windows)

// byte k of a 4-lane word, sign-extended (run bounds are -1 for none)
__device__ __forceinline__ int lane_byte(uint32_t w, int k) {
  return static_cast<int>(static_cast<int8_t>(static_cast<uint8_t>(w >> (8 * k))));
}

// a thread's 4 consecutive lanes of a slot: one 16 B load in fp32, two in
// float64; the same to store
template <typename T> struct Four { T v[4]; };

__device__ __forceinline__ Four<float> load4(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  return {{a.x, a.y, a.z, a.w}};
}
__device__ __forceinline__ Four<double> load4(const double* p) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  return {{a.x, a.y, b.x, b.y}};
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(double* p, double a, double b, double c, double d) {
  reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
  reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
}

template <typename T>
__global__ void __launch_bounds__(kTileWarps * 32)
pcell_tile(const T* __restrict__ values,
           const int8_t* __restrict__ residue,
           const int8_t* __restrict__ page_tab,
           const int8_t* __restrict__ run_hi,
           const int8_t* __restrict__ run_lo,
           const int32_t* __restrict__ tile_base,
           const int32_t* __restrict__ tile_page,
           const int32_t* __restrict__ chunk_group,
           const int32_t* __restrict__ group_bases,
           const T* __restrict__ x, T* __restrict__ z,
           int64_t num_tiles, int chunk_tiles, int group_hacks, int ntab) {
  __shared__ __align__(16) T scan_buf[kTileWarps][kLanes];
  __shared__ __align__(16) int8_t pt_buf[kTileWarps][kSlots * kLanes];
  __shared__ int32_t bases_buf[kTileWarps][kMaxTab];
  const int wib = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kTileWarps + wib;
  if (t >= num_tiles) return;  // whole warps only: no block barrier follows
  const int l = threadIdx.x & 31;
  const int j0 = 4 * l;  // this thread's lanes j0 .. j0 + 3
  T* scan = scan_buf[wib];
  const int64_t cell0 = t * (kSlots * kLanes);
  const uint32_t meta = static_cast<uint32_t>(__ldg(tile_base + t));
  const int64_t group = __ldg(tile_page + t);

  Four<T> v[kSlots];
  uint32_t res[kSlots], hi[kSlots], lo[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {  // every slot's streamed loads first
    const int64_t c = cell0 + s * kLanes + j0;
    v[s] = load4(values + c);
    res[s] = __ldg(reinterpret_cast<const unsigned int*>(residue + c));
    hi[s] = __ldg(reinterpret_cast<const unsigned int*>(run_hi + c));
    lo[s] = __ldg(reinterpret_cast<const unsigned int*>(run_lo + c));
  }
  // the tile's 8x128 page table (1 KiB, two 16 B loads a thread) and its
  // layout group's bases to the warp's shared memory, for the lookups
  const uint4* pt_src = reinterpret_cast<const uint4*>(page_tab + cell0);
  uint4* pt_dst = reinterpret_cast<uint4*>(pt_buf[wib]);
  pt_dst[l] = __ldg(pt_src + l);
  pt_dst[l + 32] = __ldg(pt_src + l + 32);
  if (l < ntab) bases_buf[wib][l] = __ldg(group_bases + group * ntab + l);
  __syncwarp();
  const int8_t* pt = pt_buf[wib];
  const int32_t* bases = bases_buf[wib];
  T p[kSlots][4];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {  // then every gather
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = lane_byte(res[s], k);
      const int d = pt[s * kLanes + r];
      const int64_t col = (static_cast<int64_t>(bases[d >> 3]) + (d & 7)) * kLanes + r;
      p[s][k] = v[s].v[k] * __ldg(x + col);
    }
  }

  T out[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    T a[4];
    a[0] = p[s][0];
#pragma unroll
    for (int k = 1; k < 4; ++k) a[k] = a[k - 1] + p[s][k];
    T incl = a[3];  // inclusive scan of the thread totals
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T up = __shfl_up_sync(0xffffffffu, incl, o);
      if (l >= o) incl += up;
    }
    T excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (l == 0) excl = T(0);
    __syncwarp();  // the last slot's reads of the buffer are done
    store4(scan + j0, excl + a[0], excl + a[1], excl + a[2], excl + a[3]);
    __syncwarp();  // the slot's 128 prefix sums are written
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int h = lane_byte(hi[s], k), b = lane_byte(lo[s], k);
      out[k] += (h >= 0 ? scan[h] : T(0)) - (b >= 0 ? scan[b] : T(0));
    }
  }
  const int64_t hack =
      static_cast<int64_t>(chunk_group[t / chunk_tiles]) * group_hacks + (meta >> 20);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (out[k] != T(0)) atomicAdd(z + hack * kLanes + j0 + k, out[k]);
}

template <typename T>
int pcell(const void* values, const void* residue, const void* page_tab,
          const void* run_hi, const void* run_lo, const void* tile_base,
          const void* tile_page, const void* chunk_group, const void* group_bases,
          const void* x, void* z, int64_t num_tiles, int chunk_tiles, int group_hacks,
          int ntab, cudaStream_t st) {
  if (num_tiles > 0)
    pcell_tile<T><<<static_cast<unsigned>((num_tiles + kTileWarps - 1) / kTileWarps),
                    kTileWarps * 32, 0, st>>>(
        static_cast<const T*>(values), static_cast<const int8_t*>(residue),
        static_cast<const int8_t*>(page_tab), static_cast<const int8_t*>(run_hi),
        static_cast<const int8_t*>(run_lo), static_cast<const int32_t*>(tile_base),
        static_cast<const int32_t*>(tile_page), static_cast<const int32_t*>(chunk_group),
        static_cast<const int32_t*>(group_bases), static_cast<const T*>(x),
        static_cast<T*>(z), num_tiles, chunk_tiles, group_hacks, ntab);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kernel #17: z (num_groups*group_hacks*128, original rows) += the pcell
// product.  x is the (x_pages*128) fp32 vector, z fp32 and zeroed by the
// caller; ntab = window_pages / 8 superpage bases per layout group.  The
// value slab must be 16 B aligned, the int8 slabs 4 B aligned.  Launches
// on `stream`, does not synchronise, and returns cudaGetLastError().
int pcell_spmv(const void* values, const void* residue, const void* page_tab,
               const void* run_hi, const void* run_lo, const void* tile_base,
               const void* tile_page, const void* chunk_group,
               const void* group_bases, const void* x, void* z, int64_t num_tiles,
               int chunk_tiles, int group_hacks, int ntab, void* stream) {
  return pcell<float>(values, residue, page_tab, run_hi, run_lo, tile_base, tile_page,
                      chunk_group, group_bases, x, z, num_tiles, chunk_tiles,
                      group_hacks, ntab, static_cast<cudaStream_t>(stream));
}

// Kernel #17 in float64: as pcell_spmv, with float64 values, x and z.
int pcell_spmv_f64(const void* values, const void* residue, const void* page_tab,
                   const void* run_hi, const void* run_lo, const void* tile_base,
                   const void* tile_page, const void* chunk_group,
                   const void* group_bases, const void* x, void* z, int64_t num_tiles,
                   int chunk_tiles, int group_hacks, int ntab, void* stream) {
  return pcell<double>(values, residue, page_tab, run_hi, run_lo, tile_base, tile_page,
                       chunk_group, group_bases, x, z, num_tiles, chunk_tiles,
                       group_hacks, ntab, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
