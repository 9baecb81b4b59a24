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
//   for every slot s of a tile t listed under output hack h
//   (hack_tiles[hack_tile_ptr[h] .. hack_tile_ptr[h + 1]]):
//     for every lane j:  r = residue[s, j];  d = page_tab[s, r]
//       col = (group_bases[tile_page[t]*K + (d >> 3)] + (d & 7)) * 128 + r
//       p[j] = values[s, j] * x[col]
//     P = the inclusive prefix sum of p over the 128 lanes
//     for every output lane o:  hi = run_hi[s, o];  lo = run_lo[s, o]
//       routed[o] = (hi >= 0 ? P[hi] : 0) - (lo >= 0 ? P[lo] : 0)
//   z[h*128 + o] = sum over h's listed tiles and their 8 slots of routed[o]
//
// i.e. every row's run of cells in a slot, summed by the difference of two
// prefix sums and sent to its output lane row % 128; z is in the original
// numbering.  The layout's hack lists (formats/whell.py, pcell_hack_tiles)
// hold each output hack's tiles that route a run (hack = chunk_group[t /
// chunk_tiles] * group_hacks + (tile_base[t] >> 20)); a tile with none,
// such as the converter's chunk padding, adds exactly 0 and is not listed.
// Padding cells hold value 0 and in-range pages.  The layout group comes
// from the layout's full-width tile_page word (int32), not from
// tile_base's 20-bit field, which bounds the JAX layout at 2^20 groups.
//
// Bound on the H100 (3.35 TB/s, SXM at 700 W): the listed tiles' slab
// streams once per product at 8 B/cell in fp32 (4 B value + int8 residue,
// page entry, run_hi and run_lo), 12 in float64, plus their page words,
// the hack lists, x and z.  On the raw flagship FEM matrix the layout pads
// 1.33 cells per nonzero (8,704 tiles, about 68 MiB of fp32 slab): ~0.022
// ms in fp32, ~0.033 in float64.  x (1-2 MiB) stays in L2.
//
// The TPU kernel builds the lane scan from seven lane rolls and two extra
// lane gathers, which its hardware issues serially, and carries
// parity-split accumulator planes across its sequential chunk grid.  The
// first design here ran one 128-thread block per tile with a block
// scan per slot and two __syncthreads() per slot, at 31 % of the bound.
// The second gave each tile one warp, no block
// barrier, and one atomicAdd per output lane into a zero-filled z: 38.0
// us in fp32 and 49.9 in float64 on the raw flagship, sums not
// bit-reproducible.
//
// The hack pass (pcell_hack_pass).  One block of kHackWarps = 2
// warps per work unit (hack_units: [begin, end) of a hack's list, the row,
// and the chunk of a hack past 8 listed tiles); warp w takes listed
// tiles begin + w, begin + w + 2, ... in order.  A warp's tile: thread l
// holds lanes 4l..4l+3 of every slot; kSlotBatch = 4 slots at a time, each
// a 16 B value load (two in float64) and a 4 B load each of residue,
// run_hi and run_lo, all issued before the batch's gathers (with the
// first batch the tile's 1 KiB page table and its group's bases go to the
// warp's shared memory behind __syncwarp()); per slot the thread's scan of
// its 4 products, a 5-step __shfl_up_sync scan of the thread totals, the
// 128 prefix sums into the warp's 512 B (1 KiB) of shared memory, and
// P[hi] - P[lo] added to the thread's 4 register sums, tile after tile.
// Then the block adds its warps' sums in warp order through shared memory
// and stores the row's 128 lanes once into z, a torch.empty: no atomics on
// z and no zero fill of it; a row with no listed tile stores 0.  A chunked
// row's blocks store their sums to the launch's part buffer and the block
// whose atomicAdd on the row's counter is the k-th adds the k chunks in
// chunk order (the same bits whichever block comes last); the counters are
// the launch's own, zeroed by the caller only when some row is chunked
// (one more device operation, about 1 us; no stream or call shares them).
// So every call gives the same bits.  The routing arithmetic per slot is
// the second design's, so the plain version (scan, then difference, then
// index_add_ over tiles) agrees to rounding.
//
// Chosen by sweeps/kernel_account.py on the raw flagship (builds of this
// source with one edit each, not kept; NVIDIA H100 80GB HBM3, 700 W, warm
// device us fp32 / float64): one warp a tile before the
// redesign, as above, 38.0 / 49.9 (its account, taken on that source,
// which git keeps: the x gathers 5.8 / 9.7, the lane scan 6.8 / 4.8, the
// atomics 0.5 / 0.6, the zero fill 0.8 / 1.2 of the call); the hack pass with 4 warps and all 8 slots at once 43.0 /
// 65.8 (104 / 140 registers: 4 and 3 blocks an SM, and warps that wait at
// the block barrier for the block's last tile); 4 slots at a time 37.3 /
// 53.8; 2 at a time 37.5 / 62.2; 8 warps a block 56 / 118; 2 warps a
// block, 4 slots at a time (kept) 34.1 / 50.8, with 128 registers asked
// in float64 50.4 (kept); a 102- or 85-register cap spilled and ran 58.5
// / 74.6 in float64.  On the SPD flagship (the pcell CG's system: 15,616
// tiles, hacks of 5-135 listed tiles) 16-tile chunks ran 65.8 / 93.0 and
// 8-tile chunks (kept: formats/whell.py, PCELL_CHUNK_TILES) 53.8 / 79.4,
// 4-tile ones 60.4 / 86.3, 4 warps a block 54.5 / 123.6; on the
// raw flagship the chunk length changed nothing.  What holds it: the x
// gathers (4.8 / 8.1 us of the kept shape on the raw flagship) and, in
// float64, the resident warps (118 / 122 registers).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kSlots = 8;
constexpr int kHackWarps = 2;  // warps per block: each takes every kHackWarps-th tile
constexpr int kMaxTab = 8;     // superpage bases per layout group (64-page windows)

// byte k of a 4-lane word, sign-extended (run bounds are -1 for none)
__device__ __forceinline__ int lane_byte(uint32_t w, int k) {
  return static_cast<int>(static_cast<int8_t>(static_cast<uint8_t>(w >> (8 * k))));
}

// a thread's 4 consecutive lanes of a slot: one 16 B load in fp32, two in
// float64; the same to store
template <typename T> struct Four { T v[4]; };

// the slots of a tile a warp loads, gathers and scans at once (the rest
// wait in the slot loop)
constexpr int kSlotBatch = 4;
// the blocks an SM asked of ptxas, its register cap 65,536 / (64 *
// kMinBlocks) (255 at most): 8 in float64 (128 registers); 1 in fp32,
// which uses 118 with no cap that binds
template <typename T> constexpr int kMinBlocks = sizeof(T) == 8 ? 8 : 1;

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

// One warp's tile t, added to its thread's 4 output lanes out[0..3]
// (j0 = 4 * lane), kSlotBatch slots at a time: the batch's streamed loads
// first (with the first batch, the tile's page table and its layout
// group's bases to the warp's shared memory), every gather of the batch,
// then per slot the lane scan and P[hi] - P[lo].  `scan`, `pt` and
// `bases` are the warp's own shared buffers.
template <typename T>
__device__ __forceinline__ void tile_routed(
    const T* __restrict__ values, const int8_t* __restrict__ residue,
    const int8_t* __restrict__ page_tab, const int8_t* __restrict__ run_hi,
    const int8_t* __restrict__ run_lo, const int32_t* __restrict__ tile_page,
    const int32_t* __restrict__ group_bases, const T* __restrict__ x, int64_t t,
    int l, int ntab, T* scan, int8_t* pt, int32_t* bases, T (&out)[4]) {
  const int j0 = 4 * l;
  const int64_t cell0 = t * (kSlots * kLanes);
  const int64_t group = __ldg(tile_page + t);
#pragma unroll 1
  for (int s0 = 0; s0 < kSlots; s0 += kSlotBatch) {
    Four<T> v[kSlotBatch];
    uint32_t res[kSlotBatch], hi[kSlotBatch], lo[kSlotBatch];
#pragma unroll
    for (int b = 0; b < kSlotBatch; ++b) {  // the batch's streamed loads first
      const int64_t c = cell0 + (s0 + b) * kLanes + j0;
      v[b] = load4(values + c);
      res[b] = __ldg(reinterpret_cast<const unsigned int*>(residue + c));
      hi[b] = __ldg(reinterpret_cast<const unsigned int*>(run_hi + c));
      lo[b] = __ldg(reinterpret_cast<const unsigned int*>(run_lo + c));
    }
    if (s0 == 0) {
      __syncwarp();  // the warp's last tile's reads of pt and bases are done
      const uint4* pt_src = reinterpret_cast<const uint4*>(page_tab + cell0);
      reinterpret_cast<uint4*>(pt)[l] = __ldg(pt_src + l);
      reinterpret_cast<uint4*>(pt)[l + 32] = __ldg(pt_src + l + 32);
      if (l < ntab) bases[l] = __ldg(group_bases + group * ntab + l);
      __syncwarp();
    }
    T p[kSlotBatch][4];
#pragma unroll
    for (int b = 0; b < kSlotBatch; ++b) {  // then every gather
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = lane_byte(res[b], k);
        const int d = pt[(s0 + b) * kLanes + r];
        const int64_t col = (static_cast<int64_t>(bases[d >> 3]) + (d & 7)) * kLanes + r;
        p[b][k] = v[b].v[k] * __ldg(x + col);
      }
    }
#pragma unroll
    for (int s = 0; s < kSlotBatch; ++s) {
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
  }
}

// Kernel #17: block u runs work unit u = (begin, end, row, chunk) of
// hack_units (formats/whell.py): the listed tiles hack_tiles[begin, end)
// of output row `row`, all of them (chunk -1) or its c-th chunk of k
// (chunk = c << 16 | k).  Warp w takes tiles begin + w, begin + w +
// kHackWarps, ... in list order into its 4 register sums a lane; then the
// block adds the warps' sums in warp order through shared memory, thread
// i lane i.  A whole row's block stores z[row, :] once; a chunk's block
// stores its sums to part[u, :], and the block that counts the row's k-th
// arrival on done[row] adds the k chunks' sums in chunk order (the same
// bits whichever block comes last) and stores z.  The counters are the
// launch's own (the caller zeroes them per call, only where some row is
// chunked), so launches on several streams share no state.
template <typename T>
__global__ void __launch_bounds__(kHackWarps * 32, kMinBlocks<T>)
pcell_hack_pass(const T* __restrict__ values,
                const int8_t* __restrict__ residue,
                const int8_t* __restrict__ page_tab,
                const int8_t* __restrict__ run_hi,
                const int8_t* __restrict__ run_lo,
                const int32_t* __restrict__ tile_page,
                const int32_t* __restrict__ group_bases,
                const int32_t* __restrict__ hack_tiles,
                const int4* __restrict__ units, int* __restrict__ done,
                T* __restrict__ part, const T* __restrict__ x, T* __restrict__ z,
                int ntab) {
  __shared__ __align__(16) T scan_buf[kHackWarps][kLanes];
  __shared__ __align__(16) int8_t pt_buf[kHackWarps][kSlots * kLanes];
  __shared__ int32_t bases_buf[kHackWarps][kMaxTab];
  const int4 unit = units[blockIdx.x];
  const int wib = threadIdx.x >> 5, l = threadIdx.x & 31, i = threadIdx.x;
  T out[4] = {T(0), T(0), T(0), T(0)};
  for (int q = unit.x + wib; q < unit.y; q += kHackWarps)
    tile_routed(values, residue, page_tab, run_hi, run_lo, tile_page, group_bases, x,
                static_cast<int64_t>(__ldg(hack_tiles + q)), l, ntab, scan_buf[wib],
                pt_buf[wib], bases_buf[wib], out);
  __syncthreads();  // every warp's reads of its scan buffer are done
  store4(scan_buf[wib] + 4 * l, out[0], out[1], out[2], out[3]);
  __syncthreads();
  constexpr int kThreads = kHackWarps * 32, kPer = (kLanes + kThreads - 1) / kThreads;
  T sum[kPer];  // lanes i, i + kThreads, ... of the row
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int o = min(i + p * kThreads, kLanes - 1);
    sum[p] = scan_buf[0][o];
#pragma unroll
    for (int w = 1; w < kHackWarps; ++w) sum[p] += scan_buf[w][o];
  }
  const int64_t row = unit.z;
  if (unit.w >= 0) {  // a chunk: the row's last block adds the chunks
    __shared__ bool last;
    const int c = unit.w >> 16, k = unit.w & 0xFFFF;
#pragma unroll
    for (int p = 0; p < kPer; ++p)
      if (i + p * kThreads < kLanes)
        part[static_cast<int64_t>(blockIdx.x) * kLanes + i + p * kThreads] = sum[p];
    __threadfence();
    __syncthreads();
    if (i == 0) last = atomicAdd(done + row, 1) == k - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const T* chunks = part + (static_cast<int64_t>(blockIdx.x) - c) * kLanes;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int o = min(i + p * kThreads, kLanes - 1);
      sum[p] = __ldcg(chunks + o);
      for (int q = 1; q < k; ++q) sum[p] += __ldcg(chunks + q * kLanes + o);
    }
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p)
    if (i + p * kThreads < kLanes) z[row * kLanes + i + p * kThreads] = sum[p];
}

template <typename T>
int pcell(const void* values, const void* residue, const void* page_tab,
          const void* run_hi, const void* run_lo, const void* tile_page,
          const void* group_bases, const void* hack_tiles, const void* units,
          void* done, void* part, const void* x, void* z, int64_t num_units, int ntab,
          cudaStream_t st) {
  if (num_units > 0)
    pcell_hack_pass<T><<<static_cast<unsigned>(num_units), kHackWarps * 32, 0, st>>>(
        static_cast<const T*>(values), static_cast<const int8_t*>(residue),
        static_cast<const int8_t*>(page_tab), static_cast<const int8_t*>(run_hi),
        static_cast<const int8_t*>(run_lo), static_cast<const int32_t*>(tile_page),
        static_cast<const int32_t*>(group_bases), static_cast<const int32_t*>(hack_tiles),
        static_cast<const int4*>(units), static_cast<int*>(done), static_cast<T*>(part),
        static_cast<const T*>(x), static_cast<T*>(z), ntab);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kernel #17: z (num_groups*group_hacks*128, original rows) = the pcell
// product, every row written (no zero fill needed).  x is the
// (x_pages*128) fp32 vector, z fp32; hack_tiles and units are the
// layout's hack_tiles and hack_units (num_units >= rows, one unit or more
// a row); done (rows int32, zeroed) and part (num_units x 128 of z's type)
// are the launch's scratch for chunked rows, and may both be null when no
// row is chunked (num_units == rows).  ntab = window_pages / 8 superpage
// bases per layout group.  The value slab and page_tab must be 16 B
// aligned, the other int8 slabs 4 B aligned.  Launches on `stream`, does
// not synchronise, and returns cudaGetLastError().
int pcell_spmv(const void* values, const void* residue, const void* page_tab,
               const void* run_hi, const void* run_lo, const void* tile_page,
               const void* group_bases, const void* hack_tiles, const void* units,
               void* done, void* part, const void* x, void* z, int64_t num_units,
               int ntab, void* stream) {
  return pcell<float>(values, residue, page_tab, run_hi, run_lo, tile_page, group_bases,
                      hack_tiles, units, done, part, x, z, num_units, ntab,
                      static_cast<cudaStream_t>(stream));
}

// Kernel #17 in float64: as pcell_spmv, with float64 values, x, z and part.
int pcell_spmv_f64(const void* values, const void* residue, const void* page_tab,
                   const void* run_hi, const void* run_lo, const void* tile_page,
                   const void* group_bases, const void* hack_tiles, const void* units,
                   void* done, void* part, const void* x, void* z, int64_t num_units,
                   int ntab, void* stream) {
  return pcell<double>(values, residue, page_tab, run_hi, run_lo, tile_page, group_bases,
                       hack_tiles, units, done, part, x, z, num_units, ntab,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
