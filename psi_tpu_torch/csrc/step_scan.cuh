// What the two step kernels of the off-path frontier traversal share
// (traverse_step.cu, the exact step; traverse_step_approx.cu, the
// mismatch-tolerant one): the graph's arguments, the scratch header, the
// block scan, the decoupled look-back across tiles, the grid barrier, and
// the host side's tile count, scratch size and grid.
//
// Both kernels run a persistent cooperative grid that takes 256-slot
// tiles of parents by an atomic ticket; a tile's prefix over the tiles
// before it comes from a 64-bit descriptor per tile (2 status bits, 62
// value bits: 0 not yet published, 1 the tile's aggregate, 2 its
// inclusive prefix). The scratch is a 64-byte header, then two
// descriptor arrays of a word per tile; a launch finds all of it 0 but
// the header's padding record, totals and barrier generation, and
// leaves it so.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kThreads = 256;  // parent slots per tile, one a thread
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kAggregate = 1ull << 62;
constexpr uint64_t kInclusive = 2ull << 62;
constexpr uint64_t kValue = (1ull << 62) - 1;
constexpr int kMaxDevices = 64;

struct GraphArgs {
  const int32_t* labels;   // [n_labels] codes, 4 = N
  const int32_t* loff;     // [n + 1] label offsets
  const int32_t* indptr;   // [n + 1] out-edge CSR
  const int32_t* indices;  // [n_edges] 1-based node ids
  int n_labels;
  int n_edges;
};

// The scratch header of a step whose records have `Fields` fields.
template <int Fields>
struct StepScratch {
  unsigned ticket;
  unsigned bar_count;
  unsigned bar_gen;
  int32_t pad[Fields];   // the padding record when new_n >= cap
  long long totals[2];   // new_n, n2, from the last live tile
};
static_assert(sizeof(StepScratch<6>) <= 64, "the descriptors start at 64");

// Exclusive scan of v over the block; `total` gets the block's sum.
template <typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* warp_sums,
                                                  T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const T y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  total = warp_sums[kWarps - 1];
  const T out = (warp ? warp_sums[warp - 1] : 0) + x - v;
  __syncthreads();
  return out;
}

__device__ __forceinline__ uint64_t peek(const unsigned long long* d) {
  return *reinterpret_cast<const volatile unsigned long long*>(d);
}

// Run by warp 0 of a tile: publish the tile's aggregate, sum the
// predecessors' descriptors back to the nearest inclusive prefix (32 at a
// time, waiting on any not yet published), publish the tile's inclusive
// prefix. Returns the tile's exclusive prefix on every lane.
static __device__ long long look_back(unsigned long long* desc, int tile,
                                      long long aggregate) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) atomicExch(desc, kInclusive | aggregate);
    return 0;
  }
  if (lane == 0) atomicExch(desc + tile, kAggregate | aggregate);
  long long exclusive = 0;
  for (int end = tile - 1;; end -= 32) {
    const int idx = end - lane;
    uint64_t d = idx >= 0 ? peek(desc + idx) : kInclusive;
    while (__any_sync(kFull, (d >> 62) == 0)) {
      if ((d >> 62) == 0) d = peek(desc + idx);
    }
    const unsigned inclusive = __ballot_sync(kFull, (d >> 62) == 2);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    long long v = lane <= stop ? static_cast<long long>(d & kValue) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    exclusive += v;
    if (inclusive) break;
  }
  if (lane == 0) atomicExch(desc + tile, kInclusive | (exclusive + aggregate));
  return exclusive;
}

// Every block of the cooperative grid waits here for all the others. The
// last to arrive resets the count and advances the generation.
template <int Fields>
static __device__ void grid_barrier(StepScratch<Fields>* scr) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = &scr->bar_gen;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(&scr->bar_count, 1u) == gridDim.x - 1) {
      atomicExch(&scr->bar_count, 0u);
      __threadfence();
      atomicAdd(&scr->bar_gen, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// 256-slot tiles of a cap.
inline long long step_tiles(int cap) {
  return (static_cast<long long>(cap) + kThreads - 1) / kThreads;
}

// Bytes of scratch a launch at `cap` needs: the header and two 8-byte
// descriptors per tile.
inline long long step_scratch_bytes(int cap) {
  return 64 + 16 * step_tiles(cap);
}

// Launch `kernel` over the cooperative grid of a step at `cap` on
// `stream`: as many blocks as fit on the card at once (asked once per
// device and kept in `grid_of`), at most one per tile. Returns the CUDA
// error code, 0 on success.
template <typename Kernel>
inline int step_launch(Kernel kernel, int (&grid_of)[kMaxDevices], int cap,
                       void** args, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (grid_of[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    grid_of[dev] = per_sm * sms;
  }
  const int grid = static_cast<int>(
      min(static_cast<long long>(grid_of[dev]), step_tiles(cap)));
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
