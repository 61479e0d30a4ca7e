// Range refine over the chunk's seeds index: the rank step of the
// approximate off-path traversal (ops/traverse.py).
//   psi_range_refine4  [lo, hi) narrowed by each char 0..3, written as
//                      [N, 4] pairs (traverse_device_approx, one launch
//                      per step). The exact traversal's one-char rank runs
//                      fused in traverse_step.cu.
//
// Counterpart of psi_tpu/ops/traverse.py::_range_refine (:230), which is
// plain XLA there, not a Pallas kernel. The port has a kernel for it
// because torch has no popcount operator: the plain PyTorch version
// (range_refine_plain) spends some tens of device operations per step on
// the SWAR popcounts, gathers and prefix sums that one thread per state
// does here.
//
// One thread per state reads lo and hi and forms the four counts at
// each end by seeds_rank.cuh's seeds_counts_at: the occ row (one 16-byte
// load) and the plane pair (one 8-byte load) of lo's block and of hi's.
//
// Every slot of the state vectors is computed, padding slots included, as
// the plain version computes them, so the two are bit-equal over the whole
// array. lo <= hi in [0, V] is not checked on the device (psi_tpu's
// contract); the wrapper checks shapes, types, contiguity, alignment and
// the depth.
//
// What bounds it on an H100: a launch moves 8 bytes per state in (lo,
// hi) and 32 out (lo', hi' for four chars): about a megabyte at the traversal's 2^15-slot cap, well under a microsecond at
// 3.35 TB/s. The seeds index (k depths x ~15.6 K blocks x 24 bytes, ~7.5
// MB for a 100 K-read chunk) stays in the 50 MB L2. So a launch is bound
// by its launch and drain, not by bytes or operations.

#include <cstdint>
#include <cuda_runtime.h>

#include "seeds_rank.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void range_refine4_kernel(const int4* __restrict__ occ_d,
                                     const int2* __restrict__ planes_d,
                                     const int32_t* __restrict__ lo,
                                     const int32_t* __restrict__ hi,
                                     int4* __restrict__ lo4,
                                     int4* __restrict__ hi4, int n) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const int32_t l = __ldg(lo + s);
  const int4 a = seeds_counts_at(occ_d, planes_d, l);
  const int4 z = seeds_counts_at(occ_d, planes_d, __ldg(hi + s));
  const int n0 = z.x - a.x, n1 = z.y - a.y, n2 = z.z - a.z, n3 = z.w - a.w;
  const int4 start = make_int4(l, l + n0, l + n0 + n1, l + n0 + n1 + n2);
  lo4[s] = start;
  hi4[s] = make_int4(start.x + n0, start.y + n1, start.z + n2, start.w + n3);
}

}  // namespace

extern "C" int psi_range_refine4(const void* occ, const void* planes,
                                 int rows, int depth, const void* lo,
                                 const void* hi, void* lo4, void* hi4, int n,
                                 void* stream) {
  if (n > 0) {
    const size_t at = static_cast<size_t>(depth) * rows;
    const int grid = (n + kThreads - 1) / kThreads;
    range_refine4_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(occ) + at,
        static_cast<const int2*>(planes) + at,
        static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
        static_cast<int4*>(lo4), static_cast<int4*>(hi4), n);
  }
  return static_cast<int>(cudaGetLastError());
}
