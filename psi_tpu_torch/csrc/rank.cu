// Rank over payloadR, the per-block rank record (ops/fm_stream.py):
//   psi_rank          rank(c_i, pos_i) per query, psi_tpu's rank_stream
//                     contract;
//   psi_rank_lf_pair  one LF step of a (lo, hi) pair per key:
//                     (C[c] + rank(c, lo), C[c] + rank(c, hi)).
//
// Both replace psi_tpu/ops/fm_stream.py::_rank_kernel (:166, via
// rank_stream and backward_search_sorted), which walks each 1024-query
// slab over the min..max range of payload windows its positions fall in,
// one masked pass per window. Here each thread reads its own block's
// record instead.
//
// payloadR [NBpad, 8] int32 holds one 32-byte record (one L2 sector) per
// text block, and rank(c, pos) reads two words of it (payload_rank.cuh
// has the record and the arithmetic, shared with trie_level.cu and
// rank4.cu).
//
// What bounds it on an H100: every step after the first of
// backward_search_sorted ranks positions scattered over the whole text,
// so each key's record is a random read. payloadR is 10 MB at 10 Mbp and
// stays in the 50 MB L2, so the cost is L2 sectors per key, not HBM bytes.
// The payloadT layout ([16, NBpad], row-major) put the four words of one
// rank in four rows 4 * NBpad bytes apart: four sectors for 16 useful
// bytes, and eight per LF step when lo and hi were ranked by two
// launches. psi_rank_lf_pair ranks lo and hi in one thread: it loads the
// record of lo's block and a second one only where hi's block differs (a
// present key's range is narrow, so lo and hi usually share a block),
// adds C[c] from shared memory and writes both ends: about one sector
// per key and one launch per step. What remains is the 20 bytes per key
// of chars, positions and results (coalesced).
//
// Neither chars (1..4) nor positions ([0, n]) are checked on the device
// (psi_tpu's contract); the wrappers check shapes, types, contiguity and
// the record's alignment.

#include <cstdint>
#include <cuda_runtime.h>

#include "payload_rank.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void rank_kernel(const int32_t* __restrict__ payloadR,
                            const int32_t* __restrict__ chars,
                            const int32_t* __restrict__ pos,
                            int32_t* __restrict__ out, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int32_t p = __ldg(pos + i);
  out[i] = psi::rank_in(psi::record(payloadR, p), __ldg(chars + i), p);
}

__global__ void rank_lf_pair_kernel(const int32_t* __restrict__ payloadR,
                                    const int32_t* __restrict__ C,
                                    const int32_t* __restrict__ chars,
                                    const int32_t* __restrict__ lo,
                                    const int32_t* __restrict__ hi,
                                    int32_t* __restrict__ lo_out,
                                    int32_t* __restrict__ hi_out, int m) {
  __shared__ int32_t c_base[5];  // C[0..4]; chars are 1..4
  if (threadIdx.x < 5) c_base[threadIdx.x] = C[threadIdx.x];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int c = __ldg(chars + i);
  const int32_t l = __ldg(lo + i);
  const int32_t h = __ldg(hi + i);
  int32_t rank_lo, rank_hi;
  psi::rank_pair(payloadR, c, l, h, rank_lo, rank_hi);
  lo_out[i] = c_base[c] + rank_lo;
  hi_out[i] = c_base[c] + rank_hi;
}

}  // namespace

extern "C" int psi_rank(const void* payloadR, const void* chars,
                        const void* pos, void* out, int m, void* stream) {
  if (m > 0) {
    const int grid = (m + kThreads - 1) / kThreads;
    rank_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(payloadR),
        static_cast<const int32_t*>(chars), static_cast<const int32_t*>(pos),
        static_cast<int32_t*>(out), m);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psi_rank_lf_pair(const void* payloadR, const void* C,
                                const void* chars, const void* lo,
                                const void* hi, void* lo_out, void* hi_out,
                                int m, void* stream) {
  if (m > 0) {
    const int grid = (m + kThreads - 1) / kThreads;
    rank_lf_pair_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(payloadR), static_cast<const int32_t*>(C),
        static_cast<const int32_t*>(chars), static_cast<const int32_t*>(lo),
        static_cast<const int32_t*>(hi), static_cast<int32_t*>(lo_out),
        static_cast<int32_t*>(hi_out), m);
  }
  return static_cast<int>(cudaGetLastError());
}
