// Per-query rank: rank(c_i, pos_i), the count of c_i in bwt[0:pos_i].
//
// Replaces psi_tpu/ops/fm_stream.py::_rank_kernel (via rank_stream and
// backward_search_sorted), which walks each 1024-query slab over the
// min..max range of payload windows its positions fall in, one masked
// pass per window. Thread i reads its own column instead:
//   out[i] = occ_c[b] + popc(match_c & below)
// with c = chars[i] in 1..4 (payload_rank.cuh has the arithmetic).
//
// What bounds it on an H100: per query, two 4-byte reads (char, pos),
// four dependent-free 4-byte gathers from one payloadT column (the occ
// row of c and the three plane words; payloadT is 20 MB at 10 Mbp and
// fits the 50 MB L2) and one coalesced 4-byte write. In
// backward_search_sorted every step after the first ranks positions that
// are scattered over the whole text, so this is a random-gather workload
// bound by L2 sectors, not by HBM bandwidth. The TPU kernel's window
// loop made scattered positions cost many passes; here they cost
// nothing more than sorted ones apart from L2 locality.

#include <cstdint>
#include <cuda_runtime.h>

#include "payload_rank.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void rank_kernel(const int32_t* __restrict__ payloadT, int nbpad,
                            const int32_t* __restrict__ chars,
                            const int32_t* __restrict__ pos,
                            int32_t* __restrict__ out, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const size_t nb = static_cast<size_t>(nbpad);
  const int c = chars[i];
  const int32_t p = pos[i];
  const uint32_t b = static_cast<uint32_t>(p) >> 5;
  const uint32_t p0 = static_cast<uint32_t>(__ldg(payloadT + 6 * nb + b));
  const uint32_t p1 = static_cast<uint32_t>(__ldg(payloadT + 7 * nb + b));
  const uint32_t p2 = static_cast<uint32_t>(__ldg(payloadT + 8 * nb + b));
  out[i] = __ldg(payloadT + c * nb + b) +
           __popc(psi::match_word(p0, p1, p2, c) & psi::below_mask(p));
}

}  // namespace

extern "C" int psi_rank(const void* payloadT, int nbpad, const void* chars,
                        const void* pos, void* out, int m, void* stream) {
  if (m > 0) {
    const int grid = (m + kThreads - 1) / kThreads;
    rank_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(payloadT), nbpad,
        static_cast<const int32_t*>(chars), static_cast<const int32_t*>(pos),
        static_cast<int32_t*>(out), m);
  }
  return static_cast<int>(cudaGetLastError());
}
