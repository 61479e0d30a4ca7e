// Ranks of all four characters at every lo and every hi of a frontier.
//
// Replaces psi_tpu/ops/fm_stream.py::_rank4_pair_kernel, the first pass
// of the two-pass level route that psi_tpu takes when the match-format
// payload and the frontier exceed its VMEM budget (texts above ~10 Mbp).
// Thread i ranks lo[i] and hi[i]:
//   r4[c-1][i] = occ_c[b] + popc(match_c & below),  c = 1..4
// (payload_rank.cuh has the arithmetic).
//
// What bounds it on an H100: per position, seven dependent-free 4-byte
// reads from one payload column (strided by NBpad, so seven L2 sectors),
// then eight 4-byte writes of [4, M] output that coalesce across the
// warp. The payload (~20 MB of payloadT at 10 Mbp, of which the seven
// rows read are ~9 MB) fits the 50 MB L2; the frontier is
// pattern-sorted, so neighbouring threads read neighbouring columns.
// It is bound by scattered L2 reads. The TPU kernel's window ring and
// DMA prefetch pipeline have no counterpart: each thread reads its own
// column and the L2 does the caching.

#include <cstdint>
#include <cuda_runtime.h>

#include "payload_rank.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void rank4_pair_kernel(const int32_t* __restrict__ payloadT,
                                  int nbpad,
                                  const int32_t* __restrict__ lo,
                                  const int32_t* __restrict__ hi,
                                  int32_t* __restrict__ r4lo,
                                  int32_t* __restrict__ r4hi, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  psi::rank4_at(payloadT, static_cast<size_t>(nbpad), lo[i], r4lo, i, m);
  psi::rank4_at(payloadT, static_cast<size_t>(nbpad), hi[i], r4hi, i, m);
}

}  // namespace

extern "C" int psi_rank4_pair(const void* payloadT, int nbpad,
                              const void* lo, const void* hi, void* r4lo,
                              void* r4hi, int m, void* stream) {
  if (m > 0) {
    const int grid = (m + kThreads - 1) / kThreads;
    rank4_pair_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(payloadT), nbpad,
        static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
        static_cast<int32_t*>(r4lo), static_cast<int32_t*>(r4hi), m);
  }
  return static_cast<int>(cudaGetLastError());
}
