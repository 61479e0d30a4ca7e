// Ranks of all four characters at every position of one array.
//
// Replaces all four of psi_tpu's rank4_stream kernels
// (psi_tpu/ops/fm_stream.py): _rank4_kernel_flat (the default, a flat
// ring of window DMAs), _rank4_kernel (per-slab window ring),
// _rank4_kernel_mxu (windows fetched by a one-hot matmul) and
// _rank4_kernel_res (the payload resident in VMEM as payload8). They
// compute the same [4, M] and differ only in how payload windows reach
// VMEM, which has no Hopper counterpart. It is the rank pass of the
// two-pass level route when lo and hi are ranked in separate launches
// (ops/fm_trie.py, pair=False). Thread i ranks pos[i]:
//   out[c-1][i] = occ_c[b] + popc(match_c & below),  c = 1..4
// (payload_rank.cuh has the arithmetic).
//
// What bounds it on an H100: per position, seven dependent-free 4-byte
// gathers from one payloadT column (20 MB at 10 Mbp, of which the seven
// rows read are ~9 MB; it fits the 50 MB L2), one 4-byte read of pos and
// four 4-byte writes that coalesce across the warp. A sorted frontier
// gives neighbouring threads neighbouring columns; scattered positions
// make each gather its own L2 sector. Bound by scattered L2 reads, so the
// design is one thread per position with no staging: the L2 plays the
// part of the TPU kernels' VMEM windows.

#include <cstdint>
#include <cuda_runtime.h>

#include "payload_rank.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void rank4_kernel(const int32_t* __restrict__ payloadT, int nbpad,
                             const int32_t* __restrict__ pos,
                             int32_t* __restrict__ out, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  psi::rank4_at(payloadT, static_cast<size_t>(nbpad), pos[i], out, i, m);
}

}  // namespace

extern "C" int psi_rank4(const void* payloadT, int nbpad, const void* pos,
                         void* out, int m, void* stream) {
  if (m > 0) {
    const int grid = (m + kThreads - 1) / kThreads;
    rank4_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(payloadT), nbpad,
        static_cast<const int32_t*>(pos), static_cast<int32_t*>(out), m);
  }
  return static_cast<int>(cudaGetLastError());
}
