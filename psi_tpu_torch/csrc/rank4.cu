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
// (ops/fm_trie.py, pair=False). Thread t ranks pos[2t] and pos[2t+1] from
// the payloadR records of their blocks (payload_rank.cuh):
//   out[c-1][i] = rec[c-1] + popc(rec[3+c] & below(pos)),  c = 1..4
//
// What bounds it on an H100: per position, one read of pos, one record
// and four output words. The record holds exactly the eight words the
// four ranks need, one 32-byte L2 sector read as two 16-byte loads that
// depend only on pos; psi_tpu's payloadT, which this kernel read before,
// spreads them over seven rows 1.25 MB apart. payloadR is 10 MB at 10
// Mbp and stays in the 50 MB L2, so the cost is a round of L2 latency and
// the lines each warp's loads touch, not HBM bytes. At scattered
// positions that is seven sectors a position against one, which the
// record pays back several times over; on the route's own positions, a
// sorted frontier whose neighbours share blocks, the two layouts touch
// about as many lines, and a kernel that moves only pos and the outputs
// takes most of this one's time (the layout sweep in PERF_ARCHIVE.md).
// Two neighbouring positions per thread, the position pair read and each
// output row written as 8-byte pairs, keep two records in flight per
// thread and halve the loads and stores the warp issues; that pays on a
// sorted frontier and costs a little at scattered positions. No staging:
// the L2 plays the part of the TPU kernels' VMEM windows.
//
// Positions ([0, n]) are not checked on the device (psi_tpu's contract);
// the wrapper checks shape, type, contiguity, the record table's 32-byte
// alignment and the positions' 8-byte alignment.

#include <cstdint>
#include <cuda_runtime.h>

#include "payload_rank.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t rank_c(int occ, int match, uint32_t below) {
  return occ + __popc(static_cast<uint32_t>(match) & below);
}

// Thread t ranks positions 2t and 2t + 1 (2t alone where m is odd and it
// is the last). Output rows are written as pairs where m is even, so that
// every row starts 8-byte aligned.
__global__ void rank4_kernel(const int32_t* __restrict__ payloadR,
                             const int32_t* __restrict__ pos,
                             int32_t* __restrict__ out, int m) {
  const int i = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= m) return;
  const bool two = i + 1 < m;
  int2 q;
  if (two) {
    q = __ldg(reinterpret_cast<const int2*>(pos + i));
  } else {
    q.x = q.y = __ldg(pos + i);
  }
  int4 occ0, match0, occ1, match1;
  psi::load_record(payloadR, q.x, occ0, match0);
  psi::load_record(payloadR, q.y, occ1, match1);
  const uint32_t b0 = psi::below_mask(q.x), b1 = psi::below_mask(q.y);
  const int2 r[4] = {
      {rank_c(occ0.x, match0.x, b0), rank_c(occ1.x, match1.x, b1)},
      {rank_c(occ0.y, match0.y, b0), rank_c(occ1.y, match1.y, b1)},
      {rank_c(occ0.z, match0.z, b0), rank_c(occ1.z, match1.z, b1)},
      {rank_c(occ0.w, match0.w, b0), rank_c(occ1.w, match1.w, b1)}};
  const size_t row = static_cast<size_t>(m);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int32_t* dst = out + c * row + i;
    if (two && (m & 1) == 0) {
      *reinterpret_cast<int2*>(dst) = r[c];
    } else {
      dst[0] = r[c].x;
      if (two) dst[1] = r[c].y;
    }
  }
}

}  // namespace

extern "C" int psi_rank4(const void* payloadR, const void* pos, void* out,
                         int m, void* stream) {
  if (m > 0) {
    const int threads = (m + 1) / 2;
    const int grid = (threads + kThreads - 1) / kThreads;
    rank4_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(payloadR),
        static_cast<const int32_t*>(pos), static_cast<int32_t*>(out), m);
  }
  return static_cast<int>(cudaGetLastError());
}
