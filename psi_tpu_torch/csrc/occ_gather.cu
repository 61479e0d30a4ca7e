// Occ-row gather over the dense per-position occ table:
//   rows[i, :] = occ[pos[i], :]   for an int32 table [R, W], W in {4, 8}.
//
// Replaces both Pallas kernels of psi_tpu/ops/fm_pallas.py:
//   * _step_kernel (via gather_occ_rows and backward_search_pallas), which
//     gathers one row per position with a 2-deep DMA ring over
//     SMEM-prefetched pointers;
//   * the inline `kernel` of blocked_gather_occ (via
//     gather_occ_rows_blocked), which gathers host-sorted pointer groups
//     from 2048-row windows staged in VMEM.
// The two differ only in how rows reach VMEM. On Hopper both are one
// gather: thread i loads its row straight from global memory.
//
// What bounds it on an H100: per position one 4-byte read (the position,
// coalesced, through the read-only path), one row read (16 bytes at W=4,
// one int4 load; 32 bytes at W=8, two int4 loads that fall in one 32-byte
// sector) and one row write (consecutive threads write consecutive rows,
// so the writes coalesce). At 10 Mbp the W=4 table is 160 MB and the W=8
// table 320 MB, far past the 50 MB L2: scattered positions make the row
// reads random HBM sector reads, so the kernel is bound by bytes moved
// (positions + rows read + rows written), and by sector efficiency where
// the positions scatter. Sorted positions let neighbouring threads share
// sectors; the TPU's window staging has no counterpart here.
//
// Positions are not range-checked on the device (psi_tpu's contract); the
// wrapper checks shapes, types, contiguity and 16-byte alignment.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int W>
__global__ void occ_gather_kernel(const int4* __restrict__ occ,
                                  const int32_t* __restrict__ pos,
                                  int4* __restrict__ rows, int m) {
  constexpr int kVec = W / 4;  // int4 loads per row
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const size_t src = static_cast<size_t>(__ldg(pos + i)) * kVec;
  const size_t dst = static_cast<size_t>(i) * kVec;
#pragma unroll
  for (int v = 0; v < kVec; ++v) rows[dst + v] = __ldg(occ + src + v);
}

}  // namespace

extern "C" int psi_occ_gather(const void* occ, int w, const void* pos,
                              void* rows, int m, void* stream) {
  if (w != 4 && w != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0) {
    const int grid = (m + kThreads - 1) / kThreads;
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* table = static_cast<const int4*>(occ);
    const auto* p = static_cast<const int32_t*>(pos);
    auto* out = static_cast<int4*>(rows);
    if (w == 4) {
      occ_gather_kernel<4><<<grid, kThreads, 0, s>>>(table, p, out, m);
    } else {
      occ_gather_kernel<8><<<grid, kThreads, 0, s>>>(table, p, out, m);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
