// Child assembly of the two-pass level route.
//
// Replaces psi_tpu/ops/fm_stream.py::_compact_kernel and its flat-ring
// variant _compact_kernel_flat (PSI_COMPACT=flat), which compute the same
// outputs and differ only in how parent windows are staged in VMEM.
// Child i of the level, with parent slot p and char c (1..4), takes the
// parent's ranks from the [4, Mprev] outputs of rank4_pair or of two
// rank4 launches:
//   lo'[i] = C[c] + r4lo[c-1][p],   hi'[i] = C[c] + r4hi[c-1][p]
//
// What bounds it on an H100: two gathered 4-byte reads per child from
// the rank tables (16 MB for both at 2^19 slots, L2-resident right after
// rank4_pair wrote them) plus streamed reads of the schedule and writes
// of the new frontier. Children are c-major with ascending parents, so a
// warp's gathers fall in one row of r4 and mostly in consecutive
// columns, which coalesces them. The TPU kernel's per-slab window cache
// and DMA exist only to stage those rows in VMEM; the L2 does it here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void compact_kernel(const int32_t* __restrict__ r4lo,
                               const int32_t* __restrict__ r4hi, int mprev,
                               const int32_t* __restrict__ parents,
                               const int32_t* __restrict__ chars,
                               const int32_t* __restrict__ C,
                               int32_t* __restrict__ lo_out,
                               int32_t* __restrict__ hi_out, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int c = chars[i];
  const size_t idx = static_cast<size_t>(c - 1) * mprev + parents[i];
  const int32_t base = __ldg(C + c);
  lo_out[i] = base + __ldg(r4lo + idx);
  hi_out[i] = base + __ldg(r4hi + idx);
}

}  // namespace

extern "C" int psi_compact(const void* r4lo, const void* r4hi, int mprev,
                           const void* parents, const void* chars,
                           const void* C, void* lo_out, void* hi_out, int m,
                           void* stream) {
  if (m > 0) {
    const int grid = (m + kThreads - 1) / kThreads;
    compact_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(r4lo), static_cast<const int32_t*>(r4hi),
        mprev, static_cast<const int32_t*>(parents),
        static_cast<const int32_t*>(chars), static_cast<const int32_t*>(C),
        static_cast<int32_t*>(lo_out), static_cast<int32_t*>(hi_out), m);
  }
  return static_cast<int>(cudaGetLastError());
}
