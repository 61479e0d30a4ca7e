// Child assembly of the two-pass level route, one child per thread.
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
// the rank tables (16 MB for both at 2^19 slots) plus streamed reads of
// the schedule and writes of the new frontier (8 MB). On its route
// rank4_pair has just written the tables, so they sit in L2 and the bound
// is the streamed bytes; read cold they cost the 32-byte sectors their
// words land on (0.41 sectors of each table per child on the bacterial
// cell, PERF.md). The time is two dependent rounds of loads (the
// schedule, then the two gathers and C[c], which need only the schedule
// and go out together) and the launch: a kernel that streams the schedule
// and the frontier without touching r4 takes under half of this one's
// time cold, and 82-85% of it where rank4_pair has just run. Children are
// c-major with ascending parents, so the 32 children of a warp gather
// from one row of r4 within a few 128-byte lines, and each load and store
// instruction covers 32 neighbouring children.
//
// A design sweep (PERF_ARCHIVE.md) timed this kernel beside the designs
// it was held against, cold (9 levels of rank tables cycled) and as the
// route runs it: two or four children a thread, consecutive with 8- or 16-byte schedule loads and frontier
// stores or strided by the block's width; C[0..4] staged in shared memory;
// streaming stores. None ran the two-pass route faster than one child a
// thread (PERF.md); consecutive children spread a warp's gathers
// over K times the lines. The TPU kernel's per-slab window cache and DMA
// exist only to stage r4's rows in VMEM; the L2 does it here.
//
// Neither chars (1..4) nor parents ([0, Mprev)) are checked on the
// device (psi_tpu's contract); the wrapper checks shapes, types and
// contiguity.

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
  const int c = __ldg(chars + i);
  const size_t x = static_cast<size_t>(c - 1) * mprev + __ldg(parents + i);
  const int32_t base = __ldg(C + c);
  lo_out[i] = base + __ldg(r4lo + x);
  hi_out[i] = base + __ldg(r4hi + x);
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
