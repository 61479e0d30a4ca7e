// Two entry points over the dense per-position occ table, an int32 table
// [R, W], W in {4, 8} (ops/fm_pallas.py):
//   psi_occ_gather   rows[i, :] = occ[pos[i], :], the row gather;
//   psi_occ_lf_pair  one LF step of a (lo, hi) pair per key:
//                    (C[c] + occ[lo, c-1], C[c] + occ[hi, c-1]).
//
// psi_occ_gather replaces both Pallas kernels of psi_tpu/ops/fm_pallas.py:
//   * _step_kernel (:31, via gather_occ_rows and backward_search_pallas),
//     which gathers one row per position with a 2-deep DMA ring over
//     SMEM-prefetched pointers;
//   * the inline `kernel` of blocked_gather_occ (:200, via
//     gather_occ_rows_blocked), which gathers host-sorted pointer groups
//     from 2048-row windows staged in VMEM.
// The two differ only in how rows reach VMEM. On Hopper both are one
// gather straight from global memory, one 16-byte piece of a row per
// lane.
//
// What bounds the row gather on an H100: per position one 4-byte read
// (the position, coalesced), one row read (16 bytes at W=4, 32 at W=8,
// inside one 32-byte sector) and one row write. At 10 Mbp the W=4 table
// is 160 MB and the W=8 table 320 MB, past the 50 MB L2: scattered
// positions make the row reads random sector reads, which the card serves
// at the same rate whether 16, 32 or 64 bytes of a piece are asked for
// (a design sweep measured it; PERF_ARCHIVE.md), so the kernel is
// bound by that rate and the streamed bytes. Sorted positions let
// neighbouring lanes share sectors; the TPU's window staging has no
// counterpart here. Of the designs the sweep timed, none was faster on
// sorted positions, the row gather's own path (gather_occ_rows_blocked
// sorts) at W = 4: consecutive rows a thread spread a warp instruction's
// rows apart, four rows a thread strided by the block's width won 6% on
// scattered positions and lost 3-6% on sorted ones, and streaming stores
// changed nothing. At W = 8 a lane pair per row, against one thread
// loading both halves, makes each load and store instruction ask for
// every sector once, and was 5-6% faster in both orders.
//
// psi_occ_lf_pair is what _step_kernel's caller, backward_search_pallas,
// does with the rows (take column c-1 of lo's and hi's row, add C[c]),
// folded into the gather. Its bound is HBM sectors: each key needs one
// 4-byte word of lo's row and one of hi's, and the card moves at least
// the 32-byte sector around each from a table past L2. For a present
// key's narrow range hi's word lies in the same 128-byte line as lo's
// (hi - lo < 8 at W = 4), often in the same sector. Each key gets a lane
// pair, lo on the even lane and hi on the odd one, so that one warp load
// instruction covers both words of a key and the sector they share is
// requested once. The pair adds C[c] from shared memory and writes lo'
// and hi' (coalesced). Against the row gather and the PyTorch ops around
// it this moves 4 bytes of each row instead of 16 or 32, and makes one
// launch per LF step instead of about seven. On the gather route's
// positions at 10 Mbp (H100 80GB HBM3, 700 W) the lane pair took 24.1 us
// per step at W = 4 and 28.6 at W = 8, 2-5% less than one thread per key
// that loads both words back to back (PERF.md).
//
// Positions are not range-checked on the device, nor chars (1..4)
// (psi_tpu's contract); the wrappers check shapes, types, contiguity and,
// for the row gather, 16-byte alignment.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// One 16-byte piece of a row per lane: a row of W int32 takes W / 4
// neighbouring lanes (one at W = 4, a lane pair at W = 8), each of which
// loads the row's position and its own piece and stores it. A warp's
// load instruction then asks for 32 / (W / 4) rows, each sector once, and
// its store instruction writes 512 contiguous bytes.
template <int W>
__global__ void occ_gather_kernel(const int4* __restrict__ occ,
                                  const int32_t* __restrict__ pos,
                                  int4* __restrict__ rows, int m) {
  constexpr int kLanes = W / 4;  // lanes a row
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t i = t / kLanes;  // the row
  if (i >= m) return;
  rows[t] = __ldg(occ + static_cast<size_t>(__ldg(pos + i)) * kLanes +
                  t % kLanes);
}

template <int W>
__global__ void occ_lf_pair_kernel(const int32_t* __restrict__ occ,
                                   const int32_t* __restrict__ C,
                                   const int32_t* __restrict__ chars,
                                   const int32_t* __restrict__ lo,
                                   const int32_t* __restrict__ hi,
                                   int32_t* __restrict__ lo_out,
                                   int32_t* __restrict__ hi_out, int m) {
  __shared__ int32_t c_base[5];  // C[0..4]; chars are 1..4
  if (threadIdx.x < 5) c_base[threadIdx.x] = C[threadIdx.x];
  __syncthreads();
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t i = t >> 1;  // the key; lo on the even lane, hi on the odd
  if (i >= m) return;
  const int c = __ldg(chars + i);
  const bool is_hi = t & 1;
  const int32_t p = __ldg((is_hi ? hi : lo) + i);
  (is_hi ? hi_out : lo_out)[i] =
      c_base[c] + __ldg(occ + static_cast<size_t>(p) * W + c - 1);
}

}  // namespace

extern "C" int psi_occ_gather(const void* occ, int w, const void* pos,
                              void* rows, int m, void* stream) {
  if (w != 4 && w != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0) {
    const int grid = static_cast<int>(
        (static_cast<int64_t>(m) * (w / 4) + kThreads - 1) / kThreads);
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

extern "C" int psi_occ_lf_pair(const void* occ, int w, const void* C,
                               const void* chars, const void* lo,
                               const void* hi, void* lo_out, void* hi_out,
                               int m, void* stream) {
  if (w != 4 && w != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0) {
    const int grid = static_cast<int>(
        (2 * static_cast<int64_t>(m) + kThreads - 1) / kThreads);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* table = static_cast<const int32_t*>(occ);
    const auto* cb = static_cast<const int32_t*>(C);
    const auto* c = static_cast<const int32_t*>(chars);
    const auto* l = static_cast<const int32_t*>(lo);
    const auto* h = static_cast<const int32_t*>(hi);
    auto* lo2 = static_cast<int32_t*>(lo_out);
    auto* hi2 = static_cast<int32_t*>(hi_out);
    if (w == 4) {
      occ_lf_pair_kernel<4><<<grid, kThreads, 0, s>>>(table, cb, c, l, h,
                                                      lo2, hi2, m);
    } else {
      occ_lf_pair_kernel<8><<<grid, kThreads, 0, s>>>(table, cb, c, l, h,
                                                      lo2, hi2, m);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
