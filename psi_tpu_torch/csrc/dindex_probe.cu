// Distance-index pair probe (ops/dindex_probe.py, probe_bisect): the
// device half of the distance index's batched pair verification, which
// `alice dstats` and DistanceIndex.verify_batch_device run.
//
// For each query q: r = the number of row keys pk[0..n) that are <= qkey
// (a searchsorted-right; pk is sorted ascending), and the answer is
//   r >= 1 && src[r-1] == q_src && dst[r-1] == q_dst
//          && iv_hi[r-1] >= s_lo && iv_lo[r-1] <= s_hi,
// the row checks of psi_tpu/ops/dindex_probe.py::probe_bisect (:30).
// That function and probe_sort (:61) are plain XLA there, not Pallas
// kernels: this kernel has no TPU counterpart. In eager torch the
// bisection is some ten operations a step over ~23 steps; here it is one
// launch.
//
// One thread per query bisects with an ordinary `while (lo < hi)` loop
// (the answer of psi_tpu's fixed-trip loop, which only stops updating
// once a lane's range is empty), then reads the one row at r-1. The keys
// are whole int64: torch has int64 on the card. The row checks short-
// circuit, so a query whose row belongs to another pair reads neither the
// rest of the row nor s_lo and s_hi; loading the query's columns before
// the search and the row's four columns together was slower on the H100.
//
// What bounds it on an H100: each query reads 24 bytes (qkey, q_src,
// q_dst, s_lo, s_hi) and writes one; its search reads ~log2(n) keys and
// one 16-byte row. The first levels of every search read the same few
// keys, which stay in L1 and L2; the last levels of 4 M queries over a
// few million keys land on scattered 32-byte sectors, so the kernel is
// bound by scattered sector reads from L2 and HBM (at the index sizes of
// a bacterial genome the 3-60 MB key table is about the size of the 50
// MB L2). This first version is simple and right; a design for this
// card's L2 and sectors (sorted queries, a cached top of the tree) is
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void dindex_probe_kernel(const long long* __restrict__ pk,
                                    const int32_t* __restrict__ src,
                                    const int32_t* __restrict__ dst,
                                    const int32_t* __restrict__ iv_lo,
                                    const int32_t* __restrict__ iv_hi,
                                    long long n,
                                    const long long* __restrict__ qkey,
                                    const int32_t* __restrict__ q_src,
                                    const int32_t* __restrict__ q_dst,
                                    const int32_t* __restrict__ s_lo,
                                    const int32_t* __restrict__ s_hi,
                                    uint8_t* __restrict__ out,
                                    long long B) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const long long q = __ldg(qkey + i);
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(pk + mid) <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  bool hit = false;
  if (lo >= 1) {
    const long long r = lo - 1;
    hit = __ldg(src + r) == __ldg(q_src + i) &&
          __ldg(dst + r) == __ldg(q_dst + i) &&
          __ldg(iv_hi + r) >= __ldg(s_lo + i) &&
          __ldg(iv_lo + r) <= __ldg(s_hi + i);
  }
  out[i] = hit ? 1 : 0;
}

}  // namespace

extern "C" int psi_dindex_probe(const void* pk, const void* src,
                                const void* dst, const void* iv_lo,
                                const void* iv_hi, long long n,
                                const void* qkey, const void* q_src,
                                const void* q_dst, const void* s_lo,
                                const void* s_hi, void* out, long long B,
                                void* stream) {
  if (n > 0 && B > 0) {
    const long long grid = (B + kThreads - 1) / kThreads;
    dindex_probe_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(pk), static_cast<const int32_t*>(src),
        static_cast<const int32_t*>(dst), static_cast<const int32_t*>(iv_lo),
        static_cast<const int32_t*>(iv_hi), n,
        static_cast<const long long*>(qkey),
        static_cast<const int32_t*>(q_src),
        static_cast<const int32_t*>(q_dst),
        static_cast<const int32_t*>(s_lo), static_cast<const int32_t*>(s_hi),
        static_cast<uint8_t*>(out), B);
  }
  return static_cast<int>(cudaGetLastError());
}
