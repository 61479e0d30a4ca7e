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
// kernels: this kernel has no TPU counterpart.
//
// What bounds it on an H100: each query streams 24 bytes in (qkey, q_src,
// q_dst, s_lo, s_hi) and one out, and its search reads scattered 32-byte
// sectors of tables of 3-200 MB, about the size of the 50 MB L2 and past
// it. Queries come in the caller's order, so neighbouring threads share no
// sectors, and the time follows the sectors a query reads: the card
// serves about 100 G of them a second (a design sweep measured
// 124-125 G/s from L2 and 30.8 G/s from HBM). The first design bisected
// the whole table, ~log2(n) dependent reads of which the last ten or so
// are such sectors, then read up to four int32 columns at row r-1, a
// sector each.
//
// This design reads about three and a half sectors a query, through
// structures built once per upload (ops/dindex_probe.directory and
// make_tables):
//  * a two-level key directory. Top bucket j holds the keys k with
//    (k >> shift) - (pk[0] >> shift) == j, at most 2^20 of them; its
//    16-byte entry is one sector. A query's bucket (clamped to the first
//    or the last, so a key outside the table still finds r = 0 or n)
//    gives its rows [first, end), or, for a bucket of more than 16 rows,
//    a sub-directory: the bucket's rows split again by
//    ((k - edge) >> s) - off into 2^m sub-buckets of about two rows, whose
//    first rows lie in one more sector. The index's keys group by source,
//    so a top bucket holds one source's rows: some 9 at (250, 450), read
//    as they are, and 120 at (1000, 10000), which split.
//  * a bisection over those rows down to four, whose keys are then loaded
//    together and counted: one or two sectors of keys.
//  * one 16-byte record (src, dst, iv_lo, iv_hi) a row, so the checks
//    read one sector where they read up to four.
// A skewed table only makes a bucket larger, and nothing reads the key's
// composite encoding: the checks are the record's, for any sorted int64
// table.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanRows = 4;   // ops/dindex_probe.SCAN_ROWS

__global__ void dindex_probe_kernel(const long long* __restrict__ pk,
                                    const int4* __restrict__ rows,
                                    const int4* __restrict__ top,
                                    const int32_t* __restrict__ sub,
                                    int shift, long long nb,
                                    const long long* __restrict__ qkey,
                                    const int32_t* __restrict__ q_src,
                                    const int32_t* __restrict__ q_dst,
                                    const int32_t* __restrict__ s_lo,
                                    const int32_t* __restrict__ s_hi,
                                    uint8_t* __restrict__ out, long long B) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const long long q = __ldg(qkey + i);
  const long long k0 = __ldg(pk);
  // the top bucket, in unsigned arithmetic: q >= k0, so the difference of
  // the shifted keys is exact even where q - k0 would overflow
  unsigned long long b = 0;
  if (q >= k0) {
    b = static_cast<unsigned long long>(q >> shift) -
        static_cast<unsigned long long>(k0 >> shift);
    if (b >= static_cast<unsigned long long>(nb)) b = nb - 1;
  }
  const int4 e = __ldg(top + b);
  int lo = e.x, hi = e.y;
  if (e.z >= 0) {
    // split: the sub-bucket of q, clamped to the bucket's first or last
    const int s = e.w & 0xff, m = e.w >> 8;
    const unsigned long long edge =
        static_cast<unsigned long long>((k0 >> shift) +
                                        static_cast<long long>(b))
        << shift;
    unsigned long long sid = 0;
    if (q >= static_cast<long long>(edge)) {
      const unsigned long long u =
          (static_cast<unsigned long long>(q) - edge) >> s;
      const unsigned long long off = static_cast<unsigned>(e.z);
      const unsigned long long last = (1ull << m) - 1;
      sid = u < off ? 0 : (u - off > last ? last : u - off);
    }
    lo = __ldg(sub + e.y + sid);
    hi = __ldg(sub + e.y + sid + 1);
  }
  while (hi - lo > kScanRows) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(pk + mid) <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int below = 0;
#pragma unroll
  for (int j = 0; j < kScanRows; ++j) {
    if (lo + j < hi) below += __ldg(pk + lo + j) <= q;
  }
  lo += below;
  bool hit = false;
  if (lo >= 1) {
    const int4 row = __ldg(rows + lo - 1);
    hit = row.x == __ldg(q_src + i) && row.y == __ldg(q_dst + i) &&
          row.w >= __ldg(s_lo + i) && row.z <= __ldg(s_hi + i);
  }
  out[i] = hit ? 1 : 0;
}

unsigned grid_of(long long B) {
  return static_cast<unsigned>((B + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int psi_dindex_probe(const void* pk, const void* rows,
                                const void* top, const void* sub, int shift,
                                long long nb, long long n, const void* qkey,
                                const void* q_src, const void* q_dst,
                                const void* s_lo, const void* s_hi,
                                void* out, long long B, void* stream) {
  if (n > 0 && B > 0 && nb > 0) {
    dindex_probe_kernel<<<grid_of(B), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(pk), static_cast<const int4*>(rows),
        static_cast<const int4*>(top), static_cast<const int32_t*>(sub),
        shift, nb, static_cast<const long long*>(qkey),
        static_cast<const int32_t*>(q_src),
        static_cast<const int32_t*>(q_dst),
        static_cast<const int32_t*>(s_lo), static_cast<const int32_t*>(s_hi),
        static_cast<uint8_t*>(out), B);
  }
  return static_cast<int>(cudaGetLastError());
}
