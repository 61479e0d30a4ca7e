// Rank over one depth of the chunk's seeds index (records.SeedsIndex),
// shared by range_refine.cu and traverse_step.cu (seeds_refine, the
// one-char rank, is traverse_step's).
//
// Per depth d the seeds index holds, for every 32-key block b,
//   occ[d, b]    int32 x 4  the count of each char in keys [0, 32 b)
//   planes[d, b] int32 x 2  bit i of word p is bit p of the depth-d char
//                           of key 32 b + i
// so #(char c in keys [0, i)) = occ[d, i/32][c] + popcount(match_c &
// ((1 << i%32) - 1)): one 16-byte occ load and one 8-byte plane load per
// end of a range. The mask is computed in uint32: psi_tpu's int32
// `(1 << 31) - 1` relies on wrap-around, which is undefined for a signed
// int in C++. The keys are sorted, so at each depth the children of a
// range [lo, hi) are contiguous, in char order: char c's range starts
// after the keys in [lo, hi) whose char is below c.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Count of each char 0..3 among the depth's keys [0, i).
__device__ __forceinline__ int4 seeds_counts_at(
    const int4* __restrict__ occ_d, const int2* __restrict__ planes_d,
    int32_t i) {
  const int b = i >> 5;
  const int4 base = __ldg(occ_d + b);
  const int2 pw = __ldg(planes_d + b);
  const uint32_t p0 = static_cast<uint32_t>(pw.x);
  const uint32_t p1 = static_cast<uint32_t>(pw.y);
  const uint32_t below = (1u << (i & 31)) - 1u;
  return make_int4(base.x + __popc(~p0 & ~p1 & below),
                   base.y + __popc(p0 & ~p1 & below),
                   base.z + __popc(~p0 & p1 & below),
                   base.w + __popc(p0 & p1 & below));
}

// [lo, hi) narrowed by char ch (0..3) at the depth: (lo', hi').
__device__ __forceinline__ int2 seeds_refine(
    const int4* __restrict__ occ_d, const int2* __restrict__ planes_d,
    int32_t lo, int32_t hi, int ch) {
  const int4 a = seeds_counts_at(occ_d, planes_d, lo);
  const int4 z = seeds_counts_at(occ_d, planes_d, hi);
  const int n0 = z.x - a.x, n1 = z.y - a.y, n2 = z.z - a.z, n3 = z.w - a.w;
  // keys of chars below ch come first; then ch's own
  const int below = (ch > 0 ? n0 : 0) + (ch > 1 ? n1 : 0) + (ch > 2 ? n2 : 0);
  const int count = ch == 0 ? n0 : ch == 1 ? n1 : ch == 2 ? n2 : n3;
  const int32_t new_lo = lo + below;
  return make_int2(new_lo, new_lo + count);
}
