// Rank arithmetic over payloadT [16, NBpad] (ops/fm_stream.py), shared by
// the rank4_pair, rank4 and rank kernels.
//
// Column b = pos >> 5 of payloadT holds the rank context of text block b:
// rows 0..5 the occ checkpoints of symbols 0..5 before the block, rows
// 6..8 the three BWT bit-plane words of its 32 positions. The match word
// of char c is the AND over the three planes of the plane or its
// complement, chosen by the bits of c (the pad symbol 255 has planes
// 1,1,1 and never matches 1..4), and
//   rank(c, pos) = occ_c[b] + popc(match_c & below),
// below = (1 << (pos & 31)) - 1, computed unsigned so that offset 31
// does not overflow.

#pragma once

#include <cstdint>

namespace psi {

__device__ __forceinline__ uint32_t match_word(uint32_t p0, uint32_t p1,
                                               uint32_t p2, int c) {
  return ((c & 1) ? p0 : ~p0) & ((c & 2) ? p1 : ~p1) & ((c & 4) ? p2 : ~p2);
}

__device__ __forceinline__ uint32_t below_mask(int32_t pos) {
  return (1u << (static_cast<uint32_t>(pos) & 31u)) - 1u;
}

// Ranks of chars 1..4 at `pos`, written to out[(c-1) * m + i].
__device__ __forceinline__ void rank4_at(const int32_t* __restrict__ payloadT,
                                         size_t nbpad, int32_t pos,
                                         int32_t* __restrict__ out, int i,
                                         int m) {
  const uint32_t b = static_cast<uint32_t>(pos) >> 5;
  const uint32_t p0 = static_cast<uint32_t>(__ldg(payloadT + 6 * nbpad + b));
  const uint32_t p1 = static_cast<uint32_t>(__ldg(payloadT + 7 * nbpad + b));
  const uint32_t p2 = static_cast<uint32_t>(__ldg(payloadT + 8 * nbpad + b));
  const uint32_t below = below_mask(pos);
#pragma unroll
  for (int c = 1; c <= 4; ++c) {
    out[static_cast<size_t>(c - 1) * m + i] =
        __ldg(payloadT + c * nbpad + b) +
        __popc(match_word(p0, p1, p2, c) & below);
  }
}

}  // namespace psi
