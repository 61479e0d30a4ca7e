// Rank arithmetic over the rank payloads (ops/fm_stream.py), shared by the
// rank kernels.
//
// payloadR [NBpad, 8] int32, the per-block rank record read by rank.cu and
// rank4.cu: row b is (occ_1..occ_4, match_1..match_4) of text block
// b = pos >> 5, the occ checkpoints of ACGT before the block and the
// per-char match-mask words of its 32 positions. A row is 32 bytes, one L2
// sector, 32-byte aligned (the wrappers check the base), so
//   rank(c, pos) = rec[b][c-1] + popc(rec[b][3+c] & below(pos))
// reads two words of one sector, and the whole record is two 16-byte
// loads.
//
// payloadC [4, NBpad, 2] int32, the same words by char, read by
// trie_level.cu: word (c-1, b) is (occ_c, match_c) of block b, one 8-byte
// load (the wrapper checks 8-byte alignment), and four neighbouring blocks
// of one char share a sector.
//
// payloadT [16, NBpad] int32, psi_tpu's layout, read by rank4_pair.cu:
// column b holds in rows 0..5 the occ checkpoints of symbols 0..5 before
// block b, in rows 6..8 the three BWT bit-plane words of its 32
// positions. The match word of char c is the AND over the three planes of
// the plane or its complement, chosen by the bits of c (the pad symbol
// 255 has planes 1,1,1 and never matches 1..4).
//
// In all three, below(pos) = (1 << (pos & 31)) - 1, computed unsigned so
// that offset 31 does not overflow.

#pragma once

#include <cstdint>

namespace psi {

constexpr int kRecord = 8;  // int32 words per payloadR row

__device__ __forceinline__ uint32_t below_mask(int32_t pos) {
  return (1u << (static_cast<uint32_t>(pos) & 31u)) - 1u;
}

__device__ __forceinline__ uint32_t block_of(int32_t pos) {
  return static_cast<uint32_t>(pos) >> 5;
}

// The payloadR record of pos's block.
__device__ __forceinline__ const int32_t* record(
    const int32_t* __restrict__ payloadR, int32_t pos) {
  return payloadR + static_cast<size_t>(block_of(pos)) * kRecord;
}

// rank(c, pos) from the record `rec` of pos's block.
__device__ __forceinline__ int32_t rank_in(const int32_t* __restrict__ rec,
                                           int c, int32_t pos) {
  const uint32_t match = static_cast<uint32_t>(__ldg(rec + 3 + c));
  return __ldg(rec + c - 1) + __popc(match & below_mask(pos));
}

// The whole record of pos's block: occ_1..4 and match_1..4, two 16-byte
// loads of one sector.
__device__ __forceinline__ void load_record(
    const int32_t* __restrict__ payloadR, int32_t pos, int4& occ,
    int4& match) {
  const int4* rec = reinterpret_cast<const int4*>(record(payloadR, pos));
  occ = __ldg(rec);
  match = __ldg(rec + 1);
}

// rank(c, l) and rank(c, h) from payloadR: l's record, and h's only where
// h's block differs from l's.
__device__ __forceinline__ void rank_pair(const int32_t* __restrict__ payloadR,
                                          int c, int32_t l, int32_t h,
                                          int32_t& rank_l, int32_t& rank_h) {
  const int32_t* rec = record(payloadR, l);
  const uint32_t match = static_cast<uint32_t>(__ldg(rec + 3 + c));
  const int32_t occ = __ldg(rec + c - 1);
  rank_l = occ + __popc(match & below_mask(l));
  rank_h = block_of(h) == block_of(l)
               ? occ + __popc(match & below_mask(h))
               : rank_in(record(payloadR, h), c, h);
}

// The payloadC word (occ_c, match_c) of pos's block.
__device__ __forceinline__ int2 char_word(const int32_t* __restrict__ payloadC,
                                          size_t nbpad, int c, int32_t pos) {
  return __ldg(reinterpret_cast<const int2*>(payloadC) +
               static_cast<size_t>(c - 1) * nbpad + block_of(pos));
}

// rank(c, pos) from the payloadC word of pos's block.
__device__ __forceinline__ int32_t rank_of(int2 word, int32_t pos) {
  return word.x + __popc(static_cast<uint32_t>(word.y) & below_mask(pos));
}

__device__ __forceinline__ uint32_t match_word(uint32_t p0, uint32_t p1,
                                               uint32_t p2, int c) {
  return ((c & 1) ? p0 : ~p0) & ((c & 2) ? p1 : ~p1) & ((c & 4) ? p2 : ~p2);
}

// Ranks of chars 1..4 at `pos` from payloadT, written to
// out[(c-1) * m + i].
__device__ __forceinline__ void rank4_at(const int32_t* __restrict__ payloadT,
                                         size_t nbpad, int32_t pos,
                                         int32_t* __restrict__ out, int i,
                                         int m) {
  const uint32_t b = block_of(pos);
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
