// One level of the trie-batched FM backward search, two children per
// thread.
//
// Replaces psi_tpu/ops/fm_fused.py::_fused_kernel, the Pallas kernel that
// runs the whole level loop in one launch with the payload and the
// frontier resident in VMEM. Here one launch runs one level; the caller
// (ops/fm_fused.py::trie_fused) ping-pongs the frontier between two
// buffers, so no kernel ever reads what it writes.
//
// Child i of the level computes, for its parent slot p and char c (1..4):
//   lo'[i] = C[c] + rank(c, lo[p]),   hi'[i] = C[c] + rank(c, hi[p])
// over payloadC [4, NBpad, 2], the (occ_c, match_c) word of each char and
// text block (payload_rank.cuh has the layouts and the arithmetic).
//
// What bounds it on an H100: three rounds of dependent reads per child.
// The schedule (parent, char) is read coalesced; the parent's lo and hi
// are gathered, but the schedule orders children c-major with ascending
// parents, so a warp's parents are neighbours and its gathers share
// sectors; then the rank word of lo's block, and of hi's block only where
// it differs. payloadC is 10 MB at 10 Mbp and the frontier 4 MB at 2^19
// slots: both stay in the 50 MB L2, so the cost is L2 latency and the
// cache lines each warp's loads touch, not HBM bytes. The rank words are
// the smaller part: a kernel that reads everything but them takes about
// 85% of this one's time (the layout sweep in PERF_ARCHIVE.md). Of the
// layouts that sweep timed, payloadC touches the fewest lines: a warp's
// children share one char and have neighbouring parents, whose blocks
// lie a few apart, and one 8-byte word per rank packs four blocks of one
// char into a sector (psi_tpu's match-format payloadW needs two words 512
// bytes apart; payloadR's 32-byte record per block, which one rank of a
// scattered position wants, gives each child a sector of its own). Two
// children per thread, loaded and stored as 8-byte pairs, keep more
// gathers in flight per thread than one. C[0..4] comes from shared
// memory, loaded once per thread block. The TPU kernel's VMEM residency,
// window loops and sequential-grid fusion have no counterpart: the L2
// plays the resident buffer.
//
// Neither chars (1..4), parents ([0, Mprev)) nor positions ([0, n]) are
// checked on the device (psi_tpu's contract); the wrapper checks shapes,
// types, contiguity and the 8-byte alignment of payloadC and of the
// paired schedule and output arrays.

#include <cstdint>
#include <cuda_runtime.h>

#include "payload_rank.cuh"

namespace {

constexpr int kThreads = 256;

// Thread t runs children 2t and 2t + 1, loaded and stored as pairs;
// where m is odd, thread 0 also runs the last child alone. Every rank word
// of the pair is loaded before any rank is computed, so that all are in
// flight at once: lo's word of each child, and hi's where hi's block
// differs from lo's; hi's word is chosen from the two only after both
// loads (a copy of lo's word made before hi's load would wait for lo's to
// arrive). The chars pair is loaded after the frontier gathers, which
// need only the parents. On an H100 the compiled order of these loads
// matters: forms of this kernel that differed only in where the odd tail
// is checked, or in the order of the schedule loads, ran 7-10% slower.
__global__ void trie_level_kernel(
    const int32_t* __restrict__ payloadC, int nbpad,
    const int32_t* __restrict__ C, const int32_t* __restrict__ parents,
    const int32_t* __restrict__ chars, const int32_t* __restrict__ lo_in,
    const int32_t* __restrict__ hi_in, int32_t* __restrict__ lo_out,
    int32_t* __restrict__ hi_out, int m) {
  __shared__ int32_t c_base[5];  // C[0..4]; chars are 1..4
  if (threadIdx.x < 5) c_base[threadIdx.x] = C[threadIdx.x];
  __syncthreads();
  const int i = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  if ((m & 1) && blockIdx.x == 0 && threadIdx.x == 0) {
    const int last = m - 1;
    const int p = __ldg(parents + last);
    const int c = __ldg(chars + last);
    const int32_t l = __ldg(lo_in + p), h = __ldg(hi_in + p);
    const int2 wl = psi::char_word(payloadC, nbpad, c, l);
    const int2 wh = psi::char_word(payloadC, nbpad, c, h);
    lo_out[last] = c_base[c] + psi::rank_of(wl, l);
    hi_out[last] = c_base[c] + psi::rank_of(wh, h);
  }
  if ((i >> 1) >= (m >> 1)) return;
  const int2 p = __ldg(reinterpret_cast<const int2*>(parents + i));
  const int32_t l0 = __ldg(lo_in + p.x), h0 = __ldg(hi_in + p.x);
  const int32_t l1 = __ldg(lo_in + p.y), h1 = __ldg(hi_in + p.y);
  const int2 c = __ldg(reinterpret_cast<const int2*>(chars + i));
  const size_t n = static_cast<size_t>(nbpad);
  const bool apart0 = psi::block_of(h0) != psi::block_of(l0);
  const bool apart1 = psi::block_of(h1) != psi::block_of(l1);
  const int2 wl0 = psi::char_word(payloadC, n, c.x, l0);
  const int2 wl1 = psi::char_word(payloadC, n, c.y, l1);
  int2 wh0 = {0, 0}, wh1 = {0, 0};
  if (apart0) wh0 = psi::char_word(payloadC, n, c.x, h0);
  if (apart1) wh1 = psi::char_word(payloadC, n, c.y, h1);
  const int2 lo = {c_base[c.x] + psi::rank_of(wl0, l0),
                   c_base[c.y] + psi::rank_of(wl1, l1)};
  const int2 hi = {c_base[c.x] + psi::rank_of(apart0 ? wh0 : wl0, h0),
                   c_base[c.y] + psi::rank_of(apart1 ? wh1 : wl1, h1)};
  *reinterpret_cast<int2*>(lo_out + i) = lo;
  *reinterpret_cast<int2*>(hi_out + i) = hi;
}

}  // namespace

extern "C" int psi_trie_level(const void* payloadC, int nbpad, const void* C,
                              const void* parents, const void* chars,
                              const void* lo_in, const void* hi_in,
                              void* lo_out, void* hi_out, int m,
                              void* stream) {
  if (m > 0) {
    const int threads = (m + 1) / 2;
    const int grid = (threads + kThreads - 1) / kThreads;
    trie_level_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(payloadC), nbpad,
        static_cast<const int32_t*>(C),
        static_cast<const int32_t*>(parents),
        static_cast<const int32_t*>(chars),
        static_cast<const int32_t*>(lo_in),
        static_cast<const int32_t*>(hi_in), static_cast<int32_t*>(lo_out),
        static_cast<int32_t*>(hi_out), m);
  }
  return static_cast<int>(cudaGetLastError());
}
