// psi_chunk — native per-chunk hot path: rolling k-mer extraction and
// the reads-side seed-index fill (per-depth chars + rank checkpoints +
// bit planes). These are the two host legs that dominate sustained
// chunk time after the device trie (profiled: extract 123 ms,
// index fill 147 ms per 100 K-read chunk in NumPy on this host).
//
// Reference semantics mirrored (not copied): seeding() windows
// (include/psi/sequence.hpp:1688-1816) and the reads-side index
// construction the WOTD/ESA trie stands in for
// (include/psi/index.hpp); the columnar chars/occ/planes layout is
// this repo's own device-rank design (psi_tpu/records.py).
//
// C ABI via ctypes (no pybind11).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Rolling k-mer extraction over concatenated ASCII reads.
//   text:      concatenated read bytes [offsets[R]]
//   offsets:   int64 [R+1] read boundaries
//   out_off:   int64 [R+1] output slot boundaries (precomputed: number
//              of windows per read, step spacing, optional greedy tail)
//   k, step:   window length / spacing
//   greedy:    add an end-anchored final window when the tail does not
//              fit (GreedyNonOverlapping)
//   keys:      uint64 [S] packed 2-bit keys (invalid chars packed as 0)
//   valid:     uint8  [S] 1 iff the window holds no non-ACGT char
//   seedmap:   int64  [S*2] rows (read_index, read_offset)
// Window starts are 0, step, 2*step, ... while start + k <= len — the
// same enumeration as ops/kmers.extract_kmers.
void psi_extract_kmers(const uint8_t* text, const int64_t* offsets,
                       const int64_t* out_off, int64_t n_reads,
                       int32_t k, int32_t step, int32_t greedy,
                       uint64_t* keys, uint8_t* valid,
                       int64_t* seedmap) {
  // 2-bit codes; 0xff = invalid
  uint8_t lut[256];
  std::memset(lut, 0xff, sizeof(lut));
  const char* acgt = "ACGT";
  const char* acgt_l = "acgt";
  for (int i = 0; i < 4; ++i) {
    lut[(uint8_t)acgt[i]] = (uint8_t)i;
    lut[(uint8_t)acgt_l[i]] = (uint8_t)i;
  }
  const uint64_t mask = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 256)
#endif
  for (int64_t r = 0; r < n_reads; ++r) {
    const int64_t beg = offsets[r], end = offsets[r + 1];
    const int64_t len = end - beg;
    int64_t slot = out_off[r];
    const int64_t n_slots = out_off[r + 1] - slot;
    if (len < k || n_slots == 0) continue;
    const uint8_t* s = text + beg;

    if (step == 1) {
      // one rolling pass: key = (key << 2 | c) & mask; a window is
      // valid iff no invalid char in the last k positions
      uint64_t key = 0;
      int64_t last_bad = -1;
      for (int64_t i = 0; i < len; ++i) {
        uint8_t c = lut[s[i]];
        if (c == 0xff) {
          last_bad = i;
          c = 0;
        }
        key = ((key << 2) | c) & mask;
        const int64_t start = i - k + 1;
        if (start >= 0) {
          const int64_t j = slot + start;
          keys[j] = key;
          valid[j] = (last_bad < start) ? 1 : 0;
          seedmap[2 * j] = r;
          seedmap[2 * j + 1] = start;
        }
      }
    } else {
      // strided windows (plus optional greedy tail): pack each window
      // directly; windows are sparse so the rolling trick buys nothing
      const int64_t n_regular = (len - k) / step + 1;
      for (int64_t w = 0; w < n_slots; ++w) {
        // slots beyond the regular set exist only when the caller
        // appended the end-anchored greedy-tail window
        const int64_t start = (w < n_regular) ? w * step : len - k;
        (void)greedy;
        uint64_t key = 0;
        uint8_t ok = 1;
        for (int32_t j = 0; j < k; ++j) {
          uint8_t c = lut[s[start + j]];
          if (c == 0xff) {
            ok = 0;
            c = 0;
          }
          key = (key << 2) | c;
        }
        const int64_t j = slot + w;
        keys[j] = key;
        valid[j] = ok;
        seedmap[2 * j] = r;
        seedmap[2 * j + 1] = start;
      }
    }
  }
}

// Seed-index fill from the sorted key array: per-depth 2-bit chars,
// per-depth rank checkpoints occ[d, b, c] = #{chars[d, :b*block] == c},
// and per-depth bit planes (one 32-bit word per block per plane).
// Layouts match records.SeedsIndex exactly:
//   chars  uint8 [k, V]
//   occ    int32 [k, nb+1, 4]
//   planes int32 [k, nb+1, 2]  (words beyond V carry zero pad bits)
// Parallel over depths (k independent rows).
void psi_seed_index_fill(const uint64_t* sorted_keys, int64_t V,
                         int32_t k, int32_t block, int64_t nb,
                         uint8_t* chars, int32_t* occ, int32_t* planes) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int32_t d = 0; d < k; ++d) {
    const int32_t shift = 2 * (k - 1 - d);
    uint8_t* ch = chars + (int64_t)d * V;
    int32_t* oc = occ + (int64_t)d * (nb + 1) * 4;
    int32_t* pl = planes + (int64_t)d * (nb + 1) * 2;
    int32_t cnt[4] = {0, 0, 0, 0};
    oc[0] = oc[1] = oc[2] = oc[3] = 0;
    int64_t b = 0;
    uint32_t w0 = 0, w1 = 0;
    for (int64_t i = 0; i < V; ++i) {
      const int64_t off = i % block;
      if (off == 0 && i > 0) {
        pl[2 * b] = (int32_t)w0;
        pl[2 * b + 1] = (int32_t)w1;
        w0 = w1 = 0;
        ++b;
        std::memcpy(oc + 4 * b, cnt, sizeof(cnt));
      }
      const uint8_t c = (uint8_t)((sorted_keys[i] >> shift) & 3u);
      ch[i] = c;
      ++cnt[c];
      w0 |= (uint32_t)(c & 1) << off;
      w1 |= (uint32_t)((c >> 1) & 1) << off;
    }
    // flush the final partial block and zero the tail
    pl[2 * b] = (int32_t)w0;
    pl[2 * b + 1] = (int32_t)w1;
    for (int64_t bb = b + 1; bb <= nb; ++bb) {
      pl[2 * bb] = 0;
      pl[2 * bb + 1] = 0;
    }
    for (int64_t bb = b + 1; bb <= nb; ++bb)
      std::memcpy(oc + 4 * bb, cnt, sizeof(cnt));
  }
}

// LSD radix sort of (key, id) pairs by key — 8-bit digits over the low
// 2k bits. ids are initialized by the caller (compacted valid-seed
// ids). Ping-pong between (keys, ids) and scratch; the sorted result
// always lands back in (keys, ids). Single histogram pass per digit;
// both histogram and scatter are sequential (the stable scatter order
// is load-bearing, and at chunk sizes the pass is memory-bound anyway).
void psi_radix_sort_kv(uint64_t* keys, int64_t* ids, int64_t n,
                       int32_t key_bits, uint64_t* tmp_keys,
                       int64_t* tmp_ids) {
  const int32_t passes = (key_bits + 7) / 8;
  uint64_t* src_k = keys;
  int64_t* src_i = ids;
  uint64_t* dst_k = tmp_keys;
  int64_t* dst_i = tmp_ids;
  int64_t hist[256];
  for (int32_t p = 0; p < passes; ++p) {
    const int32_t sh = 8 * p;
    std::memset(hist, 0, sizeof(hist));
    for (int64_t i = 0; i < n; ++i) ++hist[(src_k[i] >> sh) & 0xff];
    int64_t sum = 0;
    for (int32_t d = 0; d < 256; ++d) {
      const int64_t c = hist[d];
      hist[d] = sum;
      sum += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      const int32_t d = (int32_t)((src_k[i] >> sh) & 0xff);
      const int64_t o = hist[d]++;
      dst_k[o] = src_k[i];
      dst_i[o] = src_i[i];
    }
    std::swap(src_k, dst_k);
    std::swap(src_i, dst_i);
  }
  if (src_k != keys) {
    std::memcpy(keys, src_k, sizeof(uint64_t) * n);
    std::memcpy(ids, src_i, sizeof(int64_t) * n);
  }
}

// Gather byte spans out of a buffer into one contiguous array (packs
// the FASTQ scanner's per-record sequence spans without per-read
// Python string round trips).
void psi_gather_spans(const uint8_t* buf, const int64_t* starts,
                      const int64_t* lens, int64_t n, uint8_t* out) {
  int64_t o = 0;
  std::vector<int64_t> offs(n + 1);
  for (int64_t i = 0; i < n; ++i) {
    offs[i] = o;
    o += lens[i];
  }
  offs[n] = o;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; ++i)
    std::memcpy(out + offs[i], buf + starts[i], (size_t)lens[i]);
}

// Fused on-path emission: for each emitted search row, walk its gpos
// segment, map each global position to (node, offset) by binary
// search over the path-map starts, and cross-product with the row's
// seed range — writing finished SEED_DTYPE rows (6 x int64) directly.
// Replaces ~12 NumPy passes (repeat/cumsum/searchsorted/gather chain
// in seed_finder._chain_join + the cross-product block) with one
// OpenMP pass. Row order matches the NumPy path exactly:
// (emitted row, occurrence, seed).
//   counts:     int64 [n_search]  occurrence count per search row
//   emit_idx:   int64 [E]         emitted search rows
//   inv:        int64 [n_search]  search row -> chain-uniq (gpos seg)
//   origin:     int64 [n_search]  search row -> index-uniq (seed rng)
//   occ_start:  int64 [n_uniq]    gpos segment start per chain-uniq
//   gpos:       int64 [total_u]   global positions
//   pm_starts/ids/base: int64 [P] path map (starts ascending)
//   uniq_start/uniq_end: int64 [n_iuniq] seed ranges per index-uniq
//   seed_ids:   int64 [V], seedmap int64 [S*2]
//   out_off:    int64 [E+1]       output row offsets (precomputed)
//   out:        int64 [total*6]   SEED_DTYPE rows
void psi_emit_join(const int64_t* counts, const int64_t* emit_idx,
                   int64_t E, const int64_t* inv, const int64_t* origin,
                   const int64_t* occ_start, const int64_t* gpos,
                   const int64_t* pm_starts, const int64_t* pm_ids,
                   const int64_t* pm_base, int64_t P,
                   const int64_t* uniq_start, const int64_t* uniq_end,
                   const int64_t* seed_ids, const int64_t* seedmap,
                   int64_t rec_offset, int64_t k,
                   const int64_t* out_off, int64_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
  for (int64_t e = 0; e < E; ++e) {
    const int64_t row = emit_idx[e];
    const int64_t c = counts[row];
    const int64_t u_occ = inv[row];
    const int64_t u_org = origin[row];
    const int64_t s0 = uniq_start[u_org], s1 = uniq_end[u_org];
    const int64_t g0 = occ_start[u_occ];
    int64_t* o = out + out_off[e] * 6;
    for (int64_t j = 0; j < c; ++j) {
      const int64_t g = gpos[g0 + j];
      // entry = last p with pm_starts[p] <= g  (searchsorted right - 1)
      int64_t lo = 0, hi = P;
      while (lo < hi) {
        const int64_t mid = (lo + hi) / 2;
        if (pm_starts[mid] <= g)
          lo = mid + 1;
        else
          hi = mid;
      }
      const int64_t entry = lo - 1;
      const int64_t node = pm_ids[entry];
      const int64_t noff = g - pm_starts[entry] + pm_base[entry];
      for (int64_t s = s0; s < s1; ++s) {
        const int64_t sid = seed_ids[s];
        o[0] = node;
        o[1] = noff;
        o[2] = rec_offset + seedmap[2 * sid];
        o[3] = seedmap[2 * sid + 1];
        o[4] = k;
        o[5] = c;
        o += 6;
      }
    }
  }
}

}  // extern "C"
