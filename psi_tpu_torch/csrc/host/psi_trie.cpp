// psi_trie — native trie-schedule builder for the batched on-path route.
//
// Builds the per-level child schedule that ops/fm_trie.py ships to the
// device (the batched analogue of the reference's dual-iterator
// prefix-reuse enumeration, ref: include/psi/index_iter.hpp:808-852).
//
// The frontier's pattern order at level j is (char-major,
// parent-pattern-slot minor): r_child = r_parent + (c-1)*4^(j-1) with
// r_parent < 4^(j-1). The builder keeps the frontier ITSELF in pattern
// order (as key ranges), so children are discovered already sorted by
// (parent slot, c) and pattern order needs only a stable 4-bucket
// counting sort per level — no radix passes, no key-order slot maps.
// Random access is confined to two byte planes (change-depth and the
// level's digit plane, ~n bytes each, cache-resident for typical chunk
// sizes); everything else streams.
//
// Exposed via the same C ABI/ctypes convention as psi_host.cpp.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct TrieSched {
  int64_t k = 0;
  int64_t n = 0;
  std::vector<std::vector<int32_t>> parents;  // per level, pattern order
  std::vector<std::vector<int32_t>> chars;    // fed char 1..4
  std::vector<int32_t> leaf_perm;             // key idx -> leaf slot
  std::vector<int64_t> frontier_rows;         // level-p prefix values
  int64_t frontier_level = 0;
};

}  // namespace

extern "C" {

// keys: sorted distinct uint64 packed k-mers (c0 most significant,
// 2-bit codes). frontier_level in (0, k): additionally record each
// level-frontier entry's prefix value at that level (pattern order),
// for host ftab seeding. Returns an opaque handle (psi_trie_free).
void* psi_trie_schedule(const uint64_t* keys, int64_t n, int64_t k,
                        int64_t frontier_level) {
  auto* ts = new TrieSched;
  ts->k = k;
  ts->n = n;
  ts->parents.resize(k);
  ts->chars.resize(k);
  if (n <= 0) return ts;

  // change depth: cd[i] = first digit index where keys[i-1], keys[i]
  // differ (0-based from the most significant digit); cd[0] = 0.
  // Level-j child boundaries within a parent range are exactly the
  // positions with cd[i] <= j (0-based level j feeds digit j).
  std::vector<uint8_t> cd(n);
  cd[0] = 0;
  for (int64_t i = 1; i < n; ++i) {
    const uint64_t x = keys[i - 1] ^ keys[i];
    // first differing digit from the top: digit d lives at bits
    // [2(k-1-d), 2(k-1-d)+1]; x != 0 (keys distinct)
    const int hb = 63 - __builtin_clzll(x);
    cd[i] = (uint8_t)(k - 1 - hb / 2);
  }

  // frontier in pattern order, as key ranges
  std::vector<int32_t> fa = {0}, fb = {(int32_t)n};
  std::vector<int32_t> ca, cb;            // children (key ranges)
  std::vector<int32_t> cpar;               // parent slot per child
  std::vector<uint8_t> cch;                // char-1 (0..3) per child
  std::vector<int32_t> ta, tb;             // counting-sort scratch
  ca.reserve(n);
  cb.reserve(n);
  cpar.reserve(n);
  cch.reserve(n);
  ta.reserve(n);
  tb.reserve(n);

  for (int64_t j = 0; j < k; ++j) {
    const int shift = (int)(2 * (k - 1 - j));

    const int64_t Fp = (int64_t)fa.size();
    ca.clear();
    cb.clear();
    cpar.clear();
    cch.clear();
    int64_t cnt[4] = {0, 0, 0, 0};
    const uint8_t lev = (uint8_t)j;
    const uint8_t* cdp = cd.data();
    for (int64_t p = 0; p < Fp; ++p) {
      int32_t i = fa[p];
      const int32_t e = fb[p];
      while (i < e) {
        // the level digit comes straight off the key (one 8 B read vs
        // a separate n-byte plane pass per level)
        const uint8_t d = (uint8_t)((keys[i] >> shift) & 3);
        const int32_t s = i;
        ++i;
        while (i < e && cdp[i] > lev) ++i;  // run of the (j+1)-prefix
        ca.push_back(s);
        cb.push_back(i);
        cpar.push_back((int32_t)p);
        cch.push_back(d);
        ++cnt[d];
      }
    }
    const int64_t F = (int64_t)ca.size();

    // stable 4-bucket counting sort by char -> pattern order, writing
    // parents/chars for this level directly (no scratch copies)
    int64_t off[4];
    off[0] = 0;
    for (int c = 1; c < 4; ++c) off[c] = off[c - 1] + cnt[c - 1];
    ta.resize(F);
    tb.resize(F);
    auto& par = ts->parents[j];
    auto& ch = ts->chars[j];
    par.resize(F);
    ch.resize(F);
    for (int64_t i = 0; i < F; ++i) {
      const uint8_t d = cch[i];
      const int64_t pos = off[d]++;
      ta[pos] = ca[i];
      tb[pos] = cb[i];
      par[pos] = cpar[i];
      ch[pos] = (int32_t)d + 1;
    }

    fa.swap(ta);
    fb.swap(tb);

    if (j + 1 == frontier_level) {
      ts->frontier_level = frontier_level;
      ts->frontier_rows.resize(F);
      const int fsh = (int)(2 * (k - frontier_level));
      for (int64_t i = 0; i < F; ++i)
        ts->frontier_rows[i] = (int64_t)(keys[fa[i]] >> fsh);
    }
  }

  // leaves are singleton ranges: fa[slot] = key index
  ts->leaf_perm.resize(n);
  for (int64_t s = 0; s < n; ++s) ts->leaf_perm[fa[s]] = (int32_t)s;
  return ts;
}

// sizes: int64[k], frontier size per level 1..k.
void psi_trie_sizes(void* handle, int64_t* sizes) {
  auto* ts = (TrieSched*)handle;
  for (int64_t j = 0; j < ts->k; ++j)
    sizes[j] = (int64_t)ts->parents[j].size();
}

// Export level `level` (1-based), pattern order.
void psi_trie_level(void* handle, int64_t level, int32_t* parents,
                    int32_t* chars) {
  auto* ts = (TrieSched*)handle;
  const auto& par = ts->parents[level - 1];
  const auto& ch = ts->chars[level - 1];
  if (parents) std::memcpy(parents, par.data(), sizeof(int32_t) * par.size());
  if (chars) std::memcpy(chars, ch.data(), sizeof(int32_t) * ch.size());
}

// leaf permutation: perm[key idx] = leaf slot. perm: int32[n].
void psi_trie_leaf_perm(void* handle, int32_t* perm) {
  auto* ts = (TrieSched*)handle;
  std::memcpy(perm, ts->leaf_perm.data(),
              sizeof(int32_t) * ts->leaf_perm.size());
}

// frontier prefix values at the build-time frontier_level (pattern
// order); returns the count (0 if none was requested).
int64_t psi_trie_frontier(void* handle, int64_t* rows) {
  auto* ts = (TrieSched*)handle;
  if (rows && !ts->frontier_rows.empty())
    std::memcpy(rows, ts->frontier_rows.data(),
                sizeof(int64_t) * ts->frontier_rows.size());
  return (int64_t)ts->frontier_rows.size();
}

void psi_trie_free(void* handle) { delete (TrieSched*)handle; }

}  // extern "C"
