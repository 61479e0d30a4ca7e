// psi_host — native host-side kernels for the psi_tpu engine.
//
// Exposed via a plain C ABI consumed through ctypes (no pybind11):
//   * psi_sais:        linear-time suffix array (SA-IS) over byte text.
//     Replaces the O(n log^2 n) NumPy prefix-doubling build for
//     chromosome-scale path texts (the reference leans on sdsl's
//     disk-based construction for the same reason; ref:
//     include/psi/fmindex.hpp:214-237).
//   * psi_fastq_scan:  single-pass FASTQ/FASTA record boundary scanner
//     feeding packed read batches (kseq-style streaming frontend; ref:
//     include/psi/sequence.hpp:1608-1624).
//   * psi_bwt_from_sa: BWT symbol extraction.
//
// Build: psi_tpu_torch/_build.py compiles csrc/host/*.cpp at first use
// into build/psi_tpu_torch/libpsi_host.so.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// SA-IS (Nong, Zhang & Chan): induced sorting of LMS substrings, recursion
// on the reduced problem, final induced sort. Generic over index type.
// ---------------------------------------------------------------------------

template <typename T>
static void get_counts(const T* s, int64_t n, int64_t K, int64_t* cnt) {
  std::memset(cnt, 0, sizeof(int64_t) * K);
  for (int64_t i = 0; i < n; ++i) ++cnt[s[i]];
}

static void get_buckets(const int64_t* cnt, int64_t K, int64_t* bkt,
                        bool end) {
  int64_t sum = 0;
  for (int64_t i = 0; i < K; ++i) {
    sum += cnt[i];
    bkt[i] = end ? sum : sum - cnt[i];
  }
}

template <typename T>
static void induce_sa(const T* s, int64_t n, int64_t K, const uint8_t* t,
                      int64_t* sa, int64_t* cnt, int64_t* bkt) {
  // L-type induction (left to right)
  get_buckets(cnt, K, bkt, false);
  if (n > 0) {
    int64_t j = n - 1;
    if (!t[j]) sa[bkt[s[j]]++] = j;
  }
  for (int64_t i = 0; i < n; ++i) {
    int64_t j = sa[i] - 1;
    if (sa[i] > 0 && !t[j]) sa[bkt[s[j]]++] = j;
  }
  // S-type induction (right to left)
  get_buckets(cnt, K, bkt, true);
  for (int64_t i = n - 1; i >= 0; --i) {
    int64_t j = sa[i] - 1;
    if (sa[i] > 0 && t[j]) sa[--bkt[s[j]]] = j;
  }
}

template <typename T>
static void sais_impl(const T* s, int64_t n, int64_t K, int64_t* sa) {
  if (n == 0) return;
  if (n == 1) {
    sa[0] = 0;
    return;
  }

  std::vector<uint8_t> t(n);  // 1 = S-type, 0 = L-type
  t[n - 1] = 1;
  for (int64_t i = n - 2; i >= 0; --i)
    t[i] = (s[i] < s[i + 1] || (s[i] == s[i + 1] && t[i + 1])) ? 1 : 0;

  std::vector<int64_t> cnt(K), bkt(K);
  get_counts(s, n, K, cnt.data());

  // step 1: place LMS suffixes, induce-sort LMS substrings
  for (int64_t i = 0; i < n; ++i) sa[i] = -1;
  get_buckets(cnt.data(), K, bkt.data(), true);
  for (int64_t i = 1; i < n; ++i)
    if (t[i] && !t[i - 1]) sa[--bkt[s[i]]] = i;
  induce_sa(s, n, K, t.data(), sa, cnt.data(), bkt.data());

  // compact sorted LMS substring starts into sa[0..n1)
  int64_t n1 = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t p = sa[i];
    if (p > 0 && t[p] && !t[p - 1]) sa[n1++] = p;
  }

  // name LMS substrings
  for (int64_t i = n1; i < n; ++i) sa[i] = -1;
  int64_t name = 0, prev = -1;
  for (int64_t i = 0; i < n1; ++i) {
    int64_t pos = sa[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (int64_t d = 0;; ++d) {
        if (pos + d >= n || prev + d >= n) { diff = (pos + d >= n) != (prev + d >= n); break; }
        bool lms_p = (pos + d > 0) && t[pos + d] && !t[pos + d - 1];
        bool lms_q = (prev + d > 0) && t[prev + d] && !t[prev + d - 1];
        if (d > 0 && lms_p && lms_q) break;  // both ended, equal
        if (s[pos + d] != s[prev + d] || lms_p != lms_q) { diff = true; break; }
      }
    }
    if (diff) { ++name; prev = pos; }
    sa[n1 + pos / 2] = name - 1;
  }
  // compact names
  int64_t* s1 = sa + n - n1;
  for (int64_t i = n - 1, j = n - 1; i >= n1; --i)
    if (sa[i] >= 0) sa[j--] = sa[i];

  // step 2: recurse if names are not unique
  if (name < n1) {
    sais_impl(s1, n1, name, sa);
  } else {
    for (int64_t i = 0; i < n1; ++i) sa[s1[i]] = i;
  }

  // step 3: induce the full SA from the sorted LMS suffixes
  // collect LMS positions in text order into s1
  for (int64_t i = 1, j = 0; i < n; ++i)
    if (t[i] && !t[i - 1]) s1[j++] = i;
  for (int64_t i = 0; i < n1; ++i) sa[i] = s1[sa[i]];
  for (int64_t i = n1; i < n; ++i) sa[i] = -1;
  get_buckets(cnt.data(), K, bkt.data(), true);
  for (int64_t i = n1 - 1; i >= 0; --i) {
    int64_t j = sa[i];
    sa[i] = -1;
    sa[--bkt[s[j]]] = j;
  }
  induce_sa(s, n, K, t.data(), sa, cnt.data(), bkt.data());
}

}  // namespace

extern "C" {

// Suffix array of a byte string (alphabet size K <= 256). sa: int64[n].
// SA-IS requires a unique smallest terminator: the text is shifted +1
// into an int32 workspace and a 0 sentinel appended; the sentinel suffix
// (always rank 0) is dropped from the result.
void psi_sais(const uint8_t* text, int64_t n, int64_t* sa) {
  if (n <= 0) return;
  std::vector<int32_t> s(n + 1);
  for (int64_t i = 0; i < n; ++i) s[i] = (int32_t)text[i] + 1;
  s[n] = 0;
  std::vector<int64_t> sa_tmp(n + 1);
  sais_impl<int32_t>(s.data(), n + 1, 257, sa_tmp.data());
  // sa_tmp[0] is the sentinel suffix (position n)
  std::memcpy(sa, sa_tmp.data() + 1, sizeof(int64_t) * n);
}

// Parallel sharded suffix array for sentinel-separated string sets.
//
// Shards must end at a sentinel (code 0), so every suffix terminates
// inside its own shard and shard SAs build independently (OpenMP).
// Tie-order among suffixes equal up to their first sentinel is
// semantically irrelevant for the FM index (patterns never contain the
// sentinel; see psi_tpu/fmindex.py), so the k-way merge uses the
// stop-at-first-sentinel comparator with shard-index tie-break — a
// valid total refinement mixed with the within-shard SA-IS order.
// Memory peak is bounded by the LARGEST shard's SA-IS workspace plus
// the global int64 SA (vs whole-text workspace for the single build) —
// the genome-scale construction path (the reference leans on sdsl's
// external-memory build for the same reason, ref:
// include/psi/fmindex.hpp:214-228).
void psi_sais(const uint8_t* text, int64_t n, int64_t* sa);

void psi_sais_sharded(const uint8_t* text, int64_t n,
                      const int64_t* shard_off, int64_t nshards,
                      int64_t* sa) {
  // per-shard SAs written directly into the global buffer, offset later
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t s = 0; s < nshards; ++s) {
    const int64_t a = shard_off[s], b = shard_off[s + 1];
    psi_sais(text + a, b - a, sa + a);
    for (int64_t i = a; i < b; ++i) sa[i] += a;
  }
  if (nshards <= 1) return;

  // k-way HEAP merge with the sentinel-terminated comparator: each
  // output element costs O(log nshards) suffix comparisons (the round-2
  // linear scan compared every shard head per element — O(n * nshards)
  // comparisons, each walking shared prefixes)
  std::vector<int64_t> head(nshards);
  for (int64_t s = 0; s < nshards; ++s) head[s] = shard_off[s];
  std::vector<int64_t> out(n);
  // returns true if suffix at position p (shard sp) < suffix at q (sq)
  auto less = [&](int64_t p, int64_t sp, int64_t q, int64_t sq) {
    for (;;) {
      const uint8_t cp = text[p], cq = text[q];
      if (cp != cq) return cp < cq;
      if (cp == 0) return sp < sq;  // simultaneous sentinel: shard order
      ++p;
      ++q;
    }
  };
  // max-heap with inverted comparator = min-heap over shard heads
  auto heap_cmp = [&](int64_t a, int64_t b) {
    return less(sa[head[b]], b, sa[head[a]], a);
  };
  std::vector<int64_t> heap;
  heap.reserve(nshards);
  for (int64_t s = 0; s < nshards; ++s)
    if (head[s] < shard_off[s + 1]) heap.push_back(s);
  std::make_heap(heap.begin(), heap.end(), heap_cmp);
  for (int64_t o = 0; o < n; ++o) {
    std::pop_heap(heap.begin(), heap.end(), heap_cmp);
    const int64_t s = heap.back();
    out[o] = sa[head[s]++];
    if (head[s] < shard_off[s + 1]) {
      std::push_heap(heap.begin(), heap.end(), heap_cmp);
    } else {
      heap.pop_back();
    }
  }
  std::memcpy(sa, out.data(), sizeof(int64_t) * n);
}

// ---------------------------------------------------------------------------
// Disk-spilled sharded SA merge — the bounded-RAM genome-scale build
// (the reference leans on sdsl's external-memory construction for the
// same reason, ref: include/psi/fmindex.hpp:214-228).
//
// Per-shard SAs live in ONE shards file, shard s's entries at byte
// offset 8*shard_off[s] (absolute text positions). The merge consumes
// every shard strictly sequentially through a small pread buffer and
// streams the merged SA to out_path with buffered writes, so resident
// memory is text + bwt + nshards*buf — independent of n. bwt[i] is
// filled on the fly (bwt = text[(sa[i]+n-1) % n]), saving a second
// pass over the on-disk SA. Returns 0 on success, <0 on IO error.
// ---------------------------------------------------------------------------

int64_t psi_sais_merge_disk(const uint8_t* text, int64_t n,
                            const int64_t* shard_off, int64_t nshards,
                            const char* shards_path, const char* out_path,
                            uint8_t* bwt, int64_t bufelems) {
  if (bufelems < 1024) bufelems = 1024;
  const int fd = open(shards_path, O_RDONLY);
  if (fd < 0) return -1;
  FILE* fout = fopen(out_path, "wb");
  if (!fout) {
    close(fd);
    return -2;
  }
  struct Stream {
    int64_t next, end;  // absolute element offsets in the shards file
    int64_t pos, len;   // window into buf
    std::vector<int64_t> buf;
  };
  std::vector<Stream> st(nshards);
  auto refill = [&](int64_t s) -> bool {
    Stream& t = st[s];
    const int64_t want = std::min(bufelems, t.end - t.next);
    if (want <= 0) return false;
    const int64_t bytes = want * (int64_t)sizeof(int64_t);
    if (t.buf.empty()) t.buf.resize(bufelems);
    int64_t got = 0;
    while (got < bytes) {
      const ssize_t r = pread(fd, (char*)t.buf.data() + got, bytes - got,
                              t.next * (int64_t)sizeof(int64_t) + got);
      if (r <= 0) return false;
      got += r;
    }
    t.pos = 0;
    t.len = want;
    t.next += want;
    return true;
  };
  for (int64_t s = 0; s < nshards; ++s) {
    st[s].next = shard_off[s];
    st[s].end = shard_off[s + 1];
    st[s].pos = st[s].len = 0;
  }
  auto cur = [&](int64_t s) { return st[s].buf[st[s].pos]; };
  auto less = [&](int64_t p, int64_t sp, int64_t q, int64_t sq) {
    for (;;) {
      const uint8_t cp = text[p], cq = text[q];
      if (cp != cq) return cp < cq;
      if (cp == 0) return sp < sq;
      ++p;
      ++q;
    }
  };
  auto heap_cmp = [&](int64_t a, int64_t b) {
    return less(cur(b), b, cur(a), a);
  };
  std::vector<int64_t> heap;
  for (int64_t s = 0; s < nshards; ++s)
    if (refill(s)) heap.push_back(s);
  std::make_heap(heap.begin(), heap.end(), heap_cmp);
  std::vector<int64_t> obuf(bufelems);
  int64_t opos = 0, written = 0;
  auto flush = [&]() -> bool {
    if (opos &&
        fwrite(obuf.data(), sizeof(int64_t), opos, fout) != (size_t)opos)
      return false;
    opos = 0;
    return true;
  };
  while (!heap.empty()) {
    std::pop_heap(heap.begin(), heap.end(), heap_cmp);
    const int64_t s = heap.back();
    const int64_t v = cur(s);
    obuf[opos++] = v;
    bwt[written++] = text[v == 0 ? n - 1 : v - 1];
    if (opos == bufelems && !flush()) {
      fclose(fout);
      close(fd);
      return -3;
    }
    Stream& t = st[s];
    ++t.pos;
    if (t.pos == t.len && !refill(s)) {
      heap.pop_back();
    } else {
      std::push_heap(heap.begin(), heap.end(), heap_cmp);
    }
  }
  const bool ok = flush();
  fclose(fout);
  close(fd);
  if (!ok) return -3;
  return written == n ? 0 : -4;
}

// Occ checkpoints in one pass: occ[(b+1)*sigma + c] = #(bwt[0:min((b+1)*B, n)] == c)
// for b in [0, nblocks); occ row 0 is zeros. occ: int64[(nblocks+1)*sigma].
void psi_occ_checkpoints(const uint8_t* bwt, int64_t n, int64_t block,
                         int64_t sigma, int64_t* occ) {
  int64_t nblocks = (n + block - 1) / block;
  std::vector<int64_t> counts(sigma, 0);
  for (int64_t c = 0; c < sigma; ++c) occ[c] = 0;
  for (int64_t b = 0; b < nblocks; ++b) {
    int64_t end = std::min((b + 1) * block, n);
    for (int64_t i = b * block; i < end; ++i) ++counts[bwt[i]];
    std::copy(counts.begin(), counts.end(), occ + (b + 1) * sigma);
  }
}

// BWT extraction: bwt[i] = text[(sa[i] + n - 1) % n].
void psi_bwt_from_sa(const uint8_t* text, const int64_t* sa, int64_t n,
                     uint8_t* bwt) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t p = sa[i];
    bwt[i] = text[p == 0 ? n - 1 : p - 1];
  }
}

// Single-pass FASTQ record scanner over an in-memory buffer.
// Fills seq_starts/seq_lens (and name_starts/name_lens) for up to
// max_records records; returns the number found; *consumed is set to the
// byte offset just past the last complete record.
int64_t psi_fastq_scan(const uint8_t* buf, int64_t len, int64_t max_records,
                       int64_t* name_starts, int64_t* name_lens,
                       int64_t* seq_starts, int64_t* seq_lens,
                       int64_t* consumed) {
  int64_t i = 0, nrec = 0;
  *consumed = 0;
  while (i < len && nrec < max_records) {
    if (buf[i] != '@') break;
    int64_t name_beg = i + 1;
    while (i < len && buf[i] != '\n') ++i;
    if (i >= len) break;
    int64_t name_end = name_beg;
    while (name_end < (int64_t)i && buf[name_end] != ' ' &&
           buf[name_end] != '\t')
      ++name_end;
    int64_t seq_beg = ++i;
    while (i < len && buf[i] != '\n') ++i;
    if (i >= len) break;
    int64_t seq_end = i;
    ++i;  // past newline
    if (i >= len || buf[i] != '+') break;
    while (i < len && buf[i] != '\n') ++i;  // '+' line
    if (i >= len) break;
    ++i;
    int64_t qlen = seq_end - seq_beg;
    if (i + qlen > len) break;
    i += qlen;
    if (i < len && buf[i] == '\n') ++i;
    name_starts[nrec] = name_beg;
    name_lens[nrec] = name_end - name_beg;
    seq_starts[nrec] = seq_beg;
    seq_lens[nrec] = qlen;
    ++nrec;
    *consumed = i;
  }
  return nrec;
}

}  // extern "C"
