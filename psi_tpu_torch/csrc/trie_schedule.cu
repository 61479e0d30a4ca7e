// The trie plan's child schedule, built on the card from the sorted
// distinct keys.
//
// Replaces no TPU kernel: psi_tpu builds the schedule on the host
// (native/psi_trie.cpp; the port's copy is csrc/host/psi_trie.cpp, still
// the route on every other device) and ships the padded plan to the
// device. Here the card builds the same plan from the keys alone, bit for
// bit: `parents` / `chars` [levels, npad] of levels p+1..k, the
// ftab-seeded frontier `lo0` / `hi0` [npad] of level p, and the last
// level's slot of every key (`leaf`, psi_tpu's leaf_perm). Levels pad
// with their last entry, as ops/fm_trie.py's host route pads them.
//
// The plan's order (psi_trie.cpp): level j's frontier holds the distinct
// j-digit key prefixes in pattern order, the order of the digit-reversed
// prefix. A child is (parent slot s, fed char c), and children sort by
// (c, s); a parent has at most one child of each char. So with a bitmap
// of 4 x F_{j-1} bits, bit c * F_{j-1} + s set for every child, a child's
// slot is the number of set bits below its own: one prefix popcount puts
// every child in place at once, where the host walks the trie level by
// level. The level-p frontier is a bitmap of the 4^p digit-reversed
// prefixes, ranked the same way, so levels 1..p are never built.
//
// Keys are read in key order, where a level's prefixes are runs: key i
// starts a run of level j iff cd[i] < j, cd[i] the first digit in which
// keys i-1 and i differ (cd[0] = -1). A run's rank in key order is the
// number of run starts up to it: per-block counts of the starts of every
// level, one scan of those counts, and a ballot within the block give
// every key its run's rank at every level. Each level keeps its runs'
// slots in key-rank order (`slots`), which the next level reads to find
// a child's parent slot.
//
// What bounds it on an H100: launches, not bytes. At 2^19 keys and 9
// levels the plan written is 38 MB and the keys read 4 MB (~12.5 us at
// 3.35 TB/s); each level is five short steps in stream order (clear the
// bitmap, mark the children, scan the bitmap's words, scan the scan's
// block sums, place the children), each a grid-wide dependency on the
// last, so one level is five launches. The launches come from this file's
// host function in one ctypes call: the enqueue costs no Python per
// launch. The keys are read by the mark and the place steps of every
// level (a block's ranks are recomputed, not stored); the bitmap
// (4 x 2^19 bits, 256 KB) and the slot maps stay in L2.
//
// Nothing is checked on the device: keys must be sorted, distinct and
// below 4^k (k <= 32), n < 2^29 (a bit index is an int), ftab must hold
// 4^p rows of (lo, hi) int32; the wrapper (ops/fm_trie.py) checks types,
// shapes and devices.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // keys a block, one a thread
constexpr int kWordsPerThread = 8;
constexpr int kScanWords = kThreads * kWordsPerThread;  // words a scan block
constexpr int kScanThreads = 1024;                     // the rows' scan
constexpr int kMaxDigits = 32;

__host__ __device__ constexpr long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

// Words of a bitmap of `bits` bits, padded to whole scan blocks.
__host__ __device__ constexpr long long bitmap_words(long long bits) {
  return round_up(bits > 0 ? (bits + 31) / 32 : 1, kScanWords);
}

__device__ __forceinline__ int digit(uint64_t key, int k, int t) {
  return static_cast<int>((key >> (2 * (k - 1 - t))) & 3);
}

// Inclusive scan of v over the block (kBlock threads, every one calling);
// *total gets the block's sum.
template <int kBlock>
__device__ __forceinline__ int block_scan(int v, int* total) {
  __shared__ int warp_sums[kBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kBlock / 32 ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kBlock / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  const int out = v + (warp ? warp_sums[warp - 1] : 0);
  *total = warp_sums[kBlock / 32 - 1];
  __syncthreads();  // warp_sums is free for the next call
  return out;
}

// The block's inclusive counts of flags a and b up to this thread.
__device__ __forceinline__ void block_rank2(bool a, bool b, int* ra,
                                            int* rb) {
  __shared__ int wa[kThreads / 32], wb[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ba = __ballot_sync(0xffffffffu, a);
  const unsigned bb = __ballot_sync(0xffffffffu, b);
  if (lane == 0) {
    wa[warp] = __popc(ba);
    wb[warp] = __popc(bb);
  }
  __syncthreads();
  int sa = 0, sb = 0;
  for (int w = 0; w < warp; ++w) {
    sa += wa[w];
    sb += wb[w];
  }
  const unsigned upto = 0xffffffffu >> (31 - lane);
  *ra = sa + __popc(ba & upto);
  *rb = sb + __popc(bb & upto);
}

// cd[i], and cnt[j * nb + block] = the block's run starts of level j
// (keys with cd < j) for j = 0..k. With p == 0 the root is level 0's one
// run: slot 0, F[0] = 1.
__global__ void change_depth_kernel(const uint64_t* __restrict__ keys, int n,
                                    int k, int p, int8_t* __restrict__ cd,
                                    int* __restrict__ cnt, int nb,
                                    int* __restrict__ slots0,
                                    int* __restrict__ F) {
  __shared__ int counts[kMaxDigits + 1];
  if (threadIdx.x <= k) counts[threadIdx.x] = 0;
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int d = kMaxDigits;  // past the end: a start of no level
  if (i < n) {
    d = -1;
    if (i > 0) {
      const uint64_t x = keys[i - 1] ^ keys[i];
      d = k - 1 - (63 - __clzll(static_cast<long long>(x))) / 2;
    }
    cd[i] = static_cast<int8_t>(d);
  }
  const int lane = threadIdx.x & 31;
  for (int j = 0; j <= k; ++j) {
    const unsigned b = __ballot_sync(0xffffffffu, d < j);
    if (lane == 0 && b) atomicAdd(&counts[j], __popc(b));
  }
  __syncthreads();
  if (threadIdx.x <= k) cnt[threadIdx.x * nb + blockIdx.x] = counts[threadIdx.x];
  if (p == 0 && i == 0) {
    slots0[0] = 0;
    F[0] = 1;
  }
}

// Exclusive scan in place of each row of `rows` (one block a row, row
// `first + blockIdx.x`, `len` entries); with `totals`, the row's sum goes
// to totals[total_at].
__global__ void scan_rows_kernel(int* __restrict__ rows, int len, int first,
                                 int* __restrict__ totals, int total_at) {
  int* row = rows + static_cast<long long>(first + blockIdx.x) * len;
  int carry = 0;
  for (int b0 = 0; b0 < len; b0 += kScanThreads) {
    const int b = b0 + threadIdx.x;
    const int v = b < len ? row[b] : 0;
    int total;
    const int incl = block_scan<kScanThreads>(v, &total);
    if (b < len) row[b] = carry + incl - v;
    carry += total;
  }
  if (totals != nullptr && threadIdx.x == 0) totals[total_at] = carry;
}

// Per-word prefix popcounts of the bitmap within its scan block (wpre),
// and each scan block's count (bsum). `words` is a multiple of kScanWords.
__global__ void word_scan_kernel(const uint32_t* __restrict__ bitmap,
                                 int* __restrict__ wpre,
                                 int* __restrict__ bsum) {
  const long long base =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) *
      kWordsPerThread;
  const uint4* src = reinterpret_cast<const uint4*>(bitmap + base);
  int c[kWordsPerThread];
  int sum = 0;
  for (int t = 0; t < kWordsPerThread / 4; ++t) {
    const uint4 w = src[t];
    c[4 * t] = __popc(w.x);
    c[4 * t + 1] = __popc(w.y);
    c[4 * t + 2] = __popc(w.z);
    c[4 * t + 3] = __popc(w.w);
  }
  for (int t = 0; t < kWordsPerThread; ++t) sum += c[t];
  int total;
  int run = block_scan<kThreads>(sum, &total) - sum;
  for (int t = 0; t < kWordsPerThread; ++t) {
    wpre[base + t] = run;
    run += c[t];
  }
  if (threadIdx.x == 0) bsum[blockIdx.x] = total;
}

// Set bits below `bit` (bsum already scanned).
__device__ __forceinline__ int rank_of_bit(const uint32_t* bitmap,
                                           const int* wpre, const int* bsum,
                                           int bit) {
  const int w = bit >> 5;
  return bsum[w / kScanWords] + wpre[w] +
         __popc(bitmap[w] & ((1u << (bit & 31)) - 1u));
}

// A key of the frontier level p: its p-prefix (the ftab row) and that
// prefix digit-reversed (its pattern order).
__device__ __forceinline__ void frontier_prefix(uint64_t key, int k, int p,
                                                int* row, int* r) {
  unsigned v = static_cast<unsigned>(
      (key >> (2 * (k - p))) & ((1ull << (2 * p)) - 1));
  *row = static_cast<int>(v);
  unsigned rev = 0;
  for (int t = 0; t < p; ++t) {
    rev = (rev << 2) | (v & 3u);
    v >>= 2;
  }
  *r = static_cast<int>(rev);
}

// Level p's runs: mark their digit-reversed prefixes (place == false), or
// rank them into their slots, with the ftab's ranges at each slot.
__global__ void frontier_kernel(const uint64_t* __restrict__ keys,
                                const int8_t* __restrict__ cd, int n, int k,
                                int p, const int* __restrict__ off_p,
                                uint32_t* __restrict__ bitmap, bool place,
                                const int* __restrict__ wpre,
                                const int* __restrict__ bsum,
                                const int32_t* __restrict__ ftab,
                                int* __restrict__ slots,
                                int32_t* __restrict__ lo0,
                                int32_t* __restrict__ hi0) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool start = i < n && cd[i] < p;
  int r, unused;
  if (place) block_rank2(start, false, &r, &unused);
  if (!start) return;
  int row, rev;
  frontier_prefix(keys[i], k, p, &row, &rev);
  if (!place) {
    atomicOr(bitmap + (rev >> 5), 1u << (rev & 31));
    return;
  }
  const int slot = rank_of_bit(bitmap, wpre, bsum, rev);
  slots[off_p[blockIdx.x] + r - 1] = slot;
  lo0[slot] = ftab[2 * row];
  hi0[slot] = ftab[2 * row + 1];
}

// Level j's children (level j-1 their parents): mark each child's bit
// (place == false), or put it in its slot: parents/chars of its row, and
// its slot in key-rank order (slots).
__global__ void level_kernel(const uint64_t* __restrict__ keys,
                             const int8_t* __restrict__ cd, int n, int k,
                             int j, const int* __restrict__ off_j,
                             const int* __restrict__ off_prev,
                             const int* __restrict__ slots_prev,
                             const int* __restrict__ F,
                             uint32_t* __restrict__ bitmap, bool place,
                             const int* __restrict__ wpre,
                             const int* __restrict__ bsum,
                             int32_t* __restrict__ parents,
                             int32_t* __restrict__ chars,
                             int* __restrict__ slots) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int d = i < n ? cd[i] : kMaxDigits;
  const bool start = d < j;
  int r, rp;
  block_rank2(start, d < j - 1, &r, &rp);
  if (!start) return;
  const int s = slots_prev[off_prev[blockIdx.x] + rp - 1];
  const int c = digit(keys[i], k, j - 1);
  const int bit = c * F[j - 1] + s;
  if (!place) {
    atomicOr(bitmap + (bit >> 5), 1u << (bit & 31));
    return;
  }
  const int pos = rank_of_bit(bitmap, wpre, bsum, bit);
  parents[pos] = s;
  chars[pos] = c + 1;
  slots[off_j[blockIdx.x] + r - 1] = pos;
}

// Every row's tail [F, npad) repeats its last entry: rows 0..levels-1 of
// parents/chars (level first + 1 + row), and lo0/hi0 (level first) as
// row `levels` where they exist.
__global__ void pad_kernel(int32_t* __restrict__ parents,
                           int32_t* __restrict__ chars, int levels,
                           int npad, int32_t* __restrict__ lo0,
                           int32_t* __restrict__ hi0,
                           const int* __restrict__ F, int first) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;
  if (x >= npad) return;
  if (row < levels) {
    const int f = F[first + 1 + row];
    if (x < f) return;
    const long long at = static_cast<long long>(row) * npad;
    parents[at + x] = parents[at + f - 1];
    chars[at + x] = chars[at + f - 1];
  } else {
    const int f = F[first];
    if (x < f) return;
    lo0[x] = lo0[f - 1];
    hi0[x] = hi0[f - 1];
  }
}

struct Scratch {
  int8_t* cd;
  int* cnt;
  int* slots[2];
  uint32_t* bitmap;
  int* wpre;
  int* bsum;
  int* F;
  long long words;  // bitmap words, a multiple of kScanWords
  long long bytes;
};

Scratch layout(char* base, long long n, int k, int p) {
  const long long nb = (n + kThreads - 1) / kThreads;
  long long words = bitmap_words(4 * n);
  if (p > 0 && bitmap_words(1ll << (2 * p)) > words)
    words = bitmap_words(1ll << (2 * p));
  Scratch s{};
  long long at = 0;
  auto take = [&](long long bytes) {
    char* ptr = base ? base + at : nullptr;
    at += round_up(bytes, 256);
    return ptr;
  };
  s.cd = reinterpret_cast<int8_t*>(take(n));
  s.cnt = reinterpret_cast<int*>(take(4 * (k + 1) * nb));
  s.slots[0] = reinterpret_cast<int*>(take(4 * n));
  s.slots[1] = reinterpret_cast<int*>(take(4 * n));
  s.bitmap = reinterpret_cast<uint32_t*>(take(4 * words));
  s.wpre = reinterpret_cast<int*>(take(4 * words));
  s.bsum = reinterpret_cast<int*>(take(4 * (words / kScanWords)));
  s.F = reinterpret_cast<int*>(take(4 * (k + 1)));
  s.words = words;
  s.bytes = at;
  return s;
}

}  // namespace

extern "C" long long psi_trie_schedule_scratch_bytes(long long n, int k,
                                                     int p) {
  return layout(nullptr, n, k, p).bytes;
}

// keys: n sorted distinct k-digit keys (uint64); p: the ftab depth, 0 for
// none (then the plan starts at the root), else 0 < p < k with ftab
// int32 [4^p, 2]. Writes parents/chars int32 [k - p, npad], lo0/hi0
// int32 [npad] where p > 0, and leaf int32 [n] (key i's leaf slot).
// scratch: psi_trie_schedule_scratch_bytes(n, k, p) bytes, 256-aligned.
extern "C" int psi_trie_schedule(const void* keys_v, int n, int k, int p,
                                 const void* ftab, void* parents_v,
                                 void* chars_v, int npad, void* lo0,
                                 void* hi0, void* leaf, void* scratch,
                                 void* stream_v) {
  const auto keys = static_cast<const uint64_t*>(keys_v);
  const auto stream = static_cast<cudaStream_t>(stream_v);
  auto parents = static_cast<int32_t*>(parents_v);
  auto chars = static_cast<int32_t*>(chars_v);
  Scratch s = layout(static_cast<char*>(scratch), n, k, p);
  const int nb = (n + kThreads - 1) / kThreads;
  const int levels = k - p;
  cudaError_t err;
#define PSI_CHECK()                         \
  if ((err = cudaGetLastError()) != cudaSuccess) \
  return static_cast<int>(err)

  change_depth_kernel<<<nb, kThreads, 0, stream>>>(
      keys, n, k, p, s.cd, s.cnt, nb, s.slots[0], s.F);
  PSI_CHECK();
  scan_rows_kernel<<<k - p + 1, kScanThreads, 0, stream>>>(s.cnt, nb, p,
                                                          nullptr, 0);
  PSI_CHECK();

  // one bitmap pass: clear, mark, prefix popcounts; F[level] = its count
  auto bitmap_pass = [&](long long words, auto&& mark, int level) {
    cudaError_t e = cudaMemsetAsync(s.bitmap, 0, 4 * words, stream);
    if (e != cudaSuccess) return e;
    mark();
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    const int blocks = static_cast<int>(words / kScanWords);
    word_scan_kernel<<<blocks, kThreads, 0, stream>>>(s.bitmap, s.wpre,
                                                      s.bsum);
    scan_rows_kernel<<<1, kScanThreads, 0, stream>>>(s.bsum, blocks, 0, s.F,
                                                     level);
    return cudaGetLastError();
  };

  if (p > 0) {
    err = bitmap_pass(bitmap_words(1ll << (2 * p)), [&] {
      frontier_kernel<<<nb, kThreads, 0, stream>>>(
          keys, s.cd, n, k, p, s.cnt + static_cast<long long>(p) * nb,
          s.bitmap, false, s.wpre, s.bsum, static_cast<const int32_t*>(ftab),
          s.slots[0], static_cast<int32_t*>(lo0), static_cast<int32_t*>(hi0));
    }, p);
    if (err != cudaSuccess) return static_cast<int>(err);
    frontier_kernel<<<nb, kThreads, 0, stream>>>(
        keys, s.cd, n, k, p, s.cnt + static_cast<long long>(p) * nb, s.bitmap,
        true, s.wpre, s.bsum, static_cast<const int32_t*>(ftab), s.slots[0],
        static_cast<int32_t*>(lo0), static_cast<int32_t*>(hi0));
    PSI_CHECK();
  }
  const long long level_words = bitmap_words(4ll * n);
  for (int j = p + 1; j <= k; ++j) {
    const int row = j - p - 1;
    const int* prev = s.slots[row & 1];
    int* cur = j == k ? static_cast<int*>(leaf) : s.slots[(row + 1) & 1];
    const int* off_j = s.cnt + static_cast<long long>(j) * nb;
    const int* off_prev = s.cnt + static_cast<long long>(j - 1) * nb;
    int32_t* prow = parents + static_cast<long long>(row) * npad;
    int32_t* crow = chars + static_cast<long long>(row) * npad;
    err = bitmap_pass(level_words, [&] {
      level_kernel<<<nb, kThreads, 0, stream>>>(
          keys, s.cd, n, k, j, off_j, off_prev, prev, s.F, s.bitmap, false,
          s.wpre, s.bsum, prow, crow, cur);
    }, j);
    if (err != cudaSuccess) return static_cast<int>(err);
    level_kernel<<<nb, kThreads, 0, stream>>>(
        keys, s.cd, n, k, j, off_j, off_prev, prev, s.F, s.bitmap, true,
        s.wpre, s.bsum, prow, crow, cur);
    PSI_CHECK();
  }
  const dim3 grid((npad + kThreads - 1) / kThreads, levels + (p > 0));
  pad_kernel<<<grid, kThreads, 0, stream>>>(
      parents, chars, levels, npad, static_cast<int32_t*>(lo0),
      static_cast<int32_t*>(hi0), s.F, p);
  PSI_CHECK();
#undef PSI_CHECK
  return 0;
}
