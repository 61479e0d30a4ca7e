"""Time compact and the occ row gather over their candidate designs, and
the card's random-access rates, on the card at chip_smoke.py's shapes.

    python3 -m psi_tpu_torch.tools.gather_sweep      # from the repo root

Three parts, on the bacterial cell (tools/bacterial.py), every variant
held bit-equal to its plain PyTorch version except the floors:

  rates    random reads of G x 16 aligned bytes (G = 1: 16 bytes of a
           sector; 2: a 32-byte sector; 4: 64 bytes; 8: a 128-byte line)
           at indices from an integer hash, G lanes a piece and four
           pieces a lane group in flight, from the W=4 and W=8 occ tables
           (160 and 320 MB: the 50 MB L2 keeps up to a third of them
           between launches, as it does for the row gather), from a 4 GiB
           buffer (HBM alone) and from the first 16 MB of the W=4 table
           (in L2 after the warm-up launch); pieces and bytes per second.
  compact  chunk 1's 9 levels: r4lo and r4hi from rank4_pair_stream on
           each level's frontier. Cold: the 9 levels cycled (144 MB of
           rank tables, so they come from HBM), as chip_smoke.py times it.
           Warm: rank4_pair_stream for the level launched just before,
           CUDA events around compact alone (timing.bracketed_ms). Route:
           the two-pass route itself, rank4_pair then compact per level
           from the last level's frontier, beside rank4_pair alone. Every
           variant writes fresh outputs, as the wrapper and the route do
           (the original kernel also into two reused buffers, which costs
           it about a microsecond cold). Variants: the original kernel
           ("x1": one child a thread, C[c] by __ldg); K children a thread
           with K x 4-byte vector loads of parent and char and stores of lo'
           and hi' (every gather of the thread issued before any store);
           C[0..4] in shared memory or by __ldg; scalar loads and stores;
           K children a thread strided by the block's width, so that each
           warp instruction covers 32 neighbouring children;
           a floor that streams parent and char in and lo' and hi' out
           without touching r4; and the port's compact through its
           wrapper.
  rows     the gather route's positions (lo and hi of each of the 9 LF
           steps of chunk 1's keys over the dense table, as chip_smoke.py
           times the row gather), scattered as the route gives them and
           sorted, at W = 4 and 8. Variants: the original kernel ("x1":
           one row a thread); K rows a thread, consecutive or strided by the
           block's width, every position load and then every row load in
           flight before the first store; streaming stores
           (__stcs) of the output rows; at W = 8 a lane pair per row (one
           warp instruction covers 16 rows of 32 bytes); a floor that
           writes rows without reading the table; and the port's row
           gather through its wrapper.

Beside each time it prints the distinct sectors the kernel must read
(r4 sectors per child, table sectors per position), the byte bound of
chip_smoke.py, the sector bound (32 bytes per distinct sector plus the
streamed bytes at 3.35 TB/s) and a bound at the rates measured here.
Median of ROUNDS interleaved rounds; everything goes to
chiprun_out/gather_sweep.json.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
import tempfile
import time

ROUNDS = 5
REPS = 20          # launch batches per timed run (9 launches each)
WARM_REPS = 8      # rounds of the 9 levels for a warm compact time
PIECES = 1 << 22   # random pieces read per probe launch
L2_BYTES = 16 << 20
BIG_BYTES = 4 << 30    # a buffer of which L2 holds ~1%

_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int K> struct Vec;
template <> struct Vec<1> { using type = int32_t; };
template <> struct Vec<2> { using type = int2; };
template <> struct Vec<4> { using type = int4; };

// K consecutive int32 from src + i0 (4K-byte aligned for K <= 4), as
// one vector load per 4 items
template <int K>
__device__ __forceinline__ void load_k(const int32_t* __restrict__ src,
                                       int64_t i0, int32_t (&v)[K]) {
  constexpr int kW = K < 4 ? K : 4;
  using V = typename Vec<kW>::type;
#pragma unroll
  for (int q = 0; q < K; q += kW) {
    const V x = __ldg(reinterpret_cast<const V*>(src + i0 + q));
    const int32_t* px = reinterpret_cast<const int32_t*>(&x);
#pragma unroll
    for (int k = 0; k < kW; ++k) v[q + k] = px[k];
  }
}

template <int K>
__device__ __forceinline__ void store_k(int32_t* __restrict__ dst,
                                        int64_t i0, const int32_t (&v)[K]) {
  constexpr int kW = K < 4 ? K : 4;
  using V = typename Vec<kW>::type;
#pragma unroll
  for (int q = 0; q < K; q += kW) {
    V x;
    int32_t* px = reinterpret_cast<int32_t*>(&x);
#pragma unroll
    for (int k = 0; k < kW; ++k) px[k] = v[q + k];
    *reinterpret_cast<V*>(dst + i0 + q) = x;
  }
}

// ---- random-access probe ---------------------------------------------

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// Lane group g (G lanes) reads kR pieces of G x 16 bytes, piece index
// hashed from (g, r) into [0, npieces); all kR loads before any use.
template <int G>
__global__ void probe_kernel(const int4* __restrict__ buf, uint32_t npieces,
                             uint32_t groups, uint32_t seed,
                             int32_t* __restrict__ sink) {
  constexpr int kR = 4;
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t g = t / G, lane = t % G;
  if (g >= groups) return;
  int4 v[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const uint32_t h = mix((g * kR + r) ^ seed);
    const uint32_t piece =
        static_cast<uint32_t>((static_cast<uint64_t>(h) * npieces) >> 32);
    v[r] = __ldg(buf + static_cast<size_t>(piece) * G + lane);
  }
  int32_t acc = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) acc ^= v[r].x ^ v[r].y ^ v[r].z ^ v[r].w;
  if (acc == 0x13579bdf) sink[0] = acc;  // keeps the loads
}

// ---- compact ---------------------------------------------------------

// The original kernel: one child a thread, C[c] by __ldg.
__global__ void compact_parent_kernel(const int32_t* __restrict__ r4lo,
                                      const int32_t* __restrict__ r4hi,
                                      int mprev,
                                      const int32_t* __restrict__ parents,
                                      const int32_t* __restrict__ chars,
                                      const int32_t* __restrict__ C,
                                      int32_t* __restrict__ lo_out,
                                      int32_t* __restrict__ hi_out, int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int c = chars[i];
  const size_t idx = static_cast<size_t>(c - 1) * mprev + parents[i];
  const int32_t base = __ldg(C + c);
  lo_out[i] = base + __ldg(r4lo + idx);
  hi_out[i] = base + __ldg(r4hi + idx);
}

// K children a thread; thread 0 also runs the last m % K one at a time.
template <int K, bool kSmemC, bool kVec, bool kFloor>
__global__ void compact_kernel(const int32_t* __restrict__ r4lo,
                               const int32_t* __restrict__ r4hi, int mprev,
                               const int32_t* __restrict__ parents,
                               const int32_t* __restrict__ chars,
                               const int32_t* __restrict__ C,
                               int32_t* __restrict__ lo_out,
                               int32_t* __restrict__ hi_out, int m) {
  __shared__ int32_t c_base[5];
  if (kSmemC) {
    if (threadIdx.x < 5) c_base[threadIdx.x] = C[threadIdx.x];
    __syncthreads();
  }
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int whole = m / K;
  if (t == 0) {
    for (int i = whole * K; i < m; ++i) {
      const int c = __ldg(chars + i);
      const size_t x = static_cast<size_t>(c - 1) * mprev + __ldg(parents + i);
      const int32_t base = kSmemC ? c_base[c] : __ldg(C + c);
      lo_out[i] = base + (kFloor ? __ldg(parents + i) : __ldg(r4lo + x));
      hi_out[i] = base + (kFloor ? __ldg(parents + i) + 1 : __ldg(r4hi + x));
    }
  }
  if (t >= whole) return;
  const int64_t i0 = static_cast<int64_t>(t) * K;
  int32_t p[K], c[K], l[K], h[K];
  if (kVec) {
    load_k<K>(parents, i0, p);
    load_k<K>(chars, i0, c);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      p[k] = __ldg(parents + i0 + k);
      c[k] = __ldg(chars + i0 + k);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (kFloor) {
      l[k] = p[k];
      h[k] = p[k] + 1;
    } else {
      const size_t x = static_cast<size_t>(c[k] - 1) * mprev + p[k];
      l[k] = __ldg(r4lo + x);
      h[k] = __ldg(r4hi + x);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int32_t base = kSmemC ? c_base[c[k]] : __ldg(C + c[k]);
    l[k] += base;
    h[k] += base;
  }
  if (kVec) {
    store_k<K>(lo_out, i0, l);
    store_k<K>(hi_out, i0, h);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lo_out[i0 + k] = l[k];
      hi_out[i0 + k] = h[k];
    }
  }
}

// K children a thread, strided: thread t of block b runs children
// b K T + j T + t (T threads a block, j < K), so each warp instruction
// covers 32 neighbouring children as with one a thread; every load of the
// thread before any store; C[c] by __ldg beside the gathers; streaming
// stores (__stcs) of lo' and hi' where kStream.
template <int K, bool kStream>
__global__ void compact_strided_kernel(const int32_t* __restrict__ r4lo,
                                       const int32_t* __restrict__ r4hi,
                                       int mprev,
                                       const int32_t* __restrict__ parents,
                                       const int32_t* __restrict__ chars,
                                       const int32_t* __restrict__ C,
                                       int32_t* __restrict__ lo_out,
                                       int32_t* __restrict__ hi_out, int m) {
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * K * blockDim.x +
                     threadIdx.x;
  int32_t p[K], c[K], l[K], h[K], b[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int64_t i = i0 + j * blockDim.x;
    p[j] = i < m ? __ldg(parents + i) : 0;
    c[j] = i < m ? __ldg(chars + i) : 1;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (i0 + j * blockDim.x < m) {
      const size_t x = static_cast<size_t>(c[j] - 1) * mprev + p[j];
      l[j] = __ldg(r4lo + x);
      h[j] = __ldg(r4hi + x);
      b[j] = __ldg(C + c[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int64_t i = i0 + j * blockDim.x;
    if (i < m && kStream) {
      __stcs(lo_out + i, b[j] + l[j]);
      __stcs(hi_out + i, b[j] + h[j]);
    } else if (i < m) {
      lo_out[i] = b[j] + l[j];
      hi_out[i] = b[j] + h[j];
    }
  }
}

// ---- row gather ------------------------------------------------------

// K rows a thread, strided as compact_strided_kernel: each warp
// instruction covers 32 neighbouring rows, as with one a thread; every
// position and row load of the thread before any store.
template <int W, int K>
__global__ void rows_strided_kernel(const int4* __restrict__ occ,
                                    const int32_t* __restrict__ pos,
                                    int4* __restrict__ rows, int m) {
  constexpr int kVec = W / 4;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * K * blockDim.x +
                     threadIdx.x;
  int32_t q[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int64_t i = i0 + j * blockDim.x;
    q[j] = i < m ? __ldg(pos + i) : 0;
  }
  int4 r[K][kVec];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      if (i0 + j * blockDim.x < m)
        r[j][v] = __ldg(occ + static_cast<size_t>(q[j]) * kVec + v);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int64_t i = i0 + j * blockDim.x;
    if (i < m) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) rows[i * kVec + v] = r[j][v];
    }
  }
}

// W = 8, a lane pair per row and K rows a pair, strided: lane pair u of
// block b takes rows b K U + j U + u (U = T / 2 pairs a block).
template <int K>
__global__ void rows_lane_pair_strided_kernel(const int4* __restrict__ occ,
                                              const int32_t* __restrict__ pos,
                                              int4* __restrict__ rows, int m) {
  const int half = threadIdx.x & 1;
  const int pairs = blockDim.x >> 1;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * K * pairs +
                     (threadIdx.x >> 1);
  int32_t q[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int64_t i = i0 + j * pairs;
    q[j] = i < m ? __ldg(pos + i) : 0;
  }
  int4 r[K];
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (i0 + j * pairs < m)
      r[j] = __ldg(occ + static_cast<size_t>(q[j]) * 2 + half);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int64_t i = i0 + j * pairs;
    if (i < m) rows[i * 2 + half] = r[j];
  }
}


// The original kernel: one row a thread.
template <int W>
__global__ void rows_parent_kernel(const int4* __restrict__ occ,
                                   const int32_t* __restrict__ pos,
                                   int4* __restrict__ rows, int m) {
  constexpr int kVec = W / 4;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const size_t src = static_cast<size_t>(__ldg(pos + i)) * kVec;
  const size_t dst = static_cast<size_t>(i) * kVec;
#pragma unroll
  for (int v = 0; v < kVec; ++v) rows[dst + v] = __ldg(occ + src + v);
}

__device__ __forceinline__ void put(int4* __restrict__ dst, int4 v,
                                    bool stream) {
  if (stream) {
    __stcs(dst, v);
  } else {
    *dst = v;
  }
}

// K rows a thread: every position, then every row, loaded before the
// first store; thread 0 also copies the last m % K rows one at a time.
template <int W, int K, bool kStream, bool kFloor>
__global__ void rows_kernel(const int4* __restrict__ occ,
                            const int32_t* __restrict__ pos,
                            int4* __restrict__ rows, int m) {
  constexpr int kVec = W / 4;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int whole = m / K;
  if (t == 0) {
    for (int i = whole * K; i < m; ++i) {
      const int32_t q = __ldg(pos + i);
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        put(rows + static_cast<size_t>(i) * kVec + v,
            kFloor ? make_int4(q, q, q, q)
                   : __ldg(occ + static_cast<size_t>(q) * kVec + v),
            kStream);
    }
  }
  if (t >= whole) return;
  const int64_t i0 = static_cast<int64_t>(t) * K;
  int32_t q[K];
  load_k<K>(pos, i0, q);
  int4 r[K][kVec];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      r[k][v] = kFloor ? make_int4(q[k], q[k], q[k], q[k])
                       : __ldg(occ + static_cast<size_t>(q[k]) * kVec + v);
  int4* dst = rows + i0 * kVec;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int v = 0; v < kVec; ++v) put(dst + k * kVec + v, r[k][v], kStream);
}

// W = 8, a lane pair per row: lane 2i + h loads and stores half h.
template <bool kStream>
__global__ void rows_lane_pair_kernel(const int4* __restrict__ occ,
                                      const int32_t* __restrict__ pos,
                                      int4* __restrict__ rows, int m) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t i = t >> 1;
  if (i >= m) return;
  const size_t q = static_cast<size_t>(__ldg(pos + i));
  const int4 v = __ldg(occ + q * 2 + (t & 1));
  put(rows + t, v, kStream);
}

int blocks(int64_t threads) {
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

template <int G>
int launch_probe(const int4* buf, uint32_t npieces, uint32_t groups,
                 uint32_t seed, int32_t* sink, cudaStream_t s) {
  probe_kernel<G><<<blocks(static_cast<int64_t>(groups) * G), kThreads, 0,
                    s>>>(buf, npieces, groups, seed, sink);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int probe(const void* buf, int g, unsigned npieces,
                     unsigned groups, unsigned seed, void* sink,
                     void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const int4*>(buf);
  auto* k = static_cast<int32_t*>(sink);
  switch (g) {
    case 1: return launch_probe<1>(b, npieces, groups, seed, k, s);
    case 2: return launch_probe<2>(b, npieces, groups, seed, k, s);
    case 4: return launch_probe<4>(b, npieces, groups, seed, k, s);
    case 8: return launch_probe<8>(b, npieces, groups, seed, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#define COMPACT_ARGS                                                        \
  const void* r4lo, const void* r4hi, int mprev, const void* par,          \
      const void* chs, const void* C, void* lo2, void* hi2, int m,         \
      void* stream
#define COMPACT_PASS                                                        \
  static_cast<const int32_t*>(r4lo), static_cast<const int32_t*>(r4hi),    \
      mprev, static_cast<const int32_t*>(par),                             \
      static_cast<const int32_t*>(chs), static_cast<const int32_t*>(C),    \
      static_cast<int32_t*>(lo2), static_cast<int32_t*>(hi2), m

extern "C" int compact_parent(COMPACT_ARGS) {
  compact_parent_kernel<<<blocks(m), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(COMPACT_PASS);
  return static_cast<int>(cudaGetLastError());
}

#define COMPACT_ENTRY(name, K, smem, vec, floor)                            \
  extern "C" int name(COMPACT_ARGS) {                                       \
    compact_kernel<K, smem, vec, floor>                                     \
        <<<blocks(m / K > 0 ? m / K : 1), kThreads, 0,                      \
           static_cast<cudaStream_t>(stream)>>>(COMPACT_PASS);              \
    return static_cast<int>(cudaGetLastError());                            \
  }
COMPACT_ENTRY(compact_1_smem, 1, true, true, false)
COMPACT_ENTRY(compact_2_ldg, 2, false, true, false)
COMPACT_ENTRY(compact_2, 2, true, true, false)
COMPACT_ENTRY(compact_2_scalar, 2, true, false, false)
COMPACT_ENTRY(compact_4, 4, true, true, false)
COMPACT_ENTRY(compact_4_ldg, 4, false, true, false)
COMPACT_ENTRY(compact_8, 8, true, true, false)
COMPACT_ENTRY(compact_floor_2, 2, true, true, true)
COMPACT_ENTRY(compact_floor_4, 4, true, true, true)

#define COMPACT_STRIDED(name, K, stream_)                                   \
  extern "C" int name(COMPACT_ARGS) {                                       \
    compact_strided_kernel<K, stream_>                                      \
        <<<blocks((m + K - 1) / K), kThreads, 0,                            \
           static_cast<cudaStream_t>(stream)>>>(COMPACT_PASS);              \
    return static_cast<int>(cudaGetLastError());                            \
  }
COMPACT_STRIDED(compact_strided_1_cs, 1, true)
COMPACT_STRIDED(compact_strided_2, 2, false)
COMPACT_STRIDED(compact_strided_2_cs, 2, true)
COMPACT_STRIDED(compact_strided_4, 4, false)

#define ROWS_ARGS const void* occ, const void* pos, void* rows, int m,      \
                  void* stream
#define ROWS_PASS static_cast<const int4*>(occ),                           \
                  static_cast<const int32_t*>(pos),                        \
                  static_cast<int4*>(rows), m

#define ROWS_PARENT(name, W)                                                \
  extern "C" int name(ROWS_ARGS) {                                          \
    rows_parent_kernel<W><<<blocks(m), kThreads, 0,                         \
                            static_cast<cudaStream_t>(stream)>>>(ROWS_PASS);\
    return static_cast<int>(cudaGetLastError());                            \
  }
ROWS_PARENT(rows4_parent, 4)
ROWS_PARENT(rows8_parent, 8)

#define ROWS_ENTRY(name, W, K, stream_, floor)                              \
  extern "C" int name(ROWS_ARGS) {                                          \
    rows_kernel<W, K, stream_, floor>                                       \
        <<<blocks(m / K > 0 ? m / K : 1), kThreads, 0,                      \
           static_cast<cudaStream_t>(stream)>>>(ROWS_PASS);                 \
    return static_cast<int>(cudaGetLastError());                            \
  }
ROWS_ENTRY(rows4_1_cs, 4, 1, true, false)
ROWS_ENTRY(rows4_2, 4, 2, false, false)
ROWS_ENTRY(rows4_2_cs, 4, 2, true, false)
ROWS_ENTRY(rows4_4, 4, 4, false, false)
ROWS_ENTRY(rows4_4_cs, 4, 4, true, false)
ROWS_ENTRY(rows4_floor_1, 4, 1, false, true)
ROWS_ENTRY(rows4_floor_2_cs, 4, 2, true, true)
ROWS_ENTRY(rows8_1_cs, 8, 1, true, false)
ROWS_ENTRY(rows8_2, 8, 2, false, false)
ROWS_ENTRY(rows8_2_cs, 8, 2, true, false)
ROWS_ENTRY(rows8_4, 8, 4, false, false)
ROWS_ENTRY(rows8_4_cs, 8, 4, true, false)
ROWS_ENTRY(rows8_floor_1, 8, 1, false, true)
ROWS_ENTRY(rows8_floor_2_cs, 8, 2, true, true)

#define ROWS_LANE_PAIR(name, stream_)                                       \
  extern "C" int name(ROWS_ARGS) {                                          \
    rows_lane_pair_kernel<stream_>                                          \
        <<<blocks(2 * static_cast<int64_t>(m)), kThreads, 0,                \
           static_cast<cudaStream_t>(stream)>>>(ROWS_PASS);                 \
    return static_cast<int>(cudaGetLastError());                            \
  }
ROWS_LANE_PAIR(rows8_lane_pair, false)
ROWS_LANE_PAIR(rows8_lane_pair_cs, true)

#define ROWS_STRIDED(name, W, K)                                            \
  extern "C" int name(ROWS_ARGS) {                                          \
    rows_strided_kernel<W, K>                                               \
        <<<blocks((m + K - 1) / K), kThreads, 0,                            \
           static_cast<cudaStream_t>(stream)>>>(ROWS_PASS);                 \
    return static_cast<int>(cudaGetLastError());                            \
  }
ROWS_STRIDED(rows4_strided_2, 4, 2)
ROWS_STRIDED(rows4_strided_4, 4, 4)
ROWS_STRIDED(rows8_strided_2, 8, 2)

#define ROWS_LANE_PAIR_STRIDED(name, K)                                     \
  extern "C" int name(ROWS_ARGS) {                                          \
    rows_lane_pair_strided_kernel<K>                                        \
        <<<blocks(2 * ((static_cast<int64_t>(m) + K - 1) / K)), kThreads,  \
           0, static_cast<cudaStream_t>(stream)>>>(ROWS_PASS);              \
    return static_cast<int>(cudaGetLastError());                            \
  }
ROWS_LANE_PAIR_STRIDED(rows8_lane_pair_strided_2, 2)
ROWS_LANE_PAIR_STRIDED(rows8_lane_pair_strided_4, 4)
"""

#: probe pieces: lanes a piece (16 bytes each)
_PIECE_LANES = {"16 B of a sector": 1, "32-byte sector": 2,
                "64-byte piece": 4, "128-byte line": 8}
#: the one compact variant that writes into two reused output buffers
_REUSED = "x1, into two reused output buffers"
#: compact variants: entry point ("port": the port's wrapper), children a
#: thread, floor
_COMPACT = {
    "x1": ("compact_parent", 1, False),
    "x1, C in shared memory": ("compact_1_smem", 1, False),
    "x2, C by __ldg": ("compact_2_ldg", 2, False),
    "x2": ("compact_2", 2, False),
    "x2, scalar loads and stores": ("compact_2_scalar", 2, False),
    "x4": ("compact_4", 4, False),
    "x4, C by __ldg": ("compact_4_ldg", 4, False),
    "x8": ("compact_8", 8, False),
    "x1, streaming stores": ("compact_strided_1_cs", 1, False),
    "x2 strided, C by __ldg": ("compact_strided_2", 2, False),
    "x2 strided, streaming stores": ("compact_strided_2_cs", 2, False),
    "x4 strided, C by __ldg": ("compact_strided_4", 4, False),
    "floor x2 (no r4)": ("compact_floor_2", 2, True),
    "floor x4 (no r4)": ("compact_floor_4", 4, True),
    "the port's compact": ("port", None, False),
    _REUSED: ("compact_parent", 1, False),
}
#: row-gather variants per width: entry point ("port": the port's
#: wrapper), floor
_ROWS = {
    4: {"x1": ("rows4_parent", False),
        "x1, streaming stores": ("rows4_1_cs", False),
        "x2": ("rows4_2", False),
        "x2, streaming stores": ("rows4_2_cs", False),
        "x4": ("rows4_4", False),
        "x4, streaming stores": ("rows4_4_cs", False),
        "x2 strided": ("rows4_strided_2", False),
        "x4 strided": ("rows4_strided_4", False),
        "floor x1 (no table)": ("rows4_floor_1", True),
        "floor x2, streaming stores (no table)": ("rows4_floor_2_cs", True),
        "the port's row gather": ("port", False)},
    8: {"x1": ("rows8_parent", False),
        "x1, streaming stores": ("rows8_1_cs", False),
        "x2": ("rows8_2", False),
        "x2, streaming stores": ("rows8_2_cs", False),
        "x4": ("rows8_4", False),
        "x4, streaming stores": ("rows8_4_cs", False),
        "lane pair": ("rows8_lane_pair", False),
        "lane pair, streaming stores": ("rows8_lane_pair_cs", False),
        "x2 strided": ("rows8_strided_2", False),
        "lane pair, x2 strided": ("rows8_lane_pair_strided_2", False),
        "lane pair, x4 strided": ("rows8_lane_pair_strided_4", False),
        "floor x1 (no table)": ("rows8_floor_1", True),
        "floor x2, streaming stores (no table)": ("rows8_floor_2_cs", True),
        "the port's row gather": ("port", False)},
}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gather_sweep: no CUDA device is visible", file=sys.stderr)
        return 2
    from psi_tpu_torch.io import load_graph
    from psi_tpu_torch.ops import fm as fm_ops
    from psi_tpu_torch.ops import fm_pallas, fm_stream
    from psi_tpu_torch.seed_finder import SeedFinder
    from psi_tpu_torch.tools import bacterial as cell
    from psi_tpu_torch.tools.timing import (HBM_BYTES_PER_S, bracketed_ms,
                                            build_sweep, card_line, cuda_ms,
                                            r4_sectors, row_sectors)

    card = card_line()
    print(f"[card] {card}", flush=True)
    out_dir = os.path.join(os.getcwd(), "chiprun_out")
    with tempfile.TemporaryDirectory(prefix="gather_sweep_") as tmp:
        os.environ["HOME"] = tmp
        lib = build_sweep(tmp, "gather_sweep", _SOURCE)
        gfa, fastq = cell.make_data(tmp, cell.REF_LEN,
                                    cell.N_CHUNKS * cell.CHUNK)
        finder = SeedFinder(load_graph(gfa), cell.SEED_LEN)
        finder.create_path_index(cell.N_PATHS, patched=False)
        _, _, index = cell.first_chunk_index(finder, fastq, cell.CHUNK)
        uniq, _, prep = index._onpath_prep
        sarr = finder._get_stream_arrays()
        levels, npad = prep.parents.shape
        par, chs = prep.parents, prep.chars
        stream = torch.cuda.current_stream().cuda_stream

        def bind(entry, argtypes):
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            return lambda *a: _require(fn(*a) == 0, f"{entry} failed")

        # the levels' frontiers and rank tables, as the two-pass route
        # makes them
        fronts = [(prep.lo0, prep.hi0)]
        for j in range(levels):
            fronts.append(fm_stream.compact_plain(
                *fm_stream.rank4_pair_plain(sarr, *fronts[-1]), par[j],
                chs[j], sarr.C))
        r4s = [fm_stream.rank4_pair_stream(sarr, *fronts[j])
               for j in range(levels)]
        want_c = [fronts[j + 1] for j in range(levels)]

        # the gather route's positions and the two tables
        arrays = finder._get_fm_arrays()
        p = (arrays.ftab.shape[0].bit_length() - 1) // 2
        codes = torch.from_numpy(fm_ops.keys_to_codes(
            uniq, cell.SEED_LEN)).to(arrays.C.device)
        steps, _ = cell.lf_steps(arrays, codes, p)
        scattered = [torch.cat([lo, hi]) for _, lo, hi in steps]
        orders = {"scattered": scattered,
                  "sorted": [torch.sort(q).values for q in scattered]}
        tables = {4: arrays.occ_dense,
                  8: torch.from_numpy(fm_pallas.occ_dense_padded(
                      finder.pindex.fm)).to(arrays.C.device)}
        torch.cuda.synchronize()

        runs, result = {}, {}

        # random-access rates
        sink = torch.zeros(1, dtype=torch.int32, device="cuda")
        probe = bind("probe", [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                               ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
                               ctypes.c_void_p])
        big = torch.empty(BIG_BYTES, dtype=torch.uint8, device="cuda")
        buffers = {"W=4 table (HBM)": (tables[4], tables[4].numel() * 4),
                   "W=8 table (HBM)": (tables[8], tables[8].numel() * 4),
                   "4 GiB (HBM)": (big, BIG_BYTES),
                   "16 MB (L2)": (tables[4], L2_BYTES)}
        for bname, (buf, size) in buffers.items():
            for pname, g in _PIECE_LANES.items():
                npieces = size // (16 * g)
                groups = PIECES // 4

                def run(buf=buf, g=g, npieces=npieces, groups=groups):
                    probe(buf.data_ptr(), g, npieces, groups, 0x9e3779b9,
                          sink.data_ptr(), stream)
                key = f"rate {pname}, {bname}"
                runs[key] = run
                result[key] = {"per_run": 1, "pieces": PIECES,
                               "piece_bytes": 16 * g, "buffer_bytes": size}

        # compact: every variant writes fresh outputs, as its wrapper and
        # the route do (one of them writes into two reused buffers, as
        # sweeps before did)
        cargs = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        cargs += [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
        bufs = [(torch.empty(npad, dtype=torch.int32, device="cuda"),
                 torch.empty(npad, dtype=torch.int32, device="cuda"))
                for _ in range(2)]

        def compact_fn(entry, reused):
            if entry == "port":
                return lambda r4, j: fm_stream.compact_children(
                    *r4, par[j], chs[j], sarr.C)
            fn = bind(entry, cargs)

            def launch(r4, j):
                out = bufs[j % 2] if reused else (
                    torch.empty(npad, dtype=torch.int32, device="cuda"),
                    torch.empty(npad, dtype=torch.int32, device="cuda"))
                fn(r4[0].data_ptr(), r4[1].data_ptr(), r4[0].shape[1],
                   par[j].data_ptr(), chs[j].data_ptr(), sarr.C.data_ptr(),
                   out[0].data_ptr(), out[1].data_ptr(), npad, stream)
                return out
            return launch

        def rank4_pair_alone():
            for j in range(levels):
                fm_stream.rank4_pair_stream(sarr, *fronts[j])
        runs["compact route: rank4_pair alone"] = rank4_pair_alone
        result["compact route: rank4_pair alone"] = {"per_run": levels,
                                                     "bit_equal": True}
        sectors = [r4_sectors(npad, par[j], chs[j]) for j in range(levels)]
        streamed = 4 * 4 * npad
        for name, (entry, _, floor) in _COMPACT.items():
            fn = compact_fn(entry, name == _REUSED)
            got = [tuple(t.clone() for t in fn(r4s[j], j))
                   for j in range(levels)]
            same = all(torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
                       for g, w in zip(got, want_c))
            _require(same or floor, f"compact {name} differs from plain")

            def cold(fn=fn):
                for j in range(levels):
                    fn(r4s[j], j)
            runs[f"compact {name}, cold"] = cold
            result[f"compact {name}, cold"] = {"per_run": levels,
                                               "bit_equal": same}
            result[f"compact {name}, warm"] = {
                "per_run": 1, "bit_equal": same,
                "bracketed": (lambda fn=fn: bracketed_ms(
                    lambda j: fm_stream.rank4_pair_stream(sarr, *fronts[j]),
                    lambda j, r4: fn(r4, j), levels, WARM_REPS))}
            if not floor:
                # the two-pass route itself: rank4_pair then compact per
                # level, each level from the last (a floor's outputs are
                # no frontier)
                def route(fn=fn):
                    lo, hi = prep.lo0, prep.hi0
                    for j in range(levels):
                        lo, hi = fn(fm_stream.rank4_pair_stream(sarr, lo, hi),
                                    j)
                runs[f"compact {name}, route"] = route
                result[f"compact {name}, route"] = {"per_run": levels,
                                                    "bit_equal": same}
            if entry == "compact_parent" and name != _REUSED:
                # cold again, with the events of the warm time around each
                # launch: what the events themselves add
                result[f"compact {name}, cold, events around each "
                       f"launch"] = {
                    "per_run": 1, "bit_equal": same,
                    "bracketed": (lambda fn=fn: bracketed_ms(
                        lambda j: r4s[j], lambda j, r4: fn(r4, j), levels,
                        WARM_REPS))}
        compact_facts = {
            "r4_sectors_per_child_and_table": sum(sectors) / (levels * npad),
            "sector_bound_us": 1e6 * sum(streamed + 2 * 32 * s
                                         for s in sectors)
            / levels / HBM_BYTES_PER_S,
            "warm_bound_us": 1e6 * streamed / HBM_BYTES_PER_S,
            "r4_sectors": sectors}

        # the row gather
        rargs = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        m = scattered[0].numel()
        row_facts = {}
        for width, occ in tables.items():
            out = [torch.empty((m, width), dtype=torch.int32, device="cuda")
                   for _ in range(2)]
            for order, positions in orders.items():
                want = [fm_pallas.gather_occ_rows_plain(occ, q)
                        for q in positions]
                secs = [row_sectors(width, q) for q in positions]
                row_facts[f"W{width} {order}"] = {
                    "sectors_per_position": sum(secs) / (m * len(positions)),
                    "sector_bound_us": 1e6 * sum(
                        4 * m + 4 * width * m + 32 * s for s in secs)
                    / len(secs) / HBM_BYTES_PER_S,
                    "byte_bound_us": 1e6 * sum(
                        4 * m + 4 * width * (m + int(torch.unique(q).numel()))
                        for q in positions) / len(secs) / HBM_BYTES_PER_S,
                    "sectors": secs}
                for name, (entry, floor) in _ROWS[width].items():
                    if entry == "port":
                        def fn(q, o, occ=occ):
                            return fm_pallas.gather_occ_rows(occ, q)
                    else:
                        raw = bind(entry, rargs)

                        def fn(q, o, raw=raw, occ=occ):
                            raw(occ.data_ptr(), q.data_ptr(), o.data_ptr(),
                                q.numel(), stream)
                            return o
                    same = all(torch.equal(fn(q, out[0]), w)
                               for q, w in zip(positions, want))
                    _require(same or floor,
                             f"row gather W={width} {name} differs from plain")

                    def rows_run(fn=fn, positions=positions, out=out):
                        for i, q in enumerate(positions):
                            fn(q, out[i % 2])
                    key = f"rows W={width} {order}, {name}"
                    runs[key] = rows_run
                    result[key] = {"per_run": len(positions),
                                   "bit_equal": same}
        torch.cuda.synchronize()

        for rec in result.values():
            rec["us"] = []
        for _ in range(ROUNDS):
            for key, run in runs.items():
                result[key]["us"].append(
                    1e3 * cuda_ms(run, REPS) / result[key]["per_run"])
            for key, rec in result.items():
                if "bracketed" in rec:
                    rec["us"].append(1e3 * rec["bracketed"]())
        for key, rec in result.items():
            rec.pop("bracketed", None)
            rec["median_us"] = sorted(rec["us"])[len(rec["us"]) // 2]
            line = (f"[sweep] {key}: {rec['median_us']:.3f} us/launch "
                    f"(rounds {', '.join(f'{u:.3f}' for u in rec['us'])})")
            if key.startswith("rate"):
                rec["pieces_per_s"] = rec["pieces"] / (rec["median_us"] * 1e-6)
                rec["bytes_per_s"] = rec["pieces_per_s"] * rec["piece_bytes"]
                line += (f"; {rec['pieces_per_s'] / 1e9:.2f} G pieces/s, "
                         f"{rec['bytes_per_s'] / 1e12:.3f} TB/s")
            else:
                line += ("; bit-equal" if rec["bit_equal"]
                         else "; a floor, not checked")
            print(line, flush=True)

        def rate(name):
            return result[f"rate {name}, W=4 table (HBM)"]["pieces_per_s"]
        compact_facts["sector_bound_at_l2_rate_us"] = 1e6 * (
            streamed / HBM_BYTES_PER_S
            + sum(2 * s for s in sectors) / levels
            / result["rate 32-byte sector, 16 MB (L2)"]["pieces_per_s"])
        compact_facts["sector_bound_at_hbm_rate_us"] = 1e6 * (
            streamed / HBM_BYTES_PER_S
            + sum(2 * s for s in sectors) / levels / rate("32-byte sector"))
        per_child = compact_facts["r4_sectors_per_child_and_table"]
        print(f"[sweep] compact: {per_child:.4f} "
              f"distinct r4 sectors per child and table; sector bound "
              f"{compact_facts['sector_bound_us']:.3f} us cold, byte bound "
              f"{compact_facts['warm_bound_us']:.3f} us warm (r4 in L2); at "
              f"the measured random-sector rates "
              f"{compact_facts['sector_bound_at_hbm_rate_us']:.3f} us from "
              f"HBM, {compact_facts['sector_bound_at_l2_rate_us']:.3f} from "
              f"L2", flush=True)
        for key, f in row_facts.items():
            width = int(key[1])
            f["bound_at_rate_us"] = 1e6 * (
                (4 * m + 4 * width * m) / HBM_BYTES_PER_S
                + sum(f["sectors"]) / len(f["sectors"])
                / rate("16 B of a sector" if width == 4
                       else "32-byte sector"))
            print(f"[sweep] rows {key}: {f['sectors_per_position']:.4f} "
                  f"distinct table sectors per position; byte bound "
                  f"{f['byte_bound_us']:.3f} us, sector bound "
                  f"{f['sector_bound_us']:.3f} us, at the measured HBM "
                  f"random-sector rate {f['bound_at_rate_us']:.3f} us",
                  flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "gather_sweep.json"), "w") as fh:
        json.dump({"card": card, "compact_shape": f"{npad} slots x {levels} "
                   f"levels", "rows_shape": f"{len(scattered)} launches of "
                   f"{m} positions", "compact": compact_facts,
                   "rows": row_facts, "times": result,
                   "time": time.strftime("%Y-%m-%d %H:%M:%S")}, fh, indent=2)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
