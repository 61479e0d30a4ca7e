"""Time the trie-level and rank4 kernels over the candidate layouts of the
rank payload, on the card, at chip_smoke.py's main-path shapes.

    python3 -m psi_tpu_torch.tools.record_layouts     # from the repo root

Each layout holds, per 32-position text block b, the occ checkpoints of
A/C/G/T before the block and the per-char match-mask words of its
positions, and a rank is occ_c + popc(match_c & below(pos)):

  W   psi_tpu's payloadW [NW, 8, 128]: block b's occ_c and match_c are
      words b & 127 of rows c-1 and 3+c of window b >> 7 (rows 512
      bytes apart; neighbouring blocks share a sector of a row)
  R8  the port's payloadR [NBpad, 8], (occ_1..occ_4, match_1..match_4):
      one sector per block, occ_c and match_c read as two 4-byte words
  RI  records [NBpad, 8], (occ_1, match_1, ..., occ_4, match_4): one
      sector per block, (occ_c, match_c) read as one 8-byte word
  PC  the port's payloadC [4, NBpad, 2] of (occ_c, match_c): one 8-byte
      word, four neighbouring blocks of one char per sector
  T   psi_tpu's payloadT [16, NBpad] (rank4 only): seven rows, one word
      of each per block

The trie-level kernel is timed over every level of chunk 1's frontier,
chained through two buffer pairs as ops/fm_fused.py's trie_fused runs
it: C[c] from shared memory, hi's word read only
where hi's block differs from lo's (W reads both, as trie_level.cu did
over payloadW). rank4 is timed at the levels' lo and hi positions as
they come (sorted) and in a seeded random order, over T, R8 (two
16-byte loads a record) and R8 read by lane pairs (each lane one 16-byte
half of a record, swapped by a shuffle). "x2" gives a thread two
consecutive items, loaded and stored as 8-byte pairs ("each thread
checks for a lone last child" adds the check for an odd count that the
port's kernel leaves to thread 0); "none" reads no payload at all and
is held to no plain version: the floor of the kernel's other loads and
stores. "the port's trie_level" is csrc/trie_level.cu through its
wrapper (PC x2 with its own load order); the port's rank4 is R8 x2
(csrc/rank4.cu). Every variant but "none" is held bit-equal to the plain
PyTorch frontier and rank4. Beside each time it prints the 32-byte
sectors and the 128-byte lines that the payload loads of a warp ask for
per 32 items on this run's positions (each load instruction, once per
distinct sector or line its active lanes touch), and writes everything
to chiprun_out/record_layouts.json. Device times by CUDA events with a
spin kernel queued first (tools/timing.cuda_ms), median of ROUNDS
interleaved rounds.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys
import tempfile
import time

ROUNDS = 5
REPS = 20

_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
enum { W = 0, R8 = 1, RI = 2, PC = 3, NONE = 4, T = 5, LP = 6 };

template <int K> struct Vec;
template <> struct Vec<1> { using type = int32_t; };
template <> struct Vec<2> { using type = int2; };
template <> struct Vec<4> { using type = int4; };

template <int K>
__device__ __forceinline__ void load_k(const int32_t* __restrict__ src,
                                       int i0, int32_t (&v)[K]) {
  using V = typename Vec<K>::type;
  const V x = __ldg(reinterpret_cast<const V*>(src + i0));
  const int32_t* px = reinterpret_cast<const int32_t*>(&x);
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = px[k];
}

template <int K>
__device__ __forceinline__ void store_k(int32_t* __restrict__ dst, int i0,
                                        const int32_t (&v)[K]) {
  using V = typename Vec<K>::type;
  V x;
  int32_t* px = reinterpret_cast<int32_t*>(&x);
#pragma unroll
  for (int k = 0; k < K; ++k) px[k] = v[k];
  *reinterpret_cast<V*>(dst + i0) = x;
}

__device__ __forceinline__ uint32_t below(int32_t pos) {
  return (1u << (static_cast<uint32_t>(pos) & 31u)) - 1u;
}

template <int L>
__device__ __forceinline__ void occ_match(const int32_t* __restrict__ pay,
                                          int nbpad, uint32_t b, int c,
                                          int32_t& occ, uint32_t& match) {
  if (L == W) {
    const int32_t* win = pay + static_cast<size_t>(b >> 7) * 1024;
    occ = __ldg(win + (c - 1) * 128 + (b & 127));
    match = static_cast<uint32_t>(__ldg(win + (3 + c) * 128 + (b & 127)));
  } else if (L == R8) {
    const int32_t* rec = pay + static_cast<size_t>(b) * 8;
    occ = __ldg(rec + c - 1);
    match = static_cast<uint32_t>(__ldg(rec + 3 + c));
  } else if (L == RI || L == PC) {
    const int2* words = reinterpret_cast<const int2*>(pay);
    const int2 v = __ldg(L == RI ? words + static_cast<size_t>(b) * 4 + c - 1
                                 : words + static_cast<size_t>(c - 1) * nbpad
                                       + b);
    occ = v.x;
    match = static_cast<uint32_t>(v.y);
  } else {  // NONE: no payload read, the floor of the kernel's other loads
    occ = 0;
    match = 0;
  }
}

// K consecutive children per thread; hi's word is read only where hi's
// block differs from lo's unless kBoth.
template <int L, int K, bool kBoth, bool kTailCheck>
__global__ void trie_kernel(const int32_t* __restrict__ pay, int nbpad,
                            const int32_t* __restrict__ C,
                            const int32_t* __restrict__ parents,
                            const int32_t* __restrict__ chars,
                            const int32_t* __restrict__ lo_in,
                            const int32_t* __restrict__ hi_in,
                            int32_t* __restrict__ lo_out,
                            int32_t* __restrict__ hi_out, int m) {
  __shared__ int32_t c_base[5];
  if (threadIdx.x < 5) c_base[threadIdx.x] = C[threadIdx.x];
  __syncthreads();
  const int i0 = (blockIdx.x * blockDim.x + threadIdx.x) * K;
  if (i0 >= m) return;
  if (kTailCheck && i0 + K > m) {  // the last K: one item at a time
    for (int i = i0; i < m; ++i) {
      const int p = __ldg(parents + i), c = __ldg(chars + i);
      const int32_t l = __ldg(lo_in + p), h = __ldg(hi_in + p);
      int32_t occ;
      uint32_t match;
      occ_match<L>(pay, nbpad, static_cast<uint32_t>(l) >> 5, c, occ, match);
      lo_out[i] = c_base[c] + occ + __popc(match & below(l));
      occ_match<L>(pay, nbpad, static_cast<uint32_t>(h) >> 5, c, occ, match);
      hi_out[i] = c_base[c] + occ + __popc(match & below(h));
    }
    return;
  }
  int32_t p[K], c[K], l[K], h[K], rl[K], rh[K];
  load_k<K>(parents, i0, p);
  load_k<K>(chars, i0, c);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    l[k] = __ldg(lo_in + p[k]);
    h[k] = __ldg(hi_in + p[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t bl = static_cast<uint32_t>(l[k]) >> 5;
    const uint32_t bh = static_cast<uint32_t>(h[k]) >> 5;
    int32_t occ;
    uint32_t match;
    occ_match<L>(pay, nbpad, bl, c[k], occ, match);
    const int32_t base = c_base[c[k]];
    rl[k] = base + occ + __popc(match & below(l[k])) + (L == NONE ? l[k] : 0);
    if (kBoth || bh != bl) occ_match<L>(pay, nbpad, bh, c[k], occ, match);
    rh[k] = base + occ + __popc(match & below(h[k])) + (L == NONE ? h[k] : 0);
  }
  store_k<K>(lo_out, i0, rl);
  store_k<K>(hi_out, i0, rh);
}

__device__ __forceinline__ void write4(int32_t* __restrict__ out, int m,
                                       int i, int32_t q, int4 occ,
                                       int4 match) {
  const uint32_t bm = below(q);
  const size_t s = static_cast<size_t>(m);
  out[i] = occ.x + __popc(static_cast<uint32_t>(match.x) & bm);
  out[s + i] = occ.y + __popc(static_cast<uint32_t>(match.y) & bm);
  out[2 * s + i] = occ.z + __popc(static_cast<uint32_t>(match.z) & bm);
  out[3 * s + i] = occ.w + __popc(static_cast<uint32_t>(match.w) & bm);
}

__device__ __forceinline__ int4 shfl_xor1(int4 v) {
  v.x = __shfl_xor_sync(0xffffffffu, v.x, 1);
  v.y = __shfl_xor_sync(0xffffffffu, v.y, 1);
  v.z = __shfl_xor_sync(0xffffffffu, v.z, 1);
  v.w = __shfl_xor_sync(0xffffffffu, v.w, 1);
  return v;
}

// Ranks of chars 1..4 at K consecutive positions per thread: T (payloadT,
// seven words), R8 (two 16-byte loads a record), LP (K = 1: lanes 2j and
// 2j+1 load the two halves of lane 2j's record, then of lane 2j+1's, one
// sector per record and instruction), NONE (no payload read).
template <int L, int K>
__global__ void rank4_kernel(const int32_t* __restrict__ pay, int nbpad,
                             const int32_t* __restrict__ pos,
                             int32_t* __restrict__ out, int m) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i0 = t * K;
  if (L == LP) {
    const int32_t q = __ldg(pos + min(t, m - 1));
    const int odd = threadIdx.x & 1;
    const int32_t other = __shfl_xor_sync(0xffffffffu, q, 1);
    const int4* recs = reinterpret_cast<const int4*>(pay);
    const int4 a = __ldg(recs + static_cast<size_t>(static_cast<uint32_t>(
                                    odd ? other : q) >> 5) * 2 + odd);
    const int4 b = __ldg(recs + static_cast<size_t>(static_cast<uint32_t>(
                                    odd ? q : other) >> 5) * 2 + odd);
    const int4 got = shfl_xor1(odd ? a : b);
    if (t < m) write4(out, m, t, q, odd ? got : a, odd ? b : got);
    return;
  }
  if (i0 >= m) return;
  int32_t q[K], r[4][K];
  load_k<K>(pos, i0, q);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t b = static_cast<uint32_t>(q[k]) >> 5;
    const uint32_t bm = below(q[k]);
    if (L == T) {
      const size_t n = static_cast<size_t>(nbpad);
      const uint32_t p0 = static_cast<uint32_t>(__ldg(pay + 6 * n + b));
      const uint32_t p1 = static_cast<uint32_t>(__ldg(pay + 7 * n + b));
      const uint32_t p2 = static_cast<uint32_t>(__ldg(pay + 8 * n + b));
#pragma unroll
      for (int c = 1; c <= 4; ++c) {
        const uint32_t match = ((c & 1) ? p0 : ~p0) & ((c & 2) ? p1 : ~p1) &
                               ((c & 4) ? p2 : ~p2);
        r[c - 1][k] = __ldg(pay + c * n + b) + __popc(match & bm);
      }
    } else if (L == R8) {
      const int4* rec = reinterpret_cast<const int4*>(pay) +
                        static_cast<size_t>(b) * 2;
      const int4 o = __ldg(rec), w = __ldg(rec + 1);
      r[0][k] = o.x + __popc(static_cast<uint32_t>(w.x) & bm);
      r[1][k] = o.y + __popc(static_cast<uint32_t>(w.y) & bm);
      r[2][k] = o.z + __popc(static_cast<uint32_t>(w.z) & bm);
      r[3][k] = o.w + __popc(static_cast<uint32_t>(w.w) & bm);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) r[c][k] = q[k] + c;
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    store_k<K>(out + static_cast<size_t>(c) * m, i0, r[c]);
}

}  // namespace

#define TRIE_ENTRY(name, L, K, both, tail)                                  \
  extern "C" int name(const void* pay, int nbpad, const void* C,            \
                      const void* par, const void* chs, const void* lo,     \
                      const void* hi, void* lo2, void* hi2, int m,          \
                      void* stream) {                                       \
    const int threads = (m + K - 1) / K;                                    \
    trie_kernel<L, K, both, tail>                                           \
        <<<(threads + kThreads - 1) / kThreads, kThreads, 0,                \
           static_cast<cudaStream_t>(stream)>>>(                            \
        static_cast<const int32_t*>(pay), nbpad,                            \
        static_cast<const int32_t*>(C), static_cast<const int32_t*>(par),   \
        static_cast<const int32_t*>(chs), static_cast<const int32_t*>(lo),  \
        static_cast<const int32_t*>(hi), static_cast<int32_t*>(lo2),        \
        static_cast<int32_t*>(hi2), m);                                     \
    return static_cast<int>(cudaGetLastError());                            \
  }
TRIE_ENTRY(trie_w_both_1, W, 1, true, false)
TRIE_ENTRY(trie_r8_1, R8, 1, false, false)
TRIE_ENTRY(trie_ri_1, RI, 1, false, false)
TRIE_ENTRY(trie_pc_1, PC, 1, false, false)
TRIE_ENTRY(trie_pc_2, PC, 2, false, false)
TRIE_ENTRY(trie_pc_2_tail, PC, 2, false, true)
TRIE_ENTRY(trie_none_1, NONE, 1, false, false)

#define RANK4_ENTRY(name, L, K)                                             \
  extern "C" int name(const void* pay, int nbpad, const void* pos,          \
                      void* out, int m, void* stream) {                     \
    const int threads = (m + K - 1) / K;                                    \
    rank4_kernel<L, K><<<(threads + kThreads - 1) / kThreads, kThreads, 0,  \
                         static_cast<cudaStream_t>(stream)>>>(              \
        static_cast<const int32_t*>(pay), nbpad,                            \
        static_cast<const int32_t*>(pos), static_cast<int32_t*>(out), m);   \
    return static_cast<int>(cudaGetLastError());                            \
  }
RANK4_ENTRY(rank4_t_1, T, 1)
RANK4_ENTRY(rank4_r8_1, R8, 1)
RANK4_ENTRY(rank4_r8_2, R8, 2)
RANK4_ENTRY(rank4_lp_1, LP, 1)
RANK4_ENTRY(rank4_none_1, NONE, 1)
"""

#: name: (entry point, layout, items per thread); "port" is the port's
#: own trie_level wrapper and kernel
_TRIE = {"W, both words read (trie_level.cu over payloadW)":
         ("trie_w_both_1", "W", 1),
         "R8": ("trie_r8_1", "R8", 1), "RI": ("trie_ri_1", "RI", 1),
         "PC": ("trie_pc_1", "PC", 1), "PC x2": ("trie_pc_2", "PC", 2),
         "PC x2, each thread checks for a lone last child":
         ("trie_pc_2_tail", "PC", 2),
         "PC x2, the port's trie_level": ("port", "PC", 2),
         "none": ("trie_none_1", "none", 1)}
_RANK4 = {"T": ("rank4_t_1", "T", 1), "R8": ("rank4_r8_1", "R8", 1),
          "R8 x2": ("rank4_r8_2", "R8", 2),
          "R8 lane pairs": ("rank4_lp_1", "LP", 1),
          "none": ("rank4_none_1", "none", 1)}


def _layouts(sarr) -> dict:
    """The candidate payloads on the card, from the port's payloadR (PC
    is the port's payloadC)."""
    rec = sarr.payloadR
    nb = rec.shape[0]
    return {
        "T": sarr.payloadT,
        "R8": rec,
        "LP": rec,
        "none": rec,
        "RI": rec[:, [0, 4, 1, 5, 2, 6, 3, 7]].contiguous(),
        "PC": sarr.payloadC,
        "W": rec.view(nb // 128, 128, 8).permute(0, 2, 1).contiguous(),
    }


def _requests(active, addr, k: int = 1) -> tuple[int, int]:
    """(32-byte sectors, 128-byte lines) that the load instructions
    reading byte address `addr[i]` for item i ask for: each thread holds
    k consecutive items and loads item j of its k in instruction j.
    Counts distinct (warp, instruction, sector or line) over the active
    items."""
    import torch

    idx = torch.arange(addr.numel(), device=addr.device)
    instr = (((idx // k) >> 5) * k + idx % k)[active] << 40
    a = addr.long()[active]
    return (int(torch.unique(instr | (a >> 5)).numel()),
            int(torch.unique(instr | (a >> 7)).numel()))


def _sum(pairs) -> tuple[int, int]:
    pairs = list(pairs)
    return sum(p[0] for p in pairs), sum(p[1] for p in pairs)


def _trie_requests(layout, k, nbpad, chars, lo, hi) -> tuple[int, int]:
    """Sectors and lines of the layout's payload loads for one level."""
    import torch

    c = chars.long() - 1
    bl, bh = (lo.long() >> 5), (hi.long() >> 5)
    every = torch.ones_like(bl, dtype=torch.bool)
    ends = ((bl, every), (bh, every if layout == "W" else bh != bl))
    if layout == "W":
        def word(b, row):
            return 4 * ((b >> 7) * 1024 + row * 128 + (b & 127))
        return _sum(_requests(m, word(b, r), k) for b, m in ends
                    for r in (c, c + 4))
    if layout == "PC":
        return _sum(_requests(m, 8 * (c * nbpad + b), k) for b, m in ends)
    if layout == "RI":
        return _sum(_requests(m, 32 * b + 8 * c, k) for b, m in ends)
    if layout == "R8":
        return _sum(_requests(m, 32 * b + 4 * w, k) for b, m in ends
                    for w in (c, c + 4))
    return 0, 0


def _rank4_requests(layout, k, nbpad, pos) -> tuple[int, int]:
    import torch

    b = pos.long() >> 5
    every = torch.ones_like(b, dtype=torch.bool)
    if layout == "T":
        return _sum(_requests(every, 4 * (r * nbpad + b), k)
                    for r in range(1, 5 + 3) if r != 5)
    if layout == "R8":
        return _sum(_requests(every, 32 * b + h, k) for h in (0, 16))
    if layout == "LP":
        # one instruction loads the halves of the even lanes' records, one
        # the odd lanes'
        lane = torch.arange(b.numel(), device=b.device)
        return _sum(_requests(lane % 2 == j, 32 * b + 16 * (lane % 2))
                    for j in (0, 1))
    return 0, 0


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("record_layouts: no CUDA device is visible", file=sys.stderr)
        return 2
    from psi_tpu_torch.io import load_graph
    from psi_tpu_torch.ops import fm_fused, fm_stream
    from psi_tpu_torch.seed_finder import SeedFinder
    from psi_tpu_torch.tools import bacterial as cell
    from psi_tpu_torch.tools.timing import build_sweep, card_line, cuda_ms

    repo = os.getcwd()

    card = card_line()
    print(f"[card] {card}", flush=True)
    with tempfile.TemporaryDirectory(prefix="record_layouts_") as tmp:
        os.environ["HOME"] = tmp
        lib = build_sweep(tmp, "record_layouts", _SOURCE)
        gfa, fastq = cell.make_data(tmp, cell.REF_LEN,
                                    cell.N_CHUNKS * cell.CHUNK)
        finder = SeedFinder(load_graph(gfa), cell.SEED_LEN)
        finder.create_path_index(cell.N_PATHS, patched=False)
        _, _, index = cell.first_chunk_index(finder, fastq, cell.CHUNK)
        sarr = finder._get_stream_arrays()
        prep = index._onpath_prep[2]
        levels, npad = prep.parents.shape
        par, chs = prep.parents, prep.chars
        pays = _layouts(sarr)
        nbpad = sarr.payloadR.shape[0]
        stream = torch.cuda.current_stream().cuda_stream
        fronts = [(prep.lo0, prep.hi0)]
        for j in range(levels):
            fronts.append(fm_fused.trie_level_plain(
                sarr.payloadC, sarr.C, par[j], chs[j], *fronts[-1]))
        gen = torch.Generator(device="cuda").manual_seed(5)
        sorted_pos = [p for j in range(levels) for p in fronts[j]]
        orders = {"sorted": sorted_pos,
                  "random order": [p[torch.randperm(p.numel(), device="cuda",
                                                    generator=gen)]
                                   for p in sorted_pos]}

        def bind(entry, nargs):
            fn = getattr(lib, entry)
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                           + [ctypes.c_void_p] * nargs
                           + [ctypes.c_int, ctypes.c_void_p])
            return lambda *a: _require(fn(*a) == 0, f"{entry} failed")

        # as chip_smoke times them: the trie levels chained through two
        # buffer pairs (trie_fused), rank4's outputs in two buffers
        def trie_run(entry, pay, lo_hi):
            if entry == "port":      # the port's wrapper and kernel
                def fn(pay_ptr, _, c_ptr, *ptrs):
                    fm_fused.trie_level(pay, sarr.C, *ptrs)
                ptr = (lambda t: t)
            else:
                fn = bind(entry, 7)
                ptr = (lambda t: t.data_ptr())
            bufs = [(torch.empty_like(prep.lo0), torch.empty_like(prep.hi0))
                    for _ in range(2)]

            def run():
                lo, hi = fronts[0]
                for j in range(levels):
                    out = bufs[j % 2]
                    if lo_hi is not None:    # one level, from its frontier
                        lo, hi = fronts[j]
                    fn(ptr(pay), nbpad, ptr(sarr.C),
                       *(ptr(t) for t in (par[j], chs[j], lo, hi, *out)),
                       *((npad, stream) if entry != "port" else ()))
                    lo, hi = out
                    if lo_hi is not None:
                        lo_hi.append((lo.clone(), hi.clone()))
            return run

        def rank4_run(entry, pay, positions, outs):
            fn = bind(entry, 2)
            stride = pay.shape[1] if pay is sarr.payloadT else nbpad
            bufs = [torch.empty((4, npad), dtype=torch.int32, device="cuda")
                    for _ in range(2)]

            def run():
                for i, p in enumerate(positions):
                    out = bufs[i % 2]
                    fn(pay.data_ptr(), stride, p.data_ptr(), out.data_ptr(),
                       p.numel(), stream)
                    if outs is not None:
                        outs.append(out.clone())
            return run

        runs, result = {}, {}
        for name, (entry, lay, k) in _TRIE.items():
            key = f"trie_level {name}"
            got = []
            trie_run(entry, pays[lay], got)()
            same = all(torch.equal(a, b) for (a, b) in
                       zip([t for g in got for t in g],
                           [t for f in fronts[1:] for t in f]))
            _require(same or lay == "none",
                     f"{key} differs from its plain version")
            runs[key] = trie_run(entry, pays[lay], None)
            req = _sum(_trie_requests(lay, k, nbpad, chs[j],
                                      fronts[j][0][par[j].long()],
                                      fronts[j][1][par[j].long()])
                       for j in range(levels))
            result[key] = {"per_run": levels, "bit_equal": same,
                           "sectors_per_32": req[0] / (levels * npad / 32),
                           "lines_per_32": req[1] / (levels * npad / 32)}
        for order, positions in orders.items():
            want = [fm_stream.rank4_plain(sarr.payloadR, p) for p in positions]
            for name, (entry, lay, k) in _RANK4.items():
                key = f"rank4 {name}, {order}"
                got = []
                rank4_run(entry, pays[lay], positions, got)()
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                _require(same or lay == "none",
                         f"{key} differs from its plain version")
                runs[key] = rank4_run(entry, pays[lay], positions, None)
                req = _sum(_rank4_requests(lay, k, nbpad, p)
                           for p in positions)
                items = sum(p.numel() / 32 for p in positions)
                result[key] = {"per_run": len(positions), "bit_equal": same,
                               "sectors_per_32": req[0] / items,
                               "lines_per_32": req[1] / items}
        torch.cuda.synchronize()
        for rec in result.values():
            rec["us"] = []
        for _ in range(ROUNDS):
            for key, run in runs.items():
                result[key]["us"].append(
                    1e3 * cuda_ms(run, REPS) / result[key]["per_run"])
        for key, rec in result.items():
            rec["median_us"] = sorted(rec["us"])[len(rec["us"]) // 2]
            print(f"[layouts] {key}: {rec['median_us']:.3f} us/launch "
                  f"(rounds {', '.join(f'{u:.3f}' for u in rec['us'])}); "
                  f"payload loads ask for {rec['sectors_per_32']:.2f} "
                  f"sectors and {rec['lines_per_32']:.2f} lines per 32 "
                  f"items; "
                  f"{'bit-equal' if rec['bit_equal'] else 'not checked'}",
                  flush=True)
    os.makedirs(os.path.join(repo, "chiprun_out"), exist_ok=True)
    with open(os.path.join(repo, "chiprun_out", "record_layouts.json"),
              "w") as fh:
        json.dump({"card": card, "shape": f"{npad} slots x {levels} levels",
                   "layouts": result,
                   "time": time.strftime("%Y-%m-%d %H:%M:%S")}, fh, indent=2)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
