"""Time the distance index's pair probe over its candidate designs on the
card, at chip_smoke.py's [dindex] inputs.

    python3 -m psi_tpu_torch.tools.probe_sweep      # from the repo root

The bacterial cell's graph (tools/bacterial.py), its distance index at
(250, 450) and (1000, 10000), and 2^22 locus pairs per index from two
simulated haplotypes, made as chip_smoke.py makes them; the probe's
inputs are those verify_batch_device hands probe_bisect. Every variant is
held bit-equal to probe_bisect_plain. Variants, one thread a query:

  flat       the first design (csrc/dindex_probe.cu's psi_dindex_probe_flat):
             a bisection over the whole key table, then up to four int32
             column reads with short circuit
  flat_rec   the same bisection, then one 16-byte row record
  dirB_*     one level of key buckets, at most 2^B
             (ops/dindex_probe.key_buckets): the query's bucket gives the
             rows to search, then
    _cols    a bisection there and the four columns;
    _rec     a bisection there and the row record;
    _early   _rec with the query's four int32 columns loaded before the
             search;
    _scan    _rec bisecting only to 4 rows, whose keys are then loaded
             together and counted;
    _k32     _rec over the keys' low 32 bits (the bucket fixes the rest;
             only where shift <= 32);
    _k32scan _k32 bisecting to 8 rows, then counting them
  twoB_S_R   the two-level directory (ops/dindex_probe.directory, at
             most 2^B top buckets; one of more than S rows splits into
             sub-buckets of about R rows), a bisection over the sub-bucket
             and the row record; _scan bisects to 4 rows and counts them
             (two20_16_2_scan is the port's kernel)
  port       probe_bisect through its wrapper
  floor      reads the query columns and writes an answer without
             touching the tables

beside torch.searchsorted(pk, qkey, right=True). For each B it prints
the buckets, the non-empty ones, the mean rows of a row's bucket and the
largest, the build time on the card and the bytes, and for each
two-level directory the 32-byte sectors of the tables a pair reads
(timing.probe_sectors). Median of ROUNDS
interleaved rounds of cuda_ms; everything goes to
chiprun_out/probe_sweep.json.
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
HORIZONS = ((250, 450), (1000, 10000))
PAIRS = 1 << 22
DIR_BITS = (16, 18, 20, 22)
#: (rows over which a top bucket splits again, rows a sub-bucket aims at)
TWO_LEVEL = ((16, 2), (16, 4), (32, 4))

_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Tables {
  const long long* pk;
  const uint32_t* k32;
  const int32_t* starts;
  int shift;
  long long nb;
  const int4* rows;
  const int32_t* src;
  const int32_t* dst;
  const int32_t* iv_lo;
  const int32_t* iv_hi;
  long long n;
};

struct Queries {
  const long long* qkey;
  const int32_t* q_src;
  const int32_t* q_dst;
  const int32_t* s_lo;
  const int32_t* s_hi;
  uint8_t* out;
  long long B;
};

__device__ __forceinline__ bool cols_hit(const Tables& t, const Queries& q,
                                         long long r, long long i) {
  return __ldg(t.src + r) == __ldg(q.q_src + i) &&
         __ldg(t.dst + r) == __ldg(q.q_dst + i) &&
         __ldg(t.iv_hi + r) >= __ldg(q.s_lo + i) &&
         __ldg(t.iv_lo + r) <= __ldg(q.s_hi + i);
}

__device__ __forceinline__ bool rec_hit(int4 row, int qs, int qd, int sl,
                                        int sh) {
  return row.x == qs && row.y == qd && row.w >= sl && row.z <= sh;
}

// REC: 0 four columns, 1 the row record
template <int REC>
__global__ void flat(Tables t, Queries q) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= q.B) return;
  const long long key = __ldg(q.qkey + i);
  long long lo = 0, hi = t.n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(t.pk + mid) <= key) lo = mid + 1; else hi = mid;
  }
  bool hit = false;
  if (lo >= 1) {
    if (REC) {
      const int4 row = __ldg(t.rows + lo - 1);
      hit = rec_hit(row, __ldg(q.q_src + i), __ldg(q.q_dst + i),
                    __ldg(q.s_lo + i), __ldg(q.s_hi + i));
    } else {
      hit = cols_hit(t, q, lo - 1, i);
    }
  }
  q.out[i] = hit ? 1 : 0;
}

// MODE: 0 cols, 1 rec, 2 rec with early query loads, 3 rec + scan of 4,
// 4 k32 rec, 5 k32 rec + scan of 8
template <int MODE>
__global__ void directed(Tables t, Queries q) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= q.B) return;
  const long long key = __ldg(q.qkey + i);
  int qs = 0, qd = 0, sl = 0, sh = 0;
  if (MODE == 2) {
    qs = __ldg(q.q_src + i); qd = __ldg(q.q_dst + i);
    sl = __ldg(q.s_lo + i); sh = __ldg(q.s_hi + i);
  }
  const long long k0 = __ldg(t.pk);
  unsigned long long b = 0;
  if (key >= k0) {
    b = static_cast<unsigned long long>(key >> t.shift) -
        static_cast<unsigned long long>(k0 >> t.shift);
    if (b >= static_cast<unsigned long long>(t.nb)) b = t.nb - 1;
  }
  int lo = __ldg(t.starts + b), hi = __ldg(t.starts + b + 1);
  if (MODE >= 4) {
    // the bucket fixes the high bits: a key below the first bucket sorts
    // before all its rows, one past the last after all of them
    const uint32_t qo = static_cast<uint32_t>(key & ((1LL << t.shift) - 1));
    if (key < k0) hi = lo;
    if (key >= k0 && (static_cast<unsigned long long>(key >> t.shift) -
                      static_cast<unsigned long long>(k0 >> t.shift)) >=
                         static_cast<unsigned long long>(t.nb))
      lo = hi;
    constexpr int kScan = MODE == 5 ? 8 : 0;
    while (hi - lo > kScan) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(t.k32 + mid) <= qo) lo = mid + 1; else hi = mid;
    }
    if (MODE == 5) {
      int c = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (lo + j < hi) c += __ldg(t.k32 + lo + j) <= qo;
      lo += c;
    }
  } else {
    constexpr int kScan = MODE == 3 ? 4 : 0;
    while (hi - lo > kScan) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(t.pk + mid) <= key) lo = mid + 1; else hi = mid;
    }
    if (MODE == 3) {
      int c = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (lo + j < hi) c += __ldg(t.pk + lo + j) <= key;
      lo += c;
    }
  }
  bool hit = false;
  if (lo >= 1) {
    if (MODE == 0) {
      hit = cols_hit(t, q, lo - 1, i);
    } else {
      const int4 row = __ldg(t.rows + lo - 1);
      if (MODE != 2) {
        qs = __ldg(q.q_src + i); qd = __ldg(q.q_dst + i);
        sl = __ldg(q.s_lo + i); sh = __ldg(q.s_hi + i);
      }
      hit = rec_hit(row, qs, qd, sl, sh);
    }
  }
  q.out[i] = hit ? 1 : 0;
}

// Two levels: a 16-byte entry per top bucket, {first row, end, -1, 0} or,
// for a bucket of many rows, {first row, sub-directory offset, off,
// s | m << 8}: the bucket's rows split again by (k - edge) >> s - off
// into 2^m sub-buckets, whose first rows (and the end) the sub-directory
// holds. SCAN: bisect only to 4 rows, then count them.
template <int SCAN>
__global__ void two_level(Tables t, const int4* __restrict__ top,
                          Queries q) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= q.B) return;
  const long long key = __ldg(q.qkey + i);
  const long long k0 = __ldg(t.pk);
  unsigned long long b = 0;
  if (key >= k0) {
    b = static_cast<unsigned long long>(key >> t.shift) -
        static_cast<unsigned long long>(k0 >> t.shift);
    if (b >= static_cast<unsigned long long>(t.nb)) b = t.nb - 1;
  }
  const int4 e = __ldg(top + b);
  int lo = e.x, hi = e.y;
  if (e.z >= 0) {
    const int s = e.w & 0xff, m = e.w >> 8;
    const unsigned long long edge =
        static_cast<unsigned long long>((k0 >> t.shift) + static_cast<long long>(b))
        << t.shift;
    unsigned long long sub = 0;
    if (key >= static_cast<long long>(edge)) {
      const unsigned long long u =
          (static_cast<unsigned long long>(key) - edge) >> s;
      const unsigned long long off = static_cast<unsigned>(e.z);
      const unsigned long long last = (1ull << m) - 1;
      sub = u < off ? 0 : (u - off > last ? last : u - off);
    }
    const int* subdir = t.starts + e.y + sub;
    lo = __ldg(subdir);
    hi = __ldg(subdir + 1);
  }
  constexpr int kScan = SCAN ? 4 : 0;
  while (hi - lo > kScan) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(t.pk + mid) <= key) lo = mid + 1; else hi = mid;
  }
  if (SCAN) {
    int c = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (lo + j < hi) c += __ldg(t.pk + lo + j) <= key;
    lo += c;
  }
  bool hit = false;
  if (lo >= 1) {
    const int4 row = __ldg(t.rows + lo - 1);
    hit = rec_hit(row, __ldg(q.q_src + i), __ldg(q.q_dst + i),
                  __ldg(q.s_lo + i), __ldg(q.s_hi + i));
  }
  q.out[i] = hit ? 1 : 0;
}

__global__ void floor_kernel(Queries q) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= q.B) return;
  const long long key = __ldg(q.qkey + i);
  const int v = __ldg(q.q_src + i) + __ldg(q.q_dst + i) + __ldg(q.s_lo + i) +
                __ldg(q.s_hi + i);
  q.out[i] = static_cast<uint8_t>((key + v) & 1);
}

}  // namespace

extern "C" int sweep_probe(int variant, const void* pk, const void* k32,
                           const void* starts, int shift, long long nb,
                           const void* rows, const void* src,
                           const void* dst, const void* iv_lo,
                           const void* iv_hi, long long n, const void* qkey,
                           const void* q_src, const void* q_dst,
                           const void* s_lo, const void* s_hi, void* out,
                           long long B, void* stream) {
  Tables t{static_cast<const long long*>(pk),
           static_cast<const uint32_t*>(k32),
           static_cast<const int32_t*>(starts), shift, nb,
           static_cast<const int4*>(rows), static_cast<const int32_t*>(src),
           static_cast<const int32_t*>(dst),
           static_cast<const int32_t*>(iv_lo),
           static_cast<const int32_t*>(iv_hi), n};
  Queries q{static_cast<const long long*>(qkey),
            static_cast<const int32_t*>(q_src),
            static_cast<const int32_t*>(q_dst),
            static_cast<const int32_t*>(s_lo),
            static_cast<const int32_t*>(s_hi), static_cast<uint8_t*>(out), B};
  const unsigned grid = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: flat<0><<<grid, kThreads, 0, s>>>(t, q); break;
    case 1: flat<1><<<grid, kThreads, 0, s>>>(t, q); break;
    case 10: directed<0><<<grid, kThreads, 0, s>>>(t, q); break;
    case 11: directed<1><<<grid, kThreads, 0, s>>>(t, q); break;
    case 12: directed<2><<<grid, kThreads, 0, s>>>(t, q); break;
    case 13: directed<3><<<grid, kThreads, 0, s>>>(t, q); break;
    case 14: directed<4><<<grid, kThreads, 0, s>>>(t, q); break;
    case 15: directed<5><<<grid, kThreads, 0, s>>>(t, q); break;
    case 20: two_level<0><<<grid, kThreads, 0, s>>>(
        t, static_cast<const int4*>(k32), q); break;
    case 21: two_level<1><<<grid, kThreads, 0, s>>>(
        t, static_cast<const int4*>(k32), q); break;
    case 99: floor_kernel<<<grid, kThreads, 0, s>>>(q); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_int64] + [ctypes.c_void_p] * 5 + [
    ctypes.c_int64] + [ctypes.c_void_p] * 6 + [ctypes.c_int64,
                                               ctypes.c_void_p]
_DIRECTED = {"cols": 10, "rec": 11, "early": 12, "scan": 13, "k32": 14,
             "k32scan": 15}


def probe_inputs(tmp: str):
    """{(dmin, dmax): (ProbeTables of the upload, [qkey, q_src, q_dst,
    s_lo, s_hi])} on the card: the bacterial cell's graph, its index at
    each horizon and the 2^22 pairs chip_smoke.py probes, as
    verify_batch_device hands them to probe_bisect."""
    from psi_tpu_torch.dindex import DistanceIndex
    from psi_tpu_torch.io import load_graph
    from psi_tpu_torch.ops import dindex_probe as dp
    from psi_tpu_torch.simulate import make_pangenome_graph
    from psi_tpu_torch.tools import bacterial, pairs
    from psi_tpu_torch.tools.ggsim import simulate_haplotypes

    gfa = os.path.join(tmp, "pangenome.gfa")
    bacterial.write_gfa(make_pangenome_graph(
        bacterial.REF_LEN, bacterial.VARIANT_RATE,
        seed=bacterial.GRAPH_SEED), gfa)
    graph = load_graph(gfa)
    coords = pairs.hap_coords(graph, [h for _, h in simulate_haplotypes(
        graph, 2, seed=13)])
    got, orig = {}, dp.probe_bisect
    for dmin, dmax in HORIZONS:
        idx = DistanceIndex.build(graph, dmin, dmax)
        pr = pairs.sample_pairs(coords, PAIRS, 2 * dmax, seed=dmax)
        v, o = pairs.loci(coords, pr["hap_a"], pr["pos_a"])
        u, p = pairs.loci(coords, pr["hap_b"], pr["pos_b"])
        calls = []

        def recorder(*args):
            calls.append(args)
            return orig(*args)

        recorder.launches = orig.launches      # the wrapper counts on it
        dp.probe_bisect = recorder
        try:
            idx.verify_batch_device(graph, v, o, u, p)
        finally:
            dp.probe_bisect = orig
        t, *q = calls[0]
        got[(dmin, dmax)] = (t, q)
    return got


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def main(argv=None) -> int:
    import torch

    from psi_tpu_torch.ops import dindex_probe as dp
    from psi_tpu_torch.tools import timing

    if not torch.cuda.is_available():
        print("probe_sweep: no CUDA device", file=sys.stderr)
        return 1
    out_dir = "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)
    card = timing.card_line()
    print(f"[sweep] {card}", flush=True)
    result = {"card": card, "cells": {}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        lib = timing.build_sweep(tmp, "probe_sweep", _SOURCE)
        fn = lib.sweep_probe
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        print(f"[sweep] built in {time.monotonic() - t0:.1f} s", flush=True)
        t0 = time.monotonic()
        inputs = probe_inputs(tmp)
        print(f"[sweep] inputs in {time.monotonic() - t0:.1f} s", flush=True)

    for dmin, dmax in list(inputs):
        t, q = inputs.pop((dmin, dmax))
        n, B = t.pk.numel(), q[0].numel()
        want = dp.probe_bisect_plain(t, *q)
        cols = [c.contiguous() for c in t[1:5]]
        cell = {"rows": n, "pairs": B, "accepted": int(want.sum()),
                "dirs": {}, "ms": {}}
        dev = t.pk.device
        zero = torch.zeros(1, dtype=torch.int32, device=dev)

        def runner(variant, aux=zero, starts=zero, shift=0, nb=0):
            """The sweep's entry point on this cell's tables: `aux` is the
            32-bit keys or the two-level directory's top, `starts` the key
            buckets' first rows or the sub-directories."""
            def run():
                out = torch.empty(B, dtype=torch.bool, device=dev)
                rc = fn(variant, t.pk.data_ptr(), aux.data_ptr(),
                        starts.data_ptr(), shift, nb, t.rows.data_ptr(),
                        *(c.data_ptr() for c in cols), n,
                        *(x.data_ptr() for x in q), out.data_ptr(), B,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"variant {variant}: CUDA error {rc}")
                return out
            return run

        runs = {"flat": (runner(0), True),
                "flat_rec": (runner(1), True),
                "port": (lambda: dp.probe_bisect(t, *q), True),
                "floor": (runner(99), False),
                "searchsorted": (lambda: torch.searchsorted(
                    t.pk, q[0], right=True), False)}
        for bits in DIR_BITS:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            starts, shift = dp.key_buckets(t.pk, bits)
            torch.cuda.synchronize()
            build_ms = 1e3 * (time.monotonic() - t0)
            sizes = starts.diff()
            full = sizes[sizes > 0].double()
            starts = starts.to(torch.int32)
            nb = starts.numel() - 1
            k32 = None
            if shift <= 32:
                k32 = (t.pk & ((1 << shift) - 1)).to(torch.int64)
                k32 = torch.where(k32 >= 1 << 31, k32 - (1 << 32),
                                  k32).to(torch.int32)
            info = cell["dirs"][bits] = {
                "shift": shift, "buckets": nb, "nonempty": full.numel(),
                "rows_per_row_bucket": float((full * full).sum()
                                             / full.sum()),
                "largest": int(full.max()), "build_ms": build_ms,
                "bytes": starts.numel() * 4}
            print(f"[sweep] ({dmin}, {dmax}) dir{bits}: shift {shift}, {nb} "
                  f"buckets, {full.numel()} non-empty, mean rows of a row's "
                  f"bucket {info['rows_per_row_bucket']:.1f}, largest "
                  f"{info['largest']}; built in {build_ms:.2f} ms, "
                  f"{info['bytes'] / 1e6:.2f} MB", flush=True)
            for name, variant in _DIRECTED.items():
                if name.startswith("k32") and k32 is None:
                    continue
                if bits != 20 and name not in ("rec", "k32", "k32scan"):
                    continue
                runs[f"dir{bits}_{name}"] = (runner(
                    variant, zero if k32 is None else k32, starts, shift,
                    nb), True)
            for split, per in TWO_LEVEL:
                torch.cuda.synchronize()
                t0 = time.monotonic()
                top, sub, _ = dp.directory(t.pk, bits, split, per)
                torch.cuda.synchronize()
                two = dp.ProbeTables(*t[:6], top=top, sub=sub, shift=shift)
                info[f"two_{split}_{per}"] = {
                    "build_ms": 1e3 * (time.monotonic() - t0),
                    "top_bytes": top.numel() * 4,
                    "sub_bytes": sub.numel() * 4,
                    "split": int((top[:, 2] >= 0).sum()),
                    "sectors_per_pair": timing.probe_sectors(two, q[0])}
                print(f"[sweep] ({dmin}, {dmax}) two{bits}_{split}_{per}: "
                      f"{info[f'two_{split}_{per}']}", flush=True)
                for scan in (0, 1):
                    runs[f"two{bits}_{split}_{per}"
                         + ("_scan" if scan else "")] = (runner(
                             20 + scan, top, sub, shift, top.shape[0]), True)
        for name, (run, exact) in runs.items():
            got = run()
            torch.cuda.synchronize()
            if exact and not torch.equal(got, want):
                raise RuntimeError(f"({dmin}, {dmax}) {name} differs from "
                                   f"probe_bisect_plain")
        times = {name: [] for name in runs}
        for _ in range(ROUNDS):
            for name, (run, _) in runs.items():
                times[name].append(timing.cuda_ms(run, REPS))
        for name, ts in times.items():
            cell["ms"][name] = _median(ts)
            print(f"[sweep] ({dmin}, {dmax}) {name}: "
                  f"{1e3 * _median(ts):.3f} us (rounds "
                  f"{', '.join(f'{1e3 * x:.3f}' for x in ts)})", flush=True)
        result["cells"][f"{dmin},{dmax}"] = cell
        del t, q, runs, want, cols
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, "probe_sweep.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
