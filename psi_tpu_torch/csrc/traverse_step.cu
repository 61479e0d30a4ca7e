// One step of the exact off-path frontier traversal in one launch: the
// fork over the graph's edges, the label char, the rank over the seeds
// index and the order-keeping compaction of the survivors
// (ops/traverse.py traverse_step; its plain version traverse_step_plain).
//
// It replaces the ~45 torch operations of traverse_device's step: _fork's
// cumsum, searchsorted and clipped gathers, _label, the one-char rank,
// and the second cumsum + searchsorted compaction. It has no TPU kernel: psi_tpu's
// _range_refine (psi_tpu/ops/traverse.py:230) and traverse_device (:267)
// are plain XLA.
//
// The contract is the plain step's, bit for bit over the whole cap:
//   * parent slot s < n_used forks into count children (1 mid-node, its
//     outdegree at a node end), placed in parent order, then child order;
//     children at slots >= cap are dropped (the step then overflows);
//   * a child takes one label char: 'N' kills it, else [lo, hi) narrows
//     by the char (seeds_rank.cuh) and an empty range kills it;
//   * the survivors fill slots [0, n2) in that order; every slot of
//     [n2, cap) holds the "padding record", the values of child slot
//     cap - 1 (the plain version's searchsorted clamps there). Its parent
//     is the parent whose children cover slot cap - 1 when new_n >= cap,
//     else parent slot cap - 1, whose values the previous step's padding
//     record set when it is not in use;
//   * new_n, n2, overflow |= new_n > cap and the TraverserStats
//     increments (attempted = min(new_n, cap), ended, ended * (t + 1),
//     int64) stay on the device, and n_used is read from the device, so
//     the k steps of a traversal queue with no host sync.
// Every clip of the plain version is kept, so padding parents gather in
// bounds and compute what the plain version computes.
//
// Design (the scan, look-back, barrier and launch in step_scan.cuh). A
// persistent cooperative grid (as many blocks as fit on the card at
// once, at most one per 256-slot tile of the cap) takes tiles of
// 256 parent slots by an atomic ticket, up to the last tile with a live
// parent (n_used read on the device); one thread per parent slot. Per
// tile: the block scans the children counts and finds the children's
// global prefix by decoupled look-back (a 64-bit descriptor per tile:
// 2 status bits, 62 value bits); each thread then forms its children
// (node, offset, label, rank), keeping the first four in registers; a
// second block scan and look-back over the survivors gives each thread
// its first output slot, and it writes its survivors there. The tickets
// hand out tiles in order, so a look-back only waits on tiles that have
// started and never on one that is queued. Then one grid barrier: the
// totals and the padding record are known, every block fills its share
// of [n2, cap) with the record, the descriptors and the ticket are reset
// to 0 for the next launch, and block 0 writes the counts. The two
// cumsum + searchsorted passes and the parent -> child searchsorted of
// the plain step are gone; nothing is materialised at the cap but the
// state itself.
//
// What bounds it on an H100: 20 bytes read per live parent (locus, node,
// offset, lo, hi) and 20 bytes written per survivor; the state's padding
// slots are 20 bytes each more, since the contract writes the whole cap.
// The graph arrays and the seeds index (~7.5 MB for a 100 K-read chunk)
// stay in the 50 MB L2 and are not counted, as for range_refine4. That is
// a few MB at 10^5-10^6 live states, about a microsecond at 3.35 TB/s,
// so a step is bound by its dependent gathers (parent, edge, label, two
// rank blocks), the two look-back chains and the grid barrier, not by
// bytes; the design keeps to one pass over the live frontier and one
// launch per step.

#include <cstdint>
#include <cuda_runtime.h>

#include "seeds_rank.cuh"
#include "step_scan.cuh"

namespace {

constexpr int kKeep = 4;  // children a thread keeps in registers

struct StateIn {
  const int32_t* locus;
  const int32_t* node;
  const int32_t* off;
  const int32_t* lo;
  const int32_t* hi;
};

struct StateOut {
  int32_t* locus;
  int32_t* node;
  int32_t* off;
  int32_t* lo;
  int32_t* hi;
};

using Scratch = StepScratch<5>;

struct Child {
  int32_t node, off, lo, hi;  // off already advanced past the char
  bool ok;
};

// Child j of a parent at (node, off) with range [lo, hi), as the plain
// step forms it: the edge index and the label position clipped.
__device__ __forceinline__ Child make_child(const GraphArgs& g,
                                            const int4* __restrict__ occ_d,
                                            const int2* __restrict__ planes_d,
                                            int32_t pnode, int32_t poff,
                                            bool at_end, long long j,
                                            int32_t plo, int32_t phi) {
  int32_t nb = 0;
  if (g.n_edges > 0) {
    const long long e = __ldg(g.indptr + max(pnode, 1) - 1) + j;
    nb = __ldg(g.indices + min(max(e, 0LL), (long long)g.n_edges - 1));
  }
  Child ch;
  ch.node = at_end ? nb : pnode;
  const int32_t coff = at_end ? 0 : poff;
  const int32_t pos = min(max(__ldg(g.loff + max(ch.node, 1) - 1) + coff, 0),
                          g.n_labels - 1);
  const int c = __ldg(g.labels + pos);
  const int2 r = seeds_refine(occ_d, planes_d, plo, phi, min(max(c, 0), 3));
  ch.off = coff + 1;
  ch.lo = r.x;
  ch.hi = r.y;
  ch.ok = c < 4 && r.x < r.y;
  return ch;
}

// A parent slot's values and its children count (0 when not in use).
struct Parent {
  int32_t locus, node, off, lo, hi;
  bool at_end;
  int count;
};

__device__ __forceinline__ Parent load_parent(const GraphArgs& g,
                                              const StateIn& st, long long s,
                                              bool in_use) {
  Parent p;
  p.locus = __ldg(st.locus + s);
  p.node = __ldg(st.node + s);
  p.off = __ldg(st.off + s);
  p.lo = __ldg(st.lo + s);
  p.hi = __ldg(st.hi + s);
  const int32_t sn = max(p.node, 1);
  const int32_t len = __ldg(g.loff + sn) - __ldg(g.loff + sn - 1);
  p.at_end = in_use && p.off >= len;
  const int32_t outdeg = __ldg(g.indptr + sn) - __ldg(g.indptr + sn - 1);
  p.count = in_use ? (p.at_end ? outdeg : 1) : 0;
  return p;
}

__device__ __forceinline__ void write_slot(const StateOut& out, long long s,
                                           int32_t locus, int32_t node,
                                           int32_t off, int32_t lo,
                                           int32_t hi) {
  out.locus[s] = locus;
  out.node[s] = node;
  out.off[s] = off;
  out.lo[s] = lo;
  out.hi[s] = hi;
}

__global__ void __launch_bounds__(kThreads)
    traverse_step_kernel(GraphArgs g, const int4* __restrict__ occ_d,
                         const int2* __restrict__ planes_d, StateIn st,
                         const long long* __restrict__ n_used_p,
                         const bool* __restrict__ overflow_in,
                         const long long* __restrict__ tstats_in,
                         StateOut out, long long* __restrict__ counts,
                         bool* __restrict__ overflow_out, Scratch* scr,
                         unsigned long long* desc_a,
                         unsigned long long* desc_b, int cap, int depth) {
  __shared__ int warp_sums[kWarps];
  __shared__ int tile_s;
  __shared__ long long prefix_s;
  __shared__ int32_t pad_s[5];
  // slots past the cap are never in use, whatever the scalar says
  const long long n_used =
      min(max(*n_used_p, 0LL), static_cast<long long>(cap));
  const int ntiles = static_cast<int>((n_used + kThreads - 1) / kThreads);

  for (;;) {
    if (threadIdx.x == 0) {
      tile_s = static_cast<int>(atomicAdd(&scr->ticket, 1u));
    }
    __syncthreads();
    const int tile = tile_s;
    if (tile >= ntiles) break;
    const long long s = static_cast<long long>(tile) * kThreads + threadIdx.x;
    const bool in_use = s < n_used;
    Parent p{};
    if (in_use) p = load_parent(g, st, s, true);

    // the children's slots: block scan, then the look-back over tiles
    int tile_children;
    const int cexcl = block_exclusive_scan(p.count, warp_sums, tile_children);
    if (threadIdx.x < 32) {
      const long long pre = look_back(desc_a, tile, tile_children);
      if (threadIdx.x == 0) prefix_s = pre;
    }
    __syncthreads();
    const long long base = prefix_s + cexcl;
    const int nchild = static_cast<int>(
        min(static_cast<long long>(p.count), max(0LL, cap - base)));

    // pass 1: form the children in slot order, count the survivors
    Child kept[kKeep];
    unsigned ok_bits = 0;
    int surv = 0;
#pragma unroll
    for (int j = 0; j < kKeep; ++j) {
      if (j < nchild) {
        kept[j] = make_child(g, occ_d, planes_d, p.node, p.off, p.at_end, j,
                             p.lo, p.hi);
        ok_bits |= static_cast<unsigned>(kept[j].ok) << j;
        surv += kept[j].ok;
        if (base + j == cap - 1) {
          const int32_t v[5] = {p.locus, kept[j].node, kept[j].off,
                                kept[j].lo, kept[j].hi};
          for (int f = 0; f < 5; ++f) scr->pad[f] = v[f];
          __threadfence();
        }
      }
    }
    for (int j = kKeep; j < nchild; ++j) {
      const Child ch = make_child(g, occ_d, planes_d, p.node, p.off,
                                  p.at_end, j, p.lo, p.hi);
      surv += ch.ok;
      if (base + j == cap - 1) {
        const int32_t v[5] = {p.locus, ch.node, ch.off, ch.lo, ch.hi};
        for (int f = 0; f < 5; ++f) scr->pad[f] = v[f];
        __threadfence();
      }
    }

    // the survivors' slots: block scan, then the look-back over tiles
    int tile_surv;
    const int sexcl = block_exclusive_scan(surv, warp_sums, tile_surv);
    if (threadIdx.x < 32) {
      const long long pre = look_back(desc_b, tile, tile_surv);
      if (threadIdx.x == 0) {
        prefix_s = pre;
        if (tile == ntiles - 1) {  // thread 0's base is the tile's prefix
          scr->totals[0] = base + tile_children;
          scr->totals[1] = pre + tile_surv;
          __threadfence();
        }
      }
    }
    __syncthreads();

    // pass 2: write the survivors
    long long o = prefix_s + sexcl;
#pragma unroll
    for (int j = 0; j < kKeep; ++j) {
      if ((ok_bits >> j) & 1u) {
        write_slot(out, o++, p.locus, kept[j].node, kept[j].off, kept[j].lo,
                   kept[j].hi);
      }
    }
    for (int j = kKeep; j < nchild; ++j) {
      const Child ch = make_child(g, occ_d, planes_d, p.node, p.off,
                                  p.at_end, j, p.lo, p.hi);
      if (ch.ok) write_slot(out, o++, p.locus, ch.node, ch.off, ch.lo, ch.hi);
    }
    __syncthreads();
  }

  grid_barrier(scr);
  const volatile long long* totals = scr->totals;
  const long long new_n = ntiles ? totals[0] : 0;
  const long long n2 = ntiles ? totals[1] : 0;
  if (threadIdx.x == 0) {
    if (new_n >= cap) {
      const volatile int32_t* pad = scr->pad;
      for (int f = 0; f < 5; ++f) pad_s[f] = pad[f];
    } else {
      // child slot cap - 1 is past new_n: its parent is slot cap - 1
      const long long s = cap - 1;
      const Parent p = load_parent(g, st, s, s < n_used);
      const Child ch = make_child(g, occ_d, planes_d, p.node, p.off, p.at_end,
                                  s - (new_n - p.count), p.lo, p.hi);
      const int32_t v[5] = {p.locus, ch.node, ch.off, ch.lo, ch.hi};
      for (int f = 0; f < 5; ++f) pad_s[f] = v[f];
    }
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  for (long long s = n2 + first; s < cap; s += stride) {
    write_slot(out, s, pad_s[0], pad_s[1], pad_s[2], pad_s[3], pad_s[4]);
  }
  for (long long i = first; i < ntiles; i += stride) {
    desc_a[i] = 0;
    desc_b[i] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scr->ticket = 0;
    const long long attempted = min(new_n, static_cast<long long>(cap));
    const long long ended = attempted - n2;
    counts[0] = new_n;
    counts[1] = n2;
    counts[2] = tstats_in[0] + attempted;
    counts[3] = tstats_in[1] + ended;
    counts[4] = tstats_in[2] + ended * (depth + 1);
    *overflow_out = *overflow_in || new_n > cap;
  }
}

int g_grid[kMaxDevices];  // co-resident blocks per device, 0 = not asked yet

}  // namespace

// Bytes of scratch a launch at `cap` needs (step_scan.cuh).
extern "C" long long psi_traverse_step_scratch_bytes(int cap) {
  return step_scratch_bytes(cap);
}

extern "C" int psi_traverse_step(
    const void* labels, int n_labels, const void* loff, const void* indptr,
    const void* indices, int n_edges, const void* occ, const void* planes,
    int rows, int depth, const void* locus, const void* node,
    const void* off, const void* lo, const void* hi, const void* n_used,
    const void* overflow_in, const void* tstats_in, void* out, void* counts,
    void* overflow_out, void* scratch, int cap, void* stream) {
  const long long tiles = step_tiles(cap);
  const size_t at = static_cast<size_t>(depth) * rows;
  GraphArgs g{static_cast<const int32_t*>(labels),
              static_cast<const int32_t*>(loff),
              static_cast<const int32_t*>(indptr),
              static_cast<const int32_t*>(indices), n_labels, n_edges};
  const int4* occ_d = static_cast<const int4*>(occ) + at;
  const int2* planes_d = static_cast<const int2*>(planes) + at;
  StateIn st{static_cast<const int32_t*>(locus),
             static_cast<const int32_t*>(node),
             static_cast<const int32_t*>(off),
             static_cast<const int32_t*>(lo),
             static_cast<const int32_t*>(hi)};
  int32_t* o = static_cast<int32_t*>(out);
  StateOut so{o, o + cap, o + 2LL * cap, o + 3LL * cap, o + 4LL * cap};
  const long long* n_used_p = static_cast<const long long*>(n_used);
  const bool* ov_in = static_cast<const bool*>(overflow_in);
  const long long* ts_in = static_cast<const long long*>(tstats_in);
  long long* cnt = static_cast<long long*>(counts);
  bool* ov_out = static_cast<bool*>(overflow_out);
  Scratch* scr = static_cast<Scratch*>(scratch);
  unsigned long long* desc_a = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + 64);
  unsigned long long* desc_b = desc_a + tiles;
  void* args[] = {&g, &occ_d, &planes_d, &st, &n_used_p, &ov_in, &ts_in,
                  &so, &cnt, &ov_out, &scr, &desc_a, &desc_b, &cap, &depth};
  return step_launch(traverse_step_kernel, g_grid, cap, args, stream);
}
