// One step of the mismatch-tolerant off-path frontier traversal in one
// launch, after range_refine4 (range_refine.cu) has ranked the parents:
// the fork over the graph's edges, the label char, the fork over the
// four read chars under a mismatch budget, and the order-keeping
// compaction of the survivors (ops/traverse.py traverse_step_approx; its
// plain version traverse_step_approx_plain).
//
// It replaces the ~96 torch operations of traverse_device_approx's step
// around its range_refine4 launch: _fork's cumsum, searchsorted and
// clipped gathers, _label, the cost and budget mask, the second cumsum
// and searchsorted, and the child select by an exclusive cumsum over a
// [cap, 4] mask and an argmax. It has no TPU kernel: psi_tpu's
// traverse_device_approx (psi_tpu/ops/traverse.py) is plain XLA.
//
// The contract is the plain step's, bit for bit over the whole cap:
//   * parent slot s < n_used forks into count graph children (1
//     mid-node, its outdegree at a node end), placed in parent order,
//     then edge order; graph children at slots >= cap are dropped (the
//     step then overflows);
//   * a graph child takes one label char: 'N' kills it; else it forks
//     into a child per read char c = 0..3 whose range [lo4[c], hi4[c]) is
//     not empty and whose cost (c != label) the parent's budget covers.
//     lo4 and hi4 are the parent's row of range_refine4 over the parent
//     state: every graph child inherits its parent's [lo, hi), so that
//     row is what the plain step ranks at each of its children;
//   * the survivors fill slots [0, min(n2, cap)) in (graph child, char)
//     order, each (locus, node, off + 1, lo4[c], hi4[c], budget - cost);
//     survivors at slots >= cap are dropped. Every slot of [n2, cap)
//     holds the "padding record", the values of graph child slot cap - 1
//     with char 0 (the plain version's searchsorted clamps there and its
//     select finds no char). Its parent is the parent whose children
//     cover slot cap - 1 when new_n >= cap, else parent slot cap - 1,
//     whose values the previous step's padding record set when it is not
//     in use;
//   * new_n, n2 and overflow |= new_n > cap | n2 > cap stay on the
//     device, and n_used is read from the device, so the k steps of a
//     traversal queue with no host sync.
// Every clip of the plain version is kept, so padding parents gather in
// bounds and compute what the plain version computes.
//
// Design: that of traverse_step.cu, with its block scan, look-back, grid
// barrier and launch (step_scan.cuh). A persistent cooperative grid (as
// many blocks as fit on the card at once, at most one per 256-slot tile
// of the cap) takes tiles of 256 parent slots by an atomic ticket, up to
// the last tile with a live parent (n_used read on the device); one
// thread per parent slot. Per tile: a block scan of the graph children
// counts and a decoupled look-back across tiles (a 64-bit descriptor per
// tile: 2 status bits, 62 value bits) give each thread its first graph
// child slot; each thread forms its graph children (node, offset, label)
// and their four-bit survivor masks against its lo4 / hi4 row, keeping
// the first four in registers; a second block scan and look-back over
// the survivor counts gives each thread its first output slot, and it
// writes its survivors there. The tickets hand out tiles in order, so a
// look-back only waits on tiles that have started. Then one grid
// barrier: the totals and the padding record are known, every block
// fills its share of [n2, cap) with the record, the descriptors and the
// ticket are reset to 0 for the next launch, and block 0 writes the
// counts. No [cap, 4] array is built, and the char select needs no scan:
// a thread walks its own mask.
//
// What bounds it on an H100: per live parent its 24 bytes of state
// (locus, node, offset, budget here; range_refine4 reads its lo and hi)
// and its 32-byte lo4 / hi4 row read, 24 bytes written per survivor; the
// padding slots, 24 bytes each, come on top, since the contract writes
// the whole cap. The graph arrays stay in the 50 MB L2 and are not
// counted. At the 10^4-10^5 live parents of a chunk that is a few MB,
// about a microsecond at 3.35 TB/s, so a step is bound by its dependent
// gathers (parent, edge, label, the lo4 / hi4 row), the two look-back
// chains and the grid barrier; the design keeps to one pass over the
// live frontier and one launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "step_scan.cuh"

namespace {

constexpr int kKeep = 4;    // graph children a thread keeps in registers
constexpr int kFields = 6;  // locus, node, off, lo, hi, budget

struct StateIn {
  const int32_t* locus;
  const int32_t* node;
  const int32_t* off;
  const int32_t* budget;
  const int4* lo4;  // range_refine4 of the parent's [lo, hi), per char
  const int4* hi4;
};

struct StateOut {
  int32_t* f[kFields];  // locus, node, off, lo, hi, budget
};

using Scratch = StepScratch<kFields>;

// A graph child: its node, the offset of its label char, and that char.
struct Child {
  int32_t node, off;
  int c;
};

// Graph child j of a parent at (node, off), as the plain step forms it:
// the edge index and the label position clipped.
__device__ __forceinline__ Child make_child(const GraphArgs& g,
                                            int32_t pnode, int32_t poff,
                                            bool at_end, long long j) {
  int32_t nb = 0;
  if (g.n_edges > 0) {
    const long long e = __ldg(g.indptr + max(pnode, 1) - 1) + j;
    nb = __ldg(g.indices + min(max(e, 0LL), (long long)g.n_edges - 1));
  }
  Child ch;
  ch.node = at_end ? nb : pnode;
  ch.off = at_end ? 0 : poff;
  const int32_t pos = min(max(__ldg(g.loff + max(ch.node, 1) - 1) + ch.off, 0),
                          g.n_labels - 1);
  ch.c = __ldg(g.labels + pos);
  return ch;
}

__device__ __forceinline__ int lane_of(const int4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The char that costs nothing at label c ('N' clipped to 3, as the plain
// version clips it).
__device__ __forceinline__ int free_char(int c) { return min(max(c, 0), 3); }

// Bit c set iff the child for read char c survives: the label is not 'N',
// the char's range is not empty and the budget covers its cost.
__device__ __forceinline__ unsigned survivors(int c, const int4& l4,
                                              const int4& h4, int32_t budget) {
  if (c >= 4) return 0u;
  const int fc = free_char(c);
  unsigned m = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool ok = lane_of(l4, r) < lane_of(h4, r) && budget >= (r != fc);
    m |= static_cast<unsigned>(ok) << r;
  }
  return m;
}

// A parent slot's values and its graph children count (0 when not in use).
struct Parent {
  int32_t locus, node, off, budget;
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
  p.budget = __ldg(st.budget + s);
  const int32_t sn = max(p.node, 1);
  const int32_t len = __ldg(g.loff + sn) - __ldg(g.loff + sn - 1);
  p.at_end = in_use && p.off >= len;
  const int32_t outdeg = __ldg(g.indptr + sn) - __ldg(g.indptr + sn - 1);
  p.count = in_use ? (p.at_end ? outdeg : 1) : 0;
  return p;
}

__device__ __forceinline__ void write_slot(const StateOut& out, long long s,
                                           const int32_t (&v)[kFields]) {
#pragma unroll
  for (int f = 0; f < kFields; ++f) out.f[f][s] = v[f];
}

// The record of the child of graph child ch for read char r.
__device__ __forceinline__ void child_record(const Parent& p, const Child& ch,
                                             const int4& l4, const int4& h4,
                                             int r, int32_t (&v)[kFields]) {
  v[0] = p.locus;
  v[1] = ch.node;
  v[2] = ch.off + 1;
  v[3] = lane_of(l4, r);
  v[4] = lane_of(h4, r);
  v[5] = p.budget - (r != free_char(ch.c));
}

__global__ void __launch_bounds__(kThreads)
    traverse_step_approx_kernel(GraphArgs g, StateIn st,
                                const long long* __restrict__ n_used_p,
                                const bool* __restrict__ overflow_in,
                                StateOut out, long long* __restrict__ counts,
                                bool* __restrict__ overflow_out, Scratch* scr,
                                unsigned long long* desc_a,
                                unsigned long long* desc_b, int cap) {
  __shared__ long long warp_sums[kWarps];
  __shared__ int tile_s;
  __shared__ long long prefix_s;
  __shared__ int32_t pad_s[kFields];
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

    // the graph children's slots: block scan, then the look-back
    long long tile_children;
    const long long cexcl = block_exclusive_scan<long long>(
        p.count, warp_sums, tile_children);
    if (threadIdx.x < 32) {
      const long long pre = look_back(desc_a, tile, tile_children);
      if (threadIdx.x == 0) prefix_s = pre;
    }
    __syncthreads();
    const long long base = prefix_s + cexcl;
    const int nchild = static_cast<int>(
        min(static_cast<long long>(p.count), max(0LL, cap - base)));
    int4 l4 = make_int4(0, 0, 0, 0), h4 = l4;
    if (nchild > 0) {
      l4 = __ldg(st.lo4 + s);
      h4 = __ldg(st.hi4 + s);
    }

    // pass 1: form the graph children in slot order, count the survivors
    Child kept[kKeep];
    unsigned masks = 0;  // 4 bits a kept child
    long long surv = 0;
#pragma unroll
    for (int j = 0; j < kKeep; ++j) {
      if (j < nchild) {
        kept[j] = make_child(g, p.node, p.off, p.at_end, j);
        const unsigned m = survivors(kept[j].c, l4, h4, p.budget);
        masks |= m << (4 * j);
        surv += __popc(m);
        if (base + j == cap - 1) {
          int32_t v[kFields];
          child_record(p, kept[j], l4, h4, 0, v);
          for (int f = 0; f < kFields; ++f) scr->pad[f] = v[f];
          __threadfence();
        }
      }
    }
    for (int j = kKeep; j < nchild; ++j) {
      const Child ch = make_child(g, p.node, p.off, p.at_end, j);
      surv += __popc(survivors(ch.c, l4, h4, p.budget));
      if (base + j == cap - 1) {
        int32_t v[kFields];
        child_record(p, ch, l4, h4, 0, v);
        for (int f = 0; f < kFields; ++f) scr->pad[f] = v[f];
        __threadfence();
      }
    }

    // the survivors' slots: block scan, then the look-back
    long long tile_surv;
    const long long sexcl = block_exclusive_scan(surv, warp_sums, tile_surv);
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

    // pass 2: write the survivors that fall inside the cap
    long long o = prefix_s + sexcl;
    int32_t v[kFields];
#pragma unroll
    for (int j = 0; j < kKeep; ++j) {
      const unsigned m = (masks >> (4 * j)) & 0xfu;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if ((m >> r) & 1u) {
          if (o < cap) {
            child_record(p, kept[j], l4, h4, r, v);
            write_slot(out, o, v);
          }
          ++o;
        }
      }
    }
    for (int j = kKeep; j < nchild && o < cap; ++j) {
      const Child ch = make_child(g, p.node, p.off, p.at_end, j);
      const unsigned m = survivors(ch.c, l4, h4, p.budget);
      for (int r = 0; r < 4; ++r) {
        if ((m >> r) & 1u) {
          if (o < cap) {
            child_record(p, ch, l4, h4, r, v);
            write_slot(out, o, v);
          }
          ++o;
        }
      }
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
      for (int f = 0; f < kFields; ++f) pad_s[f] = pad[f];
    } else {
      // graph child slot cap - 1 is past new_n: its parent is slot cap - 1
      const long long s = cap - 1;
      const Parent p = load_parent(g, st, s, s < n_used);
      const Child ch = make_child(g, p.node, p.off, p.at_end,
                                  s - (new_n - p.count));
      int32_t v[kFields];
      child_record(p, ch, __ldg(st.lo4 + s), __ldg(st.hi4 + s), 0, v);
      for (int f = 0; f < kFields; ++f) pad_s[f] = v[f];
    }
  }
  __syncthreads();
  int32_t pv[kFields];
#pragma unroll
  for (int f = 0; f < kFields; ++f) pv[f] = pad_s[f];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  for (long long s = n2 + first; s < cap; s += stride) write_slot(out, s, pv);
  for (long long i = first; i < ntiles; i += stride) {
    desc_a[i] = 0;
    desc_b[i] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scr->ticket = 0;
    counts[0] = new_n;
    counts[1] = n2;
    *overflow_out = *overflow_in || new_n > cap || n2 > cap;
  }
}

int g_grid[kMaxDevices];  // co-resident blocks per device, 0 = not asked yet

}  // namespace

// Bytes of scratch a launch at `cap` needs (step_scan.cuh).
extern "C" long long psi_traverse_step_approx_scratch_bytes(int cap) {
  return step_scratch_bytes(cap);
}

extern "C" int psi_traverse_step_approx(
    const void* labels, int n_labels, const void* loff, const void* indptr,
    const void* indices, int n_edges, const void* locus, const void* node,
    const void* off, const void* budget, const void* lo4, const void* hi4,
    const void* n_used, const void* overflow_in, void* out, void* counts,
    void* overflow_out, void* scratch, int cap, void* stream) {
  const long long tiles = step_tiles(cap);
  GraphArgs g{static_cast<const int32_t*>(labels),
              static_cast<const int32_t*>(loff),
              static_cast<const int32_t*>(indptr),
              static_cast<const int32_t*>(indices), n_labels, n_edges};
  StateIn st{static_cast<const int32_t*>(locus),
             static_cast<const int32_t*>(node),
             static_cast<const int32_t*>(off),
             static_cast<const int32_t*>(budget),
             static_cast<const int4*>(lo4), static_cast<const int4*>(hi4)};
  int32_t* o = static_cast<int32_t*>(out);
  StateOut so;
  for (int f = 0; f < kFields; ++f) {
    so.f[f] = o + f * static_cast<long long>(cap);
  }
  const long long* n_used_p = static_cast<const long long*>(n_used);
  const bool* ov_in = static_cast<const bool*>(overflow_in);
  long long* cnt = static_cast<long long*>(counts);
  bool* ov_out = static_cast<bool*>(overflow_out);
  Scratch* scr = static_cast<Scratch*>(scratch);
  unsigned long long* desc_a = reinterpret_cast<unsigned long long*>(
      static_cast<char*>(scratch) + 64);
  unsigned long long* desc_b = desc_a + tiles;
  void* args[] = {&g, &st, &n_used_p, &ov_in, &so, &cnt, &ov_out, &scr,
                  &desc_a, &desc_b, &cap};
  return step_launch(traverse_step_approx_kernel, g_grid, cap, args,
                     stream);
}
