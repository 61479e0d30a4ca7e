// psi_haplotyper — native path picking (haplotype enumeration + patches).
//
// Exact port of the diversity-seeking Global haplotyper and the patched
// path generator (semantics mirror psi_tpu/graphiter.py::HaplotyperIter
// and psi_tpu/pathset.py::get_uniq_patches, which in turn mirror
// ref: include/psi/graph_iter.hpp:537-731 and pathindex.hpp:450-605).
// Random tie-breaks are delegated to a caller-provided callback so a
// NumPy RandomState drives both the native and the Python implementation
// with identical draw sequences — enabling exact-output parity tests.

#include <algorithm>
#include <cstdint>
#include <deque>
#include <unordered_map>
#include <vector>

namespace {

typedef int64_t (*rand_fn_t)(int64_t n);  // uniform draw in [0, n)

struct GraphView {
  int64_t n;
  const int64_t* node_len;
  const int64_t* indptr;
  const int64_t* indices;

  int64_t outdeg(int64_t v) const { return indptr[v] - indptr[v - 1]; }
  int64_t out(int64_t v, int64_t j) const { return indices[indptr[v - 1] + j]; }
};

// --- Path with partial head/tail offsets (mirror of pathutil.Path) ---------

struct Path {
  const GraphView* g;
  std::deque<int64_t> nodes;
  int64_t left = 0;   // included suffix length of first node (0 = whole)
  int64_t right = 0;  // included prefix length of last node (0 = whole)
  int64_t seqlen = 0;

  bool empty() const { return nodes.empty(); }
  int64_t front() const { return nodes.front(); }
  int64_t back() const { return nodes.back(); }

  int64_t get_left_len() const {
    return left ? left : g->node_len[front() - 1];
  }
  int64_t get_right_len() const {
    return right ? right : g->node_len[back() - 1];
  }
  int64_t seqlen_head() const {
    if (empty()) return 0;
    if (nodes.size() == 1) return seqlen;
    return get_left_len();
  }
  int64_t seqlen_tail() const {
    if (empty()) return 0;
    if (nodes.size() == 1) return seqlen;
    return get_right_len();
  }
  int64_t head_offset() const {
    if (left == 0) return 0;
    return g->node_len[front() - 1] - left;
  }

  void set_left_by_len(int64_t value) {
    int64_t front_len = g->node_len[front() - 1];
    if (value > front_len || value == 0) value = front_len;
    int64_t diff = value - get_left_len();
    if (diff == 0) return;
    seqlen += diff;
    left = (value == front_len) ? 0 : value;
  }
  void set_right_by_len(int64_t value) {
    int64_t back_len = g->node_len[back() - 1];
    if (value > back_len || value == 0) value = back_len;
    int64_t diff = value - get_right_len();
    if (diff == 0) return;
    seqlen += diff;
    right = (value == back_len) ? 0 : value;
  }

  void push_back_full(int64_t nid) {
    if (right != 0) set_right_by_len(0);
    nodes.push_back(nid);
    seqlen += g->node_len[nid - 1];
  }
  // later-node partial push: noff = included prefix length
  void push_back_off(int64_t nid, int64_t noff) {
    bool first = empty();
    int64_t nlen = g->node_len[nid - 1];
    if (noff < 0) noff = 0;
    if (first) {
      if (noff >= nlen) noff = nlen - 1;
      nodes.push_back(nid);
      seqlen += nlen - noff;
      left = noff ? seqlen : 0;
    } else {
      if (right != 0) set_right_by_len(0);
      if (noff > nlen || noff == 0) noff = nlen;
      nodes.push_back(nid);
      seqlen += noff;
      right = (noff == nlen) ? 0 : noff;
    }
  }
  void pop_back() {
    if (empty()) return;
    seqlen -= seqlen_tail();
    nodes.pop_back();
    right = 0;
    if (empty()) left = 0;
  }
  void pop_front() {
    if (empty()) return;
    seqlen -= seqlen_head();
    nodes.pop_front();
    left = 0;
    if (empty()) right = 0;
  }
  void clear() {
    nodes.clear();
    left = right = 0;
    seqlen = 0;
  }
};

// trims (mirror of pathutil trims / ref path_interface.hpp:338-482)
static void trim_front_to(Path& p, int64_t node_id) {
  while (!p.empty()) {
    bool found = (node_id == 0 || p.front() == node_id);
    p.pop_front();
    if (found) break;
  }
}
static void ltrim_front_by_len(Path& p, int64_t k, bool hard) {
  if (p.nodes.size() < 2) return;
  while (!p.empty() &&
         p.seqlen - p.seqlen_head() - p.seqlen_tail() >= k - 1)
    p.pop_front();
  if (!p.empty() && hard)
    p.set_left_by_len(k - 1 + p.seqlen_tail() + p.seqlen_head() - p.seqlen);
}
static void rtrim_front_by_len(Path& p, int64_t k, bool hard) {
  while (!p.empty() && p.seqlen - p.seqlen_head() >= k) p.pop_front();
  if (!p.empty() && hard)
    p.set_left_by_len(k + p.seqlen_head() - p.seqlen);
}

// extend with partial offsets (mirror of pathutil.extend /
// ref path_interface.hpp:94-113)
static void extend_path(Path& dst, const Path& other) {
  if (other.empty()) return;
  if (dst.empty())
    dst.push_back_off(other.front(), other.head_offset());
  else
    dst.push_back_full(other.front());
  if (other.nodes.size() > 1) {
    for (size_t i = 1; i + 1 < other.nodes.size(); ++i)
      dst.push_back_full(other.nodes[i]);
    dst.push_back_off(other.back(), other.seqlen_tail());
  }
}

// generic reversed containment: first-occurrence-anchored run equality
// (mirror of pathutil.rcontains / ref path_interface.hpp:601-655)
static bool rcontains(const Path& p, const std::deque<int64_t>& fnodes) {
  if (fnodes.empty() || p.empty()) return false;
  std::vector<int64_t> big(p.nodes.rbegin(), p.nodes.rend());
  std::vector<int64_t> small(fnodes.rbegin(), fnodes.rend());
  if (big.size() < small.size()) return false;
  auto it = std::find(big.begin(), big.end(), small[0]);
  if (it == big.end()) return false;
  size_t idx = it - big.begin();
  if (big.size() - idx < small.size()) return false;
  for (size_t i = 0; i < small.size(); ++i)
    if (big[idx + i] != small[i]) return false;
  return true;
}

// --- HaplotypePath: ordered node list with O(1) window containment ---------

struct HapPath {
  std::vector<int64_t> nodes;
  std::unordered_map<int64_t, int64_t> pos;

  void push_back(int64_t nid) {
    pos[nid] = (int64_t)nodes.size();
    nodes.push_back(nid);
  }
  bool contains_node(int64_t nid) const { return pos.count(nid) != 0; }
  template <class Seq>
  bool contains(const Seq& q) const {
    if (q.empty()) return false;
    auto it = pos.find(q[0]);
    if (it == pos.end()) return false;
    size_t idx = it->second;
    if (idx + q.size() > nodes.size()) return false;
    size_t i = 0;
    for (auto v : q) {
      if (nodes[idx + i] != v) return false;
      ++i;
    }
    return true;
  }
};

template <class Seq>
static bool hap_covered_by(const Seq& nodes, const std::vector<HapPath>& vis) {
  if (nodes.empty()) return false;
  for (const auto& hp : vis)
    if (hp.contains(nodes)) return true;
  return false;
}

static int64_t hap_path_coverage(const std::vector<int64_t>& nodes,
                                 const std::vector<HapPath>& vis) {
  int64_t cov = 0;
  if (nodes.size() == 1) {
    for (const auto& hp : vis)
      if (hp.contains_node(nodes[0])) ++cov;
    return cov;
  }
  for (const auto& hp : vis)
    if (hp.contains(nodes)) ++cov;
  return cov;
}

// --- Haplotyper (Global flavour) -------------------------------------------

struct Haplotyper {
  const GraphView* g;
  rand_fn_t rand_fn;
  int64_t start;
  int64_t value;  // 0 = end
  std::vector<int64_t> visiting;  // setback window
  int64_t entropy = 1;
  HapPath current;
  std::vector<HapPath> visited;
  int64_t setback = 0;
  bool raise_on_end = false;
  bool ended_flag = false;  // set when ++ hits a sink with raise_on_end
  int64_t steps = 0;        // walk-length guard: cyclic graphs are out of
  int64_t max_steps = 0;    // contract (psikt requires topological order)
                            // but must terminate, not hang

  void init(int64_t s) {
    steps = 0;
    start = s;
    value = s;
    visiting.clear();
    entropy = 1;
    current = HapPath();
    current.push_back(s);
    visited.clear();
    setback = 0;
    ended_flag = false;
  }

  bool at_end() const { return value == 0; }

  bool is_visited_vec(const std::vector<int64_t>& nodes) {
    return hap_covered_by(nodes, visited);
  }
  bool is_visited_deque(const std::deque<int64_t>& nodes) {
    return hap_covered_by(nodes, visited);
  }

  int64_t least_covered_tail() {
    if (visiting.empty()) return 0;
    int64_t lc_id = 0, lc_value = -1;
    bool equally = true;
    std::vector<int64_t> cand(visiting.begin(), visiting.end());
    cand.push_back(0);
    int64_t tail = visiting.back();
    for (int64_t j = 0; j < g->outdeg(tail); ++j) {
      int64_t to = g->out(tail, j);
      cand.back() = to;
      int64_t valv = hap_path_coverage(cand, visited);
      if (equally && lc_value != -1 && lc_value != valv) equally = false;
      if (lc_value == -1 || valv < lc_value) {
        lc_id = to;
        lc_value = valv;
      }
    }
    return equally ? 0 : lc_id;
  }

  // returns false when iteration ended (value==0); sets ended_flag if
  // raise_on_end (mirrors the range_error control flow)
  bool next() {
    if (g->outdeg(value) == 0 || (max_steps && ++steps > max_steps)) {
      value = 0;
      if (raise_on_end) ended_flag = true;
      return false;
    }
    if (setback > 1) {
      while (!visiting.empty() && entropy > setback) {
        int64_t od = g->outdeg(visiting.front());
        entropy /= (od > 0 ? od : 1);
        visiting.erase(visiting.begin());
      }
    }
    int64_t candidate = 0;
    if (setback == 0 || g->outdeg(value) == 1) {
      candidate = g->out(value, 0);
    } else {
      while (true) {
        std::vector<int64_t> probe(visiting.begin(), visiting.end());
        probe.push_back(0);
        for (int64_t j = 0; j < g->outdeg(value); ++j) {
          int64_t to = g->out(value, j);
          probe.back() = to;
          if (!is_visited_vec(probe)) {
            candidate = to;
            break;
          }
        }
        if (setback == 1 && candidate == 0 && visiting.empty()) {
          visiting.push_back(value);
          continue;
        }
        break;
      }
      if (setback == 1 && !visiting.empty()) visiting.pop_back();
    }
    if (candidate == 0) candidate = least_covered_tail();
    if (candidate == 0) {
      int64_t od = g->outdeg(value);
      candidate = g->out(value, rand_fn(od));
    }
    value = candidate;
    if (setback > 1) {
      visiting.push_back(value);
      int64_t od = g->outdeg(value);
      entropy *= (od > 0 ? od : 1);
    }
    current.push_back(value);
    return true;
  }

  void restart() {
    value = start;
    steps = 0;
    visiting.clear();
    entropy = 1;
    if (setback > 1) {
      visiting.push_back(value);
      int64_t od = g->outdeg(value);
      entropy *= (od > 0 ? od : 1);
    }
    current = HapPath();
    current.push_back(value);
  }

  void finish() {
    visited.push_back(current);
    setback = (int64_t)visited.size();
    restart();
  }
};

// --- output collection ------------------------------------------------------

struct PickResult {
  std::vector<int64_t> indptr{0};
  std::vector<int64_t> nodes;
  std::vector<int64_t> lefts;
  std::vector<int64_t> rights;

  void add(const Path& p) {
    nodes.insert(nodes.end(), p.nodes.begin(), p.nodes.end());
    indptr.push_back((int64_t)nodes.size());
    lefts.push_back(p.left);
    rights.push_back(p.right);
  }
  void add_full(const std::deque<int64_t>& nds) {
    nodes.insert(nodes.end(), nds.begin(), nds.end());
    indptr.push_back((int64_t)nodes.size());
    lefts.push_back(0);
    rights.push_back(0);
  }
};

static void extend_to_k(Path& p, Haplotyper& hp, int64_t k) {
  while (!hp.at_end() && p.seqlen < k) {
    p.push_back_full(hp.value);
    if (!hp.next() && hp.ended_flag) return;  // propagates "exception"
  }
}

// exact mirror of pathset.get_uniq_patches (ref: pathindex.hpp:496-560)
static void get_uniq_patches(PickResult& out, Haplotyper& hp, int64_t k) {
  hp.raise_on_end = true;
  hp.ended_flag = false;
  Path patch{hp.g}, frontier{hp.g};
  int64_t marked = 0;
  while (!hp.ended_flag) {
    marked = 0;
    if (!frontier.empty()) marked = frontier.back();
    if (!marked)
      extend_to_k(frontier, hp, k);
    else
      extend_to_k(frontier, hp, 2 * k + frontier.seqlen - frontier.seqlen_tail());
    if (hp.ended_flag) break;
    if (!patch.empty() && hp.is_visited_deque(frontier.nodes)) {
      patch.set_right_by_len(k - 1);
      out.add(patch);
      patch.clear();
      rtrim_front_by_len(frontier, k, true);
    } else if (!patch.empty()) {
      trim_front_to(frontier, marked);
      marked = 0;
      extend_to_k(frontier, hp, k);
      if (hp.ended_flag) break;
    }
    if (patch.empty()) {
      while (hp.is_visited_deque(frontier.nodes)) {
        frontier.push_back_full(hp.value);
        ltrim_front_by_len(frontier, k, true);
        if (!hp.next() && hp.ended_flag) break;
      }
      if (hp.ended_flag) break;
    }
    extend_path(patch, frontier);
    rtrim_front_by_len(frontier, k, false);
    while (!hp.is_visited_deque(frontier.nodes)) {
      frontier.push_back_full(hp.value);
      patch.push_back_full(hp.value);
      rtrim_front_by_len(frontier, k, false);
      if (!hp.next() && hp.ended_flag) break;
    }
  }
  // "catch (range_error)" tail (ref: pathindex.hpp:547-558)
  if (!patch.empty()) {
    if (!hp.is_visited_deque(frontier.nodes) &&
        !rcontains(patch, frontier.nodes)) {
      if (marked != 0) trim_front_to(frontier, marked);
      extend_path(patch, frontier);
    }
    out.add(patch);
  }
  hp.finish();
  hp.raise_on_end = false;
  hp.ended_flag = false;
}

static void get_uniq_full_haplotype(PickResult& out, Haplotyper& hp) {
  std::deque<int64_t> hap;
  while (!hp.at_end()) {
    hap.push_back(hp.value);
    hp.next();
  }
  hp.finish();
  if (!hap.empty()) out.add_full(hap);
}

}  // namespace

extern "C" {

// Pick `n` haplotype paths per region start. Returns an opaque handle.
void* psi_pick_paths(int64_t n_nodes, const int64_t* node_len,
                     const int64_t* indptr, const int64_t* indices,
                     int64_t n_regions, const int64_t* region_starts,
                     int64_t n, int64_t context, int64_t patched,
                     rand_fn_t rand_fn) {
  GraphView g{n_nodes, node_len, indptr, indices};
  auto* out = new PickResult();
  Haplotyper hp;
  hp.g = &g;
  hp.rand_fn = rand_fn;
  hp.max_steps = 4 * n_nodes + 1024;  // cycle guard
  hp.init(region_starts[0] ? region_starts[0] : 1);
  for (int64_t r = 0; r < n_regions; ++r) {
    hp.init(region_starts[r]);
    for (int64_t i = 0; i < n; ++i) {
      if (patched) {
        if (hp.visited.empty())
          get_uniq_full_haplotype(*out, hp);
        else
          get_uniq_patches(*out, hp, context);
      } else {
        get_uniq_full_haplotype(*out, hp);
      }
    }
  }
  return out;
}

int64_t psi_pick_paths_count(void* handle) {
  return (int64_t)static_cast<PickResult*>(handle)->lefts.size();
}
int64_t psi_pick_paths_nodes_total(void* handle) {
  return (int64_t)static_cast<PickResult*>(handle)->nodes.size();
}
void psi_pick_paths_export(void* handle, int64_t* indptr, int64_t* nodes,
                           int64_t* lefts, int64_t* rights) {
  auto* r = static_cast<PickResult*>(handle);
  std::copy(r->indptr.begin(), r->indptr.end(), indptr);
  std::copy(r->nodes.begin(), r->nodes.end(), nodes);
  std::copy(r->lefts.begin(), r->lefts.end(), lefts);
  std::copy(r->rights.begin(), r->rights.end(), rights);
}
void psi_pick_paths_free(void* handle) {
  delete static_cast<PickResult*>(handle);
}

}  // extern "C"
