// psi_uncovered — native uncovered-starting-loci detection.
//
// Exact port of the detection algorithm (per-node Backtracker context
// enumeration + coverage trims; semantics mirror psi_tpu's Python
// implementation of the reference algorithm, ref:
// include/psi/seed_finder.hpp:1481-1541). Per-node work is independent,
// so the scan is OpenMP-parallel; output preserves node order with
// ascending offsets per node.

#include <algorithm>
#include <cstdint>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Loci {
  std::vector<int64_t> node_ids;
  std::vector<int64_t> offsets;
};

struct Backtracker {
  const int64_t* indptr;
  const int64_t* indices;
  int64_t value = 0;   // 0 = end
  int64_t buffer = 0;  // 0 = none
  std::vector<std::pair<int64_t, int64_t>> backlog;

  void reset(int64_t start) {
    value = start;
    buffer = 0;
    backlog.clear();
  }
  bool at_end() const { return value == 0; }
  void next() {
    if (buffer != 0) {
      value = buffer;
      buffer = 0;
      return;
    }
    int64_t cnode = value;
    value = 0;
    for (int64_t e = indptr[cnode - 1]; e < indptr[cnode]; ++e) {
      if (e == indptr[cnode - 1]) {
        value = indices[e];
      } else {
        backlog.push_back({cnode, indices[e]});
      }
    }
  }
  void backtrack() {
    if (buffer != 0) {
      while (!backlog.empty() && backlog.back().first == value)
        backlog.pop_back();
      buffer = 0;
    }
    value = 0;
    if (!backlog.empty()) {
      value = backlog.back().first;
      buffer = backlog.back().second;
      backlog.pop_back();
    }
  }
};

struct SimplePath {
  std::vector<int64_t> nodes;
  int64_t seqlen = 0;
  const int64_t* node_len;

  void push(int64_t nid) {
    nodes.push_back(nid);
    seqlen += node_len[nid - 1];
  }
  void pop() {
    seqlen -= node_len[nodes.back() - 1];
    nodes.pop_back();
  }
  // trim_back(path, node_id): pop until node_id found (inclusive);
  // node_id == 0 pops one node (ref: path_interface.hpp:338-349)
  void trim_back(int64_t node_id) {
    while (!nodes.empty()) {
      bool found = (node_id == 0 || nodes.back() == node_id);
      pop();
      if (found) break;
    }
  }
  void clear() {
    nodes.clear();
    seqlen = 0;
  }
};

// all-occurrence contiguous-run coverage over the stored path set
struct Coverage {
  const int64_t* paths_nodes;   // concatenated path node ids
  const int64_t* paths_indptr;  // [P+1]
  std::unordered_map<int64_t, std::vector<std::pair<int64_t, int64_t>>> occ;

  void build(int64_t P) {
    for (int64_t p = 0; p < P; ++p)
      for (int64_t i = paths_indptr[p]; i < paths_indptr[p + 1]; ++i)
        occ[paths_nodes[i]].push_back({p, i - paths_indptr[p]});
  }
  bool covered(const std::vector<int64_t>& q) const {
    if (q.empty()) return false;
    auto it = occ.find(q[0]);
    if (it == occ.end()) return false;
    for (auto& [p, pos] : it->second) {
      int64_t plen = paths_indptr[p + 1] - paths_indptr[p];
      if (pos + (int64_t)q.size() > plen) continue;
      const int64_t* base = paths_nodes + paths_indptr[p] + pos;
      bool ok = true;
      for (size_t j = 1; j < q.size(); ++j)
        if (base[j] != q[j]) { ok = false; break; }
      if (ok) return true;
    }
    return false;
  }
};

}  // namespace

extern "C" {

void* psi_uncovered_build(int64_t n, const int64_t* node_len,
                          const int64_t* indptr, const int64_t* indices,
                          int64_t P, const int64_t* paths_nodes,
                          const int64_t* paths_indptr, int64_t k,
                          int64_t step) {
  auto* out = new Loci();
  Coverage cov;
  cov.paths_nodes = paths_nodes;
  cov.paths_indptr = paths_indptr;
  cov.build(P);

  std::vector<std::vector<int64_t>> per_node_offsets(n);

#pragma omp parallel
  {
    Backtracker bt;
    bt.indptr = indptr;
    bt.indices = indices;
    SimplePath trav;
    trav.node_len = node_len;
    std::vector<int64_t> current;
    std::vector<uint8_t> marks;

#pragma omp for schedule(dynamic, 64)
    for (int64_t v = 1; v <= n; ++v) {
      int64_t label_len = node_len[v - 1];
      int64_t offset = label_len;
      if ((int64_t)marks.size() < label_len) marks.resize(label_len, 0);
      std::fill(marks.begin(), marks.begin() + label_len, 0);
      trav.clear();

      bt.reset(v);
      while (!bt.at_end() && offset != 0) {
        // extend_to_k(trav, bt, offset - 1 + k)
        while (!bt.at_end() && trav.seqlen < offset - 1 + k) {
          trav.push(bt.value);
          bt.next();
        }
        current.clear();
        int64_t cur_seqlen = 0;
        if (trav.seqlen >= k) {
          current = trav.nodes;
          cur_seqlen = trav.seqlen;
        }
        while (!current.empty() && cur_seqlen != 0 && !cov.covered(current)) {
          int64_t trimmed = cur_seqlen - node_len[current.back() - 1];
          if (trimmed <= k - 1) {
            offset = 0;
            break;
          }
          offset = trimmed - k + 1;
          cur_seqlen = trimmed;
          current.pop_back();
        }
        for (int64_t f = offset;
             f < label_len && f + k < trav.seqlen + 1; f += step)
          marks[f] = 1;

        bt.backtrack();
        trav.trim_back(bt.at_end() ? 0 : bt.value);
      }

      for (int64_t f = 0; f < label_len; ++f)
        if (marks[f]) per_node_offsets[v - 1].push_back(f);
    }
  }

  for (int64_t v = 1; v <= n; ++v)
    for (int64_t f : per_node_offsets[v - 1]) {
      out->node_ids.push_back(v);
      out->offsets.push_back(f);
    }
  return out;
}

int64_t psi_uncovered_count(void* handle) {
  return (int64_t)static_cast<Loci*>(handle)->node_ids.size();
}

void psi_uncovered_export(void* handle, int64_t* node_ids, int64_t* offsets) {
  auto* l = static_cast<Loci*>(handle);
  std::copy(l->node_ids.begin(), l->node_ids.end(), node_ids);
  std::copy(l->offsets.begin(), l->offsets.end(), offsets);
}

void psi_uncovered_free(void* handle) { delete static_cast<Loci*>(handle); }

}  // extern "C"
