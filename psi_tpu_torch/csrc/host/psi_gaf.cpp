// psi_gaf.cpp — native GAF column scanner for alice dstats.
//
// The reference's alice verifies millions of alignment pairs per run
// (ref: tools/src/alice.cpp:599-737); a Python per-line parse is ~10x
// the cost of the verification itself. This scanner extracts exactly
// the dstats columns — qname pair-group, pstart, pend, oriented path
// node ids — in one pass over the buffer; everything downstream is
// vectorized NumPy + DistanceIndex.verify_batch.
//
// Pairing parity with the Python tool: group key = qname with all
// trailing '1'/'2' characters stripped, then all trailing '/' stripped
// (str.rstrip semantics); groups are numbered in first-appearance
// order and ord_in_group counts each record's rank within its group.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct GafScan {
  std::vector<int64_t> group;   // per record
  std::vector<int64_t> ord;     // rank within group (0 = first)
  std::vector<int64_t> pstart;
  std::vector<int64_t> pend;
  std::vector<int64_t> path_indptr;  // nrec+1
  std::vector<int64_t> path_coords;  // flattened node ids
  int64_t n_groups = 0;
};

static inline int64_t parse_int(const char* s, const char* e) {
  if (s < e && *s == '*') return 0;
  int64_t v = 0;
  bool neg = false;
  if (s < e && *s == '-') { neg = true; ++s; }
  for (; s < e && *s >= '0' && *s <= '9'; ++s) v = v * 10 + (*s - '0');
  return neg ? -v : v;
}

// Zero-copy group interning: keys are (offset, len) slices of the GAF
// buffer itself in an open-addressing table — no per-line string
// allocation (a std::unordered_map<std::string> here measures ~3x the
// whole remaining scan).
struct GroupIntern {
  struct Slot {
    const char* ptr = nullptr;
    uint32_t len = 0;
    int64_t id = -1;
  };
  std::vector<Slot> slots;
  size_t mask;
  size_t count = 0;

  explicit GroupIntern(size_t expect) {
    size_t cap = 64;
    while (cap < expect * 2) cap <<= 1;
    slots.resize(cap);
    mask = cap - 1;
  }

  static inline uint64_t hash(const char* s, size_t n) {
    uint64_t h = 1469598103934665603ull;  // FNV-1a
    for (size_t i = 0; i < n; ++i) {
      h ^= (uint8_t)s[i];
      h *= 1099511628211ull;
    }
    return h;
  }

  void grow() {
    std::vector<Slot> old;
    old.swap(slots);
    slots.resize(old.size() * 2);
    mask = slots.size() - 1;
    for (auto& s : old) {
      if (!s.ptr) continue;
      size_t i = hash(s.ptr, s.len) & mask;
      while (slots[i].ptr) i = (i + 1) & mask;
      slots[i] = s;
    }
  }

  int64_t intern(const char* s, size_t n, int64_t next_id) {
    if (count * 2 >= slots.size()) grow();
    size_t i = hash(s, n) & mask;
    while (slots[i].ptr) {
      if (slots[i].len == n && memcmp(slots[i].ptr, s, n) == 0)
        return slots[i].id;
      i = (i + 1) & mask;
    }
    slots[i] = {s, (uint32_t)n, next_id};
    ++count;
    return -1;  // new
  }
};

}  // namespace

extern "C" {

void* psi_gaf_scan(const uint8_t* buf, int64_t n) {
  auto* out = new GafScan();
  size_t expect = (size_t)(n / 64) + 16;  // rough line-count estimate
  out->group.reserve(expect);
  out->ord.reserve(expect);
  out->pstart.reserve(expect);
  out->pend.reserve(expect);
  out->path_indptr.reserve(expect + 1);
  out->path_coords.reserve(expect * 2);
  out->path_indptr.push_back(0);
  GroupIntern group_of(expect);
  std::vector<int64_t> group_count;
  group_count.reserve(expect);
  const char* p = reinterpret_cast<const char*>(buf);
  const char* end = p + n;
  while (p < end) {
    const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!eol) eol = end;
    // split the first 12 fields
    const char* f[13];
    int nf = 0;
    f[nf++] = p;
    for (const char* q = p; nf < 13; ++q) {
      q = static_cast<const char*>(memchr(q, '\t', eol - q));
      if (!q) break;
      f[nf++] = q + 1;
    }
    if (nf >= 12) {
      // qname = field 0: strip trailing '1'/'2', then trailing '/'
      const char* q0 = f[0];
      const char* q1 = f[1] - 1;  // points at the tab
      while (q1 > q0 && (q1[-1] == '1' || q1[-1] == '2')) --q1;
      while (q1 > q0 && q1[-1] == '/') --q1;
      int64_t g = group_of.intern(q0, q1 - q0, out->n_groups);
      if (g < 0) {
        g = out->n_groups++;
        group_count.push_back(0);
      }
      out->group.push_back(g);
      out->ord.push_back(group_count[g]++);
      // path = field 5: sequence of [<>]<digits>
      const char* s = f[5];
      const char* se = f[6] - 1;
      if (!(se - s == 1 && *s == '*')) {
        while (s < se) {
          if (*s == '>' || *s == '<') {
            ++s;
            int64_t v = 0;
            while (s < se && *s >= '0' && *s <= '9') v = v * 10 + (*s++ - '0');
            out->path_coords.push_back(v);
          } else {
            ++s;
          }
        }
      }
      out->path_indptr.push_back((int64_t)out->path_coords.size());
      out->pstart.push_back(parse_int(f[7], f[8] - 1));
      const char* e8 = (nf > 9) ? f[9] - 1 : eol;
      out->pend.push_back(parse_int(f[8], e8));
    }
    p = eol + 1;
  }
  return out;
}

int64_t psi_gaf_nrec(void* h) {
  return (int64_t) static_cast<GafScan*>(h)->group.size();
}

int64_t psi_gaf_ngroups(void* h) {
  return static_cast<GafScan*>(h)->n_groups;
}

int64_t psi_gaf_npathnodes(void* h) {
  return (int64_t) static_cast<GafScan*>(h)->path_coords.size();
}

void psi_gaf_export(void* h, int64_t* group, int64_t* ord, int64_t* pstart,
                    int64_t* pend, int64_t* path_indptr,
                    int64_t* path_coords) {
  auto* s = static_cast<GafScan*>(h);
  memcpy(group, s->group.data(), s->group.size() * sizeof(int64_t));
  memcpy(ord, s->ord.data(), s->ord.size() * sizeof(int64_t));
  memcpy(pstart, s->pstart.data(), s->pstart.size() * sizeof(int64_t));
  memcpy(pend, s->pend.data(), s->pend.size() * sizeof(int64_t));
  memcpy(path_indptr, s->path_indptr.data(),
         s->path_indptr.size() * sizeof(int64_t));
  memcpy(path_coords, s->path_coords.data(),
         s->path_coords.size() * sizeof(int64_t));
}

void psi_gaf_free(void* h) { delete static_cast<GafScan*>(h); }

}  // extern "C"
