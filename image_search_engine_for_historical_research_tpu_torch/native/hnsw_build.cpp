// HNSW graph construction (host-side, C ABI for ctypes).
//
// The PyTorch port's copy of the JAX package's native/hnsw_build.cpp; the
// algorithm and the output layout are the same, so both packages build the
// same graph from the same vectors.
//
// Native replacement for the reference's pure-python insert loop
// (src/utils/nnsearch.py:165-254, HNSW.add), which its README
// admits runs "even for days" at 1M vectors. Algorithm follows Malkov &
// Yashunin (TPAMI'18), matching the reference's semantics: exponential level
// assignment with mult = 1/ln(m), greedy descent on upper layers, ef-bounded
// best-first search on the insertion layers, and heuristic neighbor selection
// (keep a candidate only if it is closer to the new node than to every
// already-kept neighbor), with backlink pruning by the same rule.
//
// Output layout: fixed-width padded neighbor tables
//   level 0:   (n, m0) int32, -1 padding
//   level 1+:  (max_levels-1, n, m) int32, -1 padding
// which the beam-search kernel (csrc/beam_search.cu) and the upper-level
// descent (ops/graph_search.py) consume directly.
//
// Distances: squared L2 (monotonic with L2; the reference uses np.linalg.norm).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libhnsw.so hnsw_build.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

namespace {

struct Cand {
  float dist;
  int32_t id;
};
struct Nearer {
  bool operator()(const Cand& a, const Cand& b) const { return a.dist > b.dist; }
};
struct Farther {
  bool operator()(const Cand& a, const Cand& b) const { return a.dist < b.dist; }
};

class Graph {
 public:
  Graph(const float* data, int64_t n, int64_t d, int m, int m0, int ef,
        int max_levels, uint64_t seed)
      : data_(data), n_(n), d_(d), m_(m), m0_(m0), ef_(ef),
        max_levels_(max_levels), rng_(seed),
        level_mult_(1.0 / std::log((double)m)) {
    levels_.assign(n, 0);
    nbr0_.assign(n * (size_t)m0, -1);
    nbru_.assign((size_t)(max_levels - 1) * n * m, -1);
    entry_ = -1;
    top_level_ = -1;
  }

  float dist(int32_t a, int32_t b) const {
    const float* pa = data_ + (size_t)a * d_;
    const float* pb = data_ + (size_t)b * d_;
    float s = 0.f;
    for (int64_t i = 0; i < d_; ++i) {
      float t = pa[i] - pb[i];
      s += t * t;
    }
    return s;
  }

  int32_t* nbrs(int level, int32_t id) {
    if (level == 0) return nbr0_.data() + (size_t)id * m0_;
    return nbru_.data() + ((size_t)(level - 1) * n_ + id) * m_;
  }
  int cap(int level) const { return level == 0 ? m0_ : m_; }

  int assign_level() {
    std::uniform_real_distribution<double> u(0.0, 1.0);
    double r = u(rng_);
    if (r <= 0.0) r = 1e-300;
    int lvl = (int)(-std::log(r) * level_mult_);
    if (lvl >= max_levels_) lvl = max_levels_ - 1;
    return lvl;
  }

  // greedy descent on one layer (reference _search_graph_ef1)
  void greedy(int32_t q, int level, int32_t& point, float& pd) const {
    bool improved = true;
    while (improved) {
      improved = false;
      const int32_t* nb = const_cast<Graph*>(this)->nbrs(level, point);
      int c = cap(level);
      for (int i = 0; i < c; ++i) {
        int32_t e = nb[i];
        if (e < 0) break;
        float dd = dist(q, e);
        if (dd < pd) {
          pd = dd;
          point = e;
          improved = true;
        }
      }
    }
  }

  // ef-bounded best-first search on one layer; returns up to ef nearest
  std::vector<Cand> search_layer(int32_t q, int32_t entry, float edist,
                                 int level, int ef) {
    std::priority_queue<Cand, std::vector<Cand>, Nearer> candidates;
    std::priority_queue<Cand, std::vector<Cand>, Farther> best;  // max-heap
    visited_stamp_++;
    visit(entry);
    candidates.push({edist, entry});
    best.push({edist, entry});

    while (!candidates.empty()) {
      Cand c = candidates.top();
      if (c.dist > best.top().dist && (int)best.size() >= ef) break;
      candidates.pop();
      const int32_t* nb = nbrs(level, c.id);
      int capn = cap(level);
      for (int i = 0; i < capn; ++i) {
        int32_t e = nb[i];
        if (e < 0) break;
        if (seen(e)) continue;
        visit(e);
        float dd = dist(q, e);
        if ((int)best.size() < ef) {
          candidates.push({dd, e});
          best.push({dd, e});
        } else if (dd < best.top().dist) {
          candidates.push({dd, e});
          best.pop();
          best.push({dd, e});
        }
      }
    }
    std::vector<Cand> out;
    out.reserve(best.size());
    while (!best.empty()) {
      out.push_back(best.top());
      best.pop();
    }
    std::reverse(out.begin(), out.end());  // nearest first
    return out;
  }

  // heuristic selection (reference _select_heuristic / paper Algorithm 4)
  std::vector<Cand> select(const std::vector<Cand>& cands, int target) const {
    std::vector<Cand> kept;
    for (const Cand& c : cands) {
      if ((int)kept.size() >= target) break;
      bool good = true;
      for (const Cand& k : kept) {
        if (dist(c.id, k.id) < c.dist) {
          good = false;
          break;
        }
      }
      if (good) kept.push_back(c);
    }
    // backfill with skipped candidates if underfull (keepPrunedConnections)
    if ((int)kept.size() < target) {
      for (const Cand& c : cands) {
        if ((int)kept.size() >= target) break;
        bool present = false;
        for (const Cand& k : kept)
          if (k.id == c.id) { present = true; break; }
        if (!present) kept.push_back(c);
      }
    }
    return kept;
  }

  void set_neighbors(int level, int32_t id, const std::vector<Cand>& ns) {
    int32_t* nb = nbrs(level, id);
    int c = cap(level);
    int i = 0;
    for (; i < (int)ns.size() && i < c; ++i) nb[i] = ns[i].id;
    for (; i < c; ++i) nb[i] = -1;
  }

  // add backlink j -> id, pruning with the heuristic when overfull
  void backlink(int level, int32_t j, int32_t id, float dij) {
    int32_t* nb = nbrs(level, j);
    int c = cap(level);
    int sz = 0;
    while (sz < c && nb[sz] >= 0) sz++;
    if (sz < c) {
      nb[sz] = id;
      return;
    }
    std::vector<Cand> all;
    all.reserve(sz + 1);
    for (int i = 0; i < sz; ++i) all.push_back({dist(j, nb[i]), nb[i]});
    all.push_back({dij, id});
    std::sort(all.begin(), all.end(),
              [](const Cand& a, const Cand& b) { return a.dist < b.dist; });
    set_neighbors(level, j, select(all, c));
  }

  void add(int32_t q) {
    int level = (entry_ < 0) ? 0 : assign_level();
    if (entry_ < 0) {
      entry_ = q;
      top_level_ = 0;
      levels_[q] = 0;
      return;
    }
    levels_[q] = level;

    int32_t point = entry_;
    float pd = dist(q, point);
    for (int l = top_level_; l > level; --l) greedy(q, l, point, pd);

    for (int l = std::min(level, top_level_); l >= 0; --l) {
      std::vector<Cand> found = search_layer(q, point, pd, l, ef_);
      std::vector<Cand> sel = select(found, cap(l) < m_ ? cap(l) : m_);
      if (l == 0 && (int)sel.size() < m0_) {
        // level 0 may keep up to m0 links
        sel = select(found, m0_);
      }
      set_neighbors(l, q, sel);
      for (const Cand& s : sel) backlink(l, s.id, q, s.dist);
      if (!found.empty()) {
        point = found[0].id;
        pd = found[0].dist;
      }
    }
    if (level > top_level_) {
      top_level_ = level;
      entry_ = q;
    }
  }

  void build() {
    visited_.assign(n_, 0);
    visited_stamp_ = 0;
    for (int64_t i = 0; i < n_; ++i) add((int32_t)i);
  }

  const float* data_;
  int64_t n_, d_;
  int m_, m0_, ef_, max_levels_;
  std::mt19937_64 rng_;
  double level_mult_;
  std::vector<int> levels_;
  std::vector<int32_t> nbr0_, nbru_;
  int32_t entry_;
  int top_level_;

 private:
  mutable std::vector<uint32_t> visited_;
  mutable uint32_t visited_stamp_ = 0;
  void visit(int32_t i) const { visited_[i] = visited_stamp_; }
  bool seen(int32_t i) const { return visited_[i] == visited_stamp_; }
};

}  // namespace

extern "C" {

// Returns 0 on success. Outputs:
//   out_nbr0:     (n, m0) int32, -1 padded
//   out_nbru:     (max_levels-1, n, m) int32, -1 padded
//   out_levels:   (n,) int32 node top levels
//   out_meta[0] = entry point id, out_meta[1] = top level
int hnsw_build(const float* data, int64_t n, int64_t d, int m, int m0, int ef,
               int max_levels, uint64_t seed, int32_t* out_nbr0,
               int32_t* out_nbru, int32_t* out_levels, int32_t* out_meta) {
  if (n <= 0 || d <= 0 || m <= 0 || m0 < m || max_levels < 1) return 1;
  Graph g(data, n, d, m, m0, ef, max_levels, seed);
  g.build();
  std::memcpy(out_nbr0, g.nbr0_.data(), g.nbr0_.size() * sizeof(int32_t));
  std::memcpy(out_nbru, g.nbru_.data(), g.nbru_.size() * sizeof(int32_t));
  for (int64_t i = 0; i < n; ++i) out_levels[i] = g.levels_[i];
  out_meta[0] = g.entry_;
  out_meta[1] = g.top_level_;
  return 0;
}

}  // extern "C"
