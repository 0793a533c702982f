// The port's host library: every host sampler of the JAX package.
//
// Copies the samplers of pytorch_sparse_tpu/csrc/native.cpp (the JAX
// package's native host library) line for line, so that the same inputs
// and seed give the same outputs (the same draws in the same order, the
// same container types and insertion sequences, hence the same hash-map
// iteration order, and the same double arithmetic): its RNG,
// `rng_seed_at`, `rng_unit`, `draw_candidates` and `sample_size_of`; the
// homogeneous `sample_adj`, `neighbor_sample`, `saint_subgraph` and
// `relabel_one_hop`; and `hgt_sample`, `ego_k_hop`,
// `hetero_neighbor_sample` and `hetero_temporal_neighbor_sample`.  Host
// code, not a kernel: it runs on the CPU of the machine that holds the
// card, before any launch.
//
// Plain C ABI, loaded with ctypes (pytorch_sparse_tpu_torch/sample/
// _native.py) after `_build.load` compiles it with the host C++
// compiler: -O3 -march=native -fopenmp -fPIC -shared -std=c++17 and
// -ffp-contract=off.  All index arrays are int64.  `sample_adj` and
// `relabel_one_hop` fill outputs that the caller sizes exactly; every
// other entry is two-phase: a call with null outputs fills `counts`, a
// second call with buffers of those sizes fills them; both phases draw
// identically.  The homogeneous samplers draw each frontier row from a
// stream of its own (`rng_seed_at`) and `ego_k_hop` each seed, so that
// where OpenMP is built in their rows and seeds run in parallel and the
// output does not depend on the thread count (nor on OpenMP being there
// at all).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

// ---------------------------------------------------------------------
// RNG: xoshiro256** seeded via SplitMix64.
// ---------------------------------------------------------------------
namespace {

struct Rng {
  uint64_t s[4];
};

static inline uint64_t splitmix64(uint64_t &x) {
  uint64_t z = (x += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

static inline void rng_seed(Rng *r, uint64_t seed) {
  for (int i = 0; i < 4; i++) r->s[i] = splitmix64(seed);
}

static inline uint64_t rotl(uint64_t x, int k) {
  return (x << k) | (x >> (64 - k));
}

static inline uint64_t rng_next(Rng *r) {
  const uint64_t result = rotl(r->s[1] * 5, 7) * 9;
  const uint64_t t = r->s[1] << 17;
  r->s[2] ^= r->s[0];
  r->s[3] ^= r->s[1];
  r->s[1] ^= r->s[2];
  r->s[0] ^= r->s[3];
  r->s[2] ^= t;
  r->s[3] = rotl(r->s[3], 45);
  return result;
}

static inline int64_t rng_below(Rng *r, int64_t n) {
  // Lemire's nearly-divisionless bounded draw.
  return (int64_t)(((__uint128_t)rng_next(r) * (__uint128_t)n) >> 64);
}

inline double rng_unit(Rng *r) {  // uniform in (0, 1)
  return ((double)(rng_next(r) >> 11) + 1.0) * 1.1102230246251564e-16;
}

// Per-(stream, element) RNG stream: the draws for one frontier row are
// a function of (seed, stream, element) alone, so (a) OpenMP workers
// need no shared RNG state, (b) results are identical at any thread
// count, and (c) the count-pass/fill-pass two-phase protocol samples
// identically by construction.
static inline void rng_seed_at(Rng *r, uint64_t seed, uint64_t stream,
                               uint64_t element) {
  rng_seed(&r[0], seed ^ (0x9e3779b97f4a7c15ULL * (stream + 1)) ^
                      (0xbf58476d1ce4e5b9ULL * (element + 1)));
}

// Candidate-generation pass shared by sample_adj / neighbor_sample:
// fills buf[offs[i]..offs[i+1]) with the drawn edge ids for frontier
// position i (absolute into the index arrays).  offs must hold the
// exact per-row sample sizes:
//   deg          if num < 0 or (!replace and num >= deg)
//   num          if replace and deg > 0
//   num          otherwise (Robert-Floyd without replacement)
// Row-internal order matches the serial formulation's per-branch order.
static void draw_candidates(const int64_t *ptr, const int64_t *frontier,
                            int64_t n_front, int64_t num, int32_t replace,
                            uint64_t seed, uint64_t stream,
                            const int64_t *offs, int64_t *buf) {
  const int par = n_front >= 64 && offs[n_front] >= 4096;
#pragma omp parallel for schedule(dynamic, 64) if (par)
  for (int64_t i = 0; i < n_front; i++) {
    const int64_t w = frontier[i];
    const int64_t start = ptr[w], deg = ptr[w + 1] - ptr[w];
    const int64_t ni = offs[i + 1] - offs[i];
    if (ni == 0) continue;
    int64_t *dst = buf + offs[i];
    if (num < 0 || (!replace && num >= deg)) {
      for (int64_t j = 0; j < deg; j++) dst[j] = start + j;
      continue;
    }
    Rng rng;
    rng_seed_at(&rng, seed, stream, (uint64_t)i);
    if (replace) {
      for (int64_t j = 0; j < num; j++)
        dst[j] = start + rng_below(&rng, deg);
    } else {
      // Robert Floyd sampling without replacement.
      std::unordered_set<int64_t> perm;
      perm.reserve(num * 2);
      int64_t k = 0;
      for (int64_t j = deg - num; j < deg; j++) {
        int64_t rnd = rng_below(&rng, j);
        if (!perm.insert(rnd).second) {
          rnd = j;
          perm.insert(j);
        }
        dst[k++] = start + rnd;
      }
    }
  }
}

static inline int64_t sample_size_of(int64_t deg, int64_t num,
                                     int32_t replace) {
  if (deg == 0) return 0;
  if (num < 0 || (!replace && num >= deg)) return deg;
  return num;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------
// hgt_sample: Heterogeneous Graph Transformer layer-wise importance
// sampling (reference cpu/hgt_sample_cpu.cpp): per-type budgets of
// inverse-degree scores with a neighbor cap of 50, weighted node
// sampling proportional to budget^2 without replacement
// (Efraimidis-Spirakis keys), induced typed adjacency reconstruction.
// Flattened encoding and two-phase protocol as hetero_neighbor_sample;
// num_samples is (n_types * num_hops).  The keys are drawn while the
// budget map is walked, so its iteration order is part of the result.
// ---------------------------------------------------------------------
void hgt_sample(int64_t n_types, int64_t n_rels, int64_t num_hops,
                const int64_t *rel_src, const int64_t *rel_dst,
                const int64_t *colptr_cat, const int64_t *colptr_off,
                const int64_t *row_cat, const int64_t *row_off,
                const int64_t *inputs_cat, const int64_t *inputs_off,
                const int64_t *num_samples, uint64_t seed, int64_t *counts,
                int64_t *out_nodes_cat, int64_t *out_rows_cat,
                int64_t *out_cols_cat, int64_t *out_eids_cat) {
  const bool count_only = out_nodes_cat == nullptr;
  const int64_t MAX_NEIGHBORS = 50;  // hgt_sample_cpu.cpp:9
  Rng rng;
  rng_seed(&rng, seed);

  std::vector<std::vector<int64_t>> nodes(n_types);
  std::vector<std::unordered_map<int64_t, int64_t>> to_local(n_types);
  std::vector<std::unordered_map<int64_t, double>> budget(n_types);

  for (int64_t t = 0; t < n_types; t++) {
    for (int64_t i = inputs_off[t]; i < inputs_off[t + 1]; i++) {
      const int64_t v = inputs_cat[i];
      if (to_local[t].emplace(v, (int64_t)nodes[t].size()).second)
        nodes[t].push_back(v);
    }
  }

  auto update_budget = [&](int64_t node_type,
                           const std::vector<int64_t> &new_samples) {
    if (new_samples.empty()) return;
    for (int64_t r = 0; r < n_rels; r++) {
      if (rel_dst[r] != node_type) continue;
      const int64_t st = rel_src[r];
      const int64_t *cp = colptr_cat + colptr_off[r];
      const int64_t *rw = row_cat + row_off[r];
      for (const int64_t w : new_samples) {
        const int64_t start = cp[w], count = cp[w + 1] - cp[w];
        if (count == 0) continue;
        auto add = [&](int64_t e) {
          const int64_t v = rw[e];
          if (to_local[st].find(v) == to_local[st].end())
            budget[st][v] += 1.0 / (double)std::min(count, MAX_NEIGHBORS);
        };
        if (count > MAX_NEIGHBORS) {
          std::unordered_set<int64_t> perm;
          for (int64_t j = count - MAX_NEIGHBORS; j < count; j++) {
            int64_t rnd = rng_below(&rng, j);
            if (!perm.insert(rnd).second) {
              rnd = j;
              perm.insert(j);
            }
            add(start + rnd);
          }
        } else {
          for (int64_t j = 0; j < count; j++) add(start + j);
        }
      }
    }
  };

  for (int64_t t = 0; t < n_types; t++) update_budget(t, nodes[t]);

  std::vector<std::pair<double, int64_t>> keys;
  for (int64_t ell = 0; ell < num_hops; ell++) {
    std::vector<std::vector<int64_t>> hop_samples(n_types);
    for (int64_t t = 0; t < n_types; t++) {
      const int64_t num = num_samples[t * num_hops + ell];
      if (num <= 0 || budget[t].empty()) continue;
      // Efraimidis-Spirakis: top-num by u^(1/w), weight = budget^2.
      keys.clear();
      keys.reserve(budget[t].size());
      for (const auto &kv : budget[t]) {
        const double w = kv.second * kv.second;
        keys.emplace_back(std::pow(rng_unit(&rng), 1.0 / w), kv.first);
      }
      const int64_t take =
          std::min<int64_t>(num, (int64_t)keys.size());
      std::partial_sort(
          keys.begin(), keys.begin() + take, keys.end(),
          [](const auto &a, const auto &b) { return a.first > b.first; });
      for (int64_t i = 0; i < take; i++) {
        const int64_t v = keys[i].second;
        to_local[t][v] = (int64_t)nodes[t].size();
        nodes[t].push_back(v);
        budget[t].erase(v);
        hop_samples[t].push_back(v);
      }
    }
    if (ell < num_hops - 1)
      for (int64_t t = 0; t < n_types; t++) update_budget(t, hop_samples[t]);
  }

  // Induced typed adjacency (hgt_sample_cpu.cpp:189-230).
  std::vector<std::vector<int64_t>> rows(n_rels), cols(n_rels),
      eids(n_rels);
  for (int64_t r = 0; r < n_rels; r++) {
    const int64_t st = rel_src[r], dt = rel_dst[r];
    const int64_t *cp = colptr_cat + colptr_off[r];
    const int64_t *rw = row_cat + row_off[r];
    for (int64_t i = 0; i < (int64_t)nodes[dt].size(); i++) {
      const int64_t w = nodes[dt][i];
      for (int64_t e = cp[w]; e < cp[w + 1]; e++) {
        const auto it = to_local[st].find(rw[e]);
        if (it == to_local[st].end()) continue;
        rows[r].push_back(it->second);
        cols[r].push_back(i);
        eids[r].push_back(e);
      }
    }
  }

  for (int64_t t = 0; t < n_types; t++)
    counts[t] = (int64_t)nodes[t].size();
  for (int64_t r = 0; r < n_rels; r++)
    counts[n_types + r] = (int64_t)rows[r].size();

  if (!count_only) {
    int64_t npos = 0, epos = 0;
    for (int64_t t = 0; t < n_types; t++) {
      std::memcpy(out_nodes_cat + npos, nodes[t].data(),
                  nodes[t].size() * sizeof(int64_t));
      npos += (int64_t)nodes[t].size();
    }
    for (int64_t r = 0; r < n_rels; r++) {
      std::memcpy(out_rows_cat + epos, rows[r].data(),
                  rows[r].size() * sizeof(int64_t));
      std::memcpy(out_cols_cat + epos, cols[r].data(),
                  cols[r].size() * sizeof(int64_t));
      std::memcpy(out_eids_cat + epos, eids[r].data(),
                  eids[r].size() * sizeof(int64_t));
      epos += (int64_t)rows[r].size();
    }
  }
}

// ---------------------------------------------------------------------
// ego_k_hop: per-seed k-hop BFS with a per-node neighbor cap, induced
// subgraph over the sorted visited set, block-diagonal stitching
// (reference csrc/cpu/ego_sample_cpu.cpp:16-131).
//
// Two-phase like neighbor_sample: call with out_row == nullptr to get
// counts[0] = total stitched nodes, counts[1] = total induced edges;
// then call again with buffers of those sizes.  Deterministic for a
// fixed seed, so both phases visit identically.
// ---------------------------------------------------------------------
void ego_k_hop(const int64_t *rowptr, const int64_t *col, int64_t n_nodes,
               const int64_t *seeds, int64_t n_seeds, int64_t depth,
               int64_t num_neighbors, int32_t replace, uint64_t seed,
               int64_t *counts, int64_t *out_row, int64_t *out_col,
               int64_t *out_eid, int64_t *out_nid, int64_t *out_ptr,
               int64_t *out_root) {
  (void)n_nodes;
  const bool count_only = out_row == nullptr;

  // Ego nets are independent: parallel over seeds with a per-seed RNG
  // stream (deterministic regardless of thread schedule), then a
  // sequential prefix to stitch block-diagonally.
  struct PerSeed {
    std::vector<int64_t> row, colv, eid, nid;
    int64_t root_local = 0;
  };
  std::vector<PerSeed> res(n_seeds);

#pragma omp parallel for schedule(dynamic, 8)
  for (int64_t s = 0; s < n_seeds; s++) {
    Rng rng;
    rng_seed(&rng, seed ^ (0x9e3779b97f4a7c15ULL * (uint64_t)(s + 1)));
    PerSeed &r = res[s];
    const int64_t root = seeds[s];
    std::unordered_set<int64_t> visited{root};
    std::vector<int64_t> frontier{root}, next;

    for (int64_t d = 0; d < depth && !frontier.empty(); d++) {
      next.clear();
      for (const int64_t v : frontier) {
        const int64_t start = rowptr[v], deg = rowptr[v + 1] - rowptr[v];
        auto visit = [&](int64_t e) {
          const int64_t w = col[e];
          if (visited.insert(w).second) next.push_back(w);
        };
        if (num_neighbors < 0 || (!replace && deg <= num_neighbors)) {
          for (int64_t j = 0; j < deg; j++) visit(start + j);
        } else if (replace) {
          if (deg > 0)
            for (int64_t j = 0; j < num_neighbors; j++)
              visit(start + rng_below(&rng, deg));
        } else {
          std::unordered_set<int64_t> perm;
          perm.reserve(num_neighbors * 2);
          for (int64_t j = deg - num_neighbors; j < deg; j++) {
            if (!perm.insert(rng_below(&rng, j)).second) perm.insert(j);
          }
          for (const int64_t p : perm) visit(start + p);
        }
      }
      std::sort(next.begin(), next.end());
      frontier = next;  // already unique (visited-gated)
    }

    r.nid.assign(visited.begin(), visited.end());
    std::sort(r.nid.begin(), r.nid.end());
    std::unordered_map<int64_t, int64_t> assoc;
    assoc.reserve(r.nid.size() * 2);
    for (size_t i = 0; i < r.nid.size(); i++) assoc[r.nid[i]] = (int64_t)i;
    r.root_local = assoc[root];

    for (size_t i = 0; i < r.nid.size(); i++) {
      const int64_t v = r.nid[i];
      for (int64_t e = rowptr[v]; e < rowptr[v + 1]; e++) {
        const auto it = assoc.find(col[e]);
        if (it == assoc.end()) continue;
        r.row.push_back((int64_t)i);
        r.colv.push_back(it->second);
        r.eid.push_back(e);
      }
    }
  }

  int64_t node_off = 0, edge_off = 0;
  if (!count_only) out_ptr[0] = 0;
  for (int64_t s = 0; s < n_seeds; s++) {
    const PerSeed &r = res[s];
    if (!count_only) {
      for (size_t i = 0; i < r.row.size(); i++) {
        out_row[edge_off + (int64_t)i] = node_off + r.row[i];
        out_col[edge_off + (int64_t)i] = node_off + r.colv[i];
        out_eid[edge_off + (int64_t)i] = r.eid[i];
      }
      for (size_t i = 0; i < r.nid.size(); i++)
        out_nid[node_off + (int64_t)i] = r.nid[i];
      out_root[s] = node_off + r.root_local;
      out_ptr[s + 1] = node_off + (int64_t)r.nid.size();
    }
    node_off += (int64_t)r.nid.size();
    edge_off += (int64_t)r.row.size();
  }
  counts[0] = node_off;
  counts[1] = edge_off;
}

// ---------------------------------------------------------------------
// hetero_neighbor_sample: typed-graph multi-hop sampling (reference
// cpu/neighbor_sample_cpu.cpp:132-430, non-temporal path).
//
// Flattened dict encoding: relation r has source/destination node-type
// indices rel_src[r]/rel_dst[r]; its colptr lives at
// colptr_cat[colptr_off[r] .. colptr_off[r+1]) and its row array at
// row_cat[row_off[r] .. row_off[r+1]); per-hop budgets at
// budgets[r*num_hops + hop].  Input nodes per type are concatenated via
// inputs_off (n_types+1).
//
// Two-phase: out_nodes_cat == nullptr -> counts[0..T) node counts per
// type, counts[T..T+R) edge counts per relation; then call again with
// buffers sized from those counts (concatenated in type/relation order).
// Deterministic for a fixed seed.
// ---------------------------------------------------------------------
void hetero_neighbor_sample(
    int64_t n_types, int64_t n_rels, int64_t num_hops,
    const int64_t *rel_src, const int64_t *rel_dst,
    const int64_t *colptr_cat, const int64_t *colptr_off,
    const int64_t *row_cat, const int64_t *row_off,
    const int64_t *inputs_cat, const int64_t *inputs_off,
    const int64_t *budgets, int32_t replace, int32_t directed,
    uint64_t seed, int64_t *counts, int64_t *out_nodes_cat,
    int64_t *out_rows_cat, int64_t *out_cols_cat, int64_t *out_eids_cat) {
  const bool count_only = out_nodes_cat == nullptr;
  Rng rng;
  rng_seed(&rng, seed);

  std::vector<std::vector<int64_t>> samples(n_types);
  std::vector<std::unordered_map<int64_t, int64_t>> to_local(n_types);
  for (int64_t t = 0; t < n_types; t++) {
    for (int64_t i = inputs_off[t]; i < inputs_off[t + 1]; i++) {
      const int64_t v = inputs_cat[i];
      if (to_local[t].emplace(v, (int64_t)samples[t].size()).second)
        samples[t].push_back(v);
    }
  }

  std::vector<std::vector<int64_t>> rows(n_rels), cols(n_rels),
      eids(n_rels);
  std::vector<int64_t> begin(n_types, 0), end(n_types);
  for (int64_t t = 0; t < n_types; t++) end[t] = (int64_t)samples[t].size();

  for (int64_t ell = 0; ell < num_hops; ell++) {
    for (int64_t r = 0; r < n_rels; r++) {
      const int64_t st = rel_src[r], dt = rel_dst[r];
      const int64_t budget = budgets[r * num_hops + ell];
      const int64_t *cp = colptr_cat + colptr_off[r];
      const int64_t *rw = row_cat + row_off[r];

      auto visit = [&](int64_t e, int64_t i) {
        const int64_t v = rw[e];
        auto res = to_local[st].emplace(v, (int64_t)samples[st].size());
        if (res.second) samples[st].push_back(v);
        if (directed) {
          rows[r].push_back(res.first->second);
          cols[r].push_back(i);
          eids[r].push_back(e);
        }
      };

      for (int64_t i = begin[dt]; i < end[dt]; i++) {
        const int64_t w = samples[dt][i];
        const int64_t start = cp[w], deg = cp[w + 1] - cp[w];
        if (deg == 0) continue;
        if (budget < 0 || (!replace && budget >= deg)) {
          for (int64_t j = 0; j < deg; j++) visit(start + j, i);
        } else if (replace) {
          for (int64_t j = 0; j < budget; j++)
            visit(start + rng_below(&rng, deg), i);
        } else {
          std::unordered_set<int64_t> perm;
          for (int64_t j = deg - budget; j < deg; j++) {
            int64_t rnd = rng_below(&rng, j);
            if (!perm.insert(rnd).second) {
              rnd = j;
              perm.insert(j);
            }
            visit(start + rnd, i);
          }
        }
      }
    }
    for (int64_t t = 0; t < n_types; t++) {
      begin[t] = end[t];
      end[t] = (int64_t)samples[t].size();
    }
  }

  if (!directed) {
    for (int64_t r = 0; r < n_rels; r++) {
      const int64_t st = rel_src[r], dt = rel_dst[r];
      const int64_t *cp = colptr_cat + colptr_off[r];
      const int64_t *rw = row_cat + row_off[r];
      for (int64_t i = 0; i < (int64_t)samples[dt].size(); i++) {
        const int64_t w = samples[dt][i];
        for (int64_t e = cp[w]; e < cp[w + 1]; e++) {
          const auto it = to_local[st].find(rw[e]);
          if (it != to_local[st].end()) {
            rows[r].push_back(it->second);
            cols[r].push_back(i);
            eids[r].push_back(e);
          }
        }
      }
    }
  }

  for (int64_t t = 0; t < n_types; t++)
    counts[t] = (int64_t)samples[t].size();
  for (int64_t r = 0; r < n_rels; r++)
    counts[n_types + r] = (int64_t)rows[r].size();

  if (!count_only) {
    int64_t npos = 0, epos = 0;
    for (int64_t t = 0; t < n_types; t++) {
      std::memcpy(out_nodes_cat + npos, samples[t].data(),
                  samples[t].size() * sizeof(int64_t));
      npos += (int64_t)samples[t].size();
    }
    for (int64_t r = 0; r < n_rels; r++) {
      std::memcpy(out_rows_cat + epos, rows[r].data(),
                  rows[r].size() * sizeof(int64_t));
      std::memcpy(out_cols_cat + epos, cols[r].data(),
                  cols[r].size() * sizeof(int64_t));
      std::memcpy(out_eids_cat + epos, eids[r].data(),
                  eids[r].size() * sizeof(int64_t));
      epos += (int64_t)rows[r].size();
    }
  }
}

// ---------------------------------------------------------------------
// hetero_temporal_neighbor_sample (reference
// cpu/neighbor_sample_cpu.cpp:119-130 `satisfy_time` + temporal
// branches): a sampled source must satisfy time[src] <= time[root], and
// computation trees of different roots stay disjoint — relabeling is
// keyed (node, root), so a node may appear once per seed.
//
// Same flattened encoding as hetero_neighbor_sample plus per-type node
// times: type t's times at time_cat[time_off[t] ..) when has_time[t].
// Two-phase like the others.
// ---------------------------------------------------------------------
void hetero_temporal_neighbor_sample(
    int64_t n_types, int64_t n_rels, int64_t num_hops,
    const int64_t *rel_src, const int64_t *rel_dst,
    const int64_t *colptr_cat, const int64_t *colptr_off,
    const int64_t *row_cat, const int64_t *row_off,
    const int64_t *inputs_cat, const int64_t *inputs_off,
    const int64_t *budgets, const int64_t *time_cat,
    const int64_t *time_off, const int32_t *has_time, int32_t replace,
    int32_t directed, uint64_t seed, int64_t *counts,
    int64_t *out_nodes_cat, int64_t *out_rows_cat, int64_t *out_cols_cat,
    int64_t *out_eids_cat) {
  const bool count_only = out_nodes_cat == nullptr;
  Rng rng;
  rng_seed(&rng, seed);
  const int64_t INT64_MAX_T = INT64_C(0x7fffffffffffffff);

  const int64_t n_roots = inputs_off[n_types];  // one root per input node
  std::vector<std::vector<int64_t>> samples(n_types);
  std::vector<std::vector<int64_t>> root_time(n_types), root_id(n_types);
  // (node, root) -> local id, keyed node * n_roots + root.
  std::vector<std::unordered_map<int64_t, int64_t>> to_local(n_types);

  int64_t root_counter = 0;
  for (int64_t t = 0; t < n_types; t++) {
    for (int64_t i = inputs_off[t]; i < inputs_off[t + 1]; i++) {
      const int64_t v = inputs_cat[i];
      const int64_t tm =
          has_time[t] ? time_cat[time_off[t] + v] : INT64_MAX_T;
      to_local[t][v * n_roots + root_counter] =
          (int64_t)samples[t].size();
      samples[t].push_back(v);
      root_time[t].push_back(tm);
      root_id[t].push_back(root_counter);
      root_counter++;
    }
  }

  std::vector<std::vector<int64_t>> rows(n_rels), cols(n_rels),
      eids(n_rels);
  std::vector<int64_t> begin(n_types, 0), end(n_types);
  for (int64_t t = 0; t < n_types; t++) end[t] = (int64_t)samples[t].size();

  std::vector<int64_t> ok;
  for (int64_t ell = 0; ell < num_hops; ell++) {
    for (int64_t r = 0; r < n_rels; r++) {
      const int64_t st = rel_src[r], dt = rel_dst[r];
      const int64_t budget = budgets[r * num_hops + ell];
      const int64_t *cp = colptr_cat + colptr_off[r];
      const int64_t *rw = row_cat + row_off[r];
      const int64_t *src_time =
          has_time[st] ? time_cat + time_off[st] : nullptr;

      for (int64_t i = begin[dt]; i < end[dt]; i++) {
        const int64_t w = samples[dt][i];
        const int64_t t_root = root_time[dt][i];
        const int64_t root = root_id[dt][i];
        const int64_t start = cp[w], deg = cp[w + 1] - cp[w];
        if (deg == 0) continue;
        ok.clear();
        for (int64_t j = 0; j < deg; j++) {
          if (!src_time || src_time[rw[start + j]] <= t_root)
            ok.push_back(j);
        }
        const int64_t n_ok = (int64_t)ok.size();
        if (n_ok == 0) continue;

        auto visit = [&](int64_t oj) {
          const int64_t e = start + ok[oj];
          const int64_t v = rw[e];
          auto res = to_local[st].emplace(v * n_roots + root,
                                          (int64_t)samples[st].size());
          if (res.second) {
            samples[st].push_back(v);
            root_time[st].push_back(t_root);
            root_id[st].push_back(root);
          }
          if (directed) {
            rows[r].push_back(res.first->second);
            cols[r].push_back(i);
            eids[r].push_back(e);
          }
        };

        if (budget < 0 || (!replace && budget >= n_ok)) {
          for (int64_t j = 0; j < n_ok; j++) visit(j);
        } else if (replace) {
          for (int64_t j = 0; j < budget; j++)
            visit(rng_below(&rng, n_ok));
        } else {
          std::unordered_set<int64_t> perm;
          for (int64_t j = n_ok - budget; j < n_ok; j++) {
            int64_t rnd = rng_below(&rng, j);
            if (!perm.insert(rnd).second) {
              rnd = j;
              perm.insert(j);
            }
            visit(rnd);
          }
        }
      }
    }
    for (int64_t t = 0; t < n_types; t++) {
      begin[t] = end[t];
      end[t] = (int64_t)samples[t].size();
    }
  }

  for (int64_t t = 0; t < n_types; t++)
    counts[t] = (int64_t)samples[t].size();
  for (int64_t r = 0; r < n_rels; r++)
    counts[n_types + r] = (int64_t)rows[r].size();

  if (!count_only) {
    int64_t npos = 0, epos = 0;
    for (int64_t t = 0; t < n_types; t++) {
      std::memcpy(out_nodes_cat + npos, samples[t].data(),
                  samples[t].size() * sizeof(int64_t));
      npos += (int64_t)samples[t].size();
    }
    for (int64_t r = 0; r < n_rels; r++) {
      std::memcpy(out_rows_cat + epos, rows[r].data(),
                  rows[r].size() * sizeof(int64_t));
      std::memcpy(out_cols_cat + epos, cols[r].data(),
                  cols[r].size() * sizeof(int64_t));
      std::memcpy(out_eids_cat + epos, eids[r].data(),
                  eids[r].size() * sizeof(int64_t));
      epos += (int64_t)rows[r].size();
    }
  }
}

// ---------------------------------------------------------------------
// sample_adj: one-hop sampled bipartite adjacency
// (reference cpu/sample_cpu.cpp:10-137).
//
// Caller sizes outputs exactly:
//   E_out = sum over idx of (deg            if num_neighbors < 0
//                            num*(deg>0)    if replace
//                            min(deg, num)  otherwise)
//   n_id buffer capacity: n_idx + E_out.
// Outputs: out_rowptr (n_idx+1), out_col/out_eid (E_out), n_id.
// Per-row cols sorted by local id. Returns the n_id count.
int64_t sample_adj(const int64_t *rowptr, const int64_t *col, int64_t n_nodes,
                   const int64_t *idx, int64_t n_idx, int64_t num_neighbors,
                   int32_t replace, uint64_t seed, int64_t *out_rowptr,
                   int64_t *out_col, int64_t *out_eid, int64_t *n_id) {
  (void)n_nodes;
  std::unordered_map<int64_t, int64_t> n_id_map;
  n_id_map.reserve(2 * n_idx);
  int64_t n_count = 0;
  for (int64_t i = 0; i < n_idx; i++) {
    n_id_map[idx[i]] = i;
    n_id[n_count++] = idx[i];
  }

  // Parallel candidate draw (per-seed RNG streams), then a sequential
  // relabel merge in frontier order (the hash-map growth is inherently
  // ordered; the reference parallelizes the same way in its ego
  // sampler, cpu/ego_sample_cpu.cpp:34).
  std::vector<int64_t> offs(n_idx + 1, 0);
  for (int64_t i = 0; i < n_idx; i++) {
    const int64_t deg = rowptr[idx[i] + 1] - rowptr[idx[i]];
    offs[i + 1] = offs[i] + sample_size_of(deg, num_neighbors, replace);
  }
  std::vector<int64_t> buf(offs[n_idx]);
  draw_candidates(rowptr, idx, n_idx, num_neighbors, replace, seed,
                  /*stream=*/0, offs.data(), buf.data());

  std::vector<std::pair<int64_t, int64_t>> row_buf;  // (local col, e_id)
  int64_t out_pos = 0;
  out_rowptr[0] = 0;
  for (int64_t i = 0; i < n_idx; i++) {
    row_buf.clear();
    for (int64_t t = offs[i]; t < offs[i + 1]; t++) {
      const int64_t e = buf[t];
      const int64_t c = col[e];
      auto it = n_id_map.find(c);
      int64_t local;
      if (it == n_id_map.end()) {
        local = n_count;
        n_id_map.emplace(c, local);
        n_id[n_count++] = c;
      } else {
        local = it->second;
      }
      row_buf.emplace_back(local, e);
    }
    std::sort(row_buf.begin(), row_buf.end());
    for (const auto &pr : row_buf) {
      out_col[out_pos] = pr.first;
      out_eid[out_pos] = pr.second;
      out_pos++;
    }
    out_rowptr[i + 1] = out_pos;
  }
  return n_count;
}

// ---------------------------------------------------------------------
// neighbor_sample (homogeneous, CSC-driven, reference
// cpu/neighbor_sample_cpu.cpp:16-118).
//
// Two-phase: call with out_* = nullptr to get counts packed into
// counts[0]=n_samples, counts[1]=n_edges; then call again with buffers.
// Deterministic for a fixed seed, so both phases sample identically.
// ---------------------------------------------------------------------
void neighbor_sample(const int64_t *colptr, const int64_t *row,
                     int64_t n_nodes, const int64_t *input_node,
                     int64_t n_input, const int64_t *num_neighbors,
                     int64_t num_hops, int32_t replace, int32_t directed,
                     uint64_t seed, int64_t *counts, int64_t *out_nodes,
                     int64_t *out_rows, int64_t *out_cols,
                     int64_t *out_edges) {
  (void)n_nodes;
  std::vector<int64_t> samples(input_node, input_node + n_input);
  std::unordered_map<int64_t, int64_t> to_local;
  to_local.reserve(4 * n_input);
  for (int64_t i = 0; i < n_input; i++) to_local[input_node[i]] = i;

  std::vector<int64_t> rows, cols, edges;

  auto visit = [&](int64_t e, int64_t i) {
    const int64_t v = row[e];
    auto res = to_local.emplace(v, (int64_t)samples.size());
    if (res.second) samples.push_back(v);
    if (directed) {
      rows.push_back(res.first->second);
      cols.push_back(i);
      edges.push_back(e);
    }
  };

  // Per hop: parallel candidate draw over the frontier (per-(hop, row)
  // RNG streams — thread-count invariant), then a sequential relabel
  // merge in frontier order so the to_local growth stays deterministic.
  int64_t begin = 0, end = (int64_t)samples.size();
  std::vector<int64_t> offs, buf;
  for (int64_t ell = 0; ell < num_hops; ell++) {
    const int64_t num = num_neighbors[ell];
    const int64_t n_front = end - begin;
    offs.assign(n_front + 1, 0);
    for (int64_t i = 0; i < n_front; i++) {
      const int64_t w = samples[begin + i];
      const int64_t deg = colptr[w + 1] - colptr[w];
      offs[i + 1] = offs[i] + sample_size_of(deg, num, replace);
    }
    buf.resize(offs[n_front]);
    draw_candidates(colptr, samples.data() + begin, n_front, num,
                    replace, seed, /*stream=*/(uint64_t)(ell + 1),
                    offs.data(), buf.data());
    for (int64_t i = 0; i < n_front; i++)
      for (int64_t t = offs[i]; t < offs[i + 1]; t++)
        visit(buf[t], begin + i);
    begin = end;
    end = (int64_t)samples.size();
  }

  if (!directed) {
    for (int64_t i = 0; i < (int64_t)samples.size(); i++) {
      const int64_t w = samples[i];
      for (int64_t e = colptr[w]; e < colptr[w + 1]; e++) {
        auto it = to_local.find(row[e]);
        if (it != to_local.end()) {
          rows.push_back(it->second);
          cols.push_back(i);
          edges.push_back(e);
        }
      }
    }
  }

  counts[0] = (int64_t)samples.size();
  counts[1] = (int64_t)rows.size();
  if (out_nodes) {
    std::memcpy(out_nodes, samples.data(), samples.size() * sizeof(int64_t));
    std::memcpy(out_rows, rows.data(), rows.size() * sizeof(int64_t));
    std::memcpy(out_cols, cols.data(), cols.size() * sizeof(int64_t));
    std::memcpy(out_edges, edges.data(), edges.size() * sizeof(int64_t));
  }
}

// ---------------------------------------------------------------------
// saint_subgraph: node-induced subgraph (reference cpu/saint_cpu.cpp).
// Two-phase via counts[0] = number of kept edges.
// ---------------------------------------------------------------------
void saint_subgraph(const int64_t *rowptr, const int64_t *col,
                    int64_t n_nodes, const int64_t *idx, int64_t n_idx,
                    int64_t *counts, int64_t *out_row, int64_t *out_col,
                    int64_t *out_eid) {
  std::vector<int64_t> assoc(n_nodes, -1);
  for (int64_t i = 0; i < n_idx; i++) assoc[idx[i]] = i;

  int64_t k = 0;
  for (int64_t i = 0; i < n_idx; i++) {
    const int64_t v = idx[i];
    for (int64_t e = rowptr[v]; e < rowptr[v + 1]; e++) {
      const int64_t w = assoc[col[e]];
      if (w >= 0) {
        if (out_row) {
          out_row[k] = i;
          out_col[k] = w;
          out_eid[k] = e;
        }
        k++;
      }
    }
  }
  counts[0] = k;
}

// ---------------------------------------------------------------------
// relabel_one_hop (reference cpu/relabel_cpu.cpp:45-143).
// E_out = sum(deg[idx]) (caller-computed); n_id capacity n_idx + E_out.
// Returns n_id count.
// ---------------------------------------------------------------------
int64_t relabel_one_hop(const int64_t *rowptr, const int64_t *col,
                        const int64_t *idx, int64_t n_idx,
                        int64_t *out_rowptr, int64_t *out_col,
                        int64_t *out_eid, int64_t *n_id) {
  std::unordered_map<int64_t, int64_t> n_id_map;
  n_id_map.reserve(4 * n_idx);
  int64_t n_count = 0;
  for (int64_t i = 0; i < n_idx; i++) {
    n_id_map[idx[i]] = i;
    n_id[n_count++] = idx[i];
  }
  int64_t pos = 0;
  out_rowptr[0] = 0;
  for (int64_t i = 0; i < n_idx; i++) {
    const int64_t v = idx[i];
    for (int64_t e = rowptr[v]; e < rowptr[v + 1]; e++) {
      const int64_t w = col[e];
      auto res = n_id_map.emplace(w, n_count);
      if (res.second) n_id[n_count++] = w;
      out_col[pos] = res.first->second;
      out_eid[pos] = e;
      pos++;
    }
    out_rowptr[i + 1] = pos;
  }
  return n_count;
}

}  // extern "C"
