// The port's host library: the multilevel graph partitioner.
//
// Replaces the partitioner of pytorch_sparse_tpu/csrc/native.cpp (the
// JAX package's native host library): its RNG, `CoarseGraph`,
// `refine_level`, `heavy_edge_matching`, `multilevel_partition_impl`
// with the entries `multilevel_partition_ew`, `multilevel_partition`
// and the OpenMP `multilevel_partition_mt`, and `coarsen_clusters`, copied
// line for line so that the same inputs and seed give the same clusters
// (the same int32 internal ids, the same order of RNG draws, the same
// double arithmetic).  Host code, not a kernel: it runs on the CPU of
// the machine that holds the card, before any launch.
//
// METIS-style k-way partitioning (the reference binds libmetis,
// torch_sparse csrc/cpu/metis_cpu.cpp:13-62):
//   1. coarsen by heavy-edge matching until the graph is small,
//   2. initial partition by weight-balanced greedy region growing
//      (12 randomized restarts, the best balance-penalized cut kept),
//   3. uncoarsen, refining at every level with an edge-weighted
//      boundary sweep under a balance constraint.
// `coarsen_clusters` runs the coarsening levels alone and returns each
// node's ancestor at the level closest to a target cluster count: the
// cheap layout pass behind `partition_fine`.
//
// Plain C ABI, loaded with ctypes (pytorch_sparse_tpu_torch/partition/
// _native.py) after `_build.load` compiles it with the host C++
// compiler: -O3 -march=native -fopenmp -fPIC -shared -std=c++17 and
// -ffp-contract=off.  Index arrays are int64, node weights double, edge
// weights int64 (nullptr: all ones); n < 2^31.  The threaded entry is
// nondeterministic under real concurrency (its matching claims nodes
// with compare-and-swap), like mt-metis.

#include <algorithm>
#include <cstdint>
#include <queue>
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

}  // namespace

// ---------------------------------------------------------------------
// The multilevel partitioner.
//
// Engineering notes (the hot path is memory traffic, not FLOPs):
//  * internal node ids are int32 (n < 2^31 by contract), which halves
//    the random-access footprint of match/cmap/cluster;
//  * the coarse graph is built with METIS-style mark/position arrays
//    (one O(E) pass, sequential writes), not per-node hash maps;
//  * level 0 converts col once to int32, and unit edge weights stay
//    implicit (ew empty <=> all ones);
//  * refinement sweeps only the boundary, and per-node gains touch
//    only the parts actually adjacent (reset through a touched list);
//  * the _mt entry runs the streaming phases (conversion, matching by
//    CAS claims, boundary detection, final cut) under OpenMP.
// ---------------------------------------------------------------------
namespace {

typedef int32_t pidx;  // internal node id; n < 2^31 by ABI contract

struct CoarseGraph {
  std::vector<int64_t> rowptr;  // (n + 1)
  std::vector<pidx> col;
  std::vector<int64_t> ew;      // empty => unit weights (level 0 unweighted)
  std::vector<double> nw;
  inline int64_t ew_at(int64_t e) const { return ew.empty() ? 1 : ew[e]; }
};

// Edge-weighted boundary refinement under a balance limit.  Pass 0
// sweeps every node; later passes sweep only nodes whose neighborhood
// changed.  With non-negative weights a node with no neighbor outside
// its own part can never move, so the boundary restriction is exact.
void refine_level(const CoarseGraph &g, std::vector<pidx> &cluster,
                  int64_t num_parts, double limit, int64_t passes,
                  bool par) {
  const int64_t n = (int64_t)g.nw.size();
  std::vector<double> part_w(num_parts, 0.0);
  for (int64_t v = 0; v < n; v++) part_w[cluster[v]] += g.nw[v];

  // gains are accumulated sparsely: `gain` stays zeroed between nodes,
  // reset through `touched`.
  std::vector<int64_t> gain(num_parts, 0);
  std::vector<pidx> touched;
  touched.reserve(num_parts);

  std::vector<uint8_t> bnd(n, 0);
  std::vector<pidx> boundary;

  // Boundary-restricted Gauss-Seidel sweeps, exactly the classic
  // full-sweep refinement restricted to nodes that can actually move:
  // with non-negative weights an interior node's best gain is its own
  // part, so skipping it is exact.  The boundary is recomputed each
  // pass (a cheap early-break scan, parallel in the mt entry); nodes
  // that become boundary mid-pass behind the sweep point are caught on
  // the next pass, so run two extra passes to absorb the lag.
  for (int64_t pass = 0; pass < passes + 2; pass++) {
    std::fill(bnd.begin(), bnd.end(), 0);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (par)
#endif
    for (int64_t v = 0; v < n; v++) {
      const pidx p = cluster[v];
      for (int64_t e = g.rowptr[v]; e < g.rowptr[v + 1]; e++)
        if (cluster[g.col[e]] != p) {
          bnd[v] = 1;
          break;
        }
    }
    boundary.clear();
    for (int64_t v = 0; v < n; v++)
      if (bnd[v]) boundary.push_back((pidx)v);

    int64_t moves = 0;
    for (const pidx v : boundary) {
      const pidx p = cluster[v];
      const int64_t start = g.rowptr[v], end = g.rowptr[v + 1];
      if (end == start) continue;
      for (int64_t e = start; e < end; e++) {
        const pidx t = cluster[g.col[e]];
        if (gain[t] == 0) touched.push_back(t);
        gain[t] += g.ew_at(e);
      }
      pidx q = p;
      const int64_t gp = gain[p];
      for (const pidx t : touched) {
        if (t == p) continue;
        if (gain[t] > (q == p ? gp : gain[q]) ||
            (q != p && gain[t] == gain[q] && part_w[t] < part_w[q]))
          q = t;
      }
      const bool move = q != p && gain[q] > gp &&
                        part_w[q] + g.nw[v] <= limit;
      for (const pidx t : touched) gain[t] = 0;
      touched.clear();
      if (!move) continue;
      cluster[v] = q;
      part_w[p] -= g.nw[v];
      part_w[q] += g.nw[v];
      moves++;
    }
    if (moves == 0) break;
  }
}

// Heavy-edge matching in a shuffled visit order.  Serial version is
// deterministic for a given seed; the parallel version claims nodes
// with CAS (mt-metis-style, nondeterministic under contention).
void heavy_edge_matching(const CoarseGraph &g,
                         const std::vector<pidx> &order,
                         std::vector<pidx> &match, bool par) {
  const int64_t n = (int64_t)g.nw.size();
  match.assign(n, -1);
#ifdef _OPENMP
  if (par) {
#pragma omp parallel for schedule(dynamic, 2048)
    for (int64_t i = 0; i < n; i++) {
      const pidx v = order[i];
      pidx expected = -1;
      if (!__atomic_compare_exchange_n(&match[v], &expected, (pidx)-2,
                                       false, __ATOMIC_ACQ_REL,
                                       __ATOMIC_RELAXED))
        continue;  // claimed by a neighbor's CAS
      pidx claimed = v;  // self-match unless a neighbor is free
      int64_t best_w = -1;
      for (int64_t e = g.rowptr[v]; e < g.rowptr[v + 1]; e++) {
        const pidx u = g.col[e];
        if (u == v) continue;
        const int64_t w = g.ew_at(e);
        if (w <= best_w) continue;
        if (__atomic_load_n(&match[u], __ATOMIC_RELAXED) != -1) continue;
        pidx exp_u = -1;
        if (__atomic_compare_exchange_n(&match[u], &exp_u, v, false,
                                        __ATOMIC_ACQ_REL,
                                        __ATOMIC_RELAXED)) {
          if (claimed != v)  // release the previously claimed neighbor
            __atomic_store_n(&match[claimed], (pidx)-1, __ATOMIC_RELEASE);
          claimed = u;
          best_w = w;
        }
      }
      __atomic_store_n(&match[v], claimed, __ATOMIC_RELEASE);
    }
    // A node u1 can be claimed by v, skip its own iteration (its CAS
    // fails), and then be released back to -1 when v upgrades to a
    // heavier neighbor.  Nothing revisits it, so it would reach the
    // coarsening loop with match == -1 and drive an out-of-bounds
    // cmap[-1] write.  Self-match any such orphan after the barrier;
    // only the releasing thread ever wrote its slot, so a plain store
    // is safe here.
#pragma omp parallel for schedule(static)
    for (int64_t v = 0; v < n; v++)
      if (match[v] < 0) match[v] = (pidx)v;
    return;
  }
#else
  (void)par;
#endif
  for (const pidx v : order) {
    if (match[v] >= 0) continue;
    pidx best = -1;
    int64_t best_w = -1;
    for (int64_t e = g.rowptr[v]; e < g.rowptr[v + 1]; e++) {
      const pidx u = g.col[e];
      if (u == v || match[u] >= 0) continue;
      if (g.ew_at(e) > best_w) {
        best_w = g.ew_at(e);
        best = u;
      }
    }
    match[v] = best >= 0 ? best : v;
    if (best >= 0) match[best] = v;
  }
}

int64_t multilevel_partition_impl(const int64_t *rowptr_in,
                                  const int64_t *col_in, int64_t n_nodes,
                                  const double *node_w,
                                  const int64_t *edge_w, int64_t num_parts,
                                  uint64_t seed, double imbalance,
                                  int64_t *cluster_out, bool par) {
  Rng rng;
  rng_seed(&rng, seed ? seed : 1);

  const int64_t E0 = rowptr_in[n_nodes];
  // Level 0 references the input shape; col converts to int32 once and
  // unit edge weights stay implicit (the reference's unweighted METIS
  // call, metis_cpu.cpp:13-62).
  std::vector<CoarseGraph> levels(1);
  levels[0].rowptr.assign(rowptr_in, rowptr_in + n_nodes + 1);
  levels[0].col.resize(E0);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (par)
#endif
  for (int64_t e = 0; e < E0; e++) levels[0].col[e] = (pidx)col_in[e];
  if (edge_w) levels[0].ew.assign(edge_w, edge_w + E0);
  levels[0].nw.resize(n_nodes);
  double total_w = 0.0;
  for (int64_t v = 0; v < n_nodes; v++) {
    levels[0].nw[v] = node_w ? node_w[v] : 1.0;
    total_w += levels[0].nw[v];
  }
  const double limit = (1.0 + imbalance) * total_w / (double)num_parts;
  // Stop coarsening around 24 nodes/part (METIS-like); below that the
  // contraction merges across community boundaries and the initial cut
  // degrades.  Small graphs (n < ~2 * target) skip coarsening entirely
  // and rely on the GGGP init + restarts below.
  const int64_t coarse_target =
      std::max<int64_t>(128, 24 * num_parts);

  std::vector<std::vector<pidx>> cmaps;  // fine node -> coarse node
  std::vector<pidx> order, match;
  while ((int64_t)levels.back().nw.size() > coarse_target) {
    const CoarseGraph &g = levels.back();
    const int64_t n = (int64_t)g.nw.size();
    // Heavy-edge matching in random visit order.
    order.resize(n);
    for (int64_t i = 0; i < n; i++) order[i] = (pidx)i;
    for (int64_t i = n - 1; i > 0; i--)
      std::swap(order[i], order[rng_below(&rng, i + 1)]);
    heavy_edge_matching(g, order, match, par);
    // Coarse ids + the 1-2 fine nodes behind each coarse node.
    std::vector<pidx> cmap(n, -1);
    std::vector<pidx> fine0, fine1;
    fine0.reserve(n / 2 + 16);
    fine1.reserve(n / 2 + 16);
    pidx nc = 0;
    for (int64_t v = 0; v < n; v++) {
      if (cmap[v] >= 0) continue;
      const pidx u = match[v];  // == v for unmatched
      cmap[v] = nc;
      cmap[u] = nc;
      fine0.push_back((pidx)v);
      fine1.push_back(u == (pidx)v ? (pidx)-1 : u);
      nc++;
    }
    if (nc >= n * 9 / 10) break;  // matching stalled
    // Build the coarse graph: one O(E) pass with mark/position arrays
    // (sequential writes into a preallocated buffer; no hashing).
    CoarseGraph cg;
    cg.nw.assign(nc, 0.0);
    for (int64_t v = 0; v < n; v++) cg.nw[cmap[v]] += g.nw[v];
    cg.rowptr.assign(nc + 1, 0);
    cg.col.resize(g.col.size());
    cg.ew.resize(g.col.size());
    std::vector<pidx> mark(nc, -1);
    std::vector<int64_t> pos(nc);
    int64_t cur = 0;
    for (pidx cv = 0; cv < nc; cv++) {
      const pidx pair[2] = {fine0[cv], fine1[cv]};
      for (const pidx f : pair) {
        if (f < 0) continue;
        for (int64_t e = g.rowptr[f]; e < g.rowptr[f + 1]; e++) {
          const pidx cu = cmap[g.col[e]];
          if (cu == cv) continue;
          if (mark[cu] != cv) {
            mark[cu] = cv;
            pos[cu] = cur;
            cg.col[cur] = cu;
            cg.ew[cur] = g.ew_at(e);
            cur++;
          } else {
            cg.ew[pos[cu]] += g.ew_at(e);
          }
        }
      }
      cg.rowptr[cv + 1] = cur;
    }
    cg.col.resize(cur);
    cg.col.shrink_to_fit();
    cg.ew.resize(cur);
    cg.ew.shrink_to_fit();
    // Shuffle each coarse row's neighbor run: matching breaks weight
    // ties by first-seen order, and discovery order (all of a pair's
    // merged neighbors consecutively) systematically biases the next
    // level's hierarchy toward locked contiguous blocks that the
    // refinement sweeps cannot unstick (measured: 13-20% final cut vs
    // 8.8% with randomized ties on a 64-community graph).  The old
    // hash-map build got this diversity for free from its iteration
    // order; keep it deliberately here.
    for (pidx cv = 0; cv < nc; cv++)
      for (int64_t e = cg.rowptr[cv + 1] - 1; e > cg.rowptr[cv]; e--) {
        const int64_t j =
            cg.rowptr[cv] + rng_below(&rng, e - cg.rowptr[cv] + 1);
        std::swap(cg.col[e], cg.col[j]);
        std::swap(cg.ew[e], cg.ew[j]);
      }
    cmaps.push_back(std::move(cmap));
    levels.push_back(std::move(cg));
  }

  // Initial partition on the coarsest graph: greedy weighted region
  // growing (GGGP) — each part repeatedly absorbs the unassigned node
  // with the heaviest edge-weight connection to it, so heavy edges stay
  // interior from the start (BFS order ignores weights and strands the
  // adjwgt contract on graphs too small to coarsen).  The coarse graph
  // is tiny, so run several randomized restarts and keep the lowest
  // weighted cut (a single unlucky seed order can trap the greedy
  // growth + refinement in a bad basin).
  {
    CoarseGraph &g = levels.back();
    const int64_t n = (int64_t)g.nw.size();
    std::vector<pidx> best_cl;
    int64_t best_cut = -1;
    // The coarsest graph is tiny (~24 nodes/part), so restarts are
    // nearly free; 12 of them squeeze out most single-seed bad basins
    // (measured: the 4-restart build still hit 2x-of-optimal cuts on
    // ~1-in-4 community-graph seeds).
    for (int restart = 0; restart < 12; restart++) {
    std::vector<pidx> cl(n, -1);
    const double target = total_w / (double)num_parts;
    int64_t assigned = 0;
    std::vector<int64_t> conn(n, 0);  // weight into the growing part
    for (int64_t p = 0; p < num_parts && assigned < n; p++) {
      double w = 0.0;
      // seed: first unassigned node (randomized start offset)
      int64_t s = rng_below(&rng, n);
      for (int64_t i = 0; i < n; i++) {
        const int64_t v = (s + i) % n;
        if (cl[v] < 0) {
          s = v;
          break;
        }
      }
      // lazy max-heap of (connection weight, node)
      std::priority_queue<std::pair<int64_t, int64_t>> heap;
      std::fill(conn.begin(), conn.end(), 0);
      auto absorb = [&](int64_t v) {
        cl[v] = (pidx)p;
        assigned++;
        w += g.nw[v];
        for (int64_t e = g.rowptr[v]; e < g.rowptr[v + 1]; e++) {
          const pidx u = g.col[e];
          if (cl[u] >= 0) continue;
          conn[u] += g.ew_at(e);
          heap.emplace(conn[u], (int64_t)u);
        }
      };
      absorb(s);
      while (w < target) {
        if (heap.empty()) {
          // Frontier exhausted (disconnected coarse graph): reseed from
          // any unassigned node so the part still reaches its target
          // weight instead of staying a stranded fragment.
          int64_t s2 = -1;
          for (int64_t v = 0; v < n; v++)
            if (cl[v] < 0) {
              s2 = v;
              break;
            }
          if (s2 < 0) break;
          absorb(s2);
          continue;
        }
        const auto [cw, v] = heap.top();
        heap.pop();
        if (cl[v] >= 0 || cw != conn[v]) continue;  // stale entry
        absorb(v);
      }
      if (p == num_parts - 1) {
        for (int64_t v = 0; v < n; v++)
          if (cl[v] < 0) {
            cl[v] = (pidx)p;
            assigned++;
          }
      }
    }
    for (int64_t v = 0; v < n; v++)
      if (cl[v] < 0) cl[v] = (pidx)(num_parts - 1);
    refine_level(g, cl, num_parts, limit, 8, par);
    int64_t wcut = 0;
    for (int64_t v = 0; v < n; v++)
      for (int64_t e = g.rowptr[v]; e < g.rowptr[v + 1]; e++)
        if (cl[v] != cl[g.col[e]]) wcut += g.ew_at(e);
    // Balance-aware restart selection: a degenerate split (stranded
    // tiny parts, one giant part) often has a LOW cut, so min-cut alone
    // must not win — infeasible attempts are penalized by their excess
    // weight before the cut breaks ties.
    std::vector<double> pw(num_parts, 0.0);
    for (int64_t v = 0; v < n; v++) pw[cl[v]] += g.nw[v];
    double maxw = 0.0;
    for (int64_t t = 0; t < num_parts; t++) maxw = std::max(maxw, pw[t]);
    const double excess = std::max(0.0, maxw - limit);
    // One unit of imbalance is worth more than any edge: scale excess
    // by the total edge weight.
    int64_t total_ew = 0;
    if (g.ew.empty())
      total_ew = (int64_t)g.col.size();
    else
      for (const int64_t w_e : g.ew) total_ew += w_e;
    const int64_t score =
        wcut + (int64_t)(excess / std::max(total_w, 1.0) *
                         (double)(total_ew + 1) * 4.0);
    if (best_cut < 0 || score < best_cut) {
      best_cut = score;
      best_cl = cl;
    }
    }  // restarts
    // Project back through the levels.
    std::vector<pidx> cur = std::move(best_cl);
    for (int64_t li = (int64_t)cmaps.size() - 1; li >= 0; li--) {
      const std::vector<pidx> &cmap = cmaps[li];
      std::vector<pidx> fine(cmap.size());
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (par)
#endif
      for (int64_t v = 0; v < (int64_t)cmap.size(); v++)
        fine[v] = cur[cmap[v]];
      refine_level(levels[li], fine, num_parts, limit, li == 0 ? 4 : 2,
                   par);
      cur = std::move(fine);
    }
    for (int64_t v = 0; v < n_nodes; v++) cluster_out[v] = cur[v];
  }

  // Edge cut on the original graph.
  int64_t cut = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(+ : cut) if (par)
#endif
  for (int64_t v = 0; v < n_nodes; v++)
    for (int64_t e = rowptr_in[v]; e < rowptr_in[v + 1]; e++)
      if (cluster_out[v] != cluster_out[col_in[e]]) cut++;
  return cut / 2;
}

}  // namespace

extern "C" {

int64_t multilevel_partition_ew(const int64_t *rowptr_in,
                                const int64_t *col_in, int64_t n_nodes,
                                const double *node_w,
                                const int64_t *edge_w, int64_t num_parts,
                                uint64_t seed, double imbalance,
                                int64_t *cluster_out) {
  return multilevel_partition_impl(rowptr_in, col_in, n_nodes, node_w,
                                   edge_w, num_parts, seed, imbalance,
                                   cluster_out, /*par=*/false);
}

int64_t multilevel_partition(const int64_t *rowptr_in, const int64_t *col_in,
                             int64_t n_nodes, const double *node_w,
                             int64_t num_parts, uint64_t seed,
                             double imbalance, int64_t *cluster_out) {
  return multilevel_partition_ew(rowptr_in, col_in, n_nodes, node_w,
                                 nullptr, num_parts, seed, imbalance,
                                 cluster_out);
}

// Threaded entry (the analogue of the reference's mt-metis binding,
// csrc/metis.cpp:49-69 / csrc/cpu/metis_cpu.cpp:67-120): same pipeline
// with the streaming phases under OpenMP and CAS-claimed matching.
// num_workers <= 0 uses the OpenMP default.  Nondeterministic under
// real concurrency (matching claims race), like mt-metis.
int64_t multilevel_partition_mt(const int64_t *rowptr_in,
                                const int64_t *col_in, int64_t n_nodes,
                                const double *node_w,
                                const int64_t *edge_w, int64_t num_parts,
                                uint64_t seed, double imbalance,
                                int64_t num_workers, int64_t *cluster_out) {
#ifdef _OPENMP
  const int prev = omp_get_max_threads();
  if (num_workers > 0) omp_set_num_threads((int)num_workers);
  const int64_t cut = multilevel_partition_impl(
      rowptr_in, col_in, n_nodes, node_w, edge_w, num_parts, seed,
      imbalance, cluster_out, /*par=*/true);
  if (num_workers > 0) omp_set_num_threads(prev);
  return cut;
#else
  (void)num_workers;
  return multilevel_partition_impl(rowptr_in, col_in, n_nodes, node_w,
                                   edge_w, num_parts, seed, imbalance,
                                   cluster_out, /*par=*/false);
#endif
}

// ---------------------------------------------------------------------
// coarsen_clusters: fine clusters from the multilevel COARSENING
// hierarchy alone.  Heavy-edge matching merges the most tightly
// connected node pairs first, so the ancestors at a coarse level are
// the small communities that the hybrid router's (B, B) densify pass
// wants contiguous, without the k-way initial partition and per-level
// refinement whose cost grows with k: one O(E) matching and
// contraction a level.  Returns the number of clusters (about the
// target; more if matching stalls).
// ---------------------------------------------------------------------
int64_t coarsen_clusters(const int64_t *rowptr_in, const int64_t *col_in,
                         int64_t n_nodes, const int64_t *edge_w,
                         int64_t target_clusters, uint64_t seed,
                         int64_t *cluster_out) {
  if (target_clusters < 1) target_clusters = 1;
  Rng rng;
  rng_seed(&rng, seed ? seed : 1);

  const int64_t E0 = rowptr_in[n_nodes];
  CoarseGraph g;
  g.rowptr.assign(rowptr_in, rowptr_in + n_nodes + 1);
  g.col.resize(E0);
  for (int64_t e = 0; e < E0; e++) g.col[e] = (pidx)col_in[e];
  if (edge_w) g.ew.assign(edge_w, edge_w + E0);  // matching honors adjwgt
  g.nw.assign(n_nodes, 1.0);

  // label[v] = current coarse ancestor of input node v
  std::vector<pidx> label(n_nodes);
  for (int64_t v = 0; v < n_nodes; v++) label[v] = (pidx)v;

  std::vector<pidx> order, match;
  while ((int64_t)g.nw.size() > target_clusters) {
    const int64_t n = (int64_t)g.nw.size();
    order.resize(n);
    for (int64_t i = 0; i < n; i++) order[i] = (pidx)i;
    for (int64_t i = n - 1; i > 0; i--)
      std::swap(order[i], order[rng_below(&rng, i + 1)]);
    heavy_edge_matching(g, order, match, /*par=*/false);
    std::vector<pidx> cmap(n, -1);
    std::vector<pidx> fine0, fine1;
    fine0.reserve(n / 2 + 16);
    fine1.reserve(n / 2 + 16);
    pidx nc = 0;
    for (int64_t v = 0; v < n; v++) {
      if (cmap[v] >= 0) continue;
      const pidx u = match[v];
      cmap[v] = nc;
      cmap[u] = nc;
      fine0.push_back((pidx)v);
      fine1.push_back(u == (pidx)v ? (pidx)-1 : u);
      nc++;
    }
    if (nc >= n * 9 / 10) break;  // matching stalled
    // Stop at the level closest to the target in log space: a level
    // overshooting far past the target merges across community
    // boundaries, while stopping early only leaves slightly smaller
    // clusters.  prev-closer <=> n/target < target/nc.
    if ((int64_t)nc < target_clusters &&
        (double)n * (double)nc < (double)target_clusters *
                                     (double)target_clusters) {
      break;  // previous level was the better stop; discard this one
    }
    // contract (same mark/position build as the partitioner, unit
    // edge weights are enough for matching)
    CoarseGraph cg;
    cg.nw.assign(nc, 0.0);
    for (int64_t v = 0; v < n; v++) cg.nw[cmap[v]] += g.nw[v];
    cg.rowptr.assign(nc + 1, 0);
    cg.col.resize(g.col.size());
    cg.ew.resize(g.col.size());
    std::vector<pidx> mark(nc, -1);
    std::vector<int64_t> pos(nc);
    int64_t cur = 0;
    for (pidx cv = 0; cv < nc; cv++) {
      const pidx pair[2] = {fine0[cv], fine1[cv]};
      for (const pidx f : pair) {
        if (f < 0) continue;
        for (int64_t e = g.rowptr[f]; e < g.rowptr[f + 1]; e++) {
          const pidx cu = cmap[g.col[e]];
          if (cu == cv) continue;
          if (mark[cu] != cv) {
            mark[cu] = cv;
            pos[cu] = cur;
            cg.col[cur] = cu;
            cg.ew[cur] = g.ew_at(e);
            cur++;
          } else {
            cg.ew[pos[cu]] += g.ew_at(e);
          }
        }
      }
      cg.rowptr[cv + 1] = cur;
    }
    cg.col.resize(cur);
    cg.ew.resize(cur);
    // randomized neighbor order inside each row (see the partitioner's
    // note: discovery order biases the next matching level)
    for (pidx cv = 0; cv < nc; cv++)
      for (int64_t e = cg.rowptr[cv + 1] - 1; e > cg.rowptr[cv]; e--) {
        const int64_t j =
            cg.rowptr[cv] + rng_below(&rng, e - cg.rowptr[cv] + 1);
        std::swap(cg.col[e], cg.col[j]);
        std::swap(cg.ew[e], cg.ew[j]);
      }
    // fold this level into the running labels (no cmap stack kept:
    // labels compose forward, memory stays O(n))
    for (int64_t v = 0; v < n_nodes; v++) label[v] = cmap[label[v]];
    g = std::move(cg);
  }
  for (int64_t v = 0; v < n_nodes; v++) cluster_out[v] = label[v];
  return (int64_t)g.nw.size();
}

// ---------------------------------------------------------------------
// hgt_sample: Heterogeneous Graph Transformer layer-wise importance
// sampling (reference cpu/hgt_sample_cpu.cpp): per-type budgets of
// inverse-degree scores with a neighbor cap of 50, weighted node
// sampling proportional to budget^2 without replacement
// (Efraimidis-Spirakis keys), induced typed adjacency reconstruction.
// Flattened encoding and two-phase protocol as hetero_neighbor_sample;
// num_samples is (n_types * num_hops).

}  // extern "C"
