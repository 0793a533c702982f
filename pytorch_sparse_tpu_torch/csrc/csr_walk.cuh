// The CSR walk shared by csr_spmm (K1) and shard_spmm (K11a):
//
//   g[r, k] = sum_{p in [rowptr[r], rowptr[r+1])} val[p] * x[col[p], k]
//   out[map(r), k] = g[r, k]                       (write), or
//   out[map(r), k] = out[map(r), k] + g[r, k]      (accumulate)
//
// map(r) is row_map[r], or r without a row_map (K1 always).  rowptr may
// be a slice of a larger pointer array: its entries are absolute offsets
// into col and val.  val NULL means implicit ones.
//
// The contract on the sums: every output element is summed by one thread
// as acc = fmaf(v, x, acc) from 0.0f over its row's edges in CSR order
// (fmaf(1, x, acc) with implicit ones), and accumulate adds that sum to
// out once.  No atomics, no row split across threads, no reordering: the
// bits do not depend on the instance, the launch or the card's load.
//
// What bounds it on an H100.  The operand-once bound (each input read
// once) is device-memory bytes, but a walk reads one K-wide row of x per
// edge: from L2 where the rows an SM's edges reach sit there (community
// graphs, a shard's block), from device memory where x outgrows L2; and
// where the rows sit in L1 or L2, the issue rate of its per-edge
// instructions.  The design spends few instructions an edge and keeps
// several rows in flight:
//
//   * 16-byte loads.  A lane owns VEC = 4 adjacent columns of a chunk and
//     loads them as one float4 through the read-only path, so a K=128 row
//     is one warp-wide load instruction.  That needs K % 4 == 0 and x and
//     out on 16-byte boundaries; otherwise the same template runs with
//     VEC = 1 (one column a chunk).
//   * Lanes a row.  LPR = the lanes K needs at 4 columns a lane, rounded up
//     to a power of two (at most 32), so a warp walks 32 / LPR rows at once
//     (32 at K=1, 16 at K=8, 2 at K=40).  A sub-warp broadcasts its row's
//     indices with shuffles of width LPR and a mask of its own lanes.  A
//     lane owns CPL chunks, the chunk j at columns (s + LPR*j) * VEC of the
//     tile; K above 256 runs column tiles on gridDim.y.
//   * Edges in flight.  The sub-warp loads its row's (col, val) coalesced,
//     max(LPR, U) at a time, then issues the rows of U edges before the
//     first of their FMAs and adds them in edge order.  Every load is
//     unconditional (a tail edge reads the row's last edge again, a chunk
//     past K reads column 0) and only the FMAs and stores are predicated,
//     so the compiler can issue all U = 8 loads before the first FMA.
//
// The min/max walks (minmax_walk.cuh's, which K11b runs, and K7b's over
// the CSC view in spmm_minmax.cu) share the instance choice (choose, and
// the one table of instances that dispatch() launches), the grid, the
// 16-byte chunk loads, and walk_kernel's lane and batch arithmetic as
// Lanes (a lane's place in its sub-warp and its chunks' columns) and
// Batch (index batches clamped to the row's last edge, and their
// broadcast); they take fewer edges in flight where their registers would
// pass 64 a lane (edges_in_flight).  walk_kernel keeps that arithmetic
// spelled out as it was tuned, so that its instructions stay the same.
//
// csr_walk_instance() and the Python function walk_instance() in
// ops/kernels/csr_spmm.py choose the same instance for (K, aligned).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace csr_walk {

constexpr int kWarpsPerBlock = 8;
constexpr int kEdgesInFlight = 8;   // U
constexpr int kRowRegisters = 64;   // a lane's registers for rows in flight
constexpr int kTileColumns = 256;   // a column tile's width at most
constexpr unsigned kFullMask = 0xffffffffu;

struct Instance {
  int vec;     // columns a chunk: 4 (float4 loads) or 1
  int lanes;   // lanes a row (LPR), a power of two from 1 to 32
  int chunks;  // chunks a lane (CPL)
  int tiles;   // column tiles (gridDim.y)
};

inline int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

inline Instance choose(int K, bool aligned) {
  Instance in;
  in.vec = (aligned && K % 4 == 0) ? 4 : 1;
  in.lanes = next_pow2((K + 3) / 4);
  if (in.lanes > 32) in.lanes = 32;
  const int units = (K + in.vec - 1) / in.vec;
  in.chunks = next_pow2((units + in.lanes - 1) / in.lanes);
  const int cap = kTileColumns / (32 * in.vec);
  if (in.chunks > cap) in.chunks = cap;
  const int tile = in.lanes * in.vec * in.chunks;
  in.tiles = (K + tile - 1) / tile;
  return in;
}

// U for a min/max walk that counts `regs` registers a lane for each edge
// in flight (a power of two up to 64): walk_kernel's 8, or as many as
// fit in kRowRegisters.
__host__ __device__ constexpr int edges_in_flight(int regs) {
  return regs * kEdgesInFlight <= kRowRegisters ? kEdgesInFlight
                                                : kRowRegisters / regs;
}

// One chunk of VEC adjacent elements: one 16-byte load (float4 or int4)
// through the read-only path where VEC == 4, else one scalar load.
template <int VEC>
__device__ __forceinline__ void load_chunk(const float* __restrict__ p,
                                           float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_chunk(const int* __restrict__ p,
                                           int (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

// A lane's place in the walk of an instance: the row (or column) its
// sub-warp walks (item) and its place s in the sub-warp; after the
// bounds check, place() adds the sub-warp's shuffle mask and the lane's
// chunks, chunk j at column c0 + LPR * VEC * j of the block's tile
// (coff[j]: that column, or 0 for a chunk past K).
template <int VEC, int LPR, int CPL>
struct Lanes {
  static constexpr int RPW = 32 / LPR;      // rows a warp
  static constexpr int STRIDE = LPR * VEC;  // chunk j's offset
  int lane;
  int s;
  int item;
  unsigned mask;
  int c0;
  bool live[CPL];
  int coff[CPL];

  __device__ __forceinline__ Lanes()
      : lane(threadIdx.x & 31),
        s(lane % LPR),
        item((blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * RPW +
             lane / LPR) {}

  __device__ __forceinline__ void place(int K) {
    constexpr unsigned kSubMask =
        LPR == 32 ? kFullMask : (1u << (LPR % 32)) - 1u;
    mask = kSubMask << (lane - s);
    c0 = blockIdx.y * (STRIDE * CPL) + s * VEC;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      live[j] = c0 + STRIDE * j < K;
      coff[j] = live[j] ? c0 + STRIDE * j : 0;
    }
  }
};

// A sub-warp loads its row's edge indices CH = max(LPR, U) at a time,
// IPL a lane: lane s holds edge base + s + LPR * i (i < IPL), clamped to
// the row's last edge so that every load is unconditional.  take() hands
// every lane edge base + g + u of the batch, from the lane that loaded
// it: a register where LPR == 1, else a shuffle of the sub-warp.
template <int LPR, int U>
struct Batch {
  static constexpr int CH = LPR > U ? LPR : U;
  static constexpr int IPL = CH / LPR;

  static __device__ __forceinline__ int edge(int base, int s, int i,
                                             int end) {
    return min(base + s + LPR * i, end - 1);
  }

  template <typename T>
  static __device__ __forceinline__ T take(unsigned mask, const T (&m)[IPL],
                                           int g, int u) {
    if constexpr (LPR == 1) {
      return m[u];
    } else if constexpr (IPL == 1) {
      return __shfl_sync(mask, m[0], g + u, LPR);
    } else {
      return __shfl_sync(mask, m[u / LPR], u % LPR, LPR);
    }
  }
};

template <int VEC, int LPR, int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
walk_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
            const float* __restrict__ val, const float* __restrict__ x,
            const int* __restrict__ row_map, float* __restrict__ out, int R,
            int K, int accumulate) {
  constexpr int RPW = 32 / LPR;                         // rows a warp
  constexpr int U = kEdgesInFlight;
  constexpr int CH = LPR > U ? LPR : U;                 // indices a load
  constexpr int IPL = CH / LPR;                         // of them a lane
  constexpr int STRIDE = LPR * VEC;                     // chunk j's offset
  const int lane = threadIdx.x & 31;
  const int s = lane % LPR;
  const int row =
      (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * RPW + lane / LPR;
  if (row >= R) return;  // uniform across the sub-warp
  constexpr unsigned kSubMask =
      LPR == 32 ? kFullMask : (1u << (LPR % 32)) - 1u;
  const unsigned mask = kSubMask << (lane - s);  // the sub-warp's lanes
  const int c0 = blockIdx.y * (STRIDE * CPL) + s * VEC;
  bool live[CPL];
  int coff[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    live[j] = c0 + STRIDE * j < K;
    coff[j] = live[j] ? c0 + STRIDE * j : 0;
  }

  float acc[CPL][VEC];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[j][q] = 0.f;

  const int start = __ldg(rowptr + row);
  const int end = __ldg(rowptr + row + 1);
  for (int base = start; base < end; base += CH) {
    const int n = min(CH, end - base);
    int mc[IPL];
    float mv[IPL];
#pragma unroll
    for (int i = 0; i < IPL; ++i) {
      const int e = min(base + s + LPR * i, end - 1);
      mc[i] = __ldg(col + e);
      mv[i] = val != nullptr ? __ldg(val + e) : 1.f;
    }
    for (int g = 0; g < n; g += U) {
      int c[U];
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if constexpr (LPR == 1) {
          c[u] = mc[u];
          v[u] = mv[u];
        } else if constexpr (IPL == 1) {
          c[u] = __shfl_sync(mask, mc[0], g + u, LPR);
          v[u] = __shfl_sync(mask, mv[0], g + u, LPR);
        } else {
          c[u] = __shfl_sync(mask, mc[u / LPR], u % LPR, LPR);
          v[u] = __shfl_sync(mask, mv[u / LPR], u % LPR, LPR);
        }
      }
      float xv[U][CPL][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float* __restrict__ xr = x + (int64_t)c[u] * K;
#pragma unroll
        for (int j = 0; j < CPL; ++j) load_chunk<VEC>(xr + coff[j], xv[u][j]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (g + u < n) {
#pragma unroll
          for (int j = 0; j < CPL; ++j)
#pragma unroll
            for (int q = 0; q < VEC; ++q)
              acc[j][q] = fmaf(v[u], xv[u][j][q], acc[j][q]);
        }
      }
    }
  }

  const int orow = row_map != nullptr ? __ldg(row_map + row) : row;
  float* __restrict__ o = out + (int64_t)orow * K + c0;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (!live[j]) continue;
    float* __restrict__ oj = o + STRIDE * j;
    if constexpr (VEC == 4) {
      float4 r = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      if (accumulate) {
        const float4 p = *reinterpret_cast<const float4*>(oj);
        r = make_float4(p.x + r.x, p.y + r.y, p.z + r.z, p.w + r.w);
      }
      *reinterpret_cast<float4*>(oj) = r;
    } else {
      oj[0] = accumulate ? oj[0] + acc[j][0] : acc[j][0];
    }
  }
}

// The instance's (vec, lanes, chunks) as types, for dispatch().
template <int VEC_, int LPR_, int CPL_>
struct Shape {
  static constexpr int VEC = VEC_;
  static constexpr int LPR = LPR_;
  static constexpr int CPL = CPL_;
};

// Returns f(Shape<in.vec, in.lanes, in.chunks>{}): the one table of
// instances that every walk instantiates (tests/test_torch_csr_walk.py
// holds the Python choice to it).
template <typename F>
inline int dispatch(const Instance& in, F&& f) {
#define CSR_WALK_CASE(VEC_, LPR_, CPL_)                        \
  if (in.vec == VEC_ && in.lanes == LPR_ && in.chunks == CPL_) \
    return f(Shape<VEC_, LPR_, CPL_>{});
  CSR_WALK_CASE(4, 1, 1)
  CSR_WALK_CASE(4, 2, 1)
  CSR_WALK_CASE(4, 4, 1)
  CSR_WALK_CASE(4, 8, 1)
  CSR_WALK_CASE(4, 16, 1)
  CSR_WALK_CASE(4, 32, 1)
  CSR_WALK_CASE(4, 32, 2)
  CSR_WALK_CASE(1, 1, 1)
  CSR_WALK_CASE(1, 1, 2)
  CSR_WALK_CASE(1, 1, 4)
  CSR_WALK_CASE(1, 2, 4)
  CSR_WALK_CASE(1, 4, 4)
  CSR_WALK_CASE(1, 8, 4)
  CSR_WALK_CASE(1, 16, 4)
  CSR_WALK_CASE(1, 32, 4)
  CSR_WALK_CASE(1, 32, 8)
#undef CSR_WALK_CASE
  return (int)cudaErrorInvalidValue;  // no instance: a bug in choose()
}

// The grid of an instance over R rows (columns): a block walks
// kWarpsPerBlock * 32 / LPR of them, column tiles on gridDim.y.
inline dim3 grid_of(const Instance& in, int R) {
  const int rows_a_block = kWarpsPerBlock * (32 / in.lanes);
  return dim3((R + rows_a_block - 1) / rows_a_block, in.tiles);
}

// True where every pointer lies on a 16-byte boundary (NULLs do).
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return (bits & 15u) == 0;
}

// The walk on the caller's stream, as an instance of choose(K, aligned).
// Returns cudaGetLastError() after the launch (0 when R or K is 0).
inline int run(int device, const void* rowptr, const void* col,
               const void* val, const void* x, const void* row_map,
               void* out, int R, int K, int accumulate, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || K <= 0) return 0;
  const Instance in = choose(K, aligned16({x, out}));
  if (in.tiles > 65535) return (int)cudaErrorInvalidValue;
  const int* rp = static_cast<const int*>(rowptr);
  const int* ci = static_cast<const int*>(col);
  const float* v = static_cast<const float*>(val);
  const float* xp = static_cast<const float*>(x);
  const int* rm = static_cast<const int*>(row_map);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(in, [&](auto shape) {
    using S = decltype(shape);
    walk_kernel<S::VEC, S::LPR, S::CPL>
        <<<grid_of(in, R), kWarpsPerBlock * 32, 0, s>>>(
            rp, ci, v, xp, rm, op, R, K, accumulate);
    return (int)cudaGetLastError();
  });
}

}  // namespace csr_walk

extern "C" {

// The instance the walk runs for width K and operands on 16-byte
// boundaries (aligned != 0) or not: {vec, lanes, chunks, tiles} into
// out4.  Returns 0.  Defined here, so every library that includes this
// header (one .cu each) exports it.
int csr_walk_instance(int K, int aligned, int* out4) {
  const csr_walk::Instance in = csr_walk::choose(K, aligned != 0);
  out4[0] = in.vec;
  out4[1] = in.lanes;
  out4[2] = in.chunks;
  out4[3] = in.tiles;
  return 0;
}

}  // extern "C"
