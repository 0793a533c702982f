// The per-edge walk shared by edge_dot (K4) and minmax_edge_dot (K7a):
//
//   out[e] = sum_k x[col e, k] * g[row e, k]                        (K4)
//   out[e] = sum_k [arg[row e, k] == e] * x[col e, k] * g[row e, k] (K7a)
//
// over the edges e of a CSR matrix (a sampled dense-dense product, one
// value an edge).  K7a masks before it multiplies: an entry the edge did
// not win adds nothing, even where x or g is not finite.
//
// What bounds it on an H100: device-memory bytes.  Each edge gathers one
// K-wide row of x (K4; K7a only the 16-byte chunks holding an entry the
// edge won), the bytes K1 gathers for the same matrix; g[row] (and
// arg[row]) are read once a row, the output once.  2K flops an edge are
// far below the card's rate, so the design spends few instructions an
// edge and keeps several rows of x in flight.
//
// The walk runs on csr_walk.cuh's instances (choose, dispatch, Lanes,
// Batch, load_chunk), with the column tiles taken as passes inside the
// lane, since an edge's dot cannot be split across blocks without
// atomics:
//
//   * Lanes own 16-byte chunks.  A row's K columns are split into float4
//     chunks (int4 for arg) over LPR lanes, the lanes K needs rounded up
//     to a power of two, so a warp walks 32 / LPR rows: 16 at K=8, 2 at
//     K=40, 1 at K=128.  Each lane keeps its chunks of g[row] (and of
//     arg[row]) in registers, loaded once a row.  K % 4 != 0 or a base
//     off 16 bytes takes the scalar instance.  K above 256 loops over
//     column passes inside the lane (g and arg then come from L1 each
//     pass) and adds each pass to the lane's partials.
//   * U edges in flight.  The sub-warp loads its row's column indices
//     coalesced (Batch), then issues all U edges' x chunks before the
//     first FMA; a tail edge reads the row's last edge again and is not
//     stored.  K7a predicates each chunk's load on "an entry of this
//     chunk was won by edge e", a compare against registers.
//   * One reduction a batch.  Each lane holds U partial dots.  A
//     transposing butterfly over the LPR lanes halves the values a lane
//     holds at each step (U/2, U/4, ... exchanged), then sums the rest:
//     at LPR=32 and U=8, 4+2+1+1+1 = 9 shuffles a batch instead of 40.
//     Lane s ends with the sums of edges (s * U) / LPR + i of the batch,
//     i < max(1, U / LPR), and the sub-warp stores the batch's U results
//     as one run (where LPR > U, one lane of each LPR / U).  K7a skips the
//     reduction of a batch in which no lane won an entry (its dots are
//     0).
//
// The order of the sums is fixed by the instance: each lane adds its
// chunks' products from 0.0f as one fmaf chain (pass, chunk, then column
// within the chunk), and the butterfly adds the lanes' partials in a
// fixed tree (partners s ^ LPR/2 first, then s ^ LPR/4, ...).  No
// atomics: the bits do not depend on the launch or the card's load.
//
// edge_walk_instance() and the Python function edge_instance() in
// ops/kernels/edge_dot.py choose the same instance for (K, aligned).

#pragma once

#include "csr_walk.cuh"

namespace edge_walk {

using csr_walk::kWarpsPerBlock;

// Edges in flight: csr_walk.cuh's U; a lane holds U edges' chunks of x
// (at most 8 columns a lane, 64 registers).
constexpr int kEdgesInFlight = csr_walk::kEdgesInFlight;

// The transposing butterfly: at offset O (LPR/2 down to 1) a lane holds
// N partials; while N > 1 it keeps one half (the upper where bit O of its
// place s is set), sends the other to its partner s ^ O and adds what
// comes back; at N == 1 partners add their sums.  Lane s ends with the
// sums of edges (s * U) / LPR + i, i < max(1, U / LPR).
template <int O, int N, int LPR, int U>
__device__ __forceinline__ void fold(unsigned mask, int s, float (&v)[U]) {
  if constexpr (O >= 1) {
    if constexpr (N > 1) {
      const bool up = (s & O) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? v[i] : v[i + N / 2];
        const float keep = up ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(mask, send, O, LPR);
      }
      fold<O / 2, N / 2, LPR, U>(mask, s, v);
    } else {
      v[0] += __shfl_xor_sync(mask, v[0], O, LPR);
      fold<O / 2, 1, LPR, U>(mask, s, v);
    }
  }
}

// Pass p's chunks of g[row] and arg[row] (arg with MINMAX): chunk j at
// column p * TILE + c0 + STRIDE * j, live below K; a dead chunk holds 0
// and -1 (matches no edge) and reads column 0 of x.
template <int VEC, int LPR, int CPL, bool MINMAX>
__device__ __forceinline__ void load_row(
    const csr_walk::Lanes<VEC, LPR, CPL>& ln, const float* __restrict__ g,
    const int* __restrict__ arg, int64_t roff, int K, int p,
    float (&gr)[CPL][VEC], int (&ar)[CPL][VEC], bool (&live)[CPL],
    int (&coff)[CPL]) {
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = p * (LPR * VEC * CPL) + ln.c0 + ln.STRIDE * j;
    live[j] = c < K;
    coff[j] = live[j] ? c : 0;
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      gr[j][q] = 0.f;
      ar[j][q] = -1;
    }
    if (live[j]) {
      csr_walk::load_chunk<VEC>(g + roff + c, gr[j]);
      if (MINMAX) csr_walk::load_chunk<VEC>(arg + roff + c, ar[j]);
    }
  }
}

// out[e] for every edge of each row: K4 (MINMAX false, arg unread) or
// K7a.  PASSES: K above one tile, walked as `passes` column passes
// inside the lane, g and arg read again each batch.
template <int VEC, int LPR, int CPL, bool MINMAX, bool PASSES>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
edge_walk_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
                 const float* __restrict__ x, const float* __restrict__ g,
                 const int* __restrict__ arg, float* __restrict__ out,
                 int M, int K, int passes) {
  constexpr int U = kEdgesInFlight;
  constexpr int OUTS = U >= LPR ? U / LPR : 1;   // results a lane holds
  constexpr int SHARE = LPR > U ? LPR / U : 1;   // lanes holding a result
  using B = csr_walk::Batch<LPR, U>;
  csr_walk::Lanes<VEC, LPR, CPL> ln;
  const int row = ln.item;
  if (row >= M) return;  // uniform across the sub-warp
  ln.place(K);
  if (!PASSES) passes = 1;

  const int64_t roff = (int64_t)row * K;
  float gr[CPL][VEC];
  int ar[CPL][VEC];
  bool live[CPL];
  int coff[CPL];
  if (!PASSES) load_row<VEC, LPR, CPL, MINMAX>(ln, g, arg, roff, K, 0, gr, ar,
                                              live, coff);

  const int start = __ldg(rowptr + row);
  const int end = __ldg(rowptr + row + 1);
  for (int base = start; base < end; base += B::CH) {
    const int n = min(B::CH, end - base);
    int mc[B::IPL];
#pragma unroll
    for (int i = 0; i < B::IPL; ++i)
      mc[i] = __ldg(col + B::edge(base, ln.s, i, end));
    for (int t0 = 0; t0 < n; t0 += U) {
      int c[U];
#pragma unroll
      for (int u = 0; u < U; ++u) c[u] = B::take(ln.mask, mc, t0, u);
      float part[U];
#pragma unroll
      for (int u = 0; u < U; ++u) part[u] = 0.f;
      bool won_any = false;
      for (int p = 0; p < passes; ++p) {
        if (PASSES)
          load_row<VEC, LPR, CPL, MINMAX>(ln, g, arg, roff, K, p, gr, ar,
                                          live, coff);
        float xv[U][CPL][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float* __restrict__ xr = x + (int64_t)c[u] * K;
          const int e = base + t0 + u;
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            if constexpr (MINMAX) {
              bool won = false;
#pragma unroll
              for (int q = 0; q < VEC; ++q) won |= ar[j][q] == e;
              won &= t0 + u < n;
              won_any |= won;
#pragma unroll
              for (int q = 0; q < VEC; ++q) xv[u][j][q] = 0.f;
              if (won) csr_walk::load_chunk<VEC>(xr + coff[j], xv[u][j]);
            } else {
              csr_walk::load_chunk<VEC>(xr + coff[j], xv[u][j]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = base + t0 + u;
#pragma unroll
          for (int j = 0; j < CPL; ++j)
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
              const bool take = MINMAX ? (ar[j][q] == e && t0 + u < n)
                                       : live[j];
              if (take) part[u] = fmaf(xv[u][j][q], gr[j][q], part[u]);
            }
        }
      }
      if (!MINMAX || __any_sync(ln.mask, won_any))
        fold<LPR / 2, U, LPR, U>(ln.mask, ln.s, part);
      if (ln.s % SHARE == 0) {
        const int t = (ln.s * U) / LPR;
#pragma unroll
        for (int i = 0; i < OUTS; ++i)
          if (t0 + t + i < n) out[base + t0 + t + i] = part[i];
      }
    }
  }
}

// The walk on the caller's stream, as an instance of csr_walk::choose
// over x, g (and arg for K7a); the column tiles become passes.  Returns
// cudaGetLastError() after the launch (0 when M is 0).
template <bool MINMAX>
inline int run(int device, const void* rowptr, const void* col,
               const void* x, const void* g, const void* arg, void* out,
               int M, int K, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0) return 0;
  if (K <= 0) return (int)cudaErrorInvalidValue;  // the wrapper's zeros
  const csr_walk::Instance in =
      csr_walk::choose(K, csr_walk::aligned16({x, g, MINMAX ? arg : nullptr}));
  const int* rp = static_cast<const int*>(rowptr);
  const int* ci = static_cast<const int*>(col);
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(g);
  const int* ap = static_cast<const int*>(arg);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_a_block = kWarpsPerBlock * (32 / in.lanes);
  const dim3 grid((M + rows_a_block - 1) / rows_a_block);
  return csr_walk::dispatch(in, [&](auto shape) {
    using S = decltype(shape);
    constexpr int threads = kWarpsPerBlock * 32;
    if (in.tiles == 1) {
      edge_walk_kernel<S::VEC, S::LPR, S::CPL, MINMAX, false>
          <<<grid, threads, 0, s>>>(rp, ci, xp, gp, ap, op, M, K, 1);
    } else if constexpr (S::LPR * S::VEC * S::CPL ==
                         csr_walk::kTileColumns) {
      edge_walk_kernel<S::VEC, S::LPR, S::CPL, MINMAX, true>
          <<<grid, threads, 0, s>>>(rp, ci, xp, gp, ap, op, M, K, in.tiles);
    } else {
      return (int)cudaErrorInvalidValue;  // only full tiles repeat
    }
    return (int)cudaGetLastError();
  });
}

}  // namespace edge_walk

extern "C" {

// The instance the edge walk runs for width K and operands on 16-byte
// boundaries (aligned != 0) or not: {vec, lanes, chunks, passes, edges
// in flight} into out5.  Returns 0.  Defined here, so every library that
// includes this header (one .cu each) exports it.
int edge_walk_instance(int K, int aligned, int* out5) {
  const csr_walk::Instance in = csr_walk::choose(K, aligned != 0);
  out5[0] = in.vec;
  out5[1] = in.lanes;
  out5[2] = in.chunks;
  out5[3] = in.tiles;
  out5[4] = edge_walk::kEdgesInFlight;
  return 0;
}

}  // extern "C"
