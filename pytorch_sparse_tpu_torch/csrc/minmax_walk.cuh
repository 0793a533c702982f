// The min/max CSR walk: for each output element (r, k) the extreme over
// row r's edges of h[e, k] = val[e] * x[col[e], k] (x[col[e], k] with
// implicit ones), and the edge that gave it.  shard_spmm.cu's K11b and
// spmm_minmax.cu's csr_spmm_minmax (K6) run it, each with its own end of
// row.
//
// The selection rules (the JAX package's argmax/argmin over a row, as
// _group_ell_minmax, the ELL min/max and ell_spmm_minmax compute them):
//   - strict comparison from the row's first edge, so ties keep the first
//     CSR edge;
//   - a NaN candidate beats a non-NaN best, and the first NaN wins among
//     NaNs;
//   - a row whose products all equal the starting sentinel (+inf for
//     min, -inf for max) gives that value and its first edge.
// minmax_walk() leaves best_e = -1 on an empty row: K11b writes (+-inf,
// INT32_MAX) there or leaves a running pair alone, K6 writes (0, E).
//
// Element types (T): float, and for K6 __half and __nv_bfloat16.  Every
// element is compared as a float; a half-type chunk of 4 elements is one
// 8-byte load, and each product of a value and an element (both of type
// T, so exact in float) is rounded to T before it is compared, which is
// T's own multiply.  Elem<float> is the identity on float, so that the
// float walk compiles to the instructions it had before T existed.
//
// The walk is csr_walk.cuh's, with a compare-and-select in place of the
// FMA: float4 chunks where the instance has them, the lanes K needs, U
// edges' rows issued before their first compare, every load
// unconditional and only the selects predicated.  The running best
// starts from the sentinel and takes an edge where
//     !(h <= best) && best == best     (max; min: !(h >= best) && ...)
// which is "strictly better, or a NaN over a non-NaN best", so that no
// compare tests for the row's first edge; a row that took no edge (every
// product equal to the sentinel) takes its first edge after the walk,
// with the sentinel as its value, which is the first edge's product.
// A tail edge (the row's last edge read again) selects nothing without a
// predicate: once an edge has been compared, the best either is its
// product or beat it, and neither a number nor a NaN beats an equal or a
// NaN best.
//
// Registers: a lane keeps a best value and a best edge per element
// beside U edges' rows, so U = edges_in_flight(2 * CPL * VEC) counts
// each column twice: 8 edges up to 4 columns a lane, 4 at 8 (K=256,
// where 8 edges measured 4% slower; PERF.md).  Each chunk of an
// edge's row is one IMAD.WIDE from the chunk's base address.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math_constants.h>

#include "csr_walk.cuh"

namespace csr_walk {

// The 16 bits of a half type as a float, and a float rounded to them.
template <typename T>
struct Bits16;

template <>
struct Bits16<__half> {
  static __device__ __forceinline__ float to_float(unsigned short b) {
    return __half2float(__ushort_as_half(b));
  }
  static __device__ __forceinline__ unsigned short of_float(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

template <>
struct Bits16<__nv_bfloat16> {
  static __device__ __forceinline__ float to_float(unsigned short b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  static __device__ __forceinline__ unsigned short of_float(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// Element access in the operand's type T, through floats: a scalar load,
// a chunk of VEC elements (one 16-byte load for float, one 8-byte load
// for a half type, where VEC == 4), a product rounded to T, and a chunk
// stored in T.  This template serves __half and __nv_bfloat16.
template <typename T>
struct Elem {
  using B = Bits16<T>;
  static __device__ __forceinline__ float load(const T* __restrict__ p) {
    return B::to_float(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
  template <int VEC>
  static __device__ __forceinline__ void load_chunk(const T* __restrict__ p,
                                                    float (&v)[VEC]) {
    if constexpr (VEC == 4) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = B::to_float((unsigned short)(q.x & 0xffffu));
      v[1] = B::to_float((unsigned short)(q.x >> 16));
      v[2] = B::to_float((unsigned short)(q.y & 0xffffu));
      v[3] = B::to_float((unsigned short)(q.y >> 16));
    } else {
      v[0] = load(p);
    }
  }
  static __device__ __forceinline__ float round(float h) {
    return B::to_float(B::of_float(h));
  }
  template <int VEC>
  static __device__ __forceinline__ void store_chunk(T* __restrict__ p,
                                                     const float (&v)[VEC]) {
    if constexpr (VEC == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(
          B::of_float(v[0]) | (unsigned)B::of_float(v[1]) << 16,
          B::of_float(v[2]) | (unsigned)B::of_float(v[3]) << 16);
    } else {
      *reinterpret_cast<unsigned short*>(p) = B::of_float(v[0]);
    }
  }
};

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* __restrict__ p) {
    return __ldg(p);
  }
  template <int VEC>
  static __device__ __forceinline__ void load_chunk(
      const float* __restrict__ p, float (&v)[VEC]) {
    csr_walk::load_chunk<VEC>(p, v);
  }
  static __device__ __forceinline__ float round(float h) { return h; }
  template <int VEC>
  static __device__ __forceinline__ void store_chunk(float* __restrict__ p,
                                                     const float (&v)[VEC]) {
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      p[0] = v[0];
    }
  }
};

// h takes the place of best: strictly better, or a NaN over a non-NaN
// best.
template <bool IS_MIN>
__device__ __forceinline__ bool beats(float h, float best) {
  return (IS_MIN ? !(h >= best) : !(h <= best)) && best == best;
}

// The extreme and its edge (an index into col, -1 on an empty row) at
// the lane's chunks, over edges [start, end) of col and val (val unread
// without HAS_VAL), with val and x of type T.
template <int VEC, int LPR, int CPL, bool IS_MIN, bool HAS_VAL,
          typename T = float>
__device__ __forceinline__ void minmax_walk(
    const Lanes<VEC, LPR, CPL>& ln, int start, int end,
    const int* __restrict__ col, const T* __restrict__ val,
    const T* __restrict__ x, int K, float (&best)[CPL][VEC],
    int (&best_e)[CPL][VEC]) {
  constexpr int U = edges_in_flight(2 * CPL * VEC);
  using B = Batch<LPR, U>;
  const float sentinel = IS_MIN ? CUDART_INF_F : -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < CPL; ++j)
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      best[j][q] = sentinel;
      best_e[j][q] = -1;
    }

  // Chunk j of an edge's row is one IMAD.WIDE from its base: the row's
  // byte offset (a 32 x 32 -> 64-bit product) plus the chunk's address.
  const int row_bytes = K * (int)sizeof(T);
  const char* xj[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    xj[j] = reinterpret_cast<const char*>(x + ln.coff[j]);

  for (int base = start; base < end; base += B::CH) {
    const int n = min(B::CH, end - base);
    int mc[B::IPL];
    float mv[B::IPL];
#pragma unroll
    for (int i = 0; i < B::IPL; ++i) {
      const int e = B::edge(base, ln.s, i, end);
      mc[i] = __ldg(col + e);
      mv[i] = HAS_VAL ? Elem<T>::load(val + e) : 1.f;
    }
    for (int g = 0; g < n; g += U) {
      int c[U];
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        c[u] = B::take(ln.mask, mc, g, u);
        if (HAS_VAL) v[u] = B::take(ln.mask, mv, g, u);
      }
      float xv[U][CPL][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          Elem<T>::template load_chunk<VEC>(
              reinterpret_cast<const T*>(xj[j] + (int64_t)c[u] * row_bytes),
              xv[u][j]);
      // A tail edge (g + u >= n) is the row's last edge again, which
      // cannot beat the best it already left: no predicate needed.
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = base + g + u;
#pragma unroll
        for (int j = 0; j < CPL; ++j)
#pragma unroll
          for (int q = 0; q < VEC; ++q) {
            const float h = HAS_VAL ? Elem<T>::round(v[u] * xv[u][j][q])
                                    : xv[u][j][q];
            if (beats<IS_MIN>(h, best[j][q])) {
              best[j][q] = h;
              best_e[j][q] = e;
            }
          }
      }
    }
  }

  if (start < end) {
#pragma unroll
    for (int j = 0; j < CPL; ++j)
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        if (best_e[j][q] < 0) best_e[j][q] = start;
  }
}

}  // namespace csr_walk
