// SpMM min/max with argout, and the two halves of its backward.
//
//   csr_minmax:       out[r, k] = ext_{e in row r} h[e, k],  h[e, k] = val[e] * x[col e, k]
//                     arg[r, k] = the edge that gave out[r, k]
//   minmax_edge_dot:  grad_val[e] = sum_k [arg[row e, k] == e] * g[row e, k] * x[col e, k]
//   minmax_spmm_t:    grad_x[c, k] = sum_{e in column c, CSC order} [arg[row e, k] == e] * val[e] * g[row e, k]
//
// csr_minmax replaces the JAX package's pytorch_sparse_tpu/ops/kernels/ell.py:
// ell_spmm_minmax (:496); the two backward kernels replace ell_minmax_bwd
// (:383), which computes both halves as gathers over the ELL view and its
// transpose because XLA on the TPU has no fast scatter.  A GPU reads CSR
// and the cached CSC view directly, so no ELL padding remains.
//
// The argout contract (the reference's csrc/spmm.cpp:204-303 as the JAX
// ELL path computes it; every rule below is tested against it):
//   - the comparison is strict, so ties keep the FIRST CSR edge;
//   - the running best starts from the row's first edge, not from +-inf:
//     a row whose candidates are all -inf (max) gives -inf and the first
//     edge, not the sentinel;
//   - a NaN candidate wins over a non-NaN best, and the first NaN wins
//     among NaNs (jnp.argmax/argmin return the first NaN);
//   - an empty row gives out = 0 and arg = E (the sentinel);
//   - float16/bfloat16 operands compute in their own type, as JAX does:
//     the wrapper rounds val to x's type, and each product is rounded to
//     that type before it is compared, so near-ties resolve alike.  The
//     product of two half values is exact in float32, so rounding it once
//     gives the half multiply's result.
// The backward kernels mask before they multiply: an edge that did not
// win (r, k) contributes exactly 0, even where x or val is not finite
// (JAX multiplies the mask by x and turns such an entry into NaN).
//
// What bounds it on an H100, for all three: device-memory bytes.
// csr_minmax reads what csr_spmm reads (one K-wide x row per edge, its
// index and value) and writes arg beside out; a compare per element is
// far below the card's rate.  minmax_edge_dot reads g[row] and arg[row]
// once per row and only the 16-byte x chunks holding an entry whose
// (row, k) the edge won (a load predicated on a register compare): about
// 1/deg of the x elements that edge_dot reads, but won entries spread
// over the row, so at K=128 and 7 edges a row about 70% of its 32-byte
// sectors.  minmax_spmm_t reads an arg row per
// edge and only the g chunks holding an entry that edge won: on the
// ogbn-arxiv-scale uniform graph its 86.7 MB argout outgrows L2, and
// the arg rows (597 MB at K=128) and about half as many g bytes come
// from device memory.
//
// Design of csr_minmax: the min/max walk of minmax_walk.cuh (K11b's, on
// csr_walk.cuh's instances) over the whole matrix, with K6's end of row.
// The instance is csr_walk::choose(K, aligned): float4 chunks (4
// elements of x's type: 16 bytes for float, 8 for a half type) where
// K % 4 == 0, x and out start on a 4-element boundary and arg on 16
// bytes, else scalar ones; the lanes K needs, several rows a warp below
// K=128, 8 edges' rows in flight (4 at K=256).  A half-type chunk is one
// 8-byte load, and each product is rounded to the type before its
// compare (Elem<T>).  The end of row writes the walk's (best, best_e),
// absolute CSR edge ids because rowptr is the whole matrix's, or (0, E)
// on an empty row, as 16-byte (arg, float out) and 8-byte (half out)
// stores where the instance has float4 chunks.  Each output element is
// written by one thread: no atomics, deterministic.
//
// minmax_edge_dot is the per-edge walk of edge_walk.cuh (edge_dot.cu's):
// the lanes K needs keep float4 chunks of g[row] and int4 chunks of
// arg[row] in registers; for 8 edges at a time each lane issues the x
// chunks in which the edge won an entry, adds the won products, and one
// transposing butterfly a batch (skipped where no lane of the row won)
// sums the lanes' partials.
//
// minmax_spmm_t is the CSR walk of csr_walk.cuh over the CSC view (its
// instances: int4 and float4 chunks, the lanes K needs, several columns
// a warp at narrow widths): each sub-warp loads its column's (row, edge
// id) coalesced and gathers the values by edge id, then for U edges at a
// time issues their arg chunks, compares, and issues the g chunks that
// hold a win before the first FMA, so an edge's two round trips overlap
// with the other edges'.  Issuing every g chunk beside its arg chunk
// instead was measured slower on the community graphs, where an edge
// wins few entries of a row (PERF.md).  Each output element is summed in
// one thread in CSC order: no float atomics, deterministic.  (An atomic
// scatter over (row, k) through arg would read fewer bytes; it is not
// this design.)
//
// The interface is plain C, bound from Python with ctypes: pointers come
// in as void*, the launch goes on the caller's stream, and the return
// value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "csr_walk.cuh"
#include "edge_walk.cuh"
#include "minmax_walk.cuh"

namespace {

template <typename T, int VEC, int LPR, int CPL, bool IS_MIN, bool HAS_VAL>
__global__ void __launch_bounds__(csr_walk::kWarpsPerBlock * 32)
csr_minmax_walk_kernel(const int* __restrict__ rowptr,
                       const int* __restrict__ col,
                       const T* __restrict__ val, const T* __restrict__ x,
                       T* __restrict__ out, int* __restrict__ arg, int M,
                       int K, int E) {
  csr_walk::Lanes<VEC, LPR, CPL> ln;
  const int row = ln.item;
  if (row >= M) return;  // uniform across the sub-warp
  ln.place(K);
  const int start = __ldg(rowptr + row);
  const int end = __ldg(rowptr + row + 1);

  float best[CPL][VEC];
  int best_e[CPL][VEC];
  csr_walk::minmax_walk<VEC, LPR, CPL, IS_MIN, HAS_VAL>(
      ln, start, end, col, val, x, K, best, best_e);

  // An empty row gives (0, E); the others the walk's absolute edge ids.
  const bool empty = start == end;
  T* __restrict__ o = out + (int64_t)row * K + ln.c0;
  int* __restrict__ a = arg + (int64_t)row * K + ln.c0;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (!ln.live[j]) continue;
    float ov[VEC];
    int av[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      ov[q] = empty ? 0.f : best[j][q];
      av[q] = empty ? E : best_e[j][q];
    }
    csr_walk::Elem<T>::template store_chunk<VEC>(o + ln.STRIDE * j, ov);
    int* __restrict__ aj = a + ln.STRIDE * j;
    if constexpr (VEC == 4) {
      *reinterpret_cast<int4*>(aj) = make_int4(av[0], av[1], av[2], av[3]);
    } else {
      aj[0] = av[0];
    }
  }
}

// K7b: the CSC walk of csr_walk.cuh with the argout as a mask.  Column c
// is one walk item: lane s of its sub-warp owns the chunks of columns k
// of grad_x[c, :].  For U edges at a time it issues each edge's arg
// chunk (int4), compares it with the edge's id, then issues the g chunk
// of every edge that won one of the chunk's entries (a load predicated
// on the compare), and an entry adds fmaf(v, g, acc) where arg == e and
// the edge is in the column (a tail edge, the last one read again, is
// masked).  U = edges_in_flight(4 * CPL * VEC) counts each column four
// times: 4 edges with one float4 chunk a lane, 2 with two.
template <int VEC, int LPR, int CPL, bool HAS_VAL>
__global__ void __launch_bounds__(csr_walk::kWarpsPerBlock * 32)
minmax_spmm_t_kernel(const int* __restrict__ colptr,
                     const int* __restrict__ csc_row,
                     const int* __restrict__ csr2csc,
                     const float* __restrict__ val,
                     const float* __restrict__ g,
                     const int* __restrict__ arg, float* __restrict__ out,
                     int N, int K) {
  constexpr int U = csr_walk::edges_in_flight(4 * CPL * VEC);
  using B = csr_walk::Batch<LPR, U>;
  csr_walk::Lanes<VEC, LPR, CPL> ln;
  const int c = ln.item;
  if (c >= N) return;  // uniform across the sub-warp
  ln.place(K);

  float acc[CPL][VEC];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[j][q] = 0.f;

  const int start = __ldg(colptr + c);
  const int end = __ldg(colptr + c + 1);
  for (int base = start; base < end; base += B::CH) {
    const int n = min(B::CH, end - base);
    int mr[B::IPL], me[B::IPL];
    float mv[B::IPL];
#pragma unroll
    for (int i = 0; i < B::IPL; ++i) {
      const int p = B::edge(base, ln.s, i, end);
      mr[i] = __ldg(csc_row + p);
      me[i] = __ldg(csr2csc + p);
    }
#pragma unroll
    for (int i = 0; i < B::IPL; ++i)
      mv[i] = HAS_VAL ? __ldg(val + me[i]) : 1.f;
    for (int t = 0; t < n; t += U) {
      int r[U], e[U];
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        r[u] = B::take(ln.mask, mr, t, u);
        e[u] = B::take(ln.mask, me, t, u);
        v[u] = HAS_VAL ? B::take(ln.mask, mv, t, u) : 1.f;
      }
      int av[U][CPL][VEC];
      float gv[U][CPL][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t off = (int64_t)r[u] * K;
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          csr_walk::load_chunk<VEC>(arg + off + ln.coff[j], av[u][j]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t off = (int64_t)r[u] * K;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          bool won = false;
#pragma unroll
          for (int q = 0; q < VEC; ++q) won |= av[u][j][q] == e[u];
#pragma unroll
          for (int q = 0; q < VEC; ++q) gv[u][j][q] = 0.f;
          if (won && t + u < n)
            csr_walk::load_chunk<VEC>(g + off + ln.coff[j], gv[u][j]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool in_col = t + u < n;
#pragma unroll
        for (int j = 0; j < CPL; ++j)
#pragma unroll
          for (int q = 0; q < VEC; ++q)
            if (in_col && av[u][j][q] == e[u])
              acc[j][q] = fmaf(v[u], gv[u][j][q], acc[j][q]);
      }
    }
  }

  float* __restrict__ o = out + (int64_t)c * K + ln.c0;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (!ln.live[j]) continue;
    float* __restrict__ oj = o + ln.STRIDE * j;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(oj) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    } else {
      oj[0] = acc[j][0];
    }
  }
}

// K6's instance: float4 chunks need x and out on a boundary of 4
// elements of their type (16 bytes for float, 8 for a half type) and
// arg on 16 bytes.  dtype: 0 float32, 1 float16, 2 bfloat16.
csr_walk::Instance minmax_instance(int dtype, int K, const void* x,
                                   const void* out, const void* arg) {
  const uintptr_t chunk = dtype == 0 ? 16 : 8;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  return csr_walk::choose(K,
                          bits % chunk == 0 && csr_walk::aligned16({arg}));
}

template <typename T>
int launch_minmax(const csr_walk::Instance& in, bool is_min,
                  const int* rowptr, const int* col, const void* val,
                  const void* x, void* out, int* arg, int M, int K, int E,
                  cudaStream_t s) {
  const T* v = static_cast<const T*>(val);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  return csr_walk::dispatch(in, [&](auto shape) {
    using S = decltype(shape);
    const dim3 grid = csr_walk::grid_of(in, M);
    constexpr int threads = csr_walk::kWarpsPerBlock * 32;
#define K6_LAUNCH(IS_MIN_, HAS_VAL_)                                      \
  csr_minmax_walk_kernel<T, S::VEC, S::LPR, S::CPL, IS_MIN_, HAS_VAL_>    \
      <<<grid, threads, 0, s>>>(rowptr, col, v, xp, op, arg, M, K, E)
    if (is_min) {
      if (v != nullptr) K6_LAUNCH(true, true);
      else K6_LAUNCH(true, false);
    } else {
      if (v != nullptr) K6_LAUNCH(false, true);
      else K6_LAUNCH(false, false);
    }
#undef K6_LAUNCH
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float16, 2 bfloat16 (x, val and out share it).
// rowptr (M+1) int32, col (E) int32, val (E) or NULL for implicit ones,
// x (N, K) row-major, out (M, K) row-major, arg (M, K) int32 row-major.
int csr_spmm_minmax(int device, int dtype, int is_min, const void* rowptr,
                    const void* col, const void* val, const void* x,
                    void* out, void* arg, int M, int K, int E, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || K <= 0) return 0;
  if (dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  const csr_walk::Instance in = minmax_instance(dtype, K, x, out, arg);
  if (in.tiles > 65535) return (int)cudaErrorInvalidValue;
  const int* rp = static_cast<const int*>(rowptr);
  const int* ci = static_cast<const int*>(col);
  int* ap = static_cast<int*>(arg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mn = is_min != 0;
  switch (dtype) {
    case 0:
      return launch_minmax<float>(in, mn, rp, ci, val, x, out, ap, M, K, E,
                                  s);
    case 1:
      return launch_minmax<__half>(in, mn, rp, ci, val, x, out, ap, M, K, E,
                                   s);
    default:
      return launch_minmax<__nv_bfloat16>(in, mn, rp, ci, val, x, out, ap,
                                          M, K, E, s);
  }
}

// The instance csr_spmm_minmax runs for these operands:
// {vec, lanes, chunks, tiles} into out4.  Returns 0.
int csr_spmm_minmax_instance(int dtype, int K, const void* x,
                             const void* out, const void* arg, int* out4) {
  const csr_walk::Instance in = minmax_instance(dtype, K, x, out, arg);
  out4[0] = in.vec;
  out4[1] = in.lanes;
  out4[2] = in.chunks;
  out4[3] = in.tiles;
  return 0;
}

// rowptr (M+1) int32, col (E) int32, x (N, K) float32, g (M, K) float32,
// arg (M, K) int32, out (E) float32; all row-major; K >= 1.
int minmax_edge_dot_f32(int device, const void* rowptr, const void* col,
                        const void* x, const void* g, const void* arg,
                        void* out, int M, int K, void* stream) {
  return edge_walk::run<true>(device, rowptr, col, x, g, arg, out, M, K,
                              stream);
}

// colptr (N+1) int32, csc_row and csr2csc (E) int32 in CSC order, val (E)
// float32 in CSR order or NULL for implicit ones, g (M, K) float32,
// arg (M, K) int32, out (N, K) float32; all row-major.
int minmax_spmm_t_f32(int device, const void* colptr, const void* csc_row,
                      const void* csr2csc, const void* val, const void* g,
                      const void* arg, void* out, int N, int K,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N <= 0 || K <= 0) return 0;
  const csr_walk::Instance in =
      csr_walk::choose(K, csr_walk::aligned16({g, arg, out}));
  if (in.tiles > 65535) return (int)cudaErrorInvalidValue;
  const int* cp = static_cast<const int*>(colptr);
  const int* cr = static_cast<const int*>(csc_row);
  const int* pe = static_cast<const int*>(csr2csc);
  const float* v = static_cast<const float*>(val);
  const float* gp = static_cast<const float*>(g);
  const int* ap = static_cast<const int*>(arg);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return csr_walk::dispatch(in, [&](auto shape) {
    using S = decltype(shape);
    const dim3 grid = csr_walk::grid_of(in, N);
    constexpr int threads = csr_walk::kWarpsPerBlock * 32;
    if (v != nullptr) {
      minmax_spmm_t_kernel<S::VEC, S::LPR, S::CPL, true>
          <<<grid, threads, 0, s>>>(cp, cr, pe, v, gp, ap, op, N, K);
    } else {
      minmax_spmm_t_kernel<S::VEC, S::LPR, S::CPL, false>
          <<<grid, threads, 0, s>>>(cp, cr, pe, v, gp, ap, op, N, K);
    }
    return (int)cudaGetLastError();
  });
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
