// Edge softmax: for each row r and head h of a CSR matrix,
//   out[e, h] = exp(l[e, h] - m) / max(sum_{e' in row r} exp(l[e', h] - m), 1e-16),
//   m = max_{e' in row r} l[e', h],
// over logits l (E, H) in CSR edge order.  This is the attention
// normalisation of a GAT layer.
//
// Replaces the JAX package's pytorch_sparse_tpu/ops/kernels/ell.py:
// ell_edge_softmax (:462), which pads rows to ELL width and broadcasts each
// bucket's max and sum back through edge_slot, because XLA on the TPU has
// no fast segmented reduction.  In CSR order a row's logits are one
// contiguous slab of deg*H floats, so a GPU reads them directly.
//
// What bounds it on an H100: device-memory bytes.  Each logit is read and
// each output written once (8 bytes per edge and head); one exp and a few
// flops per element are far below the card's rate.  At GAT's widths a
// row's slab is short (the uniform graph with self-loops: about 8 edges,
// 63 floats at H=8), so what holds a simple kernel back is latency: a
// warp a row leaves most lanes idle, and three sweeps (max, sum, write)
// are three dependent round trips.
//
// Design of the forward: a sub-warp of LPR lanes takes a row and reads
// its slab once; a lane keeps its part in registers from the max through
// the write, so there are two round trips a row (rowptr, then the slab),
// the reductions are shuffles within the sub-warp, and 32 / LPR rows
// share a warp.  LPR is the lanes the mean row needs at kChunksAtMean
// chunks a lane (a power of two up to 32), and a lane keeps up to CPL
// chunks: kLaneChunks, or twice that where 32 lanes of kLaneChunks hold
// less than twice the mean row.  A row beyond LPR * CPL chunks (the
// register cap) sweeps its slab three times instead (max, sum, write;
// the second and third reads from L1/L2): a two-pass online max-and-sum
// would save a read but rescales the sum at every new maximum, with an
// exp each, and such rows are rare on the graphs the models run.  Two
// families of instances (edge_softmax_instance() here and
// sweep_instance() in ops/kernels/edge_softmax.py choose the same one):
//   * chunks (H divides 32, logits and out on 16-byte boundaries): lane
//     s takes the slab's 16-byte chunks c0 + s + LPR * j (c0 the chunk
//     that holds the row's first logit) as float4 loads.  Position q of
//     such a chunk holds head (4 * (s + LPR * j) + q) % H, which is
//     (4 * s + q) % H for LPR >= H / 4: fixed per lane and position, so
//     the per-head max and sum reduce over xor offsets LPR/2, ..., H/4
//     (H >= 4), or over every lane after the lane has combined its
//     positions of one head (H = 1, 2).  A slab of H = 1 or 2 may start
//     or end inside a chunk: such a chunk is read and written element by
//     element within the slab, so no lane touches another row's logits.
//   * edges (any H, any alignment): lane s takes the row's edges s +
//     LPR * j, kHeadsAPass heads a pass, with scalar loads, and the
//     per-head max and sum reduce over every lane of the sub-warp.
// NaN propagates in the max, as in jnp.max; a row-head whose logits are
// all -inf gives NaN, as in JAX (exp(-inf - -inf)); the denominator is
// max(sum, 1e-16) with a NaN sum kept, as jnp.maximum keeps it, so a
// row-head with a +inf logit is NaN throughout (fmaxf would turn its sum
// into 1e-16 and its finite logits into 0).  Each exponential is
// multiplied by the denominator's reciprocal, taken once a head and
// lane (a division an element measured 22-33% slower at H=1; the
// results differ from a division by at most an ulp).  Each output
// element is written by one thread in a fixed order of sums:
// deterministic.
// Hand-written CUDA like the package's other kernels (a Triton reduction
// would also fit; the port builds every kernel with one toolchain).
//
// The backward (edge_softmax_bwd_f32) is the gradient JAX takes by
// autodiff through ell_edge_softmax and models/gat.py:16-24: with p the
// forward's output and g the output gradient,
//   grad_l[e, h] = p[e, h] * (g[e, h] - sum_{e' in row r} p[e', h] * g[e', h]).
// It is bound by bytes as the forward is (p and g read, grad_l written:
// 12 bytes per edge and head), and runs one warp a row: lane i takes
// elements i, i+32, ... of the row's slab; when H divides 32 every
// element a lane sees belongs to head lane % H, so the per-head dot
// sum_row p*g reduces with __shfl_xor_sync over offsets 16, ..., H, then
// a second sweep writes p * (g - dot); other H loop over heads, lanes
// striding over the row's edges.  Rows are independent, so there are no
// atomics.
//
// The interface is plain C, bound from Python with ctypes: pointers come
// in as void*, the launch goes on the caller's stream, and the return
// value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// max that propagates NaN, as jnp.max does.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// Sum over lanes that differ in offsets 16, 8, ..., LO.
template <int LO>
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= LO; off >>= 1)
    v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// ---- The forward: a sub-warp a row, one read of its slab -------------

constexpr int kChunksAtMean = 2;  // a lane's chunks (edges) at the mean row
constexpr int kLaneChunks = 4;    // chunks (edges) a lane keeps, or twice
constexpr int kHeadsAPass = 4;    // heads a pass of the edges instance

// The lanes of the sub-warp of LPR lanes that holds lane.
template <int LPR>
__device__ __forceinline__ unsigned sub_mask(int lane) {
  constexpr unsigned kSub = LPR == 32 ? kFullMask : (1u << (LPR % 32)) - 1u;
  return kSub << (lane - lane % LPR);
}

template <bool MAX>
__device__ __forceinline__ float combine(float a, float b) {
  return MAX ? nan_max(a, b) : a + b;
}

// v combined over every lane of the sub-warp of LPR lanes.
template <int LPR, bool MAX>
__device__ __forceinline__ float subwarp_combine(float v, unsigned mask) {
#pragma unroll
  for (int off = LPR / 2; off >= 1; off >>= 1)
    v = combine<MAX>(v, __shfl_xor_sync(mask, v, off, LPR));
  return v;
}

// The per-head max or sum of the chunks instance: positions of one head
// within the lane first (H = 1, 2), then over xor offsets LPR/2, ...,
// max(1, H/4) of the sub-warp; every position ends with its head's value.
template <int H, int LPR, bool MAX>
__device__ __forceinline__ void reduce_heads(float (&v)[4], unsigned mask) {
  constexpr int NV = H < 4 ? H : 4;     // heads a lane holds
  constexpr int LO = H < 4 ? 1 : H / 4;
  if constexpr (H == 1) {
    v[0] = combine<MAX>(combine<MAX>(v[0], v[1]), combine<MAX>(v[2], v[3]));
  } else if constexpr (H == 2) {
    v[0] = combine<MAX>(v[0], v[2]);
    v[1] = combine<MAX>(v[1], v[3]);
  }
#pragma unroll
  for (int off = LPR / 2; off >= LO; off >>= 1)
#pragma unroll
    for (int q = 0; q < NV; ++q)
      v[q] = combine<MAX>(v[q], __shfl_xor_sync(mask, v[q], off, LPR));
#pragma unroll
  for (int q = NV; q < 4; ++q) v[q] = v[q % NV];
}

// The chunk at c (4 floats), whose first element lies p elements past
// the start of a slab of len elements: one float4 load where the chunk
// lies in the slab whole (always for H >= 4, whose slabs start and end
// on chunk boundaries), else its slab elements one by one; -inf
// elsewhere.  I is int in the register path, int64_t in the sweeps.
template <int H, typename I>
__device__ __forceinline__ void load_chunk(const float* __restrict__ c, I p,
                                           I len, float (&v)[4]) {
  if (H >= 4 || (p >= 0 && p + 4 <= len)) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(c));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = p + q >= 0 && p + q < len ? __ldg(c + q) : -CUDART_INF_F;
  }
}

template <int H, typename I>
__device__ __forceinline__ void store_chunk(float* __restrict__ c, I p, I len,
                                            const float (&v)[4]) {
  if (H >= 4 || (p >= 0 && p + 4 <= len)) {
    *reinterpret_cast<float4*>(c) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (p + q >= 0 && p + q < len) c[q] = v[q];
  }
}

// The chunks instance: H divides 32, logits and out on 16-byte
// boundaries.  Lane s of a row's sub-warp takes chunks c0 + s + LPR * j.
template <int H, int LPR, int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
softmax_chunks_kernel(const int* __restrict__ rowptr,
                      const float* __restrict__ logits,
                      float* __restrict__ out, int M) {
  static_assert(LPR >= H / 4, "a lane's positions must keep their heads");
  constexpr int RPW = 32 / LPR;
  const int lane = threadIdx.x & 31;
  const int s = lane % LPR;
  const int row =
      (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * RPW + lane / LPR;
  if (row >= M) return;  // uniform across the sub-warp
  const unsigned mask = sub_mask<LPR>(lane);
  const int64_t lo = (int64_t)__ldg(rowptr + row) * H;
  const int64_t len = (int64_t)__ldg(rowptr + row + 1) * H - lo;
  if (len == 0) return;
  // The slab's chunks from the one that holds its first logit: chunk j
  // of the lane starts p = 4 * (s + LPR * j) - lead elements into the
  // slab (lead = 0 for H >= 4).
  const int lead = (int)(lo & 3);
  const float* __restrict__ l = logits + (lo - lead);
  float* __restrict__ o = out + (lo - lead);
  const int64_t n = (len + lead + 3) >> 2;  // chunks the slab touches

  float m[4], sum[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    m[q] = -CUDART_INF_F;
    sum[q] = 0.f;
  }
  if (n <= LPR * CPL) {
    // One read: the lane's chunks stay in registers; offsets fit 32 bits.
    const int len32 = (int)len;
    float v[CPL][4];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int p = 4 * (s + LPR * j) - lead;
      if (p < len32) {
        load_chunk<H>(l + p + lead, p, len32, v[j]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[j][q] = -CUDART_INF_F;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) m[q] = nan_max(m[q], v[j][q]);
    }
    reduce_heads<H, LPR, true>(m, mask);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int p = 4 * (s + LPR * j) - lead;
      if (p >= len32) continue;  // a chunk past the slab adds nothing
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = H >= 4 || (p + q >= 0 && p + q < len32);
        v[j][q] = in ? expf(v[j][q] - m[q]) : 0.f;
        sum[q] += v[j][q];
      }
    }
    reduce_heads<H, LPR, false>(sum, mask);
#pragma unroll
    for (int q = 0; q < 4; ++q) sum[q] = 1.f / nan_max(1e-16f, sum[q]);
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int p = 4 * (s + LPR * j) - lead;
      if (p >= len32) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) v[j][q] *= sum[q];
      store_chunk<H>(o + p + lead, p, len32, v[j]);
    }
    return;
  }

  // A row beyond the register cap sweeps its slab three times.
  float v[4];
  for (int64_t c = s; c < n; c += LPR) {
    const int64_t p = 4 * c - lead;
    load_chunk<H>(l + 4 * c, p, len, v);
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q] = nan_max(m[q], v[q]);
  }
  reduce_heads<H, LPR, true>(m, mask);
  for (int64_t c = s; c < n; c += LPR) {
    const int64_t p = 4 * c - lead;
    load_chunk<H>(l + 4 * c, p, len, v);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      sum[q] += H >= 4 || (p + q >= 0 && p + q < len) ? expf(v[q] - m[q])
                                                       : 0.f;
  }
  reduce_heads<H, LPR, false>(sum, mask);
#pragma unroll
  for (int q = 0; q < 4; ++q) sum[q] = 1.f / nan_max(1e-16f, sum[q]);
  for (int64_t c = s; c < n; c += LPR) {
    const int64_t p = 4 * c - lead;
    load_chunk<H>(l + 4 * c, p, len, v);
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = expf(v[q] - m[q]) * sum[q];
    store_chunk<H>(o + 4 * c, p, len, v);
  }
}

// The edges instance: any H, any alignment.  Lane s of a row's sub-warp
// takes the row's edges s + LPR * j, kHeadsAPass heads a pass.
template <int LPR, int CPE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
softmax_edges_kernel(const int* __restrict__ rowptr,
                     const float* __restrict__ logits,
                     float* __restrict__ out, int M, int H) {
  constexpr int RPW = 32 / LPR;
  constexpr int HP = kHeadsAPass;
  const int lane = threadIdx.x & 31;
  const int s = lane % LPR;
  const int row =
      (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * RPW + lane / LPR;
  if (row >= M) return;  // uniform across the sub-warp
  const unsigned mask = sub_mask<LPR>(lane);
  const int start = __ldg(rowptr + row);
  const int n = __ldg(rowptr + row + 1) - start;
  if (n == 0) return;
  const float* __restrict__ l = logits + (int64_t)start * H;
  float* __restrict__ o = out + (int64_t)start * H;

  for (int h0 = 0; h0 < H; h0 += HP) {
    const int nh = min(HP, H - h0);  // uniform across the sub-warp
    float m[HP], sum[HP];
#pragma unroll
    for (int t = 0; t < HP; ++t) {
      m[t] = -CUDART_INF_F;
      sum[t] = 0.f;
    }
    if (n <= LPR * CPE) {
      // One read: the lane's edges stay in registers.
      float v[CPE][HP];
#pragma unroll
      for (int j = 0; j < CPE; ++j) {
        const int k = s + LPR * j;
#pragma unroll
        for (int t = 0; t < HP; ++t) {
          v[j][t] = k < n && t < nh ? __ldg(l + (int64_t)k * H + h0 + t)
                                    : -CUDART_INF_F;
          m[t] = nan_max(m[t], v[j][t]);
        }
      }
#pragma unroll
      for (int t = 0; t < HP; ++t)
        if (t < nh) m[t] = subwarp_combine<LPR, true>(m[t], mask);
#pragma unroll
      for (int j = 0; j < CPE; ++j) {
        if (s + LPR * j >= n) continue;  // an edge past the row adds nothing
#pragma unroll
        for (int t = 0; t < HP; ++t) {
          v[j][t] = t < nh ? expf(v[j][t] - m[t]) : 0.f;
          sum[t] += v[j][t];
        }
      }
#pragma unroll
      for (int t = 0; t < HP; ++t)
        if (t < nh)
          sum[t] = 1.f / nan_max(1e-16f,
                                 subwarp_combine<LPR, false>(sum[t], mask));
#pragma unroll
      for (int j = 0; j < CPE; ++j) {
        const int k = s + LPR * j;
        if (k >= n) continue;
#pragma unroll
        for (int t = 0; t < HP; ++t)
          if (t < nh) o[(int64_t)k * H + h0 + t] = v[j][t] * sum[t];
      }
      continue;
    }

    // A row beyond the register cap sweeps its edges three times.
    for (int k = s; k < n; k += LPR)
#pragma unroll
      for (int t = 0; t < HP; ++t)
        if (t < nh) m[t] = nan_max(m[t], __ldg(l + (int64_t)k * H + h0 + t));
#pragma unroll
    for (int t = 0; t < HP; ++t)
      if (t < nh) m[t] = subwarp_combine<LPR, true>(m[t], mask);
    for (int k = s; k < n; k += LPR)
#pragma unroll
      for (int t = 0; t < HP; ++t)
        if (t < nh) sum[t] += expf(__ldg(l + (int64_t)k * H + h0 + t) - m[t]);
#pragma unroll
    for (int t = 0; t < HP; ++t)
      if (t < nh)
        sum[t] = 1.f / nan_max(1e-16f,
                               subwarp_combine<LPR, false>(sum[t], mask));
    for (int k = s; k < n; k += LPR)
#pragma unroll
      for (int t = 0; t < HP; ++t)
        if (t < nh) {
          const int64_t i = (int64_t)k * H + h0 + t;
          o[i] = expf(__ldg(l + i) - m[t]) * sum[t];
        }
  }
}

// Backward, H divides 32: one head per lane.
template <int H>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
edge_softmax_bwd_kernel(const int* __restrict__ rowptr,
                        const float* __restrict__ p,
                        const float* __restrict__ g,
                        float* __restrict__ out, int M) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;  // uniform across the warp
  const int64_t lo = (int64_t)rowptr[row] * H;
  const int64_t hi = (int64_t)rowptr[row + 1] * H;
  if (lo == hi) return;

  float d = 0.f;
  for (int64_t i = lo + lane; i < hi; i += 32) d = fmaf(p[i], g[i], d);
  d = warp_sum<H>(d);
  for (int64_t i = lo + lane; i < hi; i += 32) out[i] = p[i] * (g[i] - d);
}

// Backward, any H: loop over heads, lanes stride over the row's edges.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
edge_softmax_bwd_generic_kernel(const int* __restrict__ rowptr,
                                const float* __restrict__ p,
                                const float* __restrict__ g,
                                float* __restrict__ out, int M, int H) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;  // uniform across the warp
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  for (int h = 0; h < H; ++h) {
    float d = 0.f;
    for (int e = start + lane; e < end; e += 32) {
      const int64_t i = (int64_t)e * H + h;
      d = fmaf(p[i], g[i], d);
    }
    d = warp_sum<1>(d);
    for (int e = start + lane; e < end; e += 32) {
      const int64_t i = (int64_t)e * H + h;
      out[i] = p[i] * (g[i] - d);
    }
  }
}

// An instance of the forward: vec 4 (the chunks instance) or 1 (the
// edges instance), lanes a row, chunks (edges) a lane.
struct Sweep {
  int vec;
  int lanes;
  int chunks;
};

// The instance for M rows, E edges and H heads, with logits and out on
// 16-byte boundaries (aligned) or not.  units: the chunks (edges) of the
// mean row, one more for a slab of H < 4 that starts inside a chunk.
Sweep choose(int M, int64_t E, int H, bool aligned) {
  if (M < 1) M = 1;
  Sweep in;
  in.vec = aligned && H > 0 && H <= 32 && 32 % H == 0 ? 4 : 1;
  int64_t units;
  int least = 1;
  if (in.vec == 4) {
    units = (E * H + 4 * (int64_t)M - 1) / (4 * (int64_t)M) + (H < 4);
    least = H < 4 ? 1 : H / 4;
  } else {
    units = (E + M - 1) / M;
  }
  in.lanes = 1;
  while (in.lanes < 32 && (int64_t)in.lanes * kChunksAtMean < units)
    in.lanes <<= 1;
  if (in.lanes < least) in.lanes = least;
  in.chunks = (int64_t)in.lanes * kLaneChunks >= 2 * units ? kLaneChunks
                                                          : 2 * kLaneChunks;
  return in;
}

dim3 grid_of(const Sweep& in, int M) {
  const int rows_a_block = kWarpsPerBlock * (32 / in.lanes);
  return dim3((M + rows_a_block - 1) / rows_a_block);
}

// The chunks instance (H, in.lanes, in.chunks): LPR runs from H/4 (at
// least 1) to 32; 2 * kLaneChunks chunks only at 32 lanes.
template <int H, int LPR = (H < 4 ? 1 : H / 4)>
int launch_chunks(const Sweep& in, const int* rp, const float* lp,
                  float* op, int M, cudaStream_t s) {
  if (in.lanes != LPR) {
    if constexpr (LPR < 32) {
      return launch_chunks<H, 2 * LPR>(in, rp, lp, op, M, s);
    } else {
      return (int)cudaErrorInvalidValue;  // no instance: a bug in choose()
    }
  }
  constexpr int threads = kWarpsPerBlock * 32;
  if (in.chunks == kLaneChunks) {
    softmax_chunks_kernel<H, LPR, kLaneChunks>
        <<<grid_of(in, M), threads, 0, s>>>(rp, lp, op, M);
  } else if constexpr (LPR == 32) {
    softmax_chunks_kernel<H, LPR, 2 * kLaneChunks>
        <<<grid_of(in, M), threads, 0, s>>>(rp, lp, op, M);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int LPR = 1>
int launch_edges(const Sweep& in, const int* rp, const float* lp, float* op,
                 int M, int H, cudaStream_t s) {
  if (in.lanes != LPR) {
    if constexpr (LPR < 32) {
      return launch_edges<2 * LPR>(in, rp, lp, op, M, H, s);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  constexpr int threads = kWarpsPerBlock * 32;
  if (in.chunks == kLaneChunks) {
    softmax_edges_kernel<LPR, kLaneChunks>
        <<<grid_of(in, M), threads, 0, s>>>(rp, lp, op, M, H);
  } else if constexpr (LPR == 32) {
    softmax_edges_kernel<LPR, 2 * kLaneChunks>
        <<<grid_of(in, M), threads, 0, s>>>(rp, lp, op, M, H);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int launch(const Sweep& in, const int* rp, const float* lp, float* op, int M,
           int H, cudaStream_t s) {
  if (in.vec == 1) return launch_edges(in, rp, lp, op, M, H, s);
  switch (H) {
    case 1: return launch_chunks<1>(in, rp, lp, op, M, s);
    case 2: return launch_chunks<2>(in, rp, lp, op, M, s);
    case 4: return launch_chunks<4>(in, rp, lp, op, M, s);
    case 8: return launch_chunks<8>(in, rp, lp, op, M, s);
    case 16: return launch_chunks<16>(in, rp, lp, op, M, s);
    case 32: return launch_chunks<32>(in, rp, lp, op, M, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int H>
void launch_bwd(const int* rowptr, const float* p, const float* g,
                float* out, int M, cudaStream_t stream) {
  const dim3 grid((M + kWarpsPerBlock - 1) / kWarpsPerBlock);
  edge_softmax_bwd_kernel<H><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      rowptr, p, g, out, M);
}

}  // namespace

extern "C" {

// rowptr (M+1) int32, logits (E, H) float32 row-major in CSR edge order,
// out (E, H) float32 row-major.
int edge_softmax_f32(int device, const void* rowptr, const void* logits,
                     void* out, int M, int E, int H, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || H <= 0) return 0;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(logits) | reinterpret_cast<uintptr_t>(out);
  const Sweep in = choose(M, E, H, bits % 16 == 0);
  return launch(in, static_cast<const int*>(rowptr),
                static_cast<const float*>(logits), static_cast<float*>(out),
                M, H, static_cast<cudaStream_t>(stream));
}

// The instance edge_softmax_f32 runs for M rows, E edges, H heads and
// operands on 16-byte boundaries (aligned != 0) or not: {vec, lanes,
// chunks} into out3.  Returns 0.
int edge_softmax_instance(int M, int E, int H, int aligned, int* out3) {
  const Sweep in = choose(M, E, H, aligned != 0);
  out3[0] = in.vec;
  out3[1] = in.lanes;
  out3[2] = in.chunks;
  return 0;
}

// The backward.  rowptr (M+1) int32; p (the forward's output), g (the
// output gradient) and out (the logits' gradient), each (E, H) float32
// row-major in CSR edge order.  Rows with no edge write nothing.
int edge_softmax_bwd_f32(int device, const void* rowptr, const void* p,
                         const void* g, void* out, int M, int H,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || H <= 0) return 0;
  const int* rp = static_cast<const int*>(rowptr);
  const float* pp = static_cast<const float*>(p);
  const float* gp = static_cast<const float*>(g);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 1: launch_bwd<1>(rp, pp, gp, op, M, s); break;
    case 2: launch_bwd<2>(rp, pp, gp, op, M, s); break;
    case 4: launch_bwd<4>(rp, pp, gp, op, M, s); break;
    case 8: launch_bwd<8>(rp, pp, gp, op, M, s); break;
    case 16: launch_bwd<16>(rp, pp, gp, op, M, s); break;
    case 32: launch_bwd<32>(rp, pp, gp, op, M, s); break;
    default: {
      const dim3 grid((M + kWarpsPerBlock - 1) / kWarpsPerBlock);
      edge_softmax_bwd_generic_kernel<<<grid, kWarpsPerBlock * 32, 0, s>>>(
          rp, pp, gp, op, M, H);
    }
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
