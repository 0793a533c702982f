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
// flops per element are far below the card's rate.  The slab is read three
// times (max, sum, write), the second and third time from L1/L2.
//
// Design: one warp per row sweeps its slab coalesced, lane i taking
// elements i, i+32, ...  When H divides 32 every element a lane sees
// belongs to head lane % H (the slab starts at a multiple of H), so each
// lane keeps one running max and one running sum, and the per-head max and
// sum reduce with __shfl_xor_sync over offsets 16, 8, ..., H: exactly the
// lanes of one head combine.  Other H take a generic instance that loops
// over heads, lanes striding over the row's edges.  NaN propagates as in
// jnp.max; a row-head whose logits are all -inf gives NaN, as in JAX.
// Hand-written CUDA like the package's other kernels (a Triton reduction
// would also fit; the port builds every kernel with one toolchain).
//
// The backward (edge_softmax_bwd_f32) is the gradient JAX takes by
// autodiff through ell_edge_softmax and models/gat.py:16-24: with p the
// forward's output and g the output gradient,
//   grad_l[e, h] = p[e, h] * (g[e, h] - sum_{e' in row r} p[e', h] * g[e', h]).
// It is bound by bytes as the forward is (p and g read, grad_l written:
// 12 bytes per edge and head), and runs on the same warp-per-row sweep: the
// per-head dot sum_row p*g reduces across the warp, then a second sweep
// writes p * (g - dot).  Rows are independent, so there are no atomics.
//
// The interface is plain C, bound from Python with ctypes: pointers come
// in as void*, the launch goes on the caller's stream, and the return
// value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// max that propagates NaN, as jnp.max does.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// Combine over lanes that differ in offsets 16, 8, ..., LO.
template <int LO>
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off >= LO; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

template <int LO>
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= LO; off >>= 1)
    v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// H divides 32: one head per lane.
template <int H>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
edge_softmax_kernel(const int* __restrict__ rowptr,
                    const float* __restrict__ logits,
                    float* __restrict__ out, int M) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;  // uniform across the warp
  const int64_t lo = (int64_t)rowptr[row] * H;
  const int64_t hi = (int64_t)rowptr[row + 1] * H;
  if (lo == hi) return;

  float m = -INFINITY;
  for (int64_t i = lo + lane; i < hi; i += 32) m = nan_max(m, logits[i]);
  m = warp_max<H>(m);
  float s = 0.f;
  for (int64_t i = lo + lane; i < hi; i += 32) s += expf(logits[i] - m);
  s = fmaxf(warp_sum<H>(s), 1e-16f);
  for (int64_t i = lo + lane; i < hi; i += 32)
    out[i] = expf(logits[i] - m) / s;
}

// Any H: loop over heads, lanes stride over the row's edges.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
edge_softmax_generic_kernel(const int* __restrict__ rowptr,
                            const float* __restrict__ logits,
                            float* __restrict__ out, int M, int H) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;  // uniform across the warp
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  for (int h = 0; h < H; ++h) {
    float m = -INFINITY;
    for (int e = start + lane; e < end; e += 32)
      m = nan_max(m, logits[(int64_t)e * H + h]);
    m = warp_max<1>(m);
    float s = 0.f;
    for (int e = start + lane; e < end; e += 32)
      s += expf(logits[(int64_t)e * H + h] - m);
    s = fmaxf(warp_sum<1>(s), 1e-16f);
    for (int e = start + lane; e < end; e += 32)
      out[(int64_t)e * H + h] = expf(logits[(int64_t)e * H + h] - m) / s;
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

template <int H>
void launch(const int* rowptr, const float* logits, float* out, int M,
            cudaStream_t stream) {
  const dim3 grid((M + kWarpsPerBlock - 1) / kWarpsPerBlock);
  edge_softmax_kernel<H><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      rowptr, logits, out, M);
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
                     void* out, int M, int H, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || H <= 0) return 0;
  const int* rp = static_cast<const int*>(rowptr);
  const float* lp = static_cast<const float*>(logits);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 1: launch<1>(rp, lp, op, M, s); break;
    case 2: launch<2>(rp, lp, op, M, s); break;
    case 4: launch<4>(rp, lp, op, M, s); break;
    case 8: launch<8>(rp, lp, op, M, s); break;
    case 16: launch<16>(rp, lp, op, M, s); break;
    case 32: launch<32>(rp, lp, op, M, s); break;
    default: {
      const dim3 grid((M + kWarpsPerBlock - 1) / kWarpsPerBlock);
      edge_softmax_generic_kernel<<<grid, kWarpsPerBlock * 32, 0, s>>>(
          rp, lp, op, M, H);
    }
  }
  return (int)cudaGetLastError();
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
