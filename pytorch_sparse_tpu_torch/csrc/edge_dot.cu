// Per-edge dot product: out[e] = sum_k x[col[e], k] * g[row(e), k]
// over the edges e of a CSR matrix, in CSR order.
//
// This is the grad_value pass of SpMM-sum (grad_value[e] =
// <mat[col e], grad_out[row e]>).  It replaces the JAX package's
// pytorch_sparse_tpu/ops/kernels/ell.py: ell_edge_dot (:353), which runs
// it in ELL layout (degree buckets padded to a fixed width), and
// pytorch_sparse_tpu/ops/matmul.py: _edge_dot_chunked (:313), the
// lax.scan-chunked two-gather form of the hybrid route.  A GPU reads CSR
// directly, so no padding and no chunking remain.
//
// What bounds it on an H100: device-memory bytes.  Each edge reads one
// K-wide row of x (4K bytes) and its column index, and writes one float;
// 2K flops per edge are far below the card's rate.
//
// Design: one warp per CSR row.  The warp loads g[row] once into
// registers (lanes own columns k = lane + 32*j, KPL columns per lane, K
// masked), which is the "gather g once per row" saving ell_edge_dot was
// written for, without the ELL padding.  The warp walks its row's edges
// 32 at a time: each lane loads one column index (coalesced) and
// __shfl_sync broadcasts them one by one.  For each edge the lanes read
// their columns of x[col e] (one coalesced row segment), multiply with
// their g registers, and reduce across the warp with __shfl_xor_sync;
// lane t keeps the dot of the t-th edge of the batch, and the batch's 32
// results are written with one coalesced store.  No atomics, and one
// fixed summation order: deterministic.  K above 256 takes a generic
// instance that reads g from global memory (L1) instead of registers.
// Known weak spot: at K=40 most lanes idle on the second column step.
//
// The interface is plain C, bound from Python with ctypes: pointers come
// in as void*, the launch goes on the caller's stream, and the return
// value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// KPL > 0: g[row] lives in KPL registers per lane (K <= 32 * KPL).
// KPL == 0: any K, g[row] read from global memory.
template <int KPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
edge_dot_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
                const float* __restrict__ x, const float* __restrict__ g,
                float* __restrict__ out, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;  // uniform across the warp
  const float* __restrict__ grow = g + (int64_t)row * K;

  float g_reg[KPL > 0 ? KPL : 1];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = lane + 32 * j;
    g_reg[j] = k < K ? grow[k] : 0.f;
  }

  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  for (int base = start; base < end; base += 32) {
    const int n = min(32, end - base);
    const int my_c = lane < n ? col[base + lane] : 0;
    float mine = 0.f;
    for (int t = 0; t < n; ++t) {
      const int c = __shfl_sync(kFullMask, my_c, t);
      const float* __restrict__ xr = x + (int64_t)c * K;
      float part = 0.f;
      if (KPL > 0) {
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const int k = lane + 32 * j;
          if (k < K) part = fmaf(__ldg(xr + k), g_reg[j], part);
        }
      } else {
        for (int k = lane; k < K; k += 32)
          part = fmaf(__ldg(xr + k), __ldg(grow + k), part);
      }
      const float dot = warp_sum(part);
      if (lane == t) mine = dot;
    }
    if (lane < n) out[base + lane] = mine;
  }
}

template <int KPL>
void launch(const int* rowptr, const int* col, const float* x, const float* g,
            float* out, int M, int K, cudaStream_t stream) {
  const dim3 grid((M + kWarpsPerBlock - 1) / kWarpsPerBlock);
  edge_dot_kernel<KPL><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      rowptr, col, x, g, out, M, K);
}

}  // namespace

extern "C" {

// rowptr (M+1) int32, col (E) int32, x (N, K) float32 row-major,
// g (M, K) float32 row-major, out (E) float32.
int edge_dot_f32(int device, const void* rowptr, const void* col,
                 const void* x, const void* g, void* out, int M, int K,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0) return 0;
  const int* rp = static_cast<const int*>(rowptr);
  const int* ci = static_cast<const int*>(col);
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(g);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 32) {
    launch<1>(rp, ci, xp, gp, op, M, K, s);
  } else if (K <= 64) {
    launch<2>(rp, ci, xp, gp, op, M, K, s);
  } else if (K <= 128) {
    launch<4>(rp, ci, xp, gp, op, M, K, s);
  } else if (K <= 256) {
    launch<8>(rp, ci, xp, gp, op, M, K, s);
  } else {
    launch<0>(rp, ci, xp, gp, op, M, K, s);
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
