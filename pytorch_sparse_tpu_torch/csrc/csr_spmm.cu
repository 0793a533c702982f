// CSR row-gather SpMM: out[r, k] = sum_{p in [rowptr[r], rowptr[r+1])} val[p] * x[col[p], k]
//
// Replaces the JAX package's gather route, pytorch_sparse_tpu/ops/kernels/ell.py:
// ell_spmm (:309) and _bucket_sum (:268).  There, rows were grouped into
// degree buckets padded to a fixed width (ELLPACK) because XLA on the TPU
// has no fast scatter.  A GPU reads CSR directly, so no padding and no
// bucket permutation remain.
//
// What bounds it on an H100: device-memory bytes.  Each edge reads one
// K-wide row of x (4K bytes) plus its column index and value (8 bytes);
// the arithmetic (2 flops per edge and column) is far below the card's
// rate.  The rows of x are scattered, so what matters is that each
// gather is a whole coalesced row segment and that L2 catches reuse.
//
// Design: one warp per row.  The lanes own columns k = lane + 32*j of the
// output row and keep their sums in registers (KPL columns per lane).  The
// warp walks its row's edges in CSR order, 32 at a time: each lane loads
// one (col, val) pair, and __shfl_sync broadcasts them one by one, so the
// index and value reads are coalesced and every x row is read as
// contiguous 128-byte segments.  Every output element is summed by one
// thread in CSR edge order: no atomics, deterministic, and the same
// order as _bucket_sum's left-to-right slot sum.  Rows of degree 0 write
// 0.  K need not be a multiple of 32 (lanes past K are masked).  Wide K
// takes several column tiles (gridDim.y).
//
// The interface is plain C, bound from Python with ctypes: pointers come
// in as void*, the launch goes on the caller's stream, and the return
// value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

template <int KPL, bool HAS_VAL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_spmm_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
                const float* __restrict__ val, const float* __restrict__ x,
                float* __restrict__ out, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;  // uniform across the warp
  const int k0 = blockIdx.y * (32 * KPL) + lane;

  float acc[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) acc[j] = 0.f;

  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  for (int base = start; base < end; base += 32) {
    const int n = min(32, end - base);
    int my_c = 0;
    float my_v = 0.f;
    if (lane < n) {
      my_c = col[base + lane];
      my_v = HAS_VAL ? val[base + lane] : 1.f;
    }
    for (int t = 0; t < n; ++t) {
      const int c = __shfl_sync(kFullMask, my_c, t);
      const float v = __shfl_sync(kFullMask, my_v, t);
      const float* __restrict__ xr = x + (int64_t)c * K;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int k = k0 + 32 * j;
        if (k < K) acc[j] = fmaf(v, __ldg(xr + k), acc[j]);
      }
    }
  }

  float* __restrict__ orow = out + (int64_t)row * K;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = k0 + 32 * j;
    if (k < K) orow[k] = acc[j];
  }
}

template <int KPL>
void launch(const int* rowptr, const int* col, const float* val,
            const float* x, float* out, int M, int K, cudaStream_t stream) {
  dim3 grid((M + kWarpsPerBlock - 1) / kWarpsPerBlock,
            (K + 32 * KPL - 1) / (32 * KPL));
  dim3 block(kWarpsPerBlock * 32);
  if (val != nullptr) {
    csr_spmm_kernel<KPL, true><<<grid, block, 0, stream>>>(
        rowptr, col, val, x, out, M, K);
  } else {
    csr_spmm_kernel<KPL, false><<<grid, block, 0, stream>>>(
        rowptr, col, val, x, out, M, K);
  }
}

}  // namespace

extern "C" {

// rowptr (M+1) int32, col (E) int32, val (E) float32 or NULL for implicit
// ones, x (N, K) float32 row-major, out (M, K) float32 row-major.
int csr_spmm_f32(int device, const void* rowptr, const void* col,
                 const void* val, const void* x, void* out, int M, int K,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || K <= 0) return 0;
  if ((K + 255) / 256 > 65535) return (int)cudaErrorInvalidValue;
  const int* rp = static_cast<const int*>(rowptr);
  const int* ci = static_cast<const int*>(col);
  const float* v = static_cast<const float*>(val);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 32) {
    launch<1>(rp, ci, v, xp, op, M, K, s);
  } else if (K <= 64) {
    launch<2>(rp, ci, v, xp, op, M, K, s);
  } else if (K <= 128) {
    launch<4>(rp, ci, v, xp, op, M, K, s);
  } else {
    launch<8>(rp, ci, v, xp, op, M, K, s);
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
