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
// Design: the per-edge walk of edge_walk.cuh, on the CSR walk's
// instances: float4 chunks of g[row] kept in registers by the lanes K
// needs (several rows a warp below K=128), 8 edges' rows of x issued
// before their first FMA, and one transposing butterfly a batch of 8
// edges.  No atomics, and one fixed summation order: deterministic.
//
// The interface is plain C, bound from Python with ctypes: pointers come
// in as void*, the launch goes on the caller's stream, and the return
// value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_walk.cuh"

extern "C" {

// rowptr (M+1) int32, col (E) int32, x (N, K) float32 row-major,
// g (M, K) float32 row-major, out (E) float32; K >= 1.
int edge_dot_f32(int device, const void* rowptr, const void* col,
                 const void* x, const void* g, void* out, int M, int K,
                 void* stream) {
  return edge_walk::run<false>(device, rowptr, col, x, g, nullptr, out, M, K,
                               stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
