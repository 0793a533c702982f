// CSR row-gather SpMM: out[r, k] = sum_{p in [rowptr[r], rowptr[r+1])} val[p] * x[col[p], k]
//
// Replaces the JAX package's gather route, pytorch_sparse_tpu/ops/kernels/ell.py:
// ell_spmm (:309) and _bucket_sum (:268).  There, rows were grouped into
// degree buckets padded to a fixed width (ELLPACK) because XLA on the TPU
// has no fast scatter.  A GPU reads CSR directly, so no padding and no
// bucket permutation remain.
//
// What bounds it on an H100: the rows of x that its edges gather, one
// K-wide row an edge, from L2 where they sit there (community graphs) and
// from device memory where x outgrows L2 (the ogbn-arxiv-scale uniform
// graph's 86.7 MB at K=128), and the issue rate of its per-edge
// instructions; csr_walk.cuh says how the design spends few of them.
//
// The kernel is the CSR walk of csr_walk.cuh (shared with shard_spmm.cu):
// 16-byte loads, several edges' rows in flight, and sub-warp rows at
// narrow widths.  Each output element is one fmaf chain from 0 in CSR
// edge order: no atomics, deterministic, and the same order as
// _bucket_sum's left-to-right slot sum.  Rows of degree 0 write 0.
//
// The interface is plain C, bound from Python with ctypes: pointers come
// in as void*, the launch goes on the caller's stream, and the return
// value is cudaGetLastError() after the launch.

#include "csr_walk.cuh"

extern "C" {

// rowptr (M+1) int32, col (E) int32, val (E) float32 or NULL for implicit
// ones, x (N, K) float32 row-major, out (M, K) float32 row-major.
int csr_spmm_f32(int device, const void* rowptr, const void* col,
                 const void* val, const void* x, void* out, int M, int K,
                 void* stream) {
  return csr_walk::run(device, rowptr, col, val, x, nullptr, out, M, K, 0,
                       stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
