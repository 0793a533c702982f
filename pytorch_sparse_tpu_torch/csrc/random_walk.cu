// Uniform random walks: walk i starts at start[i] and takes L steps; step l
// moves from cur to col[rowptr[cur] + trunc(rand[i, l] * deg)] with
// deg = rowptr[cur+1] - rowptr[cur], or stays at cur where deg == 0.
//
// Replaces the JAX package's walk, pytorch_sparse_tpu/sample/rw.py:21
// _walk: a lax.scan of gathers over a pre-drawn (n, L) uniform matrix.
// The kernel takes the same pre-drawn matrix, so the same uniforms give
// the same walks.  The step index is computed as there, in f32:
// __fmul_rn(r, (float)deg) rounds the product once (nothing is contracted
// into another operation) and the cast truncates toward zero.
//
// What bounds it on an H100: latency, not bandwidth.  The bytes are few
// (each uniform read once, each walk entry written once, 8 bytes a step),
// but every step makes two dependent gathers at a random node: rowptr at
// cur, then col at the drawn edge.  So the card must keep many walks in
// flight to hide the device-memory latency of each chain.
//
// Design: one thread per walk, as many walks as the caller gives (a
// Node2Vec epoch has millions), so the card holds its full occupancy of
// independent gather chains.  rowptr and col go through the read-only
// cache (__ldg).  A thread reads its own row of uniforms and writes its
// own row of the output; neighbouring threads touch neighbouring rows,
// which L1 and L2 absorb.
//
// The interface is plain C, bound from Python with ctypes: pointers come
// in as void*, the launch goes on the caller's stream, and the return
// value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
random_walk_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
                   const int* __restrict__ start,
                   const float* __restrict__ rand, int* __restrict__ out,
                   int n, int L) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* __restrict__ r = rand + i * L;
  int* __restrict__ o = out + i * (L + 1);
  int cur = start[i];
  o[0] = cur;
  for (int l = 0; l < L; ++l) {
    const int lo = __ldg(rowptr + cur);
    const int deg = __ldg(rowptr + cur + 1) - lo;
    if (deg > 0) {
      const int e = lo + (int)__fmul_rn(r[l], __int2float_rn(deg));
      cur = __ldg(col + e);
    }
    o[l + 1] = cur;
  }
}

}  // namespace

extern "C" {

// rowptr (M+1) int32, col (E) int32, start (n) int32 node ids in [0, M),
// rand (n, L) float32 row-major in [0, 1), out (n, L+1) int32 row-major.
int random_walk_i32(int device, const void* rowptr, const void* col,
                    const void* start, const void* rand, void* out, int n,
                    int L, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  random_walk_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(col),
      static_cast<const int*>(start), static_cast<const float*>(rand),
      static_cast<int*>(out), n, L);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
