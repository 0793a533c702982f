// Segmented product sum over a SpGEMM plan:
//   out[s] = sum over t in [t_ptr[s], t_ptr[s+1]) of x[i[t]] * y[j[t]]
// (y == NULL means implicit ones: out[s] = sum of x[i[t]]).
//
// This is the numeric pass of SpSpMM.  It replaces the JAX package's
// pytorch_sparse_tpu/ops/matmul.py: _plan_numeric (:606), which gathers
// the product terms valueA[a_pos] * valueB[b_pos] and sums each output
// entry's run of terms through term-count buckets (the t_tabs/inv tables
// of _spspmm_structure, :572-597, with the bucket widths of
// pytorch_sparse_tpu/ops/kernels/ell.py: _choose_caps).  Those tables
// exist only to keep XLA on the TPU free of scatters.  The structure
// pass sorts the terms by (row, col), so each output entry's terms are
// one contiguous run; a term pointer t_ptr (n_out + 1) is all a GPU
// needs.  The forward runs it with x = valueA, i = a_pos, y = valueB,
// j = b_pos.  The two value gradients run the same kernel over the terms
// re-sorted by a_pos or by b_pos: grad_valueA[e] = sum of grad_C[out_id]
// * valueB[b_pos] over the terms of A-entry e, and alike for valueB.
//
// What bounds it on an H100: device-memory bytes.  Each term reads two
// int32 indices (coalesced, since t runs with s) and gathers two values;
// each output reads one pointer and writes one value.  The arithmetic (2
// flops per term) is negligible.  The value gathers are random, but the
// value arrays of one plan are a few MB and stay in the 50 MB L2.
//
// Design: one thread per output entry.  Uniform graphs give about one
// term an entry and community graphs tens, so a thread's loop is short
// and neighbouring threads read neighbouring index words.  Each product
// is rounded to float32 (__fmul_rn, no FMA contraction) and added in term
// order, in float32, so the result is deterministic and equals the plain
// version's term-order sum.  Half operands (f16, bf16) are widened first:
// their products are exact in float32.  The sum is rounded once to the
// output dtype, which is the operands' dtype (the wrapper casts both
// operands to their promoted dtype first).  Indices are int32: a plan
// holds at most 2^26 terms by default, and the wrapper refuses 2^31.
//
// The interface is plain C, bound from Python with ctypes: pointers come
// in as void*, the launch goes on the caller's stream, and the return
// value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, bool HAS_Y>
__global__ void __launch_bounds__(kThreads)
plan_numeric_kernel(const T* __restrict__ x, const int* __restrict__ xi,
                    const T* __restrict__ y, const int* __restrict__ yj,
                    const int* __restrict__ t_ptr, T* __restrict__ out,
                    int n_out) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= n_out) return;
  const int t0 = t_ptr[s];
  const int t1 = t_ptr[s + 1];
  float acc = 0.f;
  for (int t = t0; t < t1; ++t) {
    const float a = to_float(x[xi[t]]);
    const float p = HAS_Y ? __fmul_rn(a, to_float(y[yj[t]])) : a;
    acc = __fadd_rn(acc, p);
  }
  out[s] = from_float<T>(acc);
}

template <typename T>
void launch(const void* x, const void* xi, const void* y, const void* yj,
            const void* t_ptr, void* out, int n_out, cudaStream_t stream) {
  const dim3 grid((n_out + kThreads - 1) / kThreads);
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  const int* ip = static_cast<const int*>(xi);
  const int* jp = static_cast<const int*>(yj);
  const int* tp = static_cast<const int*>(t_ptr);
  T* op = static_cast<T*>(out);
  if (y != nullptr) {
    plan_numeric_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xp, ip, yp, jp, tp, op, n_out);
  } else {
    plan_numeric_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xp, ip, yp, jp, tp, op, n_out);
  }
}

}  // namespace

extern "C" {

// dtype 0 float32, 1 float16, 2 bfloat16 (x, y and out alike).  x (nx),
// xi (T) int32, y (ny) or NULL for ones, yj (T) int32 (unused when y is
// NULL), t_ptr (n_out + 1) int32 over the T terms, out (n_out).
int plan_numeric(int device, int dtype, const void* x, const void* xi,
                 const void* y, const void* yj, const void* t_ptr, void* out,
                 int n_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_out <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, xi, y, yj, t_ptr, out, n_out, s);
  } else if (dtype == 1) {
    launch<__half>(x, xi, y, yj, t_ptr, out, n_out, s);
  } else if (dtype == 2) {
    launch<__nv_bfloat16>(x, xi, y, yj, t_ptr, out, n_out, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
