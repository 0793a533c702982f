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
// What bounds it on an H100: the gathers.  The bytes are few (each
// uniform read once, each walk entry written once, 8 bytes a step), but
// every step makes two dependent gathers at a random node, rowptr at cur
// and then col at the drawn edge: two sectors a step from L1 or L2, each
// lane's a wavefront of its own in L1.
//
// Design: a block's walks are consecutive rows, so its uniforms (W * L
// floats) and its walks (W * (L+1) ints) are each one contiguous range of
// device memory.  The block copies its uniforms into shared memory with
// 16-byte loads (a head and a tail that are not 16-byte aligned word by
// word: L may be odd and rand a slice at any 4-byte offset), walks from
// there, one walk a thread, writing each step into shared memory, and
// copies its walks out with 16-byte stores.  So the only scattered
// accesses left are the gathers, and of those the two of rowptr are one
// 8-byte load where cur is even.  The staged rows sit at odd word strides
// (L | 1 for the uniforms, (L + 1) | 1 for the walks), so that the 32
// walks of a warp read and write 32 distinct banks each step.  A block
// stages 256 walks (43 KB at L = 20); longer walks get fewer walks a
// block, and walks so long that kMinWalks of them would not fit
// kStageBytes (L > 191) run the unstaged kernel (a thread a walk, its
// rows read and written in place).  The staged kernel asks for a
// shared-memory carveout of kCarveout percent (three blocks an SM at
// L = 20), so that L1 keeps room for the rowptr and col lines the
// gathers hit again.  Measured on an H100 (PERF.md, the K12 findings):
// the pair load and the carveout each made Node2Vec faster; two walks a
// thread, their gather chains interleaved, each step's node written over
// the uniform it used (half the shared memory), and staging 8 or 4 steps
// of every walk at a time (more blocks an SM, a barrier a chunk) did not.
// The arithmetic of a step is the same in both kernels, so both give the
// plain version's walks bit for bit.
//
// The interface is plain C, bound from Python with ctypes: pointers come
// in as void*, the launch goes on the caller's stream, and the return
// value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStageBytes = 48 * 1024;  // a block's staged rows, at most
constexpr int kMinWalks = 32;           // a block stages at least a warp's
constexpr int kCarveout = 50;           // shared memory, % of the SM's most
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int odd(int n) { return n | 1; }

// Staged bytes of one walk: its uniforms and its walk at odd strides.
constexpr int staged_bytes(int L) { return 4 * (odd(L) + odd(L + 1)); }

// Walks a block stages: the most that fit kStageBytes, a multiple of a
// warp's, at most kThreads; 0 if fewer than kMinWalks fit.
int staged_walks(int L) {
  if (L > kStageBytes) return 0;
  int w = kStageBytes / staged_bytes(L);
  w = w < kThreads ? w : kThreads;
  w -= w % 32;
  return w < kMinWalks ? 0 : w;
}

// One step from cur with the uniform r: the JAX package's step, exactly.
// PAIR (rowptr on an 8-byte boundary): rowptr[cur] and rowptr[cur + 1] as
// one 8-byte load where cur is even, so a warp's two rowptr gathers take
// 1.5 of L1's wavefronts a lane instead of 2.
template <bool PAIR>
__device__ __forceinline__ int step(const int* __restrict__ rowptr,
                                    const int* __restrict__ col, int cur,
                                    float r) {
  int lo, hi;
  if (PAIR && (cur & 1) == 0) {
    const int2 p = __ldg(reinterpret_cast<const int2*>(rowptr + cur));
    lo = p.x;
    hi = p.y;
  } else {
    lo = __ldg(rowptr + cur);
    hi = __ldg(rowptr + cur + 1);
  }
  const int deg = hi - lo;
  if (deg > 0) {
    const int e = lo + (int)__fmul_rn(r, __int2float_rn(deg));
    cur = __ldg(col + e);
  }
  return cur;
}

// Words from p (on a 4-byte boundary) to the next 16-byte boundary.
__device__ __forceinline__ int words_to_16(const void* p) {
  return (int)((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4;
}

// Word j of a block's range of rows of `width` words, at its place in the
// staged rows of `stride` words.
__device__ __forceinline__ int staged_at(int j, int width, int stride) {
  const int row = j / width;
  return row * stride + (j - row * width);
}

// Copies the block's count = nw * L uniforms from src into rows of
// `stride` words: 16-byte loads from the first 16-byte boundary on, the
// words before it and after the last whole chunk one by one.
__device__ __forceinline__ void stage_in(float* __restrict__ dst,
                                         const float* __restrict__ src,
                                         int count, int L, int stride) {
  const int head = min(count, words_to_16(src));
  const int chunks = (count - head) >> 2;
  const int tail = head + 4 * chunks;
  for (int j = threadIdx.x; j < head; j += blockDim.x) {
    dst[staged_at(j, L, stride)] = __ldg(src + j);
  }
  const float4* src4 = reinterpret_cast<const float4*>(src + head);
#pragma unroll 4
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const float4 v = __ldg(src4 + c);
    const int j = head + 4 * c;
    int row = j / L, w = j - row * L;
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      dst[row * stride + w] = e[q];
      if (++w == L) {
        w = 0;
        ++row;
      }
    }
  }
  for (int j = tail + threadIdx.x; j < count; j += blockDim.x) {
    dst[staged_at(j, L, stride)] = __ldg(src + j);
  }
}

// Copies the block's count = nw * (L + 1) walk words, staged in rows of
// `stride` words, out to dst: 16-byte stores from the first 16-byte
// boundary on, the words before it and after the last whole chunk one by
// one.
__device__ __forceinline__ void stage_out(int* __restrict__ dst,
                                          const int* __restrict__ src,
                                          int count, int L, int stride) {
  const int width = L + 1;
  const int head = min(count, words_to_16(dst));
  const int chunks = (count - head) >> 2;
  const int tail = head + 4 * chunks;
  for (int j = threadIdx.x; j < head; j += blockDim.x) {
    dst[j] = src[staged_at(j, width, stride)];
  }
  int4* dst4 = reinterpret_cast<int4*>(dst + head);
#pragma unroll 4
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int j = head + 4 * c;
    int row = j / width, w = j - row * width;
    int e[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      e[q] = src[row * stride + w];
      if (++w == width) {
        w = 0;
        ++row;
      }
    }
    dst4[c] = make_int4(e[0], e[1], e[2], e[3]);
  }
  for (int j = tail + threadIdx.x; j < count; j += blockDim.x) {
    dst[j] = src[staged_at(j, width, stride)];
  }
}

// The staged walk: block b walks rows [b * W, b * W + W) of start, rand
// and out, a thread a walk.
template <bool PAIR>
__global__ void __launch_bounds__(kThreads)
random_walk_staged_kernel(const int* __restrict__ rowptr,
                          const int* __restrict__ col,
                          const int* __restrict__ start,
                          const float* __restrict__ rand,
                          int* __restrict__ out, int n, int L, int W) {
  extern __shared__ float staged[];
  const int Lr = odd(L), Lo = odd(L + 1);
  float* rs = staged;                                // W rows of Lr uniforms
  int* os = reinterpret_cast<int*>(staged + W * Lr);  // W rows of Lo nodes
  const int64_t w0 = (int64_t)blockIdx.x * W;
  const int64_t left = (int64_t)n - w0;
  const int nw = left < W ? (int)left : W;

  // The walk's start, loaded while the block's uniforms come in.
  const int t = threadIdx.x;
  int cur = t < nw ? __ldg(start + w0 + t) : 0;
  stage_in(rs, rand + w0 * L, nw * L, L, Lr);
  __syncthreads();

  if (t < nw) {
    os[t * Lo] = cur;
    for (int l = 0; l < L; ++l) {
      cur = step<PAIR>(rowptr, col, cur, rs[t * Lr + l]);
      os[t * Lo + l + 1] = cur;
    }
  }
  __syncthreads();

  stage_out(out + w0 * (L + 1), os, nw * (L + 1), L, Lo);
}

// The unstaged walk, for walks too long to stage: a thread a walk, its
// rows of rand and out read and written in place.
template <bool PAIR>
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
    cur = step<PAIR>(rowptr, col, cur, r[l]);
    o[l + 1] = cur;
  }
}

// Asks for kCarveout once per kernel and device.
template <bool PAIR>
void carve(int device) {
  static bool done[kMaxDevices];
  if (device < 0 || device >= kMaxDevices || done[device]) return;
  cudaFuncSetAttribute(random_walk_staged_kernel<PAIR>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       kCarveout);
  done[device] = true;
}

template <bool PAIR>
int launch(int device, const int* rowptr, const int* col, const int* start,
           const float* rand, int* out, int n, int L, cudaStream_t s) {
  const int W = staged_walks(L);
  if (W == 0) {
    random_walk_kernel<PAIR><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                               s>>>(rowptr, col, start, rand, out, n, L);
    return (int)cudaGetLastError();
  }
  carve<PAIR>(device);
  const int blocks = (int)(((int64_t)n + W - 1) / W);
  random_walk_staged_kernel<PAIR><<<blocks, W, W * staged_bytes(L), s>>>(
      rowptr, col, start, rand, out, n, L, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rowptr (M+1) int32 (the pair loads where it lies on an 8-byte
// boundary), col (E) int32, start (n) int32 node ids in [0, M),
// rand (n, L) float32 row-major in [0, 1) on a 4-byte boundary, out
// (n, L+1) int32 row-major on a 4-byte boundary.
int random_walk_i32(int device, const void* rowptr, const void* col,
                    const void* start, const void* rand, void* out, int n,
                    int L, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  if (L < 0) return (int)cudaErrorInvalidValue;
  const int* rp = static_cast<const int*>(rowptr);
  const int* ci = static_cast<const int*>(col);
  const int* st = static_cast<const int*>(start);
  const float* ra = static_cast<const float*>(rand);
  int* op = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return reinterpret_cast<uintptr_t>(rowptr) % 8 == 0
             ? launch<true>(device, rp, ci, st, ra, op, n, L, s)
             : launch<false>(device, rp, ci, st, ra, op, n, L, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
