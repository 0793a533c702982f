// Block-pair SpGEMM over one window of output blocks:
//   out[o, m, n] = sum over pairs p in [seg_ptr[o], seg_ptr[o+1]),
//                  sum_c A[a_idx[p], m, c] * B[b_idx[p], c, n]
// with A (nbA, Bb, Bb) and B (nbB, Bb, Bb) dense blocks and out
// (n_out, Bb, Bb) float32.
//
// This is the dense-block x dense-block share of a sparse product.  It
// replaces the JAX package's
// pytorch_sparse_tpu/ops/kernels/block_spgemm.py: block_spgemm_window
// (:88-140).  There, the pairs of a window were padded to a power-of-two
// number of chunks and walked by a lax.scan (so that windows share
// compiled programs), each chunk a batched MXU product ("sbc,sck->sbk")
// followed by a segment-sum into the output blocks.  A GPU compiles
// once and needs neither the padding nor the scan.
//
// What bounds it on an H100: operations.  A pair costs 2*Bb^3 flops
// against 2*Bb^2 elements read, 512 flops per f32 element at Bb = 512,
// far above the card's flops-per-byte balance for FP32 arithmetic outside
// the tensor cores (67 TFLOP/s over 3.35 TB/s, about 20).  This kernel
// runs on those FP32 units in full fp32; tensor cores (3xTF32 or bf16x3
// through wgmma) are later work.
//
// Design: the register-tiled scheme of csrc/block_spmm.cu, with the
// second operand a block of B instead of a slab of x.  One thread block
// owns one 128x128 tile of one output block (grid: row tiles, output
// blocks, column tiles) and walks that block's pairs, in pair order, in
// steps of 8 reduction indices.  Each step stages a 128x8 tile of A's
// block (kept as As[c][m]) and an 8x128 tile of B's block in shared
// memory; each of the 256 threads accumulates an 8x8 output tile in
// registers, reading 4 float4s from shared memory per 64 FMAs.  The next
// step's tiles are loaded into registers while this step computes, and
// stored into the other half of a double buffer.  The thread block writes
// its tile once at the end: no atomics, no segment-sum, and one fixed
// summation order (pairs in plan order, then c ascending), so the result
// is deterministic.  bf16 stores are widened with __bfloat162float as
// they are staged, so their products are exact in fp32.  Tiles past Bb
// are masked with zeros; an output block with no pair writes zeros.
// Block and output offsets are size_t: a 2,048-block window of 512^2
// f32 is 2 GB.
//
// The interface is plain C, bound from Python with ctypes: pointers come
// in as void*, the launch goes on the caller's stream, and the return
// value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;  // output rows per thread block
constexpr int TN = 128;  // output columns per thread block
constexpr int TK = 8;    // reduction step
constexpr int kThreads = 256;
constexpr int kLoads = TM * TK / kThreads;  // elements per thread per tile
constexpr int kMaxGridY = 65535;
static_assert(TM == TN, "the A tile and the B tile load alike");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
block_spgemm_kernel(const T* __restrict__ blocks_a,
                    const T* __restrict__ blocks_b,
                    const int* __restrict__ a_idx,
                    const int* __restrict__ b_idx,
                    const int* __restrict__ seg_ptr, float* __restrict__ out,
                    int Bb) {
  // As holds the A tile as As[c][m] (c the reduction index); the +4
  // padding keeps its transposed stores free of bank conflicts and the
  // float4 reads aligned.
  __shared__ __align__(16) float As[2][TK][TM + 4];
  __shared__ __align__(16) float Bs[2][TK][TN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4.. and 64+tx*4..
  const int ty = tid / 16;  // rows ty*4.. and 64+ty*4..
  const int m0 = blockIdx.x * TM;
  const int o = blockIdx.y;  // output block within this launch
  const int n0 = blockIdx.z * TN;
  const int p_begin = seg_ptr[o];
  const int steps_per_pair = (Bb + TK - 1) / TK;
  const int nsteps = (seg_ptr[o + 1] - p_begin) * steps_per_pair;
  const size_t blk = (size_t)Bb * Bb;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float a_reg[kLoads];
  float b_reg[kLoads];

  // Global -> registers for step t.
  auto load = [&](int t) {
    const int p = p_begin + t / steps_per_pair;
    const int kk = (t % steps_per_pair) * TK;
    const T* __restrict__ ab = blocks_a + (size_t)a_idx[p] * blk;
    const T* __restrict__ bb = blocks_b + (size_t)b_idx[p] * blk;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads;
      // A[m][c] along c: 8 consecutive words of a row per 8 threads.
      const int m = m0 + idx / TK;
      const int c = kk + idx % TK;
      a_reg[i] = (m < Bb && c < Bb) ? to_float(ab[(size_t)m * Bb + c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads;
      // B[c][n] along n: coalesced rows.
      const int c = kk + idx / TN;
      const int n = n0 + idx % TN;
      b_reg[i] = (c < Bb && n < Bb) ? to_float(bb[(size_t)c * Bb + n]) : 0.f;
    }
  };
  // Registers -> shared buffer `buf`.
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads;
      As[buf][idx % TK][idx / TK] = a_reg[i];
      Bs[buf][idx / TN][idx % TN] = b_reg[i];
    }
  };

  if (nsteps > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int t = 0; t < nsteps; ++t) {
    const int buf = t & 1;
    if (t + 1 < nsteps) load(t + 1);
#pragma unroll
    for (int c = 0; c < TK; ++c) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][c][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][c][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][c][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][c][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (t + 1 < nsteps) store(buf ^ 1);
    __syncthreads();
  }

  float* __restrict__ oblk = out + (size_t)o * blk;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lr = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (lr >= Bb) continue;
    float* __restrict__ orow = oblk + (size_t)lr * Bb;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gc < Bb) orow[gc] = acc[i][j];
    }
  }
}

template <typename T>
void launch(const void* blocks_a, const void* blocks_b, const int* a_idx,
            const int* b_idx, const int* seg_ptr, float* out, int n_out,
            int Bb, cudaStream_t stream) {
  const int tiles = (Bb + TM - 1) / TM;
  // gridDim.y is capped at 65535: larger windows take several launches,
  // each over its own range of output blocks.
  for (int o0 = 0; o0 < n_out; o0 += kMaxGridY) {
    const int n = n_out - o0 < kMaxGridY ? n_out - o0 : kMaxGridY;
    const dim3 grid(tiles, n, tiles);
    block_spgemm_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(blocks_a), static_cast<const T*>(blocks_b),
        a_idx, b_idx, seg_ptr + o0, out + (size_t)o0 * Bb * Bb, Bb);
  }
}

}  // namespace

extern "C" {

// dtype 0: float32 blocks, 1: bfloat16 blocks (A and B alike).
// blocks_a (nbA, Bb, Bb), blocks_b (nbB, Bb, Bb); a_idx, b_idx (npairs)
// int32, the pairs sorted by output block; seg_ptr (n_out + 1) int32 into
// the pairs; out (n_out, Bb, Bb) float32.
int block_spgemm_window(int device, int dtype, const void* blocks_a,
                        const void* blocks_b, const void* a_idx,
                        const void* b_idx, const void* seg_ptr, void* out,
                        int n_out, int Bb, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_out <= 0 || Bb <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ai = static_cast<const int*>(a_idx);
  const int* bi = static_cast<const int*>(b_idx);
  const int* sp = static_cast<const int*>(seg_ptr);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    launch<float>(blocks_a, blocks_b, ai, bi, sp, o, n_out, Bb, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(blocks_a, blocks_b, ai, bi, sp, o, n_out, Bb, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
