// Block-dense SpMM pass: out[r*B + i, k] = sum over slots s of row-block r,
//                        sum_c blocks[s, i, c] * xb[slot_col[s]*B + c, k]
//
// Replaces the JAX package's block-dense route in
// pytorch_sparse_tpu/ops/kernels/hybrid.py: _block_pass (:553),
// _scan_block_pass (:518) and the forward equation "sbc,sck->sbk" of
// _mxu_einsum_impl (:594) with its bf16 splits (_split_bf16, :570).
// There, the slot list ran in chunks under one lax.scan, each chunk a
// batched MXU matmul followed by a segment-sum into the row blocks, with
// f32 products emulated by three bf16 passes.
//
// What bounds it on an H100: operations.  A slot costs 2*B*B*K flops
// against B*B*elem bytes of block, so at B=512 and K=128 a block does
// 64 (f32) or 128 (bf16) flops per byte read, above the card's
// flops-per-byte balance for FP32 arithmetic outside the tensor cores
// (67 TFLOP/s over 3.35 TB/s, about 20).  This kernel uses those FP32
// units: it computes in full fp32, which equals JAX's HIGH (bf16x3)
// result to fp32 rounding.  wgmma and TMA are later work.
//
// Design: one thread block per (128-row tile of a row-block, row-block,
// 128-column tile of K).  Slots are sorted by row-block, so a row-block's
// slots are the contiguous range [rb_ptr[r], rb_ptr[r+1]) and each thread
// block owns its outputs outright: no atomics, and one fixed summation
// order (slots in slot order, then columns c ascending).  The thread
// block walks its slots in steps of 8 columns c: each step stages a
// 128x8 tile of the dense block (transposed) and an 8x128 tile of x in
// shared memory, and each of its 256 threads accumulates an 8x8 output
// tile in registers, reading 4 float4s from shared memory per 64 FMAs.
// The next step's tiles are loaded into registers while this step
// computes, and stored into the other half of a double buffer.  bf16
// blocks are widened with __bfloat162float as they are staged.  Tiles
// past B or K are masked with zeros.  Row-blocks with no slot write
// zeros.  Block offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;  // output rows per thread block
constexpr int TN = 128;  // output columns per thread block
constexpr int TK = 8;    // reduction step
constexpr int kThreads = 256;
constexpr int kLoads = TM * TK / kThreads;  // elements per thread per tile
static_assert(TM == TN, "the block tile and the x tile load alike");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
block_spmm_kernel(const T* __restrict__ blocks, const int* __restrict__ slot_col,
                  const int* __restrict__ rb_ptr, const float* __restrict__ xb,
                  float* __restrict__ out, int B, int K) {
  // As holds the block tile transposed (As[c][row]); the +4 padding
  // keeps the transposed stores free of bank conflicts and the float4
  // reads aligned.
  __shared__ __align__(16) float As[2][TK][TM + 4];
  __shared__ __align__(16) float Bs[2][TK][TN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4.. and 64+tx*4..
  const int ty = tid / 16;  // rows ty*4.. and 64+ty*4..
  const int m0 = blockIdx.x * TM;
  const int r = blockIdx.y;
  const int n0 = blockIdx.z * TN;
  const int s_begin = rb_ptr[r];
  const int steps_per_slot = (B + TK - 1) / TK;
  const int nsteps = (rb_ptr[r + 1] - s_begin) * steps_per_slot;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float a_reg[kLoads];
  float b_reg[kLoads];

  // Global -> registers for step t.
  auto load = [&](int t) {
    const int s = s_begin + t / steps_per_slot;
    const int kk = (t % steps_per_slot) * TK;
    const T* __restrict__ blk = blocks + (int64_t)s * B * B;
    const float* __restrict__ xs = xb + (int64_t)slot_col[s] * B * K;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads;
      const int gr = m0 + idx / TK;
      const int gc = kk + idx % TK;
      a_reg[i] = (gr < B && gc < B) ? to_float(blk[(int64_t)gr * B + gc])
                                    : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads;
      const int gr = kk + idx / TN;
      const int gc = n0 + idx % TN;
      b_reg[i] = (gr < B && gc < K) ? xs[(int64_t)gr * K + gc] : 0.f;
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

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lr = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (lr >= B) continue;
    float* __restrict__ orow = out + ((int64_t)r * B + lr) * K;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gc < K) orow[gc] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// blocks (nb+1, B, B) float32 (dtype 0) or bfloat16 (dtype 1); slot_col
// (nb) int32; rb_ptr (R+1) int32 over the row-block-sorted slots; xb
// (C*B, K) float32 row-major; out (R*B, K) float32 row-major.
int block_spmm(int device, int dtype, const void* blocks, const void* slot_col,
               const void* rb_ptr, const void* xb, void* out, int R, int B,
               int K, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || B <= 0 || K <= 0) return 0;
  dim3 grid((B + TM - 1) / TM, R, (K + TN - 1) / TN);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sc = static_cast<const int*>(slot_col);
  const int* rp = static_cast<const int*>(rb_ptr);
  const float* x = static_cast<const float*>(xb);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    block_spmm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(blocks), sc, rp, x, o, B, K);
  } else if (dtype == 1) {
    block_spmm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(blocks), sc, rp, x, o, B, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
