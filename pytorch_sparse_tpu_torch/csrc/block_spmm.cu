// Block-dense SpMM passes over a slot list of dense (B, B) blocks.
//
//   forward    out[r*B + i, k]  = sum over slots s of row-block r,
//                                 sum_c blocks[s, i, c] * xb[slot_col[s]*B + c, k]
//   transpose  out[cb*B + c, k] = sum over slots s of column-block cb,
//                                 sum_i blocks[s, i, c] * gb[slot_row[s]*B + i, k]
//
// The forward replaces the JAX package's block-dense route in
// pytorch_sparse_tpu/ops/kernels/hybrid.py: _block_pass (:553),
// _scan_block_pass (:518) and the forward equation "sbc,sck->sbk" of
// _mxu_einsum_impl (:594) with its bf16 splits (_split_bf16, :570).  The
// transpose (A_blocks^T @ g, the grad_mat pass of the hybrid route)
// replaces the block pass of hybrid_spmm_t (:763, :787-799), which is
// _scan_block_pass with the equation "sbc,sbk->sck" over the slot order
// order_t, and the d_vb contraction of _mxu_einsum_bwd (:696).  There,
// the slot list ran in chunks under one lax.scan, each chunk a batched
// MXU matmul followed by a segment-sum into the output blocks, with f32
// products emulated by bf16 passes.
//
// What bounds it on an H100: operations.  A slot costs 2*B*B*K flops
// against B*B*elem bytes of block, so at B=512 and K=128 a block does
// 64 (f32) or 128 (bf16) flops per byte read, above the card's
// flops-per-byte balance for FP32 arithmetic outside the tensor cores
// (67 TFLOP/s over 3.35 TB/s, about 20).  This kernel uses those FP32
// units: it computes in full fp32, which equals JAX's HIGH (bf16x3)
// result to fp32 rounding.  wgmma and TMA are later work.
//
// Design: one thread block per (128-row tile of an output block, output
// block, 128-column tile of K).  The slots of one output block are a
// contiguous range of the schedule: [rb_ptr[r], rb_ptr[r+1]) of the
// row-block-sorted slot list in the forward, [cb_ptr[cb], cb_ptr[cb+1])
// of order_t (a stable sort of the slots by column block) in the
// transpose.  So each thread block owns its outputs outright: no
// atomics, and one fixed summation order (slots in schedule order, then
// the reduction index ascending).  The thread block walks its slots in
// steps of 8 reduction indices: each step stages a 128x8 tile of the
// dense block and an 8x128 tile of the operand in shared memory, and
// each of its 256 threads accumulates an 8x8 output tile in registers,
// reading 4 float4s from shared memory per 64 FMAs.  The block tile is
// kept as As[c][m] (reduction index c, output row m).  The forward reads
// it from block rows m (8 consecutive columns per row) and stores it
// transposed; the transpose pass reads As[c][m] = blk[(kk+c)*B + m0+m]
// along block rows, so its staging loads are coalesced too.  The next
// step's tiles are loaded into registers while this step computes, and
// stored into the other half of a double buffer.  bf16 blocks are
// widened with __bfloat162float as they are staged.  Tiles past B or K
// are masked with zeros.  Output blocks with no slot write zeros.  Block
// offsets are 64-bit.
//
// The third entry is the block-store gradient (the d_ab contraction of
// _mxu_einsum_bwd, :696, with the equations of _GRAD_EQS, :671-676):
//
//   dblocks  out[s, i, c] = sum_k P[slot_row[s]*B + i, k] * Q[slot_col[s]*B + c, k]
//
// for every slot s < nb, and out[nb] = 0 (the trailing zero block gets no
// gradient).  The forward pass's gradient has P = grad_out and Q = x; the
// transpose pass's has P = its input g and Q = grad_out.  It is bound by
// operations as the passes are (2*B*B*K flops a slot against B*B*elem
// bytes written).  Each slot owns its output block, so one thread block
// per (slot, 128-row tile, 128-column tile) walks K in steps of 8 with
// the same double-buffered 128x8 tiles and 8x8 register tiles as above:
// both tiles are read as rows of 8 consecutive k and stored transposed.
// The sum runs over k in ascending order in fp32 and is rounded to the
// store dtype once, at the end (__float2bfloat16 rounds to nearest even,
// as torch's cast does).  No atomics.

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
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// TRANSPOSE == false: the forward pass.  seg_ptr is rb_ptr, the slots of
// output block r are seg_ptr[r]..seg_ptr[r+1] themselves (order unused),
// src_blk is slot_col, and src is xb.
// TRANSPOSE == true: the transpose pass.  seg_ptr is cb_ptr, the slots
// of output block cb are order[seg_ptr[cb]..seg_ptr[cb+1]], src_blk is
// slot_row, src is gb, and each block enters transposed.
template <typename T, bool TRANSPOSE>
__global__ void __launch_bounds__(kThreads, 2)
block_spmm_kernel(const T* __restrict__ blocks, const int* __restrict__ order,
                  const int* __restrict__ src_blk,
                  const int* __restrict__ seg_ptr, const float* __restrict__ src,
                  float* __restrict__ out, int B, int K) {
  // As holds the block tile as As[c][row] (c the reduction index); the
  // +4 padding keeps the forward's transposed stores free of bank
  // conflicts and the float4 reads aligned.
  __shared__ __align__(16) float As[2][TK][TM + 4];
  __shared__ __align__(16) float Bs[2][TK][TN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4.. and 64+tx*4..
  const int ty = tid / 16;  // rows ty*4.. and 64+ty*4..
  const int m0 = blockIdx.x * TM;
  const int r = blockIdx.y;  // output block
  const int n0 = blockIdx.z * TN;
  const int s_begin = seg_ptr[r];
  const int steps_per_slot = (B + TK - 1) / TK;
  const int nsteps = (seg_ptr[r + 1] - s_begin) * steps_per_slot;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float a_reg[kLoads];
  float b_reg[kLoads];

  // Global -> registers for step t.
  auto load = [&](int t) {
    const int p = s_begin + t / steps_per_slot;
    const int s = TRANSPOSE ? order[p] : p;
    const int kk = (t % steps_per_slot) * TK;
    const T* __restrict__ blk = blocks + (int64_t)s * B * B;
    const float* __restrict__ xs = src + (int64_t)src_blk[s] * B * K;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads;
      // Output row m and reduction index c of this element of the tile:
      // the forward reads blk[m][c] along c, the transpose blk[c][m]
      // along m; either way neighbouring threads read neighbouring words.
      const int m = m0 + (TRANSPOSE ? idx % TM : idx / TK);
      const int c = kk + (TRANSPOSE ? idx / TM : idx % TK);
      const int64_t off = TRANSPOSE ? (int64_t)c * B + m : (int64_t)m * B + c;
      a_reg[i] = (m < B && c < B) ? to_float(blk[off]) : 0.f;
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
      if (TRANSPOSE) {
        As[buf][idx / TM][idx % TM] = a_reg[i];
      } else {
        As[buf][idx % TK][idx / TK] = a_reg[i];
      }
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

// out[s] = P[slot_row[s]] . Q[slot_col[s]]^T for s < nb; out[nb] = 0.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
block_dblocks_kernel(const float* __restrict__ P, const float* __restrict__ Q,
                     const int* __restrict__ slot_row,
                     const int* __restrict__ slot_col, T* __restrict__ out,
                     int nb, int B, int K) {
  // Both tiles as [k][row]; the +4 padding keeps the transposed stores
  // free of bank conflicts and the float4 reads aligned.
  __shared__ __align__(16) float As[2][TK][TM + 4];
  __shared__ __align__(16) float Bs[2][TK][TN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns tx*4.. and 64+tx*4..
  const int ty = tid / 16;  // rows ty*4.. and 64+ty*4..
  const int s = blockIdx.x;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.z * TN;
  // The zero slot has no operands: its steps are none and it writes 0.
  const int nsteps = s < nb ? (K + TK - 1) / TK : 0;
  const float* __restrict__ p =
      s < nb ? P + (int64_t)slot_row[s] * B * K : P;
  const float* __restrict__ q =
      s < nb ? Q + (int64_t)slot_col[s] * B * K : Q;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float a_reg[kLoads];
  float b_reg[kLoads];

  // Global -> registers for step t: row (m0|n0) + idx / TK, k kk + idx % TK.
  auto load = [&](int t) {
    const int kk = t * TK;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / TK;
      const int k = kk + idx % TK;
      const bool k_ok = k < K;
      a_reg[i] = (k_ok && m0 + r < B) ? p[(int64_t)(m0 + r) * K + k] : 0.f;
      b_reg[i] = (k_ok && n0 + r < B) ? q[(int64_t)(n0 + r) * K + k] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads;
      As[buf][idx % TK][idx / TK] = a_reg[i];
      Bs[buf][idx % TK][idx / TK] = b_reg[i];
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
    T* __restrict__ orow = out + ((int64_t)s * B + lr) * B;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gc < B) orow[gc] = from_float<T>(acc[i][j]);
    }
  }
}

template <bool TRANSPOSE>
int launch(int device, int dtype, const void* blocks, const int* order,
           const int* src_blk, const int* seg_ptr, const void* src, void* out,
           int nseg, int B, int K, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nseg <= 0 || B <= 0 || K <= 0) return 0;
  dim3 grid((B + TM - 1) / TM, nseg, (K + TN - 1) / TN);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(src);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    block_spmm_kernel<float, TRANSPOSE><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(blocks), order, src_blk, seg_ptr, x, o, B, K);
  } else if (dtype == 1) {
    block_spmm_kernel<__nv_bfloat16, TRANSPOSE><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(blocks), order, src_blk, seg_ptr, x,
        o, B, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// blocks (nb+1, B, B) float32 (dtype 0) or bfloat16 (dtype 1); slot_col
// (nb) int32; rb_ptr (R+1) int32 over the row-block-sorted slots; xb
// (C*B, K) float32 row-major; out (R*B, K) float32 row-major.
int block_spmm(int device, int dtype, const void* blocks, const void* slot_col,
               const void* rb_ptr, const void* xb, void* out, int R, int B,
               int K, void* stream) {
  return launch<false>(device, dtype, blocks, nullptr,
                       static_cast<const int*>(slot_col),
                       static_cast<const int*>(rb_ptr), xb, out, R, B, K,
                       stream);
}

// The transpose pass.  blocks as above; slot_row (nb) int32; order_t (nb)
// int32, the slots stably sorted by column block; cb_ptr (C+1) int32 over
// slot_col[order_t]; gb (R*B, K) float32 row-major; out (C*B, K) float32.
int block_spmm_t(int device, int dtype, const void* blocks,
                 const void* slot_row, const void* order_t, const void* cb_ptr,
                 const void* gb, void* out, int C, int B, int K,
                 void* stream) {
  return launch<true>(device, dtype, blocks,
                      static_cast<const int*>(order_t),
                      static_cast<const int*>(slot_row),
                      static_cast<const int*>(cb_ptr), gb, out, C, B, K,
                      stream);
}

// The block-store gradient.  P (R*B, K) and Q (C*B, K) float32
// row-major, the operands padded to whole blocks; slot_row, slot_col
// (nb) int32; out (nb+1, B, B) float32 (dtype 0) or bfloat16 (dtype 1).
int block_spmm_dblocks(int device, int dtype, const void* P, const void* Q,
                       const void* slot_row, const void* slot_col, void* out,
                       int nb, int B, int K, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb < 0 || B <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  dim3 grid(nb + 1, (B + TM - 1) / TM, (B + TN - 1) / TN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(P);
  const float* q = static_cast<const float*>(Q);
  const int* sr = static_cast<const int*>(slot_row);
  const int* sc = static_cast<const int*>(slot_col);
  if (dtype == 0) {
    block_dblocks_kernel<float><<<grid, kThreads, 0, s>>>(
        p, q, sr, sc, static_cast<float*>(out), nb, B, K);
  } else if (dtype == 1) {
    block_dblocks_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        p, q, sr, sc, static_cast<__nv_bfloat16*>(out), nb, B, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
