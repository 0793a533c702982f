// Block-dense SpMM passes over a slot list of dense (B, B) blocks, and the
// gradient of the block store.
//
//   forward    out[r*B + i, k]  = sum over slots s of row-block r,
//                                 sum_c blocks[s, i, c] * xb[slot_col[s]*B + c, k]
//   transpose  out[cb*B + c, k] = sum over slots s of column-block cb,
//                                 sum_i blocks[s, i, c] * gb[slot_row[s]*B + i, k]
//   dblocks    out[s, i, c]     = sum_k P[slot_row[s]*B + i, k] * Q[slot_col[s]*B + c, k]
//                                 for s < nb, and out[nb] = 0
//
// The forward replaces the JAX package's block-dense route in
// pytorch_sparse_tpu/ops/kernels/hybrid.py: _block_pass (:553),
// _scan_block_pass (:518) and the forward equation "sbc,sck->sbk" of
// _mxu_einsum_impl (:594) with its bf16 splits (_split_bf16, :570).  The
// transpose (A_blocks^T @ g, the grad_mat pass of the hybrid route)
// replaces the block pass of hybrid_spmm_t (:763, :787-799), which is
// _scan_block_pass with the equation "sbc,sbk->sck" over the slot order
// order_t, and the d_vb contraction of _mxu_einsum_bwd (:696).  dblocks
// replaces the d_ab contraction of _mxu_einsum_bwd (:696, the equations
// of _GRAD_EQS, :671-676): the forward pass's gradient has P = grad_out
// and Q = x, the transpose pass's P = its input g and Q = grad_out.
// There, the slot list ran in chunks under one lax.scan, each chunk a
// batched MXU matmul followed by a segment-sum into the output blocks,
// with f32 products emulated by bf16 passes.
//
// What bounds it on an H100: operations.  A slot costs 2*B*B*K flops
// against B*B*elem bytes of block, so at B=512 and K=128 a block does 64
// (f32) or 128 (bf16) flops per byte read.  That is above the card's
// flops-per-byte balance on the FP32 units (67 TFLOP/s over 3.35 TB/s,
// about 20) and on f32-accurate tensor-core products (the 495 TFLOP/s of
// TF32 spent three times a product: 165 TFLOP/s over 3.35 TB/s, about 49).
//
// All three run on the tensor cores, on the template of csrc/block_tc.cuh
// (TF32 wgmma with the 3xTF32 split, TMA through a ring of stages, a fresh
// accumulator for each 32-wide step added into f32 sums).  The forward
// walks the slots of its row block in schedule order: the store's rows
// are K-major (c contiguous), loaded with the 128-byte swizzle, and xb's
// tile is loaded as it lies and transposed by the consumers.  The
// transpose walks order_t[cb_ptr[cb]..cb_ptr[cb+1]]: there the block
// enters transposed (blocks[s, i, c] read as c x i, c contiguous), which
// is MN-major and which TF32 wgmma does not take, so its [32 i][128 c]
// box is loaded as it lies, like gb's tile, and the consumers, who read
// each A tile anyway to write its small part, write both parts K-major
// (choice (a) of the two that take an MN-major block: it keeps the
// 3xTF32 arithmetic of the forward; the other, bf16 wgmma in six
// products, would move the same bytes through shared memory and lose
// the small parts of values near the bottom of f32's range).  dblocks
// walks K in steps of 32 with both operands K-major, its CTAs persistent
// (one an SM), so that the next tile's loads overlap this one's epilogue.
// A row or column block with no slot, and the trailing zero slot, write
// zeros; a bf16 store's gradient rounds the f32 sums once (to nearest
// even, as torch's cast does), so it equals the f32 store's sums rounded.
// A store whose rows are not 16 bytes (TMA's rule) comes with its rows
// padded (pitch Bp), the padding never read: the maps end at B columns.
//
// The interface is plain C, bound from Python with ctypes: pointers come
// in as void*, the launch goes on the caller's stream, and the return
// value is cudaGetLastError() after the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_tc.cuh"

namespace {

using block_tc::Sched;

int launch_dblocks_bn(int bn, bool bf16_out, const void* P, const void* Q,
                      const Sched& sc, void* out, int nb, int R, int C, int B,
                      int K, int device, cudaStream_t stream) {
  CUtensorMap ma, mb;
  const int K4 = block_tc::round_up(K, 4);
  if (!block_tc::encode(&ma, false, P, K4, B, R, K4, block_tc::kBK,
                        block_tc::kBM, 1, true) ||
      !block_tc::encode(&mb, false, Q, K4, B, C, K4, block_tc::kBK, bn, 1,
                        true))
    return (int)cudaErrorInvalidValue;
  if (bn == 64)
    return bf16_out
               ? block_tc::launch_tc<64, false, false, false, false>(
                     ma, mb, sc, static_cast<__nv_bfloat16*>(out), nb, nb + 1,
                     B, K4, device, stream)
               : block_tc::launch_tc<64, false, false, false, false>(
                     ma, mb, sc, static_cast<float*>(out), nb, nb + 1, B, K4,
                     device, stream);
  return bf16_out ? block_tc::launch_tc<128, false, false, false, false>(
                        ma, mb, sc, static_cast<__nv_bfloat16*>(out), nb,
                        nb + 1, B, K4, device, stream)
                  : block_tc::launch_tc<128, false, false, false, false>(
                        ma, mb, sc, static_cast<float*>(out), nb, nb + 1, B,
                        K4, device, stream);
}

}  // namespace

extern "C" {

// The forward pass.  blocks (nb+1, B, Bp): float32 (dtype 0, Bp = B
// rounded up to 4) or bfloat16 (dtype 1, Bp = B rounded up to 8), the
// columns past B never read; slot_col (nb) int32; rb_ptr (R+1) int32 over
// the row-block-sorted slots; xb (C*B, K4) float32 row-major, the operand
// padded to whole column blocks and to K4 = K rounded up to 4 columns;
// out (R*B, K) float32 row-major.  Every pointer 16-byte aligned.
int block_spmm(int device, int dtype, const void* blocks, const void* slot_col,
               const void* rb_ptr, const void* xb, void* out, int nb, int R,
               int C, int B, int K, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || K <= 0) return 0;
  if (nb <= 0 || C <= 0 || B <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Sched sc{static_cast<const int*>(rb_ptr), nullptr,
                 static_cast<const int*>(slot_col), 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int pitch = block_tc::store_pitch(B, dtype == 1);
  const int K4 = block_tc::round_up(K, 4);
  return dtype == 1
             ? block_tc::walk<false, true, false>(blocks, nb + 1, pitch, xb,
                                                  C, K4, sc, o, R, B, K,
                                                  device, s)
             : block_tc::walk<false, false, false>(blocks, nb + 1, pitch, xb,
                                                   C, K4, sc, o, R, B, K,
                                                   device, s);
}

// The transpose pass.  blocks (nb+1, B, Bp) as for the forward; slot_row
// (nb) int32; order_t (nb) int32, the slots stably sorted by column
// block; cb_ptr (C+1) int32 over slot_col[order_t]; gb (R*B, K4) float32
// row-major, padded as xb is; out (C*B, K) float32.  Every pointer
// 16-byte aligned.
int block_spmm_t(int device, int dtype, const void* blocks,
                 const void* slot_row, const void* order_t, const void* cb_ptr,
                 const void* gb, void* out, int nb, int R, int C, int B, int K,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C <= 0 || K <= 0) return 0;
  if (nb < 0 || R <= 0 || B <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Sched sc{static_cast<const int*>(cb_ptr),
                 static_cast<const int*>(order_t),
                 static_cast<const int*>(slot_row), 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int pitch = block_tc::store_pitch(B, dtype == 1);
  const int K4 = block_tc::round_up(K, 4);
  return dtype == 1
             ? block_tc::walk<true, true, false>(blocks, nb + 1, pitch, gb, R,
                                                 K4, sc, o, C, B, K, device, s)
             : block_tc::walk<true, false, false>(blocks, nb + 1, pitch, gb,
                                                  R, K4, sc, o, C, B, K,
                                                  device, s);
}

// The block-store gradient.  P (R*B, K4) and Q (C*B, K4) float32
// row-major, the operands padded to whole blocks and to K4 = K rounded up
// to 4 columns (the columns past K zero); slot_row, slot_col (nb) int32;
// out (nb+1, B, B) float32 (dtype 0) or bfloat16 (dtype 1).  Every pointer
// 16-byte aligned.
int block_spmm_dblocks(int device, int dtype, const void* P, const void* Q,
                       const void* slot_row, const void* slot_col, void* out,
                       int nb, int R, int C, int B, int K, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb <= 0 || R <= 0 || C <= 0 || B <= 0 || K <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Sched sc{nullptr, static_cast<const int*>(slot_row),
                 static_cast<const int*>(slot_col), 1};
  return launch_dblocks_bn(B <= 64 ? 64 : 128, dtype == 1, P, Q, sc, out, nb,
                           R, C, B, K, device,
                           static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
