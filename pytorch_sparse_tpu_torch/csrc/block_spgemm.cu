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
// against 2*Bb^2 elements read, 512 flops per f32 element at Bb = 512, far
// above the card's flops-per-byte balance both on the FP32 units (67
// TFLOP/s over 3.35 TB/s, about 20) and for f32-accurate tensor-core
// products (3xTF32: 165 TFLOP/s over 3.35 TB/s, about 49).
//
// Design: the segment walk of the tensor-core template in
// csrc/block_tc.cuh (TF32 wgmma, TMA through a ring of stages, one
// producer warp and two consumer warpgroups), the forward block pass of
// csrc/block_spmm.cu with the pairs in the place of the slots and a block
// of B in the place of the operand's column block.  A CTA owns a 128 x 128
// tile of one output block and walks that block's pairs in plan order,
// each in steps of 32 reduction indices c: A's block rows are K-major (c
// contiguous) and arrive with the 128-byte swizzle; B's [32 c][128 n]
// tile arrives as it lies and the consumers transpose it into the K-major
// tile.  Each step runs into a fresh accumulator that is added into the
// tile's sums on the FP32 units (the tensor core's own adds truncate, and
// a pair list is a long reduction: 16 steps a pair at Bb = 512).  The CTA
// writes its tile once at the end: no atomics, no segment-sum, and one
// fixed summation order (pairs in plan order, then c ascending), so the
// result is deterministic.  An output block with no pair writes zeros.
// f32 stores take the 3xTF32 split (three products a step).  bf16 stores
// are exact in TF32, so the consumers widen both tiles as they lay them
// out and one TF32 product a step is exact; TF32 rather than bf16 wgmma
// keeps one template for both stores (bf16 wgmma would take the MN-major
// B block as it lies, but needs its own descriptors and tiles).  Blocks
// are addressed by TMA with a block coordinate, so windows past 2 GB (a
// 2,048-block window of 512^2 f32) need no 32-bit offset; the epilogue's
// offsets are 64-bit.  Block rows must be 16 bytes (TMA's rule): a store
// whose rows are not comes with its rows padded to pitch Bbp, the
// padding never read.
//
// The interface is plain C, bound from Python with ctypes: pointers come
// in as void*, the launch goes on the caller's stream, and the return
// value is cudaGetLastError() after the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_tc.cuh"

extern "C" {

// dtype 0: float32 blocks, 1: bfloat16 blocks (A and B alike).
// blocks_a (nbA, Bb, Bbp), blocks_b (nbB, Bb, Bbp) with Bbp = Bb rounded up
// to 16 bytes; a_idx, b_idx (npairs) int32, the pairs sorted by output
// block; seg_ptr (n_out + 1) int32 into the pairs; out (n_out, Bb, Bb)
// float32.  The block stores 16-byte aligned.
int block_spgemm_window(int device, int dtype, const void* blocks_a,
                        const void* blocks_b, const void* a_idx,
                        const void* b_idx, const void* seg_ptr, void* out,
                        int nbA, int nbB, int n_out, int Bb, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_out <= 0 || Bb <= 0) return 0;
  if (nbA <= 0 || nbB <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const block_tc::Sched sc{static_cast<const int*>(seg_ptr),
                           static_cast<const int*>(a_idx),
                           static_cast<const int*>(b_idx), 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int pitch = block_tc::store_pitch(Bb, dtype == 1);
  return dtype == 1
             ? block_tc::walk<false, true, true>(blocks_a, nbA, pitch,
                                                 blocks_b, nbB, pitch, sc, o,
                                                 n_out, Bb, Bb, device, s)
             : block_tc::walk<false, false, false>(blocks_a, nbA, pitch,
                                                   blocks_b, nbB, pitch, sc,
                                                   o, n_out, Bb, Bb, device,
                                                   s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
