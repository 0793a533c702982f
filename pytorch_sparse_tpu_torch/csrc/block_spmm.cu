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
// The forward and dblocks (tc_kernel) run on the tensor cores: wgmma in
// TF32, with the 3xTF32 split for f32 accuracy.  The tensor core reads an
// f32 word as TF32 by dropping its low 13 mantissa bits, so each f32
// operand a is big + small with big = a & 0xffffe000 (the word itself, as
// the tensor core reads it) and small = a - big, exact in f32 and written
// beside it.  Each product is a_small*b_big + a_big*b_small + a_big*b_big;
// the dropped small*small term is within 2^-20 of |a*b| and the TF32
// reading of small within 2^-21.  bf16 blocks are exact in TF32, so their
// products are blk*x_small + blk*x_big.  The tensor core adds into its f32
// accumulator with truncation, an error that grows with the number of
// adds, so each 32-wide reduction step runs into a fresh accumulator that
// is then added into the tile's sums on the FP32 units, rounding to
// nearest.
//
// One CTA owns a 128-row by BN-column output tile at a time (BN = 64 or
// 128 by the output width): two consumer warpgroups of 64 rows each and
// one producer warp.  The producer issues two TMA loads per step into a
// ring of shared-memory stages (three or four, up to 200 KB of dynamic
// shared memory), each guarded by a full and an empty mbarrier: a 128x32
// tile of the A operand and a tile of the B operand.  A (the block store's
// rows, or P) is K-major (the reduction index contiguous), loaded with the
// 128-byte swizzle that the wgmma descriptors name.  TF32 wgmma takes only
// K-major operands: dblocks' Q is K-major as it lies, but the forward's
// operand xb has k contiguous, so its 32 x (BN+4) tile is loaded as it
// lies and the consumers transpose it into the K-major B tile.  When a
// stage lands, the consumers write its small parts (and the widened bf16
// blocks, or the transposed operand), sync on a named barrier, and issue
// the stage's wgmmas; they prepare the next stage while those run, then
// wait for them, add them into the sums and release the stage.  The
// forward walks the slots of its row block in schedule order and each
// slot's reduction index in steps of 32; dblocks walks K in steps of 32.
// So each tile is owned by one CTA (no atomics) and its sum order is
// fixed.  A row block with no slot, and the trailing zero slot, write
// zeros.  TMA fills the parts of a box outside the tensor with zeros: rows
// past B, columns past the (padded) block width or K.  The epilogue writes
// the sums straight from registers, masked to B rows and the output
// width; a bf16 store rounds the f32 sums once (to nearest even, as
// torch's cast does), so it equals the f32 store's sums rounded.  dblocks'
// CTAs are persistent (one an SM, each walking tiles), so that the next
// tile's loads overlap this one's epilogue.
//
// The transpose pass (block_spmm_t_kernel) still runs on the FP32 units:
// its block enters transposed, which is MN-major, and TF32 wgmma takes
// only K-major operands.  One thread block per (128-row tile of an output
// block, output block, 128-column tile of K) walks the slots
// order_t[cb_ptr[cb]..cb_ptr[cb+1]] in steps of 8 reduction indices: each
// step stages a 128x8 tile of the block (read along block rows, as
// As[c][m] = blk[(kk+c)*B + m0+m]) and an 8x128 tile of the operand in
// shared memory, and each of its 256 threads accumulates an 8x8 output
// tile in registers, reading 4 float4s from shared memory per 64 FMAs.
// The next step's tiles are loaded into registers while this step
// computes, and stored into the other half of a double buffer.  bf16
// blocks are widened with __bfloat162float as they are staged.  Tiles
// past B or K are masked with zeros.  Output blocks with no slot write
// zeros.  Block offsets are 64-bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// ---- the transpose pass on the FP32 units --------------------------------

constexpr int TM = 128;  // output rows per thread block
constexpr int TN = 128;  // output columns per thread block
constexpr int TK = 8;    // reduction step
constexpr int kThreads = 256;
constexpr int kLoads = TM * TK / kThreads;  // elements per thread per tile
static_assert(TM == TN, "the block tile and the operand tile load alike");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// seg_ptr is cb_ptr: the slots of output block cb are
// order[seg_ptr[cb]..seg_ptr[cb+1]]; src_blk is slot_row and src is gb.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
block_spmm_t_kernel(const T* __restrict__ blocks, const int* __restrict__ order,
                    const int* __restrict__ src_blk,
                    const int* __restrict__ seg_ptr,
                    const float* __restrict__ src, float* __restrict__ out,
                    int B, int K) {
  // As holds the block tile as As[c][row] (c the reduction index); the
  // +4 padding keeps the float4 reads aligned.
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
    const int s = order[s_begin + t / steps_per_slot];
    const int kk = (t % steps_per_slot) * TK;
    const T* __restrict__ blk = blocks + (int64_t)s * B * B;
    const float* __restrict__ xs = src + (int64_t)src_blk[s] * B * K;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads;
      // Output row m and reduction index c of this element of the tile,
      // read as blk[c][m] along m: neighbouring threads read neighbouring
      // words.
      const int m = m0 + idx % TM;
      const int c = kk + idx / TM;
      a_reg[i] = (m < B && c < B) ? to_float(blk[(int64_t)c * B + m]) : 0.f;
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
      As[buf][idx / TM][idx % TM] = a_reg[i];
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

// ---- the forward and dblocks on the tensor cores -------------------------

constexpr int kBM = 128;  // output rows of a CTA: two warpgroups of 64
constexpr int kBK = 32;   // reduction step: 32 f32, one 128-byte swizzle row
constexpr int kConsumers = 256;
constexpr int kTcThreads = kConsumers + 32;  // + the producer warp
constexpr int kATile = kBM * kBK * 4;        // 16 KB
constexpr int kSmemBudget = 200 * 1024;

template <int BN, bool FWD>
struct Tile {
  static constexpr int kBTile = BN * kBK * 4;
  // The forward's operand arrives as it lies, [32 c][BN + 4 k]: the four
  // extra columns put consecutive rows on different banks.  B's small
  // part is written over it once it has been read.
  static constexpr int kXWidth = BN + 4;
  static constexpr int kXBytes = FWD ? kBK * kXWidth * 4 : 0;
  static constexpr int kBSmall =
      FWD ? (kXBytes + 1023) / 1024 * 1024 : kBTile;
  // A, A's small part (or bf16 staging), B, B's small part (or staging).
  static constexpr int kStage = 2 * kATile + kBTile + kBSmall;
  static constexpr int kStages =
      kSmemBudget / kStage < 4 ? kSmemBudget / kStage : 4;
  static constexpr int kSmem = kStages * kStage + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A wait of more than ~10 s (a transfer that never lands) traps, so that
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000LL) {
      __trap();
    }
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The two consumer warpgroups, without the producer warp.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// Shared-memory writes of this thread become visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator accesses across a wgmma.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows with the 128-byte
// swizzle: start address, leading offset 1 (unused for this layout), 1024
// bytes between groups of 8 rows, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// D(64 x N, f32) += A(64 x 8, tf32) * B(8 x N, tf32), both from shared
// memory through descriptors, both K-major.
template <int N>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

// The part of v below TF32 precision: v minus v with its low 13 mantissa
// bits cleared (what the tensor core reads from the word), exact in f32.
// Inf and NaN keep all of themselves in the big part.
__device__ __forceinline__ float tf32_small(float v) {
  const uint32_t u = __float_as_uint(v);
  if ((u & 0x7f800000u) == 0x7f800000u) return 0.f;
  return v - __uint_as_float(u & 0xffffe000u);
}

// small = the small parts of the N4 float4s at `tile` (same layout).
template <int N4>
__device__ __forceinline__ void split_tile(const uint8_t* tile,
                                           uint8_t* small, int tid) {
  static_assert(N4 % kConsumers == 0, "whole float4s a thread");
#pragma unroll
  for (int i = 0; i < N4 / kConsumers; ++i) {
    const int u = tid + i * kConsumers;
    const float4 v = reinterpret_cast<const float4*>(tile)[u];
    reinterpret_cast<float4*>(small)[u] =
        make_float4(tf32_small(v.x), tf32_small(v.y), tf32_small(v.z),
                    tf32_small(v.w));
  }
}

// After a stage lands: the small parts of an f32 A, or the widening of
// a bf16 A (a [128][32] bf16 tile, unswizzled, in A's small slot) into the
// swizzled f32 A tile; and the split of B.  dblocks' B tile arrives
// K-major and only its small parts are written.  The forward's operand tile arrives as
// [32 c][BN + 4 k] (k contiguous) in B's small slot; the consumers read it
// into registers, sync, and write it split into the K-major [BN k][32 c]
// tiles.  Lane l takes c = l, so its reads step by a row (one bank group
// apart) and its writes fill one 128-byte row of 32 c.
template <int BN, bool FWD, bool A_BF16>
__device__ __forceinline__ void prepare(uint8_t* stage, int tid) {
  using Cfg = Tile<BN, FWD>;
  if constexpr (A_BF16) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / 4 / kConsumers; ++i) {
      const int u = tid + i * kConsumers;  // 16-byte chunk j of f32 row r
      const int r = u >> 3, j = u & 7;
      const uint2 v =
          *reinterpret_cast<const uint2*>(stage + kATile + r * 64 + j * 8);
      *reinterpret_cast<float4*>(stage + r * 128 + ((j ^ (r & 7)) << 4)) =
          make_float4(__uint_as_float(v.x << 16),
                      __uint_as_float(v.x & 0xffff0000u),
                      __uint_as_float(v.y << 16),
                      __uint_as_float(v.y & 0xffff0000u));
    }
  } else {
    split_tile<kATile / 16>(stage, stage + kATile, tid);
  }
  uint8_t* b_big = stage + 2 * kATile;
  uint8_t* b_small = b_big + Cfg::kBTile;
  if constexpr (FWD) {
    constexpr int kChunks = BN / 32;  // BN/4 chunks of 4 k over 8 warps
    const int lane = tid & 31, warp = tid >> 5;
    float4 v[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u)
      v[u] = *reinterpret_cast<const float4*>(
          b_small + (lane * Cfg::kXWidth + 4 * (warp + 8 * u)) * 4);
    consumer_sync();  // every read of the staged tile is done
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int k0 = 4 * (warp + 8 * u);
      const float vals[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + e;
        const int off =
            k * 128 + (((lane >> 2) ^ (k & 7)) << 4) + (lane & 3) * 4;
        *reinterpret_cast<float*>(b_big + off) = vals[e];
        *reinterpret_cast<float*>(b_small + off) = tf32_small(vals[e]);
      }
    }
  } else {
    split_tile<Cfg::kBTile / 16>(b_big, b_small, tid);
  }
}

__device__ __forceinline__ void store_pair(float* p, int col, int ncols,
                                           bool vec, float v0, float v1) {
  if (vec && col + 1 < ncols) {
    *reinterpret_cast<float2*>(p + col) = make_float2(v0, v1);
    return;
  }
  if (col < ncols) p[col] = v0;
  if (col + 1 < ncols) p[col + 1] = v1;
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, int col,
                                           int ncols, bool vec, float v0,
                                           float v1) {
  if (vec && col + 1 < ncols) {
    *reinterpret_cast<__nv_bfloat162*>(p + col) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  if (col < ncols) p[col] = __float2bfloat16_rn(v0);
  if (col + 1 < ncols) p[col + 1] = __float2bfloat16_rn(v1);
}

// The output tiles: (column tile, row tile, segment), the column tile
// fastest.  FWD: the forward pass; a segment is a row block r, idx_a =
// rb_ptr, idx_b = slot_col; map_a over the store as (Bp, B, nb+1), map_b
// over the operand xb as (K4, B, C); out (R*B, K) f32.  !FWD: dblocks; a
// segment is a slot s < nb+1, idx_a = slot_row, idx_b = slot_col; map_a
// over P as (K4, B, R), map_b over Q as (K4, B, C); out (nb+1, B, B) in
// TO; K is the padded K4.  Each CTA takes the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...: the ring's stages and phases run on from
// one tile to the next, so the producer loads the next tile's steps while
// the consumers write this one.
// The tensor core adds into its f32 accumulator with truncation, so each
// stage's products go to a fresh wgmma accumulator, which is then added
// into the tile's sums with f32 adds that round to nearest.
template <int BN, bool FWD, bool A_BF16, typename TO>
__global__ void __launch_bounds__(kTcThreads, 1)
tc_kernel(const __grid_constant__ CUtensorMap map_a,
          const __grid_constant__ CUtensorMap map_b,
          const int* __restrict__ idx_a, const int* __restrict__ idx_b,
          TO* __restrict__ out, int nb, int ntiles_total, int B, int K) {
  using Cfg = Tile<BN, FWD>;
  constexpr int S = Cfg::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S];
  __shared__ __align__(8) uint64_t empty[S];
  // The 128-byte swizzle repeats every 1024 bytes: align the ring to it.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int ntiles = ((FWD ? K : B) + BN - 1) / BN;
  const int mtiles = (B + kBM - 1) / kBM;
  const int csteps = FWD ? (B + kBK - 1) / kBK : 1;
  // Tile `tile`: its segment, first row and column, first slot (FWD) and
  // number of steps.
  auto tile_of = [&](int tile, int& seg, int& i0, int& n0, int& s0,
                     int& nsteps) {
    n0 = tile % ntiles * BN;
    i0 = tile / ntiles % mtiles * kBM;
    seg = tile / (ntiles * mtiles);
    if constexpr (FWD) {
      s0 = idx_a[seg];
      nsteps = (idx_a[seg + 1] - s0) * csteps;
    } else {
      s0 = 0;
      nsteps = seg < nb ? (K + kBK - 1) / kBK : 0;
    }
  };

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp; one lane issues the loads
    if (tid == kConsumers) {
      uint32_t g = 0;  // steps so far, over all of this CTA's tiles
      for (int tile = blockIdx.x; tile < ntiles_total; tile += gridDim.x) {
        int seg, i0, n0, s0, nsteps;
        tile_of(tile, seg, i0, n0, s0, nsteps);
        for (int t = 0; t < nsteps; ++t, ++g) {
          const int st = g % S;
          mbar_wait(&empty[st], ((g / S) & 1) ^ 1);
          uint8_t* stage = smem + st * Cfg::kStage;
          if constexpr (FWD) {
            mbar_expect_tx(&full[st],
                           (A_BF16 ? kATile / 2 : kATile) + Cfg::kXBytes);
            const int s = s0 + t / csteps, c0 = (t % csteps) * kBK;
            tma_load_3d(A_BF16 ? stage + kATile : stage, &map_a, &full[st],
                        c0, i0, s);
            tma_load_3d(stage + 2 * kATile + Cfg::kBTile, &map_b, &full[st],
                        n0, c0, idx_b[s]);
          } else {
            mbar_expect_tx(&full[st], kATile + Cfg::kBTile);
            const int k0 = t * kBK;
            tma_load_3d(stage, &map_a, &full[st], k0, i0, idx_a[seg]);
            tma_load_3d(stage + 2 * kATile, &map_b, &full[st], k0, n0,
                        idx_b[seg]);
          }
        }
      }
    }
    return;
  }

  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int ld = FWD ? K : B;
  const bool vec = (ld & 1) == 0;
  uint32_t g = 0;
  for (int tile = blockIdx.x; tile < ntiles_total; tile += gridDim.x) {
    int seg, i0, n0, s0, nsteps;
    tile_of(tile, seg, i0, n0, s0, nsteps);
    float acc[BN / 2], sum[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;
    if (nsteps > 0) {
      mbar_wait(&full[g % S], (g / S) & 1);
      prepare<BN, FWD, A_BF16>(smem + g % S * Cfg::kStage, tid);
      fence_proxy_async();
      consumer_sync();
      for (int t = 0; t < nsteps; ++t, ++g) {
        const int st = g % S;
        const uint8_t* stage = smem + st * Cfg::kStage;
        const uint64_t da0 = sw128_desc(stage + wg * (kATile / 2));
        const uint64_t da1 = sw128_desc(stage + kATile + wg * (kATile / 2));
        const uint64_t db0 = sw128_desc(stage + 2 * kATile);
        const uint64_t db1 = sw128_desc(stage + 2 * kATile + Cfg::kBTile);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk) {
          const uint64_t o = 2 * kk;  // 8 f32 = 32 bytes, in 16-byte units
          // The stage's first product overwrites the accumulator.
          if constexpr (!A_BF16) Mma<BN>::run(acc, da1 + o, db0 + o, kk > 0);
          Mma<BN>::run(acc, da0 + o, db1 + o, A_BF16 ? kk > 0 : 1);
          Mma<BN>::run(acc, da0 + o, db0 + o, 1);
        }
        wgmma_commit();
        const bool more = t + 1 < nsteps;
        if (more) {  // prepare the next stage while the tensor cores run
          const int st1 = (g + 1) % S;
          mbar_wait(&full[st1], ((g + 1) / S) & 1);
          prepare<BN, FWD, A_BF16>(smem + st1 * Cfg::kStage, tid);
          fence_proxy_async();
        }
        wgmma_wait0();
        fence_acc(acc);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
        mbar_arrive(&empty[st]);
        if (more) consumer_sync();
      }
    }

    // Sum j of a thread: row 16*warp + lane/4 (+8 for odd j/2), column
    // 8*(j/4) + 2*(lane%4) + j%2 of its warpgroup's 64 x BN tile.
    const int row0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    const int col0 = n0 + 2 * (lane & 3);
    const int nrows = B - i0;
    TO* obase = out + ((int64_t)seg * B + i0) * ld;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < nrows)
          store_pair(obase + (int64_t)row * ld, col0 + 8 * j, ld, vec,
                     sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ---- host side -----------------------------------------------------------

// cuTensorMapEncodeTiled is a driver function; the library links only the
// runtime, so it is fetched through the runtime's driver entry point.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D tiled map over a dense (d2, d1, d0) array, d0 contiguous, with a
// (b2, b1, b0) box; parts of a box outside the array read as zeros.
bool encode(CUtensorMap* map, bool bf16, const void* base, uint64_t d0,
            uint64_t d1, uint64_t d2, uint32_t b0, uint32_t b1, uint32_t b2,
            bool swizzle) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const uint64_t elem = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * elem, d0 * d1 * elem};
  const cuuint32_t box[3] = {b0, b1, b2};
  const cuuint32_t estride[3] = {1, 1, 1};
  return fn(map,
            bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            3, const_cast<void*>(base), dims, strides, box, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int round_up(int a, int m) { return (a + m - 1) / m * m; }

int sm_count(int device) {
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return n > 0 ? n : 1;
}

// The forward's tiles differ in length (the slots of a row block), so it
// launches one CTA a tile and leaves the balance to the hardware; dblocks'
// tiles are all alike, so it launches one CTA an SM.
template <int BN, bool FWD, bool A_BF16, typename TO>
int launch_tc(const CUtensorMap& ma, const CUtensorMap& mb, const int* idx_a,
              const int* idx_b, TO* out, int nb, int nseg, int B, int K,
              int device, cudaStream_t stream) {
  auto kernel = tc_kernel<BN, FWD, A_BF16, TO>;
  constexpr int smem = Tile<BN, FWD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (int64_t)nseg * ((B + kBM - 1) / kBM) *
                        (((FWD ? K : B) + BN - 1) / BN);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int64_t grid = FWD ? tiles : std::min<int64_t>(tiles, sm_count(device));
  kernel<<<(unsigned)grid, kTcThreads, smem, stream>>>(
      ma, mb, idx_a, idx_b, out, nb, (int)tiles, B, K);
  return (int)cudaGetLastError();
}

template <int BN, bool BF16>
int launch_fwd(const void* blocks, const int* slot_col, const int* rb_ptr,
               const void* xb, float* out, int nb, int R, int C, int B, int K,
               int device, cudaStream_t stream) {
  CUtensorMap ma, mb;
  if (!encode(&ma, BF16, blocks, round_up(B, BF16 ? 8 : 4), B, nb + 1, kBK,
              kBM, 1, !BF16) ||
      !encode(&mb, false, xb, round_up(K, 4), B, C,
              Tile<BN, true>::kXWidth, kBK, 1, false))
    return (int)cudaErrorInvalidValue;
  return launch_tc<BN, true, BF16, float>(ma, mb, rb_ptr, slot_col, out, nb,
                                          R, B, K, device, stream);
}

template <int BN, typename TO>
int launch_dblocks(const void* P, const void* Q, const int* slot_row,
                   const int* slot_col, TO* out, int nb, int R, int C, int B,
                   int K, int device, cudaStream_t stream) {
  CUtensorMap ma, mb;
  const int K4 = round_up(K, 4);
  if (!encode(&ma, false, P, K4, B, R, kBK, kBM, 1, true) ||
      !encode(&mb, false, Q, K4, B, C, kBK, BN, 1, true))
    return (int)cudaErrorInvalidValue;
  return launch_tc<BN, false, false, TO>(ma, mb, slot_row, slot_col, out, nb,
                                         nb + 1, B, K4, device, stream);
}

template <typename TO>
int dblocks_width(const void* P, const void* Q, const int* slot_row,
                  const int* slot_col, void* out, int nb, int R, int C, int B,
                  int K, int device, cudaStream_t stream) {
  TO* o = static_cast<TO*>(out);
  if (B <= 64)
    return launch_dblocks<64, TO>(P, Q, slot_row, slot_col, o, nb, R, C, B, K,
                                  device, stream);
  return launch_dblocks<128, TO>(P, Q, slot_row, slot_col, o, nb, R, C, B, K,
                                 device, stream);
}

template <bool BF16>
int fwd_width(const void* blocks, const int* slot_col, const int* rb_ptr,
              const void* xb, float* out, int nb, int R, int C, int B, int K,
              int device, cudaStream_t stream) {
  if (K <= 64)
    return launch_fwd<64, BF16>(blocks, slot_col, rb_ptr, xb, out, nb, R, C,
                                B, K, device, stream);
  return launch_fwd<128, BF16>(blocks, slot_col, rb_ptr, xb, out, nb, R, C, B,
                               K, device, stream);
}

}  // namespace

extern "C" {

// The forward pass.  blocks (nb+1, B, Bp): float32 (dtype 0, Bp = B
// rounded up to 4) or bfloat16 (dtype 1, Bp = B rounded up to 8), the
// columns past B zero; slot_col (nb) int32; rb_ptr (R+1) int32 over the
// row-block-sorted slots; xb (C*B, K4) float32 row-major, the operand
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sc = static_cast<const int*>(slot_col);
  const int* rp = static_cast<const int*>(rb_ptr);
  float* o = static_cast<float*>(out);
  return dtype == 1
             ? fwd_width<true>(blocks, sc, rp, xb, o, nb, R, C, B, K, device, s)
             : fwd_width<false>(blocks, sc, rp, xb, o, nb, R, C, B, K, device, s);
}

// The transpose pass.  blocks (nb+1, B, B) float32 (dtype 0) or bfloat16
// (dtype 1); slot_row (nb) int32; order_t (nb) int32, the slots stably
// sorted by column block; cb_ptr (C+1) int32 over slot_col[order_t]; gb
// (R*B, K) float32 row-major; out (C*B, K) float32.
int block_spmm_t(int device, int dtype, const void* blocks,
                 const void* slot_row, const void* order_t, const void* cb_ptr,
                 const void* gb, void* out, int C, int B, int K,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C <= 0 || B <= 0 || K <= 0) return 0;
  dim3 grid((B + TM - 1) / TM, C, (K + TN - 1) / TN);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* order = static_cast<const int*>(order_t);
  const int* sr = static_cast<const int*>(slot_row);
  const int* cp = static_cast<const int*>(cb_ptr);
  const float* g = static_cast<const float*>(gb);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    block_spmm_t_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(blocks), order, sr, cp, g, o, B, K);
  } else if (dtype == 1) {
    block_spmm_t_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(blocks), order, sr, cp, g, o, B, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sr = static_cast<const int*>(slot_row);
  const int* sc = static_cast<const int*>(slot_col);
  return dtype == 1 ? dblocks_width<__nv_bfloat16>(P, Q, sr, sc, out, nb, R,
                                                   C, B, K, device, s)
                    : dblocks_width<float>(P, Q, sr, sc, out, nb, R, C, B, K,
                                           device, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
