// The tensor-core template of the block kernels (csrc/block_spmm.cu and
// csrc/block_spgemm.cu): TF32 wgmma fed by TMA through a ring of
// shared-memory stages, with the 3xTF32 split for f32 accuracy.
//
// The tensor core reads an f32 word as TF32 by dropping its low 13
// mantissa bits, so each f32 operand a is big + small with big = a &
// 0xffffe000 (the word itself, as the tensor core reads it) and small = a
// - big, exact in f32 and written beside it.  Each product is
// a_small*b_big + a_big*b_small + a_big*b_big; the dropped small*small term
// is within 2^-20 of |a*b| and the TF32 reading of small within 2^-21.  A
// bf16 operand is exact in TF32 and has no small part: a bf16 block times
// an f32 operand is blk*x_small + blk*x_big, two bf16 operands one product.
// The tensor core adds into its f32 accumulator with truncation, an error
// that grows with the number of adds, so each 32-wide reduction step runs
// into a fresh accumulator that is then added into the tile's sums on the
// FP32 units, rounding to nearest.
//
// One CTA owns a 128-row by BN-column output tile at a time (BN = 64 or
// 128 by the output width): two consumer warpgroups of 64 rows each and
// one producer warp.  The producer issues two TMA loads per step into a
// ring of stages (three or four, up to 200 KB of dynamic shared memory),
// each guarded by a full and an empty mbarrier: a tile of the A operand
// (128 output rows x 32 reduction indices) and a tile of the B operand (32
// reduction indices x BN output columns).  TF32 wgmma takes only K-major
// operands (the reduction index contiguous) from shared memory, in tiles
// of 128-byte rows with the 128-byte swizzle that the descriptors name.
// An operand that lies K-major in memory (the block store's rows as the
// forward's A; both operands of the store gradient) is loaded so by TMA.
// One that lies the other way, its output index contiguous (the
// forward's x, the transpose's block and its g, the SpGEMM's B block), is
// loaded as it lies, [32 r][N + pad], the pad putting consecutive rows on
// different banks, and the consumers transpose it into the K-major tile
// as they split it (Staged below).  When a stage lands, the consumers
// write its small parts (and the transposed or widened tiles), sync on a
// named barrier, and issue the stage's wgmmas; they prepare the next stage
// while those run, then wait for them, add them into the sums and release
// the stage.  TMA fills the parts of a box outside the tensor with zeros:
// rows past B, columns past the block width or K.  The epilogue writes
// the sums straight from registers, masked to B rows and the output width.
//
// Two walks share the kernel.  A segment walk (FWD): an output tile of
// segment seg sums over the positions ptr[seg]..ptr[seg+1] of a schedule,
// and each position's block in steps of 32 reduction indices; position p
// reads A block a_of[p] (p itself when a_of is null) and B block b_of[p]
// (b_by_pos) or b_of[a] (by its A block).  The forward is the walk over
// the row-block-sorted slots (A block p, B block slot_col[p]), the
// transpose over order_t (A block order_t[p], B block slot_row of it),
// the SpGEMM over the pairs of an output block (a_idx[p], b_idx[p]).  A
// segment with no position writes zeros.  The store gradient (!FWD)
// walks K in steps of 32 for each slot seg, with A = P's row block
// a_of[seg] and B = Q's column block b_of[seg], and the slot past nb
// writes zeros.  Each tile is owned by one CTA, so its sum order is fixed
// and there is no atomic.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace block_tc {

constexpr int kBM = 128;  // output rows of a CTA: two warpgroups of 64
constexpr int kBK = 32;   // reduction step: 32 f32, one 128-byte swizzle row
constexpr int kConsumers = 256;
constexpr int kTcThreads = kConsumers + 32;  // + the producer warp
constexpr int kATile = kBM * kBK * 4;        // 16 KB
constexpr int kSmemBudget = 200 * 1024;

constexpr int round1k(int b) { return (b + 1023) / 1024 * 1024; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Where the walk finds its blocks; see the head of this file.
struct Sched {
  const int* ptr;
  const int* a_of;
  const int* b_of;
  int b_by_pos;
};

// The stage layout: A's K-major tile, A's slot (its small part, or its
// tile as it lies), B's K-major tile, B's slot (likewise).  A_MN: A
// arrives as it lies, [32 r][128 + pad]; else K-major (as [128][32] bf16,
// unswizzled, when A_BF16).  FWD: B arrives as it lies, [32 r][BN + pad];
// else K-major.  Slots are whole KB, so every tile keeps the 1024-byte
// alignment of the swizzle.
template <int BN, bool FWD, bool A_MN, bool A_BF16, bool B_BF16>
struct Tile {
  static constexpr int kAElem = A_BF16 ? 2 : 4;
  static constexpr int kBElem = B_BF16 ? 2 : 4;
  static constexpr bool kASmall = !A_BF16;
  static constexpr bool kBSmall = !B_BF16;
  static constexpr int kAWidth = kBM + 16 / kAElem;
  static constexpr int kXWidth = BN + 16 / kBElem;
  static constexpr int kABytes =
      A_MN ? kBK * kAWidth * kAElem : kBM * kBK * kAElem;
  static constexpr int kBTile = BN * kBK * 4;
  static constexpr int kBBytes = FWD ? kBK * kXWidth * kBElem : kBTile;
  static constexpr int kASlot = round1k(cmax(
      kASmall ? kATile : 0, (A_MN || A_BF16) ? kABytes : 0));
  static constexpr int kBSlot =
      round1k(cmax(kBSmall ? kBTile : 0, FWD ? kBBytes : 0));
  static constexpr int kOffASlot = kATile;
  static constexpr int kOffB = kATile + kASlot;
  static constexpr int kOffBSlot = kOffB + kBTile;
  static constexpr int kStage = kOffBSlot + kBSlot;
  static constexpr int kStages =
      kSmemBudget / kStage < 4 ? kSmemBudget / kStage : 4;
  static constexpr int kSmem = kStages * kStage + 1024;  // + alignment
  static_assert(kStages >= 2, "a ring needs two stages");
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

// A tile that arrived as it lies, [32 r][W] (r the reduction index, rows
// of W = N + pad elements), on its way to the K-major [N][32 r] tile.  The
// consumers read it into registers (bf16 widened, which is exact), sync,
// and write it with the 128-byte swizzle, and its small part beside it.
// Lane l takes r = l, so its reads step by a row (the pad puts
// consecutive rows on different banks) and its writes fill one 128-byte
// row of 32 r; warp w takes the columns 4*(w + 8u).
template <int N, int W, bool BF16>
struct Staged {
  static constexpr int kChunks = N / 32;
  float4 v[kChunks];

  __device__ __forceinline__ void read(const uint8_t* tile, int tid) {
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int e = lane * W + 4 * (warp + 8 * u);
      if constexpr (BF16) {
        const uint2 w = *reinterpret_cast<const uint2*>(tile + 2 * e);
        v[u] = make_float4(__uint_as_float(w.x << 16),
                           __uint_as_float(w.x & 0xffff0000u),
                           __uint_as_float(w.y << 16),
                           __uint_as_float(w.y & 0xffff0000u));
      } else {
        v[u] = *reinterpret_cast<const float4*>(tile + 4 * e);
      }
    }
  }

  template <bool SMALL>
  __device__ __forceinline__ void write(uint8_t* big, uint8_t* small,
                                        int tid) const {
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const float vals[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 4 * (warp + 8 * u) + e;
        const int off =
            n * 128 + (((lane >> 2) ^ (n & 7)) << 4) + (lane & 3) * 4;
        *reinterpret_cast<float*>(big + off) = vals[e];
        if constexpr (SMALL)
          *reinterpret_cast<float*>(small + off) = tf32_small(vals[e]);
      }
    }
  }
};

// After a stage lands, make its K-major tiles: A's small part (K-major
// f32), A widened (K-major bf16, a [128][32] bf16 tile unswizzled in A's
// slot), or A transposed (A_MN, from A's slot); B's small part (!FWD) or
// B transposed (FWD, from B's slot).  A tile that is read from a slot
// that its small part then overwrites is read by every consumer before
// a named barrier.
template <int BN, bool FWD, bool A_MN, bool A_BF16, bool B_BF16>
__device__ __forceinline__ void prepare(uint8_t* stage, int tid) {
  using Cfg = Tile<BN, FWD, A_MN, A_BF16, B_BF16>;
  uint8_t* a_big = stage;
  uint8_t* a_slot = stage + Cfg::kOffASlot;
  uint8_t* b_big = stage + Cfg::kOffB;
  uint8_t* b_slot = stage + Cfg::kOffBSlot;
  if constexpr (!A_MN) {
    if constexpr (A_BF16) {
#pragma unroll
      for (int i = 0; i < kBM * kBK / 4 / kConsumers; ++i) {
        const int u = tid + i * kConsumers;  // 16-byte chunk j of f32 row r
        const int r = u >> 3, j = u & 7;
        const uint2 v =
            *reinterpret_cast<const uint2*>(a_slot + r * 64 + j * 8);
        *reinterpret_cast<float4*>(a_big + r * 128 + ((j ^ (r & 7)) << 4)) =
            make_float4(__uint_as_float(v.x << 16),
                        __uint_as_float(v.x & 0xffff0000u),
                        __uint_as_float(v.y << 16),
                        __uint_as_float(v.y & 0xffff0000u));
      }
    } else {
      split_tile<kATile / 16>(a_big, a_slot, tid);
    }
  }
  if constexpr (FWD) {
    // One staged tile at a time, so that only one is held in registers
    // (both at once spilled at BN = 128); a barrier only where the small
    // part overwrites the slot that the tile arrived in.
    if constexpr (A_MN) {
      Staged<kBM, Cfg::kAWidth, A_BF16> a;
      a.read(a_slot, tid);
      if constexpr (Cfg::kASmall) consumer_sync();
      a.template write<Cfg::kASmall>(a_big, a_slot, tid);
    }
    Staged<BN, Cfg::kXWidth, B_BF16> b;
    b.read(b_slot, tid);
    if constexpr (Cfg::kBSmall) consumer_sync();
    b.template write<Cfg::kBSmall>(b_big, b_slot, tid);
  } else {
    split_tile<Cfg::kBTile / 16>(b_big, b_slot, tid);
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
// fastest.  FWD: a segment's tile sums over its positions' blocks (B
// rows and reduction indices each), out (nseg*B, K) f32.  !FWD: a segment
// is a slot s < nb+1, out (nb+1, B, B) in TO, K the padded K4.  Each CTA
// takes the tiles blockIdx.x, blockIdx.x + gridDim.x, ...: the ring's
// stages and phases run on from one tile to the next, so the producer
// loads the next tile's steps while the consumers write this one.
template <int BN, bool FWD, bool A_MN, bool A_BF16, bool B_BF16, typename TO>
__global__ void __launch_bounds__(kTcThreads, 1)
tc_kernel(const __grid_constant__ CUtensorMap map_a,
          const __grid_constant__ CUtensorMap map_b, const Sched sc,
          TO* __restrict__ out, int nb, int ntiles_total, int B, int K) {
  using Cfg = Tile<BN, FWD, A_MN, A_BF16, B_BF16>;
  constexpr int S = Cfg::kStages;
  constexpr bool AS = Cfg::kASmall, BS = Cfg::kBSmall;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S];
  __shared__ __align__(8) uint64_t empty[S];
  // The 128-byte swizzle repeats every 1024 bytes: align the ring to it.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int ntiles = ((FWD ? K : B) + BN - 1) / BN;
  const int mtiles = (B + kBM - 1) / kBM;
  const int csteps = FWD ? (B + kBK - 1) / kBK : 1;
  // Tile `tile`: its segment, first row and column, first position (FWD)
  // and number of steps.
  auto tile_of = [&](int tile, int& seg, int& i0, int& n0, int& s0,
                     int& nsteps) {
    n0 = tile % ntiles * BN;
    i0 = tile / ntiles % mtiles * kBM;
    seg = tile / (ntiles * mtiles);
    if constexpr (FWD) {
      s0 = sc.ptr[seg];
      nsteps = (sc.ptr[seg + 1] - s0) * csteps;
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
          mbar_expect_tx(&full[st], Cfg::kABytes + Cfg::kBBytes);
          if constexpr (FWD) {
            const int p = s0 + t / csteps, c0 = (t % csteps) * kBK;
            const int a = sc.a_of ? sc.a_of[p] : p;
            const int b = sc.b_of[sc.b_by_pos ? p : a];
            if constexpr (A_MN)
              tma_load_3d(stage + Cfg::kOffASlot, &map_a, &full[st], i0, c0,
                          a);
            else
              tma_load_3d(A_BF16 ? stage + Cfg::kOffASlot : stage, &map_a,
                          &full[st], c0, i0, a);
            tma_load_3d(stage + Cfg::kOffBSlot, &map_b, &full[st], n0, c0, b);
          } else {
            const int k0 = t * kBK;
            tma_load_3d(stage, &map_a, &full[st], k0, i0, sc.a_of[seg]);
            tma_load_3d(stage + Cfg::kOffB, &map_b, &full[st], k0, n0,
                        sc.b_of[seg]);
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
      prepare<BN, FWD, A_MN, A_BF16, B_BF16>(smem + g % S * Cfg::kStage, tid);
      fence_proxy_async();
      consumer_sync();
      for (int t = 0; t < nsteps; ++t, ++g) {
        const int st = g % S;
        const uint8_t* stage = smem + st * Cfg::kStage;
        const uint64_t da0 = sw128_desc(stage + wg * (kATile / 2));
        const uint64_t da1 =
            sw128_desc(stage + Cfg::kOffASlot + wg * (kATile / 2));
        const uint64_t db0 = sw128_desc(stage + Cfg::kOffB);
        const uint64_t db1 = sw128_desc(stage + Cfg::kOffBSlot);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk) {
          const uint64_t o = 2 * kk;  // 8 f32 = 32 bytes, in 16-byte units
          // The stage's first product overwrites the accumulator.
          if constexpr (AS) Mma<BN>::run(acc, da1 + o, db0 + o, kk > 0);
          if constexpr (BS)
            Mma<BN>::run(acc, da0 + o, db1 + o, AS ? 1 : kk > 0);
          Mma<BN>::run(acc, da0 + o, db0 + o, (AS || BS) ? 1 : kk > 0);
        }
        wgmma_commit();
        const bool more = t + 1 < nsteps;
        if (more) {  // prepare the next stage while the tensor cores run
          const int st1 = (g + 1) % S;
          mbar_wait(&full[st1], ((g + 1) / S) & 1);
          prepare<BN, FWD, A_MN, A_BF16, B_BF16>(smem + st1 * Cfg::kStage,
                                                 tid);
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

// cuTensorMapEncodeTiled is a driver function; the libraries link only the
// runtime, so it is fetched through the runtime's driver entry point.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
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

// A 3-D tiled map over a (d2, d1, d0) array whose rows lie ld0 elements
// apart (ld0 >= d0, ld0 * elem a multiple of 16 bytes) and whose planes
// d1 rows apart, with a (b2, b1, b0) box; the parts of a box outside
// (d2, d1, d0) read as zeros, whatever lies in the rows' padding.
inline bool encode(CUtensorMap* map, bool bf16, const void* base, uint64_t d0,
                   uint64_t d1, uint64_t d2, uint64_t ld0, uint32_t b0,
                   uint32_t b1, uint32_t b2, bool swizzle) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const uint64_t elem = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {ld0 * elem, ld0 * d1 * elem};
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

inline int round_up(int a, int m) { return (a + m - 1) / m * m; }

// The row pitch of a block store: B rounded up to 16 bytes.
inline int store_pitch(int B, bool bf16) { return round_up(B, bf16 ? 8 : 4); }

inline int sm_count(int device) {
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return n > 0 ? n : 1;
}

// The A operand's map: the block store, (nblocks, B, B) with rows `pitch`
// elements apart.  K-major: [128 rows][32 reduction] boxes, swizzled for
// f32 (wgmma reads them as they land) and as they lie for bf16 (widened by
// the consumers).  A_MN: [32 reduction][128 + pad output rows] as they lie.
template <int BN, bool FWD, bool A_MN, bool A_BF16, bool B_BF16>
bool encode_store(CUtensorMap* map, const void* blocks, int nblocks, int B,
                  int pitch) {
  using Cfg = Tile<BN, FWD, A_MN, A_BF16, B_BF16>;
  if (A_MN)
    return encode(map, A_BF16, blocks, B, B, nblocks, pitch, Cfg::kAWidth,
                  kBK, 1, false);
  return encode(map, A_BF16, blocks, B, B, nblocks, pitch, kBK, kBM, 1,
                !A_BF16);
}

// The B operand of a segment walk, (nblocks, rows, width) with rows
// `pitch` elements apart, in [32 reduction][BN + pad] boxes as they lie.
template <int BN, bool A_MN, bool A_BF16, bool B_BF16>
bool encode_rows(CUtensorMap* map, const void* base, int width, int rows,
                 int nblocks, int pitch) {
  using Cfg = Tile<BN, true, A_MN, A_BF16, B_BF16>;
  return encode(map, B_BF16, base, width, rows, nblocks, pitch, Cfg::kXWidth,
                kBK, 1, false);
}

// A segment walk's tiles differ in length, so it launches one CTA a tile
// and leaves the balance to the hardware; the store gradient's tiles are
// all alike, so it launches one CTA an SM.
template <int BN, bool FWD, bool A_MN, bool A_BF16, bool B_BF16, typename TO>
int launch_tc(const CUtensorMap& ma, const CUtensorMap& mb, const Sched& sc,
              TO* out, int nb, int nseg, int B, int K, int device,
              cudaStream_t stream) {
  auto kernel = tc_kernel<BN, FWD, A_MN, A_BF16, B_BF16, TO>;
  constexpr int smem = Tile<BN, FWD, A_MN, A_BF16, B_BF16>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (int64_t)nseg * ((B + kBM - 1) / kBM) *
                        (((FWD ? K : B) + BN - 1) / BN);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (tiles == 0) return 0;
  const int64_t grid = FWD ? tiles : std::min<int64_t>(tiles, sm_count(device));
  kernel<<<(unsigned)grid, kTcThreads, smem, stream>>>(ma, mb, sc, out, nb,
                                                       (int)tiles, B, K);
  return (int)cudaGetLastError();
}

// A segment walk over a block store (A) and row blocks of a second
// operand (B, `width` columns a row, `pitch` apart): out (nseg*B, width)
// f32, BN by the width.
template <bool A_MN, bool A_BF16, bool B_BF16, int BN>
int walk_bn(const void* store, int nblocks, int spitch, const void* rows,
            int nrowblocks, int rpitch, const Sched& sc, float* out, int nseg,
            int B, int width, int device, cudaStream_t stream) {
  CUtensorMap ma, mb;
  if (!encode_store<BN, true, A_MN, A_BF16, B_BF16>(&ma, store, nblocks, B,
                                                    spitch) ||
      !encode_rows<BN, A_MN, A_BF16, B_BF16>(&mb, rows, width, B, nrowblocks,
                                             rpitch))
    return (int)cudaErrorInvalidValue;
  return launch_tc<BN, true, A_MN, A_BF16, B_BF16, float>(
      ma, mb, sc, out, 0, nseg, B, width, device, stream);
}

template <bool A_MN, bool A_BF16, bool B_BF16>
int walk(const void* store, int nblocks, int spitch, const void* rows,
         int nrowblocks, int rpitch, const Sched& sc, float* out, int nseg,
         int B, int width, int device, cudaStream_t stream) {
  if (width <= 64)
    return walk_bn<A_MN, A_BF16, B_BF16, 64>(store, nblocks, spitch, rows,
                                             nrowblocks, rpitch, sc, out,
                                             nseg, B, width, device, stream);
  return walk_bn<A_MN, A_BF16, B_BF16, 128>(store, nblocks, spitch, rows,
                                            nrowblocks, rpitch, sc, out, nseg,
                                            B, width, device, stream);
}

}  // namespace block_tc
