// The on-chip gather probe's kernels: a row gather from a table held in
// shared memory (K13a), the edge-axis scan that a segment reduce is built
// from (K13b), and a CSR SpMM that stages X's row tiles in shared memory
// and gathers each edge from its tile (K13c).
//
// Replaces the one pl.pallas_call of the JAX package,
// benchmarks/probe_vmem_gather.py:45 _call, with its three kernels:
// gather_kernel (:64) and gather8_kernel (:86), o = x[idx[:, 0]] from a
// 2048-row and an 8-row table held in VMEM, and the kernel of _loop_time
// (:107) with c_body (:136), sum over i < R of cumsum(h + i, axis=0).
// The probe asked whether SpMM can stream X's rows through on-chip memory
// and gather each edge's row from the resident tile; Mosaic refused any
// gather that reaches past one vreg (8 rows).  K13c is the design the
// probe judged, on Hopper's shared memory: it computes what the gather
// route computes (pytorch_sparse_tpu/ops/kernels/ell.py:309 ell_spmm,
// which csr_spmm.cu replaced).
//
// What bounds it on an H100, kernel by kernel.  K13a and K13b move 1 MiB
// each way and are bound by launch and latency at the probe's size: the
// question is whether the design is expressible, and what a pass
// costs.  K13c is bound like the CSR kernel (csr_spmm.cu) by the rows of
// x its edges gather, one K-wide row an edge, from L2 or device memory;
// where a (row block, tile) pair holds many edges, K13c reads the tile's
// rows once into shared memory and serves every edge of the pair from
// there, at shared memory's rate (128 bytes a clock an SM).
//
// K13a: each block stages one float4-wide column slab of all T rows (32
// KB at T = 2048) and writes that slab of its share of the output rows;
// grid (row chunks, K / 4).  Measured on an H100 (PERF.md, the K13a
// findings), it is faster than a table split by rows over a thread-block
// cluster's shared memory and read across it (4.3 against 7.9 us at
// T = 2048).
// An index outside [0, T) reads nothing and writes NaN.
//
// K13b: h is read once and held on chip for all R passes, as the JAX
// kernel holds h_ref and its fori_loop carry in VMEM; out is written
// once.  A block takes a slab of VEC columns (16-byte loads and stores
// where VEC = 4) of every row, kScanRows consecutive rows a thread, each
// thread holding its rows of h and of the running sum in registers.
// A pass is a real scan of h + i down the rows: each thread scans its
// rows, a warp-shuffle scan joins the threads' totals, and the warps'
// totals meet in shared memory (double-buffered by the pass's parity, so
// one barrier a pass), where every warp sums those above it.  The passes
// add into the sum in order i = 0..R-1.  Past the rows of one block of
// 512 threads of 8 rows (T > 4096) runs the streaming kernel: a warp a
// column, four rows a lane, h re-read and out updated every pass.
//
// K13c: the CSR walk of csr_walk.cuh (its Lanes and Batch arithmetic and
// its 16-byte chunks) over a column slab of W = vec * lanes columns
// (gridDim.y = ceil(K / W), slab-major, so that one slab of x is read
// while it sits in L2): a sub-warp of `lanes` lanes walks a row, so a
// warp walks 32 / lanes rows at once, with 8 edges' rows issued before
// their FMAs, every load unconditional, and the next 8 edges' indices
// loaded before this batch's rows.  A block of 16 warps owns 256 rows.
// It first copies every tile that the plan stages for its rows, X[tile
// rows, slab], into shared memory with 16-byte cp.async, with a slot
// table from each tile of x to its place there; the plan keeps a block
// within 113 KB so that two blocks share an SM and one's staging overlaps
// the other's walk.  The lane that loads an edge's column looks its slot
// up once and makes the row's address, in the staged tile or in x (a
// select of two addresses, not a branch), and the sub-warp shuffles it
// round.  A block that stages nothing walks as K1 does, from x.  Each
// output element is one fmaf chain from 0 over its row's edges in CSR
// order, the chain of csr_walk.cuh: K13c and K1 agree bit for bit.
// Measured on an H100 (PERF.md, the K13c findings): a slab of 32
// columns beats K1 on the uniform graph, but staging loses on the
// community graph, where L1 already holds a row block's slab of x (128
// B a row) and the staged tiles take L1's room.

// The interface is plain C, bound from Python with ctypes: pointers come
// in as void*, the launch goes on the caller's stream, and the return
// value is cudaGetLastError() after the launch.  A kernel's shared-memory
// attributes are set once per kernel and device, and the device is set
// only when it is not already current.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "csr_walk.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's most on sm_90

int use_device(int device) {
  int cur = -1;
  if (cudaGetDevice(&cur) == cudaSuccess && cur == device) return 0;
  return (int)cudaSetDevice(device);
}

// Lets `fn` take up to kMaxSmem of dynamic shared memory on the current
// device, once: the attribute is a ceiling, and the launch's own size
// still decides how many blocks share an SM.
cudaError_t allow_smem(const void* fn, int device) {
  struct Grant {
    const void* fn;
    int device;
  };
  static std::mutex mu;
  static Grant granted[256];
  static int n_granted = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_granted; ++i) {
    if (granted[i].fn == fn && granted[i].device == device) return cudaSuccess;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && n_granted < 256) {
    granted[n_granted++] = Grant{fn, device};
  }
  return err;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// VEC floats from p to q: one 16-byte load and store where VEC == 4.
template <int VEC>
__device__ __forceinline__ void copy_chunk(float* q, const float* p) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(q) = *reinterpret_cast<const float4*>(p);
  } else {
    *q = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void nan_chunk(float* q) {
  const float nan = __int_as_float(0x7fc00000);
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(q) = make_float4(nan, nan, nan, nan);
  } else {
    *q = nan;
  }
}

// ---- K13a ------------------------------------------------------------------

constexpr int kSlabThreads = 256;

// smem: the column slab [VEC * blockIdx.y, + VEC) of all T rows.
template <int VEC>
__global__ void __launch_bounds__(kSlabThreads)
gather_slab_kernel(const int* __restrict__ idx,
                   const float* __restrict__ table, float* __restrict__ out,
                   int n, int T, int K) {
  extern __shared__ __align__(16) float slab[];
  const int k0 = blockIdx.y * VEC;
  if constexpr (VEC == 4) {
    for (int r = threadIdx.x; r < T; r += blockDim.x) {
      cp_async16(slab + 4 * r, table + (int64_t)r * K + k0);
    }
    cp_async_wait_all();
  } else {
    for (int r = threadIdx.x; r < T; r += blockDim.x) {
      slab[r] = __ldg(table + (int64_t)r * K + k0);
    }
  }
  __syncthreads();
  const int per = (n + gridDim.x - 1) / gridDim.x;
  const int i0 = blockIdx.x * per;
  const int i1 = min(n, i0 + per);
  for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    const int r = __ldg(idx + i);
    float* o = out + (int64_t)i * K + k0;
    if ((unsigned)r < (unsigned)T) {
      copy_chunk<VEC>(o, slab + VEC * r);
    } else {
      nan_chunk<VEC>(o);
    }
  }
}

// ---- K13b ------------------------------------------------------------------

constexpr int kScanRows = 8;  // measured on an H100 against 1, 2 and 4
constexpr int kScanMaxThreads = 512;
constexpr int kScanMaxWarps = kScanMaxThreads / 32;

// Block x: columns [VEC * x, + VEC) of every row, kScanRows rows a thread.
template <int VEC>
__global__ void __launch_bounds__(kScanMaxThreads)
edge_scan_onchip_kernel(const float* __restrict__ h, float* __restrict__ out,
                        int T, int K, int R) {
  __shared__ __align__(16) float tot[2][kScanMaxWarps][VEC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * VEC;
  const int r0 = threadIdx.x * kScanRows;
  const int nv = max(0, min(kScanRows, T - r0));  // this thread's rows

  float hv[kScanRows][VEC], acc[kScanRows][VEC];
#pragma unroll
  for (int q = 0; q < kScanRows; ++q) {
    if (q < nv) {
      const float* p = h + (int64_t)(r0 + q) * K + c0;
      if constexpr (VEC == 4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(p));
        hv[q][0] = x.x;
        hv[q][1] = x.y;
        hv[q][2] = x.z;
        hv[q][3] = x.w;
      } else {
        hv[q][0] = __ldg(p);
      }
    } else {
#pragma unroll
      for (int c = 0; c < VEC; ++c) hv[q][c] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[q][c] = 0.f;
  }

  for (int i = 0; i < R; ++i) {
    const float add = (float)i;
    float v[kScanRows][VEC], incl[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) incl[c] = 0.f;
#pragma unroll
    for (int q = 0; q < kScanRows; ++q) {
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        if (q < nv) incl[c] += hv[q][c] + add;
        v[q][c] = incl[c];
      }
    }
    // The threads' totals, scanned across the warp.
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const float u = __shfl_up_sync(kFullMask, incl[c], d);
        if (lane >= d) incl[c] += u;
      }
    }
    float base[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      base[c] = __shfl_up_sync(kFullMask, incl[c], 1);
      if (lane == 0) base[c] = 0.f;
    }
    float(*slot)[VEC] = tot[i & 1];
    if (lane == 31) {
#pragma unroll
      for (int c = 0; c < VEC; ++c) slot[warp][c] = incl[c];
    }
    __syncthreads();
    // The carry: the totals of the warps above this one, lane by lane,
    // then summed across the warp.
    float part[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) part[c] = lane < warp ? slot[lane][c] : 0.f;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        part[c] += __shfl_xor_sync(kFullMask, part[c], m);
      }
    }
#pragma unroll
    for (int c = 0; c < VEC; ++c) base[c] += part[c];
#pragma unroll
    for (int q = 0; q < kScanRows; ++q) {
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[q][c] += base[c] + v[q][c];
    }
  }

#pragma unroll
  for (int q = 0; q < kScanRows; ++q) {
    if (q < nv) {
      float* p = out + (int64_t)(r0 + q) * K + c0;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(p) =
            make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
      } else {
        p[0] = acc[q][0];
      }
    }
  }
}

// The streaming scan, for T past the on-chip kernel's rows.
constexpr int kScanWarps = 8;
constexpr int kRowsPerLane = 4;
constexpr int kScanChunk = 32 * kRowsPerLane;

__global__ void __launch_bounds__(kScanWarps * 32)
edge_scan_kernel(const float* __restrict__ h, float* __restrict__ out, int T,
                 int K, int R) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  if (c >= K) return;  // uniform across the warp
  for (int i = 0; i < R; ++i) {
    const float add = (float)i;
    float carry = 0.f;
    for (int r0 = 0; r0 < T; r0 += kScanChunk) {
      const int rl = r0 + lane * kRowsPerLane;
      float v[kRowsPerLane];
      float run = 0.f;
#pragma unroll
      for (int q = 0; q < kRowsPerLane; ++q) {
        if (rl + q < T) run += __ldg(h + (int64_t)(rl + q) * K + c) + add;
        v[q] = run;
      }
      float incl = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float u = __shfl_up_sync(kFullMask, incl, d);
        if (lane >= d) incl += u;
      }
      float excl = __shfl_up_sync(kFullMask, incl, 1);
      if (lane == 0) excl = 0.f;
      const float base = carry + excl;
      carry += __shfl_sync(kFullMask, incl, 31);
#pragma unroll
      for (int q = 0; q < kRowsPerLane; ++q) {
        if (rl + q < T) {
          float* o = out + (int64_t)(rl + q) * K + c;
          const float p = base + v[q];
          *o = i == 0 ? p : *o + p;
        }
      }
    }
  }
}

// ---- K13c ------------------------------------------------------------------

constexpr int kTileThreads = 512;
constexpr int kTileMinBlocks = 2;  // two blocks an SM: 64 registers a lane
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kRowsPerBlock = 256;
constexpr int kTileU = csr_walk::kEdgesInFlight;  // edges' rows in flight

// The walk of one block's rows over its column slab, as K1 walks: the
// sub-warp shuffles each edge's column (and value) round and each lane
// loads its chunk of the row, 8 rows in flight; the next batch's indices
// are loaded before this batch's rows.  STAGED: the lane that loads an
// edge's column looks its tile up in slot[] once for the sub-warp and
// hands on the row's address, in the staged tile or in x, which the
// lanes read with one generic load: a select of two addresses, not a
// branch.
template <int VEC, int LPR, bool HAS_VAL, bool STAGED>
__device__ __forceinline__ void tiled_walk(
    const int* __restrict__ rowptr, const int* __restrict__ col,
    const float* __restrict__ val, const float* __restrict__ x,
    const short* slot, const float* tiles, float* __restrict__ out, int M,
    int K, int tshift) {
  using Ln = csr_walk::Lanes<VEC, LPR, 1>;
  using Bt = csr_walk::Batch<LPR, kTileU>;
  constexpr int W = VEC * LPR;                 // the slab's columns
  constexpr int SUBS = kTileWarps * Ln::RPW;   // sub-warps a block
  constexpr int U = kTileU;
  // What a sub-warp hands round for an edge: the row's address where the
  // block stages, else its column.
  using Src =
      typename std::conditional<STAGED, unsigned long long, int>::type;
  Ln ln;
  ln.place(K);
  const int kbase = blockIdx.y * W;
  const int loff = ln.live[0] ? ln.s * VEC : 0;  // a dead lane reads chunk 0
  const int tmask = (1 << tshift) - 1;
  const int r_end = min(M, (int)(blockIdx.x + 1) * kRowsPerBlock);

  auto fetch = [&](int base, int end, Src (&mc)[Bt::IPL],
                   float (&mv)[Bt::IPL]) {
#pragma unroll
    for (int i = 0; i < Bt::IPL; ++i) {
      const int e = Bt::edge(base, ln.s, i, end);
      const int c = __ldg(col + e);
      mv[i] = HAS_VAL ? __ldg(val + e) : 1.f;
      if constexpr (STAGED) {
        const int sl = slot[c >> tshift];
        const float* p = sl >= 0 ? tiles + ((sl << tshift) + (c & tmask)) * W
                                 : x + (int64_t)c * K + kbase;
        mc[i] = reinterpret_cast<unsigned long long>(p);
      } else {
        mc[i] = c;
      }
    }
  };

  for (int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5) * Ln::RPW +
                 ln.lane / LPR;
       row < r_end; row += SUBS) {  // uniform across the sub-warp
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
    const int start = __ldg(rowptr + row);
    const int end = __ldg(rowptr + row + 1);
    Src mc[Bt::IPL];
    float mv[Bt::IPL];
    if (start < end) fetch(start, end, mc, mv);
    for (int base = start; base < end; base += Bt::CH) {
      const int n = min(Bt::CH, end - base);
      // The next batch's indices (clamped to the row's last edge).
      Src mc_next[Bt::IPL];
      float mv_next[Bt::IPL];
      fetch(base + Bt::CH, end, mc_next, mv_next);
      for (int g = 0; g < n; g += U) {
        float v[U];
        float xv[U][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          v[u] = HAS_VAL ? Bt::take(ln.mask, mv, g, u) : 1.f;
          const Src c = Bt::take(ln.mask, mc, g, u);
          if constexpr (STAGED) {
            // Shared or device memory, by the address: a generic load.
            const float* p = reinterpret_cast<const float*>(c) + loff;
            if constexpr (VEC == 4) {
              const float4 q = *reinterpret_cast<const float4*>(p);
              xv[u][0] = q.x;
              xv[u][1] = q.y;
              xv[u][2] = q.z;
              xv[u][3] = q.w;
            } else {
              xv[u][0] = *p;
            }
          } else {
            csr_walk::load_chunk<VEC>(x + (int64_t)c * K + kbase + loff,
                                      xv[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (g + u < n) {
#pragma unroll
            for (int q = 0; q < VEC; ++q) acc[q] = fmaf(v[u], xv[u][q], acc[q]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < Bt::IPL; ++i) {
        mc[i] = mc_next[i];
        mv[i] = mv_next[i];
      }
    }
    if (ln.live[0]) {
      float* o = out + (int64_t)row * K + ln.c0;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
        o[0] = acc[0];
      }
    }
  }
}

// smem: a slot table (one short a tile of x: the tile's place among the
// block's staged tiles, or -1), then the staged tiles, T x W floats each.
template <int VEC, int LPR, bool HAS_VAL>
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
tiled_spmm_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
                  const float* __restrict__ val, const float* __restrict__ x,
                  const int* __restrict__ stage_ptr,
                  const int* __restrict__ stage_tile, float* __restrict__ out,
                  int M, int N, int K, int tshift, int n_tiles,
                  int slot_bytes) {
  constexpr int W = VEC * LPR;
  const int s0 = __ldg(stage_ptr + blockIdx.x);
  const int ns = __ldg(stage_ptr + blockIdx.x + 1) - s0;
  if (ns == 0) {  // uniform across the block
    tiled_walk<VEC, LPR, HAS_VAL, false>(rowptr, col, val, x, nullptr,
                                         nullptr, out, M, K, tshift);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  short* slot = reinterpret_cast<short*>(smem_raw);
  float* tiles = reinterpret_cast<float*>(smem_raw + slot_bytes);
  const int T = 1 << tshift;
  const int kbase = blockIdx.y * W;
  const int kw = min(W, K - kbase);  // the slab's columns below K
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) slot[i] = -1;
  // The slab of every staged tile's rows, all copies in flight at once;
  // columns past K are left unwritten (only dead lanes read them).
  for (int i = 0; i < ns; ++i) {
    const int c0 = __ldg(stage_tile + s0 + i) << tshift;
    const int rows = min(T, N - c0);
    float* dst = tiles + (size_t)i * T * W;
    const float* src = x + (int64_t)c0 * K + kbase;
    if constexpr (VEC == 4) {
      const int per_row = kw / 4;
      for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
        const int r = e / per_row, q = e - r * per_row;
        cp_async16(dst + r * W + 4 * q, src + (int64_t)r * K + 4 * q);
      }
    } else {
      for (int e = threadIdx.x; e < rows * kw; e += blockDim.x) {
        const int r = e / kw, q = e - r * kw;
        dst[r * W + q] = __ldg(src + (int64_t)r * K + q);
      }
    }
  }
  __syncthreads();  // the slot table is reset
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    slot[__ldg(stage_tile + s0 + i)] = (short)i;
  }
  cp_async_wait_all();
  __syncthreads();
  tiled_walk<VEC, LPR, HAS_VAL, true>(rowptr, col, val, x, slot, tiles, out,
                                      M, K, tshift);
}

template <int VEC, int LPR>
int launch_tiled(int device, const int* rp, const int* ci, const float* v,
                 const float* xp, const int* sp, const int* st, float* op,
                 int M, int N, int K, int tshift, int n_tiles, int slot_bytes,
                 int smem, cudaStream_t s) {
  constexpr int W = VEC * LPR;
  // Slab-major: a slab's pass over x runs as one wave after another, so
  // that a slab of x that fits in L2 is read from device memory once.
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock, (K + W - 1) / W);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  auto go = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t err =
          allow_smem(reinterpret_cast<const void*>(kernel), device);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, kTileThreads, smem, s>>>(rp, ci, v, xp, sp, st, op, M, N,
                                            K, tshift, n_tiles, slot_bytes);
    return (int)cudaGetLastError();
  };
  return v != nullptr ? go(tiled_spmm_kernel<VEC, LPR, true>)
                      : go(tiled_spmm_kernel<VEC, LPR, false>);
}

}  // namespace

extern "C" {

// idx (n) int32, table (T, K) float32 row-major, out (n, K) float32
// row-major; args: {device, n, T, K, vec, grid_x} (one pointer, not six
// ints: the call is short enough that converting each argument shows).
// Slabs of `vec` columns, grid (grid_x, K / vec); vec 4 needs K % 4 == 0
// and table and out on 16-byte boundaries.
int smem_gather_f32(const int* args, const void* idx, const void* table,
                    void* out, void* stream) {
  const int device = args[0], n = args[1], T = args[2], K = args[3];
  const int vec = args[4], grid_x = args[5];
  int rc = use_device(device);
  if (rc != 0) return rc;
  if (n <= 0 || K <= 0) return 0;
  const int64_t smem = (int64_t)T * vec * 4;
  if (T <= 0 || grid_x <= 0 || (vec != 1 && vec != 4) || K % vec != 0 ||
      (vec == 4 && !csr_walk::aligned16({table, out})) || smem > kMaxSmem ||
      K / vec > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int* ip = static_cast<const int*>(idx);
  const float* tp = static_cast<const float*>(table);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, K / vec);
  auto go = [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t err =
          allow_smem(reinterpret_cast<const void*>(kernel), device);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, kSlabThreads, (int)smem, s>>>(ip, tp, op, n, T, K);
    return (int)cudaGetLastError();
  };
  return vec == 4 ? go(gather_slab_kernel<4>) : go(gather_slab_kernel<1>);
}

// h (T, K) float32 row-major, out (T, K) float32 row-major, R >= 1.  The
// instance: `streaming` (1: the streaming kernel; 0: the on-chip scan, T
// at most kScanRows * kScanMaxThreads) and, for the on-chip scan, columns
// a slab `vec` (4: K % 4 == 0 and h and out on 16-byte boundaries; 1:
// any).
int edge_scan_loop_f32(int device, const void* h, void* out, int T, int K,
                       int R, int streaming, int vec, void* stream) {
  int rc = use_device(device);
  if (rc != 0) return rc;
  if (T <= 0 || K <= 0) return 0;
  if (R <= 0) return (int)cudaErrorInvalidValue;
  const float* hp = static_cast<const float*>(h);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (streaming) {
    edge_scan_kernel<<<(K + kScanWarps - 1) / kScanWarps, kScanWarps * 32, 0,
                       s>>>(hp, op, T, K, R);
    return (int)cudaGetLastError();
  }
  const bool slab_ok =
      vec == 1 || (vec == 4 && K % 4 == 0 && csr_walk::aligned16({h, out}));
  if (!slab_ok || T > kScanRows * kScanMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = ((T + kScanRows - 1) / kScanRows + 31) & ~31;
  if (vec == 4) {
    edge_scan_onchip_kernel<4><<<K / 4, threads, 0, s>>>(hp, op, T, K, R);
  } else {
    edge_scan_onchip_kernel<1><<<K, threads, 0, s>>>(hp, op, T, K, R);
  }
  return (int)cudaGetLastError();
}

// rowptr (M+1) int32, col (E) int32 in [0, N), val (E) float32 or NULL
// for implicit ones, x (N, K) float32 row-major, out (M, K) float32
// row-major; the plan: stage_ptr (ceil(M / 256) + 1) int32 and stage_tile
// int32, the staged tiles of each block of 256 rows (at most max_staged),
// tiles of 2**tshift rows of x.  The instance: slabs of vec * lanes
// columns, lanes a row (vec 4: 1 to 8 lanes, needing K % 4 == 0 and x and
// out on 16-byte boundaries; vec 1: 1 to 32).
int tiled_spmm_f32(int device, const void* rowptr, const void* col,
                   const void* val, const void* x, const void* stage_ptr,
                   const void* stage_tile, int max_staged, void* out, int M,
                   int N, int K, int tshift, int vec, int lanes,
                   void* stream) {
  int rc = use_device(device);
  if (rc != 0) return rc;
  if (M <= 0 || K <= 0) return 0;
  if (tshift < 0 || tshift > 12 || max_staged < 0 ||
      (vec == 4 && (K % 4 != 0 || !csr_walk::aligned16({x, out})))) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = ((N > 0 ? N : 1) + (1 << tshift) - 1) >> tshift;
  const int slot_bytes = (2 * n_tiles + 15) / 16 * 16;
  const int64_t smem =
      max_staged == 0
          ? 0
          : slot_bytes + (int64_t)max_staged * (vec * lanes * 4 << tshift);
  if (n_tiles > 32767 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int* rp = static_cast<const int*>(rowptr);
  const int* ci = static_cast<const int*>(col);
  const float* v = static_cast<const float*>(val);
  const float* xp = static_cast<const float*>(x);
  const int* sp = static_cast<const int*>(stage_ptr);
  const int* st = static_cast<const int*>(stage_tile);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TILED_CASE(VEC_, LPR_)                                               \
  if (vec == VEC_ && lanes == LPR_)                                          \
    return launch_tiled<VEC_, LPR_>(device, rp, ci, v, xp, sp, st, op, M, N, \
                                    K, tshift, n_tiles, slot_bytes,          \
                                    (int)smem, s);
  TILED_CASE(4, 1)
  TILED_CASE(4, 2)
  TILED_CASE(4, 4)
  TILED_CASE(4, 8)
  TILED_CASE(1, 1)
  TILED_CASE(1, 2)
  TILED_CASE(1, 4)
  TILED_CASE(1, 8)
  TILED_CASE(1, 16)
  TILED_CASE(1, 32)
#undef TILED_CASE
  return (int)cudaErrorInvalidValue;  // no such instance
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
