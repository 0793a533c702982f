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
// costs.  K13c is bound by device-memory bytes like the CSR kernel
// (csr_spmm.cu): each edge of K1 gathers one K-wide row of X from L2 or
// device memory.  Where a (row block, tile) pair holds many edges, K13c
// reads the tile's rows once into shared memory and serves every edge of
// the pair from there.
//
// K13a: each block stages all T rows of a slab of Kc columns (T * Kc * 4
// bytes of dynamic shared memory, up to 227 KB) and writes every output
// row of that slab from it; gridDim.y = ceil(K / Kc).  An index outside
// [0, T) reads nothing and writes NaN.
//
// K13b: one warp per column.  A lane holds four consecutive rows and
// scans them itself; a warp-shuffle scan of the lanes' totals and a carry
// from the previous 128 rows give each row's prefix.  The R passes run
// inside the launch and add into the output (pass 0 writes it).
//
// K13c: a block owns 256 rows (16 warps of 16) and one slab of 32
// columns (one a lane).  It first copies every tile that the plan stages
// for its rows, X[tile rows, slab] (at most 227 KB in all), into shared
// memory, with a table from each tile of x to its place there.  Then each
// warp walks the edges of its 16 rows once, in CSR order, 32 at a time:
// an edge whose column lies in a staged tile reads x from shared memory,
// any other from device memory.  Each output element is one fmaf chain
// from 0 over its row's edges in CSR order, the chain of csr_spmm.cu: the
// two kernels agree bit for bit, whatever the order of columns in a row.
// Sixteen edges' loads (and the next chunk's indices) are issued before
// their adds, the tile or device memory chosen by a select of two
// addresses rather than a branch, so that a row's few edges outside the
// staged tiles wait for device memory together.
//
// The interface is plain C, bound from Python with ctypes: pointers come
// in as void*, the launch goes on the caller's stream, and the return
// value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's most on sm_90

// ---- K13a ------------------------------------------------------------------

constexpr int kGatherThreads = 512;

__global__ void __launch_bounds__(kGatherThreads)
smem_gather_kernel(const int* __restrict__ idx,
                   const float* __restrict__ table, float* __restrict__ out,
                   int n, int T, int K, int Kc) {
  extern __shared__ float tile[];  // T x Kc
  const int k0 = blockIdx.y * Kc;
  const int kw = min(Kc, K - k0);
  for (int e = threadIdx.x; e < T * kw; e += blockDim.x) {
    const int r = e / kw, kk = e - r * kw;
    tile[r * Kc + kk] = __ldg(table + (int64_t)r * K + k0 + kk);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n * kw; e += blockDim.x) {
    const int i = e / kw, kk = e - i * kw;
    const int r = __ldg(idx + i);
    out[(int64_t)i * K + k0 + kk] = (unsigned)r < (unsigned)T
                                        ? tile[r * Kc + kk]
                                        : __int_as_float(0x7fc00000);
  }
}

// ---- K13b ------------------------------------------------------------------

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

constexpr int kTileWarps = 16;
constexpr int kRowsPerWarp = 16;
constexpr int kRowsPerBlock = kTileWarps * kRowsPerWarp;  // 256
constexpr int kSlab = 32;
constexpr int kIlp = 16;  // loads in flight a warp

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// smem: a slot table (one short a tile of x: the tile's place among the
// block's staged tiles, or -1), then the staged tiles, T x kSlab floats
// each.
template <bool HAS_VAL>
__global__ void __launch_bounds__(kTileWarps * 32)
tiled_spmm_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
                  const float* __restrict__ val, const float* __restrict__ x,
                  const int* __restrict__ stage_ptr,
                  const int* __restrict__ stage_tile, float* __restrict__ out,
                  int M, int N, int K, int tshift, int n_tiles,
                  int slot_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  short* slot = reinterpret_cast<short*>(smem_raw);
  float* tiles = reinterpret_cast<float*>(smem_raw + slot_bytes);
  const int T = 1 << tshift;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kbase = blockIdx.y * kSlab;
  const int k = kbase + lane;
  const bool kin = k < K;
  const int kx = kin ? k : 0;  // a lane past K reads a valid column
  const int s0 = stage_ptr[blockIdx.x];
  const int ns = stage_ptr[blockIdx.x + 1] - s0;

  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) slot[i] = -1;
  __syncthreads();
  if (ns > 0) {  // uniform across the block
    for (int i = threadIdx.x; i < ns; i += blockDim.x) {
      slot[stage_tile[s0 + i]] = (short)i;
    }
    // Whole 16-byte pieces of the slab in every row of x: asynchronous
    // copies, all of the block's tiles in flight at once.
    const bool vec = (K % 4) == 0 && kbase + kSlab <= K &&
                     (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    for (int i = 0; i < ns; ++i) {
      const int c0 = stage_tile[s0 + i] << tshift;
      const int rows = min(T, N - c0);
      float* dst = tiles + (size_t)i * T * kSlab;
      if (vec) {
        for (int e = threadIdx.x; e < rows * (kSlab / 4); e += blockDim.x) {
          const int r = e / (kSlab / 4), q = e % (kSlab / 4);
          cp_async16(dst + r * kSlab + 4 * q,
                     x + (int64_t)(c0 + r) * K + kbase + 4 * q);
        }
      } else {
        for (int e = threadIdx.x; e < rows * kSlab; e += blockDim.x) {
          const int kk = kbase + (e & (kSlab - 1));
          dst[e] = kk < K ? __ldg(x + (int64_t)(c0 + e / kSlab) * K + kk)
                          : 0.f;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }

  // The warp's rows are contiguous in CSR, so it walks their edges
  // [e0, e1) in chunks of 32 across row boundaries, closing a row where
  // its edges end.  The next chunk's indices are loaded first, then each
  // half chunk's 16 loads before its adds.
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  if (row0 >= M) return;  // no barrier follows
  const int nrows = min(kRowsPerWarp, M - row0);
  const int my_ptr = lane <= nrows ? rowptr[row0 + lane] : 0;
  const int e0 = __shfl_sync(kFullMask, my_ptr, 0);
  const int e1 = __shfl_sync(kFullMask, my_ptr, nrows);
  int r = 0;  // the open row
  int r_end = __shfl_sync(kFullMask, my_ptr, 1);
  float acc = 0.f;
  int c = 0;
  float v = 0.f;
  if (e0 + lane < e1) {
    c = __ldg(col + e0 + lane);
    v = HAS_VAL ? __ldg(val + e0 + lane) : 1.f;
  }
  for (int base = e0; base < e1; base += 32) {
    const int n = min(32, e1 - base);
    int c_next = 0;
    float v_next = 0.f;
    if (base + 32 + lane < e1) {
      c_next = __ldg(col + base + 32 + lane);
      v_next = HAS_VAL ? __ldg(val + base + 32 + lane) : 1.f;
    }
    for (int h = 0; h < n; h += kIlp) {
      // No branch: lanes past the chunk hold column 0, a valid row, and
      // a load from device memory or from the tile is a select of two
      // addresses, so that every load of the group is in flight at once.
      float vv[kIlp], xv[kIlp];
#pragma unroll
      for (int q = 0; q < kIlp; ++q) {
        const int cc = __shfl_sync(kFullMask, c, (h + q) & 31);
        vv[q] = __shfl_sync(kFullMask, v, (h + q) & 31);
        const int sl = slot[cc >> tshift];
        const float* src =
            sl >= 0 ? tiles + (((size_t)sl << tshift) + (cc & (T - 1))) *
                                  kSlab + lane
                    : x + (int64_t)cc * K + kx;
        xv[q] = *src;
      }
#pragma unroll
      for (int q = 0; q < kIlp; ++q) {
        if (h + q < n) {
          while (base + h + q == r_end) {  // the open row is complete
            if (kin) out[(int64_t)(row0 + r) * K + k] = acc;
            acc = 0.f;
            ++r;
            r_end = __shfl_sync(kFullMask, my_ptr, r + 1);
          }
          acc = fmaf(vv[q], xv[q], acc);
        }
      }
    }
    c = c_next;
    v = v_next;
  }
  for (; r < nrows; ++r) {  // the open row, and empty rows after it
    if (kin) out[(int64_t)(row0 + r) * K + k] = acc;
    acc = 0.f;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

extern "C" {

// idx (n) int32 in [0, T), table (T, K) float32 row-major, out (n, K)
// float32 row-major; Kc columns a block (T * Kc * 4 bytes of shared
// memory at most 227 KB).
int smem_gather_f32(int device, const void* idx, const void* table,
                    void* out, int n, int T, int K, int Kc, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || K <= 0) return 0;
  const int64_t smem = (int64_t)T * Kc * 4;
  if (T <= 0 || Kc <= 0 || smem > kMaxSmem || (K + Kc - 1) / Kc > 65535 ||
      (int64_t)n * Kc > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  err = allow_smem(smem_gather_kernel, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(1, (K + Kc - 1) / Kc);
  smem_gather_kernel<<<grid, kGatherThreads, (int)smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(table),
      static_cast<float*>(out), n, T, K, Kc);
  return (int)cudaGetLastError();
}

// h (T, K) float32 row-major, out (T, K) float32 row-major, R >= 1.
int edge_scan_loop_f32(int device, const void* h, void* out, int T, int K,
                       int R, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T <= 0 || K <= 0) return 0;
  if (R <= 0) return (int)cudaErrorInvalidValue;
  edge_scan_kernel<<<(K + kScanWarps - 1) / kScanWarps, kScanWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<float*>(out), T, K, R);
  return (int)cudaGetLastError();
}

// rowptr (M+1) int32, col (E) int32 in [0, N), val (E) float32 or NULL
// for implicit ones, x (N, K) float32 row-major, out (M, K) float32
// row-major; the plan: stage_ptr (ceil(M / 256) + 1) int32 and stage_tile
// int32, the staged tiles of each block of 256 rows (at most max_staged),
// tiles of 2**tshift rows of x.
int tiled_spmm_f32(int device, const void* rowptr, const void* col,
                   const void* val, const void* x, const void* stage_ptr,
                   const void* stage_tile, int max_staged, void* out, int M,
                   int N, int K, int tshift, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || K <= 0) return 0;
  if (tshift < 0 || tshift > 12 || (K + kSlab - 1) / kSlab > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = ((N > 0 ? N : 1) + (1 << tshift) - 1) >> tshift;
  const int slot_bytes = (2 * n_tiles + 15) / 16 * 16;
  const int64_t smem =
      slot_bytes + (int64_t)max_staged * (kSlab * 4 << tshift);
  if (n_tiles > 32767 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock, (K + kSlab - 1) / kSlab);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(rowptr);
  const int* ci = static_cast<const int*>(col);
  const float* v = static_cast<const float*>(val);
  const float* xp = static_cast<const float*>(x);
  const int* sp = static_cast<const int*>(stage_ptr);
  const int* st = static_cast<const int*>(stage_tile);
  float* op = static_cast<float*>(out);
  if (v != nullptr) {
    err = allow_smem(tiled_spmm_kernel<true>, (int)smem);
    if (err != cudaSuccess) return (int)err;
    tiled_spmm_kernel<true><<<grid, kTileWarps * 32, (int)smem, s>>>(
        rp, ci, v, xp, sp, st, op, M, N, K, tshift, n_tiles, slot_bytes);
  } else {
    err = allow_smem(tiled_spmm_kernel<false>, (int)smem);
    if (err != cudaSuccess) return (int)err;
    tiled_spmm_kernel<false><<<grid, kTileWarps * 32, (int)smem, s>>>(
        rp, ci, v, xp, sp, st, op, M, N, K, tshift, n_tiles, slot_bytes);
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
