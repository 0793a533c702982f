// Per-shard local SpMM of the distributed schedules: one edge group of a
// row shard against the buffer the schedule holds (the shard's own block
// of x, the block the ring brought, the all-gathered x, or the received
// halo rows).
//
//   shard_spmm:         g[r, k] = sum_{p in [rowptr[r], rowptr[r+1])} val[p] * buf[col[p], k]
//                       out[map(r), k] = g[r, k]               (write), or
//                       out[map(r), k] = out[map(r), k] + g[r, k]   (accumulate)
//   shard_spmm_minmax:  the min or max over the group's row of val[p] * buf[col[p], k],
//                       with the edge that gave it as a GLOBAL edge id
//                       eid_base + (pos ? pos[p] : p), written, or combined
//                       into a running (out, arg).
//
// They replace the JAX package's per-shard compute in
// pytorch_sparse_tpu/parallel/dist.py: _group_ell_apply (:337) with the
// sums around it (`out + step` of the ring at :828, `interior + frontier`
// of the halo at :869-875 and :921-934), and _group_ell_minmax (:369)
// with _combine_minmax (:756).  There, each group was a degree-bucketed,
// padded ELL table because XLA on the TPU scatters slowly; here each
// group is a CSR whose rows keep the global CSR edge order.
//
// Accumulation follows JAX's order: the warp sums the group's row in
// registers and adds the sum to out once, so out = a + (e1 + e2 + ...),
// not ((a + e1) + e2).  row_map (optional) sends group row r to shard
// row row_map[r]: a ring group or a frontier group holds only the rows
// that have edges in it.  rowptr may be a slice of a larger pointer array
// (its first entry need not be 0): the transposed groups of the backward
// are row ranges of one CSC.
//
// The min/max rules are _group_ell_minmax's and _combine_minmax's:
//   - within the group, strict comparison, the running best starting from
//     the row's first edge, so ties keep the first CSR edge; a NaN
//     candidate wins over a non-NaN best and the first NaN wins among
//     NaNs (jnp.argmax/argmin return the first NaN);
//   - a row with no edge in the group writes (+-inf, INT32_MAX) in write
//     mode (JAX's pad row) and leaves (out, arg) alone when combining;
//   - combining takes the group's value where it is strictly better, or
//     equal with a lower global edge id, so the argout does not depend on
//     which group or ring step found a value first.  A NaN compares
//     false, so it neither replaces nor is replaced.
//
// K11a is the CSR walk of csr_walk.cuh (shared with csr_spmm.cu), which
// states what bounds it and its design: 16-byte loads, several edges' rows
// in flight, sub-warp rows at narrow widths.  Accumulation follows JAX's
// order (above); row_map and a rowptr slice are the walk's own arguments.
//
// K11b keeps a walk of its own here.  What bounds it on an H100: the
// device-memory bytes of one K-wide row of buf per edge (4K bytes) plus
// its column index and value; a compare per element is far below the
// card's rate.  Design: one warp per group row.  Lanes own columns
// k = lane + 32*j (KPL per lane, K masked, wide K in column tiles on
// gridDim.y).  Each lane loads one edge's (col, val), and __shfl_sync
// broadcasts them in edge order, so the index reads are coalesced and
// every buf row is read as contiguous 128-byte segments.  Each output
// element is written by one thread: no atomics, deterministic.
//
// The interface is plain C, bound from Python with ctypes: pointers come
// in as void*, the launch goes on the caller's stream, and the return
// value is cudaGetLastError() after the launch.

#include <math_constants.h>

#include "csr_walk.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kNoEdge = 0x7fffffff;  // JAX's int32-max pad arg

template <int KPL, bool IS_MIN>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
shard_minmax_kernel(const int* __restrict__ rowptr,
                    const int* __restrict__ col,
                    const float* __restrict__ val,
                    const float* __restrict__ buf,
                    const int* __restrict__ pos,
                    const int* __restrict__ row_map, float* __restrict__ out,
                    int* __restrict__ arg, int R, int K, int eid_base,
                    int combine) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;  // uniform across the warp
  const int k0 = blockIdx.y * (32 * KPL) + lane;
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  if (start == end && combine) return;  // nothing to combine

  const float big = IS_MIN ? CUDART_INF_F : -CUDART_INF_F;
  float best[KPL];
  int best_e[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    best[j] = big;
    best_e[j] = -1;
  }

  for (int base = start; base < end; base += 32) {
    const int n = min(32, end - base);
    int my_c = 0;
    float my_v = 1.f;
    if (lane < n) {
      my_c = col[base + lane];
      if (val != nullptr) my_v = val[base + lane];
    }
    for (int t = 0; t < n; ++t) {
      const int c = __shfl_sync(kFullMask, my_c, t);
      const float v = __shfl_sync(kFullMask, my_v, t);
      const int e = base + t;
      const float* __restrict__ br = buf + (int64_t)c * K;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int k = k0 + 32 * j;
        if (k < K) {
          float h = __ldg(br + k);
          if (val != nullptr) h = v * h;
          const bool better = IS_MIN ? (h < best[j]) : (h > best[j]);
          const bool nan_wins = h != h && best[j] == best[j];
          if (e == start || better || nan_wins) {
            best[j] = h;
            best_e[j] = e;
          }
        }
      }
    }
  }

  const int orow = row_map != nullptr ? row_map[row] : row;
  float* __restrict__ o = out + (int64_t)orow * K;
  int* __restrict__ a = arg + (int64_t)orow * K;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = k0 + 32 * j;
    if (k >= K) continue;
    int gid = kNoEdge;
    if (best_e[j] >= 0) {
      gid = eid_base + (pos != nullptr ? pos[best_e[j]] : best_e[j]);
    }
    if (combine) {
      const float ov = o[k];
      const bool better = IS_MIN ? (best[j] < ov) : (best[j] > ov);
      if (better || (best[j] == ov && gid < a[k])) {
        o[k] = best[j];
        a[k] = gid;
      }
    } else {
      o[k] = best[j];
      a[k] = gid;
    }
  }
}

dim3 grid_of(int R, int K, int KPL) {
  return dim3((R + kWarpsPerBlock - 1) / kWarpsPerBlock,
              (K + 32 * KPL - 1) / (32 * KPL));
}

template <bool IS_MIN>
void launch_minmax(const int* rp, const int* ci, const float* v,
                   const float* b, const int* ps, const int* rm, float* o,
                   int* a, int R, int K, int eid_base, int combine,
                   cudaStream_t s) {
  const dim3 block(kWarpsPerBlock * 32);
  if (K <= 32) {
    shard_minmax_kernel<1, IS_MIN><<<grid_of(R, K, 1), block, 0, s>>>(
        rp, ci, v, b, ps, rm, o, a, R, K, eid_base, combine);
  } else if (K <= 64) {
    shard_minmax_kernel<2, IS_MIN><<<grid_of(R, K, 2), block, 0, s>>>(
        rp, ci, v, b, ps, rm, o, a, R, K, eid_base, combine);
  } else if (K <= 128) {
    shard_minmax_kernel<4, IS_MIN><<<grid_of(R, K, 4), block, 0, s>>>(
        rp, ci, v, b, ps, rm, o, a, R, K, eid_base, combine);
  } else {
    shard_minmax_kernel<8, IS_MIN><<<grid_of(R, K, 8), block, 0, s>>>(
        rp, ci, v, b, ps, rm, o, a, R, K, eid_base, combine);
  }
}

}  // namespace

extern "C" {

// rowptr (R+1) int32 (absolute offsets into col and val), col int32,
// val float32 or NULL for implicit ones, buf (n, K) float32 row-major,
// row_map (R) int32 or NULL, out (rows, K) float32 row-major.
int shard_spmm_f32(int device, const void* rowptr, const void* col,
                   const void* val, const void* buf, const void* row_map,
                   void* out, int R, int K, int accumulate, void* stream) {
  return csr_walk::run(device, rowptr, col, val, buf, row_map, out, R, K,
                       accumulate, stream);
}

// As shard_spmm_f32, plus pos (edges) int32 or NULL (the edge's own index),
// arg (rows, K) int32 row-major; global id = eid_base + pos[p].
int shard_spmm_minmax_f32(int device, int is_min, const void* rowptr,
                          const void* col, const void* val, const void* buf,
                          const void* pos, const void* row_map, void* out,
                          void* arg, int R, int K, int eid_base, int combine,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || K <= 0) return 0;
  if ((K + 255) / 256 > 65535) return (int)cudaErrorInvalidValue;
  const int* rp = static_cast<const int*>(rowptr);
  const int* ci = static_cast<const int*>(col);
  const float* v = static_cast<const float*>(val);
  const float* b = static_cast<const float*>(buf);
  const int* ps = static_cast<const int*>(pos);
  const int* rm = static_cast<const int*>(row_map);
  float* o = static_cast<float*>(out);
  int* a = static_cast<int*>(arg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_min) {
    launch_minmax<true>(rp, ci, v, b, ps, rm, o, a, R, K, eid_base, combine,
                        s);
  } else {
    launch_minmax<false>(rp, ci, v, b, ps, rm, o, a, R, K, eid_base, combine,
                         s);
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
