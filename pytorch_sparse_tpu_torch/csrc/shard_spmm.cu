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
// K11b is the min/max walk of minmax_walk.cuh on the same instances:
// float4 chunks where K % 4 == 0 and buf, out and arg start on 16-byte
// boundaries (else scalar ones), the lanes K needs, 8 edges' buf rows in
// flight.  What bounds it on an H100 is what bounds K11a (one K-wide row
// of buf per edge, from L2 or device memory) plus the argout beside out;
// its compare-and-select costs about five instructions an element
// where K11a's FMA costs one, so where the rows sit in L1 or L2 the issue
// rate of those instructions bounds it.  The end of a row maps the best
// edge to its global id (eid_base + pos[e]) and writes or combines with
// 16-byte stores.  Each output element is written by one thread: no
// atomics, deterministic.
//
// The interface is plain C, bound from Python with ctypes: pointers come
// in as void*, the launch goes on the caller's stream, and the return
// value is cudaGetLastError() after the launch.

#include "csr_walk.cuh"
#include "minmax_walk.cuh"

namespace {

using csr_walk::Lanes;
constexpr int kNoEdge = 0x7fffffff;  // JAX's int32-max pad arg

template <int VEC, int LPR, int CPL, bool IS_MIN, bool HAS_VAL>
__global__ void __launch_bounds__(csr_walk::kWarpsPerBlock * 32)
shard_minmax_kernel(const int* __restrict__ rowptr,
                    const int* __restrict__ col,
                    const float* __restrict__ val,
                    const float* __restrict__ buf,
                    const int* __restrict__ pos,
                    const int* __restrict__ row_map, float* __restrict__ out,
                    int* __restrict__ arg, int R, int K, int eid_base,
                    int combine) {
  Lanes<VEC, LPR, CPL> ln;
  const int row = ln.item;
  if (row >= R) return;  // uniform across the sub-warp
  ln.place(K);
  const int start = __ldg(rowptr + row);
  const int end = __ldg(rowptr + row + 1);
  if (start == end && combine) return;  // nothing to combine

  float best[CPL][VEC];
  int best_e[CPL][VEC];
  csr_walk::minmax_walk<VEC, LPR, CPL, IS_MIN, HAS_VAL>(
      ln, start, end, col, val, buf, K, best, best_e);

  const int orow = row_map != nullptr ? __ldg(row_map + row) : row;
  float* __restrict__ o = out + (int64_t)orow * K + ln.c0;
  int* __restrict__ a = arg + (int64_t)orow * K + ln.c0;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    if (!ln.live[j]) continue;
    float* __restrict__ oj = o + ln.STRIDE * j;
    int* __restrict__ aj = a + ln.STRIDE * j;
    float ov[VEC];
    int av[VEC];
    if (combine) {
      if constexpr (VEC == 4) {
        const float4 p = *reinterpret_cast<const float4*>(oj);
        const int4 t = *reinterpret_cast<const int4*>(aj);
        ov[0] = p.x, ov[1] = p.y, ov[2] = p.z, ov[3] = p.w;
        av[0] = t.x, av[1] = t.y, av[2] = t.z, av[3] = t.w;
      } else {
        ov[0] = oj[0];
        av[0] = aj[0];
      }
    }
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const int e = best_e[j][q];
      const int gid =
          e < 0 ? kNoEdge : eid_base + (pos != nullptr ? __ldg(pos + e) : e);
      float b = best[j][q];
      int id = gid;
      if (combine) {
        const bool better = IS_MIN ? (b < ov[q]) : (b > ov[q]);
        if (!(better || (b == ov[q] && gid < av[q]))) {
          b = ov[q];
          id = av[q];
        }
      }
      ov[q] = b;
      av[q] = id;
    }
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(oj) =
          make_float4(ov[0], ov[1], ov[2], ov[3]);
      *reinterpret_cast<int4*>(aj) = make_int4(av[0], av[1], av[2], av[3]);
    } else {
      oj[0] = ov[0];
      aj[0] = av[0];
    }
  }
}

template <int VEC, int LPR, int CPL, bool IS_MIN, bool HAS_VAL>
int launch_minmax(const csr_walk::Instance& in, const int* rp,
                  const int* ci, const float* v, const float* b,
                  const int* ps, const int* rm, float* o, int* a, int R,
                  int K, int eid_base, int combine, cudaStream_t s) {
  shard_minmax_kernel<VEC, LPR, CPL, IS_MIN, HAS_VAL>
      <<<csr_walk::grid_of(in, R), csr_walk::kWarpsPerBlock * 32, 0, s>>>(
          rp, ci, v, b, ps, rm, o, a, R, K, eid_base, combine);
  return (int)cudaGetLastError();
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
  const csr_walk::Instance in =
      csr_walk::choose(K, csr_walk::aligned16({buf, out, arg}));
  if (in.tiles > 65535) return (int)cudaErrorInvalidValue;
  const int* rp = static_cast<const int*>(rowptr);
  const int* ci = static_cast<const int*>(col);
  const float* v = static_cast<const float*>(val);
  const float* b = static_cast<const float*>(buf);
  const int* ps = static_cast<const int*>(pos);
  const int* rm = static_cast<const int*>(row_map);
  float* o = static_cast<float*>(out);
  int* a = static_cast<int*>(arg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return csr_walk::dispatch(in, [&](auto shape) {
    using S = decltype(shape);
#define SHARD_MINMAX_LAUNCH(IS_MIN_, HAS_VAL_)                             \
  launch_minmax<S::VEC, S::LPR, S::CPL, IS_MIN_, HAS_VAL_>(                \
      in, rp, ci, v, b, ps, rm, o, a, R, K, eid_base, combine, s)
    if (is_min) {
      return v != nullptr ? SHARD_MINMAX_LAUNCH(true, true)
                          : SHARD_MINMAX_LAUNCH(true, false);
    }
    return v != nullptr ? SHARD_MINMAX_LAUNCH(false, true)
                        : SHARD_MINMAX_LAUNCH(false, false);
#undef SHARD_MINMAX_LAUNCH
  });
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
