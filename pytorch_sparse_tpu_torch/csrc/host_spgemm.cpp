// The port's host library: Gustavson SpGEMM, C = A @ B over CSR.
//
// A copy of the SpGEMM of pytorch_sparse_tpu/csrc/native.cpp (the JAX
// package's native host library: `spgemm_nnz_impl`, `spgemm_fill_impl`
// and the entries `spgemm_nnz` and `spgemm_fill`), line for line, so
// that the same inputs give the same output bits: each output entry is
// summed in float64 in the order of A's row, then of B's rows.  Host
// code, not a kernel: the numeric engine for products whose term list
// the device plan (ops/matmul.py) would not hold.
//
// Plain C ABI, loaded with ctypes (pytorch_sparse_tpu_torch/utils/
// _native.py) after `_build.load` compiles it with the host C++
// compiler: -O3 -march=native -fopenmp -fPIC -shared -std=c++17 and
// -ffp-contract=off (no -fopenmp where the compiler cannot link it).
//
// Two-pass protocol over an A-row range [row_lo, row_hi):
//   spgemm_nnz : writes rowptrC (row_hi-row_lo+1 entries, local, 0-based)
//                and returns nnzC for the range.
//   spgemm_fill: numeric pass writing colC (ascending per row) and valC.
// valA/valB/valC may be NULL (implicit ones / structure-only).  All index
// arrays are int64.  Rows run in parallel where OpenMP is built in, one
// thread a row with accumulators of its own, so the output does not
// depend on the thread count (nor on OpenMP being there at all).

#include <algorithm>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int64_t kI32Max = 2147483647;

// Index type I: int32 when P and the row range both fit (halves the
// mark array's cache footprint and the per-row sort traffic), int64
// otherwise.
template <typename I>
int64_t spgemm_nnz_impl(const int64_t *rowptrA, const int64_t *colA,
                        const int64_t *rowptrB, const int64_t *colB,
                        int64_t P, int64_t row_lo, int64_t row_hi,
                        int64_t *rowptrC) {
  int64_t R = row_hi - row_lo;
  rowptrC[0] = 0;
  const int64_t W = (P + 63) / 64;
#pragma omp parallel
  {
    // A bitset of P bits a thread marks the columns a row has reached;
    // clearing it costs O(P/64) words a row.
    std::vector<uint64_t> bits(W, 0);
#pragma omp for schedule(dynamic, 64)
    for (int64_t r = 0; r < R; r++) {
      int64_t i = row_lo + r;
      std::fill(bits.begin(), bits.end(), 0);
      int64_t cnt = 0;
      for (int64_t e = rowptrA[i]; e < rowptrA[i + 1]; e++) {
        int64_t k = colA[e];
        for (int64_t f = rowptrB[k]; f < rowptrB[k + 1]; f++) {
          int64_t j = colB[f];
          const uint64_t m = 1ull << (j & 63);
          uint64_t &w = bits[j >> 6];
          cnt += !(w & m);
          w |= m;
        }
      }
      rowptrC[r + 1] = cnt;
    }
  }
  for (int64_t r = 0; r < R; r++) rowptrC[r + 1] += rowptrC[r];
  return rowptrC[R];
}

template <typename I>
void spgemm_fill_impl(const int64_t *rowptrA, const int64_t *colA,
                      const double *valA, const int64_t *rowptrB,
                      const int64_t *colB, const double *valB, int64_t P,
                      int64_t row_lo, int64_t row_hi,
                      const int64_t *rowptrC, int64_t *colC,
                      double *valC) {
  int64_t R = row_hi - row_lo;
#pragma omp parallel
  {
    std::vector<double> acc(valC ? P : 0, 0.0);
    std::vector<I> mark(P, (I)-1);
    std::vector<I> cols;
#pragma omp for schedule(dynamic, 64)
    for (int64_t r = 0; r < R; r++) {
      int64_t i = row_lo + r;
      I stamp = (I)r;
      // Emit in ascending column order: a dense product row (from about
      // P/12 entries) by an ordered scan of the mark array, O(P); a
      // sparse one by sorting the columns it collected, O(cnt log cnt).
      // The count pass fixed cnt, so the choice is made up front.
      const int64_t base = rowptrC[r];
      const int64_t cnt = rowptrC[r + 1] - base;
      const bool dense = cnt * 12 >= P;
      if (!dense) cols.clear();
      for (int64_t e = rowptrA[i]; e < rowptrA[i + 1]; e++) {
        int64_t k = colA[e];
        double va = valA ? valA[e] : 1.0;
        for (int64_t f = rowptrB[k]; f < rowptrB[k + 1]; f++) {
          int64_t j = colB[f];
          double t = valB ? va * valB[f] : va;
          if (mark[j] != stamp) {
            mark[j] = stamp;
            if (!dense) cols.push_back((I)j);
            if (valC) acc[j] = t;
          } else if (valC) {
            acc[j] += t;
          }
        }
      }
      if (dense) {
        int64_t w = base;
        for (int64_t j = 0; j < P; j++) {
          if (mark[j] == stamp) {
            colC[w] = j;
            if (valC) valC[w] = acc[j];
            w++;
          }
        }
      } else {
        std::sort(cols.begin(), cols.end());
        for (int64_t s = 0; s < cnt; s++) {
          colC[base + s] = cols[s];
          if (valC) valC[base + s] = acc[cols[s]];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

int64_t spgemm_nnz(const int64_t *rowptrA, const int64_t *colA,
                   const int64_t *rowptrB, const int64_t *colB, int64_t P,
                   int64_t row_lo, int64_t row_hi, int64_t *rowptrC) {
  // Stamps are range-local rows (r < R), so int32 serves whenever the
  // column space and the row range fit; -1 never collides with a stamp.
  if (P < kI32Max && row_hi - row_lo < kI32Max)
    return spgemm_nnz_impl<int32_t>(rowptrA, colA, rowptrB, colB, P,
                                    row_lo, row_hi, rowptrC);
  return spgemm_nnz_impl<int64_t>(rowptrA, colA, rowptrB, colB, P,
                                  row_lo, row_hi, rowptrC);
}

void spgemm_fill(const int64_t *rowptrA, const int64_t *colA,
                 const double *valA, const int64_t *rowptrB,
                 const int64_t *colB, const double *valB, int64_t P,
                 int64_t row_lo, int64_t row_hi, const int64_t *rowptrC,
                 int64_t *colC, double *valC) {
  if (P < kI32Max && row_hi - row_lo < kI32Max)
    spgemm_fill_impl<int32_t>(rowptrA, colA, valA, rowptrB, colB, valB, P,
                              row_lo, row_hi, rowptrC, colC, valC);
  else
    spgemm_fill_impl<int64_t>(rowptrA, colA, valA, rowptrB, colB, valB, P,
                              row_lo, row_hi, rowptrC, colC, valC);
}

}  // extern "C"
