// Banded LU factor and solve of one system held by one thread, SUNDIALS
// bandGETRF / bandGETRS in LAPACK column band storage, and the sums of
// utils/numerics.py sum0: the device code of the whole-solve kernel's band
// linear solver (ida_lane.cuh, -DIDA_LINEAR_SOLVER=1).
//
// The order of operations is the eager port's, ida_tpu_torch/ops/banded.py
// band_factor / band_solve (its module doc lists what decides the bits):
// * the band is [ROWS = 2*ML+MU+1][N], entry (i, j) of the matrix at row
//   i - j + SMU (SMU = MU + ML) of column j, the ML rows above the band fill;
// * the pivot of column k is the first maximum of |column| over its live
//   rows k..min(k+ML, N-1), a NaN counting as the maximum (the first NaN);
//   piv[k] is its offset d;
// * the row swap is two corrections, row k := v1 + (v2 - v1) and row k + d :=
//   v2 + (v1 - v2), across the window columns k..k+SMU, also for d = 0;
// * the multipliers are divisions by the pivot (a zero pivot replaced by 1,
//   its column recorded), over all ML rows below it, out of the matrix too;
// * back substitution subtracts one sum0 of the SMU products U[k, k+t]
//   x[k+t] of a row, the products past the last column being +0 * +0.
// The eager factor works on a copy padded with SMU zero columns; what lands
// there never reaches a column of the matrix, so the columns past N - 1 are
// left out here. Every entry the factor stores is computed as the eager code
// computes it, the rows below the matrix included. N, MU and ML are template
// parameters and every loop is unrolled, so the band stays where the caller
// keeps it.

#pragma once

#include "rounded.cuh"

namespace ida {

// utils/numerics.py sum0 of t[0..count): left to right up to 32 terms, a
// pairwise tree of the terms zero-padded to a power of two beyond; K bounds
// count (the size of t)
template <int K> struct Pow2Above {
  static constexpr int v = K <= 1 ? 1 : 2 * Pow2Above<(K + 1) / 2>::v;
};
template <> struct Pow2Above<1> { static constexpr int v = 1; };

template <typename T, int K>
__device__ __forceinline__ T sum0_of(const T (&t)[K], int count) {
  if (count <= 32) {
    T acc = t[0];
#pragma unroll
    for (int i = 1; i < (K < 32 ? K : 32); ++i)
      if (i < count) acc = acc + t[i];
    return acc;
  }
  if constexpr (K > 32) {
    constexpr int P = Pow2Above<K>::v;
    T buf[P];
    int size = 1;
    while (size < count) size *= 2;
    for (int i = 0; i < P; ++i) buf[i] = (i < count) ? t[i] : T(0);
    while (size > 1) {
      size /= 2;
      for (int i = 0; i < size; ++i) buf[i] = buf[i] + buf[i + size];
    }
    return buf[0];
  }
  return t[0];  // not reached: count <= K <= 32
}

// Factor ab in place; returns 0, or the 1-based column of the first zero pivot.
template <typename T, int N, int MU, int ML>
__device__ __forceinline__ int band_factor_dev(T (&ab)[2 * ML + MU + 1][N], int (&piv)[N]) {
  constexpr int SMU = MU + ML;
  constexpr int ROWS = 2 * ML + MU + 1;
  int fail = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    // the pivot: the first maximum of |column k| over its live rows
    const int live = (ML + 1 < N - k) ? ML + 1 : N - k;
    T best = absval(ab[SMU][k]);
    bool nan = best != best;
    int d = 0;
#pragma unroll
    for (int i = 1; i <= ML; ++i) {
      if (i < live) {
        const T a = absval(ab[SMU + i][k]);
        const bool take = !nan && ((a != a) || a > best);
        nan = nan || (a != a);
        best = take ? a : best;
        d = take ? i : d;
      }
    }
    piv[k] = d;

    // rows k and k + d across the window's columns of the matrix
#pragma unroll
    for (int t = 0; t <= SMU; ++t) {
      if (k + t < N) {
        const int rk = SMU - t;  // where row k lies in column k + t
        const T v1 = ab[rk][k + t];
        T v2 = v1;
#pragma unroll
        for (int i = 1; i <= ML; ++i)
          if (rk + i < ROWS) v2 = (d == i) ? ab[rk + i][k + t] : v2;
        const T dn = v2 + (v1 - v2);
#pragma unroll
        for (int i = 1; i <= ML; ++i)
          if (rk + i < ROWS) ab[rk + i][k + t] = (d == i) ? dn : ab[rk + i][k + t];
        ab[rk][k + t] = v1 + (v2 - v1);
      }
    }

    // the multipliers, and the first zero pivot
    const T p = ab[SMU][k];
    const bool zero = p == T(0);
    fail = (fail == 0 && zero) ? k + 1 : fail;
    const T safe = zero ? T(1) : p;
#pragma unroll
    for (int i = 1; i <= ML; ++i) ab[SMU + i][k] = ab[SMU + i][k] / safe;

    // the rank-1 update of the trailing band: row k + i, column k + t
#pragma unroll
    for (int i = 1; i <= ML; ++i)
#pragma unroll
      for (int t = 1; t <= SMU; ++t)
        if (k + t < N)
          ab[SMU + i - t][k + t] = ab[SMU + i - t][k + t] - ab[SMU + i][k] * ab[SMU - t][k + t];
  }
  return fail;
}

// Solve A x = x in place from the factor: the row swaps interleaved with
// forward substitution, then back substitution.
template <typename T, int N, int MU, int ML>
__device__ __forceinline__ void band_solve_dev(const T (&ab)[2 * ML + MU + 1][N],
                                               const int (&piv)[N], T (&x)[N]) {
  constexpr int SMU = MU + ML;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int d = piv[k];
    const T vk = x[k];
    T vd = vk;
#pragma unroll
    for (int i = 1; i <= ML; ++i)
      if (k + i < N) vd = (d == i) ? x[k + i] : vd;
    const T new_k = vk + (vd - vk);
    const T dn = vd + (vk - vd);
#pragma unroll
    for (int i = 1; i <= ML; ++i)
      if (k + i < N) x[k + i] = (d == i) ? dn : x[k + i];
    x[k] = new_k;
#pragma unroll
    for (int i = 1; i <= ML; ++i)
      if (k + i < N) x[k + i] = x[k + i] + (-ab[SMU + i][k]) * new_k;
  }
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    if constexpr (SMU > 0) {
      T terms[SMU];
#pragma unroll
      for (int t = 1; t <= SMU; ++t)
        terms[t - 1] = (k + t < N) ? ab[SMU - t][k + t] * x[k + t] : T(0);
      x[k] = (x[k] - sum0_of<T, SMU>(terms, SMU)) / ab[SMU][k];
    } else {
      x[k] = (x[k] - T(0)) / ab[SMU][k];
    }
  }
}

}  // namespace ida
