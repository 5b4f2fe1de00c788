// Small-N dense LU factor and solve for one system held by one thread: the
// device code shared by the batched kernels of small_lu.cu and by the
// whole-solve kernel of fused_solve.cu (its Newton iteration).
//
// The order of operations is the reference's parity path,
// ida_tpu/ops/dense_lu.py lu_factor_unrolled / lu_solve_unrolled (and the
// port's ida_tpu_torch/ops/dense_lu.py): first-max pivot on strict '>',
// multiplier 1/pivot with a zero pivot replaced by 1 and its column recorded,
// column-oriented back substitution. No multiply-add may be contracted, so
// that the results equal the plain PyTorch version bit for bit: small_lu.cu
// instantiates T as double or float and is built with -fmad=false;
// fused_solve.cu, built -fmad=true, instantiates T as ida::Real (rounded.cuh),
// whose operators are the never-contracted intrinsics. N is a template
// parameter and every loop is unrolled, and pivoting is by selects, so the
// matrix stays in registers where the caller keeps it there.

#pragma once

#include "rounded.cuh"

namespace ida {

// Factor m in place (PA = LU packed SUNDIALS-style); piv[k] is the row
// swapped with row k at step k. Returns 0, or the 1-based column of the first
// zero pivot.
template <typename T, int N>
__device__ __forceinline__ int lu_factor_dev(T (&m)[N][N], int (&piv)[N]) {
  int failc = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    // pivot row: first occurrence of max |m[i][k]| for i >= k
    T best = absval(m[k][k]);
    int l = k;
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const T cand = absval(m[i][k]);
      const bool take = cand > best;
      best = take ? cand : best;
      l = take ? i : l;
    }
    piv[k] = l;

    // swap rows k and l by selects
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T mkj = m[k][j];
      T mlj = mkj;
#pragma unroll
      for (int i = k + 1; i < N; ++i) mlj = (l == i) ? m[i][j] : mlj;
      m[k][j] = mlj;
#pragma unroll
      for (int i = k + 1; i < N; ++i) m[i][j] = (l == i) ? mkj : m[i][j];
    }

    const T p = m[k][k];
    const bool zero = p == T(0);
    failc = (failc == 0 && zero) ? k + 1 : failc;
    const T mult = T(1) / (zero ? T(1) : p);
#pragma unroll
    for (int i = k + 1; i < N; ++i) m[i][k] = m[i][k] * mult;
#pragma unroll
    for (int j = k + 1; j < N; ++j) {
      const T mkj = m[k][j];
#pragma unroll
      for (int i = k + 1; i < N; ++i) m[i][j] = m[i][j] - mkj * m[i][k];
    }
  }
  return failc;
}

// Solve A x = v in place from a factorization.
template <typename T, int N>
__device__ __forceinline__ void lu_solve_dev(const T (&lu)[N][N], const int (&piv)[N], T (&v)[N]) {
  // permute by the pivot sequence
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int pk = piv[k];
    const T vk = v[k];
    T vpk = vk;
#pragma unroll
    for (int i = k + 1; i < N; ++i) vpk = (pk == i) ? v[i] : vpk;
    v[k] = vpk;
#pragma unroll
    for (int i = k + 1; i < N; ++i) v[i] = (pk == i) ? vk : v[i];
  }

  // forward substitution, unit lower triangle
#pragma unroll
  for (int k = 0; k < N - 1; ++k)
#pragma unroll
    for (int i = k + 1; i < N; ++i) v[i] = v[i] - lu[i][k] * v[k];

  // back substitution, column-oriented
#pragma unroll
  for (int k = N - 1; k > 0; --k) {
    v[k] = v[k] / lu[k][k];
#pragma unroll
    for (int i = 0; i < k; ++i) v[i] = v[i] - lu[i][k] * v[k];
  }
  v[0] = v[0] / lu[0][0];
}

// Solve A^T v = g in place from the factorization of A (PA = LU, so
// A^T = U^T L^T P): forward substitution with U^T, back substitution with the
// unit L^T, both column-oriented, then the pivot sequence undone from the
// last swap to the first. The order of operations is
// ida_tpu_torch/ops/dense_lu.py lu_solve_unrolled_t.
template <typename T, int N>
__device__ __forceinline__ void lu_solve_t_dev(const T (&lu)[N][N], const int (&piv)[N], T (&v)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    v[k] = v[k] / lu[k][k];
#pragma unroll
    for (int i = k + 1; i < N; ++i) v[i] = v[i] - lu[k][i] * v[k];
  }

#pragma unroll
  for (int k = N - 1; k > 0; --k)
#pragma unroll
    for (int i = 0; i < k; ++i) v[i] = v[i] - lu[k][i] * v[k];

#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    const int pk = piv[k];
    const T vk = v[k];
    T vpk = vk;
#pragma unroll
    for (int i = k + 1; i < N; ++i) vpk = (pk == i) ? v[i] : vpk;
    v[k] = vpk;
#pragma unroll
    for (int i = k + 1; i < N; ++i) v[i] = (pk == i) ? vk : v[i];
  }
}

}  // namespace ida
