// Batched small-N dense LU factor and solve for Hopper (sm_90a), one thread
// per system, batch-last layout, and the transposed solve A^T lam = g from
// the same packed factors (the backward of the solve under autograd).
//
// Replaces ida_tpu/ops/pallas_lu.py::_lu_solve_kernel (the Pallas TPU
// kernel behind pallas_lu_solve). Unlike that kernel, factor and solve are
// separate launches: the solver factors once per lsetup, keeps lu/piv in
// its state, and solves once per Newton iteration. The arithmetic lives in
// small_lu.cuh (shared with the whole-solve kernel, fused_solve.cu) and
// follows the reference's parity path, ida_tpu/ops/dense_lu.py
// lu_factor_unrolled / lu_solve_unrolled, NOT the Pallas body's row-oriented
// back substitution. Build with -fmad=false so no multiply-add is
// contracted: the results then equal the plain PyTorch version bit for bit.
//
// What bounds it: bytes. At N = 3 the factor reads 9 values and writes 13
// (lu, piv, fail) per lane for a few dozen flops; the solve reads 15 and
// writes 3. The design answers that with coalesced loads and stores (element
// (i, j) of consecutive lanes sits at consecutive addresses), no shared
// memory, and the matrix in registers (N is a template parameter, every loop
// is unrolled, pivoting is by selects, so nothing is indexed dynamically).
// At large N the factor's N*N registers spill; that is accepted here.
//
// The transposed solve (small_lu_solve_t) has no TPU counterpart: no Pallas
// kernel of ida_tpu has a backward (its gradient differentiates the jnp
// arithmetic of lu_solve_unrolled). It is the same shape of work as the
// solve, so it has the same design; it reads lu, piv and g (132 bytes a lane
// at N = 3 in f64, with lam written) and is bound by those bytes.
//
// Layouts (B lanes): a, lu [N, N, B]; piv [N, B] int32; fail [B] int32;
// rhs, x, g, lam [N, B]. Each entry point returns cudaGetLastError() after launching
// on the given stream; it allocates nothing and does not synchronize.

#include <cuda_runtime.h>

#include "small_lu.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
factor_kernel(const T* __restrict__ a, T* __restrict__ lu, int* __restrict__ piv,
              int* __restrict__ fail, long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  T m[N][N];
  int p[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) m[i][j] = a[(long long)(i * N + j) * B + b];

  const int failc = ida::lu_factor_dev<T, N>(m, p);

#pragma unroll
  for (int k = 0; k < N; ++k) piv[(long long)k * B + b] = p[k];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) lu[(long long)(i * N + j) * B + b] = m[i][j];
  fail[b] = failc;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
solve_kernel(const T* __restrict__ lu, const int* __restrict__ piv,
             const T* __restrict__ rhs, T* __restrict__ x, long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  T m[N][N];
  int p[N];
  T v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = rhs[(long long)i * B + b];
    p[i] = piv[(long long)i * B + b];
#pragma unroll
    for (int j = 0; j < N; ++j) m[i][j] = lu[(long long)(i * N + j) * B + b];
  }

  ida::lu_solve_dev<T, N>(m, p, v);

#pragma unroll
  for (int i = 0; i < N; ++i) x[(long long)i * B + b] = v[i];
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
solve_t_kernel(const T* __restrict__ lu, const int* __restrict__ piv,
               const T* __restrict__ g, T* __restrict__ lam, long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  T m[N][N];
  int p[N];
  T v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = g[(long long)i * B + b];
    p[i] = piv[(long long)i * B + b];
#pragma unroll
    for (int j = 0; j < N; ++j) m[i][j] = lu[(long long)(i * N + j) * B + b];
  }

  ida::lu_solve_t_dev<T, N>(m, p, v);

#pragma unroll
  for (int i = 0; i < N; ++i) lam[(long long)i * B + b] = v[i];
}

inline unsigned grid_for(long long B) { return (unsigned)((B + kThreads - 1) / kThreads); }

template <typename T>
int factor(const void* a, void* lu, void* piv, void* fail, int n, long long B, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const T* pa = (const T*)a;
  T* plu = (T*)lu;
  int* pp = (int*)piv;
  int* pf = (int*)fail;
  switch (n) {
#define IDA_CASE(NN) \
  case NN: factor_kernel<T, NN><<<grid_for(B), kThreads, 0, s>>>(pa, plu, pp, pf, B); break;
    IDA_CASE(1) IDA_CASE(2) IDA_CASE(3) IDA_CASE(4) IDA_CASE(5) IDA_CASE(6) IDA_CASE(7)
    IDA_CASE(8) IDA_CASE(9) IDA_CASE(10) IDA_CASE(11) IDA_CASE(12) IDA_CASE(13)
    IDA_CASE(14) IDA_CASE(15) IDA_CASE(16)
#undef IDA_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int solve(const void* lu, const void* piv, const void* rhs, void* x, int n, long long B,
          void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const T* plu = (const T*)lu;
  const int* pp = (const int*)piv;
  const T* pr = (const T*)rhs;
  T* px = (T*)x;
  switch (n) {
#define IDA_CASE(NN) \
  case NN: solve_kernel<T, NN><<<grid_for(B), kThreads, 0, s>>>(plu, pp, pr, px, B); break;
    IDA_CASE(1) IDA_CASE(2) IDA_CASE(3) IDA_CASE(4) IDA_CASE(5) IDA_CASE(6) IDA_CASE(7)
    IDA_CASE(8) IDA_CASE(9) IDA_CASE(10) IDA_CASE(11) IDA_CASE(12) IDA_CASE(13)
    IDA_CASE(14) IDA_CASE(15) IDA_CASE(16)
#undef IDA_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int solve_t(const void* lu, const void* piv, const void* g, void* lam, int n, long long B,
            void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const T* plu = (const T*)lu;
  const int* pp = (const int*)piv;
  const T* pg = (const T*)g;
  T* pl = (T*)lam;
  switch (n) {
#define IDA_CASE(NN) \
  case NN: solve_t_kernel<T, NN><<<grid_for(B), kThreads, 0, s>>>(plu, pp, pg, pl, B); break;
    IDA_CASE(1) IDA_CASE(2) IDA_CASE(3) IDA_CASE(4) IDA_CASE(5) IDA_CASE(6) IDA_CASE(7)
    IDA_CASE(8) IDA_CASE(9) IDA_CASE(10) IDA_CASE(11) IDA_CASE(12) IDA_CASE(13)
    IDA_CASE(14) IDA_CASE(15) IDA_CASE(16)
#undef IDA_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int small_lu_factor_f64(const void* a, void* lu, void* piv, void* fail, int n, long long B,
                        void* stream) {
  return factor<double>(a, lu, piv, fail, n, B, stream);
}

int small_lu_factor_f32(const void* a, void* lu, void* piv, void* fail, int n, long long B,
                        void* stream) {
  return factor<float>(a, lu, piv, fail, n, B, stream);
}

int small_lu_solve_f64(const void* lu, const void* piv, const void* rhs, void* x, int n,
                       long long B, void* stream) {
  return solve<double>(lu, piv, rhs, x, n, B, stream);
}

int small_lu_solve_f32(const void* lu, const void* piv, const void* rhs, void* x, int n,
                       long long B, void* stream) {
  return solve<float>(lu, piv, rhs, x, n, B, stream);
}

int small_lu_solve_t_f64(const void* lu, const void* piv, const void* g, void* lam, int n,
                         long long B, void* stream) {
  return solve_t<double>(lu, piv, g, lam, n, B, stream);
}

int small_lu_solve_t_f32(const void* lu, const void* piv, const void* g, void* lam, int n,
                         long long B, void* stream) {
  return solve_t<float>(lu, piv, g, lam, n, B, stream);
}

}  // extern "C"
