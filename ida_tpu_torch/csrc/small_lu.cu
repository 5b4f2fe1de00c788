// Batched small-N dense LU factor and solve for Hopper (sm_90a), and the
// transposed solve A^T lam = g from the same packed factors (the backward of
// the solve under autograd).
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
// The factor keeps its first skeleton: one thread a lane, 128-thread blocks,
// batch-last contiguous [N, N, B] (a, lu), [N, B] (piv), [B] (fail). At N = 3
// it reads 9 values and writes 13 a lane for a few dozen flops: bound by
// bytes, met with coalesced loads and the matrix in registers (N is a
// template parameter, every loop is unrolled, pivoting is by selects).
//
// The solves (solve_kernel, solve_t_kernel) share a second skeleton. What
// bounds them: bytes, plus a fixed cost a launch. A solve reads lu, piv and
// the right-hand side once and writes x once, N*N + 2N values a lane for
// about N*N flops. On the foodweb preconditioner (N = 2, [2, 2, 400, 128],
// 3.7 MB, a 1.1 us bytes bound) a launch's ramp, one DRAM round trip and its
// drain cost about as much as the bytes do, so the skeleton is built to put
// every load of a launch in flight at once:
//
// - Lanes read by strides. Every operand is addressed by its element strides
//   (lu (i, j), piv i, rhs i, x i) and a lane index of two levels: `outer`
//   rows, each with its own stride per operand, of `inner` lanes that sit
//   at consecutive addresses in every operand (LuSolveLayout, worked out
//   from the tensors' strides by ops/small_lu.py::solve_layout). Batch-last
//   contiguous [N, N, B] is outer = 1, inner = B; foodweb's pdata
//   (lu [npts, 2, 2, B], piv [npts, 2, B]) and right-hand side
//   ([npts * 2, B]) are outer = npts, inner = B; one lane (B = 1) is
//   inner = 1. The caller's layout is read as it lies, and x is written in
//   the right-hand side's layout, so no copy surrounds a launch.
// - Wide accesses. Where pairs of lanes tile every row (inner, every
//   stride and every base pointer allow them: the layout's `vector` flag)
//   and N <= 4, a thread takes two consecutive lanes and moves each element
//   of them with one access: 16 bytes (double2) in f64, 8 (float2) in f32,
//   8 (int2) for piv. Four f32 lanes a thread (float4) made ptxas spill the
//   N = 3 solve. Otherwise one lane a thread: above N = 4 the matrices of
//   two lanes cost registers the short rows do not repay, and where the
//   pairs do not tile the rows (an odd B) a stride leaves every other
//   lane's element unaligned, so the whole launch reads lane by lane (x,
//   from empty_like, is dense: strides that allow the pairs come with rows
//   they fill).
// - The grid: one thread a group, one pass, blocks of IDA_LU_THREADS (256)
//   threads for pairs and of the first skeleton's 128 for one lane a thread
//   (256 gained nothing there and made ptxas spill the f32 N = 13
//   transposed solve 4x more), every load of a thread issued before its
//   arithmetic.
//
// Which candidate won, paired in one call on an H100 80GB HBM3 at 700 W
// (tools/kernel_variants.py k1, cold device times, two rounds each, four
// calls; PERF.md has them all): pairs of lanes in one pass of 256-thread
// blocks. The N = 2 foodweb solve took 0.00269-0.00273 ms on each of its
// three layouts against the first skeleton's 0.00294-0.00308 ms (-9%);
// pairs in 128-thread blocks 0.00277-0.00281 ms, pairs on a grid sized to
// the SMs (1 or 2 blocks for each of the 132, threads spread evenly)
// 0.00275-0.00286 ms, one lane a thread in 256-thread blocks
// 0.00294-0.00299 ms. At N = 3 (B = 65,536): 0.00424-0.00428 ms against
// 0.00450-0.00458 ms (the transposed solve 0.00415-0.00423 against
// 0.00454-0.00460). The SM-sized grid won only at N = 6 on 1,024 lanes
// (0.00502 against 0.00516 ms, one launch a call) and was dropped. A copy
// of the same N = 2 bytes in this skeleton took 0.00275-0.00290 ms and an
// empty launch on its grid 0.00086-0.00089 ms: the solve sits at the floor
// of its bytes on this card, at ~41% of its bytes bound.
// `-DIDA_LU_VEC=0` rebuilds the first skeleton (one lane a thread,
// 128-thread blocks, scalar accesses) over the strided addressing, which is
// what the tool times it as.
//
// What does not apply: each byte is read once and no lane shares data with
// another, so there is nothing to stage in shared memory; there is no
// product for wgmma; a TMA tile brings nothing that coalesced wide loads do
// not, and its descriptor would cost host work for every layout.
//
// The transposed solve (small_lu_solve_t) has no TPU counterpart: no Pallas
// kernel of ida_tpu has a backward (its gradient differentiates the jnp
// arithmetic of lu_solve_unrolled). It reads the same bytes as the solve.
//
// Each entry point returns cudaGetLastError() after launching on the given
// stream; it allocates nothing and does not synchronize. Built with
// -DIDA_LU_FLOOR (tools/kernel_variants.py only), the library also holds
// small_lu_copy_* (the solve's skeleton moving the same bytes with no
// arithmetic) and small_lu_empty (a launch that does nothing): the floor any
// kernel of those bytes meets on the card.

#include <cuda_runtime.h>

#include "small_lu.cuh"

#ifndef IDA_LU_VEC
#define IDA_LU_VEC 1
#endif
#ifndef IDA_LU_THREADS
#define IDA_LU_THREADS 256  // a block of threads that take pairs of lanes
#endif

// Operand addressing of a solve (ops/small_lu.py::SolveLayout mirrors it).
struct LuSolveLayout {
  long long outer, inner;  // lanes = outer * inner
  long long lu_i, lu_j, lu_o;
  long long piv_i, piv_o;
  long long b_i, b_o;
  long long x_i, x_o;
  int vector;  // pairs of lanes tile every row: inner, every stride and
               // every base pointer allow them
};

namespace {

constexpr int kFactorThreads = 128;
// a solve's block: IDA_LU_THREADS threads for pairs of lanes, the first
// skeleton's 128 for one lane a thread
template <int V>
constexpr int kSolveThreads = V == 1 ? 128 : IDA_LU_THREADS;

template <typename T, int N>
__global__ void __launch_bounds__(kFactorThreads)
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

// V consecutive lanes of one element, moved by one access.
template <typename T, int V>
struct Lanes;

template <typename T>
struct Lanes<T, 1> {
  static __device__ __forceinline__ void load(const T* p, T (&o)[1]) { o[0] = *p; }
  static __device__ __forceinline__ void store(T* p, const T (&v)[1]) { *p = v[0]; }
};

template <>
struct Lanes<double, 2> {
  static __device__ __forceinline__ void load(const double* p, double (&o)[2]) {
    const double2 d = *reinterpret_cast<const double2*>(p);
    o[0] = d.x;
    o[1] = d.y;
  }
  static __device__ __forceinline__ void store(double* p, const double (&v)[2]) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};

template <>
struct Lanes<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float (&o)[2]) {
    const float2 d = *reinterpret_cast<const float2*>(p);
    o[0] = d.x;
    o[1] = d.y;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};

template <>
struct Lanes<int, 2> {
  static __device__ __forceinline__ void load(const int* p, int (&o)[2]) {
    const int2 d = *reinterpret_cast<const int2*>(p);
    o[0] = d.x;
    o[1] = d.y;
  }
};

enum class Op { kSolve, kSolveT, kCopy };

// One group of V (1 or 2) lanes of a row: load lu, piv and the right-hand side,
// solve each lane in registers (small_lu.cuh), store x. kCopy moves the
// same bytes with no arithmetic: each x is the right-hand side's value,
// kept only where a select over every loaded lu and piv value says so, so
// that no load can be dropped.
template <typename T, int N, int V, Op kOp>
__device__ __forceinline__ void solve_group(const T* __restrict__ lu, const int* __restrict__ piv,
                                            const T* __restrict__ b, T* __restrict__ x,
                                            const LuSolveLayout& L, long long o, long long q) {
  T m[V][N][N];
  int p[V][N];
  T v[V][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T t[V];
    int s[V];
    Lanes<T, V>::load(b + o * L.b_o + i * L.b_i + q, t);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k][i] = t[k];
    Lanes<int, V>::load(piv + o * L.piv_o + i * L.piv_i + q, s);
#pragma unroll
    for (int k = 0; k < V; ++k) p[k][i] = s[k];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      Lanes<T, V>::load(lu + o * L.lu_o + i * L.lu_i + j * L.lu_j + q, t);
#pragma unroll
      for (int k = 0; k < V; ++k) m[k][i][j] = t[k];
    }
  }

#pragma unroll
  for (int k = 0; k < V; ++k) {
    if constexpr (kOp == Op::kSolve) {
      ida::lu_solve_dev<T, N>(m[k], p[k], v[k]);
    } else if constexpr (kOp == Op::kSolveT) {
      ida::lu_solve_t_dev<T, N>(m[k], p[k], v[k]);
    } else {
      bool odd = false;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        odd = odd | (p[k][i] < 0);
#pragma unroll
        for (int j = 0; j < N; ++j) odd = odd | (m[k][i][j] == v[k][0]);
      }
#pragma unroll
      for (int i = 0; i < N; ++i) v[k][i] = odd ? m[k][i][0] : v[k][i];
    }
  }

#pragma unroll
  for (int i = 0; i < N; ++i) {
    T t[V];
#pragma unroll
    for (int k = 0; k < V; ++k) t[k] = v[k][i];
    Lanes<T, V>::store(x + o * L.x_o + i * L.x_i + q, t);
  }
}

// Thread `it` takes the group (row it / groups, group it % groups).
template <typename T, int N, int V, Op kOp>
__device__ __forceinline__ void solve_lanes(const T* __restrict__ lu, const int* __restrict__ piv,
                                            const T* __restrict__ b, T* __restrict__ x,
                                            const LuSolveLayout& L, unsigned groups,
                                            unsigned items) {
  const unsigned it = blockIdx.x * blockDim.x + threadIdx.x;
  if (it >= items) return;
  const unsigned o = it / groups;
  solve_group<T, N, V, kOp>(lu, piv, b, x, L, o, (long long)(it - o * groups) * V);
}

template <typename T, int N, int V>
__global__ void __launch_bounds__(kSolveThreads<V>)
solve_kernel(const T* __restrict__ lu, const int* __restrict__ piv, const T* __restrict__ rhs,
             T* __restrict__ x, const LuSolveLayout L, unsigned groups, unsigned items) {
  solve_lanes<T, N, V, Op::kSolve>(lu, piv, rhs, x, L, groups, items);
}

template <typename T, int N, int V>
__global__ void __launch_bounds__(kSolveThreads<V>)
solve_t_kernel(const T* __restrict__ lu, const int* __restrict__ piv, const T* __restrict__ g,
               T* __restrict__ lam, const LuSolveLayout L, unsigned groups, unsigned items) {
  solve_lanes<T, N, V, Op::kSolveT>(lu, piv, g, lam, L, groups, items);
}

#ifdef IDA_LU_FLOOR
template <typename T, int N, int V>
__global__ void __launch_bounds__(kSolveThreads<V>)
copy_kernel(const T* __restrict__ lu, const int* __restrict__ piv, const T* __restrict__ rhs,
            T* __restrict__ x, const LuSolveLayout L, unsigned groups, unsigned items) {
  solve_lanes<T, N, V, Op::kCopy>(lu, piv, rhs, x, L, groups, items);
}

__global__ void empty_kernel() {}
#endif

inline unsigned grid_for(long long B) {
  return (unsigned)((B + kFactorThreads - 1) / kFactorThreads);
}

inline unsigned blocks_for(unsigned items, unsigned threads) {
  return (items + threads - 1) / threads;
}

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
  case NN: factor_kernel<T, NN><<<grid_for(B), kFactorThreads, 0, s>>>(pa, plu, pp, pf, B); break;
    IDA_CASE(1) IDA_CASE(2) IDA_CASE(3) IDA_CASE(4) IDA_CASE(5) IDA_CASE(6) IDA_CASE(7)
    IDA_CASE(8) IDA_CASE(9) IDA_CASE(10) IDA_CASE(11) IDA_CASE(12) IDA_CASE(13)
    IDA_CASE(14) IDA_CASE(15) IDA_CASE(16)
#undef IDA_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// lanes a thread moves by one access, up to this N
constexpr int kPair = 2;
constexpr int kPairMaxN = 4;

template <typename T, int N, int V, Op kOp>
void launch_solve(const T* lu, const int* piv, const T* b, T* x, const LuSolveLayout& L,
                  cudaStream_t s) {
  const long long groups = L.inner / V;
  const unsigned items = (unsigned)(L.outer * groups);
  constexpr unsigned threads = kSolveThreads<V>;
  const unsigned blocks = blocks_for(items, threads);
  if constexpr (kOp == Op::kSolve) {
    solve_kernel<T, N, V><<<blocks, threads, 0, s>>>(lu, piv, b, x, L, (unsigned)groups, items);
  } else if constexpr (kOp == Op::kSolveT) {
    solve_t_kernel<T, N, V><<<blocks, threads, 0, s>>>(lu, piv, b, x, L, (unsigned)groups, items);
  } else {
#ifdef IDA_LU_FLOOR
    copy_kernel<T, N, V><<<blocks, threads, 0, s>>>(lu, piv, b, x, L, (unsigned)groups, items);
#endif
  }
}

template <typename T, int N, Op kOp>
void launch_n(const T* lu, const int* piv, const T* b, T* x, const LuSolveLayout& L,
              cudaStream_t s) {
  if constexpr (IDA_LU_VEC && N <= kPairMaxN) {
    if (L.vector) {
      launch_solve<T, N, kPair, kOp>(lu, piv, b, x, L, s);
      return;
    }
  }
  launch_solve<T, N, 1, kOp>(lu, piv, b, x, L, s);
}

// The caller (ops/small_lu.py) keeps outer * inner below 2^31.
template <typename T, Op kOp>
int solve(const void* lu, const void* piv, const void* rhs, void* x, int n,
          const LuSolveLayout* layout, void* stream) {
  const LuSolveLayout L = *layout;
  if (L.outer <= 0 || L.inner <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const T* plu = (const T*)lu;
  const int* pp = (const int*)piv;
  const T* pr = (const T*)rhs;
  T* px = (T*)x;
  switch (n) {
#define IDA_CASE(NN) \
  case NN: launch_n<T, NN, kOp>(plu, pp, pr, px, L, s); break;
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
                       const LuSolveLayout* layout, void* stream) {
  return solve<double, Op::kSolve>(lu, piv, rhs, x, n, layout, stream);
}

int small_lu_solve_f32(const void* lu, const void* piv, const void* rhs, void* x, int n,
                       const LuSolveLayout* layout, void* stream) {
  return solve<float, Op::kSolve>(lu, piv, rhs, x, n, layout, stream);
}

int small_lu_solve_t_f64(const void* lu, const void* piv, const void* g, void* lam, int n,
                         const LuSolveLayout* layout, void* stream) {
  return solve<double, Op::kSolveT>(lu, piv, g, lam, n, layout, stream);
}

int small_lu_solve_t_f32(const void* lu, const void* piv, const void* g, void* lam, int n,
                         const LuSolveLayout* layout, void* stream) {
  return solve<float, Op::kSolveT>(lu, piv, g, lam, n, layout, stream);
}

#ifdef IDA_LU_FLOOR
int small_lu_copy_f64(const void* lu, const void* piv, const void* rhs, void* x, int n,
                      const LuSolveLayout* layout, void* stream) {
  return solve<double, Op::kCopy>(lu, piv, rhs, x, n, layout, stream);
}

int small_lu_copy_f32(const void* lu, const void* piv, const void* rhs, void* x, int n,
                      const LuSolveLayout* layout, void* stream) {
  return solve<float, Op::kCopy>(lu, piv, rhs, x, n, layout, stream);
}

// an empty kernel on the grid the solve of this layout launches (f64)
int small_lu_empty(const LuSolveLayout* layout, void* stream) {
  const bool pairs = layout->vector && IDA_LU_VEC;
  const unsigned threads = pairs ? kSolveThreads<kPair> : kSolveThreads<1>;
  const unsigned blocks =
      blocks_for((unsigned)(layout->outer * (layout->inner / (pairs ? kPair : 1))), threads);
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
