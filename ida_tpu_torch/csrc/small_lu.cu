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
// Two skeletons, and a rule between them (kGroupRule, below).
//
// One thread a lane: the factor's first skeleton, 128-thread blocks,
// batch-last contiguous [N, N, B] (a, lu), [N, B] (piv), [B] (fail). At N = 3
// it reads 9 values and writes 13 a lane for a few dozen flops: bound by
// bytes, met with coalesced loads and the matrix in registers (N is a
// template parameter, every loop is unrolled, pivoting is by selects). The
// solves' skeleton, below, is its kin. Where lanes are many it is at the
// floor of its bytes; where they are few, one thread runs the whole serial
// chain (at N = 10 in f64: 333 multiplies, 329 adds and 1,890 FSELs, two
// a select of a double, in 3,576 instructions, 254 registers), and above
// N = 10 in f64 (N = 13 in f32) the matrix no longer fits in registers: the
// f64 factor spills 372 B at N = 11 and 12,756 B at N = 16.
//
// One system per group of G threads (G the power of two >= N, 32 / G
// systems a warp, 128-thread blocks): the factor takes a column a thread,
// the solve a row a thread, every operand broadcast by a shuffle, and each
// element sees lu_factor_dev's / lu_solve_dev's operations in their order
// (factor_cols and solve_rows say how). The factor's pivot search is a tree
// in the pivot column's own thread, so a column's chain is the search, one
// division, one multiply, one broadcast and the update; the solve's is one
// broadcast and a multiply-subtract a column (a division too, going back).
// Every collective takes the whole warp: a mask of the group's own lanes
// made the compiler issue each collective once per distinct mask in the
// warp (a first, row-a-thread factor at N = 2 took 3.8 us on 32 lanes
// against 1.49 on one), and a dead group (past the last system) stays in
// its warp, solving the identity for ones, because CUDA's division takes a
// slow path on a zero dividend or divisor (the N = 10 solve of one lane
// took 4.60 us with zeros there, 2.92 with ones).
//
// The rule (kGroupRule): the factor or the solve takes the groups from a
// least N, over a range of lanes; elsewhere one thread a lane. The
// thresholds lie inside the cells where the groups won in `k1 --sweep`
// (tools/kernel_variants.py: N = 1..16 x 1, 32, 1,024, 8,192 and 65,536
// lanes x f64, f32, the two skeletons in turns, an H100 80GB HBM3 at 700 W;
// k1_rule reads each (kernel, dtype, N)'s winning run of lane counts off
// it). What it says, f64 (device us, parent -> groups):
// - the factor: from N = 9 up to 1,024 lanes (N = 10 one lane 4.83 ->
//   3.80, N = 11 7.83 -> 3.90), and from N = 13 at every count (N = 16:
//   51.0 -> 6.4 on one lane, 612 -> 252 on 65,536: the one-thread factor
//   spills); never at N <= 6, where one thread's chain is short (N = 6:
//   2.02 -> 2.47 on one lane) and the groups' stores are half-filled
//   sectors;
// - the solve: from N = 6 on 1 to 8,192 lanes (N = 10 one lane 3.37 ->
//   2.92, N = 6 on 8,192 6.09 -> 4.06); never at 65,536 lanes, where one
//   thread a lane reads its operands in wider runs (N = 10: 28.2 against
//   45.3).
// In f32 the factor takes them from N = 10 up to 1,024 lanes, the solve
// from N = 5 on 32 to 8,192 lanes (on one lane the groups lost at N = 5..7
// and 9..10).
// Cells the sweep also won, by a fraction of a microsecond L2-warm, that the
// rule leaves to one thread a lane: the f64 solve at N = 2..5 from 32 or
// 1,024 lanes (N = 3 on 1,024: 1.94 -> 1.73; the adjoints' N = 3 solves on
// 1,024 and 4,096 lanes are such cells, never timed cold on their paths),
// the f64 factor at N = 7 and 8 on 1,024 lanes and at N = 12 on 8,192, the
// f32 factor at N = 8 and 16 on some counts, the f32 solve at N = 8 and
// N >= 11 on one lane. The headline (N = 3, 65,536 lanes) and foodweb
// (N = 2, 51,200 lanes) keep one thread a lane. `-DIDA_LU_GROUP=0`
// rebuilds the parent's dispatch (one thread a lane everywhere), `=2` puts
// every factor and solve on the groups: tools/kernel_variants.py times them
// against each other.
//
// The one-thread solves (solve_kernel, solve_t_kernel) share a skeleton. What
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
// -DIDA_LU_FLOOR (tools/kernel_variants.py and chip_smoke.py only), the
// library also holds small_lu_copy_* and small_lu_factor_copy_* (the
// solve's and the factor's skeleton, as the build's rule picks it, moving
// the same bytes with no arithmetic) and small_lu_empty /
// small_lu_factor_empty (a launch that does nothing on the same grid): the
// floor any kernel of those bytes meets on the card.

#include <cuda_runtime.h>

#include "small_lu.cuh"

#ifndef IDA_LU_VEC
#define IDA_LU_VEC 1
#endif
#ifndef IDA_LU_THREADS
#define IDA_LU_THREADS 256  // a block of threads that take pairs of lanes
#endif
// Which skeleton the factor and the solve take: 0 one thread a lane
// everywhere (the skeletons before the groups), 1 by kGroupRule below, 2
// groups everywhere. 0 and 2 exist for tools/kernel_variants.py.
#ifndef IDA_LU_GROUP
#define IDA_LU_GROUP 1
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
__device__ __forceinline__ void solve_v_lanes(const T* __restrict__ lu, const int* __restrict__ piv,
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
  solve_v_lanes<T, N, V, kOp>(lu, piv, b, x, L, o, (long long)(it - o * groups) * V);
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


// ------------------------------------------------- the group skeleton

// One system per group of G threads, G the power of two >= N. G divides 32,
// so a group lies in one warp. Every collective takes the whole warp (a
// full mask, the group as the shuffle's width): a group whose system lies
// past the last stays in its warp as a dead group (no loads, no stores),
// and only a warp whose groups are all past the last leaves at once. (A
// mask of the group's own lanes makes the compiler issue each collective
// once per distinct mask in the warp: 16 times at N = 2.)
constexpr int kGroupThreads = 128;

template <int N>
constexpr int kGroup = N <= 1 ? 1 : N <= 2 ? 2 : N <= 4 ? 4 : N <= 8 ? 8 : 16;

template <int G>
struct Team {
  int r;  // this thread's rank in its group

  __device__ __forceinline__ Team() : r((int)(threadIdx.x & 31u) & (G - 1)) {}
  template <typename V>
  __device__ __forceinline__ V from(V v, int rank) const {
    return __shfl_sync(0xffffffffu, v, rank, G);
  }
};

// The system of this thread's group, and whether it exists; false when the
// whole warp lies past the last system (the warp leaves).
template <int N>
__device__ __forceinline__ bool group_system(long long lanes, long long& s, bool& live) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  s = t / kGroup<N>;
  live = s < lanes;
  return (t - (t & 31)) / kGroup<N> < lanes;
}

// The factor of one system by its group, one column a thread: rank j loads
// column j (ranks >= N and dead groups hold zeros and store nothing). At
// each column k, rank k searches its column for the pivot: the first
// maximum of |m[i][k]| over i > k on a strict '>' (a NaN never taken),
// kept only where it beats |m[k][k]| (a NaN there keeps k) -- by a tree of
// pairs that keeps the lower row on a tie, which gives the serial scan's
// answer. Rank k broadcasts the row and the pivot; every rank swaps the two
// rows in its own column by lu_factor_dev's selects; rank k scales its
// column by 1/p and broadcasts each multiplier; ranks j > k update their
// column. Every element sees lu_factor_dev's operations in its order. The
// chain of a column is the search, the division, one multiply, one
// broadcast and the update: no collective inside the search.
template <typename T, int N, bool kCopy>
__device__ __forceinline__ void factor_cols(const T* __restrict__ a, T* __restrict__ lu,
                                            int* __restrict__ piv, int* __restrict__ fail,
                                            long long B, long long b, bool live,
                                            const Team<kGroup<N>>& team) {
  const int j = team.r;
  const bool real = live && j < N;
  T col[N];
#pragma unroll
  for (int i = 0; i < N; ++i) col[i] = real ? a[(long long)(i * N + j) * B + b] : T(0);

  int my_piv = j, failc = 0;
  if constexpr (kCopy) {
    // the same bytes, no arithmetic: each column kept where a select over
    // its loaded values says so, so that no load can be dropped
    bool odd = false;
#pragma unroll
    for (int i = 0; i < N; ++i) odd = odd | (col[i] == T(-7));
    failc = odd ? 1 : 0;
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      int l_own = k;
      T p_own = col[k];
      if (k + 1 < N) {
        T mag[N], val[N];
        int row[N];
#pragma unroll
        for (int c = 0; c < N - 1 - k; ++c) {
          const T m = ida::absval(col[k + 1 + c]);
          mag[c] = m != m ? T(-1) : m;
          val[c] = col[k + 1 + c];
          row[c] = k + 1 + c;
        }
#pragma unroll
        for (int level = 0; level < 4; ++level) {  // 15 candidates at most
          const int w = 1 << level;
#pragma unroll
          for (int c = 0; c + w < N - 1 - k; c += 2 * w) {
            const bool take = mag[c + w] > mag[c];
            mag[c] = take ? mag[c + w] : mag[c];
            val[c] = take ? val[c + w] : val[c];
            row[c] = take ? row[c + w] : row[c];
          }
        }
        const bool beat = mag[0] > ida::absval(col[k]);
        l_own = beat ? row[0] : k;
        p_own = beat ? val[0] : col[k];
      }
      const int l = team.from(l_own, k);
      const T p = team.from(p_own, k);
      my_piv = j == k ? l : my_piv;
      failc = (failc == 0 && p == T(0)) ? k + 1 : failc;

      // rows k and l swapped in this column, as lu_factor_dev swaps them
      const T mk = col[k];
      T ml = mk;
#pragma unroll
      for (int i = k + 1; i < N; ++i) ml = (l == i) ? col[i] : ml;
      col[k] = ml;
#pragma unroll
      for (int i = k + 1; i < N; ++i) col[i] = (l == i) ? mk : col[i];

      // rank k's multipliers (its own pivot, p_own, is p), broadcast
      const T mult = T(1) / (p_own == T(0) ? T(1) : p_own);
#pragma unroll
      for (int i = k + 1; i < N; ++i) {
        const T own = col[i] * mult;
        const T mik = team.from(own, k);
        col[i] = j == k ? own : j > k ? col[i] - col[k] * mik : col[i];
      }
    }
  }
  if (real) {
#pragma unroll
    for (int i = 0; i < N; ++i) lu[(long long)(i * N + j) * B + b] = col[i];
    piv[(long long)j * B + b] = my_piv;
  }
  if (live && j == 0) fail[b] = failc;
}

template <typename T, int N>
__global__ void __launch_bounds__(kGroupThreads)
factor_group_kernel(const T* __restrict__ a, T* __restrict__ lu, int* __restrict__ piv,
                    int* __restrict__ fail, long long B) {
  long long b;
  bool live;
  if (!group_system<N>(B, b, live)) return;
  factor_cols<T, N, false>(a, lu, piv, fail, B, b, live, Team<kGroup<N>>());
}

// The solve of one system by its group, one row a thread: rank r loads the
// right-hand side's element r and row r of lu, and every rank the N
// pivots. The swaps are lu_solve_dev's in order; rank r works out which
// element they bring to slot r (the swaps undone from the last to the
// first, on the index) and takes it by one shuffle. Then the forward and
// the column-oriented back substitution, v[k] broadcast from rank k at each
// column: each element sees lu_solve_dev's operations in its order.
template <typename T, int N, Op kOp>
__device__ __forceinline__ void solve_rows(const T* __restrict__ lu, const int* __restrict__ piv,
                                           const T* __restrict__ rhs, T* __restrict__ x,
                                           const LuSolveLayout& L, long long s, bool live,
                                           const Team<kGroup<N>>& team) {
  // the caller keeps the lanes below 2^31: the index splits in 32 bits
  const unsigned inner = (unsigned)L.inner;
  const unsigned o32 = live ? (unsigned)s / inner : 0u;
  const long long o = o32, q = live ? (long long)((unsigned)s - o32 * inner) : 0;
  const int r = team.r;
  const bool real = live && r < N;
  T row[N];
  int p[N];
  // a dead group solves the identity for ones: its divisions stay off the
  // slow path that CUDA's division takes for a zero (or zero quotient)
  T v = real ? rhs[o * L.b_o + r * L.b_i + q] : T(1);
#pragma unroll
  for (int j = 0; j < N; ++j)
    row[j] = real ? lu[o * L.lu_o + r * L.lu_i + j * L.lu_j + q] : T(j == r ? 1 : 0);
#pragma unroll
  for (int k = 0; k < N; ++k) p[k] = live ? piv[o * L.piv_o + k * L.piv_i + q] : k;

  if constexpr (kOp == Op::kCopy) {
    bool odd = false;
#pragma unroll
    for (int k = 0; k < N; ++k) odd = odd | (p[k] < 0) | (row[k] == v);
    v = odd ? row[0] : v;
  } else {
    int src = r;
#pragma unroll
    for (int k = N - 1; k >= 0; --k) {
      const bool swaps = p[k] > k && p[k] < N;  // lu_solve_dev swaps only such rows
      src = !swaps ? src : src == k ? p[k] : src == p[k] ? k : src;
    }
    v = team.from(v, src);

#pragma unroll
    for (int k = 0; k < N - 1; ++k) {
      const T vk = team.from(v, k);
      v = r > k ? v - row[k] * vk : v;
    }
#pragma unroll
    for (int k = N - 1; k > 0; --k) {
      v = r == k ? v / row[k] : v;
      const T vk = team.from(v, k);
      v = r < k ? v - row[k] * vk : v;
    }
    v = r == 0 ? v / row[0] : v;
  }
  if (real) x[o * L.x_o + r * L.x_i + q] = v;
}

template <typename T, int N>
__global__ void __launch_bounds__(kGroupThreads)
solve_group_kernel(const T* __restrict__ lu, const int* __restrict__ piv, const T* __restrict__ rhs,
                   T* __restrict__ x, const LuSolveLayout L, long long lanes) {
  long long s;
  bool live;
  if (!group_system<N>(lanes, s, live)) return;
  solve_rows<T, N, Op::kSolve>(lu, piv, rhs, x, L, s, live, Team<kGroup<N>>());
}

#ifdef IDA_LU_FLOOR
template <typename T, int N>
__global__ void __launch_bounds__(kGroupThreads)
factor_copy_group_kernel(const T* __restrict__ a, T* __restrict__ lu, int* __restrict__ piv,
                         int* __restrict__ fail, long long B) {
  long long b;
  bool live;
  if (!group_system<N>(B, b, live)) return;
  factor_cols<T, N, true>(a, lu, piv, fail, B, b, live, Team<kGroup<N>>());
}

template <typename T, int N>
__global__ void __launch_bounds__(kGroupThreads)
copy_group_kernel(const T* __restrict__ lu, const int* __restrict__ piv, const T* __restrict__ rhs,
                  T* __restrict__ x, const LuSolveLayout L, long long lanes) {
  long long s;
  bool live;
  if (!group_system<N>(lanes, s, live)) return;
  solve_rows<T, N, Op::kCopy>(lu, piv, rhs, x, L, s, live, Team<kGroup<N>>());
}

template <typename T, int N>
__global__ void __launch_bounds__(kFactorThreads)
factor_copy_kernel(const T* __restrict__ a, T* __restrict__ lu, int* __restrict__ piv,
                   int* __restrict__ fail, long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  T m[N][N];
  bool odd = false;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      m[i][j] = a[(long long)(i * N + j) * B + b];
      odd = odd | (m[i][j] == T(-7));
    }
#pragma unroll
  for (int k = 0; k < N; ++k) piv[(long long)k * B + b] = k;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) lu[(long long)(i * N + j) * B + b] = m[i][j];
  fail[b] = odd ? 1 : 0;
}
#endif

// The rule (see the header): the factor or the solve takes the groups where
// N >= n and lo <= lanes <= hi, or where N >= all at any number of lanes
// (kAlways: nowhere).
struct GroupRule {
  int n;
  long long lo, hi;
  int all;
};
constexpr int kAlways = 17;
constexpr GroupRule kGroupRule[2][2] = {
    {{9, 1, 1024, 13}, {10, 1, 1024, kAlways}},  // factor: f64, f32
    {{6, 1, 8192, kAlways}, {5, 32, 8192, kAlways}},  // solve: f64, f32
};

enum { kFactorRule = 0, kSolveRule = 1 };

inline bool use_groups(int kernel, bool f32, int n, long long lanes) {
#if IDA_LU_GROUP == 0
  (void)kernel, (void)f32, (void)n, (void)lanes;
  return false;
#elif IDA_LU_GROUP == 2
  (void)kernel, (void)f32, (void)n, (void)lanes;
  return true;
#else
  const GroupRule& r = kGroupRule[kernel][f32 ? 1 : 0];
  return n >= r.all || (n >= r.n && r.lo <= lanes && lanes <= r.hi);
#endif
}

template <int N>
inline unsigned group_blocks(long long lanes) {
  return (unsigned)((lanes * kGroup<N> + kGroupThreads - 1) / kGroupThreads);
}

inline unsigned grid_for(long long B) {
  return (unsigned)((B + kFactorThreads - 1) / kFactorThreads);
}

inline unsigned blocks_for(unsigned items, unsigned threads) {
  return (items + threads - 1) / threads;
}

template <typename T, int N>
void launch_factor(const T* a, T* lu, int* piv, int* fail, long long B, cudaStream_t s) {
  if (use_groups(kFactorRule, sizeof(T) == 4, N, B)) {
    factor_group_kernel<T, N><<<group_blocks<N>(B), kGroupThreads, 0, s>>>(a, lu, piv, fail, B);
  } else {
    factor_kernel<T, N><<<grid_for(B), kFactorThreads, 0, s>>>(a, lu, piv, fail, B);
  }
}

#ifdef IDA_LU_FLOOR
template <typename T, int N>
void launch_factor_copy(const T* a, T* lu, int* piv, int* fail, long long B, cudaStream_t s) {
  if (use_groups(kFactorRule, sizeof(T) == 4, N, B)) {
    factor_copy_group_kernel<T, N><<<group_blocks<N>(B), kGroupThreads, 0, s>>>(a, lu, piv, fail, B);
  } else {
    factor_copy_kernel<T, N><<<grid_for(B), kFactorThreads, 0, s>>>(a, lu, piv, fail, B);
  }
}
#endif

// kCopy: the factor's floor, the same bytes with no arithmetic
template <typename T, bool kCopy = false>
int factor(const void* a, void* lu, void* piv, void* fail, int n, long long B, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const T* pa = (const T*)a;
  T* plu = (T*)lu;
  int* pp = (int*)piv;
  int* pf = (int*)fail;
  switch (n) {
#ifdef IDA_LU_FLOOR
#define IDA_CASE(NN)                                                      \
  case NN:                                                                \
    if constexpr (kCopy) launch_factor_copy<T, NN>(pa, plu, pp, pf, B, s); \
    else launch_factor<T, NN>(pa, plu, pp, pf, B, s);                     \
    break;
#else
#define IDA_CASE(NN) \
  case NN: launch_factor<T, NN>(pa, plu, pp, pf, B, s); break;
#endif
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
  if constexpr (kOp != Op::kSolveT) {
    const long long lanes = L.outer * L.inner;
    if (use_groups(kSolveRule, sizeof(T) == 4, N, lanes)) {
      if constexpr (kOp == Op::kSolve) {
        solve_group_kernel<T, N><<<group_blocks<N>(lanes), kGroupThreads, 0, s>>>(lu, piv, b, x, L, lanes);
      } else {
#ifdef IDA_LU_FLOOR
        copy_group_kernel<T, N><<<group_blocks<N>(lanes), kGroupThreads, 0, s>>>(lu, piv, b, x, L, lanes);
#endif
      }
      return;
    }
  }
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

// an empty kernel on the grid the solve of this layout launches
int small_lu_empty(int n, int f32, const LuSolveLayout* layout, void* stream) {
  const long long lanes = layout->outer * layout->inner;
  unsigned threads, blocks;
  if (n >= 1 && n <= 16 && use_groups(kSolveRule, f32 != 0, n, lanes)) {
    const int g = n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : 16;
    threads = kGroupThreads;
    blocks = (unsigned)((lanes * g + threads - 1) / threads);
  } else {
    const bool pairs = layout->vector && IDA_LU_VEC && n <= kPairMaxN;
    threads = pairs ? kSolveThreads<kPair> : kSolveThreads<1>;
    blocks = blocks_for((unsigned)(layout->outer * (layout->inner / (pairs ? kPair : 1))), threads);
  }
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// the factor's floor: its bytes moved on its grid, and an empty kernel on it
int small_lu_factor_copy_f64(const void* a, void* lu, void* piv, void* fail, int n, long long B,
                             void* stream) {
  return factor<double, true>(a, lu, piv, fail, n, B, stream);
}

int small_lu_factor_copy_f32(const void* a, void* lu, void* piv, void* fail, int n, long long B,
                             void* stream) {
  return factor<float, true>(a, lu, piv, fail, n, B, stream);
}

int small_lu_factor_empty(int n, int f32, long long B, void* stream) {
  unsigned threads, blocks;
  if (n >= 1 && n <= 16 && use_groups(kFactorRule, f32 != 0, n, B)) {
    const int g = n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : 16;
    threads = kGroupThreads;
    blocks = (unsigned)((B * g + threads - 1) / threads);
  } else {
    threads = kFactorThreads;
    blocks = grid_for(B);
  }
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
#endif

// 1 where the build sends this factor (kernel 0) or solve (kernel 1) to the
// group skeleton (ops/small_lu.py::uses_groups asks it)
int small_lu_uses_groups(int kernel, int f32, int n, long long lanes) {
  return (kernel == 0 || kernel == 1) && n >= 1 && n <= 16 && use_groups(kernel, f32 != 0, n, lanes);
}

}  // extern "C"
