// The IDA solve of ONE lane (one DAE instance) as device code: the port's
// eager routines (ida_tpu_torch/core/*.py), each written as a __device__
// function of the same name and in the same order of operations, for a lane
// whose state is held by its thread.
//
// Where the state lives (an H100 SM has 64 K registers and 227 KB of shared
// memory, and local memory falls through a small L1 to L2):
// * the order-indexed history (phi, psi, alpha, beta, sigma, gamma: 6 rows
//   each, indexed by the run-time order kk) lies in dynamic shared memory as
//   [row][thread], so a warp reads one row as 32 consecutive words, without
//   bank conflicts even when its lanes are at different orders;
// * the vectors and scalars every attempt touches are members of Lane, with
//   compile-time indices only; every function here is inlined into its
//   kernel, so they stay in registers;
// * the cold fields (hin, hmax_inv, epcon, tstop, h0u, tretlast, tolsf,
//   toutc, taskc, and the quadratures yQ) stay in device memory and are read
//   and written where they are used; the seven int64 counters are carried as this launch's int32
//   increments and added to the field at the store.
//
// Parity with the eager port on the card is bit for bit, so:
// * T is ida::Real (rounded.cuh): every + - * / rounds once, as one torch
//   op does, through intrinsics the compiler never contracts, while the
//   file is built with nvcc's default -fmad=true so that pow and sqrt are
//   torch.pow's and torch.sqrt's; -prec-div and -prec-sqrt stay at their
//   defaults, never --use_fast_math;
// * sums run left to right over all rows, adding the zeros of masked rows
//   (utils/numerics.py sum0), and masks multiply (x * 1.0, x * 0.0) where the
//   eager code multiplies: a masked row still adds its signed zero, or its
//   NaN when the row holds an inf, so predict and get_solution walk all six
//   rows. Work whose result is discarded is skipped: set_coeffs computes
//   rows 0..kk of its recurrences and none when nothing is stored (each row
//   depends on lower rows only), complete_step leaves the rows above
//   kused + 1 alone;
// * `c / t` in torch is `reciprocal(t) * c`; every such numerator on this
//   path is a power of two (1, 0.5, 2, -1), so a plain division rounds the
//   same; `restore` multiplies by the rounded 1/beta as the eager code does;
// * Python constants enter in double and are rounded to T once, as a torch
//   op with a Python scalar does (e.g. 100.0 * eps is a double product).
// The eager loops compute some values for lanes that are masked out (the
// Jacobian of lanes that skip lsetup, the residual after the last Newton
// iteration); here a lane skips that work and keeps only what the eager code
// keeps and counts.
//
// Only TASK_NORMAL is covered; roots (nroots > 0) are not. The linear
// solver is a compile-time member of the model type too (M::kSolver):
// * SOLVER_DENSE: the dense LU of small_lu.cuh on M::jac;
// * SOLVER_BAND: the band LU of band_lu.cuh (M::kMu, M::kMl) on a Jacobian
//   in band storage from mu + ml + 1 calls of M::res_jvp on the
//   Curtis-Powell-Reid probes (ops/banded.py band_jacobian), held in the
//   lane like the dense factor;
// * SOLVER_SPGMR: restarted GMRES in the lane (ops/spgmr.py, M::kMaxl basis
//   vectors, modified or classical Gram-Schmidt, a basis stored in bfloat16
//   with M::kBf16) on the jvp M::res_jvp, the basis, the Hessenberg matrix
//   and the rotations in local memory, with the Krylov counters nli, nps,
//   ncfl and njtimes (spgmr_solve below).
// The inequality constraints are covered: a lane whose
// constraints_set is on runs the block at the end of nonlinear_solve, reading
// its constraint codes from device memory there (they are read nowhere else,
// so they take no register across the attempt loop).
//
// The arithmetic modes of IdaOptions are compile-time members of the model
// type M (M::kFastMath, M::kLs), so the parity instantiation is the code it
// was and each mode is an instantiation of its own:
// * fast_math keeps phi unscaled: set_coeffs and restore leave it alone, and
//   predict, error_test and complete_step fold the phi-star row scale
//   (phi_star_s, coeffs.py phi_star_scale) into their products where the
//   eager code does;
// * ls_precision "single" and "refined" hold the factor in float32
//   (Lane::lu is Real<float>) and solve in float32 (small_lu.cuh at float).
//   "single" evaluates the Jacobian on arguments rounded to float32 (in T,
//   as the eager code's float64 parameters promote them) and rounds it;
//   "refined" evaluates it in T, rounds it, saves the lsetup point
//   (ls_tn, ls_cj, ls_yy, ls_yp: cold fields in device memory) and refines
//   every solve once, x0 + LU32^-1 (b - J x0), with J x0 the tangent of the
//   residual at that point (M::res_jvp, torch.func.jvp's formulas).

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "band_lu.cuh"
#include "rounded.cuh"
#include "small_lu.cuh"

// threads a block, and the resident blocks an SM the solve kernel is
// compiled for (its register cap is 65,536 / (threads * blocks), at most 255)
#ifndef IDA_THREADS
#define IDA_THREADS 64
#endif
#ifndef IDA_MIN_BLOCKS
#define IDA_MIN_BLOCKS 4
#endif

// the block's dynamic shared memory: the history rows, [row][thread]
extern __shared__ __align__(16) unsigned char ida_shared[];

namespace ida {

constexpr int kThreads = IDA_THREADS;
constexpr int MXORDP1 = 6;  // rows of phi (constants.py)
constexpr int MAXN = 16;    // most components a by-value atol carries

// status codes (ida_tpu_torch/constants.py)
constexpr int CONTINUE = 99, SUCCESS = 0, TSTOP_RETURN = 1;
constexpr int TOO_MUCH_WORK = -1, TOO_MUCH_ACC = -2, ERR_FAIL = -3, CONV_FAIL = -4;
constexpr int LSETUP_FAIL = -6, LSOLVE_FAIL = -7, REP_RES_ERR = -9, CONSTR_FAIL = -11;
constexpr int BAD_EWT = -13, ILL_INPUT = -22, BAD_T = -26;
constexpr int REC_NONE = 0, REC_CONV = 1, REC_RESIDUAL = 2, REC_LSETUP = 3, REC_LSOLVE = 4;
constexpr int REC_CONSTRAINT = 5, ERROR_TEST_FAIL = 6;
constexpr double XRATE = 0.25, RATEMAX = 0.9;

// internal Newton status (core/nls.py)
constexpr int NL_CONTINUE = 0, NL_OK = 1, NL_CONV_RECVR = 2, NL_LSETUP_RECVR = 3;
constexpr int NL_RES_RECVR = 4, NL_LSOLVE_RECVR = 5;

// order actions (core/complete_step.py)
constexpr int LOWER = 0, MAINTAIN = 1, RAISE = 2;

// IdaOptions as the kernel takes them; `constraints` is enable_constraints
// (the Krylov solver's krylov_max_restarts and eplifac are read by spgmr only)
struct Opts {
  int maxord, mxstep, maxncf, maxnef, maxnlsit, suppressalg, constraints, krylov_max_restarts;
  double eplifac;
};

// IdaOptions.ls_precision, M::kLs
constexpr int LS_FULL = 0, LS_SINGLE = 1, LS_REFINED = 2;
// IdaOptions.linear_solver, M::kSolver
constexpr int SOLVER_DENSE = 0, SOLVER_BAND = 1, SOLVER_SPGMR = 2;

// a real rounded to float32 to the nearest, as torch's .to(torch.float32),
// and a float32 widened back to a real of the state's dtype (exact)
__device__ __forceinline__ Real<float> to_f32(Real<double> a) {
  Real<float> r;
  r.v = __double2float_rn(a.v);
  return r;
}
__device__ __forceinline__ Real<float> to_f32(Real<float> a) { return a; }
__device__ __forceinline__ void widen(Real<float> a, Real<double>& out) { out.v = (double)a.v; }
__device__ __forceinline__ void widen(Real<float> a, Real<float>& out) { out = a; }

// promote<T>(a): an operand of type S in an operation of type T, as torch
// promotes a float32 tensor meeting a float64 one (widened exactly), the
// identity when S is T; narrow<K>(a): a real of type T as .to(K's dtype)
// rounds it (to the nearest), the identity when K is T
template <typename T, typename S> struct Convert;
template <typename S> struct Convert<Real<S>, Real<S>> {
  __device__ static __forceinline__ Real<S> of(Real<S> a) { return a; }
};
template <> struct Convert<Real<double>, Real<float>> {
  __device__ static __forceinline__ Real<double> of(Real<float> a) {
    Real<double> r;
    widen(a, r);
    return r;
  }
};
template <> struct Convert<Real<float>, Real<double>> {
  __device__ static __forceinline__ Real<float> of(Real<double> a) { return to_f32(a); }
};
template <typename T, typename S>
__device__ __forceinline__ T promote(S a) { return Convert<T, S>::of(a); }
template <typename K, typename T>
__device__ __forceinline__ K narrow(T a) { return Convert<K, T>::of(a); }

// a real stored as bfloat16 the way ATen's .to(torch.bfloat16) rounds it
// (c10::BFloat16: a float64 goes to float32 to the nearest first, then to
// bfloat16 to the nearest even; every NaN becomes 0x7FC0), and read back
// exactly
__device__ __forceinline__ unsigned short bf16_bits(float f) {
  union { float f; unsigned int u; } x;
  x.f = f;
  if (f != f) return 0x7FC0;
  return (unsigned short)((x.u + (((x.u >> 16) & 1u) + 0x7FFFu)) >> 16);
}
__device__ __forceinline__ unsigned short bf16_bits(Real<float> a) { return bf16_bits(a.v); }
__device__ __forceinline__ unsigned short bf16_bits(Real<double> a) { return bf16_bits(to_f32(a).v); }
template <typename K>
__device__ __forceinline__ K of_bf16(unsigned short bits) {
  union { float f; unsigned int u; } x;
  x.u = (unsigned int)bits << 16;
  K r;
  r.v = x.f;
  return r;
}

// torch.finfo(dtype).eps
template <typename T> struct Eps;
template <> struct Eps<Real<double>> { static constexpr double v = 2.220446049250313e-16; };
template <> struct Eps<Real<float>> { static constexpr double v = 1.1920928955078125e-07; };

// sum of 1/(i+1) for i < K, left to right in double (coeffs.py alphas)
template <int K> struct Harmonic { static constexpr double v = Harmonic<K - 1>::v + 1.0 / K; };
template <> struct Harmonic<0> { static constexpr double v = 0.0; };

// torch.maximum / torch.minimum: NaN propagates
template <typename T> __device__ __forceinline__ T tmax(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename T> __device__ __forceinline__ T tmin(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
template <typename T> __device__ __forceinline__ T tsign(T a) {
  return T((T(0) < a) - (a < T(0)));
}

// The state fields the solve reads or writes (core/state.py IdaState), in
// the order of the pointer table the wrapper passes (ops/fused_solve.py
// STATE_FIELDS must list the same names in the same order). Fields the solve
// never touches (roots, pdata) are not passed and pass through; lu and piv
// are the direct solvers' (dense [B, N, N], band [B, 2*ML+MU+1, N]; piv
// [B, N]) and pass through under spgmr, whose counters nli, nps, ncfl and
// njtimes are read and written under spgmr only; the constraints are read,
// and copied to the result of a launch
// out of place. yQ ([B, M::NQ]) is read, written and copied for a model
// with quadratures only (M::NQ > 0): for the others its pointer is null and
// the field passes through. ls_tn, ls_cj, ls_yy and ls_yp are read, written and copied
// under ls_precision "refined" only: in the other modes their pointers are
// null and the fields pass through.
#define IDA_STATE_FIELDS(X)                                                     \
  X(phi) X(psi) X(alpha) X(beta) X(sigma) X(gamma) X(ee) X(yy) X(yp)            \
  X(yypredict) X(yppredict) X(ewt) X(savres) X(tn) X(hh) X(hused) X(rr) X(h0u)  \
  X(tretlast) X(tolsf) X(kk) X(kused) X(knew) X(phase) X(ns) X(cj) X(cjlast)    \
  X(cjold) X(cjratio) X(ss) X(oldnrm) X(eps_newt) X(toldel) X(lu) X(piv) X(hin) \
  X(hmax_inv) X(epcon) X(tstop) X(tstop_set) X(constraints) X(constraints_set)  \
  X(nst) X(nre) X(ncfn) X(netf) X(nni) X(nsetups) X(nje) X(nli) X(nps) X(ncfl)  \
  X(njtimes) X(toutc) X(taskc) X(status) X(yQ) X(ls_tn) X(ls_cj) X(ls_yy)       \
  X(ls_yp)

// Device pointers to the state's fields: reals in the state's dtype,
// kk..ns/piv/taskc/status int32, counters int64, tstop_set and
// constraints_set bool as uint8.
// The layout (which axis is the batch) is a template argument of the code
// that reads them.
struct StateRefs {
#define IDA_PTR(name) void* name;
  IDA_STATE_FIELDS(IDA_PTR)
#undef IDA_PTR
};

// Where a lane's row of a field with `rows` rows a lane lies.
struct BatchLeading {  // [B, rows]: the entry points' layout
  static constexpr bool kLast = false;
  __device__ static __forceinline__ long long at(int row, int rows, long long b, long long B) {
    return b * rows + row;
  }
};
struct BatchLast {  // [rows, B]: the batch-native layout of the eager core
  static constexpr bool kLast = true;
  __device__ static __forceinline__ long long at(int row, int rows, long long b, long long B) {
    return (long long)row * B + b;
  }
};

// The attempt loop's carry (core/solve.py _Loop minus the state), [B] each.
// A null pointer is neither read nor written.
struct CarryRefs {
  void* tret;     // T
  void* istate;   // int32
  void* nstloc;   // int32
  void* saved_t;  // T
  void* ncf;      // int32
  void* nef;      // int32
  void* fresh;    // uint8 (bool)
  void* ikind;    // int32
  void* itgt;     // T
};

// The history rows of one lane: a column of the block's [kRows][kThreads]
// array in shared memory.
template <typename T, int N>
struct Hist {
  static constexpr int kPsi = MXORDP1 * N, kAlpha = kPsi + MXORDP1, kBeta = kAlpha + MXORDP1;
  static constexpr int kSigma = kBeta + MXORDP1, kGamma = kSigma + MXORDP1;
  static constexpr int kRows = kGamma + MXORDP1;
  static constexpr size_t kBytes = sizeof(T) * kRows * kThreads;
  T* col;
  __device__ __forceinline__ T& row(int r) const { return col[r * kThreads]; }
  __device__ __forceinline__ T& phi(int j, int n) const { return row(j * N + n); }
  __device__ __forceinline__ T& psi(int i) const { return row(kPsi + i); }
  __device__ __forceinline__ T& alpha(int i) const { return row(kAlpha + i); }
  __device__ __forceinline__ T& beta(int i) const { return row(kBeta + i); }
  __device__ __forceinline__ T& sigma(int i) const { return row(kSigma + i); }
  __device__ __forceinline__ T& gamma(int i) const { return row(kGamma + i); }
};

// One lane's state; LuT is the type of the factor (T, or Real<float> under
// ls_precision "single" and "refined"), [LuRows][N] (dense N x N, band
// 2*ML+MU+1 x N; a placeholder of one entry under spgmr, never read).
template <typename T, int N, typename LuT = T, int LuRows = N>
struct Lane {
  Hist<T, N> h;
  T ee[N], yy[N], yp[N], yypredict[N], yppredict[N], ewt[N], savres[N];
  T tn, hh, hused, rr;
  int kk, kused, knew, phase, ns;
  T cj, cjlast, cjold, cjratio, ss, oldnrm, eps_newt, toldel;
  LuT lu[LuRows][N];
  int piv[N];
  bool tstop_set;
  // the counters as this launch's increments (the Krylov ones under spgmr
  // only); `stepped`: nst > 0 at the load
  int nst, nre, ncfn, netf, nni, nsetups, nje;
  int nli, nps, ncfl, njtimes;
  bool stepped;
  // the cold fields, in device memory (the table the launch writes), and
  // where the lane lies in it (a compile-time layout, so B folds away for
  // the batch-leading entry points)
  const StateRefs* io;
  long long b, B;
  bool batch_last;
#define IDA_COLD(name, ty) \
  __device__ __forceinline__ ty& name() const { return ((ty*)io->name)[b]; }
  IDA_COLD(hin, T) IDA_COLD(hmax_inv, T) IDA_COLD(epcon, T) IDA_COLD(tstop, T)
  IDA_COLD(h0u, T) IDA_COLD(tretlast, T) IDA_COLD(tolsf, T) IDA_COLD(toutc, T)
  IDA_COLD(taskc, int) IDA_COLD(status, int) IDA_COLD(ls_tn, T) IDA_COLD(ls_cj, T)
#undef IDA_COLD
  // where component i of a lane's [N] field lies
  __device__ __forceinline__ long long at(int i) const {
    return batch_last ? (long long)i * B + b : b * N + i;
  }
  // the lsetup point of ls_precision "refined"
  __device__ __forceinline__ T& ls_yy(int i) const { return ((T*)io->ls_yy)[at(i)]; }
  __device__ __forceinline__ T& ls_yp(int i) const { return ((T*)io->ls_yp)[at(i)]; }
  // nst == 0, of the true total
  __device__ __forceinline__ bool no_step_yet() const { return !stepped && nst == 0; }
  // the inequality constraints, read where the block uses them
  __device__ __forceinline__ bool constraints_set() const {
    return ((const unsigned char*)io->constraints_set)[b] != 0;
  }
  __device__ __forceinline__ T constraint(int i) const { return ((const T*)io->constraints)[at(i)]; }
};

// the factor's type, its rows, and the lane, of model M in its mode; the
// type of the band Jacobian's arguments and of the Krylov iteration
// (float32 under "single", nls.py _lsetup and _newton_iterate)
template <typename T, class M>
using LuReal = typename std::conditional<M::kLs == LS_FULL, T, Real<float>>::type;
template <class M>
struct LuRows {
  static constexpr int v = M::kSolver == SOLVER_DENSE
                               ? M::N
                               : (M::kSolver == SOLVER_BAND ? 2 * M::kMl + M::kMu + 1 : 1);
};
template <typename T, class M>
using LaneOf = Lane<T, M::N, LuReal<T, M>, LuRows<M>::v>;
template <typename T, class M>
using SingleReal = typename std::conditional<M::kLs == LS_SINGLE, Real<float>, T>::type;

// The lane's problem data: parameters, tolerances, tout, options.
template <typename T, class M>
struct Ctx {
  T p[M::P];
  T rtol, atol[M::N], tout;
  Opts opts;
};

template <typename T>
struct Carry {
  T tret;
  int istate, nstloc;
  T saved_t;
  int ncf, nef;
  bool fresh;
  int ikind;
  T itgt;
};

// ---------------------------------------------------------------- I/O

// Load lane b of `in` (layout Lay). The cold fields are read and written
// through `out` from here on, so they are copied there first when the
// launch is out of place.
template <typename T, class M, class Lay>
__device__ __forceinline__ void load_lane(const StateRefs& in, const StateRefs& out, long long b,
                                          long long B, LaneOf<T, M>& L) {
  constexpr int N = M::N;
  using LuT = LuReal<T, M>;
  L.h.col = (T*)ida_shared + threadIdx.x;
  L.io = &out;
  L.b = b;
  L.B = B;
  L.batch_last = Lay::kLast;
#define LD_SCALAR(name, ty) L.name = ((const ty*)in.name)[b];
#define LD_VEC(name, K) \
  _Pragma("unroll") for (int i = 0; i < K; ++i) \
    L.name[i] = ((const T*)in.name)[Lay::at(i, K, b, B)];
#define LD_HIST(name, K) \
  _Pragma("unroll") for (int i = 0; i < K; ++i) \
    L.h.name(i) = ((const T*)in.name)[Lay::at(i, K, b, B)];
#pragma unroll
  for (int r = 0; r < MXORDP1 * N; ++r)
    L.h.row(r) = ((const T*)in.phi)[Lay::at(r, MXORDP1 * N, b, B)];
  LD_HIST(psi, MXORDP1) LD_HIST(alpha, MXORDP1) LD_HIST(beta, MXORDP1) LD_HIST(sigma, MXORDP1)
  LD_HIST(gamma, MXORDP1)
  LD_VEC(ee, N) LD_VEC(yy, N) LD_VEC(yp, N) LD_VEC(yypredict, N) LD_VEC(yppredict, N)
  LD_VEC(ewt, N) LD_VEC(savres, N)
  LD_SCALAR(tn, T) LD_SCALAR(hh, T) LD_SCALAR(hused, T) LD_SCALAR(rr, T)
  LD_SCALAR(kk, int) LD_SCALAR(kused, int) LD_SCALAR(knew, int) LD_SCALAR(phase, int)
  LD_SCALAR(ns, int)
  LD_SCALAR(cj, T) LD_SCALAR(cjlast, T) LD_SCALAR(cjold, T) LD_SCALAR(cjratio, T)
  LD_SCALAR(ss, T) LD_SCALAR(oldnrm, T) LD_SCALAR(eps_newt, T) LD_SCALAR(toldel, T)
  if constexpr (M::kSolver != SOLVER_SPGMR) {
    constexpr int R = LuRows<M>::v;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) L.lu[i][j] = ((const LuT*)in.lu)[Lay::at(i * N + j, R * N, b, B)];
#pragma unroll
    for (int i = 0; i < N; ++i) L.piv[i] = ((const int*)in.piv)[Lay::at(i, N, b, B)];
  }
  L.tstop_set = ((const unsigned char*)in.tstop_set)[b] != 0;
  L.stepped = ((const long long*)in.nst)[b] > 0;
  L.nst = L.nre = L.ncfn = L.netf = L.nni = L.nsetups = L.nje = 0;
  L.nli = L.nps = L.ncfl = L.njtimes = 0;
  if (in.status != out.status) {
#define CP_COLD(name, ty) ((ty*)out.name)[b] = ((const ty*)in.name)[b];
    CP_COLD(hin, T) CP_COLD(hmax_inv, T) CP_COLD(epcon, T) CP_COLD(tstop, T) CP_COLD(h0u, T)
    CP_COLD(tretlast, T) CP_COLD(tolsf, T) CP_COLD(toutc, T) CP_COLD(taskc, int)
    CP_COLD(status, int) CP_COLD(constraints_set, unsigned char)
    if (M::kLs == LS_REFINED) { CP_COLD(ls_tn, T) CP_COLD(ls_cj, T) }
#undef CP_COLD
    if constexpr (M::NQ > 0) {
#pragma unroll
      for (int i = 0; i < M::NQ; ++i) {
        const long long at = Lay::at(i, M::NQ, b, B);
        ((T*)out.yQ)[at] = ((const T*)in.yQ)[at];
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const long long at = Lay::at(i, N, b, B);
      ((T*)out.constraints)[at] = ((const T*)in.constraints)[at];
      if (M::kLs == LS_REFINED) {
        ((T*)out.ls_yy)[at] = ((const T*)in.ls_yy)[at];
        ((T*)out.ls_yp)[at] = ((const T*)in.ls_yp)[at];
      }
    }
  }
#undef LD_SCALAR
#undef LD_VEC
#undef LD_HIST
}

// Store the lane into `out`; the counters are `in`'s plus the increments.
template <typename T, class M, class Lay>
__device__ __forceinline__ void store_lane(const StateRefs& in, const StateRefs& out, long long b,
                                           long long B, const LaneOf<T, M>& L) {
  constexpr int N = M::N;
  using LuT = LuReal<T, M>;
#define ST_SCALAR(name, ty) ((ty*)out.name)[b] = L.name;
#define ST_VEC(name, K) \
  _Pragma("unroll") for (int i = 0; i < K; ++i) \
    ((T*)out.name)[Lay::at(i, K, b, B)] = L.name[i];
#define ST_HIST(name, K) \
  _Pragma("unroll") for (int i = 0; i < K; ++i) \
    ((T*)out.name)[Lay::at(i, K, b, B)] = L.h.name(i);
#define ST_COUNT(name) \
  ((long long*)out.name)[b] = ((const long long*)in.name)[b] + (long long)L.name;
#pragma unroll
  for (int r = 0; r < MXORDP1 * N; ++r)
    ((T*)out.phi)[Lay::at(r, MXORDP1 * N, b, B)] = L.h.row(r);
  ST_HIST(psi, MXORDP1) ST_HIST(alpha, MXORDP1) ST_HIST(beta, MXORDP1) ST_HIST(sigma, MXORDP1)
  ST_HIST(gamma, MXORDP1)
  ST_VEC(ee, N) ST_VEC(yy, N) ST_VEC(yp, N) ST_VEC(yypredict, N) ST_VEC(yppredict, N)
  ST_VEC(ewt, N) ST_VEC(savres, N)
  ST_SCALAR(tn, T) ST_SCALAR(hh, T) ST_SCALAR(hused, T) ST_SCALAR(rr, T)
  ST_SCALAR(kk, int) ST_SCALAR(kused, int) ST_SCALAR(knew, int) ST_SCALAR(phase, int)
  ST_SCALAR(ns, int)
  ST_SCALAR(cj, T) ST_SCALAR(cjlast, T) ST_SCALAR(cjold, T) ST_SCALAR(cjratio, T)
  ST_SCALAR(ss, T) ST_SCALAR(oldnrm, T) ST_SCALAR(eps_newt, T) ST_SCALAR(toldel, T)
  if constexpr (M::kSolver != SOLVER_SPGMR) {
    constexpr int R = LuRows<M>::v;
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) ((LuT*)out.lu)[Lay::at(i * N + j, R * N, b, B)] = L.lu[i][j];
#pragma unroll
    for (int i = 0; i < N; ++i) ((int*)out.piv)[Lay::at(i, N, b, B)] = L.piv[i];
  }
  ((unsigned char*)out.tstop_set)[b] = L.tstop_set ? 1 : 0;
  ST_COUNT(nst) ST_COUNT(nre) ST_COUNT(ncfn) ST_COUNT(netf) ST_COUNT(nni) ST_COUNT(nsetups)
  ST_COUNT(nje)
  if constexpr (M::kSolver == SOLVER_SPGMR) {
    ST_COUNT(nli) ST_COUNT(nps) ST_COUNT(ncfl) ST_COUNT(njtimes)
  }
#undef ST_SCALAR
#undef ST_VEC
#undef ST_HIST
#undef ST_COUNT
}

// The tolerances and tout of a launch of the whole solve, by value (shared
// by every lane), with per-lane rtol [B] and atol [B, N] for a caller whose
// tolerances differ by lane.
struct TolArgs {
  double rtol, atol[MAXN], tout;
  const void* rtol_lanes;
  const void* atol_lanes;
};

// params [B, P] batch-leading, tolerances from `tol`
template <typename T, class M, bool LaneTol>
__device__ __forceinline__ void load_ctx(const void* params, const TolArgs& tol, const Opts& opts,
                                         long long b, Ctx<T, M>& c) {
#pragma unroll
  for (int i = 0; i < M::P; ++i) c.p[i] = ((const T*)params)[b * M::P + i];
  c.rtol = LaneTol ? ((const T*)tol.rtol_lanes)[b] : T(tol.rtol);
#pragma unroll
  for (int i = 0; i < M::N; ++i)
    c.atol[i] = LaneTol ? ((const T*)tol.atol_lanes)[b * M::N + i] : T(tol.atol[i]);
  c.tout = T(tol.tout);
  c.opts = opts;
}

// batch-native: params [P, B], rtol [B], atol [N, B], tout [B]
template <typename T, class M>
__device__ __forceinline__ void load_ctx_native(const void* params, const void* rtol,
                                                const void* atol, const void* tout,
                                                const Opts& opts, long long b, long long B,
                                                Ctx<T, M>& c) {
#pragma unroll
  for (int i = 0; i < M::P; ++i) c.p[i] = ((const T*)params)[(long long)i * B + b];
  c.rtol = ((const T*)rtol)[b];
#pragma unroll
  for (int i = 0; i < M::N; ++i) c.atol[i] = ((const T*)atol)[(long long)i * B + b];
  c.tout = ((const T*)tout)[b];
  c.opts = opts;
}

// ---------------------------------------------------------------- norms.py

// wrms_norm_bnd: sqrt(sum0((x*w [*mask])^2) / N), divided by N as a number
// of the dtype (the eager code divides by a tensor, never by a reciprocal).
template <typename T, class M>
__device__ __forceinline__ T wrms_norm_bnd(const T (&x)[M::N], const T (&w)[M::N], bool masked) {
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < M::N; ++i) {
    T t = x[i] * w[i];
    if (masked) t = t * (M::id(i) ? T(1) : T(0));
    const T sq = t * t;
    acc = (i == 0) ? sq : acc + sq;
  }
  return sqrt_of(acc / T(M::N));
}

// error_test.py _norm: the suppressalg mask when the options ask for it
template <typename T, class M>
__device__ __forceinline__ T norm(const Ctx<T, M>& c, const T (&x)[M::N], const T (&w)[M::N]) {
  return wrms_norm_bnd<T, M>(x, w, c.opts.suppressalg != 0);
}

// ---------------------------------------------------------------- tol_control.py

template <typename T, class M>
__device__ __forceinline__ void ewt_set(const Ctx<T, M>& c, const T (&y)[M::N], T (&ewt)[M::N]) {
#pragma unroll
  for (int i = 0; i < M::N; ++i) ewt[i] = T(1) / (c.rtol * absval(y[i]) + c.atol[i]);
}

// solve.py _ewt_invalid, any over the data axis
template <typename T, int N>
__device__ __forceinline__ bool ewt_invalid(const T (&ewt)[N]) {
  bool bad = false;
#pragma unroll
  for (int i = 0; i < N; ++i) bad = bad || !(ewt[i] > T(0)) || !finite(ewt[i]);
  return bad;
}

// row j of phi, out of shared memory
template <typename T, int N, class Ln>
__device__ __forceinline__ void phi_row(const Ln& L, int j, T (&out)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) out[n] = L.h.phi(j, n);
}

// ---------------------------------------------------------------- coeffs.py

// fast_math's phi -> phi-star scale of row j (coeffs.py phi_star_scale):
// beta on rows ns..kk, exactly 1 elsewhere
template <typename T, class M>
__device__ __forceinline__ T phi_star_s(const LaneOf<T, M>& L, int j) {
  return (j >= L.ns && j <= L.kk) ? L.h.beta(j) : T(1);
}

template <typename T, class M>
__device__ __forceinline__ T set_coeffs(LaneOf<T, M>& L) {
  constexpr int N = M::N;
  int ns_new = (L.hh != L.hused || L.kk != L.kused) ? 0 : L.ns;
  ns_new = min(ns_new + 1, L.kused + 2);
  L.ns = ns_new;
  const bool update = L.kk + 1 >= L.ns;
  const T hh = L.hh;
  const int kk = L.kk;

  // rows 0..kk of psi/alpha/beta/sigma/gamma; row i needs rows below it
  // and the old psi[i-1] only, and rows above kk are never stored
  if (update && kk >= 0) {
    T psi_old = L.h.psi(0);  // the old psi[i-1]
    T psi_n = hh, alpha_r = T(1), beta_r = T(1), sigma_r = T(1), gamma_r = T(0);
    L.h.psi(0) = psi_n;
    L.h.alpha(0) = alpha_r;
    L.h.beta(0) = beta_r;
    L.h.sigma(0) = sigma_r;
    L.h.gamma(0) = gamma_r;
#pragma unroll
    for (int i = 1; i < MXORDP1; ++i) {
      if (i <= kk) {
        const T psi_old_here = L.h.psi(i);
        beta_r = beta_r * psi_n / psi_old;
        gamma_r = gamma_r + alpha_r / hh;
        psi_n = psi_old + hh;
        alpha_r = hh / psi_n;
        sigma_r = (T(i) * sigma_r) * alpha_r;
        L.h.psi(i) = psi_n;
        L.h.alpha(i) = alpha_r;
        L.h.beta(i) = beta_r;
        L.h.sigma(i) = sigma_r;
        L.h.gamma(i) = gamma_r;
        psi_old = psi_old_here;
      }
    }
  }

  // alphas in double, cast to T; alpha0 in T (both sums over all rows)
  double s = 0.0;
  T a0 = T(0);
#pragma unroll
  for (int i = 0; i < MXORDP1; ++i) {
    T ai = T(0);
    if (i < kk) ai = L.h.alpha(i);
    a0 = (i == 0) ? ai : a0 + ai;
  }
  s = (kk >= 1) ? Harmonic<1>::v : s;
  s = (kk >= 2) ? Harmonic<2>::v : s;
  s = (kk >= 3) ? Harmonic<3>::v : s;
  s = (kk >= 4) ? Harmonic<4>::v : s;
  s = (kk >= 5) ? Harmonic<5>::v : s;
  s = (kk >= 6) ? Harmonic<6>::v : s;
  const T alphas = -T(s);
  const T alpha0 = -a0;

  L.cjlast = L.cj;
  L.cj = (-alphas) / L.hh;

  const T alpha_kk = L.h.alpha(kk);
  T ck = absval(alpha_kk + alphas - alpha0);
  ck = tmax(ck, alpha_kk);

  // phi -> phi-star; fast_math leaves phi unscaled (phi_star_s)
  if constexpr (!M::kFastMath) {
#pragma unroll
    for (int i = 0; i < MXORDP1; ++i) {
      if (i >= L.ns && i <= kk) {
        const T beta_i = L.h.beta(i);
#pragma unroll
        for (int n = 0; n < N; ++n) L.h.phi(i, n) = L.h.phi(i, n) * beta_i;
      }
    }
  }
  return ck;
}

template <typename T, class M>
__device__ __forceinline__ void predict(LaneOf<T, M>& L) {
  constexpr int N = M::N;
  T yy[N], yp[N];
#pragma unroll
  for (int j = 0; j < MXORDP1; ++j) {
    T one = (j <= L.kk) ? T(1) : T(0);
    T gam = T(0);
    if (j >= 1 && j <= L.kk) gam = L.h.gamma(j);
    if constexpr (M::kFastMath) {
      // the row coefficients take the phi-star scale (coeffs.py predict)
      const T s = phi_star_s<T, M>(L, j);
      one = one * s;
      gam = gam * s;
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const T ph = L.h.phi(j, n);
      const T a = ph * one;
      const T g = ph * gam;
      yy[n] = (j == 0) ? a : yy[n] + a;
      yp[n] = (j == 0) ? g : yp[n] + g;
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    L.yypredict[n] = yy[n];
    L.yppredict[n] = yp[n];
  }
}

template <typename T, class M>
__device__ __forceinline__ void restore(LaneOf<T, M>& L, T saved_t) {
  constexpr int N = M::N;
#pragma unroll
  for (int i = 0; i < MXORDP1 - 1; ++i)
    if (i < L.kk) L.h.psi(i) = L.h.psi(i + 1) - L.hh;
  // fast_math: phi was never scaled
  if constexpr (!M::kFastMath) {
#pragma unroll
    for (int i = 0; i < MXORDP1; ++i) {
      if (i >= L.ns && i <= L.kk) {
        const T inv = T(1) / L.h.beta(i);
#pragma unroll
        for (int n = 0; n < N; ++n) L.h.phi(i, n) = L.h.phi(i, n) * inv;
      }
    }
  }
  L.tn = saved_t;
}

template <typename T, class M>
__device__ __forceinline__ void reset(LaneOf<T, M>& L) {
#pragma unroll
  for (int n = 0; n < M::N; ++n) L.h.phi(1, n) = L.h.phi(1, n) * L.rr;
  L.h.psi(0) = L.hh;
}

// ---------------------------------------------------------------- interp.py

// y(t) and y'(t) into yy/yp; false, and nothing written, when t is not legal
// (check_t_legal). Without Check, the interpolation alone (interp.py
// interpolate, for quadrature nodes inside the last step).
template <typename T, class M, bool Check = true>
__device__ __forceinline__ bool get_solution(const LaneOf<T, M>& L, T t, T (&yy)[M::N],
                                             T (&yp)[M::N]) {
  constexpr int N = M::N;
  if constexpr (Check) {
    // check_t_legal
    const T tfuzz = T(100.0 * Eps<T>::v) * (absval(L.tn) + absval(L.hh)) * tsign(L.hh);
    const T tp = L.tn - L.hused - tfuzz;
    const bool ok = (t - tp) * L.hh >= T(0);
    if (!ok) return false;
  }

  // interpolate
  const int kord = max(L.kused, 1);
  const T delt = t - L.tn;
  T c = T(1), d = T(0), gam = delt / L.h.psi(0);
  T cv[MXORDP1], dv[MXORDP1];
  cv[0] = c;
  dv[0] = T(0);
#pragma unroll
  for (int j = 1; j < MXORDP1; ++j) {
    if (kord >= j) {
      const T psi_jm1 = L.h.psi(j - 1);
      const T d_new = d * gam + c / psi_jm1;
      const T c_new = c * gam;
      const T gam_new = (delt + psi_jm1) / L.h.psi(j);
      c = c_new;
      d = d_new;
      gam = gam_new;
      cv[j] = c;
      dv[j] = d;
    } else {
      cv[j] = T(0);
      dv[j] = T(0);
    }
  }
#pragma unroll
  for (int j = 0; j < MXORDP1; ++j) {
    const T cj = (j <= kord) ? cv[j] : T(0);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const T ph = L.h.phi(j, n);
      const T a = cj * ph;
      const T g = dv[j] * ph;
      yy[n] = (j == 0) ? a : yy[n] + a;
      yp[n] = (j == 0) ? g : yp[n] + g;
    }
  }
  return true;
}

// get_solution into the lane's yy/yp; they keep their values when t is not legal
template <typename T, class M>
__device__ __forceinline__ bool get_solution(LaneOf<T, M>& L, T t) {
  T yy[M::N], yp[M::N];
  const bool ok = get_solution<T, M>(L, t, yy, yp);
  if (ok) {
#pragma unroll
    for (int n = 0; n < M::N; ++n) {
      L.yy[n] = yy[n];
      L.yp[n] = yp[n];
    }
  }
  return ok;
}

// ---------------------------------------------------------------- nls.py

// x := A^-1 x from the stored factor (nls.py solve_stored), dense or band:
// in T, or under "single"/"refined" with x rounded to float32, solved in
// float32 and widened
template <typename T, class M>
__device__ __forceinline__ void solve_stored(const LaneOf<T, M>& L, T (&x)[M::N]) {
  constexpr int N = M::N;
  if constexpr (M::kSolver == SOLVER_BAND) {
    using LuT = LuReal<T, M>;
    LuT xs[N];
#pragma unroll
    for (int i = 0; i < N; ++i) xs[i] = narrow<LuT>(x[i]);
    band_solve_dev<LuT, N, M::kMu, M::kMl>(L.lu, L.piv, xs);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = promote<T>(xs[i]);
  } else if constexpr (M::kLs == LS_FULL) {
    lu_solve_dev<T, N>(L.lu, L.piv, x);
  } else {
    Real<float> xf[N];
#pragma unroll
    for (int i = 0; i < N; ++i) xf[i] = to_f32(x[i]);
    lu_solve_dev<Real<float>, N>(L.lu, L.piv, xf);
#pragma unroll
    for (int i = 0; i < N; ++i) widen(xf[i], x[i]);
  }
}

// b := the direct solve of b (nls.py direct_solve); under "refined" one step
// of refinement against the lsetup Jacobian applied as the residual's jvp at
// the saved point with tangents (x0, ls_cj x0): x0 + LU32^-1 (b - J x0)
template <typename T, class M>
__device__ __forceinline__ void direct_solve(const LaneOf<T, M>& L, const Ctx<T, M>& c,
                                             T (&b)[M::N]) {
  constexpr int N = M::N;
  if constexpr (M::kLs == LS_REFINED) {
    T x0[N], w[N], yy[N], yp[N], jx0[N];
    const T ls_cj = L.ls_cj();
#pragma unroll
    for (int i = 0; i < N; ++i) x0[i] = b[i];
    solve_stored<T, M>(L, x0);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      w[i] = ls_cj * x0[i];
      yy[i] = L.ls_yy(i);
      yp[i] = L.ls_yp(i);
    }
    M::res_jvp(c.p, L.ls_tn(), yy, yp, x0, w, jx0);
#pragma unroll
    for (int i = 0; i < N; ++i) b[i] = b[i] - jx0[i];
    solve_stored<T, M>(L, b);
#pragma unroll
    for (int i = 0; i < N; ++i) b[i] = x0[i] + b[i];
  } else {
    solve_stored<T, M>(L, b);
  }
}

// nls.py _lsetup for the band solver: J = dF/dy + cj dF/dy' at the predictor
// in band storage (ops/banded.py band_sys_jacobian), one jvp of the residual
// at (yy + 0, yp + cj * 0) a Curtis-Powell-Reid color, then band-factored.
// Under "single" the arguments are float32 (the float64 parameters promote
// the products they enter, M::res_jvp<T, Real<float>>) and the Jacobian is
// rounded to float32. Returns the lsetup failure: a zero pivot or a
// non-finite Jacobian.
template <typename T, class M>
__device__ __forceinline__ bool band_lsetup(LaneOf<T, M>& L, const Ctx<T, M>& c) {
  constexpr int N = M::N, MU = M::kMu, ML = M::kMl, SMU = MU + ML, WIDTH = MU + ML + 1;
  constexpr int ROWS = 2 * ML + MU + 1, COLORS = WIDTH < N ? WIDTH : N;
  using LuT = LuReal<T, M>;
  using S = SingleReal<T, M>;
  const S t = narrow<S>(L.tn), cj = narrow<S>(L.cj);
  S yy[N], yp[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    yy[i] = narrow<S>(L.yypredict[i]) + S(0);
    yp[i] = narrow<S>(L.yppredict[i]) + cj * S(0);
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < N; ++j) L.lu[r][j] = LuT(0);
  // band row o + SMU of column j holds J[j + o, j], the entry j + o of the
  // jvp on column j's color
#pragma unroll
  for (int color = 0; color < COLORS; ++color) {
    S v[N], w[N];
    T jv[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      v[i] = (i % WIDTH == color) ? S(1) : S(0);
      w[i] = cj * v[i];
    }
    M::res_jvp(c.p, t, yy, yp, v, w, jv);
#pragma unroll
    for (int j = color; j < N; j += WIDTH)
#pragma unroll
      for (int o = -MU; o <= ML; ++o)
        if (j + o >= 0 && j + o < N) L.lu[o + SMU][j] = narrow<LuT>(jv[j + o]);
  }
  bool jfinite = true;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < N; ++j) jfinite = jfinite && finite(L.lu[r][j]);
  const int failc = band_factor_dev<LuT, N, MU, ML>(L.lu, L.piv);
  return failc > 0 || !jfinite;
}

// One value of the GMRES basis as it is stored: in the Krylov type K, or the
// bits of K rounded to bfloat16 (krylov_storage="bfloat16"), widened at each
// read.
template <typename K, bool Bf16> struct BasisStore {
  using type = K;
  __device__ static __forceinline__ K put(K a) { return a; }
  __device__ static __forceinline__ K get(K a) { return a; }
};
template <typename K> struct BasisStore<K, true> {
  using type = unsigned short;
  __device__ static __forceinline__ unsigned short put(K a) { return bf16_bits(a); }
  __device__ static __forceinline__ K get(unsigned short a) { return of_bf16<K>(a); }
};

// sum0 of a * b over the N components, left to right (the Krylov dots)
template <typename K, int N>
__device__ __forceinline__ K dot_n(const K (&a)[N], const K (&b)[N]) {
  K acc = a[0] * b[0];
#pragma unroll
  for (int i = 1; i < N; ++i) acc = acc + a[i] * b[i];
  return acc;
}

// The Krylov operator (nls.py lsolve's atimes, IdaProblem.jtimes without a
// jtimes_fn): J v, the jvp of the residual at (t, yy, yp) in the Krylov
// type K with tangents (v, cj v), whose float64 parameters promote what they
// enter, rounded back to K.
template <typename T, class M, typename K>
__device__ __forceinline__ void atimes(const Ctx<T, M>& c, K t, K cj, const K (&yy)[M::N],
                                       const K (&yp)[M::N], const K (&v)[M::N],
                                       K (&out)[M::N]) {
  constexpr int N = M::N;
  K w[N];
  T jv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = cj * v[i];
  M::res_jvp(c.p, t, yy, yp, v, w, jv);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = narrow<K>(jv[i]);
}

// The linear solve of one Newton iteration under spgmr (nls.py lsolve, the
// Krylov branch, over ops/spgmr.py spgmr_solve): A x = -delta by restarted
// GMRES from x = 0 with s1 = s2 = ewt, no preconditioner, to the tolerance
// sqrt(N) * eplifac * eps_newt, every value in the Krylov type K (float32
// under "single"); the operator is taken at the iterate (yy_lin, yp_lin).
// Adds the iteration's nli, nps, njtimes (nli + 2 a cycle) and ncfl (1 when
// not converged) to the lane's counters; returns whether the solve counts as
// a success: converged, or on the first Newton iteration a reduced residual.
//
// Every dot product is a sum0 over the components, and the Givens algebra,
// the back substitution and the correction follow spgmr_solve op for op.
// The eager solve runs a cycle's Arnoldi columns until every lane of the
// batch is done; a lane done earlier commits zeros (H[i][j] = 0, y[j] = 0)
// for the columns past its own, which its back substitution and its
// correction then add after its own terms. Here a lane stops at its own
// column: adding +0 changes a sum only when the sum is -0, i.e. when every
// term of the lane's own is a zero, so the two agree but in the sign of such
// an all-zero sum (and beyond 32 columns, where sum0 turns to a tree whose
// shape follows the batch's column count).
template <typename T, class M>
__device__ __forceinline__ bool spgmr_solve(LaneOf<T, M>& L, const Ctx<T, M>& c,
                                            const T (&yy_lin)[M::N], const T (&yp_lin)[M::N],
                                            const T (&delta)[M::N], bool first_newton,
                                            T (&x_out)[M::N]) {
  constexpr int N = M::N, MAXL = M::kMaxl;
  using K = SingleReal<T, M>;
  using Store = BasisStore<K, M::kBf16>;
  const K tn = narrow<K>(L.tn), cj = narrow<K>(L.cj);
  K ewt[N], yy[N], yp[N], b[N], x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ewt[i] = narrow<K>(L.ewt[i]);
    yy[i] = narrow<K>(yy_lin[i]);
    yp[i] = narrow<K>(yp_lin[i]);
    b[i] = narrow<K>(-delta[i]);
    x[i] = K(0);
  }
  const K tol = narrow<K>(sqrt_of(T(N)) * T(c.opts.eplifac) * L.eps_newt);

  typename Store::type V[MAXL + 1][N];
  K H[MAXL][MAXL], cs[MAXL], sn[MAXL], g[MAXL + 1], y[MAXL], col[MAXL + 1];
  K res = K(INFINITY), res0 = K(INFINITY);
  bool converged = false;
  int restarts = 0, nli = 0, nps = 0;
#pragma unroll 1
  while (!converged && restarts < c.opts.krylov_max_restarts + 1) {
    // r = b - A x (b on the first cycle, from x = 0), z = s1 r
    K z[N];
    if (restarts == 0) {
#pragma unroll
      for (int i = 0; i < N; ++i) z[i] = ewt[i] * b[i];
    } else {
      K ax[N];
      atimes<T, M, K>(c, tn, cj, yy, yp, x, ax);
#pragma unroll
      for (int i = 0; i < N; ++i) z[i] = ewt[i] * (b[i] - ax[i]);
    }
    nps += 1;
    const K beta = sqrt_of(dot_n<K, N>(z, z));
#pragma unroll
    for (int i = 0; i < N; ++i) V[0][i] = Store::put(beta > K(0) ? z[i] / beta : z[i]);
    g[0] = beta;
#pragma unroll 1
    for (int j = 0; j < MAXL; ++j) g[j + 1] = cs[j] = sn[j] = K(0);
    bool done = beta <= tol;
    int jl = 0;
#pragma unroll 1
    for (int j = 0; j < MAXL && !done; ++j) {
      jl = j + 1;
      K u[N], w[N];
#pragma unroll
      for (int i = 0; i < N; ++i) u[i] = Store::get(V[j][i]) / ewt[i];
      atimes<T, M, K>(c, tn, cj, yy, yp, u, w);
#pragma unroll
      for (int i = 0; i < N; ++i) w[i] = ewt[i] * w[i];
      nps += 1;
      nli += 1;
      if constexpr (M::kClassical) {
        // CGS2: two passes of classical Gram-Schmidt against V[0..j]
        K hs[MAXL], hs2[MAXL], terms[MAXL];
#pragma unroll 1
        for (int pass = 0; pass < 2; ++pass) {
          K* h = pass == 0 ? hs : hs2;
#pragma unroll 1
          for (int i = 0; i <= j; ++i) {
            K vi[N];
#pragma unroll
            for (int n = 0; n < N; ++n) vi[n] = Store::get(V[i][n]);
            h[i] = dot_n<K, N>(vi, w);
          }
#pragma unroll
          for (int n = 0; n < N; ++n) {
#pragma unroll 1
            for (int i = 0; i <= j; ++i) terms[i] = h[i] * Store::get(V[i][n]);
            w[n] = w[n] - sum0_of<K, MAXL>(terms, j + 1);
          }
        }
#pragma unroll 1
        for (int i = 0; i <= j; ++i) col[i] = hs[i] + hs2[i];
      } else {
        // MGS
#pragma unroll 1
        for (int i = 0; i <= j; ++i) {
          K vi[N];
#pragma unroll
          for (int n = 0; n < N; ++n) vi[n] = Store::get(V[i][n]);
          const K hij = dot_n<K, N>(w, vi);
#pragma unroll
          for (int n = 0; n < N; ++n) w[n] = w[n] - hij * vi[n];
          col[i] = hij;
        }
      }
      const K hnorm = sqrt_of(dot_n<K, N>(w, w));
      col[j + 1] = hnorm;
#pragma unroll
      for (int n = 0; n < N; ++n) V[j + 1][n] = Store::put(hnorm > K(0) ? w[n] / hnorm : w[n]);

      // the earlier Givens rotations, then a new one to annihilate col[j+1]
#pragma unroll 1
      for (int i = 0; i < j; ++i) {
        const K tmp = cs[i] * col[i] - sn[i] * col[i + 1];
        col[i + 1] = sn[i] * col[i] + cs[i] * col[i + 1];
        col[i] = tmp;
      }
      const K denom = sqrt_of(col[j] * col[j] + col[j + 1] * col[j + 1]);
      const bool pos = denom > K(0);
      const K c_new = pos ? col[j] / denom : K(1);
      const K s_new = pos ? (-col[j + 1]) / denom : K(0);
      col[j] = c_new * col[j] - s_new * col[j + 1];
#pragma unroll 1
      for (int i = 0; i <= j; ++i) H[i][j] = col[i];
      cs[j] = c_new;
      sn[j] = s_new;
      const K gj = g[j];
      g[j] = c_new * gj;
      g[j + 1] = s_new * gj;
      done = absval(g[j + 1]) <= tol;
    }

    // back substitution H y = g over the lane's columns, then the correction
#pragma unroll 1
    for (int j = jl - 1; j >= 0; --j) {
      K s = g[j];
      if (j + 1 < jl) {
        K terms[MAXL];
#pragma unroll 1
        for (int k = j + 1; k < jl; ++k) terms[k - j - 1] = H[j][k] * y[k];
        s = g[j] - sum0_of<K, MAXL>(terms, jl - j - 1);
      }
      const K hjj = H[j][j];
      y[j] = (hjj != K(0)) ? s / hjj : K(0);
    }
    if (jl > 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        K terms[MAXL];
#pragma unroll 1
        for (int k = 0; k < jl; ++k) terms[k] = y[k] * Store::get(V[k][n]);
        x[n] = x[n] + sum0_of<K, MAXL>(terms, jl) / ewt[n];
      }
    }
    // the true scaled residual decides the restart
    K ax[N], rt[N];
    atimes<T, M, K>(c, tn, cj, yy, yp, x, ax);
#pragma unroll
    for (int i = 0; i < N; ++i) rt[i] = ewt[i] * (b[i] - ax[i]);
    nps += 1;
    res = sqrt_of(dot_n<K, N>(rt, rt));
    converged = res <= tol;
    res0 = (restarts == 0) ? beta : res0;
    restarts += 1;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x_out[i] = promote<T>(x[i]);
  L.nli += nli;
  L.nps += nps;
  L.njtimes += nli + 2 * restarts;
  L.ncfl += converged ? 0 : 1;
  const bool reduced = !converged && (res < res0);
  return converged || (first_newton && reduced);
}

// The inner Newton loop (nls.py _newton_iterate); the carry lives in the
// caller's variables (yy_lin/yp_lin: the iterate the Krylov operator is
// taken at, spgmr only).
template <typename T, class M>
__device__ __forceinline__ void _newton_iterate(LaneOf<T, M>& L, const Ctx<T, M>& c,
                                                T cjratio, T (&ycor)[M::N], T (&delta)[M::N],
                                                T (&yy_lin)[M::N], T (&yp_lin)[M::N],
                                                T& oldnrm, T& ss, int& istatus, int& knni,
                                                int& kre) {
  constexpr int N = M::N;
  constexpr bool krylov = M::kSolver == SOLVER_SPGMR;
  const T scale = (cjratio != T(1)) ? T(2) / (T(1) + cjratio) : T(1);
  int m = 0;
  istatus = NL_CONTINUE;
  while (istatus == NL_CONTINUE) {
    const bool first = m == 0;
    T x[N];
    bool lok = true;
    if constexpr (krylov) {
      lok = spgmr_solve<T, M>(L, c, yy_lin, yp_lin, delta, first, x);
#pragma unroll
      for (int i = 0; i < N; ++i) ycor[i] = ycor[i] + x[i];
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = -delta[i];
      direct_solve<T, M>(L, c, x);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        x[i] = x[i] * scale;
        ycor[i] = ycor[i] + x[i];
      }
    }

    const T delnrm = wrms_norm_bnd<T, M>(x, L.ewt, false);
    oldnrm = first ? delnrm : oldnrm;
    const bool conv_direct = first && (delnrm <= T(1.0e-4) * L.toldel);
    T rate = T(0);
    if (!first) rate = pow_of(delnrm / oldnrm, T(1) / T(max(m, 1)));
    const bool diverged = !first && (rate > T(RATEMAX));
    ss = !first ? rate / (T(1) - rate) : ss;
    const bool converged = conv_direct || (ss * delnrm <= L.eps_newt);

    m = m + 1;
    const bool exhausted = m >= c.opts.maxnlsit;
    istatus = diverged ? NL_CONV_RECVR
                       : (converged ? NL_OK : (exhausted ? NL_CONV_RECVR : NL_CONTINUE));
    // a failed linear solve is its own recoverable kind
    if (!lok) istatus = NL_LSOLVE_RECVR;

    const bool keep = istatus == NL_CONTINUE;
    if (keep) {
      T yy[N], yp[N], r[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        yy[i] = L.yypredict[i] + ycor[i];
        yp[i] = L.yppredict[i] + L.cj * ycor[i];
      }
      M::res(c.p, L.tn, yy, yp, r);
      bool rok = true;
#pragma unroll
      for (int i = 0; i < N; ++i) rok = rok && finite(r[i]);
      if (!rok) {
        istatus = NL_RES_RECVR;
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          delta[i] = r[i];
          if constexpr (krylov) {
            yy_lin[i] = yy[i];
            yp_lin[i] = yp[i];
          }
        }
      }
    }
    knni += 1;
    kre += keep ? 1 : 0;
  }
}

// nls.py _constraints, component i of the violation vector v = mm * (y -
// 0.1 * strict * c / ewt), mm = 1 where bit i of `viol` is set, else 0
template <typename T, int N, class Ln>
__device__ __forceinline__ T constraint_v(const Ln& L, int i, unsigned viol) {
  const T c = L.constraint(i);
  const T mm = ((viol >> i) & 1u) ? T(1) : T(0);
  const T strict = (absval(c) >= T(1.5)) ? T(1) : T(0);
  return mm * (L.yy[i] - T(0.1) * strict * c / L.ewt[i]);
}

// nls.py _constraints for a lane with constraints set whose Newton loop
// converged (codes 2: y > 0, 1: y >= 0, -1: y <= 0, -2: y < 0, 0: none).
// Returns REC_NONE (no violation, or a small one pulled back inside through
// ee) or REC_CONSTRAINT with the step ratio rr it asks for. A lane without a
// violation leaves here unchanged, as the eager block's selects leave it.
// The violations are a bit mask and v is recomputed where it is used (the
// same operations, so the same bits): the block holds no arrays of its own
// beside the lane's (measured on an H100: K2 at 234 registers with it, 226
// without, no spills; a form with mm[] and v[] arrays took 242).
template <typename T, class M>
__device__ __forceinline__ int constraints(LaneOf<T, M>& L) {
  constexpr int N = M::N;
  unsigned viol = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const T c = L.constraint(i), y = L.yy[i];
    const bool v = (c == T(2) && y <= T(0)) || (c == T(1) && y < T(0)) ||
                   (c == T(-1) && y > T(0)) || (c == T(-2) && y >= T(0));
    viol |= (v ? 1u : 0u) << i;
  }
  if (viol == 0) return REC_NONE;

  // wrms_norm_bnd(v, ewt): sqrt(sum0((v * ewt)^2) / N)
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const T t = constraint_v<T, N>(L, i, viol) * L.ewt[i];
    const T sq = t * t;
    acc = (i == 0) ? sq : acc + sq;
  }
  if (sqrt_of(acc / T(N)) <= L.eps_newt) {
#pragma unroll
    for (int i = 0; i < N; ++i) L.ee[i] = L.ee[i] - constraint_v<T, N>(L, i, viol);
    return REC_NONE;
  }
  // the smallest quotient phi[0] / (mm * (phi[0] - y)), inf where the
  // denominator is 0; NaN propagates through tmin and tmax as through
  // torch.amin and torch.maximum
  T minq = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const T phi0 = L.h.phi(0, i);
    const T mm = ((viol >> i) & 1u) ? T(1) : T(0);
    const T denom = mm * (phi0 - L.yy[i]);
    const T q = (denom != T(0)) ? phi0 / denom : T(INFINITY);
    minq = (i == 0) ? q : tmin(minq, q);
  }
  L.rr = tmax(T(0.9) * minq, T(0.1));
  return REC_CONSTRAINT;
}

// nonlinear_solve for an active lane; returns REC_NONE (ok) or a REC_* kind.
template <typename T, class M>
__device__ __forceinline__ int nonlinear_solve(LaneOf<T, M>& L, const Ctx<T, M>& c) {
  constexpr int N = M::N;
  const bool first = L.no_step_yet();
  const T cjold0 = first ? L.cj : L.cjold;
  T ss = first ? T(20) : L.ss;
  const T cjratio0 = L.cj / cjold0;
  const double lo = (1.0 - XRATE) / (1.0 + XRATE);
  bool call_lsetup = first || (cjratio0 < T(lo)) || (cjratio0 > T(1.0 / lo));
  ss = (L.cj != L.cjlast) ? T(100) : ss;

  // the linear-solver carry (_Lin): L.lu and L.piv in place, and
  T cjold = cjold0, cjratio = cjratio0;

  // inner carry (_Inner)
  T ycor[N], delta[N], yy_lin[N], yp_lin[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ycor[i] = T(0);
    delta[i] = L.savres[i];
  }
  T oldnrm = L.oldnrm;
  int knni = 0, kre = 0;

  bool jcur = false;
  int ostatus = NL_CONTINUE;
  while (ostatus == NL_CONTINUE) {
    // residual at the predictor (ycor = 0)
    T r[N];
    M::res(c.p, L.tn, L.yypredict, L.yppredict, r);
    kre = kre + 1;
    bool res_bad = false;
#pragma unroll
    for (int i = 0; i < N; ++i) res_bad = res_bad || !finite(r[i]);

    const bool do_setup = call_lsetup && !res_bad;
    bool setup_fail = false;
    if constexpr (M::kSolver != SOLVER_DENSE) {
      if (do_setup) {
        // _lsetup: the band Jacobian band-factored (one nje), or under spgmr
        // nothing but the counters (no preconditioner)
        if constexpr (M::kSolver == SOLVER_BAND) {
          setup_fail = band_lsetup<T, M>(L, c);
          L.nje += 1;
        }
        L.nsetups += 1;
        cjold = L.cj;
        cjratio = T(1);
        ss = T(20);
      }
    } else if (do_setup) {
      // _lsetup: J at the predictor, LU-factored
      if constexpr (M::kLs == LS_FULL) {
        M::jac(c.p, L.tn, L.cj, L.yypredict, L.yppredict, r, L.lu);
      } else {
        T J[N][N];
        if constexpr (M::kLs == LS_SINGLE) {
          // on arguments rounded to float32, evaluated in T (the float64
          // params promote them, nls.py _lsetup)
          T tn_r, cj_r, yy_r[N], yp_r[N], r_r[N];
          widen(to_f32(L.tn), tn_r);
          widen(to_f32(L.cj), cj_r);
#pragma unroll
          for (int i = 0; i < N; ++i) {
            widen(to_f32(L.yypredict[i]), yy_r[i]);
            widen(to_f32(L.yppredict[i]), yp_r[i]);
            widen(to_f32(r[i]), r_r[i]);
          }
          M::jac(c.p, tn_r, cj_r, yy_r, yp_r, r_r, J);
        } else {
          M::jac(c.p, L.tn, L.cj, L.yypredict, L.yppredict, r, J);
          // the linearization point the refinement's jvp takes
          L.ls_tn() = L.tn;
          L.ls_cj() = L.cj;
#pragma unroll
          for (int i = 0; i < N; ++i) {
            L.ls_yy(i) = L.yypredict[i];
            L.ls_yp(i) = L.yppredict[i];
          }
        }
#pragma unroll
        for (int i = 0; i < N; ++i)
#pragma unroll
          for (int j = 0; j < N; ++j) L.lu[i][j] = to_f32(J[i][j]);
      }
      bool jfinite = true;
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) jfinite = jfinite && finite(L.lu[i][j]);
      const int failc = lu_factor_dev<LuReal<T, M>, N>(L.lu, L.piv);
      setup_fail = (failc > 0) || !jfinite;
      L.nje += 1;
      L.nsetups += 1;
      cjold = L.cj;
      cjratio = T(1);
      ss = T(20);
    }
    jcur = jcur || do_setup;

    // a fresh inner carry
#pragma unroll
    for (int i = 0; i < N; ++i) {
      ycor[i] = T(0);
      delta[i] = r[i];
      yy_lin[i] = L.yypredict[i];
      yp_lin[i] = L.yppredict[i];
    }
    oldnrm = L.oldnrm;
    int istatus = NL_CONTINUE;
    const bool skip_newton = setup_fail || res_bad;
    if (!skip_newton)
      _newton_iterate<T, M>(L, c, cjratio, ycor, delta, yy_lin, yp_lin, oldnrm, ss, istatus,
                            knni, kre);

    const bool recvr = istatus == NL_CONV_RECVR || istatus == NL_LSOLVE_RECVR ||
                       istatus == NL_RES_RECVR;
    const bool retry = recvr && !jcur && !skip_newton;
    ostatus = setup_fail ? NL_LSETUP_RECVR
                         : (res_bad ? NL_RES_RECVR : (retry ? NL_CONTINUE : istatus));
    call_lsetup = retry;
    jcur = jcur && (istatus != NL_OK);
  }

  // fold the loop-local pieces back into the state
  L.cjold = cjold;
  L.cjratio = cjratio;
  L.nni = L.nni + knni;
  L.nre = L.nre + kre;
  L.oldnrm = oldnrm;
  L.ss = ss;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    L.savres[i] = delta[i];
    L.ee[i] = ycor[i];
    L.yy[i] = L.yypredict[i] + ycor[i];
    L.yp[i] = L.yppredict[i] + L.cj * ycor[i];
  }

  const int nl_status =
      ostatus == NL_OK
          ? REC_NONE
          : (ostatus == NL_LSETUP_RECVR
                 ? REC_LSETUP
                 : (ostatus == NL_RES_RECVR
                        ? REC_RESIDUAL
                        : (ostatus == NL_LSOLVE_RECVR ? REC_LSOLVE : REC_CONV)));
  return (nl_status == REC_NONE && c.opts.constraints && L.constraints_set())
             ? constraints<T, M>(L)
             : nl_status;
}

// ---------------------------------------------------------------- error_test.py

template <typename T, class M>
__device__ __forceinline__ bool error_test(LaneOf<T, M>& L, const Ctx<T, M>& c, T ck, T& err_k,
                                           T& err_km1) {
  constexpr int N = M::N;
  const int kk = L.kk;
  const T kkf = T(kk);
  const int km1 = max(kk - 1, 0);
  const int km2 = max(kk - 2, 0);

  // fast_math: the two picked rows take their phi-star scale
  const T s_k = M::kFastMath ? phi_star_s<T, M>(L, kk) : T(1);
  const T s_km1 = M::kFastMath ? phi_star_s<T, M>(L, km1) : T(1);
  T delta1[N], delta2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T row_k = L.h.phi(kk, i), row_km1 = L.h.phi(km1, i);
    if constexpr (M::kFastMath) {
      row_k = row_k * s_k;
      row_km1 = row_km1 * s_km1;
    }
    delta1[i] = row_k + L.ee[i];
    delta2[i] = delta1[i] + row_km1;
  }
  const T enorm_k = norm<T, M>(c, L.ee, L.ewt);
  const T enorm_km1 = norm<T, M>(c, delta1, L.ewt);
  const T enorm_km2 = norm<T, M>(c, delta2, L.ewt);

  err_k = L.h.sigma(kk) * enorm_k;
  const T terr_k = err_k * (kkf + T(1));
  const T err_km1_val = L.h.sigma(km1) * enorm_km1;
  const T terr_km1 = kkf * err_km1_val;
  const T err_km2 = L.h.sigma(km2) * enorm_km2;
  const T terr_km2 = (kkf - T(1)) * err_km2;

  const int knew_gt2 = (tmax(terr_km1, terr_km2) <= terr_k) ? kk - 1 : kk;
  const int knew_eq2 = (terr_km1 <= T(0.5) * terr_k) ? kk - 1 : kk;
  int knew = (kk > 2) ? knew_gt2 : knew_eq2;
  knew = (kk > 1) ? knew : kk;
  err_km1 = (kk > 1) ? err_km1_val : T(0);
  L.knew = knew;
  return (ck * enorm_k) <= T(1);
}

// ---------------------------------------------------------------- complete_step.py

template <typename T, class M>
__device__ __forceinline__ void complete_step(LaneOf<T, M>& L, const Ctx<T, M>& c, T err_k,
                                              T err_km1, T ck) {
  constexpr int N = M::N;
  const int maxord = c.opts.maxord;
  const bool had_steps = !L.no_step_yet();  // nst + 1 > 1
  const int kdiff = L.kk - L.kused;
  const int kused = L.kk;
  const T hused = L.hh;
  const T hmax_inv = L.hmax_inv();

  const int phase = (L.knew == L.kk - 1 || L.kk == maxord) ? 1 : L.phase;

  // phase 0: raise order and double step
  T hnew0 = T(2) * L.hh;
  const T tmp0 = absval(hnew0) * hmax_inv;
  hnew0 = (tmp0 > T(1)) ? hnew0 / tmp0 : hnew0;
  const bool grow = (phase == 0) && had_steps;
  const int kk_p0 = grow ? L.kk + 1 : L.kk;
  const T hh_p0 = grow ? hnew0 : L.hh;
  const T rr_p0 = L.rr;

  // phase 1: order selection
  const T kkf = T(L.kk);
  const int kp1 = min(L.kk + 1, MXORDP1 - 1);
  T dif[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dif[i] = L.ee[i] - L.h.phi(kp1, i);
  const T enorm_kp1 = norm<T, M>(c, dif, L.ewt);
  const T err_kp1 = enorm_kp1 / (kkf + T(2));

  const T terr_k = (kkf + T(1)) * err_k;
  const T terr_kp1 = (kkf + T(2)) * err_kp1;
  const T terr_km1 = kkf * err_km1;

  const int action_k1 = (terr_kp1 >= T(0.5) * terr_k) ? MAINTAIN : RAISE;
  const int action_kn = (terr_km1 <= tmin(terr_k, terr_kp1))
                            ? LOWER
                            : ((terr_kp1 >= terr_k) ? MAINTAIN : RAISE);
  int action = (L.kk == 1) ? action_k1 : action_kn;
  action = (L.kk + 1 >= L.ns || kdiff == 1) ? MAINTAIN : action;
  action = (L.kk == maxord) ? MAINTAIN : action;
  action = (L.knew == L.kk - 1) ? LOWER : action;

  const int kk_p1 = L.kk + (action == RAISE ? 1 : 0) - (action == LOWER ? 1 : 0);
  const T err_knew = (action == RAISE) ? err_kp1 : ((action == LOWER) ? err_km1 : err_k);

  const T base = T(2) * err_knew + T(1.0e-4);
  const T rr_p1 = pow_of(base, T(-1) / (T(kk_p1) + T(1)));
  T hnew1 = T(2) * L.hh;
  const T tmp1 = absval(hnew1) * hmax_inv;
  hnew1 = (tmp1 > T(1)) ? hnew1 / tmp1 : hnew1;
  const T rr_clamped = tmax(T(0.5), tmin(T(0.9), rr_p1));
  const T hh_p1 = (rr_p1 >= T(2)) ? hnew1 : ((rr_p1 <= T(1)) ? L.hh * rr_clamped : L.hh);
  const T rr_p1_out = (rr_p1 <= T(1)) ? rr_clamped : rr_p1;

  const bool in_phase0 = phase == 0;
  const int kk = in_phase0 ? kk_p0 : kk_p1;
  const T hh = in_phase0 ? hh_p0 : hh_p1;
  const T rr = in_phase0 ? rr_p0 : rr_p1_out;

  // phi: save ee into phi[kused+1], and the recurrence over rows kused..0;
  // the rows above stay as they are. Under fast_math the recurrence takes
  // the phi-star value phi[j] * s[j] and writes true phi rows
  const bool save = kused < maxord;
  T tmp[N];
#pragma unroll
  for (int n = 0; n < N; ++n) tmp[n] = L.ee[n];
#pragma unroll
  for (int j = MXORDP1 - 1; j >= 0; --j) {
    if (save && kused + 1 == j) {
#pragma unroll
      for (int n = 0; n < N; ++n) L.h.phi(j, n) = L.ee[n];
    } else if (kused >= j) {
      const T s = M::kFastMath ? phi_star_s<T, M>(L, j) : T(1);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        T ph = L.h.phi(j, n);
        if constexpr (M::kFastMath) ph = ph * s;
        tmp[n] = tmp[n] + ph;
        L.h.phi(j, n) = tmp[n];
      }
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) L.ee[n] = L.ee[n] * ck;

  L.nst += 1;
  L.kused = kused;
  L.hused = hused;
  L.phase = phase;
  L.kk = kk;
  L.hh = hh;
  L.rr = rr;
}

// ---------------------------------------------------------------- step.py

// failure policy for a lane whose attempt failed; returns the fatal code
template <typename T, class M>
__device__ __forceinline__ int _handle_n_flag(LaneOf<T, M>& L, const Ctx<T, M>& c, int kind,
                                              T err_k, T err_km1, int& ncf, int& nef) {
  L.phase = 1;
  const bool is_etf = kind == ERROR_TEST_FAIL;

  const int nef_new = nef + 1;
  const T err_knew = (L.kk == L.knew) ? err_k : err_km1;
  const int kk1 = L.knew;
  T rr1 = T(0.9) * pow_of(T(2) * err_knew + T(1.0e-4), T(-1) / (T(kk1) + T(1)));
  rr1 = tmax(T(0.25), tmin(T(0.9), rr1));
  const int kk_etf = (nef_new >= 3) ? 1 : kk1;
  const T rr_etf = (nef_new == 1) ? rr1 : T(0.25);
  const bool etf_fatal = nef_new >= c.opts.maxnef;

  const int ncf_new = ncf + 1;
  const T rr_cf = (kind == REC_CONSTRAINT) ? L.rr : T(0.25);
  const bool cf_fatal = ncf_new >= c.opts.maxncf;
  const int cf_fatal_code =
      (kind == REC_RESIDUAL)
          ? REP_RES_ERR
          : ((kind == REC_CONSTRAINT)
                 ? CONSTR_FAIL
                 : ((kind == REC_LSETUP) ? LSETUP_FAIL
                                         : ((kind == REC_LSOLVE) ? LSOLVE_FAIL : CONV_FAIL)));

  const int kk = is_etf ? kk_etf : L.kk;
  const T rr = is_etf ? rr_etf : rr_cf;
  const T hh = L.hh * rr;
  nef = is_etf ? nef_new : nef;
  ncf = is_etf ? ncf : ncf_new;
  L.netf += is_etf ? 1 : 0;
  L.ncfn += is_etf ? 0 : 1;
  const int fatal =
      is_etf ? (etf_fatal ? ERR_FAIL : CONTINUE) : (cf_fatal ? cf_fatal_code : CONTINUE);
  L.kk = kk;
  L.rr = rr;
  L.hh = hh;
  return fatal;
}

// step_begin for a lane that begins a fresh step
template <typename T, class M>
__device__ __forceinline__ void step_begin(LaneOf<T, M>& L) {
  if (L.no_step_yet()) {
    L.kk = 1;
    L.kused = 0;
    L.hused = T(0);
    L.h.psi(0) = L.hh;
    L.cj = T(1) / L.hh;
    L.phase = 0;
    L.ns = 0;
  }
}

// ---------------------------------------------------------------- quad.py

// accumulate_quad for a lane whose step was accepted (after complete_step):
// yQ += the 3-point Gauss-Legendre integral of M::quad over [tn - hused,
// tn] on the new interpolant, in quad_increment's order of operations (the
// nodes in _G3's order, the weights' products summed left to right, then
// times half). yQ is a cold field, read and written in device memory here.
template <typename T, class M>
__device__ __forceinline__ void accumulate_quad(const LaneOf<T, M>& L, const Ctx<T, M>& c) {
  if constexpr (M::NQ > 0) {
    constexpr int NQ = M::NQ;
    constexpr double kNode[3] = {-0.7745966692414834, 0.0, 0.7745966692414834};
    constexpr double kWeight[3] = {5.0 / 9.0, 8.0 / 9.0, 5.0 / 9.0};
    const T a = L.tn - L.hused;
    const T mid = T(0.5) * (a + L.tn);
    const T half = T(0.5) * (L.tn - a);
    T acc[NQ];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T t = mid + half * T(kNode[k]);
      T yy[M::N], yp[M::N], q[NQ];
      get_solution<T, M, false>(L, t, yy, yp);
      M::quad(c.p, t, yy, yp, q);
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const T term = T(kWeight[k]) * q[i];
        acc[i] = (k == 0) ? term : acc[i] + term;
      }
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      T& yq = ((T*)L.io->yQ)[L.batch_last ? (long long)i * L.B + L.b : L.b * NQ + i];
      yq = yq + half * acc[i];
    }
  }
}

struct AttemptOut {
  bool success;
  int fatal;
};

// attempt_once for an active lane: ck/err_k/err_km1 out, ncf/nef in-out
template <typename T, class M>
__device__ __forceinline__ AttemptOut attempt_once(LaneOf<T, M>& L, const Ctx<T, M>& c,
                                                   T saved_t, int& ncf, int& nef, T& ck, T& err_k,
                                                   T& err_km1) {
  ck = set_coeffs<T, M>(L);

  // advance tn, clamping to tstop against roundoff
  T tn = L.tn + L.hh;
  if (L.tstop_set) {
    const T tstop = L.tstop();
    tn = ((tn - tstop) * L.hh > T(0)) ? tstop : tn;
  }
  L.tn = tn;

  predict<T, M>(L);
  const int nl_status = nonlinear_solve<T, M>(L, c);

  T ek, ekm1;
  const bool converged = error_test<T, M>(L, c, ck, ek, ekm1);
  const bool nl_ok = nl_status == REC_NONE;
  const bool success = nl_ok && converged;
  const int kind = nl_ok ? ERROR_TEST_FAIL : nl_status;
  err_k = nl_ok ? ek : T(0);
  err_km1 = nl_ok ? ekm1 : T(0);

  int fatal = CONTINUE;
  if (!success) {
    restore<T, M>(L, saved_t);
    fatal = _handle_n_flag<T, M>(L, c, kind, err_k, err_km1, ncf, nef);
    if (fatal == CONTINUE && L.no_step_yet()) reset<T, M>(L);
  }
  return {success, fatal};
}

// ---------------------------------------------------------------- solve.py

// _first_call_init; returns istate (CONTINUE unless an input check fails)
template <typename T, class M>
__device__ __forceinline__ int _first_call_init(LaneOf<T, M>& L, const Ctx<T, M>& c) {
  constexpr int N = M::N;
  int istate = CONTINUE;
  const T tout = c.tout;
  const T tstop = L.tstop(), hmax_inv = L.hmax_inv(), epcon = L.epcon();

  T phi0[N], phi1[N];
  phi_row<T, N>(L, 0, phi0);
  phi_row<T, N>(L, 1, phi1);
  ewt_set<T, M>(c, phi0, L.ewt);
  if (ewt_invalid<T, N>(L.ewt)) istate = BAD_EWT;

  const T tdist = absval(tout - L.tn);
  const T troundoff = T(2.0 * Eps<T>::v) * (absval(L.tn) + absval(tout));
  if (tdist == T(0) || tdist < troundoff) istate = ILL_INPUT;

  T hh = L.hin();
  if (hh != T(0) && (tout - L.tn) * hh < T(0)) istate = ILL_INPUT;
  T hh_auto = T(0.001) * tdist;
  const T ypnorm = norm<T, M>(c, phi1, L.ewt);
  hh_auto = (ypnorm > T(2) / hh_auto) ? T(0.5) / ypnorm : hh_auto;
  hh_auto = (tout < L.tn) ? -hh_auto : hh_auto;
  hh = (hh == T(0)) ? hh_auto : hh;

  const T rh = absval(hh) * hmax_inv;
  hh = (rh > T(1)) ? hh / rh : hh;

  if (L.tstop_set && (tstop - L.tn) * hh <= T(0)) istate = ILL_INPUT;
  const bool clamp = L.tstop_set && ((L.tn + hh - tstop) * hh > T(0));
  hh = clamp ? (tstop - L.tn) * T(1.0 - 4.0 * Eps<T>::v) : hh;

  L.hh = hh;
  L.h0u() = hh;
  L.kk = 0;
  L.kused = 0;
#pragma unroll
  for (int n = 0; n < N; ++n) L.h.phi(1, n) = phi1[n] * hh;
  L.eps_newt = epcon;
  L.toldel = T(1.0e-4) * epcon;
  return istate;
}

// hh clamp to land on tstop (both stop tests)
template <typename T, class M>
__device__ __forceinline__ void _tstop_clamp(LaneOf<T, M>& L, int istate) {
  if (L.tstop_set && istate == CONTINUE) {
    const T tstop = L.tstop();
    const bool clamp = (L.tn + L.hh - tstop) * L.hh > T(0);
    L.hh = clamp ? (tstop - L.tn) * T(1.0 - 4.0 * Eps<T>::v) : L.hh;
  }
}

// _stop_test1, TASK_NORMAL; returns istate, updates tret
template <typename T, class M>
__device__ __forceinline__ int _stop_test1(LaneOf<T, M>& L, T tout, T& tret) {
  const T tstop = L.tstop(), tretlast = L.tretlast();
  const bool bad_tstop = L.tstop_set && ((L.tn - tstop) * L.hh > T(0));
  int istate = bad_tstop ? ILL_INPUT : CONTINUE;
  const T troundoff = T(100.0 * Eps<T>::v) * (absval(L.tn) + absval(L.hh));

  const bool hit_prev = tout == tretlast;
  const bool past_tout = (L.tn - tout) * L.hh >= T(0);
  const bool at_tstop = L.tstop_set && (absval(L.tn - tstop) <= troundoff);
  const bool sel_tstop = at_tstop && !(hit_prev || past_tout);

  // y(tout), kept when tout is past and legal for interpolation; else
  // y(tstop) for a lane that stops there
  T yy[M::N], yp[M::N];
  const bool ok = get_solution<T, M>(L, tout, yy, yp);
  const bool sel_tout = past_tout && ok && !hit_prev;
  if (sel_tout) {
#pragma unroll
    for (int n = 0; n < M::N; ++n) {
      L.yy[n] = yy[n];
      L.yp[n] = yp[n];
    }
  }
  if (sel_tstop) get_solution<T, M>(L, tstop);

  const bool hit_or_past = hit_prev || past_tout;
  const T newret = hit_or_past ? tout : (sel_tstop ? tstop : tret);
  const bool returning = hit_or_past || sel_tstop;
  tret = returning ? newret : tret;
  if (returning) L.tretlast() = newret;
  L.tstop_set = L.tstop_set && !sel_tstop;
  const int code = hit_or_past ? ((past_tout && !(hit_prev || ok)) ? BAD_T : SUCCESS)
                               : (sel_tstop ? TSTOP_RETURN : CONTINUE);
  istate = (istate != CONTINUE) ? istate : code;
  _tstop_clamp<T, M>(L, istate);
  return istate;
}

// _stop_test2, TASK_NORMAL, interpolation deferred; returns istate
template <typename T, class M>
__device__ __forceinline__ int _stop_test2(LaneOf<T, M>& L, T tout, T& tret, int& ikind,
                                           T& itgt) {
  bool sel_tstop = false;
  T tstop = T(0);
  const bool past_tout = (L.tn - tout) * L.hh >= T(0);
  if (L.tstop_set) {
    tstop = L.tstop();
    const T troundoff = T(100.0 * Eps<T>::v) * (absval(L.tn) + absval(L.hh));
    sel_tstop = (absval(L.tn - tstop) <= troundoff) && !past_tout;
  }
  ikind = (past_tout || sel_tstop) ? 1 : 0;
  itgt = past_tout ? tout : (sel_tstop ? tstop : T(0));
  const T newret = past_tout ? tout : (sel_tstop ? tstop : tret);
  const bool returning = past_tout || sel_tstop;
  tret = returning ? newret : tret;
  if (returning) L.tretlast() = newret;
  L.tstop_set = L.tstop_set && !sel_tstop;
  const int istate = past_tout ? SUCCESS : (sel_tstop ? TSTOP_RETURN : CONTINUE);
  _tstop_clamp<T, M>(L, istate);
  return istate;
}

// _step_preamble for a lane about to start a new step
template <typename T, class M>
__device__ __forceinline__ void _step_preamble(LaneOf<T, M>& L, const Ctx<T, M>& c,
                                               Carry<T>& cr) {
  constexpr int N = M::N;
  const bool too_much = cr.nstloc >= c.opts.mxstep;
  bool ewt_bad = false;
  T phi0[N];
  phi_row<T, N>(L, 0, phi0);
  if (!L.no_step_yet()) {
    ewt_set<T, M>(c, phi0, L.ewt);
    ewt_bad = ewt_invalid<T, N>(L.ewt);
  }
  const T nrm = norm<T, M>(c, phi0, L.ewt);
  const T tolsf = T(Eps<T>::v) * nrm;
  const bool too_acc = tolsf > T(1);
  if (too_acc) L.tolsf() = tolsf * T(10);

  if (too_much || ewt_bad || too_acc) {
    cr.istate = too_much ? TOO_MUCH_WORK : (ewt_bad ? BAD_EWT : TOO_MUCH_ACC);
    cr.tret = L.tn;
    L.tretlast() = L.tn;
    cr.ikind = 1;
    cr.itgt = L.tn;
  }
}

// the prologue of solve (TASK_NORMAL), up to the loop's initial carry
template <typename T, class M>
__device__ __forceinline__ void solve_prologue(LaneOf<T, M>& L, const Ctx<T, M>& c,
                                               Carry<T>& cr) {
  L.toutc() = c.tout;
  L.taskc() = 0;
  cr.tret = L.tn;
  const bool first = L.no_step_yet();
  cr.istate = first ? _first_call_init<T, M>(L, c) : CONTINUE;
  if (!first) cr.istate = _stop_test1<T, M>(L, c.tout, cr.tret);
  cr.nstloc = 0;
  cr.ikind = 0;
  cr.itgt = T(0);
  if (cr.istate == CONTINUE) _step_preamble<T, M>(L, c, cr);
  cr.saved_t = L.tn;
  cr.ncf = 0;
  cr.nef = 0;
  cr.fresh = true;
}

// one iteration of the attempt loop for an active lane (cr.istate == CONTINUE)
template <typename T, class M>
__device__ __forceinline__ void attempt_loop_body(LaneOf<T, M>& L, const Ctx<T, M>& c,
                                                  Carry<T>& cr) {
  if (cr.fresh) {
    cr.saved_t = L.tn;
    step_begin<T, M>(L);
    cr.ncf = 0;
    cr.nef = 0;
  }
  T ck, err_k, err_km1;
  const AttemptOut a = attempt_once<T, M>(L, c, cr.saved_t, cr.ncf, cr.nef, ck, err_k, err_km1);
  if (a.success) {
    complete_step<T, M>(L, c, err_k, err_km1, ck);
    accumulate_quad<T, M>(L, c);
  }

  if (a.fatal != CONTINUE) {
    cr.ikind = 1;
    cr.itgt = L.tn;
    cr.tret = L.tn;
    L.tretlast() = L.tn;
    cr.istate = a.fatal;
  }
  if (a.success) cr.nstloc += 1;

  if (cr.istate == CONTINUE && a.success) {
    cr.istate = _stop_test2<T, M>(L, c.tout, cr.tret, cr.ikind, cr.itgt);
    if (cr.istate == CONTINUE) _step_preamble<T, M>(L, c, cr);
  }
  cr.fresh = a.success;
}

// the deferred interpolation and the status lane, after the loop
template <typename T, class M>
__device__ __forceinline__ void solve_epilogue(LaneOf<T, M>& L, const Carry<T>& cr) {
  if (cr.ikind > 0) get_solution<T, M>(L, cr.itgt);
  L.status() = cr.istate;
}

}  // namespace ida
