// The whole IDA solve in one kernel for Hopper (sm_90a): one thread per
// ensemble lane, the attempt loop on the device.
//
// Replaces the Pallas TPU kernels of ida_tpu/ops/fused_solve.py:
//   K2  make_fused_solve -> kern (the whole core.solve per 1024-lane tile),
//   K3  _make_budgeted_fused_solve -> fn_init.kern (K2 with a fixed attempt
//       budget, writing the resume carry),
//   K4  _make_budgeted_fused_solve -> fn_cont.kern (resume from the carry),
// and the stage harness of scripts/bisect_fused.py (build_stage -> kern, K5):
// each fused_stage_<name> runs one solver stage, the same device function
// the whole-solve kernel calls, alone.
//
// The TPU kernel was float32 only and packed the state into two [rows, TILE]
// buffers. The solve kernel here reads the IdaState fields where the entry
// point has them, batch-leading ([B, ...]) and in their own dtypes (f64 or
// f32 reals, int32 order/status fields, int64 counters), and writes a
// batch-leading result out of place (K2, K3) or in place (K4), so the
// wrapper moves no layout around the launch; rtol, atol and tout, shared by
// every lane, travel by value in the argument struct. The stage kernels keep
// the batch-native layout ([..., B]) of the eager core they are held against.
//
// What bounds it: operations, not bytes. A lane's state (about 0.9 KB in
// f64) is read once and written once, while its solve is tens of thousands
// of dependent floating-point operations (a few hundred per step attempt,
// about a hundred per Newton iteration, with f64 divisions, sqrt and pow).
// Each lane's chain is serial, no operation may be fused into a
// multiply-add, and f64 division, sqrt and pow are long instruction
// sequences, so what the kernel spends is instructions of one thread, not
// memory traffic. The design keeps that count down:
// * the state never goes through local memory: the rows indexed by the
//   run-time order live in dynamic shared memory as [row][thread]
//   (6 * (N + 5) reals a thread: 24 KB a block of 64 at N = 3 in f64), the
//   rest in registers (every device function is inlined, ida_lane.cuh);
// * __launch_bounds__(IDA_THREADS, IDA_MIN_BLOCKS) = (64, 4): the f64
//   kernel needs 226 registers to hold a lane without spilling, which allows
//   256 threads an SM. Measured on an H100 (65,536 lanes, f64), every
//   spill-free shape (blocks of 32, 64, 128, 256) takes 0.99-1.03 ms, while
//   capping the registers for more warps an SM costs more in spill traffic
//   than the warps hide: 1.15 ms at 168 registers (3 blocks of 128), 1.2 ms
//   at 128 (4 blocks of 128, one wave). Among the spill-free shapes,
//   blocks of 64 spread a small batch over more SMs than larger blocks do;
// * pow and sqrt are inlined: the file is one translation unit built with
//   nvcc's default -fmad=true, as PyTorch's kernels are, and the solve's own
//   arithmetic keeps one rounding per operation through ida::Real
//   (rounded.cuh).
// Registers, stack and spills per entry point are in the nvcc log beside the
// library (-Xptxas -v); fused_solve_occupancy reports the resident blocks.
//
// Parity with the eager port on the card is bit for bit (see ida_lane.cuh).
//
// One library per arithmetic mode and linear solver: built with
// -DIDA_FAST_MATH=1 and/or -DIDA_LS_PRECISION=1 ("single") or 2 ("refined")
// its solve entry points run that mode of IdaOptions, and with
// -DIDA_LINEAR_SOLVER=1 (band: -DIDA_BAND_MU, -DIDA_BAND_ML) or 2 (spgmr:
// -DIDA_KRYLOV_MAXL, -DIDA_KRYLOV_GS=1 for CGS2, -DIDA_KRYLOV_BF16=1 for a
// bfloat16 basis) that linear solver in place of the dense LU
// (ops/fused_solve.py mode_flags); the parity build (no flag) is the one
// that also holds the stage kernels.
//
// The model: the hand-written Roberts below, or, built with
// -DIDA_MODEL_HEADER=1, the struct GeneratedModel that ops/fused_model.py
// writes from a problem factory into "ida_model.cuh" beside the library
// (same interface; its solve entry points then compile that model, and the
// stage kernels, Roberts-only, are left out). A model with quadratures
// (Model::NQ > 0) has its quad integrated into the state's yQ after every
// accepted step (ida_lane.cuh accumulate_quad). fused_model_eval_<dt> runs
// the model's res, jac, res_jvp and quad alone on a batch of lanes, so that
// each can be held against the eager problem's; built with -DIDA_EVAL_ONLY=1
// the library holds that entry point alone.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(); none allocates or synchronizes. `model` is the id of
// the library's model (Roberts 0, a generated model its kId); any other
// value returns cudaErrorInvalidValue.

#include <climits>

#include <cuda_runtime.h>

#include "ida_lane.cuh"
#ifdef IDA_MODEL_HEADER
#include "model_ops.cuh"
#include "ida_model.cuh"
#endif

#ifndef IDA_FAST_MATH
#define IDA_FAST_MATH 0
#endif
#ifndef IDA_LS_PRECISION
#define IDA_LS_PRECISION 0
#endif
#ifndef IDA_EVAL_ONLY
#define IDA_EVAL_ONLY 0
#endif
#ifndef IDA_LINEAR_SOLVER
#define IDA_LINEAR_SOLVER 0
#endif
#ifndef IDA_BAND_MU
#define IDA_BAND_MU 0
#endif
#ifndef IDA_BAND_ML
#define IDA_BAND_ML 0
#endif
#ifndef IDA_KRYLOV_MAXL
#define IDA_KRYLOV_MAXL 5
#endif
#ifndef IDA_KRYLOV_GS
#define IDA_KRYLOV_GS 0
#endif
#ifndef IDA_KRYLOV_BF16
#define IDA_KRYLOV_BF16 0
#endif

namespace {

using ida::kThreads;
// what one block may ask for (the SM's 228 KB less 1 KB a block)
constexpr size_t kMaxSharedBytes = 227 * 1024;

// Robertson kinetics, ida_tpu_torch/models/roberts.py (params [k1, k2, k3]
// per lane), in the eager code's order of operations.
struct Roberts {
  static constexpr int N = 3;
  static constexpr int P = 3;
  static constexpr int NQ = 0;  // no quadratures
  static constexpr int kId = 0;
  __device__ static bool id(int i) { return i != 2; }

  template <typename T>
  __device__ static void res(const T (&p)[P], T t, const T (&yy)[N], const T (&yp)[N],
                             T (&r)[N]) {
    const T r0 = -p[0] * yy[0] + p[1] * yy[1] * yy[2];
    const T r1 = -r0 - p[2] * yy[1] * yy[1] - yp[1];
    r[0] = r0 - yp[0];
    r[1] = r1;
    r[2] = yy[0] + yy[1] + yy[2] - T(1);
  }

  // the tangent of res with tangents (v, w) of (yy, yp), as torch's forward
  // AD computes it op by op (torch.func.jvp of res: d(a * b) = a' * b + a *
  // b', the params carry no tangent); the refinement's and the Krylov
  // operator's J v with w = cj v, and the band Jacobian's colored columns.
  // The arguments but the params may be of a narrower type S (float32 under
  // ls_precision "single"): what meets a parameter is promoted to T, as torch
  // promotes it, and the rest (jv[2]) is computed in S
  template <typename T, typename S>
  __device__ static void res_jvp(const T (&p)[P], S t, const S (&yy)[N], const S (&yp)[N],
                                 const S (&v)[N], const S (&w)[N], T (&jv)[N]) {
    using ida::promote;
    const T a = p[1] * promote<T>(yy[1]);
    const T a_t = p[1] * promote<T>(v[1]);
    const T r0_t = (-p[0]) * promote<T>(v[0]) + (a * promote<T>(v[2]) + a_t * promote<T>(yy[2]));
    const T c = p[2] * promote<T>(yy[1]);
    const T c_t = p[2] * promote<T>(v[1]);
    jv[0] = r0_t - promote<T>(w[0]);
    jv[1] = (-r0_t - (c * promote<T>(v[1]) + c_t * promote<T>(yy[1]))) - promote<T>(w[1]);
    jv[2] = promote<T>(v[0] + v[1] + v[2]);
  }

  template <typename T>
  __device__ static void jac(const T (&p)[P], T t, T cj, const T (&yy)[N], const T (&yp)[N],
                             const T (&rr)[N], T (&J)[N][N]) {
    J[0][0] = -p[0] - cj;
    J[0][1] = p[1] * yy[2];
    J[0][2] = p[1] * yy[1];
    J[1][0] = p[0];
    J[1][1] = -p[1] * yy[2] - T(2) * p[2] * yy[1] - cj;
    J[1][2] = -p[1] * yy[1];
    J[2][0] = T(1);
    J[2][1] = T(1);
    J[2][2] = T(1);
  }
};

// a model in one arithmetic mode and linear solver of IdaOptions (ida_lane.cuh)
template <class Model, bool FastMath, int Ls, int Solver = ida::SOLVER_DENSE, int Mu = 0,
          int Ml = 0, int Maxl = 5, bool Classical = false, bool Bf16 = false>
struct WithMode : Model {
  static constexpr bool kFastMath = FastMath;
  static constexpr int kLs = Ls;
  static constexpr int kSolver = Solver;
  static constexpr int kMu = Mu, kMl = Ml;  // band half-bandwidths
  static constexpr int kMaxl = Maxl;        // GMRES basis vectors
  static constexpr bool kClassical = Classical, kBf16 = Bf16;
};
#ifdef IDA_MODEL_HEADER
using Model = GeneratedModel;
#else
using Model = Roberts;
#endif
// the mode this library's solve entry points run, and the stage kernels'
using Solved = WithMode<Model, IDA_FAST_MATH != 0, IDA_LS_PRECISION, IDA_LINEAR_SOLVER,
                        IDA_BAND_MU, IDA_BAND_ML, IDA_KRYLOV_MAXL, IDA_KRYLOV_GS != 0,
                        IDA_KRYLOV_BF16 != 0>;
using Parity = WithMode<Roberts, false, ida::LS_FULL>;
static_assert(Model::N <= ida::MAXN, "a by-value atol carries MAXN components");
static_assert(IDA_LS_PRECISION >= ida::LS_FULL && IDA_LS_PRECISION <= ida::LS_REFINED,
              "IDA_LS_PRECISION is 0 (full), 1 (single) or 2 (refined)");
static_assert(IDA_LINEAR_SOLVER >= ida::SOLVER_DENSE && IDA_LINEAR_SOLVER <= ida::SOLVER_SPGMR,
              "IDA_LINEAR_SOLVER is 0 (dense), 1 (band) or 2 (spgmr)");
static_assert(IDA_LS_PRECISION != ida::LS_REFINED || IDA_LINEAR_SOLVER == ida::SOLVER_DENSE,
              "ls_precision \"refined\" is dense-only");
static_assert(IDA_BAND_MU >= 0 && IDA_BAND_ML >= 0 && IDA_KRYLOV_MAXL >= 1,
              "band half-bandwidths at least 0, krylov_maxl at least 1");

template <typename T>
__device__ __forceinline__ void load_carry(const ida::CarryRefs& r, long long b,
                                           ida::Carry<T>& c) {
  c.tret = ((const T*)r.tret)[b];
  c.istate = ((const int*)r.istate)[b];
  c.nstloc = ((const int*)r.nstloc)[b];
  c.saved_t = ((const T*)r.saved_t)[b];
  c.ncf = ((const int*)r.ncf)[b];
  c.nef = ((const int*)r.nef)[b];
  c.fresh = ((const unsigned char*)r.fresh)[b] != 0;
  c.ikind = ((const int*)r.ikind)[b];
  c.itgt = ((const T*)r.itgt)[b];
}

template <typename T>
__device__ __forceinline__ void store_carry(const ida::CarryRefs& r, long long b,
                                            const ida::Carry<T>& c) {
  ((T*)r.tret)[b] = c.tret;
  ((int*)r.istate)[b] = c.istate;
  if (r.nstloc == nullptr) return;
  ((int*)r.nstloc)[b] = c.nstloc;
  ((T*)r.saved_t)[b] = c.saved_t;
  ((int*)r.ncf)[b] = c.ncf;
  ((int*)r.nef)[b] = c.nef;
  ((unsigned char*)r.fresh)[b] = c.fresh ? 1 : 0;
  ((int*)r.ikind)[b] = c.ikind;
  ((T*)r.itgt)[b] = c.itgt;
}

}  // namespace

// The arguments of one launch of the whole solve (ops/fused_solve.py
// SolveArgs mirrors it): the batch-leading state read (`in`) and written
// (`out`, the same table for a launch in place), params [B, P], the
// tolerances and tout, the carry, the options, the batch size and the
// attempt budget of a budgeted launch.
struct IdaSolveArgs {
  ida::StateRefs in, out;
  const void* params;
  ida::TolArgs tol;
  ida::CarryRefs carry;
  ida::Opts opts;
  long long B;
  int budget;
};

// The arguments of one launch of the model alone (ops/fused_solve.py
// ModelEvalArgs mirrors it): batch-native inputs params [P, B], t and cj
// [B], yy, yp and v [N, B], and outputs res [N, B], jac [N, N, B], jv
// [N, B] (res_jvp with tangents (v, cj v)) and, for a model with
// quadratures, quad [NQ, B] (null, and not written, for the others).
struct ModelEvalArgs {
  const void *params, *t, *cj, *yy, *yp, *v;
  void *res, *jac, *jv;
  long long B;
  void* quad;
};

namespace {

// K2 (budget INT_MAX, resume 0), K3 (budget, resume 0), K4 (budget, resume 1)
template <typename T, class M, bool LaneTol>
__global__ void __launch_bounds__(IDA_THREADS, IDA_MIN_BLOCKS)
fused_solve_kernel(const __grid_constant__ IdaSolveArgs a, int budget, int resume) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  ida::LaneOf<T, M> L;
  ida::Ctx<T, M> c;
  ida::Carry<T> cr;
  ida::load_lane<T, M, ida::BatchLeading>(a.in, a.out, b, a.B, L);
  ida::load_ctx<T, M, LaneTol>(a.params, a.tol, a.opts, b, c);
  if (resume) {
    load_carry<T>(a.carry, b, cr);
  } else {
    ida::solve_prologue<T, M>(L, c, cr);
  }
  for (int n = 0; n < budget && cr.istate == ida::CONTINUE; ++n)
    ida::attempt_loop_body<T, M>(L, c, cr);
  ida::solve_epilogue<T, M>(L, cr);
  ida::store_lane<T, M, ida::BatchLeading>(a.in, a.out, b, a.B, L);
  store_carry<T>(a.carry, b, cr);
}

// K5: the stages, in place on a batch-native state. aux_f [*, B] (T) and
// aux_i [*, B] (int32) carry each stage's extra inputs and outputs, in the
// slots that ida_tpu_torch/ops/fused_stages.py STAGES names.
enum Stage { SET_COEFFS, NLS, ERROR_TEST, COMPLETE_STEP, ATTEMPT, PROLOGUE, STOPTEST, GETSOL };

template <typename T, class M, int S>
__global__ void __launch_bounds__(IDA_THREADS)
fused_stage_kernel(const __grid_constant__ ida::StateRefs s, const void* params, const void* rtol,
                   const void* atol, const void* tout, void* aux_f, void* aux_i, ida::Opts opts,
                   long long B) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  T* af = (T*)aux_f;
  int* ai = (int*)aux_i;
#define AF(k) af[(long long)(k) * B + b]
#define AI(k) ai[(long long)(k) * B + b]
  ida::LaneOf<T, M> L;
  ida::Ctx<T, M> c;
  ida::load_lane<T, M, ida::BatchLast>(s, s, b, B, L);
  ida::load_ctx_native<T, M>(params, rtol, atol, tout, opts, b, B, c);
  if (S == SET_COEFFS) {
    AF(0) = ida::set_coeffs<T, M>(L);
    ida::predict<T, M>(L);
  } else if (S == NLS) {
    AI(0) = ida::nonlinear_solve<T, M>(L, c);
  } else if (S == ERROR_TEST) {
    T err_k, err_km1;
    AI(0) = ida::error_test<T, M>(L, c, AF(0), err_k, err_km1) ? 1 : 0;
    AF(1) = err_k;
    AF(2) = err_km1;
  } else if (S == COMPLETE_STEP) {
    ida::complete_step<T, M>(L, c, AF(0), AF(1), AF(2));
  } else if (S == ATTEMPT) {
    int ncf = AI(0), nef = AI(1);
    T ck, err_k, err_km1;
    const ida::AttemptOut a = ida::attempt_once<T, M>(L, c, AF(0), ncf, nef, ck, err_k, err_km1);
    AI(0) = ncf;
    AI(1) = nef;
    AI(2) = a.success ? 1 : 0;
    AI(3) = a.fatal;
    AF(1) = ck;
    AF(2) = err_k;
    AF(3) = err_km1;
  } else if (S == PROLOGUE) {
    AI(0) = ida::_first_call_init<T, M>(L, c);
  } else if (S == STOPTEST) {
    T tret = L.tn, itgt;
    int ikind;
    AI(0) = ida::_stop_test1<T, M>(L, c.tout, tret);
    AI(1) = ida::_stop_test2<T, M>(L, c.tout, tret, ikind, itgt);
    AI(2) = ikind;
    AF(0) = tret;
    AF(1) = itgt;
  } else if (S == GETSOL) {
    AI(0) = ida::get_solution<T, M>(L, c.tout) ? 1 : 0;
  }
#undef AF
#undef AI
  ida::store_lane<T, M, ida::BatchLast>(s, s, b, B, L);
}

// The model's res, then jac at that residual, then res_jvp with tangents
// (v, cj v), as the solve calls them (the refinement's J v), one thread a lane.
template <typename T, class M>
__global__ void __launch_bounds__(IDA_THREADS)
model_eval_kernel(const __grid_constant__ ModelEvalArgs a) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  constexpr int N = M::N;
  const long long B = a.B;
  T p[M::P], yy[N], yp[N], v[N], w[N], r[N], jv[N], J[N][N];
  const T t = ((const T*)a.t)[b], cj = ((const T*)a.cj)[b];
  for (int i = 0; i < M::P; ++i) p[i] = ((const T*)a.params)[i * B + b];
  for (int i = 0; i < N; ++i) {
    yy[i] = ((const T*)a.yy)[i * B + b];
    yp[i] = ((const T*)a.yp)[i * B + b];
    v[i] = ((const T*)a.v)[i * B + b];
    w[i] = cj * v[i];
  }
  M::res(p, t, yy, yp, r);
  M::jac(p, t, cj, yy, yp, r, J);
  M::res_jvp(p, t, yy, yp, v, w, jv);
  for (int i = 0; i < N; ++i) {
    ((T*)a.res)[i * B + b] = r[i];
    ((T*)a.jv)[i * B + b] = jv[i];
    for (int j = 0; j < N; ++j) ((T*)a.jac)[(i * N + j) * B + b] = J[i][j];
  }
  if constexpr (M::NQ > 0) {
    T q[M::NQ];
    M::quad(p, t, yy, yp, q);
    for (int i = 0; i < M::NQ; ++i) ((T*)a.quad)[i * B + b] = q[i];
  }
}

inline unsigned grid_for(long long B) { return (unsigned)((B + kThreads - 1) / kThreads); }

// Let `kernel` use `bytes` of dynamic shared memory; an error when one block
// of this model and dtype does not fit an SM.
template <class K>
int allow_shared(K kernel, size_t bytes) {
  if (bytes > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T, bool LaneTol>
int launch_solve_as(const IdaSolveArgs& a, int budget, int resume, void* stream) {
  constexpr size_t shared = ida::Hist<T, Model::N>::kBytes;
  auto kernel = fused_solve_kernel<T, Solved, LaneTol>;
  const int err = allow_shared(kernel, shared);
  if (err != (int)cudaSuccess) return err;
  kernel<<<grid_for(a.B), kThreads, shared, (cudaStream_t)stream>>>(a, budget, resume);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_solve(const IdaSolveArgs* a, int model, int budget, int resume, void* stream) {
  if (model != Model::kId || budget < 1) return (int)cudaErrorInvalidValue;
  if ((a->tol.rtol_lanes == nullptr) != (a->tol.atol_lanes == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a->B <= 0) return (int)cudaSuccess;
  return a->tol.rtol_lanes ? launch_solve_as<T, true>(*a, budget, resume, stream)
                           : launch_solve_as<T, false>(*a, budget, resume, stream);
}

template <typename T, int S>
int launch_stage(const ida::StateRefs* s, const void* params, const void* rtol, const void* atol,
                 const void* tout, void* aux_f, void* aux_i, const ida::Opts* opts, int model,
                 long long B, void* stream) {
  if (model != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  constexpr size_t shared = ida::Hist<T, Roberts::N>::kBytes;
  auto kernel = fused_stage_kernel<T, Parity, S>;
  const int err = allow_shared(kernel, shared);
  if (err != (int)cudaSuccess) return err;
  kernel<<<grid_for(B), kThreads, shared, (cudaStream_t)stream>>>(
      *s, params, rtol, atol, tout, aux_f, aux_i, *opts, B);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_model_eval(const ModelEvalArgs* a, int model, void* stream) {
  if (model != Model::kId || ((Model::NQ > 0) != (a->quad != nullptr)))
    return (int)cudaErrorInvalidValue;
  if (a->B <= 0) return (int)cudaSuccess;
  auto kernel = model_eval_kernel<T, Model>;
  kernel<<<grid_for(a->B), kThreads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// The solve kernel's occupancy on the current device: resident blocks an SM
// at its registers and shared memory, and the SM count.
template <typename T>
int solve_occupancy(int* blocks_per_sm, int* shared_bytes, int* threads, int* sms) {
  constexpr size_t shared = ida::Hist<T, Model::N>::kBytes;
  auto kernel = fused_solve_kernel<T, Solved, false>;
  int err = allow_shared(kernel, shared);
  if (err != (int)cudaSuccess) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                           shared);
  if (err != (int)cudaSuccess) return err;
  int device = 0;
  err = (int)cudaGetDevice(&device);
  if (err != (int)cudaSuccess) return err;
  *shared_bytes = (int)shared;
  *threads = kThreads;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

using f64 = ida::Real<double>;
using f32 = ida::Real<float>;

}  // namespace

extern "C" {

#define IDA_SOLVE_ENTRY(dt)                                                                 \
  int fused_solve_##dt(const IdaSolveArgs* a, int model, void* stream) {                    \
    return launch_solve<dt>(a, model, INT_MAX, 0, stream);                                  \
  }                                                                                         \
  int fused_solve_init_##dt(const IdaSolveArgs* a, int model, void* stream) {               \
    return launch_solve<dt>(a, model, a->budget, 0, stream);                                \
  }                                                                                         \
  int fused_solve_cont_##dt(const IdaSolveArgs* a, int model, void* stream) {               \
    return launch_solve<dt>(a, model, a->budget, 1, stream);                                \
  }                                                                                         \
  int fused_solve_occupancy_##dt(int* blocks_per_sm, int* shared_bytes, int* threads,       \
                                 int* sms) {                                                \
    return solve_occupancy<dt>(blocks_per_sm, shared_bytes, threads, sms);                  \
  }
#define IDA_EVAL_ENTRY(dt)                                                                  \
  int fused_model_eval_##dt(const ModelEvalArgs* a, int model, void* stream) {              \
    return launch_model_eval<dt>(a, model, stream);                                         \
  }

IDA_EVAL_ENTRY(f64)
IDA_EVAL_ENTRY(f32)

#if !IDA_EVAL_ONLY
IDA_SOLVE_ENTRY(f64)
IDA_SOLVE_ENTRY(f32)
#endif

#if IDA_FAST_MATH == 0 && IDA_LS_PRECISION == 0 && IDA_LINEAR_SOLVER == 0 && \
    !defined(IDA_MODEL_HEADER) && !IDA_EVAL_ONLY

#define IDA_STAGE_ENTRY(name, S, dt)                                                        \
  int fused_stage_##name##_##dt(const ida::StateRefs* s, const void* params,                \
                                const void* rtol, const void* atol, const void* tout,       \
                                void* aux_f, void* aux_i, const ida::Opts* opts, int model, \
                                long long B, void* stream) {                                \
    return launch_stage<dt, S>(s, params, rtol, atol, tout, aux_f, aux_i, opts, model, B,   \
                               stream);                                                     \
  }
#define IDA_STAGE_BOTH(name, S) IDA_STAGE_ENTRY(name, S, f64) IDA_STAGE_ENTRY(name, S, f32)

IDA_STAGE_BOTH(set_coeffs, SET_COEFFS)
IDA_STAGE_BOTH(nls, NLS)
IDA_STAGE_BOTH(error_test, ERROR_TEST)
IDA_STAGE_BOTH(complete_step, COMPLETE_STEP)
IDA_STAGE_BOTH(attempt, ATTEMPT)
IDA_STAGE_BOTH(prologue, PROLOGUE)
IDA_STAGE_BOTH(stoptest, STOPTEST)
IDA_STAGE_BOTH(getsol, GETSOL)
#endif

}  // extern "C"
