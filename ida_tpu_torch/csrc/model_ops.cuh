// The ops of a model generated from a problem factory
// (ida_tpu_torch/ops/fused_model.py), one lane's scalars, each rounded as
// the eager op rounds it on the device the code runs on: the card build
// (__CUDA_ARCH__) does what ATen's CUDA kernels do, the host build of the
// CPU tests what the eager port does on the CPU, where
// utils/numerics.py's pow_, sqrt_, sin_ and cos_ call the C library.
// + - * / and sqrt are ida::Real's (rounded.cuh); every function here goes
// through Real too, so nvcc's -fmad=true contracts nothing of it.

#pragma once

#include <cmath>

#include "rounded.cuh"

namespace ida {
namespace model {

template <typename S>
__device__ __forceinline__ Real<S> make(S v) {
  Real<S> r;
  r.v = v;
  return r;
}

// a tensor divided by a Python number: ATen's CUDA kernel multiplies by the
// reciprocal, taken in double and rounded to the dtype (in float32 x / 34.4
// is x * (float)(1 / 34.4), not x * (1.0f / 34.4f)); the CPU divides
template <typename S>
__device__ __forceinline__ Real<S> div_scalar(Real<S> a, double c) {
#ifdef __CUDA_ARCH__
  return a * Real<S>(1.0 / c);
#else
  return a / Real<S>(c);
#endif
}

// ATen's sign (and sgn of a real tensor): (0 < a) - (a < 0), so 0 at -0
// and NaN
template <typename S>
__device__ __forceinline__ Real<S> sign(Real<S> a) {
  const Real<S> zero(0.0);
  return make((S)((zero < a) - (a < zero)));
}

// 1 / a (ATen's reciprocal on either device)
template <typename S>
__device__ __forceinline__ Real<S> recip(Real<S> a) {
  return Real<S>(1.0) / a;
}

#ifndef __CUDA_ARCH__
// the C library's pow of a run-time exponent: the compiler may not turn a
// constant one into multiplies (pow(x, 2.0) into x * x), as no eager CPU
// op does
inline double libm_pow(double a, double e) {
  volatile double run_time = e;
  return ::pow(a, run_time);
}
#endif

#ifdef __CUDA_ARCH__
// the exponent of CUDA's pow as a run-time value: ATen's kernels take it as
// an argument, and a constant the compiler folds into pow's instruction
// sequence may contract differently
__device__ __forceinline__ double run_time(double e) {
  asm("" : "+d"(e));
  return e;
}
__device__ __forceinline__ float run_time(float e) {
  asm("" : "+f"(e));
  return e;
}
#endif

#ifdef __CUDA_ARCH__
__device__ __forceinline__ double rsqrt_raw(double a) { return ::rsqrt(a); }
__device__ __forceinline__ float rsqrt_raw(float a) { return ::rsqrtf(a); }
__device__ __forceinline__ double exp_raw(double a) { return ::exp(a); }
__device__ __forceinline__ float exp_raw(float a) { return ::expf(a); }
__device__ __forceinline__ double log_raw(double a) { return ::log(a); }
__device__ __forceinline__ float log_raw(float a) { return ::logf(a); }
__device__ __forceinline__ double sin_raw(double a) { return ::sin(a); }
__device__ __forceinline__ float sin_raw(float a) { return ::sinf(a); }
__device__ __forceinline__ double cos_raw(double a) { return ::cos(a); }
__device__ __forceinline__ float cos_raw(float a) { return ::cosf(a); }
// the unary functions ATen's CUDA kernels call in the dtype (tanhf, not
// (float)tanh(double)); on the host the C library's in double, rounded to
// the dtype, as utils/numerics.py's tanh_, sinh_ and cosh_ call it on the
// CPU (ATen's own vectorised CPU versions are within 2 ulp of it)
#define IDA_MODEL_CUDA_FN(name)                                                   \
  __device__ __forceinline__ double name##_raw(double a) { return ::name(a); }   \
  __device__ __forceinline__ float name##_raw(float a) { return ::name##f(a); }
IDA_MODEL_CUDA_FN(tanh) IDA_MODEL_CUDA_FN(sinh) IDA_MODEL_CUDA_FN(cosh) IDA_MODEL_CUDA_FN(tan)
IDA_MODEL_CUDA_FN(atan) IDA_MODEL_CUDA_FN(expm1) IDA_MODEL_CUDA_FN(log1p)
#undef IDA_MODEL_CUDA_FN
#else
#define IDA_MODEL_LIBM_FN(name) \
  template <typename S> S name##_raw(S a) { return (S)std::name((double)a); }
IDA_MODEL_LIBM_FN(tanh) IDA_MODEL_LIBM_FN(sinh) IDA_MODEL_LIBM_FN(cosh) IDA_MODEL_LIBM_FN(tan)
IDA_MODEL_LIBM_FN(atan) IDA_MODEL_LIBM_FN(expm1) IDA_MODEL_LIBM_FN(log1p)
#undef IDA_MODEL_LIBM_FN
template <typename S> S rsqrt_raw(S a) { return S(1) / std::sqrt(a); }
template <typename S> S exp_raw(S a) { return std::exp(a); }
template <typename S> S log_raw(S a) { return std::log(a); }
template <typename S> S sin_raw(S a) { return std::sin(a); }
template <typename S> S cos_raw(S a) { return std::cos(a); }
#endif

template <typename S> __device__ __forceinline__ Real<S> rsqrt(Real<S> a) { return make(rsqrt_raw(a.v)); }
template <typename S> __device__ __forceinline__ Real<S> exp(Real<S> a) { return make(exp_raw(a.v)); }
template <typename S> __device__ __forceinline__ Real<S> log(Real<S> a) { return make(log_raw(a.v)); }
template <typename S> __device__ __forceinline__ Real<S> sin(Real<S> a) { return make(sin_raw(a.v)); }
template <typename S> __device__ __forceinline__ Real<S> cos(Real<S> a) { return make(cos_raw(a.v)); }
#define IDA_MODEL_UNARY(name) \
  template <typename S> __device__ __forceinline__ Real<S> name(Real<S> a) { return make(name##_raw(a.v)); }
IDA_MODEL_UNARY(tanh) IDA_MODEL_UNARY(sinh) IDA_MODEL_UNARY(cosh) IDA_MODEL_UNARY(tan)
IDA_MODEL_UNARY(atan) IDA_MODEL_UNARY(expm1) IDA_MODEL_UNARY(log1p)
#undef IDA_MODEL_UNARY

// tanh's derivative, grad * (1 - out * out): ATen's kernel on either device
// contracts 1 - out * out into a multiply-add (the CPU's vectorised one
// too), then multiplies
#ifdef __CUDA_ARCH__
__device__ __forceinline__ double fma_raw(double a, double b, double c) { return ::fma(a, b, c); }
__device__ __forceinline__ float fma_raw(float a, float b, float c) { return ::fmaf(a, b, c); }
#else
template <typename S> S fma_raw(S a, S b, S c) { return std::fma(a, b, c); }
#endif
template <typename S>
__device__ __forceinline__ Real<S> tanh_backward(Real<S> grad, Real<S> out) {
  return grad * make(fma_raw(-out.v, out.v, (S)1));
}

template <typename S> __device__ __forceinline__ bool isnan_of(Real<S> a) { return a.v != a.v; }

// maximum and minimum: NaN if either is NaN. On the card ATen returns the
// NaN operand (the first if both) and else CUDA's fmax/fmin; on the CPU
// ATen's vectorised kernel (MAXPD/MINPD) returns the second operand when the
// two compare equal (+0 and -0), and an all-ones NaN
#ifdef __CUDA_ARCH__
__device__ __forceinline__ double max_raw(double a, double b) { return ::fmax(a, b); }
__device__ __forceinline__ float max_raw(float a, float b) { return ::fmaxf(a, b); }
__device__ __forceinline__ double min_raw(double a, double b) { return ::fmin(a, b); }
__device__ __forceinline__ float min_raw(float a, float b) { return ::fminf(a, b); }
template <typename S>
__device__ __forceinline__ Real<S> maximum(Real<S> a, Real<S> b) {
  if (isnan_of(a)) return a;
  if (isnan_of(b)) return b;
  return make(max_raw(a.v, b.v));
}
template <typename S>
__device__ __forceinline__ Real<S> minimum(Real<S> a, Real<S> b) {
  if (isnan_of(a)) return a;
  if (isnan_of(b)) return b;
  return make(min_raw(a.v, b.v));
}
#else
template <typename S>
Real<S> maximum(Real<S> a, Real<S> b) {
  if (isnan_of(a) || isnan_of(b)) return make((S)NAN);
  return a.v > b.v ? a : b;
}
template <typename S>
Real<S> minimum(Real<S> a, Real<S> b) {
  if (isnan_of(a) || isnan_of(b)) return make((S)NAN);
  return a.v < b.v ? a : b;
}
#endif

// clamp between Python numbers (-inf/+inf for an absent bound): ATen keeps
// a NaN input; on the card min(max(v, lo), hi) in CUDA's fmax/fmin, on the
// CPU its vectorised max(lo, v) then min(hi, .), which keep v where it
// equals a bound
template <typename S>
__device__ __forceinline__ Real<S> clamp_scalar(Real<S> v, Real<S> lo, Real<S> hi) {
  if (isnan_of(v)) return v;
#ifdef __CUDA_ARCH__
  return make(min_raw(max_raw(v.v, lo.v), hi.v));
#else
  const Real<S> m = lo.v > v.v ? lo : v;
  return hi.v < m.v ? hi : m;
#endif
}

// clamp between tensors: NaN from the input, then from either bound, else
// the bounds applied as maximum then minimum
template <typename S>
__device__ __forceinline__ Real<S> clamp_tensor(Real<S> v, Real<S> lo, Real<S> hi) {
#ifdef __CUDA_ARCH__
  if (isnan_of(v)) return v;
  if (isnan_of(lo)) return lo;
  if (isnan_of(hi)) return hi;
  return make(min_raw(max_raw(v.v, lo.v), hi.v));
#else
  return minimum(maximum(v, lo), hi);
#endif
}


// base ** exponent, both tensors: CUDA's pow on the card (ATen's pow_);
// on the CPU numerics.pow_'s C library pow in double
template <typename S>
__device__ __forceinline__ Real<S> pow_tensor(Real<S> a, Real<S> e) {
#ifdef __CUDA_ARCH__
  return pow_of(a, make(run_time(e.v)));
#else
  return make((S)libm_pow((double)a.v, (double)e.v));
#endif
}

// base ** a Python number. ATen (Pow.cpp, cuda/PowKernel.cu) fills 1 at 0
// and copies at 1 on either device; on the card it then takes sqrt at 0.5,
// rsqrt at -0.5, the reciprocal at -1, a*a at 2, a*a*a at 3 and
// 1/(a*a) at -2, and CUDA's pow of the exponent in the dtype elsewhere.
// numerics.pow_ on the CPU: the C library's pow in double of the exponent
// rounded to the dtype.
template <typename S>
__device__ __forceinline__ Real<S> pow_scalar(Real<S> a, double e) {
  if (e == 0.0) return Real<S>(1.0);
  if (e == 1.0) return a;
#ifdef __CUDA_ARCH__
  if (e == 0.5) return sqrt_of(a);
  if (e == -0.5) return rsqrt(a);
  if (e == -1.0) return recip(a);
  if (e == 2.0) return a * a;
  if (e == 3.0) return a * a * a;
  if (e == -2.0) return Real<S>(1.0) / (a * a);
  return pow_of(a, make(run_time((S)e)));
#else
  return make((S)libm_pow((double)a.v, (double)(S)e));
#endif
}

}  // namespace model
}  // namespace ida
