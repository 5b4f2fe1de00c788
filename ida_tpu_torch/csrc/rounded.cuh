// A real number whose arithmetic rounds once per operation, whatever the
// compiler's contraction mode: + - * / go through CUDA's round-to-nearest
// intrinsics (__dadd_rn, __dmul_rn, ...), which nvcc never fuses into a
// multiply-add. Code written with ida::Real can be built with nvcc's default
// -fmad=true, so that CUDA's pow and sqrt inlined beside it are compiled as
// PyTorch's own kernels compile them (torch.pow, torch.sqrt bit for bit),
// while every operation of the code itself still rounds as one torch op does.
//
// The constructor is explicit: a raw `a * b + c` on doubles or floats does
// not mix with Real silently. Comparisons pass through; unary minus and
// absval are exact. Real<S> has the layout of S, so a pointer to a tensor's
// data is read as a pointer to Real<S>.

#pragma once

#include <cuda_runtime.h>

namespace ida {

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

template <typename S>
struct Real {
  S v;
  using raw = S;

  Real() = default;
  // from a Python-style constant in double (or an int): rounded to S once
  __device__ __forceinline__ explicit Real(double x) : v((S)x) {}

  __device__ __forceinline__ Real operator-() const { Real r; r.v = -v; return r; }
  __device__ __forceinline__ friend Real operator+(Real a, Real b) { Real r; r.v = add_rn(a.v, b.v); return r; }
  __device__ __forceinline__ friend Real operator-(Real a, Real b) { Real r; r.v = sub_rn(a.v, b.v); return r; }
  __device__ __forceinline__ friend Real operator*(Real a, Real b) { Real r; r.v = mul_rn(a.v, b.v); return r; }
  __device__ __forceinline__ friend Real operator/(Real a, Real b) { Real r; r.v = div_rn(a.v, b.v); return r; }

  __device__ __forceinline__ friend bool operator==(Real a, Real b) { return a.v == b.v; }
  __device__ __forceinline__ friend bool operator!=(Real a, Real b) { return a.v != b.v; }
  __device__ __forceinline__ friend bool operator<(Real a, Real b) { return a.v < b.v; }
  __device__ __forceinline__ friend bool operator<=(Real a, Real b) { return a.v <= b.v; }
  __device__ __forceinline__ friend bool operator>(Real a, Real b) { return a.v > b.v; }
  __device__ __forceinline__ friend bool operator>=(Real a, Real b) { return a.v >= b.v; }
};

// plain reals (the batched LU kernels of small_lu.cu, built -fmad=false)
__device__ __forceinline__ double absval(double v) { return fabs(v); }
__device__ __forceinline__ float absval(float v) { return fabsf(v); }

__device__ __forceinline__ Real<double> absval(Real<double> a) { a.v = fabs(a.v); return a; }
__device__ __forceinline__ Real<float> absval(Real<float> a) { a.v = fabsf(a.v); return a; }

template <typename S>
__device__ __forceinline__ bool finite(Real<S> a) { return isfinite(a.v); }

// sqrt and pow as CUDA computes them: built -fmad=true these are what
// torch.sqrt and torch.pow call on the card
__device__ __forceinline__ Real<double> sqrt_of(Real<double> a) { a.v = ::sqrt(a.v); return a; }
__device__ __forceinline__ Real<float> sqrt_of(Real<float> a) { a.v = ::sqrtf(a.v); return a; }
__device__ __forceinline__ Real<double> pow_of(Real<double> a, Real<double> e) { a.v = ::pow(a.v, e.v); return a; }
__device__ __forceinline__ Real<float> pow_of(Real<float> a, Real<float> e) { a.v = ::powf(a.v, e.v); return a; }

}  // namespace ida
