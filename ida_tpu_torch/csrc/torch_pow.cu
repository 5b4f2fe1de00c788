// pow as torch.pow computes it on the card, for csrc/ida_lane.cuh.
//
// PyTorch's CUDA kernels are built with nvcc's default -fmad=true, and
// CUDA's double pow inlined into code built with -fmad=false (as the solve
// is, so that its own arithmetic rounds op by op) rounds apart from
// torch.pow in the last bit for about one argument pair in a million. This
// file is compiled on its own with -fmad=true and linked into the solve as
// relocatable device code, so the solve's pow is torch.pow's, bit for bit.

#include <cuda_runtime.h>

__device__ double torch_pow(double base, double exponent) { return ::pow(base, exponent); }
__device__ float torch_pow(float base, float exponent) { return ::pow(base, exponent); }
