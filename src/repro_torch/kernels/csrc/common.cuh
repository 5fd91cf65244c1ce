// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_runtime.h>

// Finite on purpose, as in the TPU kernels: a fully masked row (an inactive
// slot, q_start < 0) gives a finite uniform average, never a NaN.
constexpr float REPRO_NEG_INF = -1e30f;

#define REPRO_API extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
