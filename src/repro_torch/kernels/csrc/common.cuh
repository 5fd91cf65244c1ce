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

// Asynchronous copies into shared memory (sm_80+): 16 bytes (both addresses
// 16-byte aligned) or 4, then commit the issued copies as one group and wait
// until at most N groups are still in flight.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Dynamic shared memory past the 48 KB default: cudaFuncSetAttribute once
// per kernel and device (it applies to the current device only), not once
// per launch; `done` holds a bit for each device already set.
template <class K>
cudaError_t set_smem_once(K kern, size_t bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done |= bit;
  return e;
}

// Blocks for a grid-stride loop over n items at `threads` a block: one thread
// an item, capped at `per_sm` blocks an SM of the current device.
inline cudaError_t grid_stride_blocks(long long n, int threads, int per_sm, unsigned& blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long b = (n + threads - 1) / threads;
  const long long cap = (long long)sms * per_sm;
  if (b > cap) b = cap;
  blocks = (unsigned)(b < 1 ? 1 : b);
  return cudaSuccess;
}
