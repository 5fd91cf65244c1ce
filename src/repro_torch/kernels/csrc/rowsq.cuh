// Per-row sums of squares of a (B, D) fp32 matrix whose rows lie ld floats
// apart, in two deterministic passes: the device code shared by
// dp_clip/csrc/sumsq.cu (per_example_sumsq) and dp_fused/csrc/clip_sum.cu
// (clip_sum's first phase).
//
// Pass 1, rowsq_partial: a (nblk, B) grid; block (j, b) sums its share of
// row b (rowsq_block: thread t of block j taking the elements, float4s
// when vec, at j * RS_THREADS + t + k * nblk * RS_THREADS) and writes one
// partial sum. sumsq.cu's tree kernel runs rowsq_block over every leaf's
// blocks in one grid.
// Pass 2 (rowsq_total, in each caller's last kernel): one warp per row adds
// the row's nblk partials. Every sum is in fp64, where the square of an
// fp32 value is exact: the result is the fp32 rounding of an almost exact
// sum, whatever the length. Nothing is added with atomics and every
// assignment of elements to threads and of partials to lanes is fixed by
// (D, nblk), so two launches give the same bits. 64-bit offsets throughout
// (B * ld is past 2^31 for the per-example buffer at full width).
#pragma once

#include <cuda_runtime.h>

namespace repro_rowsq {
// internal linkage: each translation unit that includes this gets its own
// copy of the kernel (no duplicate host stubs in the linked library)
namespace {

constexpr int RS_THREADS = 256;

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double sq(float x) {
  const double d = (double)x;
  return d * d;
}

// Block j of nblk's partial sum of squares of one row of D elements: thread
// t takes the elements (float4s when vec) at j * RS_THREADS + t + k * nblk *
// RS_THREADS. Call with RS_THREADS threads; the sum is thread 0's.
__device__ __forceinline__ double rowsq_block(const float* __restrict__ row, long long D,
                                              int vec, int j, int nblk) {
  const long long stride = (long long)nblk * RS_THREADS;
  const long long tid = (long long)j * RS_THREADS + threadIdx.x;
  const long long nvec = vec ? D / 4 : 0;
  double acc = 0.0;
  for (long long v = tid; v < nvec; v += stride) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(row) + v);
    acc += sq(x.x) + sq(x.y) + sq(x.z) + sq(x.w);
  }
  for (long long p = nvec * 4 + tid; p < D; p += stride) acc += sq(__ldg(row + p));
  __shared__ double warps[RS_THREADS / 32];
  acc = warp_sum_d(acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = acc;
  __syncthreads();
  if (warp == 0) acc = warp_sum_d(lane < RS_THREADS / 32 ? warps[lane] : 0.0);
  return acc;
}

__global__ void __launch_bounds__(RS_THREADS)
rowsq_partial(const float* __restrict__ g, long long D, long long ld, int vec,
              double* __restrict__ partial) {
  const int b = blockIdx.y;
  const double acc = rowsq_block(g + (long long)b * ld, D, vec, blockIdx.x, gridDim.x);
  if (threadIdx.x == 0) partial[(long long)b * gridDim.x + blockIdx.x] = acc;
}

// The sum of row b's nblk partials, in a fixed order; call with one warp.
__device__ __forceinline__ double rowsq_total(const double* __restrict__ partial, int nblk,
                                              int b) {
  double acc = 0.0;
  for (int j = threadIdx.x & 31; j < nblk; j += 32) acc += partial[(long long)b * nblk + j];
  return warp_sum_d(acc);
}

// Pass 1 on `stream`, over a (nblk, B) grid; the caller checks the error.
inline void launch_rowsq_partial(const float* g, int B, long long D, long long ld, int vec,
                                 int nblk, double* partial, cudaStream_t stream) {
  const dim3 grid((unsigned)nblk, (unsigned)B);
  rowsq_partial<<<grid, RS_THREADS, 0, stream>>>(g, D, ld, vec, partial);
}

}  // namespace
}  // namespace repro_rowsq
