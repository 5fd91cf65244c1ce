// The pass structure shared by the two scan kernels, ssd and wkv (sm_90a,
// fp32 on the CUDA cores).
//
// A block owns one (batch, head) state and walks its tokens in passes of T.
// The state is elementwise in its two indices and reduces over one of them
// (n) only in the output, so each thread holds a small tile of the state in
// registers (a few rows or columns by a few n), G threads share each row or
// column's n, and each token's output is the sum of G partials. A pass:
//   1. wait for its staged inputs (cp.async, issued two passes ahead into
//      the other of two buffers) and __syncthreads;
//   2. walk its tokens: each thread updates its tile and writes its
//      partials of every token to shared memory (no partial feeds the next
//      token, so no thread waits on another inside the pass);
//   3. __syncthreads, issue the copies of the pass after next into the
//      buffer this pass has consumed, and combine: the G partials of each
//      (token, output) are added in group order, ((p_0 + p_1) + p_2) + ...,
//      and written with one coalesced 16-byte store a thread.
// The plain versions of this order are ref.{ssd,wkv}_split_ref.
#pragma once

#include "common.cuh"

// The helpers below walk a pass's T tokens in a loop whose trip count is
// known at compile time (T * W / 4 chunks over THREADS threads), each step
// guarded by the pass's own length nt <= T: a full pass runs straight-line
// code, and a ragged last pass the same code with its tail masked.

// Stage nt <= T rows of W floats, row r from src + r * stride, into dst
// (rows packed W floats apart), 16 bytes a copy; src, dst, W and stride
// keep 16-byte alignment.
template <int THREADS, int T, int W>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int nt,
                                           size_t stride) {
  static_assert(W % 4 == 0, "rows of whole 16-byte chunks");
  constexpr int W4 = W / 4;
#pragma unroll
  for (int k = 0; k < (T * W4 + THREADS - 1) / THREADS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < nt * W4) {
      const int r = i / W4, c = (i % W4) * 4;
      cp_async16(dst + r * W + c, src + r * stride + c);
    }
  }
}

// Stage nt <= T floats, float i from src + i * stride, into dst[0, nt).
template <int THREADS, int T>
__device__ __forceinline__ void stage_scalars(float* dst, const float* src, int nt,
                                              size_t stride) {
#pragma unroll
  for (int k = 0; k < (T + THREADS - 1) / THREADS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < nt) cp_async4(dst + i, src + i * stride);
  }
}

// out[t * stride + w] = sum_g part[g * GS + t * W + w] for t < nt <= T,
// w < W, the groups added in order; four outputs a thread a step. GS, the
// stride between groups' partials, is T * W or past it by padding.
template <int G, int T, int W, int THREADS, int GS = T * W>
__device__ __forceinline__ void combine_partials(const float* part, float* out, int nt,
                                                 size_t stride) {
  static_assert(W % 4 == 0 && GS % 4 == 0 && GS >= T * W, "16-byte rows");
  constexpr int W4 = W / 4;
#pragma unroll
  for (int k = 0; k < (T * W4 + THREADS - 1) / THREADS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < nt * W4) {
      const int t = i / W4, c = (i % W4) * 4;
      float4 s = *reinterpret_cast<const float4*>(part + t * W + c);
#pragma unroll
      for (int g = 1; g < G; ++g) {
        const float4 q = *reinterpret_cast<const float4*>(part + g * GS + t * W + c);
        s.x += q.x;
        s.y += q.y;
        s.z += q.z;
        s.w += q.w;
      }
      *reinterpret_cast<float4*>(out + t * stride + c) = s;
    }
  }
}
