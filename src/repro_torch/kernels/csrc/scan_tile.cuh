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

// ---------------------------------------------------------------------------
// The reverse walk shared by the two backward kernels, wkv_bwd and ssd_bwd.
//
// A block owns one (batch, head) and walks its tokens from last to first in
// passes of T, carrying the gradient of the state in a register tile (a
// few rows by a few columns a thread). Each token needs the state before
// it, which is
// rebuilt forward, never by dividing by a decay: a first forward walk writes
// the state before every pass but the first and the last to a global
// scratch; the reverse walk reloads a pass's state, steps it through the
// pass writing a sub-checkpoint before every Q tokens into shared memory
// (each thread its own tile, so no thread waits on another), and walks each
// Q-token sub-chunk back from its sub-checkpoint with two register tiles
// (walk_back). A thread adds its own share of each token's sums in order;
// the lanes of a warp halve the partials across them (lane_halve), so no
// partial goes through shared memory inside a warp; the sums that cross
// warps are written to shared memory and combined once a sub-chunk in warp
// order. The plain versions of this order are
// ref.{wkv,ssd}_backward_split_ref.

constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

// Load / store K contiguous floats (K 1, 2 or a multiple of 4; the address
// min(K, 4) * 4-byte aligned).
template <int K>
__device__ __forceinline__ void ld_vec(float* d, const float* s) {
  static_assert(K == 1 || K == 2 || K % 4 == 0, "1, 2 or a multiple of 4 floats");
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int c = 0; c < K; c += 4) {
      const float4 q = *reinterpret_cast<const float4*>(s + c);
      d[c] = q.x, d[c + 1] = q.y, d[c + 2] = q.z, d[c + 3] = q.w;
    }
  } else if constexpr (K == 2) {
    const float2 q = *reinterpret_cast<const float2*>(s);
    d[0] = q.x, d[1] = q.y;
  } else {
    d[0] = s[0];
  }
}

template <int K>
__device__ __forceinline__ void st_vec(float* d, const float* s) {
  static_assert(K == 1 || K == 2 || K % 4 == 0, "1, 2 or a multiple of 4 floats");
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int c = 0; c < K; c += 4)
      *reinterpret_cast<float4*>(d + c) = make_float4(s[c], s[c + 1], s[c + 2], s[c + 3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(d) = make_float2(s[0], s[1]);
  } else {
    d[0] = s[0];
  }
}

template <int CNT, int S, int L, int NV>
__device__ __forceinline__ void lane_halve_first(float (&v)[NV]) {
  if constexpr (L > 0) {
    // one level on v[0, CNT), then the next on the half this lane keeps
    // (recursion, not a loop: every index is a constant, v stays in registers)
    constexpr int H = CNT / 2;
    const bool up = (threadIdx.x & S) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float lo = v[i], hi = v[i + H];
      v[i] = (up ? hi : lo) + __shfl_xor_sync(FULL_MASK, up ? lo : hi, S);
    }
    lane_halve_first<H, S / 2, L - 1>(v);
  }
}

// Recursive halving of v[0, NV) across the 2^L lanes that differ in the lane
// bits S, S/2, ..., S >> (L-1): at each level a lane whose bit is set keeps
// the upper half of its values (else the lower), adds its partner's matching
// half and hands the other half over. After L levels v[0, NV >> L) holds the
// sums over the 2^L lanes of the values numbered base .. base + (NV >> L) - 1,
// base = the sum over the levels of (bit set ? NV >> (level + 1) : 0); each
// is the xor tree, pairs across the top bit first.
template <int NV, int S, int L>
__device__ __forceinline__ void lane_halve(float (&v)[NV]) {
  static_assert((NV >> L) >= 1 && (S >> (L > 0 ? L - 1 : 0)) >= 1, "values and lanes to halve");
  lane_halve_first<NV, S, L>(v);
}

// v[0, NV) summed across the 2^L lanes that differ in the lane bits S, S/2,
// ..., S >> (L-1), every lane keeping the sums (each add commutes, so the
// lanes agree bit for bit).
template <int NV, int S, int L>
__device__ __forceinline__ void lane_butterfly(float* v) {
#pragma unroll
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += __shfl_xor_sync(FULL_MASK, v[i], S >> l);
}

// A thread's tile of E floats (E a multiple of 4) to and from its own place
// in a shared-memory sub-checkpoint of THREADS * E floats, laid out
// [chunk of 4][thread] so that a warp's 16-byte accesses do not conflict.
template <int THREADS, int E>
__device__ __forceinline__ void tile_to_smem(float* slot, const float (&x)[E]) {
#pragma unroll
  for (int f = 0; f < E / 4; ++f)
    st_vec<4>(slot + (f * THREADS + threadIdx.x) * 4, x + 4 * f);
}

template <int THREADS, int E>
__device__ __forceinline__ void tile_from_smem(const float* slot, float (&x)[E]) {
#pragma unroll
  for (int f = 0; f < E / 4; ++f) ld_vec<4>(x + 4 * f, slot + (f * THREADS + threadIdx.x) * 4);
}

// Tokens t0 .. t0 + nq - 1 (nq <= 4) of a pass, walked from last to first,
// each in two halves: grad(t, s, part), the thread's own partials of token
// t's sums (s the thread's tile of the state before t), then emit(t, part),
// the sums across lanes and their stores. The state before each token is
// rebuilt from the sub-checkpoint `slot` (the state before t0) by step(x,
// t), two tokens a reload: x steps to the state before t0 + nq - 2, a copy
// y one token further; both tokens' partials come before either's sums, so
// the two chains of shuffles overlap. Four tokens cost four steps and two
// reloads.
template <int THREADS, int E, class Part, class Step, class Grad, class Emit>
__device__ __forceinline__ void walk_back(const float* slot, int t0, int nq, float (&x)[E],
                                          float (&y)[E], Part& pa, Part& pb, Step step,
                                          Grad grad, Emit emit) {
  for (int e = nq; e > 0; e -= 2) {
    tile_from_smem<THREADS>(slot, x);
    if (e >= 2) {
      for (int s = 0; s < e - 2; ++s) step(x, t0 + s);
#pragma unroll
      for (int f = 0; f < E; ++f) y[f] = x[f];
      step(y, t0 + e - 2);
      grad(t0 + e - 1, y, pa);
      grad(t0 + e - 2, x, pb);
      emit(t0 + e - 1, pa);
      emit(t0 + e - 2, pb);
    } else {
      grad(t0, x, pa);
      emit(t0, pa);
    }
  }
}
