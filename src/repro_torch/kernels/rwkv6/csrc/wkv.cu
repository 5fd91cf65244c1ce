// RWKV-6 WKV scan, forward, fp32, sm_90a. Per token t of one (b, h), with
// an N x N state S and per-channel data-dependent decay w_t:
//   o_t = r_t^T S + (r_t . u . k_t) v_t
//   S  <- diag(w_t) S + k_t v_t^T
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/rwkv6.py:
//   wkv_pallas (_wkv_kernel :26, def :70, pallas_call :89)
// the multi-token prefill of the ssm family (time_mix with S > 1,
// src/repro/models/rwkv6.py:113-120): 32 launches a prefill at rwkv6-7b.
//
// Design: the TPU kernel runs the scan chunked, as (C, N) x (N, N) matrix
// products with every decay ratio <= 1, the state in VMEM across a
// sequential grid axis. Here one block per (b, h) walks the tokens itself
// (blocks run in no order, so nothing may carry between them), with N
// threads: thread j owns column j of S in registers and reads S before
// updating it, o_j = sum_n r_n (S[n, j] + u_n k_n v_j), then
// S[n, j] = w_n S[n, j] + k_n v_j, the form of RWKV's own CUDA kernel. It
// computes the same o and final state as _wkv_kernel (held within 2e-5, and
// 1e-4 under strong decay, of the plain chunked version), with no clamp on
// the decay, for any S: no length goes to the plain version. WKV_T tokens
// of r, k, w and v are staged in shared memory per pass; the reads of r, k,
// w there are broadcasts (every thread reads the same n).
//   Bound on this card: bytes. Each input is read once and each output
// written once: 4 x B*S*H*N + H*N floats in, B*S*H*N out, and the state
// (B*H*N*N) in and out, against about 5 flops per (token, n, j). At the
// prefill shapes (S of tens of tokens) the state's read and write are half
// the bytes. This first version keeps one block per (b, h): B*H blocks of
// N threads (256 of 64 at batch 4), with no tensor-core chunking.
#include "common.cuh"

namespace {

constexpr int WKV_T = 32;  // tokens staged in shared memory per pass

template <int N>
__global__ void __launch_bounds__(N)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ o, float* __restrict__ s_out, int S, int H) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  __shared__ float r_s[WKV_T][N], k_s[WKV_T][N], w_s[WKV_T][N], v_s[WKV_T][N];
  __shared__ float u_s[N];

  const size_t sbase = (size_t)bh * N * N;  // state (B, H, N, N)
  float st[N];                              // column j of S
#pragma unroll
  for (int n = 0; n < N; ++n) st[n] = s0[sbase + (size_t)n * N + j];
  u_s[j] = u[h * N + j];

  for (int t0 = 0; t0 < S; t0 += WKV_T) {
    const int nt = min(WKV_T, S - t0);
    __syncthreads();  // the previous pass is consumed
    for (int tt = 0; tt < nt; ++tt) {
      const size_t idx = (((size_t)b * S + t0 + tt) * H + h) * N + j;
      r_s[tt][j] = r[idx];
      k_s[tt][j] = k[idx];
      w_s[tt][j] = w[idx];
      v_s[tt][j] = v[idx];
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = v_s[tt][j];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float kv = k_s[tt][n] * vj;
        acc = fmaf(r_s[tt][n], fmaf(u_s[n], kv, st[n]), acc);
        st[n] = fmaf(w_s[tt][n], st[n], kv);
      }
      o[(((size_t)b * S + t0 + tt) * H + h) * N + j] = acc;
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) s_out[sbase + (size_t)n * N + j] = st[n];
}

template <int N>
cudaError_t launch_wkv(const float* r, const float* k, const float* v, const float* w,
                       const float* u, const float* s0, float* o, float* s_out, int B,
                       int S, int H, cudaStream_t stream) {
  wkv_kernel<N><<<B * H, N, 0, stream>>>(r, k, v, w, u, s0, o, s_out, S, H);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, o (B, S, H, N); u (H, N); s0, s_out (B, H, N, N). fp32,
// contiguous; s_out may not alias s0 of another (b, h).
REPRO_API int wkv_f32(const float* r, const float* k, const float* v, const float* w,
                      const float* u, const float* s0, float* o, float* s_out, int B,
                      int S, int H, int N, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch_wkv<16>(r, k, v, w, u, s0, o, s_out, B, S, H, stream);
    case 32:
      return launch_wkv<32>(r, k, v, w, u, s0, o, s_out, B, S, H, stream);
    case 64:
      return launch_wkv<64>(r, k, v, w, u, s0, o, s_out, B, S, H, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
