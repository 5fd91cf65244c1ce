// Mamba-2 SSD scan, forward, fp32, sm_90a. Per token t of one (b, head),
// with a P x N state h, a scalar decay per head and B_t, C_t shared across
// heads:
//   h   <- e^{la_t} h + (dt_t x_t) B_t^T
//   y_t  = h C_t
// (D * x is added outside the kernel, as in the JAX package.)
//
// Replaces the TPU kernel src/repro/kernels/mamba2/mamba2.py:
//   ssd_pallas (_ssd_kernel :28, def :67, pallas_call :89)
// the multi-token prefill of the hybrid family (mamba2_apply with S > 1,
// src/repro/models/mamba2.py:89-97): 81 launches a prefill at zamba2-7b.
//
// Design: the TPU kernel runs each chunk as (C, N) / (C, C) tile products
// with a 2-D decay tile Gamma, the state in VMEM across a sequential grid
// axis. Here one block per (b, head) walks the tokens itself (blocks run
// in no order, so nothing may carry between them), with P threads: thread
// p owns row p of h in registers, h[p, n] = e^{la_t} h[p, n] + dt_t x_t[p]
// B_t[n], then y_t[p] = sum_n h[p, n] C_t[n]. It computes the same y and
// final h as _ssd_kernel (held within 5e-5 of the plain chunked version),
// for any S: no length goes to the plain version. SSD_T tokens of B, C,
// dt and e^{la} are staged in shared memory per pass; the reads of B and C
// there are broadcasts (every thread reads the same n).
//   Bound on this card: bytes. Each input is read once and each output
// written once: x and y (B*S*nh*P each), dt and la (B*S*nh), B and C
// (B*S*N), and the state h (B*nh*P*N) in and out, against about 4 flops per
// (token, p, n). At the prefill shapes (S of tens of tokens) the state's
// read and write are two thirds of the bytes. This first version keeps one
// block per (b, head): B*nh blocks of P threads (448 of 64 at batch 4 and
// zamba2-7b's 112 heads), with no tensor-core chunking.
#include "common.cuh"

namespace {

constexpr int SSD_T = 32;  // tokens staged in shared memory per pass

template <int P, int N>
__global__ void __launch_bounds__(P)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ la, const float* __restrict__ Bc,
           const float* __restrict__ Cc, const float* __restrict__ h0,
           float* __restrict__ y, float* __restrict__ h_out, int S, int nh) {
  const int bh = blockIdx.x, b = bh / nh, hd = bh % nh, p = threadIdx.x;
  __shared__ float b_s[SSD_T][N], c_s[SSD_T][N], dt_s[SSD_T], a_s[SSD_T];

  const size_t hbase = (size_t)bh * P * N + (size_t)p * N;  // h (B, nh, P, N)
  float hs[N];                                               // row p of h
#pragma unroll
  for (int n = 0; n < N; ++n) hs[n] = h0[hbase + n];

  for (int t0 = 0; t0 < S; t0 += SSD_T) {
    const int nt = min(SSD_T, S - t0);
    __syncthreads();  // the previous pass is consumed
    for (int i = p; i < nt * N; i += P) {
      const size_t src = ((size_t)b * S + t0) * N + i;
      b_s[i / N][i % N] = Bc[src];
      c_s[i / N][i % N] = Cc[src];
    }
    for (int i = p; i < nt; i += P) {
      const size_t src = ((size_t)b * S + t0 + i) * nh + hd;
      dt_s[i] = dt[src];
      a_s[i] = expf(la[src]);
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const size_t idx = (((size_t)b * S + t0 + tt) * nh + hd) * P + p;
      const float xdt = x[idx] * dt_s[tt];
      const float a = a_s[tt];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        hs[n] = fmaf(a, hs[n], xdt * b_s[tt][n]);
        acc = fmaf(hs[n], c_s[tt][n], acc);
      }
      y[idx] = acc;
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) h_out[hbase + n] = hs[n];
}

template <int P, int N>
cudaError_t launch_ssd(const float* x, const float* dt, const float* la, const float* Bc,
                       const float* Cc, const float* h0, float* y, float* h_out, int B,
                       int S, int nh, cudaStream_t stream) {
  ssd_kernel<P, N><<<B * nh, P, 0, stream>>>(x, dt, la, Bc, Cc, h0, y, h_out, S, nh);
  return cudaGetLastError();
}

}  // namespace

// x, y (B, S, nh, P); dt, la (B, S, nh); Bc, Cc (B, S, N); h0, h_out
// (B, nh, P, N). fp32, contiguous.
REPRO_API int ssd_f32(const float* x, const float* dt, const float* la, const float* Bc,
                      const float* Cc, const float* h0, float* y, float* h_out, int B,
                      int S, int nh, int P, int N, cudaStream_t stream) {
  if (P == 16 && N == 16)  // the smoke configs
    return launch_ssd<16, 16>(x, dt, la, Bc, Cc, h0, y, h_out, B, S, nh, stream);
  if (P == 64 && N == 64)  // zamba2-7b
    return launch_ssd<64, 64>(x, dt, la, Bc, Cc, h0, y, h_out, B, S, nh, stream);
  return cudaErrorInvalidValue;
}
