// RWKV-6 WKV scan, forward, fp32, sm_90a. Per token t of one (b, h), with
// an N x N state S and per-channel data-dependent decay w_t:
//   o_t = r_t^T S + (r_t . u . k_t) v_t
//   S  <- diag(w_t) S + k_t v_t^T
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/rwkv6.py:
//   wkv_pallas (_wkv_kernel :26, def :70, pallas_call :89)
// the multi-token prefill of the ssm family (time_mix with S > 1,
// src/repro/models/rwkv6.py:113-120): 32 launches a prefill at rwkv6-7b.
// The TPU kernel runs the scan chunked, as (C, N) x (N, N) matrix products
// with every decay ratio <= 1, the state in VMEM across a sequential grid
// axis. Here one block per (b, h) walks the tokens itself (blocks run in no
// order, so nothing may carry between them) in the form of RWKV's own CUDA
// kernel, reading S before updating it:
//   o_j = sum_n r_n (S[n, j] + u_n k_n v_j),  S[n, j] = w_n S[n, j] + k_n v_j
// It computes the same o and final state as _wkv_kernel (held within 2e-5,
// and 1e-4 under strong decay, of the plain chunked version), with no clamp
// on the decay, for any S: no length goes to the plain version.
//
// Bound on this card: bytes. Each input is read once and each output
// written once: r, k, v, w and o (B*S*H*N each), u (H*N), the state
// (B*H*N*N) in and out. At rwkv6-7b's prefill (4, 32, 64, 64) that is
// 18.9 MB, 5.6 us at 3.35 TB/s; the fp32 work, 4 operations per
// (token, n, j), is 4.0 us of FMA issue.
//
// The first version (one block of N threads a (b, h), thread j
// owning column j of S) ran at 36% of that bound (0.0157 ms on the card):
//   - 256 blocks of 2 warps, under 4 warps an SM;
//   - o_j ended each token in a 64-deep chain of dependent FMAs;
//   - each pass was staged one token at a time, with nothing in flight
//     while the scan computed.
// Its state access was coalesced (lanes j on neighbouring addresses), and
// stays so. This design (the pass structure of scan_tile.cuh; times in
// PERF.md):
//   - a thread holds an 8 x 4 tile of S in registers, rows g*8 .. g*8 + 7
//     and the 4 neighbouring columns 4*cg .. 4*cg + 3 (N 64), and u's 8
//     matching values; G = 8 threads share a column, 128 threads a block, 2
//     blocks an SM: the 256 blocks of the main shape run in one wave;
//   - o_t[j] is the sum of 8 partials, each an 8-deep chain (4 independent
//     chains a thread), written to shared memory and combined once a pass
//     with coalesced 16-byte stores of o;
//   - WKV_T tokens of r, k, w and v are staged a pass with 16-byte cp.async
//     copies, the next pass in flight in a second buffer while this one
//     computes, the first two passes in flight while the state loads; each
//     16-byte read of r, k or w feeds 4 columns, each of v 8 rows;
//   - the state goes in and out once, straight between device memory and
//     registers, 16 bytes a thread, lanes on neighbouring addresses.
// What bounds it now is instruction issue: 4 fp32 operations a state
// element and token, 128 a thread and token, at 7.8 warps an SM.
#include "scan_tile.cuh"

namespace {

constexpr int WKV_R = 4;   // state columns a thread
constexpr int WKV_T = 16;  // tokens staged a pass

template <int N>
struct WkvShape {
  static constexpr int R = WKV_R, T = WKV_T;
  static constexpr int M = N >= 32 ? 8 : 4;  // n a thread
  static constexpr int G = N / M;            // threads a column
  static constexpr int CG = N / R;           // column groups: columns R*cg ..
  static constexpr int THREADS = CG * G;
  static constexpr int BUF = 4 * T * N;  // r, k, w, v
  static constexpr int RED = G * T * N;  // the partials
  static constexpr size_t BYTES = sizeof(float) * (2 * BUF + RED);
  static_assert(R == 4 && M % 4 == 0 && N % M == 0, "16-byte reads");
  static_assert(THREADS <= 1024, "one block");
};

template <int N>
__global__ void __launch_bounds__(WkvShape<N>::THREADS, 2)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ o, float* __restrict__ s_out, int S, int H) {
  using K = WkvShape<N>;
  constexpr int R = K::R, T = K::T, M = K::M, CG = K::CG, THREADS = K::THREADS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* red = smem + 2 * K::BUF;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j0 = (threadIdx.x % CG) * R, g = threadIdx.x / CG;
  const int npass = (S + T - 1) / T;

  auto stage = [&](int pass) {
    float* buf = smem + (pass & 1) * K::BUF;
    const int nt = min(T, S - pass * T);
    const size_t off = (((size_t)b * S + pass * T) * H + h) * N;
    const size_t stride = (size_t)H * N;
    stage_rows<THREADS, T, N>(buf, r + off, nt, stride);
    stage_rows<THREADS, T, N>(buf + T * N, k + off, nt, stride);
    stage_rows<THREADS, T, N>(buf + 2 * T * N, w + off, nt, stride);
    stage_rows<THREADS, T, N>(buf + 3 * T * N, v + off, nt, stride);
  };
  stage(0);
  cp_async_commit();
  if (npass > 1) stage(1);
  cp_async_commit();

  // S[g*M + i, j0 .. j0 + 3] (16-byte loads, lanes on neighbouring
  // addresses) and u[g*M + i]
  const size_t sbase = (size_t)bh * N * N + (size_t)g * M * N + j0;
  float st[M][R], us[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float4 q = *reinterpret_cast<const float4*>(s0 + sbase + (size_t)i * N);
    st[i][0] = q.x, st[i][1] = q.y, st[i][2] = q.z, st[i][3] = q.w;
    us[i] = u[h * N + g * M + i];
  }

  for (int pass = 0; pass < npass; ++pass) {
    cp_async_wait<1>();  // this pass's group has landed
    __syncthreads();     // for every thread; the last combine is done
    const float* buf = smem + (pass & 1) * K::BUF;
    const float* rs = buf + g * M;
    const float* ks = buf + T * N + g * M;
    const float* ws = buf + 2 * T * N + g * M;
    const float* vs = buf + 3 * T * N + j0;
    const int nt = min(T, S - pass * T);
#pragma unroll
    for (int tt = 0; tt < T; ++tt) {
      if (tt >= nt) break;
      const float4 v4 = *reinterpret_cast<const float4*>(vs + tt * N);
      const float vv[R] = {v4.x, v4.y, v4.z, v4.w};
      float acc[R] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < M; c += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rs + tt * N + c);
        const float4 k4 = *reinterpret_cast<const float4*>(ks + tt * N + c);
        const float4 w4 = *reinterpret_cast<const float4*>(ws + tt * N + c);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int jj = 0; jj < R; ++jj) {
            const float kv = kk[q] * vv[jj];
            acc[jj] = fmaf(rr[q], fmaf(us[c + q], kv, st[c + q][jj]), acc[jj]);
            st[c + q][jj] = fmaf(ww[q], st[c + q][jj], kv);
          }
      }
      *reinterpret_cast<float4*>(red + (g * T + tt) * N + j0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();  // partials written, this buffer consumed
    if (pass + 2 < npass) stage(pass + 2);
    cp_async_commit();
    combine_partials<K::G, T, N, THREADS>(
        red, o + (((size_t)b * S + pass * T) * H + h) * N, nt, (size_t)H * N);
  }
#pragma unroll
  for (int i = 0; i < M; ++i)
    *reinterpret_cast<float4*>(s_out + sbase + (size_t)i * N) =
        make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
}

template <int N>
cudaError_t wkv_smem() {  // once per instantiation and device
  static unsigned long long done = 0;
  return set_smem_once(wkv_kernel<N>, WkvShape<N>::BYTES, done);
}

template <int N>
cudaError_t launch_wkv(const float* r, const float* k, const float* v, const float* w,
                       const float* u, const float* s0, float* o, float* s_out, int B,
                       int S, int H, cudaStream_t stream) {
  using K = WkvShape<N>;
  const cudaError_t attr = wkv_smem<N>();
  if (attr != cudaSuccess) return attr;
  wkv_kernel<N><<<B * H, K::THREADS, K::BYTES, stream>>>(r, k, v, w, u, s0, o, s_out, S,
                                                        H);
  return cudaGetLastError();
}

template <int N>
cudaError_t config_wkv(int* cfg) {
  using K = WkvShape<N>;
  cfg[0] = K::R, cfg[1] = K::G, cfg[2] = K::T, cfg[3] = K::THREADS;
  cfg[4] = static_cast<int>(K::BYTES);
  const cudaError_t err = wkv_smem<N>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cfg[5], wkv_kernel<N>, K::THREADS,
                                                       K::BYTES);
}

}  // namespace

// r, k, v, w, o (B, S, H, N); u (H, N); s0, s_out (B, H, N, N). fp32,
// contiguous; r, k, v, w, s0, o and s_out 16-byte aligned; s_out may not
// alias s0 of another (b, h).
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

// The launch configuration of wkv_f32 at head size N: cfg = {state columns
// a thread, threads a state column, tokens a pass, threads a block, shared
// bytes a block, blocks an SM (the occupancy calculator, registers
// included)}.
REPRO_API int wkv_config(int N, int* cfg) {
  switch (N) {
    case 16:
      return config_wkv<16>(cfg);
    case 32:
      return config_wkv<32>(cfg);
    case 64:
      return config_wkv<64>(cfg);
    default:
      return cudaErrorInvalidValue;
  }
}
