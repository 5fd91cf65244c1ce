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
// The TPU kernel runs each chunk as (C, N) / (C, C) tile products with a
// 2-D decay tile Gamma, the state in VMEM across a sequential grid axis.
// Here one block per (b, head) walks the tokens itself (blocks run in no
// order, so nothing may carry between them), for any S: no length goes to
// the plain version. It computes the same y and final h as _ssd_kernel
// (held within 5e-5 of the plain chunked version).
//
// Bound on this card: bytes. Each input is read once and each output
// written once: x and y (B*S*nh*P each), dt and la (B*S*nh), B and C
// (B*S*N), the state h (B*nh*P*N) in and out. At zamba2-7b's prefill
// (4, 32, 112, 64), N 64, that is 22.2 MB, 6.6 us at 3.35 TB/s; the fp32
// work, 3 operations per (token, p, n), is 5.3 us of FMA issue.
//
// The first version (one block of P threads a (b, head), thread p
// owning row p of h) ran at 11% of that bound (0.0573 ms on the card):
//   - 448 blocks of 2 warps, about 7 warps an SM: nothing hid latency;
//   - y_t[p] ended each token in a 64-deep chain of dependent FMAs;
//   - x was read from device memory inside the token loop, at the head of
//     that chain, never staged;
//   - the state went in and out at a 256-byte stride between neighbouring
//     threads (each warp access touched 32 rows), two thirds of the bytes;
//   - staging and compute alternated, no copy in flight during compute.
// This design (the pass structure of scan_tile.cuh; times in PERF.md):
//   - a thread holds a 4 x 8 tile of h in registers: rows 4*rg .. 4*rg + 3,
//     and n in two chunks of 4, 4*g and 4*g + 32 (N 64). G = 8 threads
//     share a row, 128 threads a block, 4 blocks an SM: the 448 blocks of
//     the main shape run in one wave (13.6 warps an SM);
//   - y_t[p] is the sum of 8 partials, each an 8-deep chain (4 independent
//     chains a thread), written to shared memory and combined once a pass
//     with coalesced 16-byte stores of y;
//   - SSD_T tokens of x, B, C, dt and la are staged a pass with cp.async,
//     the next pass in flight in a second buffer while this one computes;
//     each B_t or C_t read (16 bytes) feeds 4 rows, each x read 8 n;
//     thread t turns the pass's la_t into e^{la_t} in place, once a block;
//   - the state goes in and out once, straight between device memory and
//     registers: the 8 threads of a quarter-warp hold neighbouring chunks,
//     so each 16-byte access of a quarter-warp covers 128 contiguous bytes,
//     and a warp starts its tokens as soon as its own state has arrived.
// What bounds it now is instruction issue: 3 fp32 operations a state
// element and token (the decay multiply, the B product, the C dot), 96 a
// thread and token, with the loads, the partial store and the combine
// around them; no one of these is most of the time.
#include "scan_tile.cuh"

namespace {

constexpr int SSD_R = 4;  // state rows a thread
constexpr int SSD_T = 8;  // tokens staged a pass

template <int P, int N>
struct SsdShape {
  static constexpr int R = SSD_R, T = SSD_T;
  static constexpr int M = N >= 32 ? 8 : 4;  // n a thread: M/4 chunks of 4
  static constexpr int G = N / M;            // threads a row
  static constexpr int RG = P / R;           // row groups: rows R*rg .. R*rg + R-1
  static constexpr int THREADS = RG * G;
  static constexpr int BUF = T * (P + 2 * N) + 2 * T;  // x, B, C, dt, la
  // the partials of group g at g * GS: the 4 floats past T * P put the G
  // groups of a quarter-warp in different banks
  static constexpr int GS = T * P + 4;
  static constexpr size_t BYTES = sizeof(float) * (2 * BUF + G * GS);
  static_assert(R == 4 && N % M == 0 && M % 4 == 0 && P % 4 == 0 && T % 4 == 0,
                "16-byte rows");
  static_assert(G <= 8 && T <= THREADS && THREADS <= 1024,
                "a quarter-warp's groups, a thread a token's decay, one block");
};

template <int P, int N>
__global__ void __launch_bounds__(SsdShape<P, N>::THREADS, 4)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ la, const float* __restrict__ Bc,
           const float* __restrict__ Cc, const float* __restrict__ h0,
           float* __restrict__ y, float* __restrict__ h_out, int S, int nh) {
  using K = SsdShape<P, N>;
  constexpr int R = K::R, T = K::T, M = K::M, G = K::G, THREADS = K::THREADS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* red = smem + 2 * K::BUF;  // the partials of a pass
  const int bh = blockIdx.x, b = bh / nh, hd = bh % nh;
  const int g = threadIdx.x % G, rg = threadIdx.x / G;
  const int npass = (S + T - 1) / T;

  auto stage = [&](int pass) {
    float* buf = smem + (pass & 1) * K::BUF;
    const int nt = min(T, S - pass * T);
    const size_t row = (size_t)b * S + pass * T;  // token row of (b, t0)
    stage_rows<THREADS, T, P>(buf, x + (row * nh + hd) * P, nt, (size_t)nh * P);
    stage_rows<THREADS, T, N>(buf + T * P, Bc + row * N, nt, N);
    stage_rows<THREADS, T, N>(buf + T * (P + N), Cc + row * N, nt, N);
    stage_scalars<THREADS, T>(buf + T * (P + 2 * N), dt + row * nh + hd, nt, nh);
    stage_scalars<THREADS, T>(buf + T * (P + 2 * N) + T, la + row * nh + hd, nt, nh);
  };
  stage(0);
  cp_async_commit();
  if (npass > 1) stage(1);
  cp_async_commit();

  // h[R*rg + i, 4*(g + G*k) + q]: chunk k of a row is 4 floats, and the G
  // threads of a quarter-warp hold neighbouring chunks, so each 16-byte
  // load or store of the state (and read of B or C) covers 4*G contiguous
  // floats; held in registers from the first token to the last
  const size_t hbase = (size_t)bh * P * N + (size_t)R * rg * N + 4 * g;
  float hs[R][M];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < M / 4; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(h0 + hbase + i * N + 4 * G * k);
      hs[i][4 * k] = v.x, hs[i][4 * k + 1] = v.y, hs[i][4 * k + 2] = v.z,
      hs[i][4 * k + 3] = v.w;
    }

  for (int pass = 0; pass < npass; ++pass) {
    const float* xs = smem + (pass & 1) * K::BUF;
    const float* bs = xs + T * P + 4 * g;
    const float* cs = xs + T * (P + N) + 4 * g;
    float* dts = smem + (pass & 1) * K::BUF + T * (P + 2 * N);  // dt, then la
    const int nt = min(T, S - pass * T);
    cp_async_wait<1>();  // this thread's copies of the pass have landed
    // thread t staged la_t (stage_scalars): it turns it into the decay
    // e^{la_t} in place, once for the block
    if (threadIdx.x < nt) dts[T + threadIdx.x] = expf(dts[T + threadIdx.x]);
    __syncthreads();  // the pass and its decays, for every thread
#pragma unroll
    for (int tt = 0; tt < T; ++tt) {
      if (tt >= nt) break;
      const float a = dts[T + tt], d = dts[tt];
      const float4 x4 = *reinterpret_cast<const float4*>(xs + tt * P + R * rg);
      const float xdt[R] = {x4.x * d, x4.y * d, x4.z * d, x4.w * d};
      float acc[R] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < M / 4; ++k) {
        const float4 b4 = *reinterpret_cast<const float4*>(bs + tt * N + 4 * G * k);
        const float4 c4 = *reinterpret_cast<const float4*>(cs + tt * N + 4 * G * k);
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w}, cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < R; ++i) {
            float& h = hs[i][4 * k + q];
            h = fmaf(a, h, xdt[i] * bb[q]);
            acc[i] = fmaf(h, cc[q], acc[i]);
          }
      }
      *reinterpret_cast<float4*>(red + g * K::GS + tt * P + R * rg) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();  // partials written, this buffer consumed
    if (pass + 2 < npass) stage(pass + 2);
    cp_async_commit();
    combine_partials<G, T, P, THREADS, K::GS>(
        red, y + (((size_t)b * S + pass * T) * nh + hd) * P, nt, (size_t)nh * P);
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < M / 4; ++k)
      *reinterpret_cast<float4*>(h_out + hbase + i * N + 4 * G * k) = make_float4(
          hs[i][4 * k], hs[i][4 * k + 1], hs[i][4 * k + 2], hs[i][4 * k + 3]);
}

template <int P, int N>
cudaError_t ssd_smem() {  // once per instantiation and device
  static unsigned long long done = 0;
  return set_smem_once(ssd_kernel<P, N>, SsdShape<P, N>::BYTES, done);
}

template <int P, int N>
cudaError_t launch_ssd(const float* x, const float* dt, const float* la, const float* Bc,
                       const float* Cc, const float* h0, float* y, float* h_out, int B,
                       int S, int nh, cudaStream_t stream) {
  using K = SsdShape<P, N>;
  const cudaError_t attr = ssd_smem<P, N>();
  if (attr != cudaSuccess) return attr;
  ssd_kernel<P, N><<<B * nh, K::THREADS, K::BYTES, stream>>>(x, dt, la, Bc, Cc, h0, y,
                                                             h_out, S, nh);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t config_ssd(int* cfg) {
  using K = SsdShape<P, N>;
  cfg[0] = K::R, cfg[1] = K::G, cfg[2] = K::T, cfg[3] = K::THREADS;
  cfg[4] = static_cast<int>(K::BYTES);
  const cudaError_t err = ssd_smem<P, N>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cfg[5], ssd_kernel<P, N>,
                                                       K::THREADS, K::BYTES);
}

}  // namespace

// x, y (B, S, nh, P); dt, la (B, S, nh); Bc, Cc (B, S, N); h0, h_out
// (B, nh, P, N). fp32, contiguous; x, Bc, Cc, h0, y and h_out 16-byte
// aligned.
REPRO_API int ssd_f32(const float* x, const float* dt, const float* la, const float* Bc,
                      const float* Cc, const float* h0, float* y, float* h_out, int B,
                      int S, int nh, int P, int N, cudaStream_t stream) {
  if (P == 16 && N == 16)  // the smoke configs
    return launch_ssd<16, 16>(x, dt, la, Bc, Cc, h0, y, h_out, B, S, nh, stream);
  if (P == 64 && N == 64)  // zamba2-7b
    return launch_ssd<64, 64>(x, dt, la, Bc, Cc, h0, y, h_out, B, S, nh, stream);
  return cudaErrorInvalidValue;
}

// The launch configuration of ssd_f32 at (P, N): cfg = {state rows a
// thread, threads a state row, tokens a pass, threads a block, shared bytes
// a block, blocks an SM (the occupancy calculator, registers included)}.
REPRO_API int ssd_config(int P, int N, int* cfg) {
  if (P == 16 && N == 16) return config_ssd<16, 16>(cfg);
  if (P == 64 && N == 64) return config_ssd<64, 64>(cfg);
  return cudaErrorInvalidValue;
}
