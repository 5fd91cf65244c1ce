// Mamba-2 SSD scan, backward, fp32, sm_90a. The gradients of ssd.cu's
// (y, final h) with respect to x, dt, la, B, C and the incoming state,
// given dy and dh. Per (b, head), with a_t = e^{la_t}, h_t the state after
// token t (y_t = h_t C_t) and H_t = dL/dh_t = dy_t C_t^T + a_{t+1} H_{t+1}
// (plus dh at the last token):
//   dx_t[p] = dt_t sum_n H_t[p, n] B_t[n]
//   ddt_t   = sum_{p, n} H_t[p, n] x_t[p] B_t[n]
//   dla_t   = a_t sum_{p, n} H_t[p, n] h_{t-1}[p, n]
//   dB_t[n] = sum_heads sum_p H_t[p, n] dt_t x_t[p]
//   dC_t[n] = sum_heads sum_p h_t[p, n] dy_t[p],   dh0 = a_1 H_1
// (plain version: ref.ssd_backward_ref).
//
// Differentiates the forward of the TPU kernel src/repro/kernels/mamba2/
// mamba2.py: ssd_pallas (def :67, pallas_call :89), whose port is ssd.cu.
// The JAX package has no backward kernel: it trains through autograd of
// its jnp chunked form. Here training runs the forward kernel and this
// reverse scan (ops.SSD), never autograd of the plain version.
//
// Bound on this card at zamba2-7b's training shape, one silo's share of a
// 16 x 64 batch, (B, S, nh, P, N) = (4, 64, 112, 64, 64): operations. The
// fp32 work, 13 operations per (token, p, n) (the state, H_t, dx's and
// dB's, dC's and dla's products and sums, the carried a H), is 1.53 GFLOP,
// 22.8 us at 67 TFLOP/s; the bytes, each input read once and each output
// written once (x, dy and dx, B*S*nh*P each; the state, dh and dh0,
// B*nh*P*N each; dt, la, ddt, dla, B, C, dB and dC), 11.2 M floats, 44.8
// MB, are 13.4 us at 3.35 TB/s.
//
// Design (the first, simple version; times in PERF.md):
//   - one block per (b, head), P threads; thread p owns row p of h and of
//     the carried a_{t+1} H_{t+1}, N floats each in registers;
//   - the states are recomputed forward, never stepped back by dividing by
//     a_t (which reaches 1e-7 at zamba2's A_log up to log 16): a first pass
//     from h0 writes the state before every T-token chunk into a scratch of
//     B*nh*ceil(S/T)*P*N floats; the second pass walks the chunks from last
//     to first, reloads the chunk's checkpoint, recomputes its T states
//     into shared memory (each thread its own row) and carries H back;
//   - dx sums over n inside a thread; dB, dC, ddt and dla sum over p across
//     the threads: each thread writes its partials to shared memory (rows
//     padded to P + 1 floats) and thread n adds row n's in ascending p;
//   - dB and dC also sum over the heads, which share B_t and C_t: each
//     block writes its head's sums to a partial of its own, and a second
//     launch adds the partials in ascending head. Nothing sums with float
//     atomics, so two launches on the same inputs agree bit for bit.
#include "common.cuh"

namespace {

constexpr int SSDB_T = 4;  // tokens a chunk: between checkpoints

template <int P, int N>
struct SsdBwdShape {
  static constexpr int T = SSDB_T;
  static constexpr int TOK = T * (2 * P + 2 * N) + 2 * T;  // x, dy, B, C, dt, a
  static constexpr int SBUF = T * N * P;                   // states [tt][n][p]
  static constexpr int RED = N * (P + 1);                  // [n][p], padded
  static constexpr size_t BYTES = sizeof(float) * (TOK + SBUF + 2 * RED + 2 * P);
  static_assert(N <= P && T <= P, "a thread a row of the sums, a token's decay");
};

template <int P, int N>
__global__ void __launch_bounds__(P)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ la, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ h0,
               const float* __restrict__ dy, const float* __restrict__ dh,
               float* __restrict__ ckpt, float* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ dla, float* __restrict__ dB_part,
               float* __restrict__ dC_part, float* __restrict__ dh0, int S, int nh) {
  using K = SsdBwdShape<P, N>;
  constexpr int T = K::T;
  extern __shared__ float smem[];
  float* xs = smem;
  float* dys = xs + T * P;
  float* bs = dys + T * P;
  float* cs = bs + T * N;
  float* dts = cs + T * N;
  float* as = dts + T;
  float* sbuf = as + T;
  float* redB = sbuf + K::SBUF;
  float* redC = redB + K::RED;
  float* redS = redC + K::RED;  // [2][P]: ddt's and dla's partials
  const int bhd = blockIdx.x, b = bhd / nh, hd = bhd % nh, p = threadIdx.x;
  const int nck = (S + T - 1) / T;
  float* my_ckpt = ckpt + (size_t)bhd * nck * P * N;

  auto stage = [&](int c, int nt, bool all) {
    const size_t t0 = (size_t)b * S + (size_t)c * T;
    for (int i = p; i < nt * P; i += P) {
      const int tt = i / P, q = i % P;
      const size_t g = ((t0 + tt) * nh + hd) * P + q;
      xs[i] = x[g];
      if (all) dys[i] = dy[g];
    }
    for (int i = p; i < nt * N; i += P) {
      const int tt = i / N, q = i % N;
      bs[i] = Bm[(t0 + tt) * N + q];
      if (all) cs[i] = Cm[(t0 + tt) * N + q];
    }
    if (p < nt) {
      dts[p] = dt[(t0 + p) * nh + hd];
      as[p] = expf(la[(t0 + p) * nh + hd]);
    }
  };

  float hc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) hc[n] = h0[(size_t)bhd * P * N + (size_t)p * N + n];

  // pass 1: the checkpoints, the state before each chunk ([n][p]: coalesced)
  for (int c = 0; c < nck; ++c) {
#pragma unroll
    for (int n = 0; n < N; ++n) my_ckpt[((size_t)c * N + n) * P + p] = hc[n];
    if (c == nck - 1) break;
    __syncthreads();
    stage(c, T, false);
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < T; ++tt) {
      const float a = as[tt], xdt = dts[tt] * xs[tt * P + p];
#pragma unroll
      for (int n = 0; n < N; ++n) hc[n] = fmaf(a, hc[n], xdt * bs[tt * N + n]);
    }
  }

  // pass 2: the chunks from last to first
  float hn[N];  // a_{t+1} H_{t+1}
#pragma unroll
  for (int n = 0; n < N; ++n)
    hn[n] = dh ? dh[(size_t)bhd * P * N + (size_t)p * N + n] : 0.f;
  for (int c = nck - 1; c >= 0; --c) {
    const int nt = min(T, S - c * T);
    __syncthreads();  // the previous chunk's tokens are consumed
    stage(c, nt, true);
    __syncthreads();
    // this chunk's states h_{t-1}, row p, from its checkpoint; hc ends as
    // the state after the chunk's last token
#pragma unroll
    for (int n = 0; n < N; ++n) hc[n] = my_ckpt[((size_t)c * N + n) * P + p];
    for (int tt = 0; tt < nt; ++tt) {
      const float a = as[tt], xdt = dts[tt] * xs[tt * P + p];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        sbuf[(tt * N + n) * P + p] = hc[n];
        hc[n] = fmaf(a, hc[n], xdt * bs[tt * N + n]);
      }
    }
    for (int tt = nt - 1; tt >= 0; --tt) {
      const size_t t = (size_t)b * S + (size_t)c * T + tt;
      const float xp = xs[tt * P + p], dyp = dys[tt * P + p];
      const float dtt = dts[tt], a = as[tt], xdt = dtt * xp;
      float hb = 0.f, sla = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float Ht = fmaf(dyp, cs[tt * N + n], hn[n]);
        const float hp = sbuf[(tt * N + n) * P + p];
        hb = fmaf(Ht, bs[tt * N + n], hb);
        sla = fmaf(Ht, hp, sla);
        redB[n * (P + 1) + p] = Ht * xdt;
        redC[n * (P + 1) + p] = hc[n] * dyp;
        hc[n] = hp;
        hn[n] = a * Ht;
      }
      dx[t * nh * P + (size_t)hd * P + p] = dtt * hb;
      redS[p] = xp * hb;
      redS[P + p] = sla;
      __syncthreads();  // the partials of this token are written
      if (p < N) {
        float sb = redB[p * (P + 1)], sc = redC[p * (P + 1)];
        for (int q = 1; q < P; ++q) {
          sb += redB[p * (P + 1) + q];
          sc += redC[p * (P + 1) + q];
        }
        dB_part[(t * nh + hd) * N + p] = sb;
        dC_part[(t * nh + hd) * N + p] = sc;
      }
      if (p == N - 1 || p == N - 2) {  // two threads, one scalar each
        const float* rs = redS + (p == N - 1 ? 0 : P);
        float s = rs[0];
        for (int q = 1; q < P; ++q) s += rs[q];
        if (p == N - 1)
          ddt[t * nh + hd] = s;
        else
          dla[t * nh + hd] = a * s;
      }
      __syncthreads();  // the partials are read
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) dh0[(size_t)bhd * P * N + (size_t)p * N + n] = hn[n];
}

// dB[b, t, n] and dC[b, t, n]: the heads' partials added in ascending head
__global__ void ssd_dbc_kernel(const float* __restrict__ dB_part,
                               const float* __restrict__ dC_part, float* __restrict__ dB,
                               float* __restrict__ dC, long long BS, int nh, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BS * N) return;
  const long long t = i / N, n = i % N;
  const float* pb = dB_part + t * nh * N + n;
  const float* pc = dC_part + t * nh * N + n;
  float sb = pb[0], sc = pc[0];
  for (int hd = 1; hd < nh; ++hd) {
    sb += pb[(size_t)hd * N];
    sc += pc[(size_t)hd * N];
  }
  dB[i] = sb;
  dC[i] = sc;
}

template <int P, int N>
cudaError_t launch_ssd_bwd(const float* x, const float* dt, const float* la,
                           const float* Bm, const float* Cm, const float* h0,
                           const float* dy, const float* dh, float* ckpt, float* dB_part,
                           float* dC_part, float* dx, float* ddt, float* dla, float* dB,
                           float* dC, float* dh0, int B, int S, int nh,
                           cudaStream_t stream) {
  using K = SsdBwdShape<P, N>;
  static unsigned long long done = 0;
  cudaError_t err = set_smem_once(ssd_bwd_kernel<P, N>, K::BYTES, done);
  if (err != cudaSuccess) return err;
  ssd_bwd_kernel<P, N><<<B * nh, P, K::BYTES, stream>>>(
      x, dt, la, Bm, Cm, h0, dy, dh, ckpt, dx, ddt, dla, dB_part, dC_part, dh0, S, nh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long BS = (long long)B * S;
  ssd_dbc_kernel<<<(unsigned)((BS * N + 255) / 256), 256, 0, stream>>>(dB_part, dC_part, dB,
                                                                       dC, BS, nh, N);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx (B, S, nh, P); dt, la, ddt, dla (B, S, nh); Bm, Cm, dB, dC
// (B, S, N); h0, dh, dh0 (B, nh, P, N); dh may be null (zero); ckpt the
// checkpoints' scratch, ckpt_len >= B*nh*ceil(S/SSDB_T)*P*N floats;
// dB_part, dC_part (B, S, nh, N). fp32, contiguous. Two launches: the scan,
// then the heads' sums of dB and dC.
REPRO_API int ssd_bwd_f32(const float* x, const float* dt, const float* la, const float* Bm,
                          const float* Cm, const float* h0, const float* dy, const float* dh,
                          float* ckpt, long long ckpt_len, float* dB_part, float* dC_part,
                          float* dx, float* ddt, float* dla, float* dB, float* dC, float* dh0,
                          int B, int S, int nh, int P, int N, cudaStream_t stream) {
  if (ckpt_len < (long long)B * nh * ((S + SSDB_T - 1) / SSDB_T) * P * N)
    return cudaErrorInvalidValue;
  if (P == 16 && N == 16)
    return launch_ssd_bwd<16, 16>(x, dt, la, Bm, Cm, h0, dy, dh, ckpt, dB_part, dC_part, dx,
                                  ddt, dla, dB, dC, dh0, B, S, nh, stream);
  if (P == 64 && N == 64)
    return launch_ssd_bwd<64, 64>(x, dt, la, Bm, Cm, h0, dy, dh, ckpt, dB_part, dC_part, dx,
                                  ddt, dla, dB, dC, dh0, B, S, nh, stream);
  return cudaErrorInvalidValue;
}
