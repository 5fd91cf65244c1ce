// RWKV-6 WKV scan, backward, fp32, sm_90a. The gradients of wkv.cu's
// (o, final state) with respect to r, k, v, w, u and the incoming state,
// given do and dstate. Per (b, h), with S_{t-1} the state before token t,
// G_t = dL/dS_t (G_S = dstate) and vd_t = v_t . do_t:
//   G_{t-1}[n, j] = w_t[n] G_t[n, j] + r_t[n] do_t[j]
//   dr_t[n] = sum_j S_{t-1}[n, j] do_t[j] + u[n] k_t[n] vd_t
//   dk_t[n] = sum_j G_t[n, j] v_t[j] + u[n] r_t[n] vd_t
//   dv_t[j] = sum_n (G_t[n, j] k_t[n] + r_t[n] u[n] k_t[n] do_t[j])
//   dw_t[n] = sum_j G_t[n, j] S_{t-1}[n, j]
//   du[h, n] = sum_b sum_t r_t[n] k_t[n] vd_t,   dstate0 = G_0
// (plain version: ref.wkv_backward_ref).
//
// Differentiates the forward of the TPU kernel src/repro/kernels/rwkv6/
// rwkv6.py: wkv_pallas (def :70, pallas_call :89), whose port is wkv.cu.
// The JAX package has no backward kernel: it trains through autograd of
// its jnp chunked forms. Here training runs the forward kernel and this
// reverse scan (ops.WKV), never autograd of the plain version.
//
// Bound on this card at rwkv6-7b's training shape, one silo's share of a
// 16 x 64 batch, (B, S, H, N) = (4, 64, 64, 64): bytes. Each input read
// once and each output written once: r, k, v, w, do in and dr, dk, dv, dw
// out (B*S*H*N each), the state and dstate in and dstate0 out (B*H*N*N
// each), u in and du out: 12.6 M floats, 50.3 MB, 15.0 us at 3.35 TB/s.
// The fp32 work, 12 operations per (token, n, j) (the state, dr, dk, dw,
// dv and the carried G, one multiply-add each), is 805 MFLOP, 12.0 us.
//
// Design (the first, simple version; times in PERF.md):
//   - one block per (b, h), N threads; thread n owns row n of the state
//     and of G, N floats each in registers;
//   - the states are recomputed forward, never stepped back by dividing by
//     w_t (unstable where strong decay drives w_t toward 0): a first pass from state0 writes the state before every
//     T-token chunk into a scratch of B*H*ceil(S/T)*N*N floats; the second
//     pass walks the chunks from last to first, reloads the chunk's
//     checkpoint, recomputes its T states into shared memory (each thread
//     its own row) and carries G back over the chunk's tokens;
//   - dr, dk and dw sum over j inside a thread; dv sums over n across the
//     threads: each thread writes its N partials to shared memory (rows
//     padded to N + 1 floats, so neither the writes nor the reads conflict),
//     and thread j adds column j's in ascending n; the buffer alternates
//     between two copies, so a token needs one __syncthreads;
//   - du sums over b and t: each block adds its tokens in the order it
//     walks them (t descending) into a partial of its own, and a second
//     launch adds the partials in ascending b. Nothing sums with float
//     atomics, so two launches on the same inputs agree bit for bit.
#include "common.cuh"

namespace {

constexpr int WKVB_T = 4;  // tokens a chunk: between checkpoints

template <int N>
struct WkvBwdShape {
  static constexpr int T = WKVB_T;
  static constexpr int TOK = 5 * T * N;       // r, k, v, w, do of a chunk
  static constexpr int SBUF = T * N * N;      // the chunk's states [tt][j][n]
  static constexpr int RED = N * (N + 1);     // dv partials [j][n], padded
  static constexpr size_t BYTES = sizeof(float) * (TOK + T + SBUF + 2 * RED);
  static_assert(T <= N, "a thread a token's v . do");
};

template <int N>
__global__ void __launch_bounds__(N)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               const float* __restrict__ dout, const float* __restrict__ dstate,
               float* __restrict__ ckpt, float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part,
               float* __restrict__ ds0, int S, int H) {
  using K = WkvBwdShape<N>;
  constexpr int T = K::T;
  extern __shared__ float smem[];
  float* rs = smem;
  float* ks = rs + T * N;
  float* vs = ks + T * N;
  float* ws = vs + T * N;
  float* dos = ws + T * N;
  float* vd = dos + T * N;
  float* sbuf = vd + T;
  float* red = sbuf + K::SBUF;
  const int bh = blockIdx.x, b = bh / H, h = bh % H, n = threadIdx.x;
  const int nck = (S + T - 1) / T;
  const size_t tstride = (size_t)H * N;
  float* my_ckpt = ckpt + (size_t)bh * nck * N * N;

  // the chunk's tokens into shared memory, t from c * T, coalesced
  auto stage = [&](int c, int nt, bool all) {
    const size_t off = (((size_t)b * S + (size_t)c * T) * H + h) * N;
    for (int i = n; i < nt * N; i += N) {
      const int tt = i / N, x = i % N;
      const size_t g = off + tt * tstride + x;
      ks[i] = k[g];
      vs[i] = v[g];
      ws[i] = w[g];
      if (all) {
        rs[i] = r[g];
        dos[i] = dout[g];
      }
    }
  };

  float st[N];
#pragma unroll
  for (int j = 0; j < N; ++j) st[j] = s0[(size_t)bh * N * N + (size_t)n * N + j];

  // pass 1: the checkpoints, the state before each chunk ([j][n]: coalesced)
  for (int c = 0; c < nck; ++c) {
#pragma unroll
    for (int j = 0; j < N; ++j) my_ckpt[((size_t)c * N + j) * N + n] = st[j];
    if (c == nck - 1) break;
    __syncthreads();
    stage(c, T, false);
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < T; ++tt) {
      const float kn = ks[tt * N + n], wn = ws[tt * N + n];
#pragma unroll
      for (int j = 0; j < N; ++j) st[j] = fmaf(wn, st[j], kn * vs[tt * N + j]);
    }
  }

  // pass 2: the chunks from last to first
  float g[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    g[j] = dstate ? dstate[(size_t)bh * N * N + (size_t)n * N + j] : 0.f;
  const float un = u[h * N + n];
  float du_acc = 0.f;
  int par = 0;
  for (int c = nck - 1; c >= 0; --c) {
    const int nt = min(T, S - c * T);
    __syncthreads();  // the previous chunk's tokens are consumed
    stage(c, nt, true);
    __syncthreads();
    if (n < nt) {
      float s = 0.f;
      for (int j = 0; j < N; ++j) s = fmaf(vs[n * N + j], dos[n * N + j], s);
      vd[n] = s;
    }
    // this chunk's states S_{t-1}, row n, from its checkpoint
#pragma unroll
    for (int j = 0; j < N; ++j) st[j] = my_ckpt[((size_t)c * N + j) * N + n];
    for (int tt = 0; tt < nt; ++tt) {
      const float kn = ks[tt * N + n], wn = ws[tt * N + n];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        sbuf[(tt * N + j) * N + n] = st[j];
        st[j] = fmaf(wn, st[j], kn * vs[tt * N + j]);
      }
    }
    __syncthreads();  // vd
    for (int tt = nt - 1; tt >= 0; --tt) {
      const size_t at = (((size_t)b * S + (size_t)c * T + tt) * H + h) * N;
      const float rn = rs[tt * N + n], kn = ks[tt * N + n], wn = ws[tt * N + n];
      const float vdt = vd[tt], ruk = rn * un * kn;
      float* rd = red + par * K::RED;
      float sdr = 0.f, sdk = 0.f, sdw = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float sp = sbuf[(tt * N + j) * N + n];
        const float dj = dos[tt * N + j], vj = vs[tt * N + j];
        sdr = fmaf(sp, dj, sdr);
        sdk = fmaf(g[j], vj, sdk);
        sdw = fmaf(g[j], sp, sdw);
        rd[j * (N + 1) + n] = fmaf(g[j], kn, ruk * dj);
        g[j] = fmaf(wn, g[j], rn * dj);
      }
      dr[at + n] = fmaf(un * kn, vdt, sdr);
      dk[at + n] = fmaf(un * rn, vdt, sdk);
      dw[at + n] = sdw;
      du_acc = fmaf(rn * kn, vdt, du_acc);
      __syncthreads();  // the partials of this token are written
      float s = rd[n * (N + 1)];
      for (int x = 1; x < N; ++x) s += rd[n * (N + 1) + x];
      dv[at + n] = s;
      par ^= 1;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) ds0[(size_t)bh * N * N + (size_t)n * N + j] = g[j];
  du_part[(size_t)bh * N + n] = du_acc;
}

// du[h, n] = sum over b ascending of du_part[b, h, n]
__global__ void wkv_du_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                              int B, int HN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HN) return;
  float s = du_part[i];
  for (int b = 1; b < B; ++b) s += du_part[(size_t)b * HN + i];
  du[i] = s;
}

template <int N>
cudaError_t launch_wkv_bwd(const float* r, const float* k, const float* v, const float* w,
                           const float* u, const float* s0, const float* dout,
                           const float* dstate, float* ckpt, float* du_part, float* dr,
                           float* dk, float* dv, float* dw, float* du, float* ds0, int B,
                           int S, int H, cudaStream_t stream) {
  using K = WkvBwdShape<N>;
  static unsigned long long done = 0;
  cudaError_t err = set_smem_once(wkv_bwd_kernel<N>, K::BYTES, done);
  if (err != cudaSuccess) return err;
  wkv_bwd_kernel<N><<<B * H, N, K::BYTES, stream>>>(r, k, v, w, u, s0, dout, dstate, ckpt,
                                                    dr, dk, dv, dw, du_part, ds0, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int HN = H * N;
  wkv_du_kernel<<<(HN + 255) / 256, 256, 0, stream>>>(du_part, du, B, HN);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, do, dr, dk, dv, dw (B, S, H, N); u, du (H, N); s0, dstate,
// ds0 (B, H, N, N); dstate may be null (zero); ckpt the checkpoints'
// scratch, ckpt_len >= B*H*ceil(S/WKVB_T)*N*N floats; du_part (B, H, N).
// fp32, contiguous. Two launches: the scan, then du.
REPRO_API int wkv_bwd_f32(const float* r, const float* k, const float* v, const float* w,
                          const float* u, const float* s0, const float* dout,
                          const float* dstate, float* ckpt, long long ckpt_len,
                          float* du_part, float* dr, float* dk, float* dv, float* dw,
                          float* du, float* ds0, int B, int S, int H, int N,
                          cudaStream_t stream) {
  if (ckpt_len < (long long)B * H * ((S + WKVB_T - 1) / WKVB_T) * N * N)
    return cudaErrorInvalidValue;
  switch (N) {
    case 16:
      return launch_wkv_bwd<16>(r, k, v, w, u, s0, dout, dstate, ckpt, du_part, dr, dk, dv,
                                dw, du, ds0, B, S, H, stream);
    case 32:
      return launch_wkv_bwd<32>(r, k, v, w, u, s0, dout, dstate, ckpt, du_part, dr, dk, dv,
                                dw, du, ds0, B, S, H, stream);
    case 64:
      return launch_wkv_bwd<64>(r, k, v, w, u, s0, dout, dstate, ckpt, du_part, dr, dk, dv,
                                dw, du, ds0, B, S, H, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
