// RWKV-6 WKV scan, backward, fp32, sm_90a. The gradients of wkv.cu's
// (o, final state) with respect to r, k, v, w, u and the incoming state,
// given do and dstate. Per (b, h), with S_{t-1} the state before token t,
// G_t = dL/dS_t (G_S = dstate) and vd_t = v_t . do_t:
//   G_{t-1}[n, j] = w_t[n] G_t[n, j] + r_t[n] do_t[j]
//   dr_t[n] = sum_j S_{t-1}[n, j] do_t[j] + u[n] k_t[n] vd_t
//   dk_t[n] = sum_j G_t[n, j] v_t[j] + u[n] r_t[n] vd_t
//   dv_t[j] = sum_n G_t[n, j] k_t[n] + (sum_n r_t[n] u[n] k_t[n]) do_t[j]
//   dw_t[n] = sum_j G_t[n, j] S_{t-1}[n, j]
//   du[h, n] = sum_b sum_t r_t[n] k_t[n] vd_t,   dstate0 = G_0
// (plain version: ref.wkv_backward_ref; this kernel's order of sums:
// ref.wkv_backward_split_ref).
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
// The first version (one block of N threads a (b, h), a thread a state
// row, checkpoints every 4 tokens) ran at 7% of that bound (0.211 ms):
//   - its checkpoint scratch, B*H*S/4 states (67.1 MB), went through device
//     memory, more bytes than the bound's;
//   - 2 warps a block and 101 KB of shared memory, 4 warps an SM;
//   - a __syncthreads a token, then a 64-deep serial sum of dv;
//   - each 4-token chunk staged with plain loads between two syncs.
// This design (the reverse walk of scan_tile.cuh; times in PERF.md):
//   - a thread holds a 4 x 8 tile of G and of the state (rows n, columns
//     j; N 64), 128 threads a block, two blocks an SM: the 256 blocks of
//     the main shape run in one wave (8 warps an SM: 16, with 4 x 4 tiles,
//     ran no faster);
//   - the global checkpoints are the state before every WKVB_T = 16-token
//     pass but the first (state0) and the last (kept in registers):
//     B*H*(ceil(S/16) - 2) states, 8.4 MB at the main shape, written and
//     read back by the block that owns them while they sit in the L2;
//   - a pass's sub-checkpoints, one every WKVB_Q = 4 tokens, go to shared
//     memory (each thread its own tile, no sync), and each 4-token
//     sub-chunk is walked back from its sub-checkpoint in two register
//     tiles (walk_back): 2.75 state steps a token in all;
//   - a thread adds its 8 columns of each sum over j (dr's, dk's, dw's and
//     v . do); the 8 lanes that share a row halve those four sums across
//     them (lane_halve), two to a lane: the lane stores dr and dk of its
//     row straight to device memory, or dw, and adds its row's du; no
//     partial of these goes through shared memory. dv's sum over n is
//     halved across the warp's four row groups, then the 4 warps' partials
//     are combined once a sub-chunk in warp order with 16-byte stores, c_t
//     = r_t . u . k_t added from a sum each warp takes for its share of the
//     pass's tokens;
//   - the pass's r, k, v, w and do are staged with 16-byte cp.async copies,
//     the pass before in flight in a second buffer while this one walks;
//   - du sums over b and t: the lane that ends with row n's v . do adds
//     r k vd into a partial of its block, t descending, and a second launch
//     adds the partials in ascending b. Nothing sums with float atomics,
//     so two launches on the same inputs agree bit for bit.
// What bounds it now is instruction issue, at about half the rate the card
// allows: 6 fp32 operations a state element a token for the gradients and
// 2 for each of the 2.75 state steps (two thirds of the walk's
// instructions), the lanes' halving (about a tenth of the time) around
// them; no one stall is most of the rest (PERF.md).
#include "scan_tile.cuh"

namespace {

constexpr int WKVB_T = 16;  // tokens a pass: between the global checkpoints
constexpr int WKVB_Q = 4;   // tokens a sub-chunk: between the shared ones

template <int N>
struct WkvBwdShape {
  static constexpr int T = WKVB_T, Q = WKVB_Q, NQ = T / Q;
  static constexpr int M = N / 16;        // state rows n a thread
  static constexpr int R = 8;             // state columns j a thread
  static constexpr int E = M * R;         // a tile: M rows x R columns
  static constexpr int CG = N / R;        // column groups: lanes that share a row
  static constexpr int RL = 32 / CG;      // row groups a warp
  static constexpr int LC = log2i(CG);    // levels across a row's lanes
  static constexpr int W = N / (RL * M);  // warps (16 rows each)
  static constexpr int THREADS = 32 * W;
  static constexpr int LV = log2i(RL);    // dv: levels across a warp's row groups
  static constexpr int LH = LV < 3 ? LV : 3;  // of which halve the R columns
  static constexpr int DVN = R >> LH;     // dv values a lane ends with
  static constexpr int TW = T / W;        // a pass's tokens a warp sums c_t of
  static constexpr int UL = (N + 31) / 32;  // u's values a lane holds for c_t
  static constexpr int BUF = 5 * T * N;   // r, k, v, w, do of a pass
  static constexpr int SUB = N * N;       // a sub-checkpoint
  static constexpr int DV = Q * W * N;    // a sub-chunk's dv partials [tq][warp][j]
  static constexpr size_t BYTES = sizeof(float) * (2 * BUF + NQ * SUB + DV + T);
  static_assert(N % 16 == 0 && 4 * M == 2 * CG, "a row's four sums, two to a lane");
  static_assert(DV <= SUB, "dv partials fit a spent sub-checkpoint");
  static_assert(T % Q == 0 && Q == 4, "walk_back's four tokens");
};

template <int N>
__global__ void __launch_bounds__(WkvBwdShape<N>::THREADS, 2)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               const float* __restrict__ dout, const float* __restrict__ dstate,
               float* __restrict__ ckpt, float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part,
               float* __restrict__ ds0, int S, int H) {
  using K = WkvBwdShape<N>;
  constexpr int T = K::T, Q = K::Q, M = K::M, R = K::R, E = K::E, CG = K::CG, W = K::W;
  constexpr int THREADS = K::THREADS, TN = T * N;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* slots = smem + 2 * K::BUF;  // the pass's sub-checkpoints
  float* dvbuf = slots + K::NQ * K::SUB;
  float* cs = dvbuf + K::DV;  // c_t = sum_n r_t u k_t of the pass's tokens
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int cg = lane % CG, rg = wid * K::RL + lane / CG;
  const int n0 = rg * M, j0 = K::R * cg;
  // after the halving: this lane's row and two sums, dr's and dk's (even
  // cg) or dw's and v . do (odd cg)
  const int nr = n0 + cg / 2, odd = cg & 1;
  const float un = u[h * N + nr];
  float ul[K::UL];  // u[h, lane + 32 y], for c_t
#pragma unroll
  for (int y = 0; y < K::UL; ++y) ul[y] = lane + 32 * y < N ? u[h * N + lane + 32 * y] : 0.f;
  const int npass = (S + T - 1) / T;
  const size_t tstride = (size_t)H * N, tok0 = (size_t)b * S;
  const size_t sbase = (size_t)bh * N * N + (size_t)n0 * N + j0;  // the tile
  float* my_ckpt = ckpt + (size_t)bh * max(npass - 2, 0) * N * N;

  // pass p's inputs into buffer p & 1: k, v, w to step the state; r and do
  // too for the reverse walk
  auto stage = [&](int p, bool all) {
    if (p < 0 || p >= npass) return;
    float* buf = smem + (p & 1) * K::BUF;
    const int nt = min(T, S - p * T);
    const size_t off = ((tok0 + (size_t)p * T) * H + h) * N;
    stage_rows<THREADS, T, N>(buf + TN, k + off, nt, tstride);
    stage_rows<THREADS, T, N>(buf + 2 * TN, v + off, nt, tstride);
    stage_rows<THREADS, T, N>(buf + 3 * TN, w + off, nt, tstride);
    if (all) {
      stage_rows<THREADS, T, N>(buf, r + off, nt, tstride);
      stage_rows<THREADS, T, N>(buf + 4 * TN, dout + off, nt, tstride);
    }
  };
  auto load_tile = [&](float (&x)[E], const float* src) {
#pragma unroll
    for (int i = 0; i < M; ++i) ld_vec<R>(x + R * i, src + (size_t)i * N);
  };
  auto store_tile = [&](float* dst, const float (&x)[E]) {
#pragma unroll
    for (int i = 0; i < M; ++i) st_vec<R>(dst + (size_t)i * N, x + R * i);
  };
  // S <- diag(w_t) S + k_t v_t^T on the tile, token tt of the pass in buf
  auto step = [&](float (&x)[E], const float* buf, int tt) {
    float kk[M], ww[M], vv[R];
    ld_vec<M>(kk, buf + TN + tt * N + n0);
    ld_vec<R>(vv, buf + 2 * TN + tt * N + j0);
    ld_vec<M>(ww, buf + 3 * TN + tt * N + n0);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int q = 0; q < R; ++q) x[R * i + q] = fmaf(ww[i], x[R * i + q], kk[i] * vv[q]);
  };

  float X[E], Y[E], G[E];
  struct Part {
    float red[4 * M], adv[R];
  } pa, pb;  // two tokens' partials in flight (walk_back)
  load_tile(X, s0 + sbase);
  stage(0, npass == 1);
  cp_async_commit();
  stage(1, npass == 2);
  cp_async_commit();

  // the forward walk: the state before each pass but the first and the last
  for (int p = 0; p + 1 < npass; ++p) {
    cp_async_wait<1>();  // this pass's group has landed
    __syncthreads();
    if (p >= 1) store_tile(my_ckpt + (size_t)(p - 1) * N * N + (size_t)n0 * N + j0, X);
    const float* buf = smem + (p & 1) * K::BUF;
#pragma unroll 4
    for (int tt = 0; tt < T; ++tt) step(X, buf, tt);
    __syncthreads();  // this buffer is consumed
    stage(p + 2, p + 2 == npass - 1);
    cp_async_commit();
  }

  // the reverse walk
  if (dstate) {
    load_tile(G, dstate + sbase);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) G[e] = 0.f;
  }
  float du_acc = 0.f;
  for (int p = npass - 1; p >= 0; --p) {
    const int nt = min(T, S - p * T), nsub = (nt + Q - 1) / Q;
    cp_async_wait<0>();
    __syncthreads();  // the pass's inputs, for every thread; the last combine is done
    stage(p - 1, true);
    cp_async_commit();
    const float* buf = smem + (p & 1) * K::BUF;
    // c_t for the pass's tokens: warp wid takes tokens wid, wid + W, ...
    // (lane l adds n = l, l + 32, ...; then the warp's xor tree, all of the
    // warp's tokens at once)
    {
      float c[K::TW];
#pragma unroll
      for (int x = 0; x < K::TW; ++x) {
        const int tt = wid + x * W;
        c[x] = 0.f;
        if (tt < nt)
#pragma unroll
          for (int y = 0; y < K::UL; ++y)
            if (lane + 32 * y < N)
              c[x] = fmaf(buf[tt * N + lane + 32 * y] * ul[y], buf[TN + tt * N + lane + 32 * y],
                          c[x]);
      }
      lane_butterfly<K::TW, 16, 5>(c);
#pragma unroll
      for (int x = 0; x < K::TW; ++x)
        if (lane == 0 && wid + x * W < nt) cs[wid + x * W] = c[x];
    }
    // the sub-checkpoints, from the state before the pass
    if (p < npass - 1) load_tile(X, p == 0 ? s0 + sbase : my_ckpt + (size_t)(p - 1) * N * N +
                                                             (size_t)n0 * N + j0);
    for (int q = 0; q < nsub; ++q) {
      tile_to_smem<THREADS>(slots + q * K::SUB, X);
      if (q + 1 < nsub)
#pragma unroll
        for (int s = 0; s < Q; ++s) step(X, buf, q * Q + s);
    }
    for (int q = nsub - 1; q >= 0; --q) {
      const int t0 = q * Q, nq = min(Q, nt - t0);
      // the sub-chunk's dv partials: the spare buffer, or the first
      // sub-chunk's sub-checkpoint once it is spent (after its sync)
      float* dvp = ((nsub - 1 - q) & 1) ? slots + (nsub - 1) * K::SUB : dvbuf;
      // a token's own partials: red [row][dr, dk, dw, v . do] over the
      // thread's R columns, adv over its M rows; G steps back over the token
      auto grad = [&](int tt, const float (&sp)[E], Part& pt) {
        float rr[M], kk[M], ww[M], vv[R], dd[R];
        ld_vec<M>(rr, buf + tt * N + n0);
        ld_vec<M>(kk, buf + TN + tt * N + n0);
        ld_vec<R>(vv, buf + 2 * TN + tt * N + j0);
        ld_vec<M>(ww, buf + 3 * TN + tt * N + n0);
        ld_vec<R>(dd, buf + 4 * TN + tt * N + j0);
        float vdp = 0.f;
#pragma unroll
        for (int q4 = 0; q4 < R; ++q4) vdp = fmaf(vv[q4], dd[q4], vdp);
#pragma unroll
        for (int q4 = 0; q4 < R; ++q4) pt.adv[q4] = 0.f;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          float sdr = 0.f, sdk = 0.f, sdw = 0.f;
#pragma unroll
          for (int q4 = 0; q4 < R; ++q4) {
            const float s = sp[R * i + q4], g = G[R * i + q4];
            sdr = fmaf(s, dd[q4], sdr);
            sdk = fmaf(g, vv[q4], sdk);
            sdw = fmaf(g, s, sdw);
            pt.adv[q4] = fmaf(g, kk[i], pt.adv[q4]);
            G[R * i + q4] = fmaf(ww[i], g, rr[i] * dd[q4]);
          }
          pt.red[4 * i] = sdr, pt.red[4 * i + 1] = sdk, pt.red[4 * i + 2] = sdw;
          pt.red[4 * i + 3] = vdp;
        }
      };
      // the token's sums across lanes, stored
      auto emit = [&](int tt, Part& pt) {
        const size_t at = ((tok0 + (size_t)p * T + tt) * H + h) * N;
        // across the CG lanes of the row group: red[0, 2) are this lane's sums
        lane_halve<4 * M, CG / 2, K::LC>(pt.red);
        const float other = __shfl_xor_sync(FULL_MASK, pt.red[1], 1);
        const float rn = buf[tt * N + nr], kn = buf[TN + tt * N + nr];
        if (odd) {
          dw[at + nr] = pt.red[0];
          du_acc = fmaf(rn * kn, pt.red[1], du_acc);
        } else {
          dr[at + nr] = fmaf(un * kn, other, pt.red[0]);
          dk[at + nr] = fmaf(un * rn, other, pt.red[1]);
        }
        // dv across the warp's row groups (lane bits 16 .. CG)
        lane_halve<R, 16, K::LH>(pt.adv);
        lane_butterfly<R, (16 >> K::LH), K::LV - K::LH>(pt.adv);
        int qb = 0;
#pragma unroll
        for (int l = 0; l < K::LH; ++l) qb += (lane & (16 >> l)) ? (K::R >> (l + 1)) : 0;
        if ((lane & ((16 >> K::LH) * 2 - 1) & ~(CG - 1)) == 0)
          st_vec<K::DVN>(dvp + ((tt - t0) * W + wid) * N + j0 + qb, pt.adv);
      };
      walk_back<THREADS>(slots + q * K::SUB, t0, nq, X, Y, pa, pb,
                         [&](float (&x)[E], int tt) { step(x, buf, tt); }, grad, emit);
      __syncthreads();  // the sub-chunk's dv partials are written
      // dv_t[j] = (sum of the warps' partials in order) + c_t do_t[j]
#pragma unroll
      for (int c = 0; c < (Q * N / 4 + THREADS - 1) / THREADS; ++c) {
        const int idx = tid + c * THREADS;
        if (idx < nq * (N / 4)) {
          const int tq = idx / (N / 4), j = (idx % (N / 4)) * 4;
          float4 s = *reinterpret_cast<const float4*>(dvp + tq * W * N + j);
#pragma unroll
          for (int x = 1; x < W; ++x) {
            const float4 a = *reinterpret_cast<const float4*>(dvp + (tq * W + x) * N + j);
            s.x += a.x, s.y += a.y, s.z += a.z, s.w += a.w;
          }
          const float ct = cs[t0 + tq];
          const float4 d = *reinterpret_cast<const float4*>(buf + 4 * TN + (t0 + tq) * N + j);
          *reinterpret_cast<float4*>(dv + ((tok0 + (size_t)p * T + t0 + tq) * H + h) * N + j) =
              make_float4(fmaf(ct, d.x, s.x), fmaf(ct, d.y, s.y), fmaf(ct, d.z, s.z),
                          fmaf(ct, d.w, s.w));
        }
      }
    }
  }
  store_tile(ds0 + sbase, G);
  if (odd) du_part[(size_t)bh * N + nr] = du_acc;
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
cudaError_t wkv_bwd_smem() {  // once per instantiation and device
  static unsigned long long done = 0;
  return set_smem_once(wkv_bwd_kernel<N>, WkvBwdShape<N>::BYTES, done);
}

template <int N>
cudaError_t launch_wkv_bwd(const float* r, const float* k, const float* v, const float* w,
                           const float* u, const float* s0, const float* dout,
                           const float* dstate, float* ckpt, float* du_part, float* dr,
                           float* dk, float* dv, float* dw, float* du, float* ds0, int B,
                           int S, int H, cudaStream_t stream) {
  using K = WkvBwdShape<N>;
  cudaError_t err = wkv_bwd_smem<N>();
  if (err != cudaSuccess) return err;
  wkv_bwd_kernel<N><<<B * H, K::THREADS, K::BYTES, stream>>>(
      r, k, v, w, u, s0, dout, dstate, ckpt, dr, dk, dv, dw, du_part, ds0, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int HN = H * N;
  wkv_du_kernel<<<(HN + 255) / 256, 256, 0, stream>>>(du_part, du, B, HN);
  return cudaGetLastError();
}

template <int N>
cudaError_t config_wkv_bwd(int* cfg) {
  using K = WkvBwdShape<N>;
  cfg[0] = K::M, cfg[1] = K::CG, cfg[2] = K::T, cfg[3] = K::Q, cfg[4] = K::THREADS;
  cfg[5] = static_cast<int>(K::BYTES);
  const cudaError_t err = wkv_bwd_smem<N>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cfg[6], wkv_bwd_kernel<N>,
                                                       K::THREADS, K::BYTES);
}

}  // namespace

// r, k, v, w, do, dr, dk, dv, dw (B, S, H, N); u, du (H, N); s0, dstate,
// ds0 (B, H, N, N); dstate may be null (zero); ckpt the checkpoints'
// scratch, ckpt_len >= B*H*max(ceil(S/WKVB_T) - 2, 0)*N*N floats (may be
// null when that is 0); du_part (B, H, N). fp32, contiguous; r, k, v, w,
// do, s0, dstate and ds0 16-byte aligned. Two launches: the scan, then du.
REPRO_API int wkv_bwd_f32(const float* r, const float* k, const float* v, const float* w,
                          const float* u, const float* s0, const float* dout,
                          const float* dstate, float* ckpt, long long ckpt_len,
                          float* du_part, float* dr, float* dk, float* dv, float* dw,
                          float* du, float* ds0, int B, int S, int H, int N,
                          cudaStream_t stream) {
  const long long npass = (S + WKVB_T - 1) / WKVB_T;
  if (ckpt_len < (long long)B * H * (npass > 2 ? npass - 2 : 0) * N * N)
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

// The launch configuration of wkv_bwd_f32 at head size N: cfg = {state rows
// a thread, lanes that share a row, tokens a pass (between global
// checkpoints), tokens a sub-chunk (between shared ones), threads a block,
// shared bytes a block, blocks an SM (the occupancy calculator, registers
// included)}.
REPRO_API int wkv_bwd_config(int N, int* cfg) {
  switch (N) {
    case 16:
      return config_wkv_bwd<16>(cfg);
    case 32:
      return config_wkv_bwd<32>(cfg);
    case 64:
      return config_wkv_bwd<64>(cfg);
    default:
      return cudaErrorInvalidValue;
  }
}
