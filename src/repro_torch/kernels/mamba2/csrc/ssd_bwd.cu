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
// (plain version: ref.ssd_backward_ref; this kernel's order of sums:
// ref.ssd_backward_split_ref). With h_t = a_t h_{t-1} + dt_t x_t B_t^T the
// kernel takes dC from the state before the token, as every other sum:
//   sum_p h_t[p, n] dy_t[p] = a_t sum_p h_{t-1}[p, n] dy_t[p]
//                             + B_t[n] dt_t (x_t . dy_t).
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
// The first version (one block of P threads a (b, head), a thread a state
// row, checkpoints every 4 tokens) ran at 4% of that bound (0.537 ms):
//   - its checkpoint scratch, B*nh*S/4 states (117.4 MB), went through
//     device memory, 3.1 times the bound's time;
//   - 2 warps a block and about 101 KB of shared memory, 4 warps an SM;
//   - two __syncthreads a token, 64-deep serial sums of dB and dC, and ddt
//     and dla each summed by one thread;
//   - each 4-token chunk staged with plain loads between two syncs.
// This design (the reverse walk of scan_tile.cuh; times in PERF.md):
//   - a thread holds an 8 x 4 tile of the carried a H and of the state
//     (rows p, columns n; P = N = 64), 128 threads a block, two blocks an
//     SM (8 warps an SM: 16, with 4 x 4 tiles, ran 9% slower), 3.4 blocks
//     an SM in all at the main shape;
//   - the global checkpoints are the state before every SSDB_T = 16-token
//     pass but the first (h0) and the last (kept in registers):
//     B*nh*(ceil(S/16) - 2) states, 14.7 MB at the main shape, written and
//     read back by the block that owns them while they sit in the L2;
//   - a pass's sub-checkpoints, one every SSDB_Q = 4 tokens, go to shared
//     memory (each thread its own tile, no sync), and each sub-chunk is
//     walked back from its sub-checkpoint in two register tiles
//     (walk_back): 2.75 state steps a token in all;
//   - a warp holds all 64 rows of 16 columns: a thread adds its 8 rows of
//     dB's and dC's sums over p, the warp's 8 row groups halve them
//     (lane_halve), one to a lane, and the lanes store them, a head's
//     partials; hb = H_t B_t (dx's sum over n) is halved across the warp's
//     four column groups, ddt's and dla's sums across all its lanes, and
//     the 4 warps' partials of those are combined once a sub-chunk in warp
//     order; dt_t (x_t . dy_t), for dC, is one sum a token that the warps
//     take for the pass before its walk;
//   - the pass's x, dy, B, C, dt and la are staged with cp.async, the pass
//     before in flight in a second buffer; thread t turns la_t into
//     e^{la_t} in place, once a block;
//   - dB and dC also sum over the heads, which share B_t and C_t: each
//     block stores its head's sums to a partial of its own, and a second
//     launch adds the partials in ascending head. Nothing sums with float
//     atomics, so two launches on the same inputs agree bit for bit.
// What bounds it now is instruction issue, at about half the rate the card
// allows: 6 fp32 operations a state element a token for the gradients and
// 2 for each of the 2.75 state steps (two thirds of the walk's
// instructions), the lanes' halving around them; and 448 blocks on 132 SMs
// at 2 an SM (some SMs run 4, most 3).
#include "scan_tile.cuh"

namespace {

constexpr int SSDB_T = 16;  // tokens a pass: between the global checkpoints
constexpr int SSDB_Q = 4;   // tokens a sub-chunk: between the shared ones

template <int P, int N>
struct SsdBwdShape {
  static constexpr int T = SSDB_T, Q = SSDB_Q, NQ = T / Q;
  static constexpr int M = P / 8;    // state rows p a thread: 8 row groups
  static constexpr int E = 4 * M;    // a tile: M rows x 4 columns n
  static constexpr int CG = N / 4;   // column groups, four a warp
  static constexpr int W = CG / 4;   // warps
  static constexpr int THREADS = 32 * W;
  static constexpr int LB = log2i(M) < 2 ? log2i(M) : 2;  // hb: levels that halve the rows
  static constexpr int HBN = M >> LB;                     // hb values a lane ends with
  static constexpr int TW = T / W;  // a pass's tokens a warp sums x . dy of
  // x, dy (T x P), B, C (T x N), dt, la (then e^{la}) of a pass
  static constexpr int XO = 0, DYO = T * P, BO = 2 * T * P, CO = 2 * T * P + T * N,
                       DTO = 2 * T * (P + N), AO = DTO + T;
  static constexpr int BUF = AO + T;
  static constexpr int SUB = P * N;      // a sub-checkpoint
  static constexpr int HB = Q * W * P;   // a sub-chunk's hb partials [tq][warp][p]
  static constexpr int DD = Q * W * 2;   // and ddt's, dla's [tq][warp][2]
  static constexpr size_t BYTES = sizeof(float) * (2 * BUF + NQ * SUB + HB + DD + T);
  static_assert(P % 16 == 0 && N % 16 == 0, "the lanes' layout");
  static_assert(HB + DD <= SUB, "partials fit a spent sub-checkpoint");
  static_assert(T <= THREADS && T % Q == 0 && Q == 4, "a thread a token's decay");
};

template <int P, int N>
__global__ void __launch_bounds__(SsdBwdShape<P, N>::THREADS, 2)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ la, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ h0,
               const float* __restrict__ dy, const float* __restrict__ dh,
               float* __restrict__ ckpt, float* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ dla, float* __restrict__ dB_part,
               float* __restrict__ dC_part, float* __restrict__ dh0, int S, int nh) {
  using K = SsdBwdShape<P, N>;
  constexpr int T = K::T, Q = K::Q, M = K::M, E = K::E, W = K::W, THREADS = K::THREADS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* slots = smem + 2 * K::BUF;  // the pass's sub-checkpoints
  float* pbuf = slots + K::NQ * K::SUB;  // a sub-chunk's hb, ddt and dla partials
  float* xdys = pbuf + K::HB + K::DD;    // dt_t (x_t . dy_t) of the pass's tokens
  const int bhd = blockIdx.x, b = bhd / nh, hd = bhd % nh;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int rg = lane >> 2, cg = 4 * wid + (lane & 3);
  const int p0 = rg * M, c0 = 4 * cg;
  // after the halving across the row groups: this lane's column and sum
  // (dB if < 4, else dC), from lane bits 16, 8, 4
  const int slot = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
  const int nc = c0 + (slot & 3);
  const int npass = (S + T - 1) / T;
  const size_t tok0 = (size_t)b * S;
  const size_t hbase = (size_t)bhd * P * N + (size_t)p0 * N + c0;  // the tile
  float* my_ckpt = ckpt + (size_t)bhd * max(npass - 2, 0) * P * N;

  // pass p's inputs into buffer p & 1: x, B, dt and la to step the state;
  // dy and C too for the reverse walk
  auto stage = [&](int p, bool all) {
    if (p < 0 || p >= npass) return;
    float* buf = smem + (p & 1) * K::BUF;
    const int nt = min(T, S - p * T);
    const size_t row = tok0 + (size_t)p * T;  // token row of (b, p * T)
    stage_rows<THREADS, T, P>(buf + K::XO, x + (row * nh + hd) * P, nt, (size_t)nh * P);
    stage_rows<THREADS, T, N>(buf + K::BO, Bm + row * N, nt, N);
    stage_scalars<THREADS, T>(buf + K::DTO, dt + row * nh + hd, nt, nh);
    stage_scalars<THREADS, T>(buf + K::AO, la + row * nh + hd, nt, nh);
    if (all) {
      stage_rows<THREADS, T, P>(buf + K::DYO, dy + (row * nh + hd) * P, nt, (size_t)nh * P);
      stage_rows<THREADS, T, N>(buf + K::CO, Cm + row * N, nt, N);
    }
  };
  // thread t staged la_t (stage_scalars): it turns it into e^{la_t} in
  // place once its copies have landed, before the __syncthreads
  auto decays = [&](int p) {
    float* as = smem + (p & 1) * K::BUF + K::AO;
    if (tid < min(T, S - p * T)) as[tid] = expf(as[tid]);
  };
  // the tile's M rows of 4 columns, 16 bytes each: a warp's 4 column groups
  // cover 64 contiguous bytes of a row
  auto load_tile = [&](float (&h)[E], const float* src) {
#pragma unroll
    for (int i = 0; i < M; ++i) ld_vec<4>(h + 4 * i, src + (size_t)i * N);
  };
  auto store_tile = [&](float* dst, const float (&h)[E]) {
#pragma unroll
    for (int i = 0; i < M; ++i) st_vec<4>(dst + (size_t)i * N, h + 4 * i);
  };
  // h <- a_t h + (dt_t x_t) B_t^T on the tile, token tt of the pass in buf
  auto step = [&](float (&h)[E], const float* buf, int tt) {
    float xx[M], bb[4];
    ld_vec<M>(xx, buf + K::XO + tt * P + p0);
    ld_vec<4>(bb, buf + K::BO + tt * N + c0);
    const float d = buf[K::DTO + tt], a = buf[K::AO + tt];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float xdt = xx[i] * d;
#pragma unroll
      for (int q = 0; q < 4; ++q) h[4 * i + q] = fmaf(a, h[4 * i + q], xdt * bb[q]);
    }
  };

  float X[E], Y[E], Hc[E];  // Hc: the carried a_{t+1} H_{t+1}
  struct Part {
    float red[8], hb[M], dd[2];
  } pa, pb;  // two tokens' partials in flight (walk_back)
  load_tile(X, h0 + hbase);
  stage(0, npass == 1);
  cp_async_commit();
  stage(1, npass == 2);
  cp_async_commit();

  // the forward walk: the state before each pass but the first and the last
  for (int p = 0; p + 1 < npass; ++p) {
    cp_async_wait<1>();  // this pass's group has landed
    decays(p);
    __syncthreads();
    if (p >= 1) store_tile(my_ckpt + (size_t)(p - 1) * P * N + (size_t)p0 * N + c0, X);
    const float* buf = smem + (p & 1) * K::BUF;
#pragma unroll 4
    for (int tt = 0; tt < T; ++tt) step(X, buf, tt);
    __syncthreads();  // this buffer is consumed
    stage(p + 2, p + 2 == npass - 1);
    cp_async_commit();
  }

  // the reverse walk
  if (dh) {
    load_tile(Hc, dh + hbase);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) Hc[e] = 0.f;
  }
  for (int p = npass - 1; p >= 0; --p) {
    const int nt = min(T, S - p * T), nsub = (nt + Q - 1) / Q;
    cp_async_wait<0>();
    decays(p);
    __syncthreads();  // the pass's inputs, for every thread; the last combine is done
    stage(p - 1, true);
    cp_async_commit();
    const float* buf = smem + (p & 1) * K::BUF;
    // dt_t (x_t . dy_t) for the pass's tokens: warp wid takes tokens wid,
    // wid + W, ... (lane l adds p = l, l + 32, ...; then the warp's xor tree)
    {
      float sx[K::TW];  // all of the warp's tokens through one xor tree
#pragma unroll
      for (int x = 0; x < K::TW; ++x) {
        const int tt = wid + x * W;
        sx[x] = 0.f;
        if (tt < nt)
#pragma unroll
          for (int y = 0; y < (P + 31) / 32; ++y)
            if (lane + 32 * y < P)
              sx[x] = fmaf(buf[K::XO + tt * P + lane + 32 * y],
                           buf[K::DYO + tt * P + lane + 32 * y], sx[x]);
      }
      lane_butterfly<K::TW, 16, 5>(sx);
#pragma unroll
      for (int x = 0; x < K::TW; ++x)
        if (lane == 0 && wid + x * W < nt) xdys[wid + x * W] = buf[K::DTO + wid + x * W] * sx[x];
    }
    // the sub-checkpoints, from the state before the pass
    if (p < npass - 1) load_tile(X, p == 0 ? h0 + hbase : my_ckpt + (size_t)(p - 1) * P * N +
                                                             (size_t)p0 * N + c0);
    for (int q = 0; q < nsub; ++q) {
      tile_to_smem<THREADS>(slots + q * K::SUB, X);
      if (q + 1 < nsub)
#pragma unroll
        for (int s = 0; s < Q; ++s) step(X, buf, q * Q + s);
    }
    __syncthreads();  // the pass's dt (x . dy)
    for (int q = nsub - 1; q >= 0; --q) {
      const int t0 = q * Q, nq = min(Q, nt - t0);
      // the sub-chunk's partials: the spare buffer, or the first
      // sub-chunk's sub-checkpoint once it is spent (after its sync)
      float* hbp = ((nsub - 1 - q) & 1) ? slots + (nsub - 1) * K::SUB : pbuf;
      float* ddp = hbp + K::HB;
      // a token's own partials: hb over the thread's 4 columns, dB's and
      // dC's over its M rows, ddt's and dla's; the carried a H steps back
      auto grad = [&](int tt, const float (&hp)[E], Part& pt) {
        float xx[M], dyy[M], bb[4], cc[4];
        ld_vec<M>(xx, buf + K::XO + tt * P + p0);
        ld_vec<M>(dyy, buf + K::DYO + tt * P + p0);
        ld_vec<4>(bb, buf + K::BO + tt * N + c0);
        ld_vec<4>(cc, buf + K::CO + tt * N + c0);
        const float d = buf[K::DTO + tt], a = buf[K::AO + tt];
        pt.dd[0] = pt.dd[1] = 0.f;
#pragma unroll
        for (int q4 = 0; q4 < 8; ++q4) pt.red[q4] = 0.f;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const float xdt = xx[i] * d;
          pt.hb[i] = 0.f;
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) {
            const float hprev = hp[4 * i + q4];
            const float Ht = fmaf(dyy[i], cc[q4], Hc[4 * i + q4]);
            pt.hb[i] = fmaf(Ht, bb[q4], pt.hb[i]);
            pt.dd[1] = fmaf(Ht, hprev, pt.dd[1]);
            pt.red[q4] = fmaf(Ht, xdt, pt.red[q4]);
            pt.red[4 + q4] = fmaf(hprev, dyy[i], pt.red[4 + q4]);
            Hc[4 * i + q4] = a * Ht;
          }
        }
#pragma unroll
        for (int i = 0; i < M; ++i) pt.dd[0] = fmaf(xx[i], pt.hb[i], pt.dd[0]);
      };
      // the token's sums across lanes, stored or left for the combine
      auto emit = [&](int tt, Part& pt) {
        const size_t t = tok0 + (size_t)p * T + tt;
        // dB, dC across the 8 row groups (lane bits 16, 8, 4)
        lane_halve<8, 16, 3>(pt.red);
        {
          const size_t o = (t * nh + hd) * N + nc;
          if (slot < 4)
            dB_part[o] = pt.red[0];
          else
            dC_part[o] = fmaf(buf[K::AO + tt], pt.red[0], buf[K::BO + tt * N + nc] * xdys[tt]);
        }
        // hb across the warp's four column groups (lane bits 2, 1)
        lane_halve<M, 2, K::LB>(pt.hb);
        lane_butterfly<K::HBN, (2 >> K::LB), 2 - K::LB>(pt.hb);
        int ib = 0;
#pragma unroll
        for (int l = 0; l < K::LB; ++l) ib += (lane & (2 >> l)) ? (M >> (l + 1)) : 0;
        if ((lane & (3 >> K::LB)) == 0)
          st_vec<K::HBN>(hbp + ((tt - t0) * W + wid) * P + p0 + ib, pt.hb);
        // ddt's and dla's sums across the warp: lane bit 16 keeps dla's
        lane_halve<2, 16, 1>(pt.dd);
        lane_butterfly<1, 8, 4>(pt.dd);
        if (!(lane & 15)) ddp[((tt - t0) * W + wid) * 2 + (lane >> 4)] = pt.dd[0];
      };
      walk_back<THREADS>(slots + q * K::SUB, t0, nq, X, Y, pa, pb,
                         [&](float (&h)[E], int tt) { step(h, buf, tt); }, grad, emit);
      __syncthreads();  // the sub-chunk's partials are written
      // dx_t[p] = dt_t (sum of the warps' hb partials in order); ddt_t and
      // dla_t / a_t the sums of the warps' partials
#pragma unroll
      for (int c = 0; c < (Q * P / 4 + THREADS - 1) / THREADS; ++c) {
        const int idx = tid + c * THREADS;
        if (idx < nq * (P / 4)) {
          const int tq = idx / (P / 4), j = (idx % (P / 4)) * 4;
          float4 s = *reinterpret_cast<const float4*>(hbp + tq * W * P + j);
#pragma unroll
          for (int wq = 1; wq < W; ++wq) {
            const float4 g = *reinterpret_cast<const float4*>(hbp + (tq * W + wq) * P + j);
            s.x += g.x, s.y += g.y, s.z += g.z, s.w += g.w;
          }
          const float d = buf[K::DTO + t0 + tq];
          *reinterpret_cast<float4*>(dx + ((tok0 + (size_t)p * T + t0 + tq) * nh + hd) * P +
                                     j) = make_float4(d * s.x, d * s.y, d * s.z, d * s.w);
        }
      }
      if (tid < 2 * nq) {
        const int tq = tid >> 1, kind = tid & 1;
        float s = ddp[tq * W * 2 + kind];
        for (int wq = 1; wq < W; ++wq) s += ddp[(tq * W + wq) * 2 + kind];
        const size_t o = (tok0 + (size_t)p * T + t0 + tq) * nh + hd;
        if (kind == 0)
          ddt[o] = s;
        else
          dla[o] = buf[K::AO + t0 + tq] * s;
      }
    }
  }
  store_tile(dh0 + hbase, Hc);
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
cudaError_t ssd_bwd_smem() {  // once per instantiation and device
  static unsigned long long done = 0;
  return set_smem_once(ssd_bwd_kernel<P, N>, SsdBwdShape<P, N>::BYTES, done);
}

template <int P, int N>
cudaError_t launch_ssd_bwd(const float* x, const float* dt, const float* la,
                           const float* Bm, const float* Cm, const float* h0,
                           const float* dy, const float* dh, float* ckpt, float* dB_part,
                           float* dC_part, float* dx, float* ddt, float* dla, float* dB,
                           float* dC, float* dh0, int B, int S, int nh,
                           cudaStream_t stream) {
  using K = SsdBwdShape<P, N>;
  cudaError_t err = ssd_bwd_smem<P, N>();
  if (err != cudaSuccess) return err;
  ssd_bwd_kernel<P, N><<<B * nh, K::THREADS, K::BYTES, stream>>>(
      x, dt, la, Bm, Cm, h0, dy, dh, ckpt, dx, ddt, dla, dB_part, dC_part, dh0, S, nh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long BS = (long long)B * S;
  ssd_dbc_kernel<<<(unsigned)((BS * N + 255) / 256), 256, 0, stream>>>(dB_part, dC_part, dB,
                                                                       dC, BS, nh, N);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t config_ssd_bwd(int* cfg) {
  using K = SsdBwdShape<P, N>;
  cfg[0] = K::M, cfg[1] = K::W, cfg[2] = K::T, cfg[3] = K::Q, cfg[4] = K::THREADS;
  cfg[5] = static_cast<int>(K::BYTES);
  const cudaError_t err = ssd_bwd_smem<P, N>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cfg[6], ssd_bwd_kernel<P, N>,
                                                       K::THREADS, K::BYTES);
}

}  // namespace

// x, dy, dx (B, S, nh, P); dt, la, ddt, dla (B, S, nh); Bm, Cm, dB, dC
// (B, S, N); h0, dh, dh0 (B, nh, P, N); dh may be null (zero); ckpt the
// checkpoints' scratch, ckpt_len >= B*nh*max(ceil(S/SSDB_T) - 2, 0)*P*N
// floats (may be null when that is 0); dB_part, dC_part (B, S, nh, N).
// fp32, contiguous; x, dy, Bm, Cm, h0, dh and dh0 16-byte aligned. Two
// launches: the scan, then the heads' sums of dB and dC.
REPRO_API int ssd_bwd_f32(const float* x, const float* dt, const float* la, const float* Bm,
                          const float* Cm, const float* h0, const float* dy, const float* dh,
                          float* ckpt, long long ckpt_len, float* dB_part, float* dC_part,
                          float* dx, float* ddt, float* dla, float* dB, float* dC, float* dh0,
                          int B, int S, int nh, int P, int N, cudaStream_t stream) {
  const long long npass = (S + SSDB_T - 1) / SSDB_T;
  if (ckpt_len < (long long)B * nh * (npass > 2 ? npass - 2 : 0) * P * N)
    return cudaErrorInvalidValue;
  if (P == 16 && N == 16)
    return launch_ssd_bwd<16, 16>(x, dt, la, Bm, Cm, h0, dy, dh, ckpt, dB_part, dC_part, dx,
                                  ddt, dla, dB, dC, dh0, B, S, nh, stream);
  if (P == 64 && N == 64)
    return launch_ssd_bwd<64, 64>(x, dt, la, Bm, Cm, h0, dy, dh, ckpt, dB_part, dC_part, dx,
                                  ddt, dla, dB, dC, dh0, B, S, nh, stream);
  return cudaErrorInvalidValue;
}

// The launch configuration of ssd_bwd_f32 at (P, N): cfg = {state rows a
// thread, warps a block (four column groups each), tokens a pass (between
// global checkpoints), tokens a sub-chunk (between shared ones), threads a
// block, shared bytes a block, blocks an SM (the occupancy calculator,
// registers included)}.
REPRO_API int ssd_bwd_config(int P, int N, int* cfg) {
  if (P == 16 && N == 16) return config_ssd_bwd<16, 16>(cfg);
  if (P == 64 && N == 64) return config_ssd_bwd<64, 64>(cfg);
  return cudaErrorInvalidValue;
}
