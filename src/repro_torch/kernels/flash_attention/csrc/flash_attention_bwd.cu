// GQA flash attention, backward, fp32 or bf16, sm_90a.
//
// Replaces the backward of the training path's flash attention: _bwd_vjp of
// the custom VJP flash_attention_xla (src/repro/kernels/flash_attention/
// blocked.py:100-140), which JAX's auto dispatch runs off the TPU at S >=
// 2048 (ops.py:23-27) under build_model(use_flash=True) (repro/models/
// attention.py:102-104). The Pallas forward (flash_attention.py:66) has no
// backward of its own; its row-1 kernel's LSE instantiation
// (flash_attention.cu) is this kernel's forward.
//
// What it computes, from the saved q (B, Sq, Hq, D), k, v (B, Sk, Hkv, D),
// the rounded out, the fp32 lse (B, Hq, Sq) and dout: in fp32,
//   delta = sum_d dout * out          (from the rounded out, as _bwd_vjp)
//   p     = exp(s - lse), s = q k^T * scale, 0 above the causal diagonal
//   ds    = p * (dp - delta) * scale, dp = dout v^T
//   dq = ds k,  dk = sum over the group's G query heads of ds^T q,
//   dv = the same sum of p^T dout,
// each rounded once to its input's dtype at the store. Query head h reads
// KV head h / G, as blocked.repeat_kv repeats it.
//
// Design: FA2's split into passes, no atomics (two launches give the same
// gradients bit for bit: every sum runs in a fixed order inside one block,
// and the group's heads are folded in a fixed order).
//   delta   one warp a (b, query row, head): lanes over D, a shuffle sum.
//   dk/dv   one block a (key tile, query head h, b): the block walks the
//           query tiles of head h from the first that reaches its keys
//           (causal) to the end, accumulating its head's dk and dv in
//           registers. With G > 1 query heads a KV head each block writes
//           its partial in fp32 to a scratch (2, G, B, Sk, Hkv, D) that the
//           wrapper allocates, and
//   combine sums the G partials of each element in ascending head order
//           and rounds once to the output's dtype (G = 1: the dk/dv pass
//           rounds and stores, no scratch and no combine). So the pass has
//           Hq x B x Sk / tile blocks, not Hkv x B x Sk / tile: 1024 at
//           qwen2.5-3b's silo, 512 at B 1, S 1000 (64 before, where the
//           plain version won).
//   dq      one block a (query tile, head, b), heavy tiles first (causal:
//           the last query tiles see the most keys); it walks the key tiles
//           up to the diagonal, accumulating dq in registers.
// Tiles wholly above the diagonal are skipped; a padded row or column (a
// ragged tile) gets p = ds = 0 explicitly, so no stale lse is read past a
// tile's end; the staged rows there are zero. Device launches a call:
// delta, dk/dv, combine (G > 1), dq, counted as one.
//
// fp32 (flash_attention_bwd_f32) on the CUDA cores (BwdTile): each step
// stages its tiles (16-byte cp.async), computes the BQ x BK scores and
// dout v^T together (16 x 16 threads, 4 x 2 cells each, 16-byte shared
// loads), writes p and ds to shared memory, then the products over the
// tile (the P.V layout of attn_tile.cuh: a row's D outputs are D/4 lanes x
// 4 dims).
//   Bound on this card: five S x S x D products (the minimum: dp, and the
//   products for dq, dk, dv; s recomputed is p's), 2 flops a product term,
//   over the visible pairs: 5 * 2 * D * pairs * Hq * B. At qwen2.5-3b's
//   training shape (B 1, S 4096, Hq 16, Hkv 2, D 128, causal) 1.72e11:
//   2.6 ms at the 67 TFLOP/s fp32 rate, against 0.3 GB of bytes (under
//   0.1 ms): bound by operations. This design does seven such products (s
//   and dp again in the dq pass).
//
// bf16 (flash_attention_bwd_bf16) on the tensor cores (csrc/mma_tile.cuh:
// mma.sync m16n8k16, bf16 in and fp32 accumulate; the same 1.72e11 flops
// are 0.17 ms at bf16's 989 TFLOP/s). Blocks of 4 warps; q, k, v and dout
// stay bf16 in shared memory (row stride D + 8), double-buffered by
// cp.async with ragged rows zero-filled, and enter the products once,
// exactly; p and ds are fp32 and enter as the two-term split (hi =
// bf16(x), lo = bf16(x - hi): 2^-16 of x), two mma into one accumulator.
//   dk/dv   64 keys a block, 16 a warp; query tiles of 32. A warp computes
//           S^T = K Q^T and dP^T = V dO^T (keys x queries: 16 x 32 a warp)
//           on the tensor cores, then p^T = exp(s scale - lse) and ds^T =
//           p^T (dp^T - delta) scale in fp32 on the accumulators, and feeds
//           them, split, straight from the accumulator fragments as the A
//           operand (FA2's layout trick: no shared round trip) of dV += P^T
//           dO and dK += dS^T Q, dO and Q by ldmatrix.trans.
//   dq      64 query rows a block, 16 a warp; key tiles of 64. S = Q K^T
//           and dP = dO V^T, then ds, split, into dQ += dS K (K by
//           ldmatrix.trans).
// Ten S x S x D units of work against the function's five (s and dp
// again in the dq pass; the split doubles the four gradient products): a
// floor of 0.35 ms at the silo shape. Latency bounds it, as the forward:
// registers hold each warp's accumulators and cap the SM at two blocks (8
// warps). The dk/dv pass holds dk and dv (D floats a thread) and 16 x 32
// tiles of s and dp, 255 registers with 48 bytes of stack at D 128; the dq
// pass dq (D/2 floats) and 16 x 64 tiles, 254 registers (key tiles of 32
// at three blocks an SM, 168 registers, were 1.07x slower). Shared memory
// at D 128: 69 KB (dk/dv) and 102 KB (dq). The exponentials are base-2 SFU
// ones, the scale folded into one FMA (mma_tile.cuh's exp2_approx), and
// the mask is tested only in tiles that cross the diagonal or an end.
// At the silo shape on an H100 80GB HBM3 (700 W; tools/time_flash_pair.py)
// dk/dv takes 0.87 ms and dq 0.59, about 230 TFLOP/s of products each.
#include "attn_tile.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int BWD_THREADS = 256;
constexpr int BQ = 64;  // query rows a tile
constexpr int BK = 32;  // keys a tile

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// Stage n <= nmax rows of D fp32 values into dst (row stride ds); row t
// starts at g + off(t). Rows n..nmax-1 are zero-filled.
template <int D, class Off>
__device__ void stage_rows(float* dst, int ds, const float* g, int n, int nmax, Off off) {
  constexpr int VEC = Elem<float>::VEC, LPV = D / VEC;
  static_assert(D % VEC == 0, "a row is whole 16-byte copies");
  for (int idx = threadIdx.x; idx < nmax * LPV; idx += BWD_THREADS) {
    const int t = idx / LPV, d = VEC * (idx % LPV);
    if (t < n)
      stage_vec(dst + t * ds + d, g + off(t) + d);
    else
      zero_vec<VEC>(dst + t * ds + d);
  }
}

template <int D>
struct BwdTile {
  static_assert(D % 4 == 0 && D <= 128, "D/4 lanes a row");
  static constexpr int KS = D + 4;   // q, dout, k, v row stride (floats)
  static constexpr int PS = BK + 4;  // p and ds row stride
  // the score layout: 16 x 16 threads, RM x CM cells each
  static constexpr int TR = 16, TC = BWD_THREADS / TR;
  static constexpr int RM = BQ / TR, CM = BK / TC;
  // the product layout: a row's D outputs are D/4 lanes x 4 dims
  static constexpr int LPR = D / 4;
  static constexpr int RPW = 32 / LPR;                 // rows (slots) a warp
  static constexpr int NS = (BWD_THREADS / 32) * RPW;  // slots
  static constexpr int RA = (BQ + NS - 1) / NS;        // dq rows a lane
  static constexpr int KA = (BK + NS - 1) / NS;        // dk/dv keys a lane
  // shared: q, dout (BQ x KS), k, v (BK x KS), p, ds (BQ x PS), lse, delta
  static constexpr int FLOATS = 2 * BQ * KS + 2 * BK * KS + 2 * BQ * PS + 2 * BQ;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;

  float *q_s, *do_s, *k_s, *v_s, *p_s, *ds_s, *lse_s, *dl_s;

  __device__ explicit BwdTile(float* smem) {
    q_s = smem;
    do_s = q_s + BQ * KS;
    k_s = do_s + BQ * KS;
    v_s = k_s + BK * KS;
    p_s = v_s + BK * KS;
    ds_s = p_s + BQ * PS;
    lse_s = ds_s + BQ * PS;
    dl_s = lse_s + BQ;
  }

  // q and dout rows q0 .. q0 + rows - 1 of head h, with their lse and delta
  // (0 past rows, never read: visible() masks those rows).
  __device__ void stage_q(const float* q, const float* dout, const float* lse,
                          const float* delta, int b, int h, int q0, int rows, int Sq, int Hq) {
    auto off = [&](int r) { return (((long long)b * Sq + q0 + r) * Hq + h) * D; };
    stage_rows<D>(q_s, KS, q, rows, BQ, off);
    stage_rows<D>(do_s, KS, dout, rows, BQ, off);
    const long long base = ((long long)b * Hq + h) * Sq + q0;
    for (int r = threadIdx.x; r < BQ; r += BWD_THREADS) {
      lse_s[r] = r < rows ? lse[base + r] : 0.f;
      dl_s[r] = r < rows ? delta[base + r] : 0.f;
    }
  }

  // k and v rows k0 .. k0 + cols - 1 of KV head hk.
  __device__ void stage_k(const float* k, const float* v, int b, int hk, int k0, int cols,
                          int Sk, int Hkv) {
    auto off = [&](int c) { return (((long long)b * Sk + k0 + c) * Hkv + hk) * D; };
    stage_rows<D>(k_s, KS, k, cols, BK, off);
    stage_rows<D>(v_s, KS, v, cols, BK, off);
  }

  // p (when P) and ds of the staged tiles into shared memory; visible(r, c)
  // says whether cell (r, c) is a real, unmasked pair. Call with the tiles
  // staged and visible to every thread; read p_s / ds_s after a barrier.
  template <bool P, class Visible>
  __device__ void scores(float scale, Visible visible) {
    const int t = threadIdx.x, tr = t / TC, tc = t % TC;
    float s[RM][CM], dp[RM][CM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CM; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[RM], ov[RM], kv[CM], vv[CM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(q_s + (tr + TR * i) * KS + d);
        ov[i] = *reinterpret_cast<const float4*>(do_s + (tr + TR * i) * KS + d);
      }
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tc + TC * j) * KS + d);
        vv[j] = *reinterpret_cast<const float4*>(v_s + (tc + TC * j) * KS + d);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CM; ++j) {
          float a = s[i][j], e = dp[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          s[i][j] = fmaf(qv[i].w, kv[j].w, a);
          e = fmaf(ov[i].x, vv[j].x, e);
          e = fmaf(ov[i].y, vv[j].y, e);
          e = fmaf(ov[i].z, vv[j].z, e);
          dp[i][j] = fmaf(ov[i].w, vv[j].w, e);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = tr + TR * i;
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        const int c = tc + TC * j;
        const float p = visible(r, c) ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        if (P) p_s[r * PS + c] = p;
        ds_s[r * PS + c] = p * (dp[i][j] - dl_s[r]) * scale;
      }
    }
  }

  // KA consecutive floats of row r of a (BQ x PS) tile from column c0.
  __device__ static void load_ka(const float* src, float (&x)[KA]) {
    if constexpr (KA == 4) {
      const float4 f = *reinterpret_cast<const float4*>(src);
      x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
    } else if constexpr (KA == 2) {
      const float2 f = *reinterpret_cast<const float2*>(src);
      x[0] = f.x, x[1] = f.y;
    } else {
#pragma unroll
      for (int a = 0; a < KA; ++a) x[a] = src[a];
    }
  }

  // dv[a] += sum_r p[r][key a] dout[r], dk[a] += sum_r ds[r][key a] q[r],
  // over r = 0 .. BQ - 1 in order, for this lane's KA keys and 4 dims.
  __device__ void accumulate_dkdv(float4 (&dk)[KA], float4 (&dv)[KA]) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane >= RPW * LPR) return;
    const int slot = warp * RPW + lane / LPR, d = 4 * (lane % LPR), c0 = slot * KA;
    if (c0 >= BK) return;
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      const float4 o = *reinterpret_cast<const float4*>(do_s + r * KS + d);
      const float4 x = *reinterpret_cast<const float4*>(q_s + r * KS + d);
      float p[KA], g[KA];
      load_ka(p_s + r * PS + c0, p);
      load_ka(ds_s + r * PS + c0, g);
#pragma unroll
      for (int a = 0; a < KA; ++a) {
        fma4(dv[a], p[a], o);
        fma4(dk[a], g[a], x);
      }
    }
  }

  // dq[i] += sum_c ds[row i][c] k[c], over c = 0 .. BK - 1 in order, for
  // this lane's RA rows and 4 dims.
  __device__ void accumulate_dq(float4 (&dq)[RA]) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane >= RPW * LPR) return;
    const int slot = warp * RPW + lane / LPR, d = 4 * (lane % LPR);
    const float* ks = k_s + d;
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      const float4 k0 = *reinterpret_cast<const float4*>(ks + (c + 0) * KS);
      const float4 k1 = *reinterpret_cast<const float4*>(ks + (c + 1) * KS);
      const float4 k2 = *reinterpret_cast<const float4*>(ks + (c + 2) * KS);
      const float4 k3 = *reinterpret_cast<const float4*>(ks + (c + 3) * KS);
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const int r = slot + NS * i;
        if (r < BQ) {
          const float4 g = *reinterpret_cast<const float4*>(ds_s + r * PS + c);
          fma4(dq[i], g.x, k0);
          fma4(dq[i], g.y, k1);
          fma4(dq[i], g.z, k2);
          fma4(dq[i], g.w, k3);
        }
      }
    }
  }
};

__device__ __forceinline__ void staged() {
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// delta (B, Hq, Sq) = sum_d dout * out, one warp a row of (B, Sq, Hq).
template <class T>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, long long n, int Sq, int Hq, int D) {
  const long long row = ((long long)blockIdx.x * BWD_THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(widen(g[d]), widen(o[d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const long long b = row / ((long long)Sq * Hq);
    const int rem = (int)(row % ((long long)Sq * Hq)), i = rem / Hq, h = rem % Hq;
    delta[(b * Hq + h) * Sq + i] = acc;
  }
}

// Store a bf16 dk/dv block's dk and dv of (key, hk, b) at 2 dims from off:
// rounded to bf16 when part is null (G = 1), else its head g's fp32 partial into part (2,
// G, B, Sk, Hkv, D); n = B Sk Hkv D.
__device__ __forceinline__ void store_dkdv2(__nv_bfloat16* dk, __nv_bfloat16* dv, float* part,
                                            size_t off, size_t n, int g, int G, float k0,
                                            float k1, float v0, float v1) {
  if (part) {
    *reinterpret_cast<float2*>(part + g * n + off) = make_float2(k0, k1);
    *reinterpret_cast<float2*>(part + (G + g) * n + off) = make_float2(v0, v1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(k0, k1);
    *reinterpret_cast<__nv_bfloat162*>(dv + off) = __floats2bfloat162_rn(v0, v1);
  }
}

template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ part,
                      int Sq, int Sk, int Hq, int Hkv, int causal, float scale) {
  using Tile = BwdTile<D>;
  extern __shared__ float4 bwd_smem[];
  Tile tile(reinterpret_cast<float*>(bwd_smem));
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, hk = h / G, cols = min(Sk - k0, BK);
  const int nqt = (Sq + BQ - 1) / BQ, qt0 = causal ? k0 / BQ : 0;

  tile.stage_k(k, v, b, hk, k0, cols, Sk, Hkv);
  staged();  // before any exit: a block with no query tile in reach stores 0
  float4 dka[Tile::KA], dva[Tile::KA];
#pragma unroll
  for (int a = 0; a < Tile::KA; ++a)
    dka[a] = dva[a] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int qt = qt0; qt < nqt; ++qt) {
    const int q0 = qt * BQ, rows = min(Sq - q0, BQ);
    __syncthreads();  // the previous step's tiles are consumed
    tile.stage_q(q, dout, lse, delta, b, h, q0, rows, Sq, Hq);
    staged();
    tile.template scores<true>(scale, [&](int r, int c) {
      return r < rows && c < cols && (!causal || q0 + r >= k0 + c);
    });
    __syncthreads();
    tile.accumulate_dkdv(dka, dva);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane >= Tile::RPW * Tile::LPR) return;
  const int slot = warp * Tile::RPW + lane / Tile::LPR, d = 4 * (lane % Tile::LPR);
  const size_t n = (size_t)gridDim.z * Sk * Hkv * D;
#pragma unroll
  for (int a = 0; a < Tile::KA; ++a) {
    const int c = slot * Tile::KA + a;
    if (c >= cols) continue;
    const size_t off = (((size_t)b * Sk + k0 + c) * Hkv + hk) * D + d;
    if (part) {
      *reinterpret_cast<float4*>(part + (h % G) * n + off) = dka[a];
      *reinterpret_cast<float4*>(part + (G + h % G) * n + off) = dva[a];
    } else {
      store4(dk + off, dka[a]);
      store4(dv + off, dva[a]);
    }
  }
}

// dk, dv = the sum of the G heads' partials (2, G, B, Sk, Hkv, D) in
// ascending head order, rounded once; four elements a thread, n4 = n / 4.
template <class T>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_combine_kernel(const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
                         long long n4, int G) {
  const float4* p4 = reinterpret_cast<const float4*>(part);
  for (long long i = (long long)blockIdx.x * BWD_THREADS + threadIdx.x; i < 2 * n4;
       i += (long long)gridDim.x * BWD_THREADS) {
    const int w = i >= n4;  // 0: dk, 1: dv
    const long long j = i - w * n4;
    const float4* p = p4 + w * G * n4 + j;
    float4 a = p[0];
    for (int g = 1; g < G; ++g) {
      const float4 x = p[g * n4];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    store4((w ? dv : dk) + 4 * j, a);
  }
}

template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int causal,
                    float scale) {
  using Tile = BwdTile<D>;
  extern __shared__ float4 bwd_smem[];
  Tile tile(reinterpret_cast<float*>(bwd_smem));
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv), rows = min(Sq - q0, BQ);
  int nkt = (Sk + BK - 1) / BK;
  if (causal) nkt = min(nkt, (q0 + rows - 1) / BK + 1);

  tile.stage_q(q, dout, lse, delta, b, h, q0, rows, Sq, Hq);
  float4 acc[Tile::RA];
#pragma unroll
  for (int i = 0; i < Tile::RA; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK, cols = min(Sk - k0, BK);
    __syncthreads();  // the previous step's tiles are consumed
    tile.stage_k(k, v, b, hk, k0, cols, Sk, Hkv);
    staged();
    tile.template scores<false>(scale, [&](int r, int c) {
      return r < rows && c < cols && (!causal || q0 + r >= k0 + c);
    });
    __syncthreads();
    tile.accumulate_dq(acc);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane >= Tile::RPW * Tile::LPR) return;
  const int slot = warp * Tile::RPW + lane / Tile::LPR, d = 4 * (lane % Tile::LPR);
#pragma unroll
  for (int i = 0; i < Tile::RA; ++i) {
    const int r = slot + Tile::NS * i;
    if (r < rows) store4(dq + (((size_t)b * Sq + q0 + r) * Hq + h) * D + d, acc[i]);
  }
}

// ---------------------------------------------------------------- bf16

constexpr int TB_THREADS = 128;  // 4 warps
constexpr int TB_Q = 64;         // dq: query rows a block, 16 a warp
constexpr int TB_K = 64;         // dq: keys a tile
constexpr int TB_KEYS = 64;      // dk/dv: keys a block, 16 a warp
constexpr int TB_QT = 32;        // dk/dv: queries a tile

using bf16 = __nv_bfloat16;

template <int D>
__global__ void __launch_bounds__(TB_THREADS)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
                         int Sq, int Sk, int Hq, int Hkv, int causal, float scale) {
  using R = TcRows<D>;
  constexpr int ST = R::ST, NQ = TB_QT / 8, DT = D / 8, KD = D / 16;
  extern __shared__ uint4 tc_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* v_s = k_s + TB_KEYS * ST;
  bf16* qd_s = v_s + TB_KEYS * ST;  // buffer i: q, then dout, at 2 i TB_QT rows
  float* ld_s = reinterpret_cast<float*>(qd_s + 4 * TB_QT * ST);  // buffer i: lse, delta
  const int k0 = blockIdx.x * TB_KEYS, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, hk = h / G;
  const int nqt = (Sq + TB_QT - 1) / TB_QT, qt0 = causal ? k0 / TB_QT : 0;
  const long long qs = (long long)Hq * D, ks = (long long)Hkv * D;
  const bf16* qg = q + ((long long)b * Sq * Hq + h) * D;
  const bf16* og = dout + ((long long)b * Sq * Hq + h) * D;
  const float* lg = lse + ((long long)b * Hq + h) * Sq;
  const float* dg = delta + ((long long)b * Hq + h) * Sq;
  auto stage = [&](int qt, int buf) {
    const int q0 = qt * TB_QT, n = min(Sq - q0, TB_QT);
    bf16* qd = qd_s + buf * 2 * TB_QT * ST;
    R::template load<TB_QT, TB_THREADS>(qd, qg + q0 * qs, qs, n);
    R::template load<TB_QT, TB_THREADS>(qd + TB_QT * ST, og + q0 * qs, qs, n);
    const int i = threadIdx.x;
    if (i < 2 * TB_QT) {
      const int r = i % TB_QT;
      const float* src = (i < TB_QT ? lg : dg) + q0;
      cp_async4_zfill(ld_s + buf * 2 * TB_QT + i, r < n ? src + r : src, r < n);
    }
  };
  {
    const int n = min(Sk - k0, TB_KEYS);
    const long long base = ((long long)b * Sk + k0) * Hkv * D + (long long)hk * D;
    R::template load<TB_KEYS, TB_THREADS>(k_s, k + base, ks, n);
    R::template load<TB_KEYS, TB_THREADS>(v_s, v + base, ks, n);
  }
  if (qt0 < nqt) stage(qt0, 0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, tq = lane & 3;
  const int kr0 = 16 * warp, kc0 = k0 + kr0 + (lane >> 2), kc1 = kc0 + 8;
  const float sl = scale * TC_LOG2E;
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int qt = qt0; qt < nqt; ++qt) {
    const int buf = (qt - qt0) & 1;
    if (qt + 1 < nqt) stage(qt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* q_s = qd_s + buf * 2 * TB_QT * ST;
    const bf16* o_s = q_s + TB_QT * ST;
    const float* ls = ld_s + buf * 2 * TB_QT;
    const float* dl = ls + TB_QT;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x TB_QT queries
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned ka[4], va[4];
      R::a_frag(ka, k_s, kr0, kk);
      R::a_frag(va, v_s, kr0, kk);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        unsigned qb[4], ob[4];
        R::bt_frag(qb, q_s, 8 * j, kk);
        R::bt_frag(ob, o_s, 8 * j, kk);
        mma_bf16(st[j], ka, qb[0], qb[1]);
        mma_bf16(st[j + 1], ka, qb[2], qb[3]);
        mma_bf16(dpt[j], va, ob[0], ob[1]);
        mma_bf16(dpt[j + 1], va, ob[2], ob[3]);
      }
    }
    // p^T and ds^T in fp32; 0 for a masked, padded or absent pair (tested
    // only where the tile crosses the diagonal or an end: the warp's branch)
    const int q0 = qt * TB_QT;
    const bool edge = q0 + TB_QT > Sq || k0 + kr0 + 16 > Sk || (causal && q0 < k0 + kr0 + 15);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tq + (e & 1), qi = q0 + c, kj = e < 2 ? kc0 : kc1;
        float p = exp2_approx(fmaf(st[j][e], sl, -ls[c] * TC_LOG2E));
        if (edge && !(qi < Sq && kj < Sk && (!causal || kj <= qi))) p = 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dl[c]) * scale;
      }
    // dV += P^T dO, then dK += dS^T Q, the split operands straight from the
    // accumulators
#pragma unroll
    for (int j = 0; j < NQ; j += 2) {
      unsigned ah[4], al[4];
      a_from_c(st[j], st[j + 1], ah, al);
#pragma unroll
      for (int i = 0; i < DT; i += 2) {
        unsigned ob[4];
        R::b_frag(ob, o_s, 8 * j, 8 * i);
        mma_bf16(dva[i], ah, ob[0], ob[1]);
        mma_bf16(dva[i], al, ob[0], ob[1]);
        mma_bf16(dva[i + 1], ah, ob[2], ob[3]);
        mma_bf16(dva[i + 1], al, ob[2], ob[3]);
      }
      a_from_c(dpt[j], dpt[j + 1], ah, al);
#pragma unroll
      for (int i = 0; i < DT; i += 2) {
        unsigned qb[4];
        R::b_frag(qb, q_s, 8 * j, 8 * i);
        mma_bf16(dka[i], ah, qb[0], qb[1]);
        mma_bf16(dka[i], al, qb[0], qb[1]);
        mma_bf16(dka[i + 1], ah, qb[2], qb[3]);
        mma_bf16(dka[i + 1], al, qb[2], qb[3]);
      }
    }
    __syncthreads();  // this tile's buffers are consumed
  }
  cp_async_wait<0>();

  const size_t n = (size_t)gridDim.z * Sk * Hkv * D;
  const int g = h % G;
  float* pg = G > 1 ? part : nullptr;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int d = 8 * i + 2 * tq;
    if (kc0 < Sk)
      store_dkdv2(dk, dv, pg, (((size_t)b * Sk + kc0) * Hkv + hk) * D + d, n, g, G, dka[i][0],
                  dka[i][1], dva[i][0], dva[i][1]);
    if (kc1 < Sk)
      store_dkdv2(dk, dv, pg, (((size_t)b * Sk + kc1) * Hkv + hk) * D + d, n, g, G, dka[i][2],
                  dka[i][3], dva[i][2], dva[i][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(TB_THREADS)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int causal,
                       float scale) {
  using R = TcRows<D>;
  constexpr int ST = R::ST, NT = TB_K / 8, DT = D / 8, KD = D / 16;
  extern __shared__ uint4 tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* o_s = q_s + TB_Q * ST;
  bf16* kv_s = o_s + TB_Q * ST;  // buffer i: k, then v, at 2 i TB_K rows
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TB_Q, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv), rows = min(Sq - q0, TB_Q);
  int nkt = (Sk + TB_K - 1) / TB_K;
  if (causal) nkt = min(nkt, (q0 + rows - 1) / TB_K + 1);
  const long long qs = (long long)Hq * D, ks = (long long)Hkv * D;
  const bf16* kg = k + ((long long)b * Sk * Hkv + hk) * D;
  const bf16* vg = v + ((long long)b * Sk * Hkv + hk) * D;
  auto stage = [&](int t, int buf) {
    const int kt0 = t * TB_K, n = min(Sk - kt0, TB_K);
    bf16* kd = kv_s + buf * 2 * TB_K * ST;
    R::template load<TB_K, TB_THREADS>(kd, kg + kt0 * ks, ks, n);
    R::template load<TB_K, TB_THREADS>(kd + TB_K * ST, vg + kt0 * ks, ks, n);
  };
  const long long qoff = (((long long)b * Sq + q0) * Hq + h) * D;
  R::template load<TB_Q, TB_THREADS>(q_s, q + qoff, qs, rows);
  R::template load<TB_Q, TB_THREADS>(o_s, dout + qoff, qs, rows);
  stage(0, 0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, tq = lane & 3;
  const int r0 = 16 * warp, qr0 = q0 + r0 + (lane >> 2), qr1 = qr0 + 8;
  const long long lrow = ((long long)b * Hq + h) * Sq;
  // lse in base 2, for p = 2^(s scale log2(e) - lse log2(e))
  const float sl = scale * TC_LOG2E;
  const float ls0 = qr0 < Sq ? lse[lrow + qr0] * TC_LOG2E : 0.f;
  const float ls1 = qr1 < Sq ? lse[lrow + qr1] * TC_LOG2E : 0.f;
  const float dl0 = qr0 < Sq ? delta[lrow + qr0] : 0.f;
  const float dl1 = qr1 < Sq ? delta[lrow + qr1] : 0.f;
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int t = 0; t < nkt; ++t) {
    const int buf = t & 1;
    if (t + 1 < nkt) stage(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* k_s = kv_s + buf * 2 * TB_K * ST;
    const bf16* v_s = k_s + TB_K * ST;

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x TB_K keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned qa[4], oa[4];
      R::a_frag(qa, q_s, r0, kk);
      R::a_frag(oa, o_s, r0, kk);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned kb[4], vb[4];
        R::bt_frag(kb, k_s, 8 * j, kk);
        R::bt_frag(vb, v_s, 8 * j, kk);
        mma_bf16(s[j], qa, kb[0], kb[1]);
        mma_bf16(s[j + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[j], oa, vb[0], vb[1]);
        mma_bf16(dp[j + 1], oa, vb[2], vb[3]);
      }
    }
    // ds in fp32 (into s); 0 for a masked, padded or absent pair (tested
    // only where the tile crosses the diagonal or an end: the warp's branch)
    const int kt0 = t * TB_K;
    const bool edge = kt0 + TB_K > Sk || q0 + r0 + 16 > Sq || (causal && kt0 + TB_K - 1 > q0 + r0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kt0 + 8 * j + 2 * tq + (e & 1), r = e < 2 ? qr0 : qr1;
        float p = exp2_approx(fmaf(s[j][e], sl, -(e < 2 ? ls0 : ls1)));
        if (edge && !(r < Sq && c < Sk && (!causal || c <= r))) p = 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1)) * scale;
      }
    // dQ += dS K, dS split straight from the accumulators
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      unsigned gh[4], gl[4];
      a_from_c(s[j], s[j + 1], gh, gl);
#pragma unroll
      for (int i = 0; i < DT; i += 2) {
        unsigned kb[4];
        R::b_frag(kb, k_s, 8 * j, 8 * i);
        mma_bf16(acc[i], gh, kb[0], kb[1]);
        mma_bf16(acc[i], gl, kb[0], kb[1]);
        mma_bf16(acc[i + 1], gh, kb[2], kb[3]);
        mma_bf16(acc[i + 1], gl, kb[2], kb[3]);
      }
    }
    __syncthreads();  // this tile's buffers are consumed
  }
  cp_async_wait<0>();

  bf16* d0 = dq + (((long long)b * Sq + qr0) * Hq + h) * D + 2 * tq;
  bf16* d1 = d0 + 8 * qs;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    if (qr0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(d0 + 8 * i) = __floats2bfloat162_rn(acc[i][0], acc[i][1]);
    if (qr1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(d1 + 8 * i) = __floats2bfloat162_rn(acc[i][2], acc[i][3]);
  }
}

// --------------------------------------------------------------- launch

template <class T>
cudaError_t launch_delta(const T* out, const T* dout, float* delta, int B, int Sq, int Hq,
                                 int D, cudaStream_t stream) {
  const long long rows = (long long)B * Sq * Hq;
  const long long blocks = (rows * 32 + BWD_THREADS - 1) / BWD_THREADS;
  flash_bwd_delta_kernel<T><<<(unsigned)blocks, BWD_THREADS, 0, stream>>>(out, dout, delta,
                                                                          rows, Sq, Hq, D);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_combine(const float* part, T* dk, T* dv, int B, int Sk, int Hkv, int D, int G,
                           cudaStream_t stream) {
  const long long n4 = (long long)B * Sk * Hkv * D / 4;
  unsigned blocks = 0;
  cudaError_t e = grid_stride_blocks(2 * n4, BWD_THREADS, 8, blocks);
  if (e != cudaSuccess) return e;
  flash_bwd_combine_kernel<T><<<blocks, BWD_THREADS, 0, stream>>>(part, dk, dv, n4, G);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_f32(const float* q, const float* k, const float* v, const float* out,
                           const float* dout, const float* lse, float* delta, float* dq,
                           float* dk, float* dv, float* part, int B, int Sq, int Sk, int Hq,
                           int Hkv, int causal, float scale, cudaStream_t stream) {
  static unsigned long long set_dkdv = 0, set_dq = 0;
  auto dkdv = flash_bwd_dkdv_kernel<D>;
  auto dqk = flash_bwd_dq_kernel<D>;
  const size_t smem = BwdTile<D>::BYTES;
  cudaError_t e = set_smem_once(dkdv, smem, set_dkdv);
  if (e == cudaSuccess) e = set_smem_once(dqk, smem, set_dq);
  if (e == cudaSuccess) e = launch_delta(out, dout, delta, B, Sq, Hq, D, stream);
  if (e != cudaSuccess) return e;
  const int G = Hq / Hkv;
  dkdv<<<dim3((Sk + BK - 1) / BK, Hq, B), BWD_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, G > 1 ? part : nullptr, Sq, Sk, Hq, Hkv, causal,
      scale);
  e = cudaGetLastError();
  if (e == cudaSuccess && G > 1) e = launch_combine(part, dk, dv, B, Sk, Hkv, D, G, stream);
  if (e != cudaSuccess) return e;
  dqk<<<dim3((Sq + BQ - 1) / BQ, Hq, B), BWD_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, Hq, Hkv, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* out,
                            const bf16* dout, const float* lse, float* delta, bf16* dq, bf16* dk,
                            bf16* dv, float* part, int B, int Sq, int Sk, int Hq, int Hkv,
                            int causal, float scale, cudaStream_t stream) {
  static unsigned long long set_dkdv = 0, set_dq = 0;
  using R = TcRows<D>;
  auto dkdv = flash_bwd_dkdv_tc_kernel<D>;
  auto dqk = flash_bwd_dq_tc_kernel<D>;
  const size_t smem_kv =
      sizeof(bf16) * (2 * TB_KEYS + 4 * TB_QT) * R::ST + sizeof(float) * 4 * TB_QT;
  const size_t smem_q = sizeof(bf16) * (2 * TB_Q + 4 * TB_K) * R::ST;
  cudaError_t e = set_smem_once(dkdv, smem_kv, set_dkdv);
  if (e == cudaSuccess) e = set_smem_once(dqk, smem_q, set_dq);
  if (e == cudaSuccess) e = launch_delta(out, dout, delta, B, Sq, Hq, D, stream);
  if (e != cudaSuccess) return e;
  const int G = Hq / Hkv;
  dkdv<<<dim3((Sk + TB_KEYS - 1) / TB_KEYS, Hq, B), TB_THREADS, smem_kv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, part, Sq, Sk, Hq, Hkv, causal, scale);
  e = cudaGetLastError();
  if (e == cudaSuccess && G > 1) e = launch_combine(part, dk, dv, B, Sk, Hkv, D, G, stream);
  if (e != cudaSuccess) return e;
  dqk<<<dim3((Sq + TB_Q - 1) / TB_Q, Hq, B), TB_THREADS, smem_q, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, Hq, Hkv, causal, scale);
  return cudaGetLastError();
}

#define REPRO_FLASH_BWD_SWITCH(LAUNCH)                                                         \
  switch (D) {                                                                                 \
    case 16:                                                                                   \
      return LAUNCH<16>(q, k, v, out, dout, lse, delta, dq, dk, dv, part, B, Sq, Sk, Hq, Hkv,  \
                        causal, scale, stream);                                                \
    case 32:                                                                                   \
      return LAUNCH<32>(q, k, v, out, dout, lse, delta, dq, dk, dv, part, B, Sq, Sk, Hq, Hkv,  \
                        causal, scale, stream);                                                \
    case 64:                                                                                   \
      return LAUNCH<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, part, B, Sq, Sk, Hq, Hkv,  \
                        causal, scale, stream);                                                \
    case 80: /* hubert-xlarge, stablelm-3b */                                                  \
      return LAUNCH<80>(q, k, v, out, dout, lse, delta, dq, dk, dv, part, B, Sq, Sk, Hq, Hkv,  \
                        causal, scale, stream);                                                \
    case 96: /* phi3-mini-3.8b */                                                              \
      return LAUNCH<96>(q, k, v, out, dout, lse, delta, dq, dk, dv, part, B, Sq, Sk, Hq, Hkv,  \
                        causal, scale, stream);                                                \
    case 112: /* zamba2-7b's shared block */                                                   \
      return LAUNCH<112>(q, k, v, out, dout, lse, delta, dq, dk, dv, part, B, Sq, Sk, Hq, Hkv, \
                         causal, scale, stream);                                               \
    case 128:                                                                                  \
      return LAUNCH<128>(q, k, v, out, dout, lse, delta, dq, dk, dv, part, B, Sq, Sk, Hq, Hkv, \
                         causal, scale, stream);                                               \
    default:                                                                                   \
      return cudaErrorInvalidValue;                                                            \
  }

}  // namespace

// q, out, dout, dq (B, Sq, Hq, D); k, v, dk, dv (B, Sk, Hkv, D); lse and the
// scratch delta (B, Hq, Sq) fp32; with Hq > Hkv the scratch part (2, Hq /
// Hkv, B, Sk, Hkv, D) fp32 (else unread: may be null). fp32, contiguous,
// 16-byte aligned. Device launches on the stream: delta, dk/dv, combine
// (Hq > Hkv), dq.
REPRO_API int flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                                      const float* out, const float* dout, const float* lse,
                                      float* delta, float* dq, float* dk, float* dv, float* part,
                                      int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                                      float scale, cudaStream_t stream) {
  if (Hq != Hkv && part == nullptr) return cudaErrorInvalidValue;
  REPRO_FLASH_BWD_SWITCH(launch_bwd_f32)
}

// The same in bf16 (q, k, v, out, dout and the gradients; lse, delta and
// part fp32), on the tensor cores: each gradient rounded once to nearest
// even.
REPRO_API int flash_attention_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, const __nv_bfloat16* out,
                                       const __nv_bfloat16* dout, const float* lse, float* delta,
                                       __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                                       float* part, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                       int causal, float scale, cudaStream_t stream) {
  if (Hq != Hkv && part == nullptr) return cudaErrorInvalidValue;
  REPRO_FLASH_BWD_SWITCH(launch_bwd_bf16)
}
