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
// Design: FA2's split into passes, three launches a call, no atomics (two
// launches give the same gradients bit for bit: every sum runs in a fixed
// order inside one block).
//   delta  one warp a (b, query row, head): lanes over D, a shuffle sum.
//   dk/dv  one block a (key tile of BK keys, KV head, b). K and V stage
//          once; the block walks every query head of the group and, for
//          each, the query tiles of BQ rows from the first that reaches its
//          keys (causal) to the end, accumulating dk and dv in registers:
//          the group fold is this walk's order, head by head.
//   dq     one block a (query tile, head, b), heavy tiles first (causal:
//          the last query tiles see the most keys); it walks the key tiles
//          up to the diagonal, accumulating dq in registers.
// Each step stages its tiles (16-byte cp.async for fp32; bf16 widened to
// fp32 as it stages, attn_tile.cuh's stage_vec), computes the BQ x BK
// scores and dout v^T together (16 x 16 threads, 4 x 2 cells each, 16-byte
// shared loads), writes p and ds to shared memory, then the products over
// the tile (the P.V layout of attn_tile.cuh: a row's D outputs are D/4
// lanes x 4 dims). Tiles wholly above the diagonal are skipped; a padded
// row or column (a ragged tile) gets p = ds = 0 explicitly, so no stale
// lse is read past a tile's end; the staged rows there are zero.
//   Bound on this card: five S x S x D products (the minimum: dp, and the
//   products for dq, dk, dv; s recomputed is p's), 2 flops a product term,
//   over the visible pairs: 5 * 2 * D * pairs * Hq * B. At qwen2.5-3b's
//   training shape (B 1, S 4096, Hq 16, Hkv 2, D 128, causal) 1.72e11:
//   2.6 ms at the 67 TFLOP/s fp32 rate (0.17 at bf16's 989 on the tensor
//   cores), against 0.3 GB of bytes (under 0.1 ms): bound by operations.
//   This design does seven such products (s and dp again in the dq pass),
//   fp32 on the CUDA cores; mma.sync / wgmma and TMA are later work.
#include "attn_tile.cuh"

namespace {

constexpr int BWD_THREADS = 256;
constexpr int BQ = 64;  // query rows a tile
constexpr int BK = 32;  // keys a tile

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// Stage n <= nmax rows of D values of T into dst (fp32, row stride ds);
// row t starts at g + off(t). Rows n..nmax-1 are zero-filled.
template <int D, class T, class Off>
__device__ void stage_rows(float* dst, int ds, const T* g, int n, int nmax, Off off) {
  constexpr int VEC = Elem<T>::VEC, LPV = D / VEC;
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
  template <class T>
  __device__ void stage_q(const T* q, const T* dout, const float* lse, const float* delta,
                          int b, int h, int q0, int rows, int Sq, int Hq) {
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
  template <class T>
  __device__ void stage_k(const T* k, const T* v, int b, int hk, int k0, int cols, int Sk,
                          int Hkv) {
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

template <class T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
                      int causal, float scale) {
  using Tile = BwdTile<D>;
  extern __shared__ float4 bwd_smem[];
  Tile tile(reinterpret_cast<float*>(bwd_smem));
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int cols = min(Sk - k0, BK), G = Hq / Hkv;
  const int nqt = (Sq + BQ - 1) / BQ, qt0 = causal ? k0 / BQ : 0;

  tile.stage_k(k, v, b, hk, k0, cols, Sk, Hkv);
  staged();  // before any exit: a block with no query tile in reach stores 0
  float4 dka[Tile::KA], dva[Tile::KA];
#pragma unroll
  for (int a = 0; a < Tile::KA; ++a)
    dka[a] = dva[a] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
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
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane >= Tile::RPW * Tile::LPR) return;
  const int slot = warp * Tile::RPW + lane / Tile::LPR, d = 4 * (lane % Tile::LPR);
#pragma unroll
  for (int a = 0; a < Tile::KA; ++a) {
    const int c = slot * Tile::KA + a;
    if (c >= cols) continue;
    const size_t off = (((size_t)b * Sk + k0 + c) * Hkv + hk) * D + d;
    store4(dk + off, dka[a]);
    store4(dv + off, dva[a]);
  }
}

template <class T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int Hq,
                    int Hkv, int causal, float scale) {
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

template <class T, int D>
cudaError_t launch_bwd(const T* q, const T* k, const T* v, const T* out, const T* dout,
                       const float* lse, float* delta, T* dq, T* dk, T* dv, int B, int Sq,
                       int Sk, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  static unsigned long long set_dkdv = 0, set_dq = 0;
  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  auto dqk = flash_bwd_dq_kernel<T, D>;
  const size_t smem = BwdTile<D>::BYTES;
  cudaError_t e = set_smem_once(dkdv, smem, set_dkdv);
  if (e == cudaSuccess) e = set_smem_once(dqk, smem, set_dq);
  if (e != cudaSuccess) return e;
  const long long rows = (long long)B * Sq * Hq;
  const long long blocks = (rows * 32 + BWD_THREADS - 1) / BWD_THREADS;
  flash_bwd_delta_kernel<T><<<(unsigned)blocks, BWD_THREADS, 0, stream>>>(out, dout, delta,
                                                                          rows, Sq, Hq, D);
  dkdv<<<dim3((Sk + BK - 1) / BK, Hkv, B), BWD_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, Hq, Hkv, causal, scale);
  dqk<<<dim3((Sq + BQ - 1) / BQ, Hq, B), BWD_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, Hq, Hkv, causal, scale);
  return cudaGetLastError();
}

template <class T>
int flash_bwd(const T* q, const T* k, const T* v, const T* out, const T* dout, const float* lse,
              float* delta, T* dq, T* dk, T* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D,
              int causal, float scale, cudaStream_t stream) {
#define REPRO_FLASH_BWD_CASE(DD)                                                             \
  case DD:                                                                                   \
    return launch_bwd<T, DD>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, \
                             causal, scale, stream);
  switch (D) {
    REPRO_FLASH_BWD_CASE(16)
    REPRO_FLASH_BWD_CASE(32)
    REPRO_FLASH_BWD_CASE(64)
    REPRO_FLASH_BWD_CASE(80)   // hubert-xlarge, stablelm-3b
    REPRO_FLASH_BWD_CASE(96)   // phi3-mini-3.8b
    REPRO_FLASH_BWD_CASE(112)  // zamba2-7b's shared block
    REPRO_FLASH_BWD_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_BWD_CASE
}

}  // namespace

// q, out, dout, dq (B, Sq, Hq, D); k, v, dk, dv (B, Sk, Hkv, D); lse and the
// scratch delta (B, Hq, Sq) fp32. fp32, contiguous, 16-byte aligned. Three
// device launches (delta, dk/dv, dq) on the stream.
REPRO_API int flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                                      const float* out, const float* dout, const float* lse,
                                      float* delta, float* dq, float* dk, float* dv, int B,
                                      int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                                      float scale, cudaStream_t stream) {
  return flash_bwd(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, causal,
                   scale, stream);
}

// The same in bf16 (q, k, v, out, dout and the gradients; lse and delta
// fp32): widened as the tiles stage, fp32 inside, each gradient rounded
// once to nearest even.
REPRO_API int flash_attention_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, const __nv_bfloat16* out,
                                       const __nv_bfloat16* dout, const float* lse, float* delta,
                                       __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                                       int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                                       float scale, cudaStream_t stream) {
  return flash_bwd(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Sk, Hq, Hkv, D, causal,
                   scale, stream);
}
