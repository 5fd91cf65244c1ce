// GQA flash attention, backward, fp32 or bf16, sm_90a.
//
// Replaces the backward of the training path's flash attention: _bwd_vjp of
// the custom VJP flash_attention_xla (src/repro/kernels/flash_attention/
// blocked.py:100-140), which JAX's auto dispatch runs off the TPU at S >=
// 2048 (ops.py:23-27) under build_model(use_flash=True) (repro/models/
// attention.py:102-104). The Pallas forward (flash_attention.py:66) has no
// backward of its own; the training forward of its row-1 kernel
// (flash_attention.cu's lse entries) is this kernel's forward.
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
// The bound on this card: five S x S x D products (the minimum: dp, and the
// products for dq, dk, dv; s recomputed is p's), 2 flops a product term,
// over the visible pairs: 5 * 2 * D * pairs * Hq * B. At qwen2.5-3b's
// training shape (B 1, S 4096, Hq 16, Hkv 2, D 128, causal) 1.72e11: 2.6 ms
// at the 67 TFLOP/s fp32 rate, against 0.3 GB of bytes (under 0.1 ms):
// bound by operations. Both dtypes do seven such products (s and dp again
// in the dq pass), on the tensor cores.
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
//
// fp32 (flash_attention_bwd_f32) on the tensor cores too: each fp32 operand
// as three bf16 terms (csrc/mma_tile.cuh's split3, hi + mid + lo == x) and
// each product as the six term products above 2^-24 of it (mma_x5 and
// mma_x6_add, smallest first); p and ds leave the accumulators as three terms (a_from_c3). One
// body for every D, 8 warps a block in pairs: a pass keeps 64 rows (16 a
// pair), split once into their A fragments' three terms in shared memory
// (96 KB at D 128: the accumulators, dk and dv or dq, leave no registers for
// them), and walks tiles of 32 rows of the other side, staged in fp32 by
// cp.async and split once a block into three bf16 planes that ldmatrix
// reads (51 KB at D 128, with 32 KB of staging). Each warp of a pair takes
// 16 of a tile's 32 rows, so its s and dp tiles are 16 x 16 (the five
// smaller terms and hi hi in separate accumulators, hi hi added last); at
// the end the second warp's partials go through shared memory and the
// first adds them to its own, in that order.
//   dk/dv   a block keeps 64 keys (k and v) and walks the query tiles of 32
//           (q and dout) from the first that reaches its keys; the combine
//           of the heads' partials is the bf16 pass's kernel.
//   dq      a block keeps 64 query rows (q and dout), heavy tiles first, and
//           walks the key tiles of 32 (k and v) up to the diagonal.
// Six mma a product and seven products: 42 S x S x D units of work at
// bf16's rate, a floor of 1.46 ms at the silo shape, under the 2.56 ms fp32
// bound. Shared memory, 180 KB at D 128, holds one block (8 warps) an SM;
// 255 registers at D 128, with 0 (dq) and 8 (dk/dv) bytes of stack (the
// k-step loops unrolled by 2: fully unrolled, the hoisted loads spilled
// 32-112 bytes at D 80-128 and were 1-2% slower; tools/time_flash_pair.py,
// H100 80GB HBM3, 700 W).
#include "mma_tile.cuh"

namespace {

constexpr int BWD_THREADS = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// Four outputs in the output's type: fp32 as they are, bf16 rounded once
// to nearest even (as torch's .to(torch.bfloat16) and XLA's convert round).
__device__ __forceinline__ void store4(float* o, float4 v) {
  *reinterpret_cast<float4*>(o) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* o, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&lo);
  raw.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(o) = raw;
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

// ---------------------------------------------------------------- fp32

constexpr int XB_THREADS = 256;  // 8 warps: 4 pairs
constexpr int XB_FIX = 64;       // rows a block keeps (keys, or queries): 16 a pair
constexpr int XB_WALK = 32;      // rows a walked tile: 16 for each warp of a pair

template <int D>
constexpr size_t x3_bwd_smem() {
  // the kept operands' fragments (4 pairs, 2 tensors, 3 terms), the walked
  // tiles' planes (2 tensors, 3 terms) and their fp32 staging, lse and
  // delta twice
  return sizeof(uint4) * 4 * 6 * (D / 16) * 32 + sizeof(bf16) * 6 * XB_WALK * TcRows<D>::ST +
         sizeof(float) * (2 * XB_WALK * D + 4 * XB_WALK);
}

// The A fragments of 16 rows (from g, row stride gs; rows >= n read 0) as
// three terms into a pair's shared slots dst[(term KD + kk) 32], every k-step.
template <int D>
__device__ __forceinline__ void keep_x3(uint4* dst, const float* g, long long gs, int n) {
  constexpr int KD = D / 16;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    unsigned a[3][4];
    a_frag_x3(a, g, gs, n, kk);
#pragma unroll
    for (int t = 0; t < 3; ++t) dst[(t * KD + kk) * 32] = pack4(a[t]);
  }
}

__device__ __forceinline__ void take_x3(unsigned (&a)[3][4], const uint4* src, int KD, int kk) {
#pragma unroll
  for (int t = 0; t < 3; ++t) unpack4(a[t], src[(t * KD + kk) * 32]);
}

// Warp pair p's halves: the second (warps 4..7) leaves its accumulators in
// shared memory, the first adds them to its own (own + other, in that
// order). acc are the warp's N accumulator tiles; red the block's scratch
// (4 N 32 float4). Returns whether this warp holds the sums.
template <int N>
__device__ __forceinline__ bool fold_pair(float (&acc)[N][4], float4* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float4* r = red + (warp & 3) * N * 32 + lane;
  __syncthreads();  // every warp is done with what the scratch held
  if (warp >= 4)
#pragma unroll
    for (int i = 0; i < N; ++i) r[i * 32] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  if (warp >= 4) return false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float4 x = r[i * 32];
    acc[i][0] += x.x;
    acc[i][1] += x.y;
    acc[i][2] += x.z;
    acc[i][3] += x.w;
  }
  return true;
}

// dk/dv: a block keeps 64 keys (16 a pair: k and v split once into their A
// fragments' three terms, in shared memory) and walks the query tiles of 32
// (q and dout staged, then split once into planes); warp 4 + p takes the
// second 16 queries of each tile for pair p's keys, and the pair's partials
// are added at the end.
template <int D>
__global__ void __launch_bounds__(XB_THREADS, 1)
flash_bwd_dkdv_x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ part,
                         int Sq, int Sk, int Hq, int Hkv, int causal, float scale) {
  using R = TcRows<D>;
  using X = X3Rows<D>;
  constexpr int ST = R::ST, DT = D / 8, KD = D / 16, PL = XB_WALK * ST;
  extern __shared__ uint4 tc_smem[];
  uint4* kv_f = tc_smem;  // [pair][k, v][term][kk][lane]
  bf16* qd_p = reinterpret_cast<bf16*>(tc_smem + 4 * 6 * KD * 32);  // q's planes, dout's
  float* stg = reinterpret_cast<float*>(qd_p + 6 * PL);               // q, dout in fp32
  float* ld_s = stg + 2 * XB_WALK * D;  // buffer i: lse, delta at 2 i XB_WALK
  const int k0 = blockIdx.x * XB_FIX, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, hk = h / G;
  const int nqt = (Sq + XB_WALK - 1) / XB_WALK, qt0 = causal ? k0 / XB_WALK : 0;
  const long long qs = (long long)Hq * D, ks = (long long)Hkv * D;
  const float* qg = q + ((long long)b * Sq * Hq + h) * D;
  const float* og = dout + ((long long)b * Sq * Hq + h) * D;
  const float* lg = lse + ((long long)b * Hq + h) * Sq;
  const float* dg = delta + ((long long)b * Hq + h) * Sq;
  auto stage = [&](int qt) {
    const int q0 = qt * XB_WALK, n = min(Sq - q0, XB_WALK);
    X::template load<XB_WALK, XB_THREADS>(stg, qg + q0 * qs, qs, n);
    X::template load<XB_WALK, XB_THREADS>(stg + XB_WALK * D, og + q0 * qs, qs, n);
    const int i = threadIdx.x;
    if (i < 2 * XB_WALK) {
      const int r = i % XB_WALK;
      const float* src = (i < XB_WALK ? lg : dg) + q0;
      cp_async4_zfill(ld_s + ((qt - qt0) & 1) * 2 * XB_WALK + i, r < n ? src + r : src, r < n);
    }
  };
  if (qt0 < nqt) stage(qt0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, tq = lane & 3;
  const int pair = warp & 3, half = warp >> 2, qr = 16 * half;
  const int kr0 = 16 * pair, kc0 = k0 + kr0 + (lane >> 2), kc1 = kc0 + 8;
  const uint4* kf = kv_f + pair * 6 * KD * 32 + lane;  // k's terms, then v's
  // k split by warp p, v by warp 4 + p
  keep_x3<D>(kv_f + (pair * 2 + half) * 3 * KD * 32 + lane,
             (half ? v : k) + (((long long)b * Sk + k0 + kr0) * Hkv + hk) * D, ks,
             Sk - k0 - kr0);
  const float sl = scale * TC_LOG2E;
  const bf16* q_p = qd_p;
  const bf16* o_p = qd_p + 3 * PL;
  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int qt = qt0; qt < nqt; ++qt) {
    cp_async_wait<0>();
    __syncthreads();  // tile qt staged; qt - 1's planes consumed (k, v kept)
    X::template split<XB_WALK, XB_THREADS>(qd_p, stg);
    X::template split<XB_WALK, XB_THREADS>(qd_p + 3 * PL, stg + XB_WALK * D);
    __syncthreads();  // the planes are whole; the staging is free
    if (qt + 1 < nqt) stage(qt + 1);
    cp_async_commit();
    const float* ls = ld_s + ((qt - qt0) & 1) * 2 * XB_WALK + qr;
    const float* dl = ls + XB_WALK;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 16 queries, the
    // five smaller terms apart from hi hi, added last
    float sm[2][4], st[2][4], pm[2][4], dpt[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sm[j][e] = st[j][e] = pm[j][e] = dpt[j][e] = 0.f;
#pragma unroll 2  // full unrolling spilled at D 96-128
    for (int kk = 0; kk < KD; ++kk) {
      unsigned a[3][4], bq[3][4];
      take_x3(a, kf, KD, kk);
#pragma unroll
      for (int t = 0; t < 3; ++t) R::bt_frag(bq[t], q_p + t * PL, qr, kk);
      mma_x5(sm[0], sm[1], a, bq);
      mma_bf16(st[0], a[0], bq[0][0], bq[0][1]);
      mma_bf16(st[1], a[0], bq[0][2], bq[0][3]);
      take_x3(a, kf + 3 * KD * 32, KD, kk);
#pragma unroll
      for (int t = 0; t < 3; ++t) R::bt_frag(bq[t], o_p + t * PL, qr, kk);
      mma_x5(pm[0], pm[1], a, bq);
      mma_bf16(dpt[0], a[0], bq[0][0], bq[0][1]);
      mma_bf16(dpt[1], a[0], bq[0][2], bq[0][3]);
    }
    // p^T and ds^T in fp32; 0 for a masked, padded or absent pair (tested
    // only where the warp's tile crosses the diagonal or an end)
    const int q0 = qt * XB_WALK + qr;
    const bool edge = q0 + 16 > Sq || k0 + kr0 + 16 > Sk || (causal && q0 < k0 + kr0 + 15);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tq + (e & 1), qi = q0 + c, kj = e < 2 ? kc0 : kc1;
        float p = exp2_approx(fmaf(sm[j][e] + st[j][e], sl, -ls[c] * TC_LOG2E));
        if (edge && !(qi < Sq && kj < Sk && (!causal || kj <= qi))) p = 0.f;
        st[j][e] = p;
        dpt[j][e] = p * ((pm[j][e] + dpt[j][e]) - dl[c]) * scale;
      }
    // dV += P^T dO, then dK += dS^T Q: all three terms of each
    unsigned pa[3][4];
    a_from_c3(st[0], st[1], pa[0], pa[1], pa[2]);
#pragma unroll
    for (int i = 0; i < DT; i += 2) {
      unsigned bo[3][4];
#pragma unroll
      for (int t = 0; t < 3; ++t) R::b_frag(bo[t], o_p + t * PL, qr, 8 * i);
      mma_x6_add(dva[i], dva[i + 1], pa, bo);
    }
    a_from_c3(dpt[0], dpt[1], pa[0], pa[1], pa[2]);
#pragma unroll
    for (int i = 0; i < DT; i += 2) {
      unsigned bq[3][4];
#pragma unroll
      for (int t = 0; t < 3; ++t) R::b_frag(bq[t], q_p + t * PL, qr, 8 * i);
      mma_x6_add(dka[i], dka[i + 1], pa, bq);
    }
  }
  cp_async_wait<0>();

  float4* red = reinterpret_cast<float4*>(tc_smem);
  const bool dk_here = fold_pair(dka, red);
  const bool dv_here = fold_pair(dva, red);
  if (!(dk_here && dv_here)) return;
  // G = 1: the gradients; else this head's fp32 partial for the combine
  const size_t n = (size_t)gridDim.z * Sk * Hkv * D;
  const int g = h % G;
  float* kd = G > 1 ? part + g * n : dk;
  float* vd = G > 1 ? part + (G + g) * n : dv;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int d = 8 * i + 2 * tq;
    if (kc0 < Sk) {
      const size_t off = (((size_t)b * Sk + kc0) * Hkv + hk) * D + d;
      *reinterpret_cast<float2*>(kd + off) = make_float2(dka[i][0], dka[i][1]);
      *reinterpret_cast<float2*>(vd + off) = make_float2(dva[i][0], dva[i][1]);
    }
    if (kc1 < Sk) {
      const size_t off = (((size_t)b * Sk + kc1) * Hkv + hk) * D + d;
      *reinterpret_cast<float2*>(kd + off) = make_float2(dka[i][2], dka[i][3]);
      *reinterpret_cast<float2*>(vd + off) = make_float2(dva[i][2], dva[i][3]);
    }
  }
}

// dq: a block keeps 64 query rows (16 a pair: q and dout split once into
// their A fragments' three terms) and walks the key tiles of 32 (k and v
// staged, then split once into planes), heavy tiles first; warp 4 + p takes
// the second 16 keys of each tile for pair p's rows, and the pair's
// partials are added at the end.
template <int D>
__global__ void __launch_bounds__(XB_THREADS, 1)
flash_bwd_dq_x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int causal,
                       float scale) {
  using R = TcRows<D>;
  using X = X3Rows<D>;
  constexpr int ST = R::ST, DT = D / 8, KD = D / 16, PL = XB_WALK * ST;
  extern __shared__ uint4 tc_smem[];
  uint4* qo_f = tc_smem;  // [pair][q, dout][term][kk][lane]
  bf16* kv_p = reinterpret_cast<bf16*>(tc_smem + 4 * 6 * KD * 32);  // k's planes, v's
  float* stg = reinterpret_cast<float*>(kv_p + 6 * PL);               // k, v in fp32
  const int q0 = (gridDim.x - 1 - blockIdx.x) * XB_FIX, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv), rows = min(Sq - q0, XB_FIX);
  int nkt = (Sk + XB_WALK - 1) / XB_WALK;
  if (causal) nkt = min(nkt, (q0 + rows - 1) / XB_WALK + 1);
  const long long qs = (long long)Hq * D, ks = (long long)Hkv * D;
  const float* kg = k + ((long long)b * Sk * Hkv + hk) * D;
  const float* vg = v + ((long long)b * Sk * Hkv + hk) * D;
  auto stage = [&](int t) {
    const int kt0 = t * XB_WALK, n = min(Sk - kt0, XB_WALK);
    X::template load<XB_WALK, XB_THREADS>(stg, kg + kt0 * ks, ks, n);
    X::template load<XB_WALK, XB_THREADS>(stg + XB_WALK * D, vg + kt0 * ks, ks, n);
  };
  stage(0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, tq = lane & 3;
  const int pair = warp & 3, half = warp >> 2, kr = 16 * half;
  const int r0 = 16 * pair, qr0 = q0 + r0 + (lane >> 2), qr1 = qr0 + 8;
  const uint4* qf = qo_f + pair * 6 * KD * 32 + lane;  // q's terms, then dout's
  // q split by warp p, dout by warp 4 + p
  keep_x3<D>(qo_f + (pair * 2 + half) * 3 * KD * 32 + lane,
             (half ? dout : q) + (((long long)b * Sq + q0 + r0) * Hq + h) * D, qs, rows - r0);
  const long long lrow = ((long long)b * Hq + h) * Sq;
  const float sl = scale * TC_LOG2E;
  const float ls0 = qr0 < Sq ? lse[lrow + qr0] * TC_LOG2E : 0.f;
  const float ls1 = qr1 < Sq ? lse[lrow + qr1] * TC_LOG2E : 0.f;
  const float dl0 = qr0 < Sq ? delta[lrow + qr0] : 0.f;
  const float dl1 = qr1 < Sq ? delta[lrow + qr1] : 0.f;
  const bf16* k_p = kv_p;
  const bf16* v_p = kv_p + 3 * PL;
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t staged; t - 1's planes consumed (q, dout kept)
    X::template split<XB_WALK, XB_THREADS>(kv_p, stg);
    X::template split<XB_WALK, XB_THREADS>(kv_p + 3 * PL, stg + XB_WALK * D);
    __syncthreads();  // the planes are whole; the staging is free
    if (t + 1 < nkt) stage(t + 1);
    cp_async_commit();

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x 16 keys, the five
    // smaller terms apart from hi hi, added last
    float sm[2][4], s[2][4], pm[2][4], dp[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sm[j][e] = s[j][e] = pm[j][e] = dp[j][e] = 0.f;
#pragma unroll 2  // full unrolling spilled at D 96-128
    for (int kk = 0; kk < KD; ++kk) {
      unsigned a[3][4], bk[3][4];
      take_x3(a, qf, KD, kk);
#pragma unroll
      for (int p = 0; p < 3; ++p) R::bt_frag(bk[p], k_p + p * PL, kr, kk);
      mma_x5(sm[0], sm[1], a, bk);
      mma_bf16(s[0], a[0], bk[0][0], bk[0][1]);
      mma_bf16(s[1], a[0], bk[0][2], bk[0][3]);
      take_x3(a, qf + 3 * KD * 32, KD, kk);
#pragma unroll
      for (int p = 0; p < 3; ++p) R::bt_frag(bk[p], v_p + p * PL, kr, kk);
      mma_x5(pm[0], pm[1], a, bk);
      mma_bf16(dp[0], a[0], bk[0][0], bk[0][1]);
      mma_bf16(dp[1], a[0], bk[0][2], bk[0][3]);
    }
    // ds in fp32 (into s); 0 for a masked, padded or absent pair (tested
    // only where the warp's tile crosses the diagonal or an end)
    const int kt0 = t * XB_WALK + kr;
    const bool edge = kt0 + 16 > Sk || q0 + r0 + 16 > Sq || (causal && kt0 + 15 > q0 + r0);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kt0 + 8 * j + 2 * tq + (e & 1), r = e < 2 ? qr0 : qr1;
        float p = exp2_approx(fmaf(sm[j][e] + s[j][e], sl, -(e < 2 ? ls0 : ls1)));
        if (edge && !(r < Sq && c < Sk && (!causal || c <= r))) p = 0.f;
        s[j][e] = p * ((pm[j][e] + dp[j][e]) - (e < 2 ? dl0 : dl1)) * scale;
      }
    // dQ += dS K: all three terms of each
    unsigned ga[3][4];
    a_from_c3(s[0], s[1], ga[0], ga[1], ga[2]);
#pragma unroll
    for (int i = 0; i < DT; i += 2) {
      unsigned bk[3][4];
#pragma unroll
      for (int p = 0; p < 3; ++p) R::b_frag(bk[p], k_p + p * PL, kr, 8 * i);
      mma_x6_add(acc[i], acc[i + 1], ga, bk);
    }
  }
  cp_async_wait<0>();

  if (!fold_pair(acc, reinterpret_cast<float4*>(tc_smem))) return;
  float* d0 = dq + (((long long)b * Sq + qr0) * Hq + h) * D + 2 * tq;
  float* d1 = d0 + 8 * qs;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    if (qr0 < Sq) *reinterpret_cast<float2*>(d0 + 8 * i) = make_float2(acc[i][0], acc[i][1]);
    if (qr1 < Sq) *reinterpret_cast<float2*>(d1 + 8 * i) = make_float2(acc[i][2], acc[i][3]);
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
  auto dkdv = flash_bwd_dkdv_x3_kernel<D>;
  auto dqk = flash_bwd_dq_x3_kernel<D>;
  const size_t smem = x3_bwd_smem<D>();
  cudaError_t e = set_smem_once(dkdv, smem, set_dkdv);
  if (e == cudaSuccess) e = set_smem_once(dqk, smem, set_dq);
  if (e == cudaSuccess) e = launch_delta(out, dout, delta, B, Sq, Hq, D, stream);
  if (e != cudaSuccess) return e;
  const int G = Hq / Hkv;
  dkdv<<<dim3((Sk + XB_FIX - 1) / XB_FIX, Hq, B), XB_THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, part, Sq, Sk, Hq, Hkv, causal, scale);
  e = cudaGetLastError();
  if (e == cudaSuccess && G > 1) e = launch_combine(part, dk, dv, B, Sk, Hkv, D, G, stream);
  if (e != cudaSuccess) return e;
  dqk<<<dim3((Sq + XB_FIX - 1) / XB_FIX, Hq, B), XB_THREADS, smem, stream>>>(
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
