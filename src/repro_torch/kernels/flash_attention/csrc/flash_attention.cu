// Causal or bidirectional GQA flash attention, forward, fp32 or bf16,
// sm_90a, on the tensor cores.
//
// Replaces flash_attention_pallas (_flash_kernel :27, pallas_call :86) of
// src/repro/kernels/flash_attention/flash_attention.py, the direct-mode
// prefill of the serving path (src/repro/models/attention.py:89-93), and
// JAX's training forward _fwd (src/repro/kernels/flash_attention/
// blocked.py:57), which also keeps each row's log-sum-exp, lse (B, Hq, Sq)
// fp32 = m + log(max(l, 1e-30)) (:89), for the backward kernel
// (flash_attention_bwd.cu).
//
// One kernel a dtype, serving and training alike: flash_fwd_lse_tc_kernel
// (bf16) and flash_fwd_lse_x3_kernel (fp32). The serving entries
// (flash_attention_fwd_{f32,bf16}) pass no lse, and the kernel skips its
// store (a branch on a kernel argument: the same way for every thread);
// the training entries (flash_attention_fwd_lse_{f32,bf16}) pass one. The
// Pallas kernel takes any float type, upcasts its tiles, computes in f32
// and writes q's type (flash_attention.py:39-41, :61): here the sums are
// fp32 and each output is rounded once (bf16 to nearest even).
//
// Bound on this card (operations: 4 D flops a visible (query, key) pair; bytes:
// q, k, v and out once):
//   the serving prefills (B 4, S 32): bytes, 0.0007 ms fp32 and 0.0004 bf16
//   at qwen2.5-3b's heads, 0.0022 / 0.0011 at zamba2-7b's; one wave of Hq B
//   blocks, whose cost is the launch. A block has 64 query rows (bf16) or
//   128 (fp32), so at Sq 32 two of its four warps (six of eight) compute on
//   q rows zero-filled past Sq and store nothing.
//   qwen2.5-3b's prefill_32k (B 15, S 32768, 16/2 heads, d_head 128, causal,
//   bf16): 6.6e13 flops, 66.7 ms at the tensor cores' 989 TFLOP/s; the
//   split below doubles the products, a floor of 133 ms. zamba2-7b's (B 5,
//   32/32 heads, d_head 112): 38.9 ms, the floor 77.8.
//   qwen2.5-3b's training silo (B 1, S 4096, causal): 6.9e10 flops, 0.07 ms
//   in bf16 (the floor 0.139), 1.03 ms at the fp32 rate.
// Why the split stays at serving shapes: the serving gates are the training
// gates (fp32 within 1e-5 of the plain version, bf16 one ulp past that),
// and P as one bf16 term keeps only 2^-9 of it.
//
// bf16 (flash_fwd_lse_tc_kernel, on csrc/mma_tile.cuh): a block of 4 warps
// takes 64 query rows of one (head, batch), 16 rows a warp, heaviest query
// tiles first; Q's fragments stay in registers. K and V tiles of 64 keys stay
// bf16 in shared memory (row stride D + 8: no ldmatrix bank conflicts),
// double-buffered by cp.async (rows past Sk zero-filled). S = QK^T by
// mma.sync m16n8k16 (bf16 in, fp32 accumulate: exact products of the bf16
// inputs); the online softmax runs on the accumulator fragments (a row's max
// and sum over its quad by shuffles; base-2 SFU exponentials with the scale
// folded into one FMA, m kept in those units and lse = m ln 2 + log l; a
// masked or absent column is -inf, so p = 0, tested only in tiles that cross
// the diagonal or the end of the keys); P goes from the accumulator straight
// into A fragments as three bf16 terms (split3: hi + mid + lo == p) and O +=
// P_hi V + P_mid V + P_lo V, V by ldmatrix.trans. Tiles wholly above the
// diagonal are skipped. So the split costs two more products: 4 S x S x D
// units of work against the function's 2, a floor of 0.139 ms at the silo
// shape. P as two terms (hi and lo, 2^-16 of p: 3 units) was 1.15-1.2x faster
// and within the kernel gates, but 1.48-1.51e-3 of its outputs rounded to
// another bf16 than the plain version's, against 1.35-1.57e-4 with three
// terms, and 36 layers of random weights carried that to 0.1016 between the
// logits of serving's wave mode, which prefills through this kernel, and its
// continuous mode, which prefills through paged attention's three-term
// kernel: past the modes' 0.1 gate (chip_smoke.py phase 23, H100 80GB HBM3,
// 700 W). Occupancy bounds it (a warp's softmax leaves the tensor pipe to the
// SM's other warps): Q stages in the second K/V buffer and moves to registers
// before tile 1 is copied there, so shared memory is 4 x 64 rows of D + 8
// bf16 (70 KB at D 128), and __launch_bounds__ asks for three blocks (12
// warps) an SM: 168 registers a thread (the O accumulator D/2, Q's fragments
// D/4, the scores 32), with 16-56 bytes of stack at D 96-128 (with two terms,
// 1.09x faster at the silo shape than two blocks at 189 registers, H100 80GB
// HBM3, 700 W: tools/time_flash_pair.py).
//
// fp32 (flash_fwd_lse_x3_kernel): every fp32 operand enters as three bf16
// terms (csrc/mma_tile.cuh's split3, hi + mid + lo == x), and a product as
// the six term products above 2^-24 of it, smallest first (mma_x5,
// mma_x6_add): 6 mma where bf16 takes 1, so 12 S x S x D units of work at
// bf16's rate, a floor of 0.42 ms at the silo shape (under the 1.03 ms fp32
// bound). A block of 8 warps takes 128 query rows, heaviest first. q is split
// once, as the warp's A fragments: hi stays in registers, mid and lo in the
// warp's own shared slots (three terms in registers would be 96 a thread at D
// 128). K and V come in tiles of 16 keys: staged in fp32 by cp.async while
// the previous tile computes, then split once a block into three bf16 planes
// each (row stride D + 8), which ldmatrix reads as in the bf16 kernel. S
// keeps its five smaller terms and hi hi in separate accumulators (hi hi
// added last); P leaves the accumulators as three terms (a_from_c3), and each
// tile's P V is summed from zero and added to O outside the tensor cores
// (mma_x6_add). 255 registers at D 128 allow one block of 8 warps an SM;
// shared memory: 64 KB of q's terms, 26 KB of planes, 16 KB of staging. (Two
// blocks of 4 warps and 64 rows, as the bf16 kernel, were 3.5-7% slower: the
// split and its barriers are shared by twice the rows here;
// tools/time_flash_pair.py, H100 80GB HBM3, 700 W.)
#include "mma_tile.cuh"

namespace {

constexpr int TC_THREADS = 128;  // 4 warps, 16 query rows each
constexpr int TC_ROWS = 64;      // query rows a block
constexpr int TC_COLS = 64;      // keys a tile

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 3)
flash_fwd_lse_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int causal,
                        float scale) {
  using R = TcRows<D>;
  constexpr int ST = R::ST, NT = TC_COLS / 8, DT = D / 8, KD = D / 16;
  extern __shared__ uint4 tc_smem[];
  // buffer i: k, then v, at 2 i TC_COLS rows; q stages in buffer 1's k
  // rows, free again once its fragments are in registers
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* q_s = kv_s + 2 * TC_COLS * ST;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv), rows = min(Sq - q0, TC_ROWS);
  int ntiles = (Sk + TC_COLS - 1) / TC_COLS;
  if (causal) ntiles = min(ntiles, (q0 + rows - 1) / TC_COLS + 1);
  const long long qs = (long long)Hq * D, ks = (long long)Hkv * D;
  const __nv_bfloat16* kg = k + ((long long)b * Sk * Hkv + hk) * D;
  const __nv_bfloat16* vg = v + ((long long)b * Sk * Hkv + hk) * D;
  auto stage = [&](int t, int buf) {
    const int k0 = t * TC_COLS, n = min(Sk - k0, TC_COLS);
    __nv_bfloat16* kd = kv_s + buf * 2 * TC_COLS * ST;
    R::template load<TC_COLS, TC_THREADS>(kd, kg + k0 * ks, ks, n);
    R::template load<TC_COLS, TC_THREADS>(kd + TC_COLS * ST, vg + k0 * ks, ks, n);
  };
  R::template load<TC_ROWS, TC_THREADS>(q_s, q + (((long long)b * Sq + q0) * Hq + h) * D, qs,
                                        rows);
  stage(0, 0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, tq = lane & 3;
  const int r0 = 16 * warp, qr0 = q0 + r0 + (lane >> 2), qr1 = qr0 + 8;
  unsigned qf[KD][4];
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) R::a_frag(qf[kk], q_s, r0, kk);
  __syncthreads();  // q's rows are free for tile 1
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = REPRO_NEG_INF, m1 = REPRO_NEG_INF, l0 = 0.f, l1 = 0.f;  // rows qr0, qr1
  const float sl = scale * TC_LOG2E;

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) stage(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* k_s = kv_s + buf * 2 * TC_COLS * ST;
    const __nv_bfloat16* v_s = k_s + TC_COLS * ST;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned kb[4];
        R::bt_frag(kb, k_s, 8 * j, kk);
        mma_bf16(s[j], qf[kk], kb[0], kb[1]);
        mma_bf16(s[j + 1], qf[kk], kb[2], kb[3]);
      }

    // mask (only where the tile crosses the diagonal or the end of the
    // keys: the branch is the warp's); each row's max over its quad
    const int k0 = t * TC_COLS;
    if (k0 + TC_COLS > Sk || (causal && k0 + TC_COLS - 1 > q0 + r0))
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = k0 + 8 * j + 2 * tq + (e & 1), r = e < 2 ? qr0 : qr1;
          if (c >= Sk || (causal && c > r)) s[j][e] = -INFINITY;
        }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    // m in base-2 units of the scaled scores; finite: it starts at NEG_INF
    const float mn0 = fmaxf(m0, mx0 * sl), mn1 = fmaxf(m1, mx1 * sl);
    const float a0 = exp2_approx(m0 - mn0), a1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2_approx(fmaf(s[j][0], sl, -mn0));  // 2^-inf = 0
      s[j][1] = exp2_approx(fmaf(s[j][1], sl, -mn0));
      s[j][2] = exp2_approx(fmaf(s[j][2], sl, -mn1));
      s[j][3] = exp2_approx(fmaf(s[j][3], sl, -mn1));
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = a0 * l0 + ps0;  // this thread's columns; the quad's sum at the end
    l1 = a1 * l1 + ps1;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      acc[i][0] *= a0;
      acc[i][1] *= a0;
      acc[i][2] *= a1;
      acc[i][3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      unsigned pa[3][4];
      a_from_c3(s[j], s[j + 1], pa[0], pa[1], pa[2]);
#pragma unroll
      for (int i = 0; i < DT; i += 2) {
        unsigned vb[4];
        R::b_frag(vb, v_s, 8 * j, 8 * i);
#pragma unroll
        for (int u = 0; u < 3; ++u) {  // hi first
          mma_bf16(acc[i], pa[u], vb[0], vb[1]);
          mma_bf16(acc[i + 1], pa[u], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // this tile's buffers are consumed
  }
  cp_async_wait<0>();

#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const long long lrow = ((long long)b * Hq + h) * Sq;
  if (lse && tq == 0) {  // the training forward's; serving passes none
    if (qr0 < Sq) lse[lrow + qr0] = m0 * TC_LN2 + logf(fmaxf(l0, 1e-30f));
    if (qr1 < Sq) lse[lrow + qr1] = m1 * TC_LN2 + logf(fmaxf(l1, 1e-30f));
  }
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* o0 = out + (((long long)b * Sq + qr0) * Hq + h) * D + 2 * tq;
  __nv_bfloat16* o1 = o0 + 8 * qs;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    if (qr0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * i) =
          __floats2bfloat162_rn(acc[i][0] * i0, acc[i][1] * i0);
    if (qr1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * i) =
          __floats2bfloat162_rn(acc[i][2] * i1, acc[i][3] * i1);
  }
}

template <int D>
cudaError_t launch_fwd_lse_tc(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, __nv_bfloat16* out, float* lse, int B,
                              int Sq, int Sk, int Hq, int Hkv, int causal, float scale,
                              cudaStream_t stream) {
  static unsigned long long smem_set = 0;
  auto kern = flash_fwd_lse_tc_kernel<D>;
  static_assert(TC_ROWS <= TC_COLS, "q stages in a k buffer");
  const size_t smem = sizeof(__nv_bfloat16) * 4 * TC_COLS * TcRows<D>::ST;
  cudaError_t e = set_smem_once(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + TC_ROWS - 1) / TC_ROWS, Hq, B);
  kern<<<grid, TC_THREADS, smem, stream>>>(q, k, v, out, lse, Sq, Sk, Hq, Hkv, causal, scale);
  return cudaGetLastError();
}

int flash_fwd_lse_tc(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                     __nv_bfloat16* out, float* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                     int D, int causal, float scale, cudaStream_t stream) {
#define REPRO_FLASH_TC_CASE(DD) \
  case DD:                      \
    return launch_fwd_lse_tc<DD>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, causal, scale, stream);
  switch (D) {
    REPRO_FLASH_TC_CASE(16)
    REPRO_FLASH_TC_CASE(32)
    REPRO_FLASH_TC_CASE(64)
    REPRO_FLASH_TC_CASE(80)
    REPRO_FLASH_TC_CASE(96)
    REPRO_FLASH_TC_CASE(112)
    REPRO_FLASH_TC_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_TC_CASE
}

// ---------------------------------------------------------- fp32 training

constexpr int X3_KEYS = 16;         // the fp32 lse forward's key tile
constexpr int X3_WARPS = 8;         // 16 query rows each
constexpr int X3_THREADS = 32 * X3_WARPS;
constexpr int X3_ROWS = 16 * X3_WARPS;
constexpr int X3_BLOCKS = 1;        // an SM, for the launch bounds

template <int D>
constexpr size_t x3_fwd_smem() {
  // q's mid and lo fragments, k's and v's planes, their fp32 staging
  return sizeof(uint4) * X3_WARPS * 2 * (D / 16) * 32 +
         sizeof(__nv_bfloat16) * 6 * X3_KEYS * TcRows<D>::ST + sizeof(float) * 2 * X3_KEYS * D;
}

template <int D>
__global__ void __launch_bounds__(X3_THREADS, X3_BLOCKS)
flash_fwd_lse_x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int causal,
                        float scale) {
  using R = TcRows<D>;
  using X = X3Rows<D>;
  constexpr int ST = R::ST, DT = D / 8, KD = D / 16, PL = X3_KEYS * ST;
  extern __shared__ uint4 tc_smem[];
  // a warp's own q fragments, mid then lo: [warp][term][kk][lane]
  uint4* qf_s = tc_smem;
  // k's planes hi, mid, lo, then v's (X3_KEYS rows each), then k and v in
  // fp32 as they are staged
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(tc_smem + X3_WARPS * 2 * KD * 32);
  float* stg = reinterpret_cast<float*>(kv_s + 6 * PL);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * X3_ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv), rows = min(Sq - q0, X3_ROWS);
  int ntiles = (Sk + X3_KEYS - 1) / X3_KEYS;
  if (causal) ntiles = min(ntiles, (q0 + rows - 1) / X3_KEYS + 1);
  const long long qs = (long long)Hq * D, ks = (long long)Hkv * D;
  const float* kg = k + ((long long)b * Sk * Hkv + hk) * D;
  const float* vg = v + ((long long)b * Sk * Hkv + hk) * D;
  auto stage = [&](int t) {
    const int k0 = t * X3_KEYS, n = min(Sk - k0, X3_KEYS);
    X::template load<X3_KEYS, X3_THREADS>(stg, kg + k0 * ks, ks, n);
    X::template load<X3_KEYS, X3_THREADS>(stg + X3_KEYS * D, vg + k0 * ks, ks, n);
  };
  stage(0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, tq = lane & 3;
  const int r0 = 16 * warp, qr0 = q0 + r0 + (lane >> 2), qr1 = qr0 + 8;
  // q split once: hi in registers, mid and lo in the warp's shared slots
  uint4* qf = qf_s + warp * 2 * KD * 32 + lane;
  unsigned qh[KD][4];
  {
    const float* qg = q + (((long long)b * Sq + q0 + r0) * Hq + h) * D;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned a[3][4];
      a_frag_x3(a, qg, qs, rows - r0, kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) qh[kk][i] = a[0][i];
      qf[kk * 32] = pack4(a[1]);
      qf[(KD + kk) * 32] = pack4(a[2]);
    }
  }
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = REPRO_NEG_INF, m1 = REPRO_NEG_INF, l0 = 0.f, l1 = 0.f;  // rows qr0, qr1
  const float sl = scale * TC_LOG2E;
  const __nv_bfloat16* k_p = kv_s;
  const __nv_bfloat16* v_p = kv_s + 3 * PL;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t staged; tile t - 1's planes consumed
    X::template split<X3_KEYS, X3_THREADS>(kv_s, stg);
    X::template split<X3_KEYS, X3_THREADS>(kv_s + 3 * PL, stg + X3_KEYS * D);
    __syncthreads();  // the planes are whole; the staging is free
    if (t + 1 < ntiles) stage(t + 1);
    cp_async_commit();

    // S = Q K^T over the tile's 16 keys (two n-tiles): the five smaller
    // terms in sm, hi hi apart in s, added last
    float sm[2][4], s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sm[j][e] = s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned a[3][4], kb[3][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[0][i] = qh[kk][i];
      unpack4(a[1], qf[kk * 32]);
      unpack4(a[2], qf[(KD + kk) * 32]);
#pragma unroll
      for (int p = 0; p < 3; ++p) R::bt_frag(kb[p], k_p + p * PL, 0, kk);
      mma_x5(sm[0], sm[1], a, kb);
      mma_bf16(s[0], a[0], kb[0][0], kb[0][1]);
      mma_bf16(s[1], a[0], kb[0][2], kb[0][3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sm[j][e] + s[j][e];

    // mask (only where the tile crosses the diagonal or the end of the
    // keys); each row's max over its quad
    const int k0 = t * X3_KEYS;
    if (k0 + X3_KEYS > Sk || (causal && k0 + X3_KEYS - 1 > q0 + r0))
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = k0 + 8 * j + 2 * tq + (e & 1), r = e < 2 ? qr0 : qr1;
          if (c >= Sk || (causal && c > r)) s[j][e] = -INFINITY;
        }
    float mx0 = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
    float mx1 = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0 * sl), mn1 = fmaxf(m1, mx1 * sl);
    const float a0 = exp2_approx(m0 - mn0), a1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j][0] = exp2_approx(fmaf(s[j][0], sl, -mn0));
      s[j][1] = exp2_approx(fmaf(s[j][1], sl, -mn0));
      s[j][2] = exp2_approx(fmaf(s[j][2], sl, -mn1));
      s[j][3] = exp2_approx(fmaf(s[j][3], sl, -mn1));
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = a0 * l0 + ps0;
    l1 = a1 * l1 + ps1;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      acc[i][0] *= a0;
      acc[i][1] *= a0;
      acc[i][2] *= a1;
      acc[i][3] *= a1;
    }
    // O += P V, P and V as three terms each
    unsigned pa[3][4];
    a_from_c3(s[0], s[1], pa[0], pa[1], pa[2]);
#pragma unroll
    for (int i = 0; i < DT; i += 2) {
      unsigned vb[3][4];
#pragma unroll
      for (int p = 0; p < 3; ++p) R::b_frag(vb[p], v_p + p * PL, 0, 8 * i);
      mma_x6_add(acc[i], acc[i + 1], pa, vb);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const long long lrow = ((long long)b * Hq + h) * Sq;
  if (lse && tq == 0) {  // the training forward's; serving passes none
    if (qr0 < Sq) lse[lrow + qr0] = m0 * TC_LN2 + logf(fmaxf(l0, 1e-30f));
    if (qr1 < Sq) lse[lrow + qr1] = m1 * TC_LN2 + logf(fmaxf(l1, 1e-30f));
  }
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  float* o0 = out + (((long long)b * Sq + qr0) * Hq + h) * D + 2 * tq;
  float* o1 = o0 + 8 * qs;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    if (qr0 < Sq)
      *reinterpret_cast<float2*>(o0 + 8 * i) = make_float2(acc[i][0] * i0, acc[i][1] * i0);
    if (qr1 < Sq)
      *reinterpret_cast<float2*>(o1 + 8 * i) = make_float2(acc[i][2] * i1, acc[i][3] * i1);
  }
}

template <int D>
cudaError_t launch_fwd_lse_x3(const float* q, const float* k, const float* v, float* out,
                              float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                              float scale, cudaStream_t stream) {
  static unsigned long long smem_set = 0;
  auto kern = flash_fwd_lse_x3_kernel<D>;
  const size_t smem = x3_fwd_smem<D>();
  cudaError_t e = set_smem_once(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + X3_ROWS - 1) / X3_ROWS, Hq, B);
  kern<<<grid, X3_THREADS, smem, stream>>>(q, k, v, out, lse, Sq, Sk, Hq, Hkv, causal, scale);
  return cudaGetLastError();
}

int flash_fwd_lse_x3(const float* q, const float* k, const float* v, float* out, float* lse,
                     int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal, float scale,
                     cudaStream_t stream) {
#define REPRO_FLASH_X3_CASE(DD) \
  case DD:                      \
    return launch_fwd_lse_x3<DD>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, causal, scale, stream);
  switch (D) {
    REPRO_FLASH_X3_CASE(16)
    REPRO_FLASH_X3_CASE(32)
    REPRO_FLASH_X3_CASE(64)
    REPRO_FLASH_X3_CASE(80)
    REPRO_FLASH_X3_CASE(96)
    REPRO_FLASH_X3_CASE(112)
    REPRO_FLASH_X3_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_X3_CASE
}

}  // namespace

// The serving forward: q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D); out (B, Sq,
// Hq, D). fp32, contiguous, 16-byte aligned. The training forward's kernel
// with no lse.
REPRO_API int flash_attention_fwd_f32(const float* q, const float* k, const float* v,
                                      float* out, int B, int Sq, int Sk, int Hq, int Hkv,
                                      int D, int causal, float sm_scale, cudaStream_t stream) {
  return flash_fwd_lse_x3(q, k, v, out, nullptr, B, Sq, Sk, Hq, Hkv, D, causal, sm_scale,
                          stream);
}

// The same in bf16 (q, k, v and out); fp32 sums, the output rounded once to
// nearest even.
REPRO_API int flash_attention_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, __nv_bfloat16* out, int B, int Sq,
                                       int Sk, int Hq, int Hkv, int D, int causal,
                                       float sm_scale, cudaStream_t stream) {
  return flash_fwd_lse_tc(q, k, v, out, nullptr, B, Sq, Sk, Hq, Hkv, D, causal, sm_scale,
                          stream);
}

// The training forward: the same, and lse (B, Hq, Sq) fp32.
REPRO_API int flash_attention_fwd_lse_f32(const float* q, const float* k, const float* v,
                                          float* out, float* lse, int B, int Sq, int Sk, int Hq,
                                          int Hkv, int D, int causal, float sm_scale,
                                          cudaStream_t stream) {
  return flash_fwd_lse_x3(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, sm_scale, stream);
}

REPRO_API int flash_attention_fwd_lse_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                           const __nv_bfloat16* v, __nv_bfloat16* out, float* lse,
                                           int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                           int causal, float sm_scale, cudaStream_t stream) {
  return flash_fwd_lse_tc(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, sm_scale, stream);
}
