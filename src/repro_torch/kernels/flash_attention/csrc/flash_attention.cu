// Causal GQA flash attention, forward, fp32, sm_90a.
//
// Replaces flash_attention_pallas (_flash_kernel :27, pallas_call :86) of
// src/repro/kernels/flash_attention/flash_attention.py, the direct-mode
// prefill of the serving path (src/repro/models/attention.py:89-93).
//
// One block per (query tile of 64 rows, query head h, batch b); the KV head is
// h / (Hq / Hkv). The block stages its Q tile once and loops over 64-column
// K/V tiles in shared memory up to the causal limit (tiles wholly above the
// diagonal contribute exactly nothing, since every row already holds column
// 0, so they are skipped). Each warp owns 8 query rows and keeps their running
// max m, sum l and output accumulator acc in fp32 registers (a lane owns
// ceil(D/32) output dims); scores are fp32 with the same finite NEG_INF = -1e30 for the
// causal mask and for the ragged edge: the last Q and K/V tiles are masked,
// not assumed to divide the sequence. The last step divides by max(l, 1e-30).
//   Bound on this card: at the prefill lengths of the serving path the work is
//   2*2*D flops per visible (query, key) pair against 4 bytes per element of
//   q, k, v and out, which is above the fp32 ridge for S >~ 64, so the bound
//   is the fp32 rate. This first version does the products on CUDA cores
//   (no wgmma / TF32, since the path holds fp32 at full precision).
#include "common.cuh"

namespace {

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_WARPS = 8;
constexpr int FA_THREADS = FA_WARPS * 32;
constexpr int FA_ROWS_PER_WARP = FA_BQ / FA_WARPS;

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int Sq, int Sk,
                           int Hq, int Hkv, int causal, float sm_scale) {
  constexpr int DL = (D + 31) / 32;  // output dims per lane (lanes past D idle)
  constexpr int QS = D + 1;  // padded row stride: conflict-free column reads
  const int q0 = blockIdx.x * FA_BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int rows = min(Sq - q0, FA_BQ);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ float smem[];
  float* q_s = smem;              // BQ x QS
  float* k_s = q_s + FA_BQ * QS;  // BK x QS
  float* v_s = k_s + FA_BK * QS;  // BK x D
  float* s_s = v_s + FA_BK * D;   // BQ x BK: scores, then probabilities

  for (int idx = threadIdx.x; idx < rows * D; idx += FA_THREADS) {
    const int r = idx / D, d = idx % D;
    q_s[r * QS + d] = q[(((size_t)b * Sq + q0 + r) * Hq + h) * D + d];
  }

  float m[FA_ROWS_PER_WARP], l[FA_ROWS_PER_WARP], acc[FA_ROWS_PER_WARP][DL];
#pragma unroll
  for (int i = 0; i < FA_ROWS_PER_WARP; ++i) {
    m[i] = REPRO_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DL; ++kk) acc[i][kk] = 0.f;
  }

  int n_k = (Sk + FA_BK - 1) / FA_BK;
  if (causal) n_k = min(n_k, (q0 + rows - 1) / FA_BK + 1);

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * FA_BK;
    const int cols = min(Sk - k0, FA_BK);
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < FA_BK * D; idx += FA_THREADS) {
      const int t = idx / D, d = idx % D;
      const size_t src = (((size_t)b * Sk + k0 + t) * Hkv + hk) * D + d;
      k_s[t * QS + d] = t < cols ? k[src] : 0.f;
      v_s[t * D + d] = t < cols ? v[src] : 0.f;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < rows * FA_BK; e += FA_THREADS) {
      const int r = e / FA_BK, col = e % FA_BK;
      const float* qr = q_s + r * QS;
      const float* kr = k_s + col * QS;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const bool visible = col < cols && (!causal || q0 + r >= k0 + col);
      s_s[r * FA_BK + col] = visible ? dot * sm_scale : REPRO_NEG_INF;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < FA_ROWS_PER_WARP; ++i) {
      const int r = warp + FA_WARPS * i;
      if (r < rows) {  // warp-uniform
        float* sr = s_s + r * FA_BK;
        float mx = REPRO_NEG_INF;
        for (int col = lane; col < FA_BK; col += 32) mx = fmaxf(mx, sr[col]);
        const float m_new = fmaxf(m[i], warp_max(mx));
        float ps = 0.f;
        for (int col = lane; col < FA_BK; col += 32) {
          const float p = expf(sr[col] - m_new);
          sr[col] = p;
          ps += p;
        }
        const float alpha = expf(m[i] - m_new);
        l[i] = alpha * l[i] + warp_sum(ps);
        m[i] = m_new;
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < DL; ++kk) {
          const int d = lane + 32 * kk;
          if (d < D) {
            float a = acc[i][kk] * alpha;
#pragma unroll 8
            for (int col = 0; col < FA_BK; ++col) a = fmaf(sr[col], v_s[col * D + d], a);
            acc[i][kk] = a;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < FA_ROWS_PER_WARP; ++i) {
    const int r = warp + FA_WARPS * i;
    if (r < rows) {
      float* o = out + (((size_t)b * Sq + q0 + r) * Hq + h) * D;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int kk = 0; kk < DL; ++kk)
        if (lane + 32 * kk < D) o[lane + 32 * kk] = acc[i][kk] * inv;
    }
  }
}

template <int D>
cudaError_t launch_flash(const float* q, const float* k, const float* v, float* out, int B,
                         int Sq, int Sk, int Hq, int Hkv, int causal, float sm_scale,
                         cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(FA_BQ + FA_BK) * (D + 1) + (size_t)FA_BK * D + FA_BQ * FA_BK);
  auto kern = flash_attention_fwd_kernel<D>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + FA_BQ - 1) / FA_BQ, Hq, B);
  kern<<<grid, FA_THREADS, smem, stream>>>(q, k, v, out, Sq, Sk, Hq, Hkv, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D); out (B, Sq, Hq, D). fp32, contiguous.
REPRO_API int flash_attention_fwd_f32(const float* q, const float* k, const float* v,
                                      float* out, int B, int Sq, int Sk, int Hq, int Hkv,
                                      int D, int causal, float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_flash<16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, sm_scale, stream);
    case 32:
      return launch_flash<32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, sm_scale, stream);
    case 64:
      return launch_flash<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, sm_scale, stream);
    case 112:  // zamba2-7b's shared block (103 KB of shared memory)
      return launch_flash<112>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, sm_scale, stream);
    case 128:
      return launch_flash<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
