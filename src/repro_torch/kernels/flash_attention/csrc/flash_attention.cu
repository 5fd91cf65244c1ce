// Causal GQA flash attention, forward, fp32 or bf16, sm_90a.
//
// Replaces flash_attention_pallas (_flash_kernel :27, pallas_call :86) of
// src/repro/kernels/flash_attention/flash_attention.py, the direct-mode
// prefill of the serving path (src/repro/models/attention.py:89-93).
//
// One block per (query tile, query head h, batch b); the KV head is
// h / (Hq / Hkv). The query tile follows Sq: 32 rows up to Sq 32 (the
// serving prefills: qwen2.5-3b and zamba2-7b at prompt 32), 64 beyond. The
// block stages its Q tile once and walks 32-column K/V tiles up to the
// causal limit (tiles wholly above the diagonal add exactly nothing, since
// every row already holds column 0), each through the online-softmax step
// shared with paged attention (csrc/attn_tile.cuh): register-blocked score
// micro-tiles read with 16-byte shared loads, the row max and sum by
// shuffles, and a P.V update in which a row's D outputs are D/4 lanes x 4
// contiguous dims (20 lanes at d_head 80, 24 at 96, 28 at 112: the rest of
// each warp idles in that step). The loops stop at the tile's
// real column count; the ragged last tiles are masked, not assumed to
// divide the sequence. NEG_INF is the same finite -1e30; the last step
// divides by max(l, 1e-30). Tiles are staged with 16-byte cp.async, single
// buffered: 49 KB of shared memory at d_head 112 with a 32-row tile (68 KB
// with 64 rows), so 4 (3) blocks fit an SM.
//   Bound on this card: at the serving prefills (S 32) the work is 2*2*D
//   flops per visible (query, key) pair against 4 bytes per element of q,
//   k, v and out: bound by bytes (0.0007 ms for qwen2.5-3b, 0.0022 for
//   zamba2-7b), and one wave of 64 or 128 blocks. At S 32 the cost is
//   work spent on padding and idle lanes, so the tiles follow the sequence
//   (32 x 32, not 64 x 64, which would do 4x the products) and d_head 112
//   maps onto 28 lanes. The products stay fp32 on CUDA cores (no wgmma /
//   TF32: the path holds fp32 at full precision).
// bf16 (flash_attention_fwd_bf16): q, k, v and out in bf16, as the Pallas
// kernel takes any float type, upcasts its tiles and computes in f32
// (flash_attention.py:39-41) and writes q's type (:61). The tiles widen
// bf16 to fp32 as they stage (csrc/attn_tile.cuh); the math is the fp32
// kernel's, and each output is rounded once from f32, to nearest even
// (__floats2bfloat162_rn). Half the bytes of q, k, v and out: the bound at
// S 32 halves (0.0004 ms at d_head 128).
// The training forward (flash_attention_fwd_lse_{f32,bf16}, the template's
// LSE flag): the same kernel also writes each row's log-sum-exp, lse (B, Hq,
// Sq) fp32 = m + log(max(l, 1e-30)), as _fwd ends (src/repro/kernels/
// flash_attention/blocked.py:89), for the backward kernel
// (flash_attention_bwd.cu). At qwen2.5-3b's training shape (B 1, S 4096,
// 16 heads, causal) it is 4 S^2 D / 2 flops a head, 6.9e10: 1.0 ms at the
// fp32 rate, against 0.05 ms of bytes, so bound by operations. The serving
// entries instantiate LSE false: their code is unchanged.
#include "attn_tile.cuh"

namespace {

template <int D, int ROWS>
using FlashTile = AttnTile<D, ROWS, 1>;

template <class T, int D, int ROWS, bool LSE>
__global__ void __launch_bounds__(ATTN_THREADS)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int causal,
                           float sm_scale) {
  extern __shared__ float4 attn_smem[];
  FlashTile<D, ROWS> tile(reinterpret_cast<float*>(attn_smem));
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int rows = min(Sq - q0, ROWS);

  int ntiles = (Sk + ATTN_COLS - 1) / ATTN_COLS;
  if (causal) ntiles = min(ntiles, (q0 + rows - 1) / ATTN_COLS + 1);

  FlashTile<D, ROWS>::stage(tile.q_s, FlashTile<D, ROWS>::KS, q, rows, ROWS, [&](int r) {
    return (((long long)b * Sq + q0 + r) * Hq + h) * D;
  });
  tile.run(
      ntiles,
      [&](int t, int buf) {
        const int k0 = t * ATTN_COLS;
        tile.stage_kv(buf, k, v, min(Sk - k0, ATTN_COLS), [&](int c) {
          return (((long long)b * Sk + k0 + c) * Hkv + hk) * D;
        });
      },
      [&](int t) { return min(Sk - t * ATTN_COLS, ATTN_COLS); },
      [&](int t, int r, int c, float dot) {
        return !causal || q0 + r >= t * ATTN_COLS + c ? dot * sm_scale : REPRO_NEG_INF;
      });

  if (LSE)
    tile.each_ml([&](int r, float m, float l) {
      if (r < rows) lse[((size_t)b * Hq + h) * Sq + q0 + r] = m + logf(fmaxf(l, 1e-30f));
    });
  tile.each_acc([&](int r, int d, float4 a, float l) {
    if (r >= rows) return;
    T* o = out + (((size_t)b * Sq + q0 + r) * Hq + h) * D + d;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    store4(o, make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
  });
}

template <class T, int D, int ROWS, bool LSE>
cudaError_t launch_flash(const T* q, const T* k, const T* v, T* out, float* lse, int B, int Sq,
                         int Sk, int Hq, int Hkv, int causal, float sm_scale,
                         cudaStream_t stream) {
  static unsigned long long smem_set = 0;
  auto kern = flash_attention_fwd_kernel<T, D, ROWS, LSE>;
  const size_t smem = FlashTile<D, ROWS>::BYTES;
  cudaError_t e = set_smem_once(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + ROWS - 1) / ROWS, Hq, B);
  kern<<<grid, ATTN_THREADS, smem, stream>>>(q, k, v, out, lse, Sq, Sk, Hq, Hkv, causal,
                                              sm_scale);
  return cudaGetLastError();
}

template <class T, int D, bool LSE>
cudaError_t launch_flash_rows(const T* q, const T* k, const T* v, T* out, float* lse, int B,
                              int Sq, int Sk, int Hq, int Hkv, int causal, float sm_scale,
                              cudaStream_t stream) {
  if (Sq <= 32)
    return launch_flash<T, D, 32, LSE>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, causal, sm_scale,
                                       stream);
  return launch_flash<T, D, 64, LSE>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, causal, sm_scale,
                                     stream);
}

template <class T, bool LSE>
int flash_fwd(const T* q, const T* k, const T* v, T* out, float* lse, int B, int Sq, int Sk,
              int Hq, int Hkv, int D, int causal, float sm_scale, cudaStream_t stream) {
#define REPRO_FLASH_CASE(DD)                                                                    \
  case DD:                                                                                      \
    return launch_flash_rows<T, DD, LSE>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, causal, sm_scale, \
                                         stream);
  switch (D) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(80)   // stablelm-3b, hubert-xlarge
    REPRO_FLASH_CASE(96)   // phi3-mini-3.8b
    REPRO_FLASH_CASE(112)  // zamba2-7b's shared block
    REPRO_FLASH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
}

}  // namespace

// q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D); out (B, Sq, Hq, D). fp32, contiguous,
// 16-byte aligned.
REPRO_API int flash_attention_fwd_f32(const float* q, const float* k, const float* v,
                                      float* out, int B, int Sq, int Sk, int Hq, int Hkv,
                                      int D, int causal, float sm_scale, cudaStream_t stream) {
  return flash_fwd<float, false>(q, k, v, out, nullptr, B, Sq, Sk, Hq, Hkv, D, causal, sm_scale,
                                 stream);
}

// The same in bf16 (q, k, v and out); the math in fp32, the output rounded
// once to nearest even.
REPRO_API int flash_attention_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, __nv_bfloat16* out, int B, int Sq,
                                       int Sk, int Hq, int Hkv, int D, int causal,
                                       float sm_scale, cudaStream_t stream) {
  return flash_fwd<__nv_bfloat16, false>(q, k, v, out, nullptr, B, Sq, Sk, Hq, Hkv, D, causal,
                                         sm_scale, stream);
}

// The training forward: the same, and lse (B, Hq, Sq) fp32.
REPRO_API int flash_attention_fwd_lse_f32(const float* q, const float* k, const float* v,
                                          float* out, float* lse, int B, int Sq, int Sk, int Hq,
                                          int Hkv, int D, int causal, float sm_scale,
                                          cudaStream_t stream) {
  return flash_fwd<float, true>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal, sm_scale,
                                stream);
}

REPRO_API int flash_attention_fwd_lse_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                           const __nv_bfloat16* v, __nv_bfloat16* out, float* lse,
                                           int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                           int causal, float sm_scale, cudaStream_t stream) {
  return flash_fwd<__nv_bfloat16, true>(q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, D, causal,
                                        sm_scale, stream);
}
