// Paged attention, page reset and rollback for confidential serving, fp32,
// sm_90a.
//
// Replaces the TPU kernels of src/repro/kernels/paged_attention/paged_attention.py:
//   paged_attention_pallas (_paged_kernel, :98, pallas_call :142)
//   paged_reset_pallas     (_reset_kernel, :158, pallas_call :223)
//   paged_rollback_pallas  (_rollback_kernel, :163, pallas_call :198)
//
// paged_attention: one block per (slot b, kv head h). The block reads its own
// block-table row tables[b, :] and walks all nP pages of it, staging the page's
// (P, D) K and V tiles of head h in shared memory (stride Hkv*D between tokens
// in the pool). The GQA group is folded onto rows: folded row r is query head
// h*G + r / C at chunk token r % C, as in the TPU kernel's _fold. Each warp
// owns rows r = warp + 8*i and keeps their running max m, sum l and output
// accumulator acc in fp32 registers (a lane owns ceil(D/32) output dims).
//   Isolation: the only pool addresses the block computes are
//   tables[b, j]*P*Hkv*D + t*Hkv*D + h*D + d, so it reads no page that the
//   slot's row does not name (an out-of-range id is skipped, never read).
//   Mask: kvpos = j*P + col is visible to row r iff kvpos <= q_start[b] + r % C
//   (_mask, paged_attention.py:57). Every page is visited, and NEG_INF is the
//   same finite -1e30, so a fully masked row (q_start = -1) is the same finite
//   uniform average as in the plain version; the last step divides by
//   max(l, 1e-30).
//   Bound on this card: reading each named page's K and V once. Decode
//   (C = 1, G*C = 8 rows) does 2*8 flops per K/V element, far below the
//   fp32 ridge, so it is bound by bytes; a C = 16 chunk (128 rows) does 16x
//   more, which puts it above the ridge of the fp32 (CUDA core) rate. This
//   first version stages K/V in shared memory once per page for all rows and
//   does the products on CUDA cores; with only B*Hkv blocks it leaves most SMs
//   idle at small batch (splitting the page loop across blocks is later work).
//
// paged_reset: one block per (row entry j, layer l) zeroes the contiguous
// P*H*D slab of K and of V at page row[j] of layer l, in place, with 16-byte
// stores. A repeated id zeroes the same slab twice (idempotent); pages outside
// the row are never written. Bound on this card: writing the named slabs once.
//
// paged_rollback: the TPU kernel walks (layer, page of the row) and writes
// every page back, zeroing the lanes whose logical position j*P + t lies in
// [start, end). Here only the dead positions are written: one block per
// (dead position, layer l) zeroes that token's contiguous Hkv*D slab of K and
// of V, with 16-byte stores. Positions outside [0, nP*P) name no page and are
// skipped, as the TPU grid never visits them. The kernel writes +0.0, as the
// TPU kernel's jnp.where does. Zeroing is idempotent, so a repeated page id
// is harmless (the TPU kernel needs a duplicate-free row: a second visit
// would write the page's old content back). Bound on this card: writing the
// dead slabs once, 2 * L * (end - start) * Hkv*D * 4 bytes: 221 KB for a
// 3-token tail of qwen2.5-3b, 0.07 us, so one launch is bound by its launch.
#include "common.cuh"

namespace {

constexpr int PA_WARPS = 8;
constexpr int PA_THREADS = PA_WARPS * 32;
constexpr int PA_ROWS_PER_WARP = 16;
constexpr int PA_ROWS = PA_WARPS * PA_ROWS_PER_WARP;  // folded rows per block

template <int D>
__global__ void __launch_bounds__(PA_THREADS)
paged_attention_kernel(const float* __restrict__ q, const float* __restrict__ k_pages,
                       const float* __restrict__ v_pages, const int* __restrict__ tables,
                       const int* __restrict__ q_start, float* __restrict__ out, int C,
                       int Hq, int Hkv, int N, int P, int nP, float sm_scale) {
  constexpr int DL = (D + 31) / 32;  // output dims per lane (D < 32: lanes >= D idle)
  constexpr int QS = D + 1;     // padded row stride: conflict-free column reads
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = Hq / Hkv, GC = G * C;
  const int row0 = blockIdx.z * PA_ROWS;
  const int cap = GC < PA_ROWS ? GC : PA_ROWS;
  const int rows = min(GC - row0, PA_ROWS);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qs = q_start[b];
  const size_t tok_stride = (size_t)Hkv * D;

  extern __shared__ float smem[];
  float* q_s = smem;               // cap x QS
  float* k_s = q_s + cap * QS;     // P x QS
  float* v_s = k_s + P * QS;       // P x D
  float* s_s = v_s + P * D;        // cap x P: scores, then probabilities

  for (int idx = threadIdx.x; idx < rows * D; idx += PA_THREADS) {
    const int r = idx / D, d = idx % D, fr = row0 + r;
    const int head = h * G + fr / C, c = fr % C;
    q_s[r * QS + d] = q[(((size_t)b * C + c) * Hq + head) * D + d];
  }

  float m[PA_ROWS_PER_WARP], l[PA_ROWS_PER_WARP], acc[PA_ROWS_PER_WARP][DL];
#pragma unroll
  for (int i = 0; i < PA_ROWS_PER_WARP; ++i) {
    m[i] = REPRO_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < DL; ++k) acc[i][k] = 0.f;
  }

  for (int j = 0; j < nP; ++j) {
    const int page = tables[(size_t)b * nP + j];
    const bool named = page >= 0 && page < N;  // block-uniform
    __syncthreads();  // the previous page's tiles are consumed
    if (named) {
      const size_t base = (size_t)page * P * tok_stride + (size_t)h * D;
      for (int idx = threadIdx.x; idx < P * D; idx += PA_THREADS) {
        const int t = idx / D, d = idx % D;
        k_s[t * QS + d] = k_pages[base + t * tok_stride + d];
        v_s[t * D + d] = v_pages[base + t * tok_stride + d];
      }
    }
    __syncthreads();
    if (!named) continue;

    for (int e = threadIdx.x; e < rows * P; e += PA_THREADS) {
      const int r = e / P, col = e % P;
      const float* qr = q_s + r * QS;
      const float* kr = k_s + col * QS;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int kvpos = j * P + col;
      s_s[r * P + col] = kvpos <= qs + (row0 + r) % C ? dot * sm_scale : REPRO_NEG_INF;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < PA_ROWS_PER_WARP; ++i) {
      const int r = warp + PA_WARPS * i;
      if (r < rows) {  // warp-uniform
        float* sr = s_s + r * P;
        float mx = REPRO_NEG_INF;
        for (int col = lane; col < P; col += 32) mx = fmaxf(mx, sr[col]);
        const float m_new = fmaxf(m[i], warp_max(mx));
        float ps = 0.f;
        for (int col = lane; col < P; col += 32) {
          const float p = expf(sr[col] - m_new);
          sr[col] = p;
          ps += p;
        }
        const float alpha = expf(m[i] - m_new);
        l[i] = alpha * l[i] + warp_sum(ps);
        m[i] = m_new;
        __syncwarp();
#pragma unroll
        for (int k = 0; k < DL; ++k) {
          const int d = lane + 32 * k;
          if (d < D) {
            float a = acc[i][k] * alpha;
            for (int col = 0; col < P; ++col) a = fmaf(sr[col], v_s[col * D + d], a);
            acc[i][k] = a;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < PA_ROWS_PER_WARP; ++i) {
    const int r = warp + PA_WARPS * i;
    if (r < rows) {
      const int fr = row0 + r, head = h * G + fr / C, c = fr % C;
      float* o = out + (((size_t)b * C + c) * Hq + head) * D;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int k = 0; k < DL; ++k)
        if (lane + 32 * k < D) o[lane + 32 * k] = acc[i][k] * inv;
    }
  }
}

template <int D>
cudaError_t launch_paged_attention(const float* q, const float* k_pages, const float* v_pages,
                                   const int* tables, const int* q_start, float* out, int B,
                                   int C, int Hq, int Hkv, int N, int P, int nP, float sm_scale,
                                   cudaStream_t stream) {
  const int GC = (Hq / Hkv) * C;
  const int cap = GC < PA_ROWS ? GC : PA_ROWS;
  const size_t smem = sizeof(float) * ((size_t)cap * (D + 1) + (size_t)P * (D + 1) +
                                       (size_t)P * D + (size_t)cap * P);
  auto kern = paged_attention_kernel<D>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B, Hkv, (GC + PA_ROWS - 1) / PA_ROWS);
  kern<<<grid, PA_THREADS, smem, stream>>>(q, k_pages, v_pages, tables, q_start, out, C, Hq,
                                           Hkv, N, P, nP, sm_scale);
  return cudaGetLastError();
}

__global__ void paged_reset_kernel(float* __restrict__ k_pages, float* __restrict__ v_pages,
                                   const int* __restrict__ row, int N, long long slab) {
  const int j = blockIdx.x, layer = blockIdx.y;
  const int page = row[j];
  if (page < 0 || page >= N) return;  // never write outside the pool
  const size_t base = ((size_t)layer * N + page) * slab;
  float* k = k_pages + base;
  float* v = v_pages + base;
  if (slab % 4 == 0) {  // pool and slab 16-byte aligned: vector stores
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long i = threadIdx.x; i < slab / 4; i += blockDim.x) {
      reinterpret_cast<float4*>(k)[i] = z;
      reinterpret_cast<float4*>(v)[i] = z;
    }
  } else {
    for (long long i = threadIdx.x; i < slab; i += blockDim.x) {
      k[i] = 0.f;
      v[i] = 0.f;
    }
  }
}

__global__ void paged_rollback_kernel(float* __restrict__ k_pages, float* __restrict__ v_pages,
                                      const int* __restrict__ row, int N, int P, int tok,
                                      int lo) {
  const int pos = lo + blockIdx.x, layer = blockIdx.y;
  const int page = row[pos / P];
  if (page < 0 || page >= N) return;  // never write outside the pool
  const size_t base = (((size_t)layer * N + page) * P + pos % P) * tok;
  float* k = k_pages + base;
  float* v = v_pages + base;
  if (tok % 4 == 0) {  // pool and slab 16-byte aligned: vector stores
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = threadIdx.x; i < tok / 4; i += blockDim.x) {
      reinterpret_cast<float4*>(k)[i] = z;
      reinterpret_cast<float4*>(v)[i] = z;
    }
  } else {
    for (int i = threadIdx.x; i < tok; i += blockDim.x) {
      k[i] = 0.f;
      v[i] = 0.f;
    }
  }
}

}  // namespace

// q (B, C, Hq, D); k_pages, v_pages (N, P, Hkv, D); tables (B, nP) int32;
// q_start (B,) int32; out (B, C, Hq, D). All fp32 and contiguous.
REPRO_API int paged_attention_f32(const float* q, const float* k_pages, const float* v_pages,
                                  const int* tables, const int* q_start, float* out, int B,
                                  int C, int Hq, int Hkv, int N, int P, int D, int nP,
                                  float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_paged_attention<16>(q, k_pages, v_pages, tables, q_start, out, B, C, Hq,
                                        Hkv, N, P, nP, sm_scale, stream);
    case 32:
      return launch_paged_attention<32>(q, k_pages, v_pages, tables, q_start, out, B, C, Hq,
                                        Hkv, N, P, nP, sm_scale, stream);
    case 64:
      return launch_paged_attention<64>(q, k_pages, v_pages, tables, q_start, out, B, C, Hq,
                                        Hkv, N, P, nP, sm_scale, stream);
    case 128:
      return launch_paged_attention<128>(q, k_pages, v_pages, tables, q_start, out, B, C, Hq,
                                         Hkv, N, P, nP, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// k_pages, v_pages (L, N, P, H, D) fp32 contiguous, zeroed in place at the
// pages named in row (nP,) int32 across all L layers.
REPRO_API int paged_reset_f32(float* k_pages, float* v_pages, const int* row, int L, int N,
                              long long slab, int nP, cudaStream_t stream) {
  dim3 grid(nP, L);
  paged_reset_kernel<<<grid, 256, 0, stream>>>(k_pages, v_pages, row, N, slab);
  return cudaGetLastError();
}

// k_pages, v_pages (L, N, P, H, D) fp32 contiguous; row (nP,) int32. Zeroes
// logical positions [start, end) of row (page j holds j*P .. j*P+P-1) across
// all L layers, in place; tok = H*D.
REPRO_API int paged_rollback_f32(float* k_pages, float* v_pages, const int* row, int L, int N,
                                 int P, int tok, int nP, int start, int end,
                                 cudaStream_t stream) {
  const long long lo = start > 0 ? start : 0;
  const long long hi = (long long)end < (long long)nP * P ? end : (long long)nP * P;
  if (L <= 0 || hi <= lo) return cudaSuccess;
  dim3 grid((unsigned)(hi - lo), L);
  paged_rollback_kernel<<<grid, 64, 0, stream>>>(k_pages, v_pages, row, N, P, tok, (int)lo);
  return cudaGetLastError();
}
