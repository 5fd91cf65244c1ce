// Paged attention for confidential serving, fp32 or bf16, sm_90a.
//
// Replaces the TPU kernel of src/repro/kernels/paged_attention/paged_attention.py:
//   paged_attention_pallas (_paged_kernel, :98, pallas_call :142)
// The page reset and rollback (paged_reset_pallas, paged_rollback_pallas)
// are one batched kernel in pool_zero.cu.
//
// paged_attention: the GQA group is folded onto rows, as in the TPU kernel's
// _fold: folded row r of kv head h is query head h*G + r / C at chunk token
// r % C. The G*C rows are cut into tiles of at most 64 (8, 16, 32 or 64
// rows, so a decode step's 8 rows and a verify's 32 fill their tile), and
// the slot's nP pages into `splits` contiguous runs chosen by the wrapper
// (paged_attention.py: plan) from B, Hkv, nP, the row tiles and the SM
// count, so that one call covers the card with runs of at least one tile. Grid (slot x kv head, row tile, split); each block runs the
// shared online-softmax step (csrc/attn_tile.cuh) over its run, 32 tokens a
// tile, the next tile's K/V copied with 16-byte cp.async under this tile's
// math (double-buffered). One token's Hkv*D slab is contiguous, so a tile of
// head h is 32 rows of D floats at stride Hkv*D.
//   Two device launches a call: the split kernel writes each split's
//   partial (m, l, acc) to a scratch buffer that the wrapper allocates, and
//   a combine kernel on the same stream merges the splits in ascending
//   order (deterministic) and writes acc / max(l, 1e-30). With one split
//   the first kernel writes the output itself and the combine is skipped.
//   Isolation: the only pool addresses a block computes are
//   tables[b, j]*P*Hkv*D + t*Hkv*D + h*D + d, so it reads no page that the
//   slot's row does not name; an out-of-range id is skipped, never read (its
//   columns score -inf and add exactly 0).
//   Mask: kvpos = j*P + col is visible to row r iff kvpos <= q_start[b] + r % C
//   (_mask, paged_attention.py:57), NEG_INF the same finite -1e30. When
//   q_start[b] >= 0 and page 0 is named, every row sees position 0, so pages
//   wholly past q_start[b] + C - 1 add exactly 0 in fp32 and are not walked.
//   Otherwise (q_start < 0: an inactive slot) every named page is walked, so
//   a fully masked row is the same finite uniform average over the named
//   pages as in the plain version. A split with nothing to walk writes m =
//   NEG_INF, l = 0, acc = 0, which the combine weighs to 0 next to a real
//   row and to nothing next to an all-masked one. (Skipping the acc of
//   such a split made the combine's loads wait on l and ran slower on the
//   H100: PERF.md.)
//   Bound on this card: reading each visible page's K and V once. Decode
//   (C 1, 8 rows) does 2*8 flops per K/V element, far below the fp32 ridge:
//   bound by bytes (2.4 MB at the smoke's q_starts, 0.0005 ms); a C 16 chunk
//   does 16x more and sits just above the ridge (0.0014 ms of fp32 issue).
//   At these shapes what costs time is parallelism and wasted work, not
//   the FMA rate: B x Hkv is 8 (slot, kv head) pairs at B 4, on 132 SMs,
//   and a slot's causal limit leaves most of its pages unseen. So the
//   page runs split across blocks (at B 4: 128 blocks for decode and a
//   verify, 256 for a chunk, one 32-token tile each), the causal skip
//   drops the pages no row sees, and the products are register-blocked.
//   Head dims 16, 32, 64, 80, 96 and 128. At 80 and 96 (stablelm-3b,
//   phi3-mini-3.8b) a row's P.V outputs are 20 or 24 lanes, so one row a
//   warp and 12 or 8 lanes idle in that step; their q/k strides (84, 100
//   floats) still put 8 consecutive rows' float4 reads in distinct banks.
//   Both archs are MHA (G 1): a decode step's one folded row sits in a row
//   tile of 8, so 7 of its rows are padding (correct, wasteful: PERF.md).
//   bf16 (paged_attention_bf16): q and both pools in bf16, as the Pallas
//   kernel reads its pools in the compute type; the tiles widen them to
//   fp32 as they stage (csrc/attn_tile.cuh), the math, the partials and the
//   output stay fp32 (the Pallas kernel returns fp32, paged_attention.py:
//   152). Half the pool bytes: the bound halves.
//
#include "attn_tile.cuh"

namespace {

template <int D, int ROWS>
using PagedTile = AttnTile<D, ROWS, 2>;

// part: acc (BH, splits, GC, D), then m and l (BH, splits, GC) each
template <class T, int D, int ROWS>
__global__ void __launch_bounds__(ATTN_THREADS, 2)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ tables,
                       const int* __restrict__ q_start, float* __restrict__ out,
                       float* __restrict__ part, int C, int Hq, int Hkv, int N, int P, int nP,
                       int pps, float sm_scale) {
  extern __shared__ float4 attn_smem[];
  PagedTile<D, ROWS> tile(reinterpret_cast<float*>(attn_smem));
  int* lim_s = reinterpret_cast<int*>(attn_smem) + PagedTile<D, ROWS>::FLOATS;
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int G = Hq / Hkv, GC = G * C;
  const int row0 = blockIdx.y * ROWS, rows = min(GC - row0, ROWS);
  const int split = blockIdx.z, splits = gridDim.z;
  const int* trow = tables + (size_t)b * nP;
  const int qs = q_start[b];
  const long long tok = (long long)Hkv * D;

  int j0 = split * pps, j1 = min(nP, j0 + pps);
  const int p0 = trow[0];
  if (qs >= 0 && p0 >= 0 && p0 < N)  // every row sees position 0
    j1 = min(j1, (int)min((long long)nP, ((long long)qs + C - 1) / P + 1));
  const int pos0 = j0 * P, npos = max(j1 - j0, 0) * P;
  const int ntiles = (npos + ATTN_COLS - 1) / ATTN_COLS;
  // each row's last visible position; whether the run names every page
  // (then the mask needs no table read)
  for (int r = threadIdx.x; r < ROWS; r += ATTN_THREADS) lim_s[r] = qs + (row0 + r) % C;
  bool unnamed = false;
  for (int j = j0 + threadIdx.x; j < j1; j += ATTN_THREADS) {
    const int page = trow[j];
    unnamed |= page < 0 || page >= N;
  }
  unnamed = __syncthreads_or(unnamed);

  PagedTile<D, ROWS>::stage(tile.q_s, PagedTile<D, ROWS>::KS, q, rows, ROWS, [&](int r) {
    const int fr = row0 + r;
    return (((long long)b * C + fr % C) * Hq + h * G + fr / C) * D;
  });
  // -1 for a position whose page is not named
  auto kv_off = [&](int pos) -> long long {
    const int page = __ldg(trow + pos / P);
    if (page < 0 || page >= N) return -1;
    return ((long long)page * P + pos % P) * tok + (long long)h * D;
  };
  tile.run(
      ntiles,
      [&](int t, int buf) {
        const int base = pos0 + t * ATTN_COLS;
        tile.stage_kv(buf, k_pages, v_pages, min(npos - t * ATTN_COLS, ATTN_COLS),
                      [&](int c) { return kv_off(base + c); });
      },
      [&](int t) { return min(npos - t * ATTN_COLS, ATTN_COLS); },
      [&](int t, int r, int c, float dot) {
        const int pos = pos0 + t * ATTN_COLS + c;
        if (unnamed) {
          const int page = __ldg(trow + pos / P);
          if (page < 0 || page >= N) return -INFINITY;
        }
        return pos <= lim_s[r] ? dot * sm_scale : REPRO_NEG_INF;
      });

  if (splits == 1) {
    tile.each_acc([&](int r, int d, float4 a, float l) {
      if (r >= rows) return;
      const int fr = row0 + r;
      float* o = out + (((size_t)b * C + fr % C) * Hq + h * G + fr / C) * D + d;
      const float inv = 1.f / fmaxf(l, 1e-30f);
      *reinterpret_cast<float4*>(o) = make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
    });
    return;
  }
  const size_t n = (size_t)gridDim.x * splits * GC;  // partial rows
  const size_t prow = ((size_t)blockIdx.x * splits + split) * GC + row0;
  float* pm = part + n * D + prow;
  float* pl = pm + n;
  tile.each_ml([&](int r, float m, float l) {
    if (r < rows) {
      pm[r] = m;
      pl[r] = l;
    }
  });
  tile.each_acc([&](int r, int d, float4 a, float) {
    if (r < rows) *reinterpret_cast<float4*>(part + (prow + r) * D + d) = a;
  });
}

// One thread a (slot x kv head, folded row, 4 dims): merges the splits in
// ascending order.
__global__ void __launch_bounds__(256)
paged_combine_kernel(const float* __restrict__ part, float* __restrict__ out, int C, int Hq,
                     int Hkv, int D, int splits) {
  const int G = Hq / Hkv, GC = G * C, D4 = D / 4;
  const int idx = blockIdx.y * blockDim.x + threadIdx.x;
  if (idx >= GC * D4) return;
  const int r = idx / D4, d = 4 * (idx % D4);
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const size_t n = (size_t)gridDim.x * splits * GC;
  const size_t row = (size_t)bh * splits * GC + r;  // split 0's partial row
  const float* pm = part + n * D;
  const float* pl = pm + n;
  float mx = REPRO_NEG_INF;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, pm[row + (size_t)s * GC]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const size_t ps = row + (size_t)s * GC;
    const float w = expf(pm[ps] - mx);
    l = fmaf(pl[ps], w, l);
    fma4(acc, w, *reinterpret_cast<const float4*>(part + ps * D + d));
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  float* o = out + (((size_t)b * C + r % C) * Hq + h * G + r / C) * D + d;
  *reinterpret_cast<float4*>(o) = make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

template <class T, int D, int ROWS>
cudaError_t launch_paged_attention(const T* q, const T* k_pages, const T* v_pages,
                                   const int* tables, const int* q_start, float* out,
                                   float* part, int B, int C, int Hq, int Hkv, int N, int P,
                                   int nP, int splits, float sm_scale, cudaStream_t stream) {
  static unsigned long long smem_set = 0;
  auto kern = paged_attention_kernel<T, D, ROWS>;
  const size_t smem = PagedTile<D, ROWS>::BYTES + ROWS * sizeof(int);
  cudaError_t e = set_smem_once(kern, smem, smem_set);
  if (e != cudaSuccess) return e;
  const int GC = (Hq / Hkv) * C;
  const int pps = (nP + splits - 1) / splits;
  dim3 grid(B * Hkv, (GC + ROWS - 1) / ROWS, splits);
  kern<<<grid, ATTN_THREADS, smem, stream>>>(q, k_pages, v_pages, tables, q_start, out, part, C,
                                              Hq, Hkv, N, P, nP, pps, sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  dim3 cgrid(B * Hkv, (GC * (D / 4) + 255) / 256);
  paged_combine_kernel<<<cgrid, 256, 0, stream>>>(part, out, C, Hq, Hkv, D, splits);
  return cudaGetLastError();
}

template <class T, int D>
cudaError_t launch_paged_rows(int rows, const T* q, const T* k_pages, const T* v_pages,
                              const int* tables, const int* q_start, float* out, float* part,
                              int B, int C, int Hq, int Hkv, int N, int P, int nP, int splits,
                              float sm_scale, cudaStream_t stream) {
  switch (rows) {
    case 8:
      return launch_paged_attention<T, D, 8>(q, k_pages, v_pages, tables, q_start, out, part, B,
                                             C, Hq, Hkv, N, P, nP, splits, sm_scale, stream);
    case 16:
      return launch_paged_attention<T, D, 16>(q, k_pages, v_pages, tables, q_start, out, part,
                                              B, C, Hq, Hkv, N, P, nP, splits, sm_scale, stream);
    case 32:
      return launch_paged_attention<T, D, 32>(q, k_pages, v_pages, tables, q_start, out, part,
                                              B, C, Hq, Hkv, N, P, nP, splits, sm_scale, stream);
    case 64:
      return launch_paged_attention<T, D, 64>(q, k_pages, v_pages, tables, q_start, out, part,
                                              B, C, Hq, Hkv, N, P, nP, splits, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <class T>
int paged_attention(const T* q, const T* k_pages, const T* v_pages, const int* tables,
                    const int* q_start, float* out, float* part, int B, int C, int Hq, int Hkv,
                    int N, int P, int D, int nP, int rows, int splits, float sm_scale,
                    cudaStream_t stream) {
  if (splits < 1 || splits > nP) return cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return launch_paged_rows<T, 16>(rows, q, k_pages, v_pages, tables, q_start, out, part, B,
                                      C, Hq, Hkv, N, P, nP, splits, sm_scale, stream);
    case 32:
      return launch_paged_rows<T, 32>(rows, q, k_pages, v_pages, tables, q_start, out, part, B,
                                      C, Hq, Hkv, N, P, nP, splits, sm_scale, stream);
    case 64:
      return launch_paged_rows<T, 64>(rows, q, k_pages, v_pages, tables, q_start, out, part, B,
                                      C, Hq, Hkv, N, P, nP, splits, sm_scale, stream);
    case 80:  // stablelm-3b
      return launch_paged_rows<T, 80>(rows, q, k_pages, v_pages, tables, q_start, out, part, B,
                                      C, Hq, Hkv, N, P, nP, splits, sm_scale, stream);
    case 96:  // phi3-mini-3.8b
      return launch_paged_rows<T, 96>(rows, q, k_pages, v_pages, tables, q_start, out, part, B,
                                      C, Hq, Hkv, N, P, nP, splits, sm_scale, stream);
    case 128:
      return launch_paged_rows<T, 128>(rows, q, k_pages, v_pages, tables, q_start, out, part, B,
                                       C, Hq, Hkv, N, P, nP, splits, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, C, Hq, D); k_pages, v_pages (N, P, Hkv, D); tables (B, nP) int32;
// q_start (B,) int32; out (B, C, Hq, D). All fp32, contiguous and 16-byte
// aligned. rows: the row tile (8, 16, 32 or 64); splits: the page runs
// (1..nP); part: scratch of B*Hkv*splits*G*C*(D + 2) floats, unused when
// splits is 1.
REPRO_API int paged_attention_f32(const float* q, const float* k_pages, const float* v_pages,
                                  const int* tables, const int* q_start, float* out, float* part,
                                  int B, int C, int Hq, int Hkv, int N, int P, int D, int nP,
                                  int rows, int splits, float sm_scale, cudaStream_t stream) {
  return paged_attention(q, k_pages, v_pages, tables, q_start, out, part, B, C, Hq, Hkv, N, P, D,
                         nP, rows, splits, sm_scale, stream);
}

// The same with q, k_pages and v_pages in bf16; out and part stay fp32.
REPRO_API int paged_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k_pages,
                                   const __nv_bfloat16* v_pages, const int* tables,
                                   const int* q_start, float* out, float* part, int B, int C,
                                   int Hq, int Hkv, int N, int P, int D, int nP, int rows,
                                   int splits, float sm_scale, cudaStream_t stream) {
  return paged_attention(q, k_pages, v_pages, tables, q_start, out, part, B, C, Hq, Hkv, N, P, D,
                         nP, rows, splits, sm_scale, stream);
}
