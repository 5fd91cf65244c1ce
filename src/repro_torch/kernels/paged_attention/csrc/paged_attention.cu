// Paged attention for confidential serving, fp32 or bf16, sm_90a.
//
// Replaces the TPU kernel of src/repro/kernels/paged_attention/paged_attention.py:
//   paged_attention_pallas (_paged_kernel, :98, pallas_call :142)
// The page reset and rollback (paged_reset_pallas, paged_rollback_pallas)
// are one batched kernel in pool_zero.cu.
//
// What both instantiations keep, the TPU kernel's contract:
//   Fold: the GQA group is folded onto rows, as in the TPU kernel's _fold:
//   folded row r of kv head h is query head h*G + r / C at chunk token r % C.
//   Isolation: the only pool addresses a block computes are
//   tables[b, j]*P*Hkv*D + t*Hkv*D + h*D + d, so it reads no page that the
//   slot's row does not name; an out-of-range id is skipped, never read (its
//   columns score -inf and add exactly 0).
//   Mask: kvpos = j*P + col is visible to row r iff kvpos <= q_start[b] + r % C
//   (_mask, paged_attention.py:57), NEG_INF the same finite -1e30. When
//   q_start[b] >= 0 and page 0 is named, every row sees position 0, so keys
//   wholly past q_start[b] + C - 1 add exactly 0 in fp32 and are not walked.
//   Otherwise (q_start < 0: an inactive slot) every named page is walked, so
//   a fully masked row is the same finite uniform average over the named
//   pages as in the plain version.
//   Merge: each block writes its partial (m, l, acc) to a scratch buffer
//   that the wrapper allocates; a partial with nothing to walk is m =
//   NEG_INF, l = 0, acc = 0, which the combine weighs to 0 next to a real
//   row and to nothing next to an all-masked one. A second launch on the same
//   stream (paged_combine_kernel) merges a row's partials in ascending
//   order, no atomics, and writes acc / max(l, 1e-30): two launches are
//   bit-equal. Where one block covers a row's whole walk it writes the
//   output itself and the combine is skipped.
//
// fp32 (paged_attention_f32) on the CUDA cores. The G*C rows are cut into
// tiles of at most 64 (8, 16, 32 or 64 rows, so a decode step's 8 rows and a
// verify's 32 fill their tile), and the slot's nP pages into `splits`
// contiguous runs chosen by the wrapper (paged_attention.py: plan) from B,
// Hkv, nP, the row tiles and the SM count, so that one call covers the card
// with runs of at least one tile. Grid (slot x kv head, row tile, split);
// each block runs the online-softmax step of csrc/attn_tile.cuh over
// its run, 32 tokens a tile, the next tile's K/V copied with 16-byte
// cp.async under this tile's math (double-buffered). One token's Hkv*D slab
// is contiguous, so a tile of head h is 32 rows of D floats at stride
// Hkv*D. Pages wholly past the causal limit are not walked. (Skipping the
// acc of an empty split made the combine's loads wait on l and ran slower on
// the H100: PERF.md.)
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
//
// bf16 (paged_attention_bf16) on the tensor cores (paged_attention_tc_kernel,
// on csrc/mma_tile.cuh). q and both pools are bf16, as the Pallas kernel
// reads its pools in the compute type; the math, the partials and the output
// are fp32 (the Pallas kernel returns fp32, paged_attention.py:152).
//   Bound on this card: the bytes. A decode step at Hkv 32 (stablelm-3b,
//   d_head 80, B 4, 32 pages of 16 a slot, the smoke's q_starts) needs the
//   7 MB of bf16 K and V in the pages holding a visible position, for 4
//   flops a key and a dimension: 0.0022 ms of bytes against 1e-5 ms of
//   tensor-core work. (The walk reads 12 MB: an inactive slot walks every
//   page for the plain version's uniform average.) The design this replaces
//   ran the fp32 kernel on bf16 tiles at 7-8% of that bound, slower than
//   its own fp32 instantiation: cp.async cannot convert, so each bf16 row
//   was widened through registers and the next tile's copy no longer ran
//   under this tile's math; a decode's one folded row at G 1 sat in a
//   256-thread block's 8-row tile; every slot's pages were split into the
//   same number of runs, so the longest slot's run walked six 32-token
//   tiles in series while the shortest slot's blocks had nothing to do; and
//   3 x 128 blocks of 256 threads at 2 an SM ran in two waves. So:
//   - Work cut by tokens, in one wave. A block of 4 warps (128 threads)
//     takes a chunk of PTC_CHUNK = 128 tokens of one (slot, kv head, row
//     tile), warp w its 32 tokens as two tiles of 16 keys; grid (B x Hkv,
//     row tiles, ceil(nP P / 128)). Each block reads q_start on the card and
//     computes the slot's walk: a chunk wholly past it writes an empty
//     partial and exits, so a short slot costs blocks that exit at once and
//     the longest slot's walk spreads over every chunk it holds. At B 4, Hkv
//     32, 32 pages of 16: 512 blocks, 352 of them live at the smoke's
//     q_starts, all resident at once (48.5 KB of shared memory a block at
//     d_head 80, 4 an SM; 68-72.5 KB at 128). The page ids of a warp's keys
//     are read beside q_start, before the walk's end is known.
//   - bf16 in shared memory, as it lies in the pool. Each warp copies its
//     own tiles' K and V rows with 16-byte cp.async (two lanes a key, the
//     key's page looked up once; an unnamed page or a key past the walk
//     zero-filled and never read) into a ring of two stages at a row stride
//     of D + 8 (TC_PAD: no ldmatrix bank conflicts); both tiles are in
//     flight before the first tile's math. No block barrier until the warps
//     merge.
//   - The products on the tensor cores, mma.sync m16n8k16 (bf16 in, fp32
//     accumulate; q, k and v enter once, exactly). At G*C <= 8 folded rows
//     (a decode at G 1, 2, 4 or 8; a verify at G 1 or 2) the scores are
//     computed transposed, S^T = K q^T: the tile's 16 keys on M, the rows on
//     N, so the padding stays inside one instruction's 8 columns. P^T goes
//     through 1152 bytes of the warp's shared memory and O^T += V^T P^T, V^T
//     by ldmatrix.trans. With more rows, 16-row tiles: S = Q K^T and O += P
//     V, P taken from the accumulator (a_from_c3), as in the flash pair.
//     P enters whole, as three bf16 terms (split3, csrc/mma_tile.cuh: hi +
//     mid + lo == p), at three mma a step. The flash pair's two terms leave
//     up to 2^-16 of each p, which at a row with a few visible keys moves
//     the output by up to 2^-16 of its V values; the kernel and its model,
//     whose p differ in the last bits, round lo apart. With two terms the
//     kernel lay 7.0e-6 from the plain version and 1.0e-5 from its model
//     (the 1e-5 gate); with three, under 1e-6 from both. The third product
//     costs 2-5% of the kernel's card time against two terms in the same
//     call (H100 80GB HBM3, 700 W: tools/time_paged_bf16.py, PERF.md).
//   - The merge: each warp leaves its (m, l, acc) in its own shared memory,
//     the block merges its 4 warps in warp order, and paged_combine_kernel
//     (the fp32 kernel's, unchanged) merges the chunks in ascending order.
//   The exponentials are base 2 on the SFU (ex2.approx, the scale folded
//   into the scores); the partials carry m in natural units, as the combine
//   reads them.
//
#include "attn_tile.cuh"
#include "mma_tile.cuh"

namespace {

template <int D, int ROWS>
using PagedTile = AttnTile<D, ROWS>;

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


// ---------------------------------------------- bf16 on the tensor cores

constexpr int PTC_WARPS = 4;  // warps a block
constexpr int PTC_THREADS = 32 * PTC_WARPS;
constexpr int PTC_KEYS = 16;    // keys a tile
constexpr int PTC_TILES = 2;    // tiles a warp walks
constexpr int PTC_STAGES = 2;   // the ring a warp stages its tiles through
constexpr int PTC_CHUNK = PTC_WARPS * PTC_TILES * PTC_KEYS;  // tokens a block: 128
constexpr int PTC_PST = PTC_KEYS + 8;  // P^T's row stride (bf16): conflict-free reads

// The end of slot b's walk, tokens [0, end) of its S = nP * P. When q_start
// >= 0 and page 0 is named, every row sees position 0, so keys past the
// last row's limit add exactly 0 and are not walked; otherwise every
// position is.
__device__ __forceinline__ int paged_walk_end(const int* trow, int qs, int C, int N, int S) {
  const int p0 = __ldg(trow);
  if (qs >= 0 && p0 >= 0 && p0 < N) return (int)min((long long)S, (long long)qs + C);
  return S;
}

template <int D, bool TR>
struct PagedTc {
  static constexpr int ROWS = TR ? 8 : 16;  // folded rows a block
  static constexpr int ST = TcRows<D>::ST;
  static constexpr int STAGE = 2 * PTC_KEYS * ST;  // one tile's K rows, then V (bf16)
  // bf16 values of shared memory a warp: its ring, then (transposed) P^T's
  // three terms
  static constexpr int WARP = PTC_STAGES * STAGE + (TR ? 3 * 8 * PTC_PST : 0);
  static constexpr size_t BYTES = sizeof(__nv_bfloat16) * PTC_WARPS * WARP;
  // a warp's partial (m, l: ROWS floats each; acc: ROWS x D) over its ring
  static_assert(PTC_STAGES * STAGE >= 2 * ROWS * (D + 2), "the partial fits the ring");
};

// part: as paged_combine_kernel reads it (chunks in place of splits)
template <int D, bool TR>
__global__ void __launch_bounds__(PTC_THREADS, 3)
paged_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k_pages,
                          const __nv_bfloat16* __restrict__ v_pages,
                          const int* __restrict__ tables, const int* __restrict__ q_start,
                          float* __restrict__ out, float* __restrict__ part, int C, int Hq,
                          int Hkv, int N, int P, int nP, float sl) {
  using L = PagedTc<D, TR>;
  using R = TcRows<D>;
  constexpr int ROWS = L::ROWS, ST = L::ST, KD = D / 16, AT = TR ? D / 16 : D / 8;
  extern __shared__ uint4 tc_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int G = Hq / Hkv, GC = G * C, r0 = blockIdx.y * ROWS, rows = min(GC - r0, ROWS);
  const int chunk = blockIdx.z, chunks = gridDim.z;
  const int* trow = tables + (size_t)b * nP;
  const int c0 = chunk * PTC_CHUNK, S = nP * P;
  const int wbase = c0 + warp * PTC_TILES * PTC_KEYS, key = lane >> 1;
  // the page ids of the warp's keys (lanes 2k and 2k + 1: key k of each
  // tile), read beside q_start: reading the table is not reading a page
  int pid[PTC_TILES];
#pragma unroll
  for (int i = 0; i < PTC_TILES; ++i) {
    const int pos = wbase + i * PTC_KEYS + key;
    pid[i] = pos < S ? __ldg(trow + pos / P) : -1;
  }
  const int qs = __ldg(q_start + b);
  const int end = paged_walk_end(trow, qs, C, N, S);
  const size_t n = (size_t)gridDim.x * chunks * GC;  // partial rows
  const size_t prow = ((size_t)bh * chunks + chunk) * GC + r0;

  if (c0 >= end) {  // wholly past the slot's walk (never chunk 0): an empty partial
    for (int i = threadIdx.x; i < rows * (D / 4); i += PTC_THREADS) {
      const int r = i / (D / 4), d = 4 * (i % (D / 4));
      *reinterpret_cast<float4*>(part + (prow + r) * D + d) = make_float4(0.f, 0.f, 0.f, 0.f);
      if (d == 0) {
        part[n * D + prow + r] = REPRO_NEG_INF;
        part[n * D + n + prow + r] = 0.f;
      }
    }
    return;
  }

  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(tc_smem) + warp * L::WARP;
  const int ntiles = wbase < end ? min(PTC_TILES, (end - wbase + PTC_KEYS - 1) / PTC_KEYS) : 0;
  const long long tok = (long long)Hkv * D;

  // Copy tile i's K and V rows into stage s; returns the key mask (bits 2k
  // and 2k + 1 set: key k is there, its page named and inside the walk).
  auto stage = [&](int i, int s) -> unsigned {
    const int pos = wbase + i * PTC_KEYS + key, page = pid[i];
    long long off = -1;
    if (pos < end && page >= 0 && page < N)
      off = ((long long)page * P + pos % P) * tok + (long long)h * D;
    const bool ok = off >= 0;
    __nv_bfloat16* kd = ws + s * L::STAGE + key * ST;
    __nv_bfloat16* vd = kd + PTC_KEYS * ST;
    const __nv_bfloat16* kg = ok ? k_pages + off : k_pages;
    const __nv_bfloat16* vg = ok ? v_pages + off : v_pages;
#pragma unroll
    for (int c = 8 * (lane & 1); c < D; c += 16) {
      cp_async16_zfill(kd + c, ok ? kg + c : kg, ok);
      cp_async16_zfill(vd + c, ok ? vg + c : vg, ok);
    }
    return __ballot_sync(0xffffffffu, ok);
  };
  unsigned there[PTC_STAGES];
#pragma unroll
  for (int s = 0; s < PTC_STAGES; ++s) {
    there[s] = s < ntiles ? stage(s, s) : 0u;
    cp_async_commit();
  }

  // the lane's two folded rows (transposed: 2 t4 and 2 t4 + 1, the score
  // columns; else r0 + g and r0 + g + 8), each one's last visible
  // position, and q's fragments straight from device memory (a row past
  // G*C is zero)
  const int fr0 = TR ? 2 * t4 : r0 + g, fr1 = TR ? 2 * t4 + 1 : r0 + g + 8;
  const int lim0 = qs + fr0 % C, lim1 = qs + fr1 % C;
  auto q_row = [&](int fr) -> const unsigned* {
    return fr < GC ? reinterpret_cast<const unsigned*>(
                         q + (((long long)b * C + fr % C) * Hq + h * G + fr / C) * D + 2 * t4)
                   : nullptr;
  };
  auto ld = [](const unsigned* p, int i) { return p ? __ldg(p + i) : 0u; };
  // transposed: B fragments of q^T (row g); else A fragments (rows fr0, fr1)
  unsigned qf[KD][TR ? 2 : 4];
  {
    const unsigned* qa = q_row(TR ? g : fr0);
    const unsigned* qb = q_row(fr1);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if constexpr (TR) {
        qf[kk][0] = ld(qa, 8 * kk);
        qf[kk][1] = ld(qa, 8 * kk + 4);
      } else {
        qf[kk][0] = ld(qa, 8 * kk);
        qf[kk][1] = ld(qb, 8 * kk);
        qf[kk][2] = ld(qa, 8 * kk + 4);
        qf[kk][3] = ld(qb, 8 * kk + 4);
      }
    }
  }

  float m0 = REPRO_NEG_INF, m1 = REPRO_NEG_INF, l0 = 0.f, l1 = 0.f;  // rows fr0, fr1
  float acc[AT][4];
#pragma unroll
  for (int i = 0; i < AT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

#pragma unroll
  for (int i = 0; i < PTC_TILES; ++i) {
    if (i >= ntiles) break;
    const int s = i % PTC_STAGES, kb = wbase + i * PTC_KEYS;
    cp_async_wait<PTC_STAGES - 1>();
    __syncwarp();
    const __nv_bfloat16* k_s = ws + s * L::STAGE;
    const __nv_bfloat16* v_s = k_s + PTC_KEYS * ST;
    const unsigned th = there[s];
    // scaled score in base-2 units; NEG_INF masked; -inf for a key not there
    auto score = [&](float dot, int key, int lim) {
      return !((th >> (2 * key)) & 1u) ? -INFINITY : kb + key <= lim ? dot * sl : REPRO_NEG_INF;
    };
    float a0, a1;  // the rows' rescale factors
    if constexpr (TR) {
      // S^T: c0, c1 = key g, rows 2 t4 and 2 t4 + 1; c2, c3 = key g + 8
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned ka[4];
        R::a_frag(ka, k_s, 0, kk);
        mma_bf16(sc, ka, qf[kk][0], qf[kk][1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[e] = score(sc[e], g + 8 * (e >> 1), e & 1 ? lim1 : lim0);
      float mx0 = fmaxf(sc[0], sc[2]), mx1 = fmaxf(sc[1], sc[3]);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {  // over the 8 lanes of a column
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite
      a0 = exp2_approx(m0 - mn0);
      a1 = exp2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[e] = exp2_approx(sc[e] - (e & 1 ? mn1 : mn0));
      l0 = a0 * l0 + (sc[0] + sc[2]);  // this lane's keys; the column's sum at the end
      l1 = a1 * l1 + (sc[1] + sc[3]);
#pragma unroll
      for (int j = 0; j < AT; ++j) {
        acc[j][0] *= a0;
        acc[j][1] *= a1;
        acc[j][2] *= a0;
        acc[j][3] *= a1;
      }
      // P^T (row x key) as three bf16 terms in shared memory (split3: p
      // whole), then read back as the B fragments of O^T += V^T P^T (keys
      // 2 t4.., 2 t4 + 8.., row g)
      __nv_bfloat16* pt = ws + PTC_STAGES * L::STAGE;  // hi, mid, lo
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // keys g and g + 8 of rows 2 t4, 2 t4 + 1
        unsigned tm[3];
        split3(sc[2 * e], sc[2 * e + 1], tm[0], tm[1], tm[2]);
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          const __nv_bfloat162 two = *reinterpret_cast<const __nv_bfloat162*>(&tm[u]);
          __nv_bfloat16* row = pt + u * 8 * PTC_PST + 2 * t4 * PTC_PST + g + 8 * e;
          row[0] = two.x;
          row[PTC_PST] = two.y;
        }
      }
      __syncwarp();
      unsigned pb[3][2];
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const unsigned* r = reinterpret_cast<const unsigned*>(pt + (u * 8 + g) * PTC_PST + 2 * t4);
        pb[u][0] = r[0];
        pb[u][1] = r[4];
      }
#pragma unroll
      for (int j = 0; j < AT; ++j) {  // dims 16 j .. 16 j + 15 on M
        unsigned va[4];
        ldsm_x4_t(va, v_s + ((lane & 7) + 8 * (lane >> 4)) * ST + 16 * j + 8 * ((lane >> 3) & 1));
#pragma unroll
        for (int u = 0; u < 3; ++u) mma_bf16(acc[j], va, pb[u][0], pb[u][1]);  // hi first
      }
    } else {
      // S: sc[j]: c0, c1 = row fr0, keys 8 j + 2 t4 and + 1; c2, c3 = row fr1
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned kf[4];
        R::bt_frag(kf, k_s, 0, kk);
        mma_bf16(sc[0], qf[kk], kf[0], kf[1]);
        mma_bf16(sc[1], qf[kk], kf[2], kf[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = score(sc[j][e], 8 * j + 2 * t4 + (e & 1), e & 2 ? lim1 : lim0);
      float mx0 = fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1]));
      float mx1 = fmaxf(fmaxf(sc[0][2], sc[0][3]), fmaxf(sc[1][2], sc[1][3]));
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {  // over the quad of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite
      a0 = exp2_approx(m0 - mn0);
      a1 = exp2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = exp2_approx(sc[j][e] - (e & 2 ? mn1 : mn0));
      l0 = a0 * l0 + (sc[0][0] + sc[0][1] + sc[1][0] + sc[1][1]);
      l1 = a1 * l1 + (sc[0][2] + sc[0][3] + sc[1][2] + sc[1][3]);
#pragma unroll
      for (int j = 0; j < AT; ++j) {
        acc[j][0] *= a0;
        acc[j][1] *= a0;
        acc[j][2] *= a1;
        acc[j][3] *= a1;
      }
      unsigned pa[3][4];  // hi, mid, lo
      a_from_c3(sc[0], sc[1], pa[0], pa[1], pa[2]);
#pragma unroll
      for (int j = 0; j < AT; j += 2) {
        unsigned vb[4];
        R::b_frag(vb, v_s, 0, 8 * j);
#pragma unroll
        for (int u = 0; u < 3; ++u) {  // hi first
          mma_bf16(acc[j], pa[u], vb[0], vb[1]);
          mma_bf16(acc[j + 1], pa[u], vb[2], vb[3]);
        }
      }
    }
    __syncwarp();  // stage s (and P^T) consumed
    if (i + PTC_STAGES < ntiles) there[s] = stage(i + PTC_STAGES, s);
    cp_async_commit();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int o = TR ? 4 : 1; o < (TR ? 32 : 4); o <<= 1) {  // the rows' sums over their lanes
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  __syncwarp();

  // this warp's partial over its own ring: m, l (ROWS each), acc (ROWS x D)
  float* wf = reinterpret_cast<float*>(ws);
  float* wa = wf + 2 * ROWS;
  const int w0 = fr0 - (TR ? 0 : r0), w1 = fr1 - (TR ? 0 : r0);  // rows of the block
  if (TR ? g == 0 : t4 == 0) {
    wf[w0] = m0;
    wf[w1] = m1;
    wf[ROWS + w0] = l0;
    wf[ROWS + w1] = l1;
  }
#pragma unroll
  for (int j = 0; j < AT; ++j) {
    if constexpr (TR) {  // dims 16 j + g and + 8
      wa[w0 * D + 16 * j + g] = acc[j][0];
      wa[w1 * D + 16 * j + g] = acc[j][1];
      wa[w0 * D + 16 * j + g + 8] = acc[j][2];
      wa[w1 * D + 16 * j + g + 8] = acc[j][3];
    } else {  // dims 8 j + 2 t4 and + 1
      *reinterpret_cast<float2*>(wa + w0 * D + 8 * j + 2 * t4) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(wa + w1 * D + 8 * j + 2 * t4) = make_float2(acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();

  // the block's 4 warps merged in warp order, one thread a (row, 4 dims)
  constexpr int WF = L::WARP / 2;  // floats a warp's region
  const float* pf = reinterpret_cast<const float*>(tc_smem);
  for (int i = threadIdx.x; i < rows * (D / 4); i += PTC_THREADS) {
    const int r = i / (D / 4), d = 4 * (i % (D / 4));
    float mx = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < PTC_WARPS; ++w) mx = fmaxf(mx, pf[w * WF + r]);
    float lt = 0.f;
    float4 at = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < PTC_WARPS; ++w) {
      const float* f = pf + w * WF;
      const float wt = exp2_approx(f[r] - mx);
      lt = fmaf(f[ROWS + r], wt, lt);
      fma4(at, wt, *reinterpret_cast<const float4*>(f + 2 * ROWS + r * D + d));
    }
    if (chunks == 1) {
      const int fr = r0 + r;
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      float* o = out + (((size_t)b * C + fr % C) * Hq + h * G + fr / C) * D + d;
      *reinterpret_cast<float4*>(o) = make_float4(at.x * inv, at.y * inv, at.z * inv, at.w * inv);
    } else {
      *reinterpret_cast<float4*>(part + (prow + r) * D + d) = at;
      if (d == 0) {
        part[n * D + prow + r] = mx * TC_LN2;  // natural units, as the combine reads m
        part[n * D + n + prow + r] = lt;
      }
    }
  }
}

template <int D, bool TR>
cudaError_t launch_paged_tc(const __nv_bfloat16* q, const __nv_bfloat16* k_pages,
                            const __nv_bfloat16* v_pages, const int* tables, const int* q_start,
                            float* out, float* part, int B, int C, int Hq, int Hkv, int N, int P,
                            int nP, int chunks, float sm_scale, cudaStream_t stream) {
  using L = PagedTc<D, TR>;
  static unsigned long long smem_set = 0;
  auto kern = paged_attention_tc_kernel<D, TR>;
  cudaError_t e = set_smem_once(kern, L::BYTES, smem_set);
  if (e != cudaSuccess) return e;
  const int GC = (Hq / Hkv) * C;
  dim3 grid(B * Hkv, (GC + L::ROWS - 1) / L::ROWS, chunks);
  kern<<<grid, PTC_THREADS, L::BYTES, stream>>>(q, k_pages, v_pages, tables, q_start, out, part,
                                                C, Hq, Hkv, N, P, nP, sm_scale * TC_LOG2E);
  e = cudaGetLastError();
  if (e != cudaSuccess || chunks == 1) return e;
  dim3 cgrid(B * Hkv, (GC * (D / 4) + 255) / 256);
  paged_combine_kernel<<<cgrid, 256, 0, stream>>>(part, out, C, Hq, Hkv, D, chunks);
  return cudaGetLastError();
}

// rows: the folded-row tile the wrapper planned, 8 (transposed) when G*C <=
// 8 and 16 otherwise; chunks: ceil(nP * P / PTC_CHUNK). Anything else is
// refused, as is a head dim without an instantiation.
int paged_attention_tc(const __nv_bfloat16* q, const __nv_bfloat16* k_pages,
                       const __nv_bfloat16* v_pages, const int* tables, const int* q_start,
                       float* out, float* part, int B, int C, int Hq, int Hkv, int N, int P,
                       int D, int nP, int rows, int chunks, float sm_scale, cudaStream_t stream) {
  const int GC = (Hq / Hkv) * C;
  const long long S = (long long)nP * P;
  if (S > 0x7fffffffLL || rows != (GC <= 8 ? 8 : 16) ||
      chunks != (S + PTC_CHUNK - 1) / PTC_CHUNK || chunks > 65535)
    return cudaErrorInvalidValue;
#define REPRO_PAGED_TC_CASE(DD)                                                                 \
  case DD:                                                                                      \
    return rows == 8 ? launch_paged_tc<DD, true>(q, k_pages, v_pages, tables, q_start, out,     \
                                                 part, B, C, Hq, Hkv, N, P, nP, chunks,         \
                                                 sm_scale, stream)                              \
                     : launch_paged_tc<DD, false>(q, k_pages, v_pages, tables, q_start, out,    \
                                                  part, B, C, Hq, Hkv, N, P, nP, chunks,        \
                                                  sm_scale, stream);
  switch (D) {
    REPRO_PAGED_TC_CASE(16)
    REPRO_PAGED_TC_CASE(32)
    REPRO_PAGED_TC_CASE(64)
    REPRO_PAGED_TC_CASE(80)   // stablelm-3b
    REPRO_PAGED_TC_CASE(96)   // phi3-mini-3.8b
    REPRO_PAGED_TC_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_PAGED_TC_CASE
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

// The same with q, k_pages and v_pages in bf16, on the tensor cores
// (paged_attention_tc_kernel); out and part stay fp32. rows: 8 when G*C <= 8
// (the scores transposed), else 16; splits: the token chunks, ceil(nP * P /
// 128); part: B*Hkv*chunks*G*C*(D + 2) floats, unused with one chunk.
REPRO_API int paged_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k_pages,
                                   const __nv_bfloat16* v_pages, const int* tables,
                                   const int* q_start, float* out, float* part, int B, int C,
                                   int Hq, int Hkv, int N, int P, int D, int nP, int rows,
                                   int splits, float sm_scale, cudaStream_t stream) {
  return paged_attention_tc(q, k_pages, v_pages, tables, q_start, out, part, B, C, Hq, Hkv, N, P,
                            D, nP, rows, splits, sm_scale, stream);
}
