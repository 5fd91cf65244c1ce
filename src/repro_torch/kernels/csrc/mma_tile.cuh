// Tensor-core tiles for the port's bf16 attention kernels (sm_90a): warp-level
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate), ldmatrix and 16-byte
// cp.async, by inline PTX (no CUTLASS).
//
// Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k16"; g = lane / 4,
// t = lane % 4):
//   A (16 x 16, row major), 4 registers of two bf16: a0 (row g, cols 2t,
//     2t+1), a1 (row g+8, same cols), a2 (row g, cols 2t+8, 2t+9), a3 (row
//     g+8, cols 2t+8, 2t+9).
//   B (16 x 8, k x n), 2 registers: b0 (k rows 2t, 2t+1, col g), b1 (k rows
//     2t+8, 2t+9, col g).
//   C (16 x 8, fp32), 4 floats: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row
//     g+8, same cols).
// A C fragment of two neighbouring n-tiles is, element for element, the A
// fragment of one k-step over those 16 columns (FA2's layout trick): a
// score tile goes from the accumulator to the next product's A operand in
// registers, with no round trip through shared memory (a_from_c).
//
// Shared memory holds bf16 rows as they are in device memory, D values at a
// stride of D + 8 (TC_PAD): a row of D 16..128 (a multiple of 16) is whole
// 16-byte chunks, and the 16 bytes of padding shift successive rows by 4
// banks (mod 32: rows 0..7 of an ldmatrix phase land on 8 disjoint bank
// quads at every instantiated D), so ldmatrix has no bank conflicts.
//
// The two-term split: an fp32 operand x (the bf16 backward's softmax
// probability or score gradient) enters the tensor cores as hi =
// bf16_rn(x) and lo = bf16_rn(x - hi); x - hi is exact in fp32, and |x -
// hi - lo| <= 2^-16 |x| (8 bits of hi, then 8 of lo), where one bf16
// operand alone keeps 2^-9. Its product
// with a bf16 operand is two mma into one fp32 accumulator, hi first.
// Operands that are bf16 already (q, k, v, dout) enter once, exactly.
// The three-term split (split3) goes on: mid = bf16_rn(x - hi), lo =
// bf16_rn(x - hi - mid). x - hi holds at most 16 significant bits of x's 24
// and x - hi - mid at most 8, so lo is exact and hi + mid + lo == x (for
// |x| >= 2^-110, where lo stays a normal bf16): the operand enters whole,
// at three mma (the forwards' P, bf16 paged attention's P, every fp32
// operand).
//
// fp32 operands on both sides (the fp32 training pair): each enters as its
// three terms, and a product keeps the six term products above 2^-24 of
// it (mid mid, lo hi, hi lo, mid hi, hi mid, hi hi, smallest first: mma_x5
// and mma_x6_add; mid lo, lo mid and lo lo are dropped). An fp32 tile that every
// warp reads is staged by cp.async and split once a block into three bf16
// planes (X3Rows), which ldmatrix reads as it reads a bf16 tile; an
// operand that one warp keeps is split once, from device memory, into its
// fragments (a_frag_x3).
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

constexpr int TC_PAD = 8;  // bf16 values of padding a shared row

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from gmem to smem, or 16 zero bytes when !valid (src-size 0:
// nothing is read; gmem need only be a valid address).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0));
}

// Four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i of lane l holds its row l / 4, elements 2(l % 4)
// and +1 (.trans: the transposed matrix's).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b (16 x 16 by 16 x 8), fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU (ex2.approx.ftz: within 2 ulp; 2^-inf = 0). The softmax
// exponentials fold their scale into one FMA in base 2: exp(s c - m) =
// 2^(s c log2(e) - m log2(e)).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float TC_LOG2E = 1.4426950408889634f;
constexpr float TC_LN2 = 0.6931471805599453f;

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<unsigned*>(&h);
}

// The two-term split of (x, y): hi and lo as two packed bf16 (x in the low
// half, the lower column).
__device__ __forceinline__ void split2(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The three-term split of (x, y): hi, mid and lo as packed bf16, hi + mid +
// lo == x exactly (and y).
__device__ __forceinline__ void split3(float x, float y, unsigned& hi, unsigned& mid,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;  // exact
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(__floats2bfloat162_rn(rx - mf.x, ry - mf.y));  // exact
}

// The hi and lo A fragments of k-step j of a 16-row fp32 tile held as C
// fragments c[n-tile][4]: n-tiles 2j and 2j+1.
__device__ __forceinline__ void a_from_c(const float (&c0)[4], const float (&c1)[4],
                                         unsigned (&hi)[4], unsigned (&lo)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// The same in three terms (split3).
__device__ __forceinline__ void a_from_c3(const float (&c0)[4], const float (&c1)[4],
                                          unsigned (&hi)[4], unsigned (&mid)[4],
                                          unsigned (&lo)[4]) {
  split3(c0[0], c0[1], hi[0], mid[0], lo[0]);
  split3(c0[2], c0[3], hi[1], mid[1], lo[1]);
  split3(c1[0], c1[1], hi[2], mid[2], lo[2]);
  split3(c1[2], c1[3], hi[3], mid[3], lo[3]);
}

// Shared bf16 tile of rows at stride D + TC_PAD.
template <int D>
struct TcRows {
  static_assert(D % 16 == 0 && D <= 128, "whole k-steps of 16");
  static constexpr int ST = D + TC_PAD;  // row stride (bf16 values)
  static constexpr int CH = D / 8;       // 16-byte chunks a row

  // Start the copies of n <= NMAX rows into dst: row r from g + r * gs
  // (elements); rows n..NMAX-1 are zero-filled.
  template <int NMAX, int THREADS>
  __device__ static void load(__nv_bfloat16* dst, const __nv_bfloat16* g, long long gs, int n) {
    for (int i = threadIdx.x; i < NMAX * CH; i += THREADS) {
      const int r = i / CH, c = 8 * (i % CH);
      const bool ok = r < n;
      cp_async16_zfill(dst + r * ST + c, ok ? g + r * gs + c : g, ok);
    }
  }

  // A fragment of rows r0..r0+15, k-step kk, of a row-major tile.
  __device__ static void a_frag(unsigned (&a)[4], const __nv_bfloat16* s, int r0, int kk) {
    const int l = threadIdx.x & 31;
    ldsm_x4(a, s + (r0 + (l & 15)) * ST + 16 * kk + 8 * (l >> 4));
  }

  // B fragments (b0, b1 of n-tiles n0/8 and n0/8 + 1) of s^T, k-step kk:
  // rows n0..n0+15 of s are the product's columns, its D the depth.
  __device__ static void bt_frag(unsigned (&b)[4], const __nv_bfloat16* s, int n0, int kk) {
    const int l = threadIdx.x & 31;
    ldsm_x4(b, s + (n0 + (l & 7) + 8 * (l >> 4)) * ST + 16 * kk + 8 * ((l >> 3) & 1));
  }

  // B fragments of s itself, k-step over rows k0..k0+15, n-tiles of
  // columns d0..d0+7 and d0+8..d0+15 (ldmatrix.trans).
  __device__ static void b_frag(unsigned (&b)[4], const __nv_bfloat16* s, int k0, int d0) {
    const int l = threadIdx.x & 31;
    ldsm_x4_t(b, s + (k0 + (l & 15)) * ST + d0 + 8 * (l >> 4));
  }
};

// The five smaller of the six products of split3 operands (all but hi hi),
// smallest first, into the accumulators of two n-tiles: a[t] is term t of
// the A fragment (0 hi, 1 mid, 2 lo), b[t] term t's B fragments of the two
// n-tiles (b[t][0..1] and b[t][2..3], as bt_frag and b_frag give them). The
// two n-tiles alternate, so neighbouring mma are independent.
__device__ __forceinline__ void mma_x5(float (&c0)[4], float (&c1)[4], const unsigned (&a)[3][4],
                                       const unsigned (&b)[3][4]) {
#define REPRO_MMA_X(i, j)                  \
  mma_bf16(c0, a[i], b[j][0], b[j][1]); \
  mma_bf16(c1, a[i], b[j][2], b[j][3]);
  REPRO_MMA_X(1, 1)
  REPRO_MMA_X(2, 0)
  REPRO_MMA_X(0, 2)
  REPRO_MMA_X(1, 0)
  REPRO_MMA_X(0, 1)
#undef REPRO_MMA_X
}

// c += a b for operands given whole as split3 terms, in a sum that runs
// over many k-steps (P V, dV, dK, dQ): the six products from zero in the
// tensor cores, hi hi last, then one fp32 add each into c. The tensor
// cores' fp32 accumulation does not round to nearest: a sum of 1536 mma
// steps kept in them (a dv of S 4096) drifted by 1.1-1.7e-4 on an H100,
// all one way, where the add rounds each step to nearest.
__device__ __forceinline__ void mma_x6_add(float (&c0)[4], float (&c1)[4],
                                           const unsigned (&a)[3][4],
                                           const unsigned (&b)[3][4]) {
  float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
  mma_x5(t0, t1, a, b);
  mma_bf16(t0, a[0], b[0][0], b[0][1]);
  mma_bf16(t1, a[0], b[0][2], b[0][3]);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    c0[e] += t0[e];
    c1[e] += t1[e];
  }
}

__device__ __forceinline__ void unpack4(unsigned (&a)[4], uint4 x) {
  a[0] = x.x, a[1] = x.y, a[2] = x.z, a[3] = x.w;
}

__device__ __forceinline__ uint4 pack4(const unsigned (&a)[4]) {
  return make_uint4(a[0], a[1], a[2], a[3]);
}

// The A fragments of rows 0..15 of an fp32 tile in device memory (row r at
// g + r * gs; rows r >= n read as 0), k-step kk, as split3's three terms:
// a[0] hi, a[1] mid, a[2] lo.
__device__ __forceinline__ void a_frag_x3(unsigned (&a)[3][4], const float* g, long long gs,
                                          int n, int kk) {
  const int l = threadIdx.x & 31, r = l >> 2, c = 16 * kk + 2 * (l & 3);
  float2 x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = r + 8 * (i & 1), cc = c + 8 * (i >> 1);
    x[i] = rr < n ? __ldg(reinterpret_cast<const float2*>(g + rr * gs + cc)) : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) split3(x[i].x, x[i].y, a[0][i], a[1][i], a[2][i]);
}

// NMAX rows of D fp32 values (the fp32 training pair's walked tiles): staged
// by cp.async at a stride of D floats, then split once a block into three
// bf16 planes, hi, mid and lo, NMAX rows each at TcRows' stride, one after
// the other, for ldmatrix.
template <int D>
struct X3Rows {
  static constexpr int ST = TcRows<D>::ST;
  static constexpr int CH = D / 4;  // 16-byte chunks an fp32 row

  // Start the copies of n <= NMAX rows into dst: row r from g + r * gs; rows
  // n..NMAX-1 are zero-filled.
  template <int NMAX, int THREADS>
  __device__ static void load(float* dst, const float* g, long long gs, int n) {
    for (int i = threadIdx.x; i < NMAX * CH; i += THREADS) {
      const int r = i / CH, c = 4 * (i % CH);
      const bool ok = r < n;
      cp_async16_zfill(dst + r * D + c, ok ? g + r * gs + c : g, ok);
    }
  }

  // The staged rows src into the planes at dst, dst + NMAX ST, dst + 2 NMAX
  // ST. Call with the copies landed and visible to every thread.
  template <int NMAX, int THREADS>
  __device__ static void split(__nv_bfloat16* dst, const float* src) {
    for (int i = threadIdx.x; i < NMAX * CH; i += THREADS) {
      const int r = i / CH, c = 4 * (i % CH);
      const float4 x = *reinterpret_cast<const float4*>(src + r * D + c);
      uint2 h, m, l;
      split3(x.x, x.y, h.x, m.x, l.x);
      split3(x.z, x.w, h.y, m.y, l.y);
      __nv_bfloat16* d = dst + r * ST + c;
      *reinterpret_cast<uint2*>(d) = h;
      *reinterpret_cast<uint2*>(d + NMAX * ST) = m;
      *reinterpret_cast<uint2*>(d + 2 * NMAX * ST) = l;
    }
  }
};
