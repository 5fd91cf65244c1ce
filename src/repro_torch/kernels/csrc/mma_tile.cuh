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
// The two-term split: an fp32 operand x (a softmax probability or a score
// gradient) enters the tensor cores as hi = bf16_rn(x) and lo = bf16_rn(x -
// hi); x - hi is exact in fp32, and |x - hi - lo| <= 2^-16 |x| (8 bits of
// hi, then 8 of lo), where one bf16 operand alone keeps 2^-9. Its product
// with a bf16 operand is two mma into one fp32 accumulator, hi first.
// Operands that are bf16 already (q, k, v, dout) enter once, exactly.
// The three-term split (split3) goes on: mid = bf16_rn(x - hi), lo =
// bf16_rn(x - hi - mid). x - hi holds at most 16 significant bits of x's 24
// and x - hi - mid at most 8, so lo is exact and hi + mid + lo == x (for
// |x| >= 2^-110, where lo stays a normal bf16): the operand enters whole,
// at three mma.
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
