// The per-leaf jax.random.normal draw as device functions: the mantissa
// uniform on [nextafter(-1, 0), 1), XLA's float32 erf_inv and the scaling
// by sqrt(2), in the order of the plain version
// (src/repro_torch/kernels/prng/ref.py), which is the order XLA lowers
// jax.random.normal in.
//
// Bit-equality with the plain version on the card rests on three things:
//   - every float multiply and add is an explicit round-to-nearest
//     intrinsic (__fmul_rn, __fadd_rn, __fsub_rn), never contracted into a
//     fused multiply-add;
//   - each polynomial step c + p * w is one float64 __fma_rn rounded to
//     float32 with __double2float_rn: p and w hold 24-bit significands, so
//     p * w is exact in float64 and the fused step gives the bits of the
//     plain version's (c.double() + p.double() * w).float(), whose multiply
//     does not round; a float32 fmaf rounds to 24 bits once where this
//     rounds to 53 and then to 24, so it is another function;
//   - log1pf and sqrtf are CUDA's IEEE library calls, which torch's CUDA
//     log1p and sqrt call for float32 (nvcc's default flags, never
//     --use_fast_math).
// The coefficients are the float32 values of the plain version's tables,
// written as exact hexadecimal literals (a decimal float literal could
// round differently from torch's conversion of the Python double).
#pragma once

#include <cstdint>

namespace repro_erfinv {

// nextafter(-1, 0) in float32: the normal's uniform starts there
constexpr float LO = -0x1.fffffep-1f;
// sqrt(2) rounded to float32
constexpr float SQRT2 = 0x1.6a09e6p+0f;

// A threefry word -> the float32 uniform on [LO, 1): the high 23 bits as a
// mantissa in [1, 2), minus 1, then max(LO, u * (1 - LO) + LO).
__device__ __forceinline__ float uniform_lo1(uint32_t bits) {
  const float u = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float v = __fadd_rn(__fmul_rn(u, __fsub_rn(1.0f, LO)), LO);
  return fmaxf(LO, v);
}

// w = -log1p(x * -x), the variable erf_inv's polynomials are taken in.
__device__ __forceinline__ float erfinv_w(float x) { return -log1pf(__fmul_rn(x, -x)); }

// XLA's float32 erf_inv: p(w) * x, +-inf at +-1.
__device__ __forceinline__ float erfinv(float x) {
  const float w0 = erfinv_w(x);
  const bool lt = w0 < 5.0f;
  const double w = (double)(lt ? __fsub_rn(w0, 2.5f) : __fsub_rn(sqrtf(w0), 3.0f));
  // Giles' polynomials, highest degree first: w < 5, then w >= 5
  constexpr double LT5[9] = {0x1.e2cb1p-26,  0x1.70966cp-22, -0x1.d8e6aep-19,
                             -0x1.26b582p-18, 0x1.ca65b6p-13, -0x1.48a81p-10,
                             -0x1.11c9dep-8, 0x1.f91ec6p-3,   0x1.805c5ep+0};
  constexpr double GE5[9] = {-0x1.a3e136p-13, 0x1.a76ad6p-14, 0x1.61b8e4p-10,
                             -0x1.e17bcep-9,  0x1.7824f6p-8,  -0x1.f38baep-8,
                             0x1.354afcp-7,   0x1.006db6p+0,  0x1.6a9efcp+1};
  float p = (float)(lt ? LT5[0] : GE5[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    const double c = lt ? LT5[i] : GE5[i];
    p = __double2float_rn(__fma_rn((double)p, w, c));
  }
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7f800000)) : __fmul_rn(p, x);
}

// The standard normal of one threefry word.
__device__ __forceinline__ float normal_of_bits(uint32_t bits) {
  return __fmul_rn(SQRT2, erfinv(uniform_lo1(bits)));
}

}  // namespace repro_erfinv
