// Threefry-2x32 and Box-Muller normals as device functions, the CUDA twin of
// src/repro_torch/kernels/zsmask/threefry.py (and of the JAX package's
// src/repro/kernels/zsmask/threefry.py, which the TPU kernels inline).
//
// Bits: 20 rounds of add / rotate / xor on uint32 with a key injection every
// 4 rounds, exactly as JAX's threefry2x32; the rotate is one funnel shift.
// Floats: every multiply and add is an explicit round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn), which nvcc never contracts into a fused
// multiply-add, so the association is the JAX package's operation for
// operation and the result matches the plain torch version (separate ops)
// bit for bit, whatever -fmad says. logf and sqrtf are the IEEE library
// calls (never --use_fast_math), as torch.log and torch.sqrt use them.
#pragma once

#include <cstdint>

namespace repro_threefry {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t k2,
                                             uint32_t& x0, uint32_t& x1) {
  // k2 = k0 ^ k1 ^ 0x1BD11BDA, computed once per thread by the caller
  const uint32_t ks[3] = {k0, k1, k2};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__device__ __forceinline__ uint32_t key_parity(uint32_t k0, uint32_t k1) {
  return k0 ^ k1 ^ 0x1BD11BDAu;
}

// uint32 -> float32 uniform in (0, 1]
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __fmul_rn(__fadd_rn(__uint2float_rn(bits), 1.0f), 2.3283064365386963e-10f);
}

// cos(2*pi*u) for u in [0, 1]: -poly((2u - 1)^2), Horner order as in JAX
__device__ __forceinline__ float cos_turn(float u) {
  const float x = __fadd_rn(__fmul_rn(2.0f, u), -1.0f);
  const float t = __fmul_rn(x, x);
  float acc = -1.035682435e-04f;
  acc = __fadd_rn(__fmul_rn(acc, t), 1.928504556e-03f);
  acc = __fadd_rn(__fmul_rn(acc, t), -2.580626495e-02f);
  acc = __fadd_rn(__fmul_rn(acc, t), 2.353304178e-01f);
  acc = __fadd_rn(__fmul_rn(acc, t), -1.335262775e+00f);
  acc = __fadd_rn(__fmul_rn(acc, t), 4.058712006e+00f);
  acc = __fadd_rn(__fmul_rn(acc, t), -4.934802055e+00f);
  acc = __fadd_rn(__fmul_rn(acc, t), 1.000000000e+00f);
  return -acc;
}

// sin(2*pi*u) for u in [0, 1]: -x * poly((2u - 1)^2)
__device__ __forceinline__ float sin_turn(float u) {
  const float x = __fadd_rn(__fmul_rn(2.0f, u), -1.0f);
  const float t = __fmul_rn(x, x);
  float acc = -2.173679604e-05f;
  acc = __fadd_rn(__fmul_rn(acc, t), 4.661239800e-04f);
  acc = __fadd_rn(__fmul_rn(acc, t), -7.370326202e-03f);
  acc = __fadd_rn(__fmul_rn(acc, t), 8.214584738e-02f);
  acc = __fadd_rn(__fmul_rn(acc, t), -5.992645025e-01f);
  acc = __fadd_rn(__fmul_rn(acc, t), 2.550163984e+00f);
  acc = __fadd_rn(__fmul_rn(acc, t), -5.167712688e+00f);
  acc = __fadd_rn(__fmul_rn(acc, t), 3.141592741e+00f);
  return -__fmul_rn(x, acc);
}

// One Box-Muller pair of standard normals from counters (c0, c1).
__device__ __forceinline__ void normal_pair(uint32_t k0, uint32_t k1, uint32_t k2,
                                            uint32_t c0, uint32_t c1, float& z0, float& z1) {
  threefry2x32(k0, k1, k2, c0, c1);
  const float rad = sqrtf(__fmul_rn(-2.0f, logf(uniform01(c0))));
  const float u2 = uniform01(c1);
  z0 = __fmul_rn(rad, cos_turn(u2));
  z1 = __fmul_rn(rad, sin_turn(u2));
}

// The first normal of the pair only: the noise streams never read the
// second, so the sine is skipped.
__device__ __forceinline__ float normal_z0(uint32_t k0, uint32_t k1, uint32_t k2,
                                           uint32_t c0, uint32_t c1) {
  threefry2x32(k0, k1, k2, c0, c1);
  const float rad = sqrtf(__fmul_rn(-2.0f, logf(uniform01(c0))));
  return __fmul_rn(rad, cos_turn(uniform01(c1)));
}

// threefry2x32 of chains [b, e), in place: chain n's counters (x0[n], x1[n])
// under its key (k0[n], k1[n], k2[n]), the chains advanced round by round.
__device__ __forceinline__ void threefry_chains(const uint32_t* k0, const uint32_t* k1,
                                                const uint32_t* k2, uint32_t* x0, uint32_t* x1,
                                                int b, int e) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
#pragma unroll
  for (int n = b; n < e; ++n) {
    x0[n] += k0[n];
    x1[n] += k1[n];
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int n = b; n < e; ++n) {
        x0[n] += x1[n];
        x1[n] = rotl32(x1[n], rot[i % 2][j]);
        x1[n] ^= x0[n];
      }
    }
#pragma unroll
    for (int n = b; n < e; ++n) {
      const uint32_t ks[3] = {k0[n], k1[n], k2[n]};
      x0[n] += ks[(i + 1) % 3];
      x1[n] += ks[(i + 2) % 3] + (uint32_t)(i + 1);
    }
  }
}

// N normals at once, normal_z0 of each chain n: key (k0[n], k1[n], k2[n]),
// counters (c0[n], c1[n]). The chains go through in stages of S: stage s's
// threefry rounds (integer work, most of it on the INT32 pipe, which issues
// at half rate) sit in one basic block with stage s-1's log and cosine
// (float work on the FP32 pipe), so the two pipes overlap inside a warp;
// then stage s-1's square roots (each a branch to its slow path, which
// ends a basic block). Integer rounds in any order give the same bits, and
// each normal keeps normal_z0's float operations in its order: bit-equal to
// N calls of normal_z0.
template <int N, int S>
__device__ __forceinline__ void normals_z0(const uint32_t (&k0)[N], const uint32_t (&k1)[N],
                                           const uint32_t (&k2)[N], const uint32_t (&c0)[N],
                                           const uint32_t (&c1)[N], float (&z)[N]) {
  static_assert(N % S == 0, "stages of S chains");
  uint32_t x0[N], x1[N];
  float m[N], c[N];
#pragma unroll
  for (int n = 0; n < N; ++n) x0[n] = c0[n], x1[n] = c1[n];
#pragma unroll
  for (int st = 0; st <= N / S; ++st) {
    if (st < N / S) threefry_chains(k0, k1, k2, x0, x1, st * S, st * S + S);
    if (st > 0) {
#pragma unroll
      for (int n = (st - 1) * S; n < st * S; ++n) {
        m[n] = __fmul_rn(-2.0f, logf(uniform01(x0[n])));
        c[n] = cos_turn(uniform01(x1[n]));
      }
#pragma unroll
      for (int n = (st - 1) * S; n < st * S; ++n) z[n] = __fmul_rn(sqrtf(m[n]), c[n]);
    }
  }
}

// N normals of one key (k0, k1, k2) at counters (c0[n], c1[n]).
template <int N, int S>
__device__ __forceinline__ void normals_z0(uint32_t k0, uint32_t k1, uint32_t k2,
                                           const uint32_t (&c0)[N], const uint32_t (&c1)[N],
                                           float (&z)[N]) {
  uint32_t a[N], b[N], c[N];
#pragma unroll
  for (int n = 0; n < N; ++n) a[n] = k0, b[n] = k1, c[n] = k2;
  normals_z0<N, S>(a, b, c, c0, c1, z);
}

}  // namespace repro_threefry
