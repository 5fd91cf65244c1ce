// Per-example clip and sum over the packed (B, P) buffer, fp32, sm_90a:
//   norms[b] = sqrt(max(sum_p g[b, p]^2, 1e-30))
//   sum[p]   = sum_b g[b, p] * min(1, C / norms[b])
//
// Replaces the TPU kernel src/repro/kernels/dp_fused/dp_fused.py:
//   clip_sum_pallas (_clip_sum_kernel, :54, def :100, pallas_call :109)
// DP-SGD per-example clipping in one call (core/clipping.py,
// per_example_clipped_grad, packed route): the clipped per-example tensor
// (B * P) never exists in device memory.
//
// Design: the TPU kernel runs its two phases on one sequential grid,
// carrying the norms from phase 0 to phase 1 in VMEM. Here the phases are
// launches on one stream, which orders them without a grid-wide barrier:
//   1. rowsq_partial (kernels/csrc/rowsq.cuh, shared with sumsq.cu): the
//      rows' fp64 partial sums of squares over a (nblk, B) grid;
//   2. clip_scales: one warp per row adds the partials in a fixed order,
//      rounds to fp32 and writes the norm and min(1, C / norm), with
//      fmaxf / sqrtf / __fdiv_rn / fminf as the plain version's
//      clamp / sqrt / division / minimum (C read from the device);
//   3. clip_accumulate_f32 (dp_clip/csrc/clip_accumulate.cu): the fold
//      acc = 0; acc = acc + g[b] * scale[b] over b, __fmul_rn / __fadd_rn.
// Given the same norms the sum is bit-equal to the plain version's left
// fold; the norms are fp32 roundings of fp64 sums. Deterministic: no
// atomics, fixed reduction orders.
//   Bound on this card: bytes. The function reads g once and writes the
// sum and the norms, (B + 1) * P * 4 bytes; this two-pass design reads g
// twice, (2B + 1) * P * 4 bytes, the TPU kernel's own floor.
#include "common.cuh"
#include "rowsq.cuh"

extern "C" int clip_accumulate_f32(const float* g, const float* scale, float* out, int n,
                                   long long P, long long ld, int vec, cudaStream_t stream);

namespace {

__global__ void clip_scales(const double* __restrict__ partial, int nblk,
                            const float* __restrict__ clip_bound, float* __restrict__ norms,
                            float* __restrict__ scale) {
  const double total = repro_rowsq::rowsq_total(partial, nblk, blockIdx.x);
  if (threadIdx.x == 0) {
    const float norm = sqrtf(fmaxf((float)total, 1e-30f));
    norms[blockIdx.x] = norm;
    scale[blockIdx.x] = fminf(1.0f, __fdiv_rn(clip_bound[0], norm));
  }
}

}  // namespace

// g (B, P) fp32 contiguous; sum (P,), norms (B,), scale (B,) fp32;
// partial (B * nblk) fp64 scratch; clip_bound (1,) fp32 on the device. vec
// != 0 when P % 4 == 0 and g, sum are 16-byte aligned.
REPRO_API int clip_sum_f32(const float* g, float* sum, float* norms, float* scale,
                           double* partial, const float* clip_bound, int B, long long P,
                           int vec, int nblk, cudaStream_t stream) {
  repro_rowsq::launch_rowsq_partial(g, B, P, P, vec, nblk, partial, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  clip_scales<<<B, 32, 0, stream>>>(partial, nblk, clip_bound, norms, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return clip_accumulate_f32(g, scale, sum, B, P, P, vec, stream);
}
