// Per-example sums of squares, (B, D) -> (B,) fp32, sm_90a:
//   out[b] = sum_d g[b, d]^2
//
// Replaces the TPU kernel src/repro/kernels/dp_clip/dp_clip.py:
//   per_example_sumsq (_sumsq_kernel, :26, def :42, pallas_call :48)
// On the per-leaf clip path (kernels/dp_clip/ops.py, _clip_and_sum_perleaf)
// g is one leaf's columns of the (B, P) per-example gradient buffer: B rows
// of the leaf's D elements, ld = P apart, read in place. The per-leaf sums
// add up to each example's squared norm.
//
// Design: the TPU kernel carries each row's partial sum across the grid's
// D axis in VMEM; here blocks run in parallel, so the rows are cut over a
// (nblk, B) grid and reduced in two passes (kernels/csrc/rowsq.cuh): block
// partials in fp64, then one warp per row adds them in a fixed order. No
// atomics: two launches give the same bits. fp64 accumulation makes the
// result the fp32 rounding of an almost exact sum; the plain version's
// chunked fp32 dot products agree to about 1e-7 relative.
//   Bound on this card: bytes. Every element is read once (B * D * 4
// bytes), two flops each; the fp64 adds and fp32->fp64 conversions cost
// about a fifth of the read at the card's fp64 and conversion rates.
#include "common.cuh"
#include "rowsq.cuh"

namespace {

__global__ void rowsq_final(const double* __restrict__ partial, int nblk,
                            float* __restrict__ out) {
  const double total = repro_rowsq::rowsq_total(partial, nblk, blockIdx.x);
  if (threadIdx.x == 0) out[blockIdx.x] = (float)total;
}

}  // namespace

// g (B, D) fp32 rows ld apart; out (B,) fp32; partial (B * nblk) fp64
// scratch. vec != 0 when D and ld are multiples of 4 and g is 16-byte
// aligned.
REPRO_API int per_example_sumsq_f32(const float* g, float* out, double* partial, int B,
                                    long long D, long long ld, int vec, int nblk,
                                    cudaStream_t stream) {
  repro_rowsq::launch_rowsq_partial(g, B, D, ld, vec, nblk, partial, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rowsq_final<<<B, 32, 0, stream>>>(partial, nblk, out);
  return cudaGetLastError();
}
