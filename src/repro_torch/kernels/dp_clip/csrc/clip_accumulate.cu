// Masked aggregate of the fused DP tier: out[p] = sum_i g[i, p] * scale[i],
// fp32, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/dp_clip/dp_clip.py:
//   clip_accumulate (_clip_accum_kernel, :46, pallas_call :77)
// On the training path g is the stacked (n_silos, P) packed gradient buffer
// and scale the per-silo clip factors (zeroed for dropped silos), so the sum
// is sum_i clip(g_i) (core/dp_pipeline.py masked_aggregate). On the
// per-leaf clip path g is one leaf's columns of the (B, P) per-example
// buffer, rows ld = P apart, read in place; clip_sum.cu runs it as its
// last phase.
//
// Design: each thread owns 4 consecutive columns at a time (one 16-byte load
// per row when P % 4 == 0 and the buffers are 16-byte aligned; scalar
// otherwise) and folds the rows in silo order, acc = 0; acc = acc + g[i]*s[i],
// with __fmul_rn / __fadd_rn so nothing contracts into an FMA: the result is
// bit-equal to the plain version's explicit left fold. A grid-stride loop
// with 64-bit offsets covers any P (the stacked buffer is past 2^31
// elements at 12 layers of qwen2.5-3b, n = 4).
//   Bound on this card: bytes. Every element of g is read once and the
// output written once, (n + 1) * P * 4 bytes, one multiply-add per element
// read: far below the fp32 ridge. The TPU kernel carried the partial sum
// across the grid's row axis in VMEM; here a whole column stays in a
// thread's registers, so there is no cross-block reduction at all.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int CA_THREADS = 256;

__global__ void __launch_bounds__(CA_THREADS)
clip_accumulate_kernel(const float* __restrict__ g, const float* __restrict__ scale,
                       float* __restrict__ out, int n, long long P, long long ld, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = vec ? P / 4 : 0;
  for (long long v = tid; v < nvec; v += stride) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < n; ++i) {
      const float s = __ldg(scale + i);
      const float4 x = __ldg(reinterpret_cast<const float4*>(g + (long long)i * ld) + v);
      acc.x = __fadd_rn(acc.x, __fmul_rn(x.x, s));
      acc.y = __fadd_rn(acc.y, __fmul_rn(x.y, s));
      acc.z = __fadd_rn(acc.z, __fmul_rn(x.z, s));
      acc.w = __fadd_rn(acc.w, __fmul_rn(x.w, s));
    }
    reinterpret_cast<float4*>(out)[v] = acc;
  }
  for (long long p = nvec * 4 + tid; p < P; p += stride) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(g + (long long)i * ld + p), __ldg(scale + i)));
    out[p] = acc;
  }
}

}  // namespace

// g (n, P) fp32 with rows ld floats apart (ld = P: contiguous); scale
// (n,) fp32; out (P,) fp32. vec != 0 when P and ld are multiples of 4 and
// g, out are 16-byte aligned.
REPRO_API int clip_accumulate_f32(const float* g, const float* scale, float* out, int n,
                                  long long P, long long ld, int vec, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long work = vec ? (P + 3) / 4 : P;
  long long blocks = (work + CA_THREADS - 1) / CA_THREADS;
  const long long cap = (long long)sms * 16;  // enough blocks in flight to saturate HBM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  clip_accumulate_kernel<<<(unsigned)blocks, CA_THREADS, 0, stream>>>(g, scale, out, n, P, ld,
                                                                    vec);
  return cudaGetLastError();
}
