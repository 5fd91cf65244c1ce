// Corrected DP noise of the fused tier, all silos in one launch, fp32, sm_90a:
//   out[p] = g[p] + sum_i ( s_i * xi_t^i[p] - lam_i * s_prev * xi_{t-1}^i[p] )
//
// Replaces the TPU kernel src/repro/kernels/dp_fused/dp_fused.py:
//   noise_batch_pallas (_noise_batch_kernel, :219, pallas_call :255)
// Every stream is regenerated from its 8-byte key: xi^i[p] is the first
// Box-Muller normal of threefry2x32(key, (c0 = (uint32)p, c1 = i)), the
// counter being the global packed index, as in the TPU kernel, so the noise
// lands on the same parameters as in the JAX package. Nothing of the noise
// touches device memory.
//
// Design: one thread per element in a grid-stride loop with a 64-bit index
// (P is past 2^31 at full depth of qwen2.5-3b; the counter keeps JAX's
// uint32 wrap). The thread folds the silos' shares onto g in silo order,
// each share built as the TPU kernel builds it,
//   share = (0 + s_i * xi) - lam_i * (s_prev * xp);  acc = acc + share,
// with explicit __fmul_rn / __fadd_rn (no FMA contraction): bit-equal to the
// plain version. The (n,) scale and gate vectors are device arrays (n reaches
// 400 in the scale-out); keys and s_prev are arguments. use_prev == 0 skips
// the xi_{t-1} streams. When use_prev is set the xi_{t-1} streams are drawn
// even where lam_i is 0 (a gated-off correction), as in JAX.
//   Bound on this card: instruction issue, not bytes. Each element costs
// 2 * n noise streams, each a threefry2x32 (20 rounds of add / rotate /
// xor, the adds split by the compiler between the INT32 pipe's IADD3 and the
// FP32 pipe's IMAD), a log, a sqrt and an 8-term polynomial: about 137
// arithmetic instructions a stream in the SASS, 66 of them on the 64 INT32
// lanes of an SM, against 8 bytes of memory traffic an element.
#include "common.cuh"
#include "threefry.cuh"

#include <cstdint>

namespace {

constexpr int NB_THREADS = 256;

__global__ void __launch_bounds__(NB_THREADS)
noise_batch_kernel(const float* __restrict__ g, float* __restrict__ out, long long P,
                   uint32_t kx0, uint32_t kx1, uint32_t kp0, uint32_t kp1,
                   const float* __restrict__ scales, const float* __restrict__ lams, int n,
                   float s_prev, int use_prev) {
  using namespace repro_threefry;
  const uint32_t kx2 = key_parity(kx0, kx1), kp2 = key_parity(kp0, kp1);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < P; p += stride) {
    const uint32_t c0 = (uint32_t)p;
    float acc = g[p];
    for (int i = 0; i < n; ++i) {
      float share = __fadd_rn(0.0f, __fmul_rn(__ldg(scales + i),
                                              normal_z0(kx0, kx1, kx2, c0, (uint32_t)i)));
      if (use_prev) {
        const float xp = normal_z0(kp0, kp1, kp2, c0, (uint32_t)i);
        share = __fsub_rn(share, __fmul_rn(__ldg(lams + i), __fmul_rn(s_prev, xp)));
      }
      acc = __fadd_rn(acc, share);
    }
    out[p] = acc;
  }
}

}  // namespace

// g, out (P,) fp32, distinct; scales, lams (n,) fp32 on the device.
REPRO_API int noise_batch_f32(const float* g, float* out, long long P, uint32_t kx0,
                              uint32_t kx1, uint32_t kp0, uint32_t kp1, const float* scales,
                              const float* lams, int n, float s_prev, int use_prev,
                              cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long blocks = (P + NB_THREADS - 1) / NB_THREADS;
  const long long cap = (long long)sms * 8;  // 2048 threads per SM resident
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  noise_batch_kernel<<<(unsigned)blocks, NB_THREADS, 0, stream>>>(
      g, out, P, kx0, kx1, kp0, kp1, scales, lams, n, s_prev, use_prev);
  return cudaGetLastError();
}
