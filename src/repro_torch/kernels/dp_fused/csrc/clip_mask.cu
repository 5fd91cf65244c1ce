// One silo's contribution on the barrier tier, fp32, sm_90a:
//   out[p] = g[p] * scale + b * (r_silo[p] - r_nxt[p]) + s * xi_t^silo[p]
//            - lam * (s_prev * xi_{t-1}^silo[p])
//
// Replaces the TPU kernel src/repro/kernels/dp_fused/dp_fused.py:
//   clip_mask_pallas (_clip_mask_kernel, :137, def :171, pallas_call :202)
// The clip, the zero-sum pairwise mask over the ring of active silos, the
// silo's noise share and its lambda-correction share, in one pass. Every
// stream is regenerated from its 8-byte key: the first Box-Muller normal of
// threefry2x32(key, (c0 = (uint32)p, c1 = stream id)), the stream id being
// `silo` for r_i, xi_t and xi_{t-1} and `nxt` for r_nxt, the counter the
// global packed index, as in the TPU kernel. The masks and the noise never
// touch device memory.
//
// Design: the layout of noise_batch.cu. One thread per element in a
// grid-stride loop with a 64-bit index (P is past 2^31 at full depth of
// qwen2.5-3b; the counter keeps JAX's uint32 wrap). The five scalars
// (scale, s, b, lam, s_prev) come as a device array, the TPU kernel's SMEM
// operand, so the caller keeps them on the card without a host sync. Each
// multiply and add is an explicit __fmul_rn / __fadd_rn / __fsub_rn in the
// reference's order (no FMA contraction) while logf and sqrtf keep nvcc's
// default flags: bit-equal to the plain version. use_pairwise == 0 skips
// both r streams, use_prev == 0 the xi_{t-1} stream; with use_prev set the
// xi_{t-1} stream is drawn even where lam is 0, as in JAX. out may be g
// (the barrier tier writes each contribution over its packed row): each
// element is read and written by one thread, once, so g and out carry no
// __restrict__.
//   Bound on this card: instruction issue, not bytes. Four threefry
// normals an element (about 137 arithmetic instructions each in
// noise_batch's SASS, 66 of them on the INT32 pipe) against 8 bytes of
// memory traffic an element.
#include "common.cuh"
#include "threefry.cuh"

#include <cstdint>

namespace {

constexpr int CM_THREADS = 256;

__global__ void __launch_bounds__(CM_THREADS)
clip_mask_kernel(const float* g, float* out, long long P, uint32_t kr0, uint32_t kr1,
                 uint32_t kx0, uint32_t kx1, uint32_t kp0, uint32_t kp1, uint32_t silo,
                 uint32_t nxt, const float* __restrict__ scalars, int use_pairwise,
                 int use_prev) {
  using namespace repro_threefry;
  const float scale = scalars[0], s = scalars[1], b = scalars[2], lam = scalars[3],
              s_prev = scalars[4];
  const uint32_t kr2 = key_parity(kr0, kr1), kx2 = key_parity(kx0, kx1),
                 kp2 = key_parity(kp0, kp1);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < P; p += stride) {
    const uint32_t c0 = (uint32_t)p;
    float acc = __fmul_rn(g[p], scale);
    if (use_pairwise) {
      const float r_i = normal_z0(kr0, kr1, kr2, c0, silo);
      const float r_nxt = normal_z0(kr0, kr1, kr2, c0, nxt);
      acc = __fadd_rn(acc, __fmul_rn(b, __fsub_rn(r_i, r_nxt)));
    }
    acc = __fadd_rn(acc, __fmul_rn(s, normal_z0(kx0, kx1, kx2, c0, silo)));
    if (use_prev) {
      const float xp = normal_z0(kp0, kp1, kp2, c0, silo);
      acc = __fsub_rn(acc, __fmul_rn(lam, __fmul_rn(s_prev, xp)));
    }
    out[p] = acc;
  }
}

}  // namespace

// g, out (P,) fp32, equal or disjoint; scalars (5,) fp32 on the device:
// scale, s, b, lam, s_prev.
REPRO_API int clip_mask_f32(const float* g, float* out, long long P, uint32_t kr0,
                            uint32_t kr1, uint32_t kx0, uint32_t kx1, uint32_t kp0,
                            uint32_t kp1, uint32_t silo, uint32_t nxt, const float* scalars,
                            int use_pairwise, int use_prev, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long blocks = (P + CM_THREADS - 1) / CM_THREADS;
  const long long cap = (long long)sms * 8;  // 2048 threads per SM resident
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  clip_mask_kernel<<<(unsigned)blocks, CM_THREADS, 0, stream>>>(
      g, out, P, kr0, kr1, kx0, kx1, kp0, kp1, silo, nxt, scalars, use_pairwise, use_prev);
  return cudaGetLastError();
}
