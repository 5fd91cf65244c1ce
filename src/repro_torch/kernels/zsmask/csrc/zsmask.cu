// Per-leaf zero-sum DP mask on a static ring, fp32, sm_90a:
//   out[p] = g[p] + (b * (r_silo[p] - r_nxt[p]) + s * xi_silo[p])
//
// Replaces the TPU kernel src/repro/kernels/zsmask/zsmask.py:
//   zsmask_pallas (_zsmask_kernel, :25, def :51, pallas_call :65)
// The per-leaf execution policy's pairwise mask: one launch per leaf (per
// layer of a stacked leaf) and per silo, the keys folded with the leaf's
// index by the caller (core/masking.py). Each stream is regenerated from
// its 8-byte key: the first Box-Muller normal of
// threefry2x32(key, (c0 = offset + p, c1 = stream id)), the stream id being
// `silo` for r_i and xi and `nxt` = (silo + 1) % n for r_nxt. `offset` puts
// a tensor of a stacked leaf at its place in the whole leaf's counters (the
// JAX ref's offset; the TPU kernel takes whole flats only), and c0 wraps as
// JAX's uint32 index does. The mask never touches device memory.
//
// Design: the layout of clip_mask.cu, which draws the same streams. One
// thread per element in a grid-stride loop with a 64-bit index. The two
// scalars (s = sigma_c / sqrt(n), b) come as a device array, the TPU
// kernel's SMEM operand, so the caller keeps them on the card without a
// host sync. Each multiply and add is an explicit __fmul_rn / __fadd_rn /
// __fsub_rn in the reference's order (no FMA contraction) while logf and
// sqrtf keep nvcc's default flags: bit-equal to the plain version. The r
// streams are drawn whatever b is (b = 0 in the mask-only pass of the
// lambda correction), as the TPU kernel draws them. out may be g: each
// element is read and written by one thread, once.
//   Bound on this card: instruction issue, not bytes. Three threefry
// normals an element (about 129 arithmetic instructions each in
// clip_mask's SASS) against 8 bytes of memory traffic an element.
#include "common.cuh"
#include "threefry.cuh"

#include <cstdint>

namespace {

constexpr int ZS_THREADS = 256;

__global__ void __launch_bounds__(ZS_THREADS)
zsmask_kernel(const float* g, float* out, long long D, uint32_t kr0, uint32_t kr1,
              uint32_t kx0, uint32_t kx1, uint32_t silo, uint32_t nxt, uint32_t offset,
              const float* __restrict__ scalars) {
  using namespace repro_threefry;
  const float s = scalars[0], b = scalars[1];
  const uint32_t kr2 = key_parity(kr0, kr1), kx2 = key_parity(kx0, kx1);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < D; p += stride) {
    const uint32_t c0 = (uint32_t)p + offset;
    const float r_i = normal_z0(kr0, kr1, kr2, c0, silo);
    const float r_nxt = normal_z0(kr0, kr1, kr2, c0, nxt);
    const float xi = normal_z0(kx0, kx1, kx2, c0, silo);
    const float mask = __fadd_rn(__fmul_rn(b, __fsub_rn(r_i, r_nxt)), __fmul_rn(s, xi));
    out[p] = __fadd_rn(g[p], mask);
  }
}

}  // namespace

// g, out (D,) fp32, equal or disjoint; scalars (2,) fp32 on the device:
// s, b. offset is the counter of g[0].
REPRO_API int zsmask_f32(const float* g, float* out, long long D, uint32_t kr0,
                         uint32_t kr1, uint32_t kx0, uint32_t kx1, uint32_t silo,
                         uint32_t nxt, uint32_t offset, const float* scalars,
                         cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long blocks = (D + ZS_THREADS - 1) / ZS_THREADS;
  const long long cap = (long long)sms * 8;  // 2048 threads per SM resident
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  zsmask_kernel<<<(unsigned)blocks, ZS_THREADS, 0, stream>>>(
      g, out, D, kr0, kr1, kx0, kx1, silo, nxt, offset, scalars);
  return cudaGetLastError();
}
