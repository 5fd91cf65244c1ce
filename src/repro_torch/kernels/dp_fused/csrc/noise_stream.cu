// One silo's standard-normal stream, fp32, sm_90a:
//   out[p] = the first Box-Muller normal of threefry2x32(key, ((uint32)p, silo))
//
// No TPU kernel behind it: the JAX package draws this stream with the jnp
// `_silo_stream` (src/repro/core/dp_pipeline.py:74) behind
// `DPPipeline.noise_stream` (:302), and its wire tier's speculative handler
// passes the stream to the contribution as an argument. The port draws it
// here, so that a stream cached from round t (as round t+1's xi_{t-1}) or
// prefetched for round t+1 lies in device memory, and clip_mask's
// external-stream variant (clip_mask.cu) reads it there.
//
// Design: the layout of clip_mask.cu. One thread per element in a
// grid-stride loop with a 64-bit index; the counter keeps JAX's uint32
// wrap. The normal is `normal_z0` of threefry.cuh, the very device function
// clip_mask_kernel calls for its in-kernel xi, with nvcc's default flags
// (logf and sqrtf as torch's CUDA log and sqrt): the stream is bit-equal to
// the plain version and to the stream clip_mask draws for the same key and
// silo, so a contribution built from a cached stream is the serial one bit
// for bit.
//   Bound on this card: instruction issue, not bytes. One normal an element
// (about 129 arithmetic instructions in clip_mask's SASS) against 4 bytes
// written; at the wire tier's P = 235,520 a launch is about a quarter of
// clip_mask's four-stream issue bound, near the launch floor.
#include "common.cuh"
#include "threefry.cuh"

#include <cstdint>

namespace {

constexpr int NS_THREADS = 256;

__global__ void __launch_bounds__(NS_THREADS)
noise_stream_kernel(float* __restrict__ out, long long P, uint32_t k0, uint32_t k1,
                    uint32_t silo) {
  using namespace repro_threefry;
  const uint32_t k2 = key_parity(k0, k1);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < P; p += stride)
    out[p] = normal_z0(k0, k1, k2, (uint32_t)p, silo);
}

}  // namespace

// out (P,) fp32; (k0, k1) the stream's raw key, silo its stream id.
REPRO_API int noise_stream_f32(float* out, long long P, uint32_t k0, uint32_t k1,
                               uint32_t silo, cudaStream_t stream) {
  unsigned blocks = 0;
  // 8 blocks an SM: 2048 threads resident
  const cudaError_t err = grid_stride_blocks(P, NS_THREADS, 8, blocks);
  if (err != cudaSuccess) return err;
  noise_stream_kernel<<<blocks, NS_THREADS, 0, stream>>>(out, P, k0, k1, silo);
  return cudaGetLastError();
}
