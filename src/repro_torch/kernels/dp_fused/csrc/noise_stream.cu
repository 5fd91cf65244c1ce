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
// Design: the layout of clip_mask.cu (csrc/stream_grid.cuh): every block
// resident at once, each an equal contiguous share, each thread NS_WIDTH
// consecutive elements at a time, their normals through normals_z0's
// pipeline (one chain's threefry rounds beside the other's float tail) and
// stored with one vector store where the group lies inside [0, P) (element
// by element at the ragged ends). Indices are 64-bit; the counter keeps
// JAX's uint32 wrap. Each normal is normal_z0's operations in its order,
// the arithmetic clip_mask_kernel runs for its in-kernel xi, with nvcc's
// default flags (logf and sqrtf as torch's CUDA log and sqrt): the stream
// is bit-equal to the plain version and to the stream clip_mask draws for
// the same key and silo, so a contribution built from a cached stream is
// the serial one bit for bit.
//   Bound on this card: instruction issue, not bytes. One normal an element
// (128.75 instructions in clip_mask's SASS, one element a thread) against
// 4 bytes written; at the wire tier's P = 235,520 a launch is about a
// quarter of clip_mask's four-stream issue bound, near the launch floor
// (PERF.md's findings on the stream kernels).
#include "common.cuh"
#include "stream_grid.cuh"
#include "threefry.cuh"

#include <cstdint>

namespace {

constexpr int NS_THREADS = 128;
// elements a thread takes at a time
constexpr int NS_WIDTH = 2;
// normals a pipeline stage (normals_z0 of threefry.cuh)
constexpr int NS_STAGE = 1;
// register budget: 7 blocks an SM, so that the wire tier's P = 235,520
// (920 blocks) is one resident wave
constexpr int NS_MIN_BLOCKS = 7;

ResidentCache ns_resident;

__global__ void __launch_bounds__(NS_THREADS, NS_MIN_BLOCKS)
noise_stream_kernel(float* __restrict__ out, long long P, StreamLayout lay, uint32_t k0,
                    uint32_t k1, uint32_t silo) {
  using namespace repro_threefry;
  constexpr int W = NS_WIDTH;
  const uint32_t k2 = key_parity(k0, k1);
  long long lo, hi;
  block_share(lay, lo, hi);
  for (long long j = lo + threadIdx.x; j < hi; j += NS_THREADS) {
    const long long e0 = W * j - lay.off;
    uint32_t c0[W], c1[W];
#pragma unroll
    for (int k = 0; k < W; ++k) c0[k] = (uint32_t)(e0 + k), c1[k] = silo;
    float z[W];
    normals_z0<W, (NS_STAGE < W ? NS_STAGE : W)>(k0, k1, k2, c0, c1, z);
    store_group<W>(out, e0, P, e0 >= 0 && e0 + W <= P, z);
  }
}

}  // namespace

// out (P,) fp32; (k0, k1) the stream's raw key, silo its stream id.
REPRO_API int noise_stream_f32(float* out, long long P, uint32_t k0, uint32_t k1,
                               uint32_t silo, cudaStream_t stream) {
  StreamLayout lay = stream_layout<NS_WIDTH>(P, out, nullptr, nullptr, nullptr);
  unsigned blocks = 0;
  const cudaError_t err =
      stream_blocks(noise_stream_kernel, NS_THREADS, lay, ns_resident, blocks);
  if (err != cudaSuccess) return err;
  noise_stream_kernel<<<blocks, NS_THREADS, 0, stream>>>(out, P, lay, k0, k1, silo);
  return cudaGetLastError();
}

// The launch configuration of noise_stream_kernel on the current device
// (stream_config of csrc/stream_grid.cuh).
REPRO_API int noise_stream_config(int* cfg) {
  return stream_config(noise_stream_kernel, NS_THREADS, NS_WIDTH, cfg);
}
