// The per-leaf jax.random.normal draw, fp32, sm_90a:
//   normal:          out[j] = z_a(offset + j)
//   normal_combine:  r = z_a * sa - (z_b * sb) * g   (z_a * sa without key b)
//                    out[j] = out[j] + r when accumulating, else r
// z_k(i) being the standard normal JAX draws at counter i under key k:
// threefry2x32(key, (i >> 32, i & 0xFFFFFFFF)), the word y0 ^ y1, the
// mantissa uniform on [nextafter(-1, 0), 1), XLA's float32 erf_inv, times
// sqrt(2) (csrc/erfinv.cuh).
//
// No TPU kernel behind it: the JAX package draws these with jnp's
// jax.random.normal, which XLA fuses into one pass over a leaf, in
// _noise_like behind corrected_noise (src/repro/core/noise_correction.py:
// 50-56) and in the admin masks (src/repro/core/masking.py:147-150,
// :189-196, :214). The port's per-leaf noise, its admin rows and the scan
// tier's noise stage draw here on the card: normal for a plain draw (an
// admin row's u), normal_combine for corrected_noise's window in one pass
// (xi_t and lam * xi_{t-1} of a leaf tensor added into the aggregate in
// place, at its counter offset) and for an admin xi with its correction.
// The scalars sa, sb, g are fp32 device words read in the kernel (sigma *
// C is a device value: no host copy, no stream wait), in
// corrected_noise's order: z.mul_(sc), zp.mul_(sc).mul_(gate), z.sub_(zp),
// flat.add_(z).
//
// Design: the layout of the wire tier's stream kernels
// (csrc/stream_grid.cuh): every block resident at once, each an equal
// contiguous share, NR_WIDTH consecutive elements a thread at a time,
// stored (and, accumulating, loaded) with one vector access where the
// group lies inside [0, n). One launch for any n: the indices are 64-bit
// and the counter is offset + j in 64 bits, split into (hi, lo) as the
// plain version splits its int64 counters, so a stacked leaf's tensors at
// their offsets and a counter past 2^32 draw what the whole leaf draws.
// Every operation is the plain version's, rounded where it rounds (the
// erf_inv steps in float64 rounded to float32 each), so the kernel equals
// kernels/prng/ref.py on the card bit for bit.
//   Bound on this card: instruction issue, not bytes (4 or 8 bytes an
// element). This build's loop spends a normal 168.75 arithmetic
// instructions (128 issue a clock an SM): 84 on the integer pipe (64 a
// clock; threefry and log1pf), 17 float32 <-> float64 conversions (16 a
// clock), 8 float64 multiply-adds. chip_smoke.py pins these counts
// and takes the bound from them (PERF.md's rows 17-18).
#include "common.cuh"
#include "erfinv.cuh"
#include "stream_grid.cuh"
#include "threefry.cuh"

#include <cstdint>

namespace {

constexpr int NR_THREADS = 128;
// elements a thread takes at a time
constexpr int NR_WIDTH = 4;

// what a launch writes: one key's normals; z_a * sa; z_a * sa - (z_b * sb)
// * g
enum Kind { DRAW = 0, SCALED = 1, CORRECTED = 2 };

ResidentCache nr_resident[3];

// The normal at counter i under key (k0, k1, k2 = key_parity(k0, k1)).
__device__ __forceinline__ float normal_at(uint32_t k0, uint32_t k1, uint32_t k2,
                                           unsigned long long i) {
  uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)i;
  repro_threefry::threefry2x32(k0, k1, k2, x0, x1);
  return repro_erfinv::normal_of_bits(x0 ^ x1);
}

// acc: add into out (SCALED, CORRECTED) rather than write it
template <int KIND>
__global__ void __launch_bounds__(NR_THREADS)
normal_kernel(float* __restrict__ out, long long n, StreamLayout lay, unsigned long long offset,
              uint32_t ka0, uint32_t ka1, uint32_t kb0, uint32_t kb1,
              const float* __restrict__ scalars_a, const float* __restrict__ scalars_b,
              const float* __restrict__ gate, int acc) {
  constexpr int W = NR_WIDTH;
  const uint32_t ka2 = repro_threefry::key_parity(ka0, ka1);
  const uint32_t kb2 = repro_threefry::key_parity(kb0, kb1);
  float sa = 0.0f, sb = 0.0f, g = 0.0f;
  if (KIND == SCALED || KIND == CORRECTED) sa = *scalars_a;
  if (KIND == CORRECTED) sb = *scalars_b, g = *gate;
  long long lo, hi;
  block_share(lay, lo, hi);
  for (long long j = lo + threadIdx.x; j < hi; j += NR_THREADS) {
    const long long e0 = W * j - lay.off;
    const bool whole = e0 >= 0 && e0 + W <= n;
    float v[W];
    if (KIND != DRAW && acc) load_group<W>(out, e0, n, whole, v);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      // an element outside [0, n) of a ragged group is drawn, not stored
      const unsigned long long i = offset + (unsigned long long)(e0 + k);
      float r = normal_at(ka0, ka1, ka2, i);
      if (KIND != DRAW) r = __fmul_rn(r, sa);
      if (KIND == CORRECTED)
        r = __fsub_rn(r, __fmul_rn(__fmul_rn(normal_at(kb0, kb1, kb2, i), sb), g));
      v[k] = KIND != DRAW && acc ? __fadd_rn(v[k], r) : r;
    }
    store_group<W>(out, e0, n, whole, v);
  }
}

template <int KIND>
cudaError_t launch(float* out, long long n, unsigned long long offset, uint32_t ka0,
                   uint32_t ka1, uint32_t kb0, uint32_t kb1, const float* sa, const float* sb,
                   const float* g, int acc, cudaStream_t stream) {
  StreamLayout lay = stream_layout<NR_WIDTH>(n, out, nullptr, nullptr, nullptr);
  unsigned blocks = 0;
  const cudaError_t err =
      stream_blocks(normal_kernel<KIND>, NR_THREADS, lay, nr_resident[KIND], blocks);
  if (err != cudaSuccess) return err;
  normal_kernel<KIND><<<blocks, NR_THREADS, 0, stream>>>(out, n, lay, offset, ka0, ka1, kb0,
                                                         kb1, sa, sb, g, acc);
  return cudaGetLastError();
}

}  // namespace

// out (n,) fp32 <- the normals of key (k0, k1) at counters offset ..
// offset + n - 1.
REPRO_API int normal_f32(float* out, long long n, unsigned long long offset, uint32_t k0,
                         uint32_t k1, cudaStream_t stream) {
  return launch<DRAW>(out, n, offset, k0, k1, 0, 0, nullptr, nullptr, nullptr, 0, stream);
}

// out (n,) fp32 <- (accumulate ? out + r : r), r = z_a * sa - (z_b * sb) * g,
// or z_a * sa when has_b is 0 (sb and g are not read then); sa, sb, g one
// fp32 word each in device memory.
REPRO_API int normal_combine_f32(float* out, long long n, unsigned long long offset,
                                 uint32_t ka0, uint32_t ka1, uint32_t kb0, uint32_t kb1,
                                 int has_b, const float* sa, const float* sb, const float* g,
                                 int accumulate, cudaStream_t stream) {
  if (has_b)
    return launch<CORRECTED>(out, n, offset, ka0, ka1, kb0, kb1, sa, sb, g, accumulate, stream);
  return launch<SCALED>(out, n, offset, ka0, ka1, 0, 0, sa, nullptr, nullptr, accumulate, stream);
}

// The launch configuration of normal_f32's kernel (kind 0) or of
// normal_combine_f32's with key b (kind 1) on the current device
// (stream_config of csrc/stream_grid.cuh).
REPRO_API int normal_config(int kind, int* cfg) {
  if (kind == 0) return stream_config(normal_kernel<DRAW>, NR_THREADS, NR_WIDTH, cfg);
  return stream_config(normal_kernel<CORRECTED>, NR_THREADS, NR_WIDTH, cfg);
}
