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
// Design: the layout of csrc/stream_grid.cuh: every block resident at once
// (the blocks an SM read once per device), each block an equal contiguous
// share, each thread CM_WIDTH consecutive elements at a time, one vector
// load of g and store of out where the group lies inside [0, P) and g is
// aligned as out is (element by element otherwise), the next group's loads
// issued before this group's arithmetic. The group's normals go through
// normals_z0<N, CM_STAGE> of threefry.cuh, a pipeline in which one stage's
// threefry rounds (INT32 pipe) and the stage before's log and cosine (FP32
// pipe) share a basic block: all four streams of the group in one pipeline
// when every stream is drawn (row 8's flags), else stream group after
// stream group. Indices are 64-bit (P is past 2^31 at full depth of
// qwen2.5-3b); the counter keeps JAX's uint32 wrap. The five scalars
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
// normals an element (128.75 instructions each in the SASS of the
// one-element-a-thread layout this one replaced, 62.75 of them on the INT32
// pipe, which issues at half the rate) against 8 bytes of memory traffic an
// element. Why this layout and not one element a thread (the layout
// before) or four (16-byte accesses): PERF.md's findings on the stream
// kernels.
//
// clip_mask_kernel<true> (clip_mask_ext_f32), the same function with xi_t
// and xi_{t-1} read from (P,) fp32 buffers (no TPU kernel behind it: the JAX
// package sends external streams to its jnp reference,
// src/repro/kernels/dp_fused/ops.py:61-71). It
// serves the wire tier's speculative rounds, whose handlers keep a silo's
// xi_t from round t as its xi_{t-1} at t+1 and prefetch xi_{t+1}, both drawn
// by noise_stream.cu. The r streams are drawn as above; a null xi or xp
// pointer draws that stream in the kernel instead. Both instantiations run
// one body, so given noise_stream's buffers the external-stream kernel
// equals clip_mask_kernel<false> bit for bit. Bound: two streams an
// element (r_i, r_nxt) against 16 bytes (g, xi, xp read, out written).
#include "common.cuh"
#include "stream_grid.cuh"
#include "threefry.cuh"

#include <cstdint>
#include <type_traits>

namespace {

constexpr int CM_THREADS = 128;
// elements a thread takes at a time
constexpr int CM_WIDTH = 2;
// normals a pipeline stage (threefry_chains / normals_z0 of threefry.cuh)
constexpr int CM_STAGE = 2;
// register budget: 7 blocks an SM (73 registers a thread), so that the wire
// tier's P = 235,520 (920 blocks) is one resident wave
constexpr int CM_MIN_BLOCKS = 7;

ResidentCache cm_resident[2];

// Which streams a launch draws: every one (row 8: the barrier and wire
// tiers' contribution), the four in one pipeline; or any other combination
// of the flags (row 14 draws r_i and r_nxt and reads xi_t and xi_{t-1}),
// each stream group drawn after the other.
enum { DRAW_ALL = 0, ANY_FLAGS = 1 };

// The W elements from e0 with their inputs gv (g), xv, vv (xi_t, xi_{t-1}
// where read) into acc, in the reference's order of operations.
template <int MODE, int W>
__device__ __forceinline__ void contribution(long long e0, const float (&gv)[W], float (&xv)[W],
                                             float (&vv)[W], float (&acc)[W], uint32_t kr0,
                                             uint32_t kr1, uint32_t kr2, uint32_t kx0,
                                             uint32_t kx1, uint32_t kx2, uint32_t kp0,
                                             uint32_t kp1, uint32_t kp2, uint32_t silo,
                                             uint32_t nxt, float scale, float s, float b,
                                             float lam, float s_prev, bool pair, bool prev,
                                             bool draw_x, bool draw_v) {
  using namespace repro_threefry;
  constexpr int S = CM_STAGE;
  float r[2 * W];
  if constexpr (MODE == DRAW_ALL) {
    // element k's four normals are chains 4k .. 4k+3: r_i, r_nxt, xi, xi_{t-1}
    uint32_t k0[4 * W], k1[4 * W], k2[4 * W], c0[4 * W], c1[4 * W];
    float z[4 * W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const uint32_t key[4][3] = {{kr0, kr1, kr2}, {kr0, kr1, kr2}, {kx0, kx1, kx2},
                                  {kp0, kp1, kp2}};
      const uint32_t id[4] = {silo, nxt, silo, silo};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        k0[4 * k + q] = key[q][0], k1[4 * k + q] = key[q][1], k2[4 * k + q] = key[q][2];
        c0[4 * k + q] = (uint32_t)(e0 + k), c1[4 * k + q] = id[q];
      }
    }
    normals_z0<4 * W, (S < 4 * W ? S : 4 * W)>(k0, k1, k2, c0, c1, z);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      r[k] = z[4 * k], r[W + k] = z[4 * k + 1], xv[k] = z[4 * k + 2], vv[k] = z[4 * k + 3];
    }
  } else {
    uint32_t c0[2 * W], c1[2 * W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      c0[2 * k] = c0[2 * k + 1] = (uint32_t)(e0 + k);
      c1[2 * k] = silo, c1[2 * k + 1] = nxt;
    }
    if (pair) {
      float z[2 * W];
      normals_z0<2 * W, (S < 2 * W ? S : 2 * W)>(kr0, kr1, kr2, c0, c1, z);
#pragma unroll
      for (int k = 0; k < W; ++k) r[k] = z[2 * k], r[W + k] = z[2 * k + 1];
    }
    uint32_t cx[W], cs[W];
#pragma unroll
    for (int k = 0; k < W; ++k) cx[k] = (uint32_t)(e0 + k), cs[k] = silo;
    if (draw_x) normals_z0<W, (S < W ? S : W)>(kx0, kx1, kx2, cx, cs, xv);
    if (prev && draw_v) normals_z0<W, (S < W ? S : W)>(kp0, kp1, kp2, cx, cs, vv);
  }
#pragma unroll
  for (int k = 0; k < W; ++k) {
    acc[k] = __fmul_rn(gv[k], scale);
    if (MODE == DRAW_ALL || pair) acc[k] = __fadd_rn(acc[k], __fmul_rn(b, __fsub_rn(r[k], r[W + k])));
    acc[k] = __fadd_rn(acc[k], __fmul_rn(s, xv[k]));
    if (MODE == DRAW_ALL || prev)
      acc[k] = __fsub_rn(acc[k], __fmul_rn(lam, __fmul_rn(s_prev, vv[k])));
  }
}

// EXT = false: row 8, every stream drawn in the kernel (xi, xp unused).
// EXT = true: the external-stream kernel, xi_t and xi_{t-1} read from xi and
// xp where those are not null. One body, so both keep one operation order.
template <bool EXT>
__global__ void __launch_bounds__(CM_THREADS, CM_MIN_BLOCKS)
clip_mask_kernel(const float* g, const float* __restrict__ xi, const float* __restrict__ xp,
                 float* out, long long P, StreamLayout lay, uint32_t kr0, uint32_t kr1,
                 uint32_t kx0, uint32_t kx1, uint32_t kp0, uint32_t kp1, uint32_t silo,
                 uint32_t nxt, const float* __restrict__ scalars, int use_pairwise,
                 int use_prev) {
  using namespace repro_threefry;
  constexpr int W = CM_WIDTH;
  const float scale = scalars[0], s = scalars[1], b = scalars[2], lam = scalars[3],
              s_prev = scalars[4];
  const uint32_t kr2 = key_parity(kr0, kr1), kx2 = key_parity(kx0, kx1),
                 kp2 = key_parity(kp0, kp1);
  const bool pair = use_pairwise != 0, prev = use_prev != 0;
  const bool read_x = EXT && xi != nullptr, read_v = EXT && prev && xp != nullptr;
  long long lo, hi;
  block_share(lay, lo, hi);
  // the groups of this thread, each one's loads issued a group ahead
  auto groups = [&](auto mode) {
    constexpr int MODE = decltype(mode)::value;
    float gv[W], xv[W], vv[W];
    auto load = [&](long long j, float (&gg)[W], float (&xx)[W], float (&pp)[W]) {
      const long long e0 = W * j - lay.off;
      const bool vec = lay.vec && e0 >= 0 && e0 + W <= P;
      load_group<W>(g, e0, P, vec, gg);
      if (read_x) load_group<W>(xi, e0, P, vec, xx);
      if (read_v) load_group<W>(xp, e0, P, vec, pp);
    };
    long long j = lo + threadIdx.x;
    if (j < hi) load(j, gv, xv, vv);
    for (; j < hi; j += CM_THREADS) {
      float gn[W], xn[W], vn[W], acc[W];
      if (j + CM_THREADS < hi) load(j + CM_THREADS, gn, xn, vn);
      const long long e0 = W * j - lay.off;
      contribution<MODE, W>(e0, gv, xv, vv, acc, kr0, kr1, kr2, kx0, kx1, kx2, kp0, kp1, kp2,
                            silo, nxt, scale, s, b, lam, s_prev, pair, prev, !read_x,
                            !read_v);
      store_group<W>(out, e0, P, e0 >= 0 && e0 + W <= P, acc);
#pragma unroll
      for (int k = 0; k < W; ++k) {
        gv[k] = gn[k];
        if (read_x) xv[k] = xn[k];
        if (read_v) vv[k] = vn[k];
      }
    }
  };
  if (pair && prev && !read_x && !read_v)
    groups(std::integral_constant<int, DRAW_ALL>());
  else
    groups(std::integral_constant<int, ANY_FLAGS>());
}

template <bool EXT>
int launch_clip_mask(const float* g, const float* xi, const float* xp, float* out,
                     long long P, uint32_t kr0, uint32_t kr1, uint32_t kx0, uint32_t kx1,
                     uint32_t kp0, uint32_t kp1, uint32_t silo, uint32_t nxt,
                     const float* scalars, int use_pairwise, int use_prev,
                     cudaStream_t stream) {
  StreamLayout lay = stream_layout<CM_WIDTH>(P, out, g, xi, use_prev ? xp : nullptr);
  unsigned blocks = 0;
  const cudaError_t err = stream_blocks(clip_mask_kernel<EXT>, CM_THREADS, lay,
                                        cm_resident[EXT], blocks);
  if (err != cudaSuccess) return err;
  clip_mask_kernel<EXT><<<blocks, CM_THREADS, 0, stream>>>(
      g, xi, xp, out, P, lay, kr0, kr1, kx0, kx1, kp0, kp1, silo, nxt, scalars,
      use_pairwise, use_prev);
  return cudaGetLastError();
}

}  // namespace

// g, out (P,) fp32, equal or disjoint; scalars (5,) fp32 on the device:
// scale, s, b, lam, s_prev.
REPRO_API int clip_mask_f32(const float* g, float* out, long long P, uint32_t kr0,
                            uint32_t kr1, uint32_t kx0, uint32_t kx1, uint32_t kp0,
                            uint32_t kp1, uint32_t silo, uint32_t nxt, const float* scalars,
                            int use_pairwise, int use_prev, cudaStream_t stream) {
  return launch_clip_mask<false>(g, nullptr, nullptr, out, P, kr0, kr1, kx0, kx1, kp0, kp1,
                                 silo, nxt, scalars, use_pairwise, use_prev, stream);
}

// clip_mask_f32 with xi, xp (P,) fp32 buffers on the device, each disjoint
// from out or null (then drawn in the kernel from kx / kp).
REPRO_API int clip_mask_ext_f32(const float* g, const float* xi, const float* xp, float* out,
                                long long P, uint32_t kr0, uint32_t kr1, uint32_t kx0,
                                uint32_t kx1, uint32_t kp0, uint32_t kp1, uint32_t silo,
                                uint32_t nxt, const float* scalars, int use_pairwise,
                                int use_prev, cudaStream_t stream) {
  return launch_clip_mask<true>(g, xi, xp, out, P, kr0, kr1, kx0, kx1, kp0, kp1, silo, nxt,
                                scalars, use_pairwise, use_prev, stream);
}

// The launch configuration of clip_mask_kernel<ext != 0> on the current
// device (stream_config of csrc/stream_grid.cuh: threads, elements a thread
// at a time, blocks an SM, registers, local bytes).
REPRO_API int clip_mask_config(int ext, int* cfg) {
  return ext ? stream_config(clip_mask_kernel<true>, CM_THREADS, CM_WIDTH, cfg)
             : stream_config(clip_mask_kernel<false>, CM_THREADS, CM_WIDTH, cfg);
}
