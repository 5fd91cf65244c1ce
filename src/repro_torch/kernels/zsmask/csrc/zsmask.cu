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
//
// zsmask_buffer_kernel (zsmask_buffer_f32): the same mask over every tensor of
// a packed buffer in one launch, the per-leaf policy's whole contribution
// of one silo (core/dp_pipeline.py, _contribution_perleaf), replacing one
// zsmask launch per leaf tensor (and, with the lambda correction, a second
// zsmask over zeros, a multiply and a subtraction per leaf tensor). A
// device table holds one entry per tensor in the buffer's order (its
// buffer offset, numel, leaf index i, counter offset inside the leaf and
// start in the prefix of all tensors' elements; core/flatbuf.leaf_table),
// built once per layout; padding is never touched. Each block folds leaf
// i's keys itself, as core/masking.fold_leaf does: k + 0x9E3779B9 * (i + 1)
// on both words of key_r, 0x85EBCA6B for key_xi and prev_key, in uint32.
// PREV = true (lambda > 0) goes on with the correction's pass in the
// reference's order, prev = 0 + (0 * (r_i - r_nxt) + s * xp), xp drawn on
// the folded prev_key, then out = out - lam * prev: the per-leaf route's
// ops, but r_i and r_nxt drawn once, 4 normals an element instead of 6.
// The multiply by zero stays: the bits must match where a normal is not
// finite. Work split: the stream kernels' (csrc/stream_grid.cuh), every
// block resident, each an equal contiguous share of the concatenated
// elements, one element a thread at a time (a share crosses few tensor
// boundaries); the block finds its first tensor by a search over the
// prefix, held in shared memory, and walks the tensors its share covers.
// Each element's normals go through normals_z0 of threefry.cuh, one chain
// a stage: bit-equal to the per-leaf kernel's normal_z0 calls. The scalars
// are device words, read by every thread with no host sync: sigma_c, b and
// lam as the caller holds them, s = sigma_c / sqrt(n) divided here in
// fp32 (correctly rounded, as the per-leaf route's torch ops on the card).
//   Bound: issue, as zsmask_kernel: 3 normals an element (4 with PREV).
//
// zsmask_buffer_bf16 (the bf16 / bf16_prev instantiations, In =
// __nv_bfloat16): the same walk, keys and normals over the bf16 leaves of
// a bf16 or mixed tree (the table holds only those leaves' tensors; the
// fp32 instantiation takes the fp32 leaves' table in a second launch).
// It reads the clipped leaves from a packed bf16 buffer, x = bf16(g *
// scale), and writes the fp32 contribution row, in the order the JAX
// package's barrier step evaluates a bf16 leaf's perleaf contribution
// (kernels/zsmask/ref.py, zsmask_buffer_bf16_ref): m = bf16_rn(x + mask);
// with PREV, p = bf16_rn(0 + (0 * d + s * xp)) and out = fma(-lam, p, m),
// one rounding, as XLA's CPU backend contracts m - lam * p (lam is a
// strong fp32 inside the step, so the leaf's contribution is fp32);
// without PREV out = m, a bf16 value widened. Every rounding to bf16 is
// __float2bfloat16_rn, every fp32 op __fadd_rn / __fmul_rn / __fmaf_rn:
// bit-equal to the plain version.
//   Bound: issue, as the fp32 instantiation (3 normals an element, 4 with
// PREV) over 6 bytes an element (a bf16 read, an fp32 write) against 8.
#include "common.cuh"
#include "stream_grid.cuh"
#include "threefry.cuh"

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

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

constexpr int ZT_THREADS = 128;
// the table's columns (core/flatbuf.leaf_table): buffer offset, numel, leaf
// index, counter offset inside the leaf (uint32), start in the prefix
constexpr int ZT_COLS = 5;
constexpr uint32_t R_FOLD = 0x9E3779B9u, XI_FOLD = 0x85EBCA6Bu;

ResidentCache zb_resident[4];  // [PREV + 2 * bf16]

// In = float: src is buf, masked in place (the fp32 instantiations); In =
// __nv_bfloat16: src the packed bf16 clipped leaves, buf the fp32 row.
template <bool PREV, typename In>
__global__ void __launch_bounds__(ZT_THREADS)
zsmask_buffer_kernel(const In* src, float* buf, const long long* __restrict__ table, int E,
                     long long total, long long share, int rem, uint32_t kr0, uint32_t kr1,
                     uint32_t kx0, uint32_t kx1, uint32_t kp0, uint32_t kp1, uint32_t silo,
                     uint32_t nxt, uint32_t n_silos, const float* __restrict__ sigma_c,
                     const float* __restrict__ b_scale, const float* __restrict__ lam_gate) {
  using namespace repro_threefry;
  constexpr int N = PREV ? 4 : 3;
  extern __shared__ long long start[];  // E + 1: the prefix, total last
  for (int e = threadIdx.x; e < E; e += ZT_THREADS) start[e] = table[(long long)e * ZT_COLS + 4];
  if (threadIdx.x == 0) start[E] = total;
  __syncthreads();
  const float s = __fdiv_rn(*sigma_c, __fsqrt_rn((float)n_silos)), b = *b_scale;
  const float lam = PREV ? *lam_gate : 0.0f;
  const int blk = blockIdx.x;
  const long long lo = (long long)blk * share + (blk < rem ? blk : rem);
  const long long hi = lo + share + (blk < rem ? 1 : 0);
  // the last tensor that starts at or before lo
  int a = 0, z = E;
  while (z - a > 1) {
    const int m = (a + z) >> 1;
    if (start[m] <= lo) a = m; else z = m;
  }
  for (int e = a; e < E && start[e] < hi; ++e) {
    const long long* row = table + (long long)e * ZT_COLS;
    const long long off = row[0], e0 = start[e];
    const uint32_t leaf = (uint32_t)row[2], ctr = (uint32_t)row[3];
    const uint32_t dr = R_FOLD * (leaf + 1u), dx = XI_FOLD * (leaf + 1u);
    uint32_t k0[N], k1[N], k2[N], c1[N];
    k0[0] = k0[1] = kr0 + dr, k1[0] = k1[1] = kr1 + dr;
    k0[2] = kx0 + dx, k1[2] = kx1 + dx;
    if constexpr (PREV) k0[N - 1] = kp0 + dx, k1[N - 1] = kp1 + dx;
#pragma unroll
    for (int n = 0; n < N; ++n) k2[n] = key_parity(k0[n], k1[n]);
    c1[0] = silo, c1[1] = nxt, c1[2] = silo;
    if constexpr (PREV) c1[N - 1] = silo;
    const long long p1 = start[e + 1] < hi ? start[e + 1] : hi;
    for (long long p = (e0 > lo ? e0 : lo) + threadIdx.x; p < p1; p += ZT_THREADS) {
      const long long q = p - e0;
      uint32_t c0[N];
#pragma unroll
      for (int n = 0; n < N; ++n) c0[n] = (uint32_t)q + ctr;
      float zv[N];
      normals_z0<N, 1>(k0, k1, k2, c0, c1, zv);
      const float d = __fsub_rn(zv[0], zv[1]);
      const float mask = __fadd_rn(__fmul_rn(b, d), __fmul_rn(s, zv[2]));
      float o;
      if constexpr (std::is_same_v<In, float>) {
        o = __fadd_rn(src[off + q], mask);
      } else {
        o = __bfloat162float(__float2bfloat16_rn(__fadd_rn(__bfloat162float(src[off + q]), mask)));
      }
      if constexpr (PREV) {
        const float prev = __fadd_rn(0.0f, __fadd_rn(__fmul_rn(0.0f, d), __fmul_rn(s, zv[N - 1])));
        if constexpr (std::is_same_v<In, float>) {
          o = __fsub_rn(o, __fmul_rn(lam, prev));
        } else {
          o = __fmaf_rn(-lam, __bfloat162float(__float2bfloat16_rn(prev)), o);
        }
      }
      buf[off + q] = o;
    }
  }
}

template <bool PREV, typename In>
int launch_zsmask_buffer(const In* src, float* buf, const long long* table, int E,
                         long long total, uint32_t kr0, uint32_t kr1, uint32_t kx0, uint32_t kx1,
                         uint32_t kp0, uint32_t kp1, uint32_t silo, uint32_t nxt,
                         uint32_t n_silos, const float* sigma_c, const float* b_scale,
                         const float* lam_gate, cudaStream_t stream) {
  constexpr int slot = (PREV ? 1 : 0) + (std::is_same_v<In, float> ? 0 : 2);
  int resident = 0;
  cudaError_t err = resident_blocks(zsmask_buffer_kernel<PREV, In>, ZT_THREADS, zb_resident[slot],
                                    resident);
  if (err != cudaSuccess) return err;
  long long blocks = (total + ZT_THREADS - 1) / ZT_THREADS;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  const size_t smem = (size_t)(E + 1) * sizeof(long long);
  zsmask_buffer_kernel<PREV, In><<<(unsigned)blocks, ZT_THREADS, smem, stream>>>(
      src, buf, table, E, total, total / blocks, (int)(total % blocks), kr0, kr1, kx0, kx1,
      kp0, kp1, silo, nxt, n_silos, sigma_c, b_scale, lam_gate);
  return cudaGetLastError();
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

// buf the packed fp32 buffer, masked in place; table (E, 5) int64 on the
// device (core/flatbuf.leaf_table; its prefix takes (E + 1) * 8 bytes of
// shared memory, within the 48 KB default: E < 6144), total its
// tensors' elements; raw keys (unfolded); n_silos the ring's size;
// sigma_c, b_scale and lam_gate one fp32 word each on the device (lam_gate
// read only with use_prev, when prev_key is drawn and the correction
// applied).
REPRO_API int zsmask_buffer_f32(float* buf, const long long* table, int E, long long total,
                                uint32_t kr0, uint32_t kr1, uint32_t kx0, uint32_t kx1,
                                uint32_t kp0, uint32_t kp1, uint32_t silo, uint32_t nxt,
                                uint32_t n_silos, const float* sigma_c, const float* b_scale,
                                const float* lam_gate, int use_prev, cudaStream_t stream) {
  if (total == 0) return cudaSuccess;
  return use_prev
             ? launch_zsmask_buffer<true, float>(buf, buf, table, E, total, kr0, kr1, kx0, kx1,
                                                 kp0, kp1, silo, nxt, n_silos, sigma_c, b_scale,
                                                 lam_gate, stream)
             : launch_zsmask_buffer<false, float>(buf, buf, table, E, total, kr0, kr1, kx0, kx1,
                                                  kp0, kp1, silo, nxt, n_silos, sigma_c,
                                                  b_scale, lam_gate, stream);
}

// src the packed bf16 buffer of the clipped leaves, out the fp32
// contribution row of the same layout, written over the table's tensors
// only; table (E, 5) int64 on the device: the bf16 leaves' rows
// (core/flatbuf.leaf_table(layout, "bfloat16")), total their elements;
// the rest as zsmask_buffer_f32.
REPRO_API int zsmask_buffer_bf16(const __nv_bfloat16* src, float* out, const long long* table,
                                 int E, long long total, uint32_t kr0, uint32_t kr1,
                                 uint32_t kx0, uint32_t kx1, uint32_t kp0, uint32_t kp1,
                                 uint32_t silo, uint32_t nxt, uint32_t n_silos,
                                 const float* sigma_c, const float* b_scale,
                                 const float* lam_gate, int use_prev, cudaStream_t stream) {
  if (total == 0) return cudaSuccess;
  return use_prev ? launch_zsmask_buffer<true, __nv_bfloat16>(
                        src, out, table, E, total, kr0, kr1, kx0, kx1, kp0, kp1, silo, nxt,
                        n_silos, sigma_c, b_scale, lam_gate, stream)
                  : launch_zsmask_buffer<false, __nv_bfloat16>(
                        src, out, table, E, total, kr0, kr1, kx0, kx1, kp0, kp1, silo, nxt,
                        n_silos, sigma_c, b_scale, lam_gate, stream);
}

// The launch configuration of one instantiation on the current device
// (threads, elements a thread at a time, blocks an SM, registers, local
// bytes): variant bit 0 PREV, bit 1 the bf16 source.
REPRO_API int zsmask_buffer_config(int variant, int* cfg) {
  switch (variant & 3) {
    case 0: return stream_config(zsmask_buffer_kernel<false, float>, ZT_THREADS, 1, cfg);
    case 1: return stream_config(zsmask_buffer_kernel<true, float>, ZT_THREADS, 1, cfg);
    case 2: return stream_config(zsmask_buffer_kernel<false, __nv_bfloat16>, ZT_THREADS, 1, cfg);
    default: return stream_config(zsmask_buffer_kernel<true, __nv_bfloat16>, ZT_THREADS, 1, cfg);
  }
}
