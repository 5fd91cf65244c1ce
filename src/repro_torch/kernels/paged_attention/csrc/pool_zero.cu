// Page reset and rollback for the confidential page pools: one launch an
// event, fp32 or bf16 pools, sm_90a.
//
// Replaces the TPU kernels of src/repro/kernels/paged_attention/paged_attention.py:
//   paged_reset_pallas     (_reset_kernel, :158, pallas_call :223)
//   paged_rollback_pallas  (_rollback_kernel, :163, pallas_call :198)
//
// Both are "zero a list of distinct slabs in every layer of one or two
// pools". A pool is K and V of (L, N, P, H, D) fp32, contiguous; the target
// pool and the draft pool (an early exit over the target's own layers)
// share N, P, H and D and differ only in L. A reset's slab is a page, P*H*D
// floats at page id p (ids below N); a rollback's is a token, H*D floats at
// pool token index page*P + t (below N*P). The host resolves an event (an
// admission's fresh pages; every rejected tail of a speculative tick) to
// one list of distinct indices.
//
// Bound on this card: a tick's rollback at qwen2.5-3b's serving shape (4
// tails of 3 tokens in 36 + 4 layers, 1 MB: 0.3 us at 3.35 TB/s) by its
// launch (about 1 us a launch in a CUDA graph); an admission's reset (4
// pages in 36 + 4 layers, 5.2 MB: 1.6 us) by its bytes. Below about a MB,
// the launch. The TPU grids walk (layer, row entry) and rewrite whole pages; a
// port of that launched one block per entry and layer, once per pool and
// per range, each after a blocking copy of the table row from pageable host
// memory, and rewrote the page a padded row repeats. So:
//   - one launch an event: both pools and every range in one grid,
//     blockIdx.y a layer of pool a, then of pool b;
//   - the indices ride in the launch's parameter block (up to
//     POOL_ZERO_CAP int32 by value, 1 KB of the 4 KB limit, read in place
//     as a __grid_constant__): no device buffer and no host-to-device copy
//     for the stream to wait on; a longer list launches again per chunk;
//   - a grid sized to the bytes: thread u of a layer zeroes 16-byte unit u
//     of that layer's count * width floats (one store into K, one into V),
//     so a 1 KB token slab takes 64 threads, not a block;
//   - distinct indices (the host drops repeats): no slab written twice;
//   - the guard 0 <= index < limit on the device: a pool never takes a
//     write outside itself, whatever the host passed.
// The kernel writes +0.0, as the TPU kernels' zeros and jnp.where do.
// bf16 pools (pool_zero_bf16) keep the pool's type, as the TPU kernels do:
// every width, stride and offset is counted in elements of that type, and a
// 16-byte store holds 8 bf16 values (4 fp32); +0.0 is all zero bits in both.
#include <cuda_bf16.h>

#include <climits>
#include <cstdint>
#include <cstring>

#include "common.cuh"

#define POOL_ZERO_CAP 256
#define POOL_ZERO_THREADS 256

namespace {

struct IndexList {
  int idx[POOL_ZERO_CAP];
};

__device__ __forceinline__ float zero_of(const float*) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(const __nv_bfloat16*) {
  return __float2bfloat16_rn(0.f);
}

// VEC elements of T a unit: 16 / sizeof(T) (16-byte stores) when the slab
// width is a multiple of that and the pools are 16-byte aligned, else 1.
template <class T, int VEC>
__global__ void __launch_bounds__(POOL_ZERO_THREADS)
pool_zero_kernel(T* __restrict__ k_a, T* __restrict__ v_a, T* __restrict__ k_b,
                 T* __restrict__ v_b, int layers_a, long long layer_stride, long long limit,
                 long long width, int units, int count, const __grid_constant__ IndexList list) {
  const int u = blockIdx.x * POOL_ZERO_THREADS + threadIdx.x;
  if (u >= count * units) return;
  const int e = u / units;
  const long long idx = list.idx[e];
  if (idx < 0 || idx >= limit) return;  // never write outside the pool
  int layer = blockIdx.y;
  T* k = k_a;
  T* v = v_a;
  if (layer >= layers_a) {
    layer -= layers_a;
    k = k_b;
    v = v_b;
  }
  const long long off = layer * layer_stride + idx * width + (long long)(u - e * units) * VEC;
  if constexpr (VEC > 1) {
    static_assert(VEC * sizeof(T) == 16, "a unit is one 16-byte store");
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);  // +0.0 in every lane
    *reinterpret_cast<uint4*>(k + off) = z;
    *reinterpret_cast<uint4*>(v + off) = z;
  } else {
    k[off] = zero_of(k);
    v[off] = zero_of(v);
  }
}

template <class T>
int pool_zero(T* k_a, T* v_a, int layers_a, T* k_b, T* v_b, int layers_b,
              long long layer_stride, long long limit, long long width, const int* idx, int count,
              cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (layers_a < 0 || layers_b < 0 || layers_a + layers_b > 65535 || count < 0 || width <= 0 ||
      limit < 0 || layer_stride < limit * width || (layers_b > 0 && (!k_b || !v_b)))
    return -cudaErrorInvalidValue;
  const int layers = layers_a + layers_b;
  if (count == 0 || layers == 0) return 0;
  const uintptr_t addr = (uintptr_t)k_a | (uintptr_t)v_a | (uintptr_t)k_b | (uintptr_t)v_b;
  const bool vec = width % VEC == 0 && addr % 16 == 0;
  const long long units = vec ? width / VEC : width;
  if (units > INT_MAX / POOL_ZERO_CAP) return -cudaErrorInvalidValue;
  IndexList list;
  int launches = 0;
  for (int c0 = 0; c0 < count; c0 += POOL_ZERO_CAP, ++launches) {
    const int n = count - c0 < POOL_ZERO_CAP ? count - c0 : POOL_ZERO_CAP;
    memcpy(list.idx, idx + c0, n * sizeof(int));
    const dim3 grid((unsigned)((n * units + POOL_ZERO_THREADS - 1) / POOL_ZERO_THREADS), layers);
    if (vec)
      pool_zero_kernel<T, VEC><<<grid, POOL_ZERO_THREADS, 0, stream>>>(
          k_a, v_a, k_b, v_b, layers_a, layer_stride, limit, width, (int)units, n, list);
    else
      pool_zero_kernel<T, 1><<<grid, POOL_ZERO_THREADS, 0, stream>>>(
          k_a, v_a, k_b, v_b, layers_a, layer_stride, limit, width, (int)units, n, list);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return -(int)e;
  }
  return launches;
}

__global__ void empty_kernel() {}

}  // namespace

// Zero the slabs idx[0 .. count) (host int32; distinct, as the wrappers pass
// them) in layers_a layers of pool a (k_a, v_a) and layers_b of pool b
// (k_b, v_b; null when layers_b is 0), in place. Each pool is (L, N, P, H,
// D) fp32 contiguous: layer_stride = N*P*H*D floats, a slab is `width`
// floats at idx * width, and an index outside [0, limit) is skipped. One
// launch for each POOL_ZERO_CAP indices. Returns the launches made (0 for
// an empty list), or minus the cudaError_t of a refused one.
REPRO_API int pool_zero_f32(float* k_a, float* v_a, int layers_a, float* k_b, float* v_b,
                            int layers_b, long long layer_stride, long long limit,
                            long long width, const int* idx, int count, cudaStream_t stream) {
  return pool_zero(k_a, v_a, layers_a, k_b, v_b, layers_b, layer_stride, limit, width, idx, count,
                   stream);
}

// The same on bf16 pools: layer_stride and width in bf16 elements.
REPRO_API int pool_zero_bf16(__nv_bfloat16* k_a, __nv_bfloat16* v_a, int layers_a,
                             __nv_bfloat16* k_b, __nv_bfloat16* v_b, int layers_b,
                             long long layer_stride, long long limit, long long width,
                             const int* idx, int count, cudaStream_t stream) {
  return pool_zero(k_a, v_a, layers_a, k_b, v_b, layers_b, layer_stride, limit, width, idx, count,
                   stream);
}

// One launch of an empty kernel: the floor a launch of this library costs
// on the card, which chip_smoke.py times beside the kernels.
REPRO_API int repro_empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return cudaGetLastError();
}
