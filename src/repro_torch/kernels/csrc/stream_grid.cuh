// Launch layout of the wire tier's stream kernels (dp_fused/csrc/clip_mask.cu,
// dp_fused/csrc/noise_stream.cu), sm_90a.
//
// Grid: every block resident at once, each with an equal share. The blocks
// one SM holds are read once per kernel and device
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, cached as set_smem_once
// caches its attribute, so a launch inside CUDA graph capture calls nothing
// new); the grid is that many blocks an SM, cut to the work, and each
// block takes a contiguous share of the groups, the shares one group apart
// at most.
//
// Elements: in groups of W consecutive elements a thread (a vector of W
// fp32, 16 bytes at W = 4), the groups aligned to the output's address, so
// a group that lies wholly inside [0, P) stores with one vector access and
// reads its inputs with one where they share the output's alignment. The
// first and last groups, partly outside [0, P), and every load of an input
// aligned otherwise, go element by element.
#pragma once

#include <atomic>
#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

// Groups of W elements over [0, P): group j holds elements W * j - off ...
// W * j - off + W - 1, off the output's misalignment in elements (0 .. W-1).
// vec: every input shares the output's alignment, so a whole group's loads
// are vector loads too. share, rem: groups / grid and groups % grid, set by
// stream_blocks, so that a block finds its share without a 64-bit division.
struct StreamLayout {
  long long groups;
  long long share;
  int rem;
  int off;
  int vec;
};

template <int W>
inline StreamLayout stream_layout(long long P, const float* out, const float* a,
                                  const float* b, const float* c) {
  const uintptr_t align = 4 * W, o = reinterpret_cast<uintptr_t>(out) % align;
  StreamLayout lay;
  lay.off = (int)(o / 4);
  lay.groups = (P + lay.off + W - 1) / W;
  lay.share = lay.groups;
  lay.rem = 0;
  lay.vec = 1;
  for (const float* in : {a, b, c})
    if (in != nullptr && reinterpret_cast<uintptr_t>(in) % align != o) lay.vec = 0;
  return lay;
}

// Resident blocks of `kern` at `threads` a block on the current device
// (SMs x blocks an SM), queried once per device; `cache` holds one entry a
// device, 0 until read.
struct ResidentCache {
  std::atomic<int> blocks[64];
};

template <class K>
cudaError_t resident_blocks(K kern, int threads, ResidentCache& cache, int& resident) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int n = cache.blocks[dev & 63].load(std::memory_order_relaxed);
  if (n == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, 0);
    if (e != cudaSuccess) return e;
    n = sms * (per_sm < 1 ? 1 : per_sm);
    cache.blocks[dev & 63].store(n, std::memory_order_relaxed);
  }
  resident = n;
  return cudaSuccess;
}

// The grid for lay.groups groups at `threads` a block (one group a thread
// while that fits the resident blocks, else the resident blocks), and each
// block's share of them in lay.
template <class K>
cudaError_t stream_blocks(K kern, int threads, StreamLayout& lay, ResidentCache& cache,
                          unsigned& blocks) {
  int resident = 0;
  const cudaError_t e = resident_blocks(kern, threads, cache, resident);
  if (e != cudaSuccess) return e;
  long long b = (lay.groups + threads - 1) / threads;
  if (b > resident) b = resident;
  blocks = (unsigned)(b < 1 ? 1 : b);
  lay.share = lay.groups / blocks;
  lay.rem = (int)(lay.groups % blocks);
  return cudaSuccess;
}

// A stream kernel's launch configuration on the current device: o = {threads
// a block, elements a thread at a time, blocks an SM (the residency its grid
// is sized by), registers a thread, local memory bytes a thread (spills)}.
template <class K>
cudaError_t stream_config(K kern, int threads, int width, int* o) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return e;
  o[0] = threads;
  o[1] = width;
  o[3] = a.numRegs;
  o[4] = (int)a.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(o + 2, kern, threads, 0);
}

// This block's share [lo, hi) of the groups: share groups, one more for
// the first rem blocks.
__device__ __forceinline__ void block_share(const StreamLayout& lay, long long& lo,
                                            long long& hi) {
  const int b = blockIdx.x;
  lo = (long long)b * lay.share + (b < lay.rem ? b : lay.rem);
  hi = lo + lay.share + (b < lay.rem ? 1 : 0);
}

// W elements from e0: one vector load when `vec` (the group lies inside
// [0, P) and src + e0 is aligned to 4 * W bytes), else element by element,
// 0 outside [0, P).
template <int W>
__device__ __forceinline__ void load_group(const float* src, long long e0, long long P,
                                           bool vec, float (&v)[W]) {
  if (vec) {
    if constexpr (W == 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + e0);
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
    } else if constexpr (W == 2) {
      const float2 t = *reinterpret_cast<const float2*>(src + e0);
      v[0] = t.x, v[1] = t.y;
    } else {
      v[0] = src[e0];
    }
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const long long p = e0 + k;
      v[k] = p >= 0 && p < P ? src[p] : 0.0f;
    }
  }
}

// W elements to e0: one vector store when `vec`, else the elements inside
// [0, P) one by one.
template <int W>
__device__ __forceinline__ void store_group(float* dst, long long e0, long long P, bool vec,
                                            const float (&v)[W]) {
  if (vec) {
    if constexpr (W == 4) {
      *reinterpret_cast<float4*>(dst + e0) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (W == 2) {
      *reinterpret_cast<float2*>(dst + e0) = make_float2(v[0], v[1]);
    } else {
      dst[e0] = v[0];
    }
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const long long p = e0 + k;
      if (p >= 0 && p < P) dst[p] = v[k];
    }
  }
}
