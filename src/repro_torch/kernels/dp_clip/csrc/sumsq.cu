// Per-example sums of squares, (B, D) -> (B,) fp32, sm_90a:
//   out[b] = sum_d g[b, d]^2
//
// Replaces the TPU kernel src/repro/kernels/dp_clip/dp_clip.py:
//   per_example_sumsq (_sumsq_kernel, :26, def :42, pallas_call :48)
// On the per-leaf clip path (kernels/dp_clip/ops.py, _clip_and_sum_perleaf)
// g is one leaf's columns of the (B, P) per-example gradient buffer: B rows
// of the leaf's D elements, ld = P apart, read in place. The per-leaf sums
// add up to each example's squared norm.
//
// Design: the TPU kernel carries each row's partial sum across the grid's
// D axis in VMEM; here blocks run in parallel, so the rows are cut over a
// (nblk, B) grid and reduced in two passes (kernels/csrc/rowsq.cuh): block
// partials in fp64, then one warp per row adds them in a fixed order. No
// atomics: two launches give the same bits. fp64 accumulation makes the
// result the fp32 rounding of an almost exact sum; the plain version's
// chunked fp32 dot products agree to about 1e-7 relative.
//   Bound on this card: bytes. Every element is read once (B * D * 4
// bytes), two flops each; the fp64 adds and fp32->fp64 conversions cost
// about a fifth of the read at the card's fp64 and conversion rates.
//
// per_example_sumsq_tree_f32: the per-leaf clip route's norms over every
// leaf of the (B, P) buffer in two launches a tree, instead of two a leaf
// and an fp32 add a leaf on the host's stream. A device table (one row a
// leaf: its column offset, D, vec, nblk, and its first block in the
// prefix of all leaves' B * nblk blocks, which is also its first partial;
// kernels/dp_clip/dp_clip.py, sumsq_table) is built once per layout, row
// count and card. Pass 1, rowsq_tree_partial: one 1-D grid over every
// (leaf, row b, block j); each block finds its leaf by a search over the
// prefix and computes exactly the partial rowsq_partial computes for that
// leaf (rowsq_block, the same thread and element assignment, the same
// fp64 sums). Pass 2, rowsq_tree_final: a block a row, each warp adding a
// leaf's partials in rowsq_total's order and rounding them to fp32, then
// one thread folding the fp32 per-leaf sums in leaf order with __fadd_rn:
// bit-equal to sum(per_example_sumsq(c) for c in the leaves' columns).
// Bound: bytes, as per_example_sumsq.
#include "common.cuh"
#include "rowsq.cuh"

namespace {

__global__ void rowsq_final(const double* __restrict__ partial, int nblk,
                            float* __restrict__ out) {
  const double total = repro_rowsq::rowsq_total(partial, nblk, blockIdx.x);
  if (threadIdx.x == 0) out[blockIdx.x] = (float)total;
}

// the table's columns: column offset, D, vec, nblk, first block (and first
// partial) in the prefix over the leaves
constexpr int ST_COLS = 5;
constexpr int SF_THREADS = 512;

__global__ void __launch_bounds__(repro_rowsq::RS_THREADS)
rowsq_tree_partial(const float* __restrict__ g, long long ld, const long long* __restrict__ table,
                   int L, double* __restrict__ partial) {
  const long long k = blockIdx.x;
  int a = 0, z = L;  // the last leaf whose first block is at or before k
  while (z - a > 1) {
    const int m = (a + z) >> 1;
    if (__ldg(table + (long long)m * ST_COLS + 4) <= k) a = m; else z = m;
  }
  const long long* row = table + (long long)a * ST_COLS;
  const long long off = __ldg(row), D = __ldg(row + 1), first = __ldg(row + 4);
  const int vec = (int)__ldg(row + 2), nblk = (int)__ldg(row + 3);
  const long long local = k - first;
  const long long b = local / nblk;
  const int j = (int)(local - b * nblk);
  const double acc = repro_rowsq::rowsq_block(g + b * ld + off, D, vec, j, nblk);
  if (threadIdx.x == 0) partial[k] = acc;
}

__global__ void __launch_bounds__(SF_THREADS)
rowsq_tree_final(const double* __restrict__ partial, const long long* __restrict__ table, int L,
                 int B, float* __restrict__ out, float* __restrict__ per_leaf) {
  extern __shared__ float leaf_sum[];  // L
  const int b = blockIdx.x;
  for (int l = threadIdx.x >> 5; l < L; l += SF_THREADS / 32) {
    const long long* row = table + (long long)l * ST_COLS;
    const float t = (float)repro_rowsq::rowsq_total(partial + row[4], (int)row[3], b);
    if ((threadIdx.x & 31) == 0) {
      leaf_sum[l] = t;
      if (per_leaf != nullptr) per_leaf[(long long)l * B + b] = t;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int l = 0; l < L; ++l) acc = __fadd_rn(acc, leaf_sum[l]);
    out[b] = acc;
  }
}

}  // namespace

// g (B, D) fp32 rows ld apart; out (B,) fp32; partial (B * nblk) fp64
// scratch. vec != 0 when D and ld are multiples of 4 and g is 16-byte
// aligned.
REPRO_API int per_example_sumsq_f32(const float* g, float* out, double* partial, int B,
                                    long long D, long long ld, int vec, int nblk,
                                    cudaStream_t stream) {
  repro_rowsq::launch_rowsq_partial(g, B, D, ld, vec, nblk, partial, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rowsq_final<<<B, 32, 0, stream>>>(partial, nblk, out);
  return cudaGetLastError();
}

// g the (B, P) buffer, rows ld apart; table (L, 5) int64 on the device
// (L * 4 bytes of shared memory, within the 48 KB default: L <= 12288),
// blocks its leaves' B * nblk summed; partial (blocks) fp64 scratch; out
// (B,) fp32 totals; per_leaf (L, B) fp32 or null.
REPRO_API int per_example_sumsq_tree_f32(const float* g, long long ld, int B,
                                         const long long* table, int L, long long blocks,
                                         double* partial, float* out, float* per_leaf,
                                         cudaStream_t stream) {
  rowsq_tree_partial<<<(unsigned)blocks, repro_rowsq::RS_THREADS, 0, stream>>>(g, ld, table, L,
                                                                             partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rowsq_tree_final<<<B, SF_THREADS, (size_t)L * sizeof(float), stream>>>(partial, table, L, B,
                                                                        out, per_leaf);
  return cudaGetLastError();
}
