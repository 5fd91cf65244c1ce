// One online-softmax step over a (rows x cols) tile, fp32 on the CUDA cores
// (sm_90a): fp32 paged attention's (paged_attention.cu's
// paged_attention_kernel, its one user since the flash forward moved to the
// tensor cores), as the TPU kernel and its oracle share _page_step
// (src/repro/kernels/paged_attention/paged_attention.py:43).
//
// A block of ATTN_THREADS threads holds ROWS query rows in shared memory and
// walks key/value tiles of ATTN_COLS tokens. Each step:
//   scores  thread (tr, tc) owns the RM x CM micro-tile of rows tr + TR*i and
//           columns tc + TC*j; each 16-byte shared load of q or k feeds RM or
//           CM float4 products, so a q load is reused CM times and a k load RM
//           times. score(r, c, dot) scales and masks: NEG_INF (finite) for a
//           masked column, -INFINITY for a column that is not there (past the
//           tile's end, an unnamed page), which adds exactly 0 to a row.
//   softmax the TC lanes that share a row reduce its max and its sum with
//           shuffles; they keep m and l in registers (each a copy) and write
//           p over the scores and alpha = exp(m - m_new) for the P.V step.
//   P.V     a row's D outputs are D/4 lanes x 4 contiguous dims (20 lanes at
//           d_head 80, 24 at 96, 28 at 112, 32 at 128: one row a warp; 2, 4
//           or 8 rows a warp at 64, 32, 16); each
//           lane owns RA rows, so one float4 of V feeds RA rows and a float4
//           of p four columns.
// Shared strides are padded to 16 bytes past a multiple of 128, so the
// float4 reads of different rows fall in different banks.
//
// q and the pages are fp32 (bf16 paged attention runs on the tensor cores,
// csrc/mma_tile.cuh), staged by 16-byte cp.async, double-buffered: the next
// tile's copies run under this tile's math.
#pragma once

#include "common.cuh"

constexpr int ATTN_THREADS = 256;
constexpr int ATTN_COLS = 32;  // key/value tokens a tile

__device__ __forceinline__ void zero4(float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void fma4(float4& a, float p, const float4& v) {
  a.x = fmaf(p, v.x, a.x);
  a.y = fmaf(p, v.y, a.y);
  a.z = fmaf(p, v.z, a.z);
  a.w = fmaf(p, v.w, a.w);
}

template <int D, int ROWS>
struct AttnTile {
  static_assert(D % 4 == 0 && D <= 128, "D/4 lanes a row");
  static_assert(ROWS == 8 || ROWS == 16 || ROWS == 32 || ROWS == 64, "row tile");
  static constexpr int COLS = ATTN_COLS;
  static constexpr int KS = D + 4;     // q and k row stride (floats)
  static constexpr int SS = COLS + 4;  // score row stride
  static constexpr int TR = ROWS < 16 ? ROWS : 16;
  static constexpr int TC = ATTN_THREADS / TR;  // lanes a row: 16 or 32
  static constexpr int RM = ROWS / TR;
  static constexpr int CM = COLS / TC;
  static constexpr int LPR = D / 4;                     // P.V lanes a row
  static constexpr int RPW = 32 / LPR;                  // P.V rows a warp
  static constexpr int NS = (ATTN_THREADS / 32) * RPW;  // P.V row slots
  static constexpr int RA = (ROWS + NS - 1) / NS;       // P.V rows a lane

  // shared memory: q (ROWS x KS), 2 x [k (COLS x KS), v (COLS x D)],
  // scores (ROWS x SS), one float a row (alpha, then l)
  static constexpr int FLOATS = ROWS * KS + 2 * COLS * (KS + D) + ROWS * SS + ROWS;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
  static constexpr int BUF = COLS * (KS + D);  // one K/V buffer
  float* q_s;
  float* kv_s;  // 2 x [k, v]: indexed by arithmetic, never a pointer array
  float* s_s;
  float* a_s;

  float m[RM], l[RM];
  float4 acc[RA];

  __device__ explicit AttnTile(float* smem) {
    q_s = smem;
    kv_s = q_s + ROWS * KS;
    s_s = kv_s + 2 * BUF;
    a_s = s_s + ROWS * SS;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      m[i] = REPRO_NEG_INF;
      l[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < RA; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // Stage n <= nmax rows of D values into dst (row stride ds): src(t) is
  // row t's offset into g, or -1 for a row that is not there (zero-filled,
  // never read). Rows n..nmax-1 are zero-filled too.
  template <class Src>
  __device__ static void stage(float* dst, int ds, const float* g, int n, int nmax, Src src) {
    constexpr int LPV = D / 4;
    for (int idx = threadIdx.x; idx < nmax * LPV; idx += ATTN_THREADS) {
      const int t = idx / LPV, d = 4 * (idx % LPV);
      const long long off = t < n ? src(t) : -1;
      if (off >= 0)
        cp_async16(dst + t * ds + d, g + off + d);
      else
        zero4(dst + t * ds + d);
    }
  }

  // K and V rows at the same offsets into buffer b.
  template <class Src>
  __device__ void stage_kv(int b, const float* k, const float* v, int n, Src src) {
    constexpr int LPV = D / 4;
    for (int idx = threadIdx.x; idx < COLS * LPV; idx += ATTN_THREADS) {
      const int t = idx / LPV, d = 4 * (idx % LPV);
      const long long off = t < n ? src(t) : -1;
      float* kd = kv_s + b * BUF + t * KS + d;
      float* vd = kv_s + b * BUF + COLS * KS + t * D + d;
      if (off >= 0) {
        cp_async16(kd, k + off + d);
        cp_async16(vd, v + off + d);
      } else {
        zero4(kd);
        zero4(vd);
      }
    }
  }

  // One online-softmax step against buffer b (staged and visible to every
  // thread); cols <= COLS of its columns are there. Ends with the scores'
  // shared memory consumed by P.V only after the caller's next barrier.
  template <class Score>
  __device__ void step(int b, int cols, Score score) {
    const int t = threadIdx.x, tr = t / TC, tc = t % TC;
    const float* ks = kv_s + b * BUF;
    float s[RM][CM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CM; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RM], kv[CM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (tr + TR * i) * KS + d);
#pragma unroll
      for (int j = 0; j < CM; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tc + TC * j) * KS + d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CM; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          s[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = tr + TR * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        const int c = tc + TC * j;
        s[i][j] = c < cols ? score(r, c, s[i][j]) : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = TC / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);  // finite: m starts at NEG_INF
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        const float p = expf(s[i][j] - m_new);  // exp(-inf) = 0
        s_s[r * SS + tc + TC * j] = p;
        ps += p;
      }
#pragma unroll
      for (int o = TC / 2; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + ps;
      m[i] = m_new;
      if (tc == 0) a_s[r] = alpha;
    }
    __syncthreads();

    const int warp = t / 32, lane = t % 32;
    if (lane < RPW * LPR) {
      const int slot = warp * RPW + lane / LPR, d = 4 * (lane % LPR);
      const float* vs = kv_s + b * BUF + COLS * KS + d;
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const int r = slot + NS * i;
        if (r < ROWS) {
          const float a = a_s[r];
          acc[i].x *= a;
          acc[i].y *= a;
          acc[i].z *= a;
          acc[i].w *= a;
        }
      }
      const int c4n = (cols + 3) / 4;  // p is 0 past cols
      for (int c = 0; c < 4 * c4n; c += 4) {
        const float4 v0 = *reinterpret_cast<const float4*>(vs + (c + 0) * D);
        const float4 v1 = *reinterpret_cast<const float4*>(vs + (c + 1) * D);
        const float4 v2 = *reinterpret_cast<const float4*>(vs + (c + 2) * D);
        const float4 v3 = *reinterpret_cast<const float4*>(vs + (c + 3) * D);
#pragma unroll
        for (int i = 0; i < RA; ++i) {
          const int r = slot + NS * i;
          if (r < ROWS) {
            const float4 p = *reinterpret_cast<const float4*>(s_s + r * SS + c);
            fma4(acc[i], p.x, v0);
            fma4(acc[i], p.y, v1);
            fma4(acc[i], p.z, v2);
            fma4(acc[i], p.w, v3);
          }
        }
      }
    }
  }

  // f(r, m, l) once a row, from the score layout.
  template <class F>
  __device__ void each_ml(F f) const {
    const int tr = threadIdx.x / TC, tc = threadIdx.x % TC;
    if (tc == 0)
#pragma unroll
      for (int i = 0; i < RM; ++i) f(tr + TR * i, m[i], l[i]);
  }

  // f(r, d, acc, l) once a (row, 4 dims), from the P.V layout; l is the
  // row's sum, passed through shared memory. Call after a barrier that
  // follows the last step.
  template <class F>
  __device__ void each_acc(F f) {
    each_ml([&](int r, float, float lr) { a_s[r] = lr; });
    __syncthreads();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane < RPW * LPR) {
      const int slot = warp * RPW + lane / LPR, d = 4 * (lane % LPR);
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const int r = slot + NS * i;
        if (r < ROWS) f(r, d, acc[i], a_s[r]);
      }
    }
  }

  // The tile loop: stage_tile(t, buf) issues tile t's copies into buffer
  // buf, cols(t) is its column count, score(t, r, c, dot) its mask; the
  // next tile's copies run under this tile's math. The caller has issued
  // (not committed) the q copies.
  template <class Stage, class Cols, class Score>
  __device__ void run(int ntiles, Stage stage_tile, Cols cols, Score score) {
    if (ntiles > 0) stage_tile(0, 0);
    cp_async_commit();
    for (int t = 0; t < ntiles; ++t) {
      const int b = t & 1;
      if (t + 1 < ntiles) stage_tile(t + 1, b ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      step(b, cols(t), [&](int r, int c, float dot) { return score(t, r, c, dot); });
      __syncthreads();  // this tile's buffers and scores are consumed
    }
    cp_async_wait<0>();
    __syncthreads();
  }
};
