// The paged decode fold that K3, K5, K6, K7 and K8 share.
//
// One query row (one request, or one flat row of a ragged wave) attends over
// the cache pages its page list names. The fold is split in three parts so
// that every decode kernel runs the same arithmetic:
//   - a KV loader: widens one K or V value to f32 in registers; FloatKV
//     reads f32/bf16 caches, Int8KV reads int8 data and multiplies by the
//     f32 scale of the value's (token, KV head) row;
//   - the fold (attend_row): 8 warps take the row's pages round-robin, each
//     folds its tokens 8 at a time into its own running (max, sum, acc) with
//     an f32 online softmax, and the warps' partial states are merged through
//     shared memory;
//   - an epilogue: Normalize writes acc / max(l, 1e-30) in the query's dtype
//     (K3, K6, K8), RawStats writes the merged (acc, m, l) in f32 (K5, K7).
// Only the first ceil(seq_len / bt) pages are read: the TPU kernels'
// fully-masked blocks are bitwise no-ops, so skipping them changes nothing.
// A page id outside [0, N) is skipped. Every product that feeds a sum is an
// explicit fmaf or __fmul_rn, so FMA contraction cannot round two kernels
// apart: a K6 row is bitwise the K3 row over the same pages, a K5/K7 row
// normalised by its own statistics is bitwise K3/K6, and K8 is bitwise K3
// over the f32-dequantised cache (dequantize_kv's data.float() * scale is
// one f32 multiply, as Int8KV's __fmul_rn).
//
// Grid: one CTA per (KV head, row); the CTA holds the G = H / KVH query rows
// of its KV group in registers, lane-strided over D.
#pragma once

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kChunk = 8;  // tokens folded per online-softmax step

// ---------------------------------------------------------------------------
// KV loaders: one K or V value widened to f32. `off` is the element's index in
// the cache, th * D + d, where th = (page * bt + token) * KVH + kvh indexes its
// (token, KV head) row; `s` is the row's scale, read once per row by
// k_scale / v_scale (a float cache has none: 0, and no load).
// ---------------------------------------------------------------------------

template <typename C>
struct FloatKV {
  const C* k;
  const C* v;

  __device__ __forceinline__ float k_scale(int64_t) const { return 0.f; }
  __device__ __forceinline__ float v_scale(int64_t) const { return 0.f; }
  __device__ __forceinline__ float key(int64_t off, float) const {
    return its::to_f32(k[off]);
  }
  __device__ __forceinline__ float value(int64_t off, float) const {
    return its::to_f32(v[off]);
  }
};

// int8 data with one f32 scale per (token, KV head) row.
struct Int8KV {
  const int8_t* k;
  const float* ks;
  const int8_t* v;
  const float* vs;

  __device__ __forceinline__ float k_scale(int64_t th) const { return ks[th]; }
  __device__ __forceinline__ float v_scale(int64_t th) const { return vs[th]; }
  __device__ __forceinline__ float key(int64_t off, float s) const {
    return __fmul_rn(static_cast<float>(k[off]), s);
  }
  __device__ __forceinline__ float value(int64_t off, float s) const {
    return __fmul_rn(static_cast<float>(v[off]), s);
  }
};

// ---------------------------------------------------------------------------
// Epilogues: called once per (query head, d) with the row's merged state.
// `head` is the flat query head index row * H + h.
// ---------------------------------------------------------------------------

template <typename T>
struct Normalize {
  T* out;  // [rows, H, D]

  __device__ __forceinline__ void operator()(int64_t head, int d, int D, float, float l,
                                             float acc) const {
    out[head * D + d] = its::from_f32<T>(acc / fmaxf(l, 1e-30f));
  }
};

struct RawStats {
  float* acc;  // [rows, H, D]
  float* m;    // [rows, H]
  float* l;    // [rows, H]

  __device__ __forceinline__ void operator()(int64_t head, int d, int D, float mm, float ll,
                                             float aa) const {
    acc[head * D + d] = aa;
    if (d == 0) {
      m[head] = mm;
      l[head] = ll;
    }
  }
};

// ---------------------------------------------------------------------------
// The fold: query row `row` (KV group `kvh`) over page_list[0 .. nblk),
// seq_len valid tokens. An empty row leaves acc 0, l 0 and m at kNegInf.
// ---------------------------------------------------------------------------

template <typename T, int D, int G, typename KV, typename Epi>
__device__ __forceinline__ void attend_row(const T* __restrict__ q, const KV& kv,
                                           const int32_t* __restrict__ page_list, int nblk,
                                           int seq_len, const Epi& epi, int64_t row, int kvh,
                                           int H, int KVH, int bt, int num_blocks, float scale) {
  constexpr int E = D / 32;  // elements of a head row held by each lane
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float qr[G][E];
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qrow = q + (row * H + kvh * G + g) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[g][e] = its::to_f32(qrow[lane + 32 * e]);
      acc[g][e] = 0.f;
    }
    m[g] = its::kNegInf;
    l[g] = 0.f;
  }

  for (int j = warp; j < nblk; j += kWarps) {
    const int page = page_list[j];
    if (page < 0 || page >= num_blocks) continue;
    const int64_t th0 = static_cast<int64_t>(page) * bt * KVH + kvh;  // token 0 of the page
    const int ntok = min(bt, seq_len - j * bt);
    for (int t0 = 0; t0 < ntok; t0 += kChunk) {
      float x[kChunk][E];  // K rows, then V rows, of this chunk
      float s[kChunk][G];
      // Predicated loads, all issued before the first use (the fold is bound
      // by load latency at decode's few CTAs).
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int64_t th = th0 + static_cast<int64_t>(t0 + u) * KVH;
        const float sc = (t0 + u < ntok) ? kv.k_scale(th) : 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e)
          x[u][e] = (t0 + u < ntok) ? kv.key(th * D + lane + 32 * e, sc) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) part = fmaf(qr[g][e], x[u][e], part);
          s[u][g] = __fmul_rn(its::warp_sum(part), scale);
        }
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int64_t th = th0 + static_cast<int64_t>(t0 + u) * KVH;
        const float sc = (t0 + u < ntok) ? kv.v_scale(th) : 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e)
          x[u][e] = (t0 + u < ntok) ? kv.value(th * D + lane + 32 * e, sc) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = its::kNegInf;
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          if (t0 + u < ntok) mx = fmaxf(mx, s[u][g]);
        const float m_new = fmaxf(m[g], mx);
        const float corr = expf(m[g] - m_new);
        float psum = 0.f;
        float pv[E];
#pragma unroll
        for (int e = 0; e < E; ++e) pv[e] = 0.f;
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (t0 + u < ntok) {
            const float p = expf(s[u][g] - m_new);
            psum += p;
#pragma unroll
            for (int e = 0; e < E; ++e) pv[e] = fmaf(p, x[u][e], pv[e]);
          }
        }
        l[g] = fmaf(l[g], corr, psum);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(acc[g][e], corr, pv[e]);
        m[g] = m_new;
      }
    }
  }

  // Merge the warps' partial softmax states.
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][g][lane + 32 * e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kWarps * 32) {
    const int g = idx / D;
    const int d = idx % D;
    float mm = its::kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mm);
      ll = fmaf(sm_l[w][g], c, ll);
      aa = fmaf(sm_acc[w][g][d], c, aa);
    }
    epi(row * H + kvh * G + g, d, D, mm, ll, aa);
  }
}

// Rows of a batched block table (K3, K5, K8): grid (KVH, B). Row b attends
// over tables[b, :], its seq_len clamped to the table's max_blocks * bt.
template <typename T, int D, int G, typename KV, typename Epi>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode(const T* __restrict__ q, KV kv, const int32_t* __restrict__ tables,
             const int32_t* __restrict__ seq_lens, Epi epi, int H, int KVH, int bt,
             int num_blocks, int max_blocks, float scale) {
  const int b = blockIdx.y;
  const int seq_len = max(0, min(seq_lens[b], max_blocks * bt));
  attend_row<T, D, G>(q, kv, tables + static_cast<int64_t>(b) * max_blocks,
                      (seq_len + bt - 1) / bt, seq_len, epi, b, blockIdx.x, H, KVH, bt,
                      num_blocks, scale);
}

// Rows of a ragged wave (K6, K7): grid (KVH, R). Row r's pages are
// pages[page_starts[r] + j], clamped to the pages the row owns in the flat
// list (up to the next row's start, or P for the last row).
template <typename T, int D, int G, typename KV, typename Epi>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_ragged(const T* __restrict__ q, KV kv, const int32_t* __restrict__ pages,
                    const int32_t* __restrict__ page_starts,
                    const int32_t* __restrict__ seq_lens, Epi epi, int H, int KVH, int bt,
                    int num_blocks, int R, int P, float scale) {
  const int r = blockIdx.y;
  const int start = min(max(page_starts[r], 0), P);
  const int end = (r + 1 < R) ? min(max(page_starts[r + 1], start), P) : P;
  const int seq_len = max(0, min(seq_lens[r], (end - start) * bt));
  attend_row<T, D, G>(q, kv, pages + start, (seq_len + bt - 1) / bt, seq_len, epi, r,
                      blockIdx.x, H, KVH, bt, num_blocks, scale);
}

// ---------------------------------------------------------------------------
// Launch and dispatch over (query dtype, head_dim, group size).
// ---------------------------------------------------------------------------

// The launch shape every decode kernel shares: rows on grid.y, KV heads on
// grid.x. `width` is max_blocks for a table, P for a ragged page list.
struct Shape {
  int rows, H, KVH, bt, num_blocks, width;
  cudaStream_t stream;
};

template <typename T, int D, int G, bool kRagged, typename KV, typename Epi>
int launch(const T* q, const KV& kv, const int32_t* index, const int32_t* starts,
           const int32_t* seq_lens, const Epi& epi, const Shape& s) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid(s.KVH, s.rows);
  if constexpr (kRagged) {
    paged_decode_ragged<T, D, G, KV, Epi><<<grid, kWarps * 32, 0, s.stream>>>(
        q, kv, index, starts, seq_lens, epi, s.H, s.KVH, s.bt, s.num_blocks, s.rows, s.width,
        scale);
  } else {
    paged_decode<T, D, G, KV, Epi><<<grid, kWarps * 32, 0, s.stream>>>(
        q, kv, index, seq_lens, epi, s.H, s.KVH, s.bt, s.num_blocks, s.width, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// One instantiation of the kernels: query dtype T, head_dim D, group size G.
template <typename T_, int D_, int G_>
struct Config {
  using T = T_;
  static constexpr int D = D_;
  static constexpr int G = G_;
};

template <typename T, int D, typename F>
int by_group(int G, F& f) {
  switch (G) {
    case 1: return f(Config<T, D, 1>{});
    case 2: return f(Config<T, D, 2>{});
    case 4: return f(Config<T, D, 4>{});
    case 8: return f(Config<T, D, 8>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Validates the shape, then calls f(Config<T, D, G>{}) for the kernels'
// instantiation; 0 without a launch when there are no rows.
template <typename F>
int dispatch(int dtype, int D, const Shape& s, F f) {
  if (s.rows <= 0) return 0;
  if (s.KVH <= 0 || s.H % s.KVH != 0 || s.bt <= 0 || s.width <= 0 || s.rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = s.H / s.KVH;
  switch (dtype) {
    case its::kFloat32:
      if (D == 64) return by_group<float, 64>(G, f);
      if (D == 128) return by_group<float, 128>(G, f);
      break;
    case its::kBFloat16:
      if (D == 64) return by_group<__nv_bfloat16, 64>(G, f);
      if (D == 128) return by_group<__nv_bfloat16, 128>(G, f);
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
