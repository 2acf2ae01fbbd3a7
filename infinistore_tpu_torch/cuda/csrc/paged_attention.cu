// K3: batched paged decode attention, and K6: its ragged form.
//
// K3 replaces infinistore_tpu/tpu/paged_attention.py:
// _paged_decode_attention_pallas_batched (body _decode_attn_kernel, through
// _attn_block_update / _attn_block_fold) and its B=1 wrapper
// _paged_decode_attention_pallas. One query row per request attends over
// the cache blocks its block-table row names:
//   q [B, H, D], k/v cache [N, bt, KVH, D], tables [B, max_blocks] int32,
//   seq_lens [B] int32 -> out [B, H, D] in q's dtype.
//
// K6 replaces _paged_decode_attention_pallas_ragged (body
// _ragged_decode_attn_kernel, through _ragged_fold). One query row per flat
// wave row r attends over its slice of the wave's concatenated page list:
//   q [R, H, D], pages [P], page_starts [R], seq_lens [R] (int32)
//   -> out [R, H, D]; row r's pages are pages[page_starts[r] + j] for
//   j < ceil(seq_lens[r] / bt), clamped to the pages the row owns in the
//   flat list (up to the next row's start, or P for the last row).
//
// Both: positions >= seq_len are masked; seq_len 0 gives zeros
// (acc / max(l, 1e-30)). The online softmax runs in f32 with f32 FMAs (the
// HIGHEST-precision dots of the TPU kernels); inputs are widened to f32 on
// load.
//
// Bound: bytes. The function must read the K and V of every valid token once:
// at B=4, 2048 tokens of context, 8 KV heads x 128 x bf16 that is 32 MiB per
// layer per step, about 10 us at 3.35 TB/s. A ragged wave reads the distinct
// pages it references (a verification chunk's rows share their pages).
//
// Design: one CTA per (KV head, row) holds the G = H / KVH query rows of that
// group in registers (lane-strided over D). Its 8 warps take the row's pages
// round-robin, and only the first ceil(seq_len / bt): the TPU kernels'
// fully-masked blocks are bitwise no-ops there, so skipping them changes
// nothing. A warp folds its tokens 8 at a time into its own running (max,
// sum, acc); the warps' partial states are merged through shared memory at
// the end. A page id outside [0, N) is skipped. K3 and K6 share that fold
// (attend_row below), so a K6 row is bitwise the K3 row over the same pages,
// and a row never depends on the other rows of its wave: the TPU kernel's
// sequential grid, which resets scratch on a row change, has no counterpart
// here because every row is its own CTA. The products that feed a sum are
// written as explicit fmaf / __fmul_rn, so the compiler's FMA contraction
// cannot round the two kernels differently.
// Left on the table: B x KVH CTAs (32 on the decode path) occupy a quarter
// of the 132 SMs; splitting the sequence across CTAs with a second combine
// pass (flash-decoding), and cp.async/TMA prefetch of the next block, are the
// obvious next steps.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kChunk = 8;  // tokens folded per online-softmax step

// Attention of query row `row` (its KV group `kvh`) over the pages
// page_list[0 .. nblk), seq_len valid tokens; writes out[row, kvh*G .. +G).
template <typename T, int D, int G>
__device__ __forceinline__ void attend_row(
    const T* __restrict__ q, const T* __restrict__ k_cache, const T* __restrict__ v_cache,
    const int32_t* __restrict__ page_list, int nblk, int seq_len, T* __restrict__ out,
    int64_t row, int kvh, int H, int KVH, int bt, int num_blocks, float scale) {
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

  const int64_t tok_stride = static_cast<int64_t>(KVH) * D;
  const int64_t blk_stride = static_cast<int64_t>(bt) * tok_stride;
  for (int j = warp; j < nblk; j += kWarps) {
    const int page = page_list[j];
    if (page < 0 || page >= num_blocks) continue;
    const T* kb = k_cache + page * blk_stride + kvh * D + lane;
    const T* vb = v_cache + page * blk_stride + kvh * D + lane;
    const int ntok = min(bt, seq_len - j * bt);
    for (int t0 = 0; t0 < ntok; t0 += kChunk) {
      float x[kChunk][E];  // K rows, then V rows, of this chunk
      float s[kChunk][G];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          x[u][e] = (t0 + u < ntok) ? its::to_f32(kb[(t0 + u) * tok_stride + 32 * e]) : 0.f;
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
#pragma unroll
        for (int e = 0; e < E; ++e)
          x[u][e] = (t0 + u < ntok) ? its::to_f32(vb[(t0 + u) * tok_stride + 32 * e]) : 0.f;
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
    out[(row * H + kvh * G + g) * D + d] = its::from_f32<T>(aa / fmaxf(ll, 1e-30f));
  }
}

// K3: grid (KVH, B).
template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode(const T* __restrict__ q, const T* __restrict__ k_cache,
             const T* __restrict__ v_cache, const int32_t* __restrict__ tables,
             const int32_t* __restrict__ seq_lens, T* __restrict__ out, int H,
             int KVH, int bt, int num_blocks, int max_blocks, float scale) {
  const int b = blockIdx.y;
  const int seq_len = max(0, min(seq_lens[b], max_blocks * bt));
  attend_row<T, D, G>(q, k_cache, v_cache, tables + static_cast<int64_t>(b) * max_blocks,
                      (seq_len + bt - 1) / bt, seq_len, out, b, blockIdx.x, H, KVH, bt,
                      num_blocks, scale);
}

// K6: grid (KVH, R).
template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_ragged(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache, const int32_t* __restrict__ pages,
                    const int32_t* __restrict__ page_starts,
                    const int32_t* __restrict__ seq_lens, T* __restrict__ out, int H,
                    int KVH, int bt, int num_blocks, int R, int P, float scale) {
  const int r = blockIdx.y;
  const int start = min(max(page_starts[r], 0), P);
  const int end = (r + 1 < R) ? min(max(page_starts[r + 1], start), P) : P;
  const int seq_len = max(0, min(seq_lens[r], (end - start) * bt));
  attend_row<T, D, G>(q, k_cache, v_cache, pages + start, (seq_len + bt - 1) / bt, seq_len,
                      out, r, blockIdx.x, H, KVH, bt, num_blocks, scale);
}

// The launch shape both kernels share: rows on grid.y, KV heads on grid.x.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* index;   // K3: tables; K6: pages
  const int32_t* starts;  // K6 only: page_starts
  const int32_t* seq_lens;
  void* out;
  int rows, H, KVH, bt, num_blocks;
  int width;  // K3: max_blocks; K6: P
  cudaStream_t stream;
};

template <typename T, int D, int G>
int launch(const Args& a, bool ragged) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid(a.KVH, a.rows);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);
  if (ragged) {
    paged_decode_ragged<T, D, G><<<grid, kWarps * 32, 0, a.stream>>>(
        q, k, v, a.index, a.starts, a.seq_lens, out, a.H, a.KVH, a.bt, a.num_blocks, a.rows,
        a.width, scale);
  } else {
    paged_decode<T, D, G><<<grid, kWarps * 32, 0, a.stream>>>(
        q, k, v, a.index, a.seq_lens, out, a.H, a.KVH, a.bt, a.num_blocks, a.width, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_group(const Args& a, bool ragged) {
  switch (a.H / a.KVH) {
    case 1: return launch<T, D, 1>(a, ragged);
    case 2: return launch<T, D, 2>(a, ragged);
    case 4: return launch<T, D, 4>(a, ragged);
    case 8: return launch<T, D, 8>(a, ragged);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(int dtype, int D, const Args& a, bool ragged) {
  if (a.rows <= 0) return 0;
  if (a.KVH <= 0 || a.H % a.KVH != 0 || a.bt <= 0 || a.width <= 0 || a.rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case its::kFloat32:
      if (D == 64) return by_group<float, 64>(a, ragged);
      if (D == 128) return by_group<float, 128>(a, ragged);
      break;
    case its::kBFloat16:
      if (D == 64) return by_group<__nv_bfloat16, 64>(a, ragged);
      if (D == 128) return by_group<__nv_bfloat16, 128>(a, ragged);
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int its_paged_decode_attention(const void* q, const void* k_cache,
                                          const void* v_cache, const int32_t* tables,
                                          const int32_t* seq_lens, void* out, int dtype,
                                          int B, int H, int KVH, int D, int bt,
                                          int num_blocks, int max_blocks, void* stream) {
  const Args a{q, k_cache, v_cache, tables, nullptr, seq_lens, out, B, H, KVH, bt,
               num_blocks, max_blocks, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, a, false);
}

extern "C" int its_paged_decode_attention_ragged(const void* q, const void* k_cache,
                                                 const void* v_cache, const int32_t* pages,
                                                 const int32_t* page_starts,
                                                 const int32_t* seq_lens, void* out, int dtype,
                                                 int R, int H, int KVH, int D, int bt,
                                                 int num_blocks, int P, void* stream) {
  const Args a{q, k_cache, v_cache, pages, page_starts, seq_lens, out, R, H, KVH, bt,
               num_blocks, P, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, a, true);
}
