// K3: batched paged decode attention.
//
// Replaces infinistore_tpu/tpu/paged_attention.py:
// _paged_decode_attention_pallas_batched (body _decode_attn_kernel, through
// _attn_block_update / _attn_block_fold) and its B=1 wrapper
// _paged_decode_attention_pallas. One query row per request attends over
// the cache blocks its block-table row names:
//   q [B, H, D], k/v cache [N, bt, KVH, D], tables [B, max_blocks] int32,
//   seq_lens [B] int32 -> out [B, H, D] in q's dtype.
// Positions >= seq_len are masked; seq_len 0 gives zeros (acc / max(l, 1e-30)).
// The online softmax runs in f32 with f32 FMAs (the HIGHEST-precision dots of
// the TPU kernel); inputs are widened to f32 on load.
//
// Bound: bytes. The function must read the K and V of every valid token once:
// at B=4, 2048 tokens of context, 8 KV heads x 128 x bf16 that is 32 MiB per
// layer per step, about 10 us at 3.35 TB/s.
//
// Design: one CTA per (KV head, request) holds the G = H / KVH query rows of
// that group in registers (lane-strided over D). Its 8 warps take the
// request's table entries round-robin, and only the first ceil(seq_len / bt):
// the TPU kernel's fully-masked blocks are bitwise no-ops there, so skipping
// them changes nothing. A warp folds its tokens 8 at a time into its own
// running (max, sum, acc); the warps' partial states are merged through shared
// memory at the end. A table entry outside [0, N) is skipped.
// Left on the table: B x KVH CTAs (32 on the main path) occupy a quarter of
// the 132 SMs; splitting the sequence across CTAs with a second combine pass
// (flash-decoding), and cp.async/TMA prefetch of the next block, are the
// obvious next steps.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kChunk = 8;  // tokens folded per online-softmax step

template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode(const T* __restrict__ q, const T* __restrict__ k_cache,
             const T* __restrict__ v_cache, const int32_t* __restrict__ tables,
             const int32_t* __restrict__ seq_lens, T* __restrict__ out, int H,
             int KVH, int bt, int num_blocks, int max_blocks, float scale) {
  constexpr int E = D / 32;  // elements of a head row held by each lane
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seq_len = max(0, min(seq_lens[b], max_blocks * bt));
  const int nblk = (seq_len + bt - 1) / bt;

  float qr[G][E];
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qrow = q + (static_cast<int64_t>(b) * H + kvh * G + g) * D;
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
    const int page = tables[static_cast<int64_t>(b) * max_blocks + j];
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
          s[u][g] = its::warp_sum(part) * scale;
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
        l[g] = l[g] * corr + psum;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = acc[g][e] * corr + pv[e];
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
    out[(static_cast<int64_t>(b) * H + kvh * G + g) * D + d] =
        its::from_f32<T>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const int32_t* tables,
           const int32_t* seq_lens, void* out, int B, int H, int KVH, int bt,
           int num_blocks, int max_blocks, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid(KVH, B);
  paged_decode<T, D, G><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      tables, seq_lens, static_cast<T*>(out), H, KVH, bt, num_blocks, max_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_group(int G, const void* q, const void* k, const void* v, const int32_t* tables,
             const int32_t* seq_lens, void* out, int B, int H, int KVH, int bt,
             int num_blocks, int max_blocks, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, k, v, tables, seq_lens, out, B, H, KVH, bt, num_blocks, max_blocks, stream);
    case 2: return launch<T, D, 2>(q, k, v, tables, seq_lens, out, B, H, KVH, bt, num_blocks, max_blocks, stream);
    case 4: return launch<T, D, 4>(q, k, v, tables, seq_lens, out, B, H, KVH, bt, num_blocks, max_blocks, stream);
    case 8: return launch<T, D, 8>(q, k, v, tables, seq_lens, out, B, H, KVH, bt, num_blocks, max_blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int by_dim(int D, int G, const void* q, const void* k, const void* v,
           const int32_t* tables, const int32_t* seq_lens, void* out, int B, int H,
           int KVH, int bt, int num_blocks, int max_blocks, cudaStream_t stream) {
  switch (D) {
    case 64: return by_group<T, 64>(G, q, k, v, tables, seq_lens, out, B, H, KVH, bt, num_blocks, max_blocks, stream);
    case 128: return by_group<T, 128>(G, q, k, v, tables, seq_lens, out, B, H, KVH, bt, num_blocks, max_blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int its_paged_decode_attention(const void* q, const void* k_cache,
                                          const void* v_cache, const int32_t* tables,
                                          const int32_t* seq_lens, void* out, int dtype,
                                          int B, int H, int KVH, int D, int bt,
                                          int num_blocks, int max_blocks, void* stream) {
  if (B <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || bt <= 0 || max_blocks <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KVH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case its::kFloat32:
      return by_dim<float>(D, G, q, k_cache, v_cache, tables, seq_lens, out, B, H, KVH, bt, num_blocks, max_blocks, s);
    case its::kBFloat16:
      return by_dim<__nv_bfloat16>(D, G, q, k_cache, v_cache, tables, seq_lens, out, B, H, KVH, bt, num_blocks, max_blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
