// K4, f32 path: blocked causal (flash) attention for prefill on the CUDA
// cores. bf16 inputs go to the tensor-core kernel in flash_prefill_wgmma.cu;
// this file keeps f32, whose contract is HIGHEST-precision dots with no TF32,
// which wgmma has no form for.
//
// Replaces infinistore_tpu/tpu/flash_prefill.py:_flash_prefill_pallas (bodies
// _flash_kernel and _flash_update) for f32 inputs:
//   q [B, S, H, D], k/v [B, T, KVH, D] (KVH divides H) -> out [B, S, H, D]
// in f32. Dots are full-precision f32 FMAs; softmax statistics are f32.
// Causal masking is by global position and needs S == T (the wrapper checks).
//
// Bound: operations. Causal attention does 2 dots of 2*D flops over about
// S^2 / 2 (query, key) pairs per head: 2*S^2*D*H = 34.4 GFLOP per layer at
// S = 2048, H = 32, D = 128, about 0.51 ms at the 67 TFLOP/s f32 CUDA-core
// peak (bytes: q, k, v and out once, 84 MB, 25 us).
//
// Design: one CTA of 256 threads per (query tile of 64 rows, batch x head).
// Q, K and V tiles sit in shared memory (Q and K rows padded by one word so
// that threads reading different rows hit distinct banks); each thread
// computes a 4 x 4 patch of the 64 x 64 logit tile and a 4 x (D/16) patch
// of the output accumulator, kept in registers. Key tiles stop at the causal
// diagonal, so tiles above it are never read. A ragged last tile is handled
// by bounds checks, not by a dividing tile size. Heavy (late) query tiles
// are scheduled first. Left on the table: shared-memory bandwidth (each
// FMA reads two shared operands); the small f32 models that run this path
// do not need more.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 16 x 16

template <int D>
struct Smem {
  static constexpr int kQ = kBQ * (D + 1);    // Q tile, row stride D + 1
  static constexpr int kK = kBK * (D + 1);    // K tile, row stride D + 1
  static constexpr int kV = kBK * D;          // V tile, row stride D
  static constexpr int kP = kBQ * (kBK + 1);  // logits / probabilities
  static constexpr int kFloats = kQ + kK + kV + kP + 3 * kBQ;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int S, int T_len, int H,
              int KVH, bool causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + Smem<D>::kQ;
  float* Vs = Ks + Smem<D>::kK;
  float* Ps = Vs + Smem<D>::kV;
  float* row_m = Ps + Smem<D>::kP;
  float* row_l = row_m + kBQ;
  float* row_a = row_l + kBQ;
  constexpr int KS = D + 1;  // Q and K row stride
  constexpr int PS = kBK + 1;
  constexpr int DJ = D / 16;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // late tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kBQ;

  const int64_t q_row = static_cast<int64_t>(H) * D;    // stride between tokens
  const int64_t kv_row = static_cast<int64_t>(KVH) * D;
  const float* qb = q + (static_cast<int64_t>(b) * S) * q_row + h * D;
  const float* kb = k + (static_cast<int64_t>(b) * T_len) * kv_row + kvh * D;
  const float* vb = v + (static_cast<int64_t>(b) * T_len) * kv_row + kvh * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    Qs[r * KS + d] = (q0 + r < S) ? qb[(q0 + r) * q_row + d] : 0.f;
  }
  if (tid < kBQ) {
    row_m[tid] = its::kNegInf;
    row_l[tid] = 0.f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int last_row = min(q0 + kBQ, S) - 1;
  int n_kt = (T_len + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, last_row / kBK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile's PV reads of Vs / Ps are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      const bool in = k0 + c < T_len;
      Ks[c * KS + d] = in ? kb[(k0 + c) * kv_row + d] : 0.f;
      Vs[c * D + d] = in ? vb[(k0 + c) * kv_row + d] : 0.f;
    }
    __syncthreads();

    // Logits: rows ty + 16 i, columns tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * KS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool valid = (k0 + c < T_len) && (!causal || k0 + c <= q0 + r);
        Ps[r * PS + c] = valid ? s[i][j] * scale : its::kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: 4 threads per row, 16 columns each.
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float mx = its::kNegInf;
#pragma unroll
      for (int u = 0; u < kBK / 4; ++u) mx = fmaxf(mx, Ps[r * PS + part + 4 * u]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kBK / 4; ++u) {
        const int c = part + 4 * u;
        const bool valid = (k0 + c < T_len) && (!causal || k0 + c <= q0 + r);
        const float p = valid ? expf(Ps[r * PS + c] - m_new) : 0.f;
        sum += p;
        Ps[r * PS + c] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        row_a[r] = alpha;
        row_l[r] = alpha * row_l[r] + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: rows ty + 16 i, columns tx + 16 j.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_a[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pr[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  float* ob = out + (static_cast<int64_t>(b) * S) * q_row + h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float l = fmaxf(row_l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(q0 + r) * q_row + tx + 16 * j] = acc[i][j] / l;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int T_len,
           int H, int KVH, bool causal, cudaStream_t stream) {
  const size_t bytes = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_prefill<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_prefill<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), S, T_len, H, KVH, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 tensors only (bf16 goes to its_flash_prefill_wgmma).
extern "C" int its_flash_prefill(const void* q, const void* k, const void* v, void* out, int B,
                                 int S, int T_len, int H, int KVH, int D, int causal,
                                 void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || T_len <= 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, out, B, S, T_len, H, KVH, causal != 0, s);
    case 128: return launch<128>(q, k, v, out, B, S, T_len, H, KVH, causal != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
