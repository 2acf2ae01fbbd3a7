// K4, f32 path: blocked causal (flash) attention for prefill on the CUDA
// cores. bf16 inputs go to the tensor-core kernel in flash_prefill_wgmma.cu;
// this file keeps f32, whose contract is HIGHEST-precision dots with no TF32,
// which wgmma has no form for.
//
// Replaces infinistore_tpu/tpu/flash_prefill.py:_flash_prefill_pallas (bodies
// _flash_kernel and _flash_update) for f32 inputs:
//   q [B, S, H, D], k/v [B, T, KVH, D] (KVH divides H; D 8, 16, 32, 64, 80,
//   96, 128 or 256)
//   -> out [B, S, H, D] in f32. Dots are full-precision f32 FMAs; softmax statistics are f32.
// Causal masking is by global position and needs S == T (the wrapper checks).
//
// Bound: operations. Causal attention does 2 dots of 2*D flops over about
// S^2 / 2 (query, key) pairs per head: 2*S^2*D*H = 34.4 GFLOP per layer at
// S = 2048, H = 32, D = 128, about 0.51 ms at the 67 TFLOP/s f32 CUDA-core
// peak (bytes: q, k, v and out once, 84 MB, 25 us).
//
// Two bodies, by head_dim; both schedule heavy (late) query tiles first,
// stop key tiles at the causal diagonal (tiles above it are never read),
// and handle a ragged last tile by bounds checks.
//
// D = 8, 16, 32 (flash_prefill): one CTA of 256 threads per (query tile of
// 64 rows, batch x head). Q, K and V tiles sit in shared memory (Q and K
// rows padded by one word so that threads reading different rows hit
// distinct banks); each thread computes a 4 x 4 patch of the 64 x 64 logit
// tile and a 4 x ceil(D/16) patch of the output accumulator (4 x 1 at D =
// 16; at D = 8 the threads of columns 8-15 of the patch hold none and idle
// through PV), kept in registers. Each FMA reads two shared operands: at
// these head_dims the launch and the tile loads, not the FMAs, set the time.
//
// D = 64 to 256 (flash_prefill_blocked): here the FMAs set the time, and
// the first body's two shared loads an FMA held it near a fifth of the
// peak. One CTA of 256 threads per (query tile, batch x head). Thread (ty,
// tx) holds rows ty + kTY i and keys tx + kTX j of the logit tile: up to
// D = 128, 16 x 16 threads of 8 x 8 logits over a 128 x 128 tile; at 256,
// where 8 output rows would not fit the registers, 32 x 8 threads of 2 x 8
// over 64 x 64. Q and K keep their natural [row, D] layout in shared
// memory, padded by 4 words a row, so one 16-byte load gives four d-values:
// up to D = 128 a d-step of four reads 8 + 8 float4 and does 256 FMAs (one
// 16-byte load per 16 FMAs, what an SM's shared memory feeds its FMA rate
// with: a 16-byte load of a warp takes four of its 128-byte cycles), and a
// quarter-warp's 8 keys fall in distinct banks. The online softmax runs on
// the patch in registers (a row's kTX threads are lanes of one warp: max by
// shuffles; the row sum is kept per thread and reduced once, in the
// epilogue; the logits are scaled by log2 e / sqrt(D) and exponentiated
// with exp2f). P goes to shared memory [row, key]; PV reads four keys'
// probabilities for its rows (one float4 a row) and each key's V columns 4
// tx + 4 kTX j (float4; at D = 80 and 96 also 1 or 2 columns at the end),
// rows x D / kTX accumulators a thread. K and V have one buffer each,
// filled by cp.async so the loads run under the FMAs: K of tile t + 1 loads
// while tile t's softmax and PV run, V of tile t + 1 while tile t + 1's QK
// runs; three barriers a tile. At D = 128 there is no room for a P buffer
// beside Q, K and V: P takes K's, and tile t + 1's K and V load after tile
// t's PV. Shared memory: 169,984 bytes at D = 64, 194,560 at 80, 219,136 at
// 96, 200,704 at 128 and 216,064 at 256; one CTA, 8 warps, an SM. Inputs
// not 16-byte aligned are copied 4 bytes at a time. Left on the table: the
// loops run at about half the FMA peak (PERF.md: shared memory is not what
// holds them), so at D = 96 and 128 the CUTLASS kernel behind SDPA is
// faster.

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
  constexpr int DJ = (D + 15) / 16;  // output columns tx + 16 j of this thread

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
      for (int j = 0; j < DJ; ++j)
        vv[j] = D % 16 == 0 || tx + 16 * j < D ? Vs[c * D + tx + 16 * j] : 0.f;
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
      if (D % 16 == 0 || tx + 16 * j < D) ob[(q0 + r) * q_row + tx + 16 * j] = acc[i][j] / l;
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


// ---- D = 64 to 256: the register-blocked body ----

// Probe builds only: skip the FMAs of QK or of PV (wrong output; what each
// costs); the package builds neither.
#ifdef ITS_F32_SKIP_QK
constexpr bool kDoQK = false;
#else
constexpr bool kDoQK = true;
#endif
#ifdef ITS_F32_SKIP_PV
constexpr bool kDoPV = false;
#else
constexpr bool kDoPV = true;
#endif
#ifdef ITS_F32_SKIP_SOFTMAX
constexpr bool kDoSoftmax = false;
#else
constexpr bool kDoSoftmax = true;
#endif

template <int D>
struct Blocked {
  static constexpr int kThreads = 256;
  // Thread (ty, tx) holds rows ty + kTY i (i < kRM) and keys tx + kTX j
  // (j < kKN) of the logit tile, and rows ty + kTY i by D / kTX output
  // columns. Up to D = 128: 16 x 16 threads of 8 x 8 logits, a 128 x 128
  // tile; at 256, where 8 rows of output would not fit the registers,
  // 32 x 8 threads of 2 x 8, a 64 x 64 tile.
  static constexpr int kTX = D == 256 ? 8 : 16;
  static constexpr int kTY = kThreads / kTX;
  static constexpr int kRM = D == 256 ? 2 : 8;
  static constexpr int kKN = 8;
  static constexpr int kBQ = kTY * kRM;             // query rows a CTA
  static constexpr int kBK = kTX * kKN;             // keys a tile
  static constexpr int kQS = D + 4;                 // Q and K row stride (floats)
  static constexpr int kPS = kBK + 4;               // P row stride
  static constexpr int kC4 = D / (4 * kTX);         // float4 output groups a thread: 4 tx + 4 kTX j
  static constexpr int kTail = (D - 4 * kTX * kC4) / kTX;  // then 1 or 2 columns at the end
  static constexpr int kOC = 4 * kC4 + kTail;       // output columns a thread
  static constexpr int kQ = kBQ * kQS;
  static constexpr int kK = kBK * kQS;
  static constexpr int kV = kBK * D;
  // P takes K's buffer where a buffer of its own would not fit (D = 128):
  // the next tile's K and V then load after PV, not under the FMAs.
  static constexpr bool kAliasP = (kQ + kK + kV + kBQ * kPS) * 4 > 227 * 1024;
  static constexpr int kP = kAliasP ? 0 : kBQ * kPS;
  static constexpr int kBytes = (kQ + kK + kV + kP) * sizeof(float);
  static_assert(D % 16 == 0 && D >= 64, "the blocked body takes head_dim 64-256");
  static_assert(kTail == 0 || kTail == 1 || kTail == 2, "a thread's last columns");
  static_assert(!kAliasP || kBQ * kPS <= kK, "P fits K's buffer");
  static_assert(kBytes <= 227 * 1024, "shared memory");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0 .. row0 + rows - 1 of one head (src: row 0, column 0; rows
// src_row floats apart) into dst [rows, stride]; rows at or past `limit`
// are zero-filled. 16-byte copies when every input is 16-byte aligned.
template <int D, int kNT>
__device__ __forceinline__ void load_rows(float* dst, int stride, const float* src,
                                          int64_t src_row, int row0, int rows, int limit,
                                          bool vec) {
  if (vec) {
    constexpr int kChunks = D / 4;
    for (int idx = threadIdx.x; idx < rows * kChunks; idx += kNT) {
      const int r = idx / kChunks, c = idx % kChunks * 4;
      const bool in = row0 + r < limit;
      cp_async16(dst + r * stride + c, in ? src + (row0 + r) * src_row + c : src, in);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * D; idx += kNT) {
      const int r = idx / D, c = idx % D;
      const bool in = row0 + r < limit;
      cp_async4(dst + r * stride + c, in ? src + (row0 + r) * src_row + c : src, in);
    }
  }
}

__device__ __forceinline__ float lane_of(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

template <int D>
__global__ void __launch_bounds__(Blocked<D>::kThreads, 1)
flash_prefill_blocked(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out, int S, int T_len,
                      int H, int KVH, bool causal, float scale_log2, bool vec) {
  using L = Blocked<D>;
  constexpr int kRM = L::kRM, kKN = L::kKN, kTX = L::kTX, kTY = L::kTY, kBK = L::kBK;
  constexpr int kNT = L::kThreads;
  extern __shared__ __align__(16) float smem_blocked[];
  float* Qs = smem_blocked;
  float* Ks = Qs + L::kQ;
  float* Vs = Ks + L::kK;
  float* Ps = L::kAliasP ? Ks : Vs + L::kV;

  const int tid = threadIdx.x;
  const int tx = tid % kTX;  // keys tx + kTX j; output columns 4 tx + 4 kTX j
  const int ty = tid / kTX;  // rows ty + kTY i
  const int qt = gridDim.x - 1 - blockIdx.x;  // late tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = qt * L::kBQ;

  const int64_t q_row = static_cast<int64_t>(H) * D;  // stride between tokens
  const int64_t kv_row = static_cast<int64_t>(KVH) * D;
  const float* qb = q + (static_cast<int64_t>(b) * S) * q_row + h * D;
  const float* kb = k + (static_cast<int64_t>(b) * T_len) * kv_row + kvh * D;
  const float* vb = v + (static_cast<int64_t>(b) * T_len) * kv_row + kvh * D;

  const int last_row = min(q0 + L::kBQ, S) - 1;
  int n_kt = (T_len + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, last_row / kBK + 1);

  load_rows<D, kNT>(Qs, L::kQS, qb, q_row, q0, L::kBQ, S, vec);
  load_rows<D, kNT>(Ks, L::kQS, kb, kv_row, 0, kBK, T_len, vec);
  cp_async_commit();
  load_rows<D, kNT>(Vs, D, vb, kv_row, 0, kBK, T_len, vec);
  cp_async_commit();

  float o[kRM][L::kOC];
  float m[kRM], l[kRM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = its::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::kOC; ++c) o[i][c] = 0.f;
  }
  cp_async_wait<1>();  // Q and K of tile 0
  __syncthreads();

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    // Logits: four d-values a step, one float4 a row and a key.
    float s[kRM][kKN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kKN; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < (kDoQK ? D : 0); d += 4) {
      float4 qv[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + kTY * i) * L::kQS + d);
#pragma unroll
      for (int j = 0; j < kKN; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + (tx + kTX * j) * L::kQS + d);
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int i = 0; i < kRM; ++i)
            s[i][j] = fmaf(lane_of(qv[i], c), lane_of(kv, c), s[i][j]);
      }
    }
    __syncthreads();  // every thread is done with Ks
    if (!L::kAliasP && kt + 1 < n_kt)
      load_rows<D, kNT>(Ks, L::kQS, kb, kv_row, k0 + kBK, kBK, T_len, vec);
    cp_async_commit();

    // Online softmax on the patch; P to shared memory.
    const bool mask = k0 + kBK > T_len || (causal && k0 + kBK - 1 > q0);
    if constexpr (!kDoSoftmax) {
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kKN; ++j) Ps[(ty + kTY * i) * L::kPS + tx + kTX * j] = s[i][j];
    }
#pragma unroll
    for (int i = 0; i < (kDoSoftmax ? kRM : 0); ++i) {
      const int r = q0 + ty + kTY * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kKN; ++j) {
        const int c = k0 + tx + kTX * j;
        float x = s[i][j] * scale_log2;
        if (mask && (c >= T_len || (causal && c > r))) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 1; w < kTX; w *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float alpha = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKN; ++j) {
        const float p = exp2f(s[i][j] - mx);
        sum += p;
        Ps[(ty + kTY * i) * L::kPS + tx + kTX * j] = p;
      }
      l[i] = alpha * l[i] + sum;  // this thread's keys; the row's kTX threads add up at the end
#pragma unroll
      for (int c = 0; c < L::kOC; ++c) o[i][c] *= alpha;
    }
    cp_async_wait<1>();  // V of this tile (K of the next may still be in flight)
    __syncthreads();

    // O += P V: four keys a step, one float4 of P a row.
#pragma unroll 2
    for (int c = 0; c < (kDoPV ? kBK : 0); c += 4) {
      float4 pv[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + kTY * i) * L::kPS + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = Vs + (c + u) * D;
#pragma unroll
        for (int j = 0; j < L::kC4; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + 4 * tx + 4 * kTX * j);
#pragma unroll
          for (int i = 0; i < kRM; ++i) {
            const float p = lane_of(pv[i], u);
            o[i][4 * j] = fmaf(p, vv.x, o[i][4 * j]);
            o[i][4 * j + 1] = fmaf(p, vv.y, o[i][4 * j + 1]);
            o[i][4 * j + 2] = fmaf(p, vv.z, o[i][4 * j + 2]);
            o[i][4 * j + 3] = fmaf(p, vv.w, o[i][4 * j + 3]);
          }
        }
        if constexpr (L::kTail == 2) {
          const float2 vv = *reinterpret_cast<const float2*>(vr + 4 * kTX * L::kC4 + 2 * tx);
#pragma unroll
          for (int i = 0; i < kRM; ++i) {
            const float p = lane_of(pv[i], u);
            o[i][4 * L::kC4] = fmaf(p, vv.x, o[i][4 * L::kC4]);
            o[i][4 * L::kC4 + 1] = fmaf(p, vv.y, o[i][4 * L::kC4 + 1]);
          }
        } else if constexpr (L::kTail == 1) {
          const float vv = vr[4 * kTX * L::kC4 + tx];
#pragma unroll
          for (int i = 0; i < kRM; ++i)
            o[i][4 * L::kC4] = fmaf(lane_of(pv[i], u), vv, o[i][4 * L::kC4]);
        }
      }
    }
    if constexpr (L::kAliasP) {
      __syncthreads();  // every thread is done with Vs and P (in Ks)
      if (kt + 1 < n_kt) {
        load_rows<D, kNT>(Ks, L::kQS, kb, kv_row, k0 + kBK, kBK, T_len, vec);
        load_rows<D, kNT>(Vs, D, vb, kv_row, k0 + kBK, kBK, T_len, vec);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    } else {
      cp_async_wait<0>();  // K of the next tile
      __syncthreads();     // every thread is done with Vs and Ps
      if (kt + 1 < n_kt) load_rows<D, kNT>(Vs, D, vb, kv_row, k0 + kBK, kBK, T_len, vec);
      cp_async_commit();
    }
  }

  float* ob = out + (static_cast<int64_t>(b) * S) * q_row + h * D;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    float li = l[i];
#pragma unroll
    for (int w = 1; w < kTX; w *= 2) li += __shfl_xor_sync(0xffffffffu, li, w);
    li = fmaxf(li, 1e-30f);
    const int r = q0 + ty + kTY * i;
    if (r >= S) continue;
    float* orow = ob + r * q_row;
#pragma unroll
    for (int j = 0; j < L::kC4; ++j)
      *reinterpret_cast<float4*>(orow + 4 * tx + 4 * kTX * j) =
          make_float4(o[i][4 * j] / li, o[i][4 * j + 1] / li, o[i][4 * j + 2] / li,
                      o[i][4 * j + 3] / li);
    if constexpr (L::kTail == 2)
      *reinterpret_cast<float2*>(orow + 4 * kTX * L::kC4 + 2 * tx) =
          make_float2(o[i][4 * L::kC4] / li, o[i][4 * L::kC4 + 1] / li);
    else if constexpr (L::kTail == 1)
      orow[4 * kTX * L::kC4 + tx] = o[i][4 * L::kC4] / li;
  }
}

template <int D>
int launch_blocked(const void* q, const void* k, const void* v, void* out, int B, int S,
                   int T_len, int H, int KVH, bool causal, cudaStream_t stream) {
  using L = Blocked<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_blocked<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  // Logits in base 2: exp2(x * log2 e) = exp(x), so the body takes exp2f.
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  const dim3 grid((S + L::kBQ - 1) / L::kBQ, B * H);
  flash_prefill_blocked<D><<<grid, L::kThreads, L::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), S, T_len, H, KVH, causal, scale_log2, vec);
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
    case 8: return launch<8>(q, k, v, out, B, S, T_len, H, KVH, causal != 0, s);
    case 16: return launch<16>(q, k, v, out, B, S, T_len, H, KVH, causal != 0, s);
    case 32: return launch<32>(q, k, v, out, B, S, T_len, H, KVH, causal != 0, s);
    case 64: return launch_blocked<64>(q, k, v, out, B, S, T_len, H, KVH, causal != 0, s);
    case 80: return launch_blocked<80>(q, k, v, out, B, S, T_len, H, KVH, causal != 0, s);
    case 96: return launch_blocked<96>(q, k, v, out, B, S, T_len, H, KVH, causal != 0, s);
    case 128: return launch_blocked<128>(q, k, v, out, B, S, T_len, H, KVH, causal != 0, s);
    case 256: return launch_blocked<256>(q, k, v, out, B, S, T_len, H, KVH, causal != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
