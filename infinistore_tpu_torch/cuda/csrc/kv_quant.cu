// K8: batched paged decode attention over an int8 KV cache.
//
// Replaces infinistore_tpu/tpu/kv_quant.py:_quant_decode_pallas (body
// _quant_decode_kernel, through _attn_block_update):
//   q [B, H, D] f32 or bf16, k/v data [N, bt, KVH, D] int8, k/v scales
//   [N, bt, KVH] f32 (one per (token, KV head), from quantize_kv),
//   tables [B, max_blocks] int32, seq_lens [B] int32 -> out [B, H, D] in
//   q's dtype.
// Its contract is the JAX package's: attention over the dequantised cache
// (data * scale), within 1e-5 of the plain version (_quant_decode_xla's
// dequantise-then-float decode) with f32 q and 2e-2 with bf16 q. Beyond it:
// two launches on the same inputs are bitwise equal, a row's splits depend
// only on its own length (so a row is bitwise its solo launch), seq_len 0
// gives zeros, pages outside [0, N) and rows past seq_len read nothing and
// weigh nothing, and no floating-point atomic is used.
//
// Bound: bytes. The function reads one int8 byte per K and V element plus one
// f32 scale per (token, KV head): at B=4, 2048 tokens, 8 KV heads x 128 that
// is 16 MiB of data and 0.5 MiB of scales per layer per step, about 5.2 us at
// 3.35 TB/s, half of K3's bf16 read.
//
// Design: a split-KV fold of its own, built for int8 bytes, with the split
// merge of decode_fold.cuh (finish_split). Against K3's fold run with an
// int8 loader (what K8 was before), which widened 8 elements a lane from an
// 8-byte read, dequantised every element with its own multiply and converted
// each byte with a quarter-rate int-to-float:
//   1. Loads: a lane owns kVec = 16 int8 elements of a token's head row, one
//      16-byte read from the ring (8 at G = 8, which keeps q and acc at 128
//      floats a thread). At D = 128 a token sits on 8 lanes and a warp folds
//      4 tokens a step; a 32-token stage carries 8 KiB of K and V, as many
//      bytes as K3's bf16 stage, so a split takes half K3's stages.
//   2. Conversion: each byte becomes an exact f32 in two full-rate
//      instructions: the byte, biased by 128, is permuted into the low byte
//      of 2^23's bits, and one subtraction of 2^23 + 128 leaves its value.
//   3. Scales once per token: score = (s_k[t] * 1/sqrt(D)) * sum(q * data),
//      and the PV weight is p * s_v[t]; the integers are exact in f32, so
//      no element is multiplied by its scale.
//   4. The fold's split policy (decode_fold.cuh: split_pages, grid_splits):
//      about 8 splits of 4 to 16 pages, a function of the row's own length
//      and compile-time constants only. On the card (PERF.md) 8 splits at
//      the int8 round trip's wave (256 CTAs, one wave at 2 an SM) beat 16 and
//      32 (512 and 1,024 CTAs), since each CTA pays a fixed chain of
//      latencies (its table, its first stage, the in-CTA merge, the ticket)
//      that more CTAs only repeat. Rows of more than 16 splits merge in
//      finish_split's tree, in split order.
// What bounds it (PERF.md): neither the bytes (the fold took as long with
// every page in L2) nor the issue rate, but that per-CTA chain beside the
// launch floor; 4 tokens a group a stage, 8 elements a lane, deeper or
// shallower rings and more CTAs an SM did no better.
// The scores are summed by the transposed butterfly, the online softmax and
// its sharing run as in decode_fold.cuh, through a 4-stage cp.async ring
// (rows past seq_len and pages outside [0, N) are zero-filled and masked).
// f32 q stays on f32 FMAs; tensor cores are not used.

#include "decode_fold.cuh"

namespace {

// How a CTA lays out head dim D at group size G: kVec int8 elements a lane,
// kLanes lanes a token, kGroups token groups each folding kTokPerGroup tokens
// of every kStageTok-token stage; the ring holds a stage's K rows, V rows,
// K scales and V scales.
template <int D, int G>
struct Q8Fold {
  static constexpr int kVec = G <= 4 ? 16 : 8;
  static constexpr int kLanes = D / kVec;
  static constexpr int kGroups = kThreads / kLanes;
  static constexpr int kTokPerGroup = 2;
  static constexpr int kStageTok = kGroups * kTokPerGroup;
  static constexpr int kStages = 4;
  static constexpr int kSideBytes = kStageTok * D;
  static constexpr int kStageBytes = 2 * kSideBytes + 2 * kStageTok * 4;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kMergeBytes = (kGroups * G * (D + 2) + 2 * G) * 4;
  static constexpr int kBytes = kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
  // q and acc take 2 x G x kVec floats a thread; registers cap the CTAs an SM
  // holds by it.
  static constexpr int kState = 2 * G * kVec;
  static constexpr int kMinBlocks = kState >= 128 ? 2 : kState >= 64 ? 3 : 4;
};

struct Int8Pages {
  const int8_t* k;
  const float* ks;
  const int8_t* v;
  const float* vs;

  __device__ __forceinline__ const int8_t* data(int side) const { return side ? v : k; }
  __device__ __forceinline__ const float* scales(int side) const { return side ? vs : ks; }
  bool aligned() const {
    return (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0 &&
           (reinterpret_cast<uintptr_t>(ks) | reinterpret_cast<uintptr_t>(vs)) % 4 == 0;
  }
};

// N int8 elements from the ring as exact f32 values: byte i of a word, biased
// to b + 128 (one xor a word), is permuted into the low byte of 2^23's bits,
// 0x4B0000xx = 2^23 + b + 128, and one subtraction leaves b.
template <int N>
__device__ __forceinline__ void widen_s8(const int8_t* p, float (&x)[N]) {
  static_assert(N == 8 || N == 16, "one 8- or 16-byte read");
  uint32_t w[N / 4];
  if constexpr (N == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  }
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
    x[4 * i + 0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u)) - 8388736.f;
    x[4 * i + 1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651u)) - 8388736.f;
    x[4 * i + 2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652u)) - 8388736.f;
    x[4 * i + 3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653u)) - 8388736.f;
  }
}

// One work item: split `split` of row `row` (KV head `kvh`) over
// table[0 .. ceil(seq_len / bt)).
template <typename T, int D, int G>
__device__ __forceinline__ void quant_split(const T* __restrict__ q, const Int8Pages& kv,
                                            const int32_t* __restrict__ table, int seq_len,
                                            const Normalize<T>& epi, float* __restrict__ scratch,
                                            int* __restrict__ tickets, int row, int kvh,
                                            int split, int H, int KVH, int bt, int num_blocks,
                                            int splits, float scale) {
  using F = Q8Fold<D, G>;
  constexpr int kVec = F::kVec;
  constexpr int kChunks = D / 16;  // 16-byte chunks of a head row
  constexpr int kCopies = 2 * F::kStageTok * kChunks / kThreads;
  static_assert(2 * F::kStageTok * kChunks % kThreads == 0, "a stage splits evenly");
  static_assert(2 * F::kStageTok <= kThreads, "one scale copy per thread");

  const int npages = (seq_len + bt - 1) / bt;
  const int spp = split_pages(npages);
  const int nsplit = max(1, (npages + spp - 1) / spp);
  if (split >= nsplit) return;  // the same for every thread of the CTA

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t sm_base[kMaxSplitPages];  // element offset of (page, token 0, kvh), or -1
  __shared__ bool sm_ok[F::kStages][F::kStageTok];  // a ring row holds a valid token

  const int tid = threadIdx.x;
  const int page0 = split * spp;
  if (tid < spp) {
    const int j = page0 + tid;
    const int page = j < npages ? table[j] : -1;
    sm_base[tid] = (page >= 0 && page < num_blocks)
        ? (static_cast<int64_t>(page) * bt * KVH + kvh) * D : -1;
  }
  const int ntok = min(seq_len - page0 * bt, spp * bt);
  const int nstages = (ntok + F::kStageTok - 1) / F::kStageTok;
  const int row_stride = KVH * D;  // elements from one token's row to the next

  // The producer's copies: copy k of this thread moves 16-byte chunk col_k of
  // ring row r_k (copy kCopies: the f32 scale of ring row tid % kStageTok of
  // side tid / kStageTok), whose token sits at offset po[k] of the split's
  // page pi[k]; the position advances by a stage without a division.
  int pi[kCopies + 1], po[kCopies + 1];
#pragma unroll
  for (int k = 0; k <= kCopies; ++k) {
    const int r = k < kCopies ? ((tid + k * kThreads) / kChunks) % F::kStageTok
                              : tid % F::kStageTok;
    pi[k] = r / bt;
    po[k] = r % bt;
  }
  __syncthreads();

  auto issue = [&](int st) {
    unsigned char* slot = smem + (st % F::kStages) * F::kStageBytes;
    const int tok0 = st * F::kStageTok;
#pragma unroll
    for (int k = 0; k <= kCopies; ++k) {
      const int c = tid + k * kThreads;
      const int side = k < kCopies ? c / (F::kStageTok * kChunks) : tid / F::kStageTok;
      const int r = k < kCopies ? (c / kChunks) % F::kStageTok : tid % F::kStageTok;
      const int64_t base = tok0 + r < ntok ? sm_base[pi[k]] : -1;
      const int64_t at = base + static_cast<int64_t>(po[k]) * row_stride;
      if (k < kCopies) {
        const int col = c % kChunks;
        const int8_t* src = base >= 0 ? kv.data(side) + at + col * 16 : kv.data(side);
        cp_async16(slot + side * F::kSideBytes + r * D + col * 16, src, base >= 0);
        if (side == 0 && col == 0) sm_ok[st % F::kStages][r] = base >= 0;
      } else if (tid < 2 * F::kStageTok) {
        const float* src = base >= 0 ? kv.scales(side) + at / D : kv.scales(side);
        cp_async4(slot + 2 * F::kSideBytes + tid * 4, src, base >= 0);
      }
      po[k] += F::kStageTok;
      while (po[k] >= bt) {
        po[k] -= bt;
        ++pi[k];
      }
    }
  };

  const int grp = tid / F::kLanes;  // token group (aligned lanes of one warp)
  const int gl = tid % F::kLanes;   // lane in the group: elements gl*kVec ..
  const int lane0 = (tid & 31) - gl;

  // As in decode_fold.cuh: score u * G + g (token u, query head g) of a
  // stage; this lane holds scores idx0 + j, j < kHeld, all of token u_own,
  // and keeps their heads' running max and denominator.
  constexpr int kNV = F::kTokPerGroup * G;
  constexpr int kHeld = kNV > F::kLanes ? kNV / F::kLanes : 1;
  const int idx0 = gl * kNV / F::kLanes;
  const int u_own = idx0 / G;
  constexpr int kTokLanes = F::kLanes / F::kTokPerGroup;  // lanes from a token's scores to the next's
  auto holder = [](int idx) { return kNV > F::kLanes ? idx / kHeld : idx * F::kLanes / kNV; };

  // q in 16-byte loads (the wrapper checks q's alignment), widened as the
  // fold widens a float cache's rows.
  float qr[G][kVec], acc[G][kVec], m_own[kHeld], l_own[kHeld];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qrow = q + (static_cast<int64_t>(row) * H + kvh * G + g) * D + gl * kVec;
#pragma unroll
    for (int c = 0; c < kVec / 8; ++c) {
      float part[8];
      widen(qrow + 8 * c, part);
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][8 * c + e] = part[e];
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    m_own[j] = its::kNegInf;
    l_own[j] = 0.f;
  }

#pragma unroll
  for (int st = 0; st < F::kStages - 1; ++st) {
    if (st < nstages) issue(st);
    cp_async_commit();
  }
  for (int st = 0; st < nstages; ++st) {
    cp_async_wait<F::kStages - 2>();
    __syncthreads();  // stage st landed for every thread; stage st-1's slot is free
    if (st + F::kStages - 1 < nstages) issue(st + F::kStages - 1);
    cp_async_commit();

    const unsigned char* slot = smem + (st % F::kStages) * F::kStageBytes;
    const int8_t* ks = reinterpret_cast<const int8_t*>(slot);
    const int8_t* vs = reinterpret_cast<const int8_t*>(slot + F::kSideBytes);
    const float* scl = reinterpret_cast<const float*>(slot + 2 * F::kSideBytes);
    float x[kVec];
    float sv[kNV];  // this lane's partial dot products, then its held sums
#pragma unroll
    for (int u = 0; u < F::kTokPerGroup; ++u) {
      widen_s8(ks + (grp + F::kGroups * u) * D + gl * kVec, x);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) part = fmaf(qr[g][e], x[e], part);
        sv[u * G + g] = part;
      }
    }
    transpose_sum<kNV, F::kLanes / 2>(sv, gl);
    // The held scores' token: its K scale, folded with 1/sqrt(D), and whether
    // it is a valid token. The group's other tokens' scores of the same heads
    // sit kTokLanes, 2 x kTokLanes, ... lanes away: the stage's max and the
    // probabilities' sum go over them by a butterfly, so every holder of a
    // head ends with the same bits.
    const int r_own = grp + F::kGroups * u_own;
    const float s_own = __fmul_rn(scl[r_own], scale);
    const bool ok_own = sm_ok[st % F::kStages][r_own];
    float p_own[kHeld], c_own[kHeld];
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      const float mine = __fmul_rn(sv[j], s_own);
      float m_tok = ok_own ? mine : its::kNegInf;
#pragma unroll
      for (int off = kTokLanes; off < F::kLanes; off *= 2)
        m_tok = fmaxf(m_tok, __shfl_xor_sync(0xffffffffu, m_tok, off));
      const float m_new = fmaxf(m_own[j], m_tok);
      p_own[j] = ok_own ? expf(mine - m_new) : 0.f;
      float psum = p_own[j];
#pragma unroll
      for (int off = kTokLanes; off < F::kLanes; off *= 2)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      c_own[j] = expf(m_own[j] - m_new);
      l_own[j] = fmaf(l_own[j], c_own[j], psum);
      m_own[j] = m_new;
    }
    // Every lane folds V for every head: the probabilities and corrections
    // from their holders, each probability weighted by its token's V scale;
    // acc is rescaled once, then each token's V row is widened and added.
    float pw[kNV];
#pragma unroll
    for (int idx = 0; idx < kNV; ++idx)
      pw[idx] = __fmul_rn(__shfl_sync(0xffffffffu, p_own[idx % kHeld], lane0 + holder(idx)),
                          scl[F::kStageTok + grp + F::kGroups * (idx / G)]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float corr = __shfl_sync(0xffffffffu, c_own[g % kHeld], lane0 + holder(g));
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][e] = __fmul_rn(acc[g][e], corr);
    }
#pragma unroll
    for (int u = 0; u < F::kTokPerGroup; ++u) {
      widen_s8(vs + (grp + F::kGroups * u) * D + gl * kVec, x);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] = fmaf(pw[u * G + g], x[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: its memory now holds the merge

  float* sm_ml = reinterpret_cast<float*>(smem);  // [kGroups][G][m, l]
  float* sm_acc = sm_ml + F::kGroups * G * 2;     // [kGroups][G][D]
  if (u_own == 0 && gl == holder(idx0)) {
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      sm_ml[(grp * G + idx0 + j) * 2] = m_own[j];
      sm_ml[(grp * G + idx0 + j) * 2 + 1] = l_own[j];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) sm_acc[(grp * G + g) * D + gl * kVec + e] = acc[g][e];
  }
  __syncthreads();
  finish_split<D, G, F::kGroups>(smem, epi, scratch, tickets, row, kvh, split, nsplit, H, KVH,
                                 splits);
}

// Grid (splits x KVH, B): row b attends over tables[b, :], its seq_len
// clamped to the table's max_blocks * bt.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads, Q8Fold<D, G>::kMinBlocks)
quant_decode(const T* __restrict__ q, Int8Pages kv, const int32_t* __restrict__ tables,
             const int32_t* __restrict__ seq_lens, Normalize<T> epi,
             float* __restrict__ scratch, int* __restrict__ tickets, int H, int KVH, int bt,
             int num_blocks, int max_blocks, int splits, float scale) {
  const int b = blockIdx.y;
  const int seq_len = max(0, min(seq_lens[b], max_blocks * bt));
  quant_split<T, D, G>(q, kv, tables + static_cast<int64_t>(b) * max_blocks, seq_len, epi,
                       scratch, tickets, b, blockIdx.x / splits, blockIdx.x % splits, H, KVH,
                       bt, num_blocks, splits, scale);
}

}  // namespace

// The decode entries' arguments (decode_fold.cuh: launch), with k_data,
// k_scales, v_data, v_scales in place of k, v; `splits` =
// its_decode_splits(max_blocks).
extern "C" int its_paged_decode_attention_quantized(
    const void* q, const int8_t* k_data, const float* k_scales, const int8_t* v_data,
    const float* v_scales, const int32_t* tables, const int32_t* seq_lens, void* out,
    float* scratch, int* tickets, int dtype, int B, int H, int KVH, int D, int bt,
    int num_blocks, int max_blocks, int splits, void* stream) {
  const Shape s{B, H, KVH, bt, num_blocks, max_blocks, 0, splits,
                static_cast<cudaStream_t>(stream)};
  const Int8Pages kv{k_data, k_scales, v_data, v_scales};
  if (!kv.aligned() || reinterpret_cast<uintptr_t>(q) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return dispatch(dtype, D, s, [&](auto c) {
    using T = typename decltype(c)::T;
    constexpr int kD = decltype(c)::D;
    constexpr int kG = decltype(c)::G;
    const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(kD)));
    return launch_split_kernel(quant_decode<T, kD, kG>, Q8Fold<kD, kG>::kBytes, s,
                               static_cast<const T*>(q), kv, tables, seq_lens,
                               Normalize<T>{static_cast<T*>(out)}, scratch, tickets, s.H, s.KVH,
                               s.bt, s.num_blocks, s.width, s.splits, scale);
  });
}
