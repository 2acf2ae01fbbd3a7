// The paged decode fold that K3, K5, K6 and K7 share: a split-KV
// (flash-decoding) fold for Hopper, and the split merge K8 shares with it.
//
// Replaces, through the entries of paged_attention.cu and
// paged_attention_stats.cu, the fold of infinistore_tpu/tpu/paged_attention.py
// (_attn_block_update / _attn_block_fold / _ragged_fold) that the TPU kernels
// _paged_decode_attention_pallas_batched, _pallas_stats, _pallas_ragged and
// _pallas_ragged_stats run. One query row (a request, or a flat row of a
// ragged wave) attends over the cache pages its page list names, for the
// G = H / KVH query heads of one KV head. (K8, kv_quant.cu, folds int8 pages
// in a fold of its own and shares this file's split merge.)
//
// Bound: bytes. The function must read the K and V of every valid token once
// (a ragged wave: each distinct page once), plus q and the output.
//
// Design, point by point against the fold it replaces (one CTA per (KV head,
// row), 8 warps taking the row's pages round-robin, 2-byte lane-strided loads,
// a 32-lane warp sum per token and query head, no prefetch, 32 KiB of static
// shared memory for the merge):
//   1. The sequence is split across CTAs. A work item is (KV head, row,
//      split); a split is split_pages(n) consecutive pages of the row's n
//      pages (n = ceil(seq_len / bt)): 8 splits of 4 to 16 pages, 16-page
//      splits from 128 pages up (a 1,152-token row is 8 splits of 9 pages, a
//      2,048-token row 8 of 16, a 32,768-token row 128 of 16). A row's split
//      count and boundaries depend only on its own (clamped) seq_len and
//      compile-time constants: never on the number of rows, the grid or the
//      other rows. So a K6 row is bitwise the K3 row over its own table and
//      bitwise its solo launch, and a K5/K7 row is the state K3/K6
//      normalise. The grid is (splits x KVH, rows), splits =
//      grid_splits(width) for the launch's table width, a row's splits of
//      one KV head on adjacent CTAs; a CTA past its row's split count exits
//      at once.
//   2. A lane owns kVec = 8 consecutive elements of a token's head row: one
//      16-byte load in bf16, two in f32. A token's D elements sit on D / 8
//      lanes (a token group: 16 lanes at D = 128), and a group folds 2
//      tokens a stage. Its 2 x G partial dot products are summed by a
//      transposed butterfly (transpose_sum: each level sends half of the
//      values left, so a lane ends holding whole sums, one per (token, head)
//      pair at G = 4), and each lane runs the softmax of the scores it holds
//      (its head's running max and denominator, one expf per score and one
//      per correction) and shares the probabilities and corrections back by
//      shuffles for the PV update every lane does on its 8 elements. The
//      mapping from elements to lanes, tokens to groups and stages, and
//      scores to lanes is defined in elements and is the same for the f32
//      and bf16 loaders, so f32 K3 over a bf16 cache widened to f32 adds the
//      same products in the same order as bf16 K3.
//   3. Pages stream through a kStages-deep cp.async ring in dynamic shared
//      memory (cp.async.cg, 16 bytes, L1 bypassed): each stage is kStageTok
//      token rows of one KV head, K then V, gathered from the pages of the
//      split whose addresses the CTA computes once into shared memory; each
//      copy's position advances by a stage without a division. Later stages
//      load while the current one folds. cp.async needs no per-call host work
//      (a TMA tensor map would cost a host-side encode per call on a
//      host-bound decode path). Rows past seq_len and pages outside [0, N)
//      are zero-filled (no bytes read) and masked.
//   4. A split's token groups merge through shared memory, which the ring
//      hands back once drained (so the 32 KiB merge at G = 8 costs no extra
//      space); each (group, head) weight is one expf (finish_split). A row
//      of one split applies its epilogue at once. A row of several splits
//      writes each split's partial (acc [D], m, l per query head) to f32
//      scratch, and the last CTA to arrive merges them (merge_partials) in
//      split order, never in arrival order, with its global reads issued
//      together, and applies the epilogue. Arrival is an acq_rel atomic
//      ticket, reset by the CTA that merges. Up to kMergeGroup splits, the
//      last CTA of the (row, KV head) merges them all. A longer row merges
//      in a fixed two-level tree, so its merge is spread across the card and
//      no CTA reads more than kMergeGroup partials at a time: the last CTA of
//      each group of kMergeGroup consecutive splits merges its group in
//      split order into the group's first slot, and the last of the group
//      mergers merges the groups in group order. The tree depends only on
//      the row's own split count, so K3 and K5 take the same one. Two
//      launches on the same inputs are bitwise equal, and no floating-point
//      atomic is used. An empty split (m -1e30, l 0, acc 0) merges as a
//      no-op; a row with seq_len 0 is one empty split, so it gives acc 0,
//      l 0, m -1e30 (zeros through Normalize).
//
// Every product that feeds a sum is an explicit fmaf or __fmul_rn, so FMA
// contraction cannot round two kernels apart. Only the first ceil(seq_len /
// bt) pages of a row are read (the TPU kernels' fully-masked blocks are bitwise
// no-ops, so skipping them changes nothing).
//
// The parts each kernel instantiates:
//   - a KV loader: FloatKV reads f32/bf16 caches;
//   - an epilogue, applied once per (row, query head, d) after the merge:
//     Normalize writes acc / max(l, 1e-30) in the query's dtype (K3, K6, K8),
//     RawStats writes (acc, m, l) in f32 (K5, K7).
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// A row of n pages folds in splits of split_pages(n) consecutive pages: as
// close to kTargetSplits splits as kMinSplitPages..kMaxSplitPages pages a
// split allow (16-page splits from 128 pages up, 256 tokens at bt = 16).
// (Long rows keep 16-page splits: 8- and 32-page splits past 256 pages
// measured slower at 32,768 tokens; PERF.md.)
constexpr int kTargetSplits = 8;
constexpr int kMinSplitPages = 4;
constexpr int kMaxSplitPages = 16;

__host__ __device__ constexpr int split_pages(int npages) {
  return npages <= kTargetSplits * kMinSplitPages ? kMinSplitPages
         : npages >= kTargetSplits * kMaxSplitPages ? kMaxSplitPages
         : (npages + kTargetSplits - 1) / kTargetSplits;
}

// The most splits a row of at most `width` pages has: the grid's split
// dimension, and the scratch's.
__host__ __device__ constexpr int grid_splits(int width) {
  return width <= kTargetSplits * kMinSplitPages ? (width + kMinSplitPages - 1) / kMinSplitPages
         : width <= kTargetSplits * kMaxSplitPages ? kTargetSplits
         : (width + kMaxSplitPages - 1) / kMaxSplitPages;
}

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 5;  // depth of the cp.async ring
constexpr int kVec = 8;     // consecutive elements of a head row per lane

// How a CTA lays out head dim D: kLanes lanes per token, kGroups token groups,
// each folding kTokPerGroup tokens of every kStageTok-token stage.
template <int D>
struct Fold {
  static constexpr int kLanes = D / kVec;
  static constexpr int kGroups = kThreads / kLanes;
  static constexpr int kTokPerGroup = 2;
  static constexpr int kStageTok = kGroups * kTokPerGroup;
};

// ---------------------------------------------------------------------------
// cp.async (sm_80+): a copy into shared memory that the thread does not wait
// on; src-size 0 fills the destination with zeros and reads nothing.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The split merge's ticket: an atomic add at GPU scope that releases the
// CTA's partial (written before the barrier that precedes it, which the
// release covers) and acquires the partials of the splits that took their
// tickets before it.
__device__ __forceinline__ int ticket(int* counter) {
  int t;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(t)
               : "l"(counter)
               : "memory");
  return t;
}

// Transposed sum over an aligned group of lanes: each lane brings Cnt
// values, and each level of the butterfly (offset Off, halving while more than
// one value is left) sends half of them to the partner lane and adds the half
// it keeps, so one shuffle per value moves where a sum per value would take
// log2(lanes). The lane at position gl of an L-lane group ends with the sums
// of values gl * Cnt / L + j, j < max(1, Cnt / L), in v[j]; a value two lanes
// hold (Cnt < L) is added in both as a + b = b + a, so their copies are equal.
template <int Cnt, int Off, int N>
__device__ __forceinline__ void transpose_sum(float (&v)[N], int gl) {
  if constexpr (Off > 0) {
    if constexpr (Cnt > 1) {
      constexpr int kHalf = Cnt / 2;
      const bool hi = (gl & Off) != 0;
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        const float keep = hi ? v[kHalf + j] : v[j];
        const float send = hi ? v[j] : v[kHalf + j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, Off);
      }
      transpose_sum<kHalf, Off / 2>(v, gl);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], Off);
      transpose_sum<1, Off / 2>(v, gl);
    }
  }
}

// ---------------------------------------------------------------------------
// The KV loader: the K and V arrays (side 0 and 1) whose (token, KV head)
// rows the ring gathers, and how kVec elements of a row are widened to f32
// from the ring.
// ---------------------------------------------------------------------------

template <typename C>
struct FloatKV {
  using Elem = C;
  const C* k;
  const C* v;

  __device__ __forceinline__ const C* data(int side) const { return side ? v : k; }
  bool aligned() const {
    return (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  }
};

__device__ __forceinline__ void widen(const float* p, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void widen(const __nv_bfloat16* p, float (&x)[kVec]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // element 2i in the low half (bf16 -> f32 is exact)
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

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

// Shared memory of one CTA: the ring, which the in-CTA merge reuses.
template <int D, int G, typename KV>
struct Smem {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(typename KV::Elem));
  static constexpr int kSideBytes = Fold<D>::kStageTok * kRowBytes;
  static constexpr int kStageBytes = 2 * kSideBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kMergeBytes = (Fold<D>::kGroups * G * (D + 2) + 2 * G) * 4;
  static constexpr int kBytes = kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
};

// ---------------------------------------------------------------------------
// The end of a work item, which every fold shares.
// ---------------------------------------------------------------------------

// Merges `count` partials of one (row, KV head), the scratch slots 0,
// kStride, 2 x kStride, ... from `accs` (acc [G][D] a slot) and `mls` ((m, l)
// [G] a slot), in that order, and hands each output's merged state to
// emit(g, d, m, l, acc). Its global reads go out together: each thread
// prefetches its outputs' partial acc of the first kPre slots, and the
// slots' (m, l) stage in shared memory, kMergeSplits at a time, in one pass
// of all threads. Then each head's max (G threads), the weights (one expf per
// (slot, head)), the denominators (G threads) and the outputs. The caller
// has synchronised the CTA after its last use of `smem`.
template <int D, int G, int kStride, typename Emit>
__device__ __forceinline__ void merge_partials(const float* accs, const float* mls, int count,
                                               unsigned char* smem, const Emit& emit) {
  constexpr int kMergeSplits = 512 / G;
  constexpr int kOuts = (G * D + kThreads - 1) / kThreads;
  constexpr int kPre = 8;
  const int tid = threadIdx.x;
  constexpr int64_t acc_step = static_cast<int64_t>(kStride) * G * D;
  float pre[kOuts][kPre];
#pragma unroll
  for (int k = 0; k < kOuts; ++k) {
#pragma unroll
    for (int sp = 0; sp < kPre; ++sp) {
      const int idx = tid + k * kThreads;
      pre[k][sp] = idx < G * D && sp < count ? __ldcg(accs + sp * acc_step + idx) : 0.f;
    }
  }
  float* head = reinterpret_cast<float*>(smem);  // [G] maxima, then [G] denominators
  float* sm_mw = head + 2 * G;                   // [kMergeSplits][G] m, then the weights
  float* sm_l = sm_mw + kMergeSplits * G;        // [kMergeSplits][G] l
  auto stage_ml = [&](int sp0, int cn) {
    for (int t = tid; t < cn * G; t += kThreads) {
      const int slot = kStride == 1 ? sp0 * G + t : (sp0 + t / G) * kStride * G + t % G;
      const float2 v = __ldcg(reinterpret_cast<const float2*>(mls) + slot);
      sm_mw[t] = v.x;
      sm_l[t] = v.y;
    }
  };
  float run = its::kNegInf;  // tid < G: head tid's max so far
  for (int sp0 = 0; sp0 < count; sp0 += kMergeSplits) {
    const int cn = min(kMergeSplits, count - sp0);
    __syncthreads();  // the last chunk is read
    stage_ml(sp0, cn);
    __syncthreads();
    if (tid < G)
      for (int sp = 0; sp < cn; ++sp) run = fmaxf(run, sm_mw[sp * G + tid]);
  }
  if (tid < G) {
    head[tid] = run;
    head[G + tid] = 0.f;
  }
  float aa[kOuts];
#pragma unroll
  for (int k = 0; k < kOuts; ++k) aa[k] = 0.f;
  for (int sp0 = 0; sp0 < count; sp0 += kMergeSplits) {
    const int cn = min(kMergeSplits, count - sp0);
    if (count > kMergeSplits) {  // one chunk is still staged from the maxima's pass
      __syncthreads();
      stage_ml(sp0, cn);
    }
    __syncthreads();  // the maxima and the chunk are in
    for (int t = tid; t < cn * G; t += kThreads) sm_mw[t] = expf(sm_mw[t] - head[t % G]);
    __syncthreads();
    if (tid < G) {
      float ll = head[G + tid];
      for (int sp = 0; sp < cn; ++sp) ll = fmaf(sm_l[sp * G + tid], sm_mw[sp * G + tid], ll);
      head[G + tid] = ll;
    }
#pragma unroll
    for (int k = 0; k < kOuts; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < G * D) {
        const int g = idx / D;
        int sp = 0;
        if (sp0 == 0) {
#pragma unroll
          for (int j = 0; j < kPre; ++j)
            if (j < cn) aa[k] = fmaf(pre[k][j], sm_mw[j * G + g], aa[k]);
          sp = min(kPre, cn);
        }
        for (; sp < cn; ++sp)
          aa[k] = fmaf(__ldcg(accs + (sp0 + sp) * acc_step + idx), sm_mw[sp * G + g], aa[k]);
      }
    }
  }
  __syncthreads();  // the denominators are in
#pragma unroll
  for (int k = 0; k < kOuts; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < G * D) {
      const int g = idx / D;
      emit(g, idx % D, head[g], head[G + g], aa[k]);
    }
  }
}

// The end of work item (row, kvh, split) of a row of `nsplit` splits, in a
// launch whose grid has `splits` a (row, KV head). The CTA's kGroups token
// groups have left their states in shared memory (sm_ml [kGroups][G][m, l],
// then sm_acc [kGroups][G][D]). Merges them in group order (each head's max
// and the groups' weights once, by G threads, then every output); then a row
// of one split applies the epilogue, and a row of several writes the split's
// partial to its scratch slot and takes a ticket. The last CTA to arrive
// merges: all the row's splits up to kMergeGroup of them, else its group of
// kMergeGroup splits, into the group's first slot, and then, if it is also
// the last group to arrive, the groups. The (row, KV head)'s ticket counters
// are tickets[item * splits + i]: i = 0 for a row of one group; a group's
// own index, and ngroups for the groups' merge, in a tree (ngroups + 1 <=
// splits). Each counter is reset by the CTA that merges on it.
constexpr int kMergeGroup = 16;

template <int D, int G, int kGroups, typename Epi>
__device__ __forceinline__ void finish_split(unsigned char* smem, const Epi& epi,
                                             float* __restrict__ scratch,
                                             int* __restrict__ tickets, int row, int kvh,
                                             int split, int nsplit, int H, int KVH, int splits) {
  __shared__ int sm_ticket;
  const int tid = threadIdx.x;
  float* sm_ml = reinterpret_cast<float*>(smem);  // m becomes the weight
  float* sm_acc = sm_ml + kGroups * G * 2;
  float* sm_head = sm_acc + kGroups * G * D;      // [G][m, l], merged
  if (tid < G) {
    float mm = its::kNegInf;
#pragma unroll
    for (int w = 0; w < kGroups; ++w) mm = fmaxf(mm, sm_ml[(w * G + tid) * 2]);
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < kGroups; ++w) {
      const float c = expf(sm_ml[(w * G + tid) * 2] - mm);
      sm_ml[(w * G + tid) * 2] = c;
      ll = fmaf(sm_ml[(w * G + tid) * 2 + 1], c, ll);
    }
    sm_head[tid * 2] = mm;
    sm_head[tid * 2 + 1] = ll;
  }
  __syncthreads();

  const int64_t item = static_cast<int64_t>(row) * KVH + kvh;
  const int64_t acc_floats = static_cast<int64_t>(gridDim.y) * KVH * splits * G * D;
  float* accs = scratch + item * splits * G * D;          // the item's slots: acc [G][D]
  float* mls = scratch + acc_floats + item * splits * G * 2;  // and (m, l) [G]
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    const float mm = sm_head[g * 2];
    const float ll = sm_head[g * 2 + 1];
    float aa = 0.f;
#pragma unroll
    for (int w = 0; w < kGroups; ++w)
      aa = fmaf(sm_acc[(w * G + g) * D + d], sm_ml[(w * G + g) * 2], aa);
    if (nsplit == 1) {
      epi(static_cast<int64_t>(row) * H + kvh * G + g, d, D, mm, ll, aa);
    } else {
      accs[split * G * D + idx] = aa;
      if (d == 0) {
        mls[(split * G + g) * 2] = mm;
        mls[(split * G + g) * 2 + 1] = ll;
      }
    }
  }
  if (nsplit == 1) return;
#ifdef ITS_DECODE_NOMERGE
  return;  // a timing build (cuda/decode_probe.py): the fold alone, outputs left unset
#endif

  auto to_epilogue = [&](int g, int d, float mm, float ll, float aa) {
    epi(static_cast<int64_t>(row) * H + kvh * G + g, d, D, mm, ll, aa);
  };
  int* tix = tickets + item * splits;
  __syncthreads();  // the CTA's partial is written; thread 0 releases it
  if (nsplit <= kMergeGroup) {  // the last split merges them all, in split order
    if (tid == 0) sm_ticket = ticket(tix);
    __syncthreads();
    if (sm_ticket != nsplit - 1) return;
    merge_partials<D, G, 1>(accs, mls, nsplit, smem, to_epilogue);
    if (tid == 0) tix[0] = 0;  // ready for the next launch on this stream
    return;
  }
  // The tree: the last split of a group merges the group into its first slot.
  const int group = split / kMergeGroup;
  const int ngroups = (nsplit + kMergeGroup - 1) / kMergeGroup;
  const int first = group * kMergeGroup;
  const int count = min(kMergeGroup, nsplit - first);
  if (tid == 0) sm_ticket = ticket(tix + group);
  __syncthreads();
  if (sm_ticket != count - 1) return;
  float* gacc = accs + first * G * D;
  float* gml = mls + first * G * 2;
  merge_partials<D, G, 1>(gacc, gml, count, smem, [&](int g, int d, float mm, float ll,
                                                        float aa) {
    gacc[g * D + d] = aa;  // this thread's own reads of the slot are done
    if (d == 0) {
      gml[g * 2] = mm;
      gml[g * 2 + 1] = ll;
    }
  });
  if (tid == 0) tix[group] = 0;
  __syncthreads();  // the group's state is written; thread 0 releases it
  if (tid == 0) sm_ticket = ticket(tix + ngroups);
  __syncthreads();
  if (sm_ticket != ngroups - 1) return;
  merge_partials<D, G, kMergeGroup>(accs, mls, ngroups, smem, to_epilogue);
  if (tid == 0) tix[ngroups] = 0;
}

// ---------------------------------------------------------------------------
// One work item: split `split` of query row `row` (KV group `kvh`) over
// page_list[0 .. ceil(seq_len / bt)).
// ---------------------------------------------------------------------------

template <typename T, int D, int G, typename KV, typename Epi>
__device__ __forceinline__ void attend_split(const T* __restrict__ q, const KV& kv,
                                             const int32_t* __restrict__ page_list,
                                             int seq_len, const Epi& epi,
                                             float* __restrict__ scratch,
                                             int* __restrict__ tickets, int row, int kvh,
                                             int split, int H, int KVH, int bt, int num_blocks,
                                             int splits, float scale) {
  using F = Fold<D>;
  using S = Smem<D, G, KV>;
  using E = typename KV::Elem;
  constexpr int kChunks = S::kRowBytes / 16;  // 16-byte chunks of a head row
  constexpr int kCopies = 2 * F::kStageTok * kChunks / kThreads;
  static_assert(2 * F::kStageTok * kChunks % kThreads == 0, "a stage splits evenly");

  const int npages = (seq_len + bt - 1) / bt;
  const int spp = split_pages(npages);
  const int nsplit = max(1, (npages + spp - 1) / spp);
  if (split >= nsplit) return;  // the same for every thread of the CTA

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t sm_base[kMaxSplitPages];  // element offset of (page, token 0, kvh), or -1
  __shared__ bool sm_ok[kStages][F::kStageTok];  // a ring row holds a valid token

  const int tid = threadIdx.x;
  const int page0 = split * spp;
  if (tid < spp) {
    const int j = page0 + tid;
    const int page = j < npages ? page_list[j] : -1;
    sm_base[tid] = (page >= 0 && page < num_blocks)
        ? (static_cast<int64_t>(page) * bt * KVH + kvh) * D : -1;
  }
  const int ntok = min(seq_len - page0 * bt, spp * bt);
  const int nstages = (ntok + F::kStageTok - 1) / F::kStageTok;
  const int row_stride = KVH * D;  // elements from one token's row to the next

  // The producer's copies: copy k of this thread moves 16-byte chunk col_k
  // of ring row r_k, whose token st * kStageTok + r_k sits at offset po[k] of
  // the split's page pi[k]. Stages are issued in order, so the position
  // advances by kStageTok tokens a stage, without a division.
  int pi[kCopies], po[kCopies];
#pragma unroll
  for (int k = 0; k < kCopies; ++k) {
    const int r = ((tid + k * kThreads) / kChunks) % F::kStageTok;
    pi[k] = r / bt;
    po[k] = r % bt;
  }
  __syncthreads();

  // Queue the copies of stage `st` (split-relative tokens st * kStageTok ...)
  // into its ring slot; rows past the split or on a skipped page read as 0.
  auto issue = [&](int st) {
    unsigned char* slot = smem + (st % kStages) * S::kStageBytes;
    const int tok0 = st * F::kStageTok;
#pragma unroll
    for (int k = 0; k < kCopies; ++k) {
      const int c = tid + k * kThreads;
      const int side = c / (F::kStageTok * kChunks);
      const int r = (c / kChunks) % F::kStageTok;
      const int64_t base = tok0 + r < ntok ? sm_base[pi[k]] : -1;
      const int64_t at = base + static_cast<int64_t>(po[k]) * row_stride;
      const int col = c % kChunks;
      const E* src = base >= 0 ? kv.data(side) + at + col * (16 / static_cast<int>(sizeof(E)))
                               : kv.data(side);
      cp_async16(slot + side * S::kSideBytes + r * S::kRowBytes + col * 16, src, base >= 0);
      if (side == 0 && col == 0) sm_ok[st % kStages][r] = base >= 0;
      po[k] += F::kStageTok;
      while (po[k] >= bt) {
        po[k] -= bt;
        ++pi[k];
      }
    }
  };

  const int grp = tid / F::kLanes;  // token group (aligned lanes of one warp)
  const int gl = tid % F::kLanes;   // lane in the group: elements gl*8 .. gl*8+7
  const int lane0 = (tid & 31) - gl;  // the group's first lane in the warp

  // The group's kNV scores of a stage, score u * G + g for token u and query
  // head g, are shared out by transpose_sum: this lane holds scores idx0 + j,
  // j < kHeld, of token u_own, and keeps the running max and denominator of
  // their heads (the lane with the other token keeps equal copies).
  constexpr int kNV = F::kTokPerGroup * G;
  constexpr int kHeld = kNV > F::kLanes ? kNV / F::kLanes : 1;
  static_assert(F::kTokPerGroup == 2, "a score's other token is on lane gl ^ kLanes / 2");
  const int idx0 = gl * kNV / F::kLanes;
  const int u_own = idx0 / G;
  // The lane that holds score idx (the first, where two hold it).
  auto holder = [](int idx) { return kNV > F::kLanes ? idx / kHeld : idx * F::kLanes / kNV; };

  float qr[G][kVec], acc[G][kVec], m_own[kHeld], l_own[kHeld];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qrow = q + (static_cast<int64_t>(row) * H + kvh * G + g) * D + gl * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      qr[g][e] = its::to_f32(qrow[e]);
      acc[g][e] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    m_own[j] = its::kNegInf;
    l_own[j] = 0.f;
  }
#ifdef ITS_DECODE_PROLOGUE
  // A timing build (cuda/decode_probe.py k7): the prologue alone (the row's
  // metadata, its page ids, q), its loads kept live, outputs left unset.
  asm volatile("" ::"l"(sm_base[tid % kMaxSplitPages]));
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kVec; ++e) asm volatile("" ::"f"(qr[g][e]));
  return;
#endif

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nstages) issue(st);
    cp_async_commit();
  }
  for (int st = 0; st < nstages; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st landed for every thread; stage st-1's slot is free
    if (st + kStages - 1 < nstages) issue(st + kStages - 1);
    cp_async_commit();

    const unsigned char* slot = smem + (st % kStages) * S::kStageBytes;
    const E* ks = reinterpret_cast<const E*>(slot);
    const E* vs = reinterpret_cast<const E*>(slot + S::kSideBytes);
    float x[F::kTokPerGroup][kVec];
    float sv[kNV];  // this lane's partial dot products, then its held sums
    bool ok[F::kTokPerGroup];
#pragma unroll
    for (int u = 0; u < F::kTokPerGroup; ++u) {
      const int r = grp + F::kGroups * u;
      ok[u] = sm_ok[st % kStages][r];
      widen(ks + r * D + gl * kVec, x[u]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) part = fmaf(qr[g][e], x[u][e], part);
        sv[u * G + g] = part;
      }
    }
    transpose_sum<kNV, F::kLanes / 2>(sv, gl);
#pragma unroll
    for (int u = 0; u < F::kTokPerGroup; ++u) {
      const int r = grp + F::kGroups * u;
      widen(vs + r * D + gl * kVec, x[u]);
    }
    // The online softmax of the held heads: both tokens' scores, in token
    // order, from this lane and its partner.
    float p_own[kHeld], c_own[kHeld];
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      const float mine = __fmul_rn(sv[j], scale);
      const float other = __shfl_xor_sync(0xffffffffu, mine, F::kLanes / 2);
      const float s0 = u_own ? other : mine;
      const float s1 = u_own ? mine : other;
      const float m_new = fmaxf(m_own[j], fmaxf(ok[0] ? s0 : its::kNegInf,
                                                ok[1] ? s1 : its::kNegInf));
      p_own[j] = (u_own ? ok[1] : ok[0]) ? expf(mine - m_new) : 0.f;
      const float p_other = __shfl_xor_sync(0xffffffffu, p_own[j], F::kLanes / 2);
      const float psum = u_own ? p_other + p_own[j] : p_own[j] + p_other;
      c_own[j] = expf(m_own[j] - m_new);
      l_own[j] = fmaf(l_own[j], c_own[j], psum);
      m_own[j] = m_new;
    }
    // Every lane folds V for every head: it gathers the probabilities and
    // corrections from their holders.
    float p[kNV], corr[G];
#pragma unroll
    for (int idx = 0; idx < kNV; ++idx)
      p[idx] = __shfl_sync(0xffffffffu, p_own[idx % kHeld], lane0 + holder(idx));
#pragma unroll
    for (int g = 0; g < G; ++g)
      corr[g] = __shfl_sync(0xffffffffu, c_own[g % kHeld], lane0 + holder(g));
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float pv[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) pv[e] = fmaf(p[g], x[0][e], 0.f);
#pragma unroll
      for (int u = 1; u < F::kTokPerGroup; ++u) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) pv[e] = fmaf(p[u * G + g], x[u][e], pv[e]);
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][e] = fmaf(acc[g][e], corr[g], pv[e]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: its memory now holds the merge

  // The token groups' states, for finish_split.
  float* sm_ml = reinterpret_cast<float*>(smem);  // [kGroups][G][m, l]
  float* sm_acc = sm_ml + F::kGroups * G * 2;     // [kGroups][G][D]
  if (u_own == 0 && gl == holder(idx0)) {  // idx0 + j is head idx0 + j's (m, l)
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

// Rows of a batched block table (K3, K5): grid (splits x KVH, B). Row b
// attends over tables[b, :], its seq_len clamped to the table's max_blocks * bt.
// Registers cap the CTAs an SM holds: 3 up to G = 4, 2 at G = 8 (128 floats
// of q and acc a thread).
template <typename T, int D, int G, typename KV, typename Epi>
__global__ void __launch_bounds__(kThreads, (G <= 4 ? 3 : 2))
paged_decode(const T* __restrict__ q, KV kv, const int32_t* __restrict__ tables,
             const int32_t* __restrict__ seq_lens, Epi epi, float* __restrict__ scratch,
             int* __restrict__ tickets, int H, int KVH, int bt, int num_blocks, int max_blocks,
             int splits, float scale) {
  const int b = blockIdx.y;
  const int seq_len = max(0, min(seq_lens[b], max_blocks * bt));
  attend_split<T, D, G>(q, kv, tables + static_cast<int64_t>(b) * max_blocks, seq_len, epi,
                        scratch, tickets, b, blockIdx.x / splits, blockIdx.x % splits, H, KVH,
                        bt, num_blocks, splits, scale);
}

// Rows of a ragged wave (K6, K7): grid (splits x KVH, R). Row r's pages are
// pages[page_starts[r] + j], clamped to the pages the row owns in the flat
// list (up to the next row's start, or P for the last row) and to the
// launch's table width.
template <typename T, int D, int G, typename KV, typename Epi>
__global__ void __launch_bounds__(kThreads, (G <= 4 ? 3 : 2))
paged_decode_ragged(const T* __restrict__ q, KV kv, const int32_t* __restrict__ pages,
                    const int32_t* __restrict__ page_starts,
                    const int32_t* __restrict__ seq_lens, Epi epi, float* __restrict__ scratch,
                    int* __restrict__ tickets, int H, int KVH, int bt, int num_blocks, int P,
                    int width, int splits, float scale) {
  const int r = blockIdx.y;
  const int R = gridDim.y;
  const int start = min(max(page_starts[r], 0), P);
  const int end = (r + 1 < R) ? min(max(page_starts[r + 1], start), P) : P;
  const int seq_len = max(0, min(seq_lens[r], min(end - start, width) * bt));
  attend_split<T, D, G>(q, kv, pages + start, seq_len, epi, scratch, tickets, r,
                        blockIdx.x / splits, blockIdx.x % splits, H, KVH, bt, num_blocks,
                        splits, scale);
}

// ---------------------------------------------------------------------------
// Launch and dispatch over (query dtype, head_dim, group size).
// ---------------------------------------------------------------------------

// The launch shape every decode kernel shares. `width` bounds a row's pages
// (max_blocks for a table; the table width, at most P, for a ragged wave),
// `splits` = grid_splits(width) as the wrapper sized its scratch, `P`
// the length of a ragged page list.
struct Shape {
  int rows, H, KVH, bt, num_blocks, width, P, splits;
  cudaStream_t stream;
};

// Launches a decode kernel (K3, K5-K8) over (splits x KVH, rows) CTAs of
// kThreads threads and `smem` bytes of dynamic shared memory.
template <typename... Params, typename... Args>
int launch_split_kernel(void (*kernel)(Params...), int smem, const Shape& s, Args... args) {
  if (smem > 40 * 1024) {  // beside the static shared memory
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(s.splits * s.KVH, s.rows), kThreads, smem, s.stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The split scratch of a launch: per (row, KV head, split, query head) an f32
// partial acc [D], then all the (m, l) pairs: rows * splits * H * (D + 2)
// floats. `tickets`: rows * KVH * splits int32 zeros, left zero by every
// launch.
template <typename T, int D, int G, bool kRagged, typename KV, typename Epi>
int launch(const T* q, const KV& kv, const int32_t* index, const int32_t* starts,
           const int32_t* seq_lens, const Epi& epi, float* scratch, int* tickets,
           const Shape& s) {
  if (!kv.aligned()) return static_cast<int>(cudaErrorMisalignedAddress);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  constexpr int smem = Smem<D, G, KV>::kBytes;
  if constexpr (kRagged) {
    return launch_split_kernel(paged_decode_ragged<T, D, G, KV, Epi>, smem, s, q, kv, index,
                               starts, seq_lens, epi, scratch, tickets, s.H, s.KVH, s.bt,
                               s.num_blocks, s.P, s.width, s.splits, scale);
  } else {
    return launch_split_kernel(paged_decode<T, D, G, KV, Epi>, smem, s, q, kv, index, seq_lens,
                               epi, scratch, tickets, s.H, s.KVH, s.bt, s.num_blocks, s.width,
                               s.splits, scale);
  }
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

// Validates the shape (the scratch's split count included), then calls
// f(Config<T, D, G>{}) for the kernels' instantiation; 0 without a launch
// when there are no rows.
template <typename F>
int dispatch(int dtype, int D, const Shape& s, F f) {
  if (s.rows <= 0) return 0;
  if (s.KVH <= 0 || s.H % s.KVH != 0 || s.bt <= 0 || s.width <= 0 || s.rows > 65535 ||
      s.splits != grid_splits(s.width) ||
      static_cast<int64_t>(s.splits) * s.KVH > 0x7fffffff)
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
