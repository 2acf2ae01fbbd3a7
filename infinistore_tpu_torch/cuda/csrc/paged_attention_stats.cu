// K5: paged decode attention's raw statistics, and K7: their ragged form,
// the shard-local halves of sharded decode (K7's entry is in
// paged_attention_ragged_stats.cu).
//
// K5 replaces infinistore_tpu/tpu/paged_attention.py:
// _paged_decode_attention_pallas_stats (body _decode_attn_stats_kernel):
//   q [B, H, D], k/v cache [N, bt, KVH, D], tables [B, max_blocks] int32,
//   seq_lens [B] int32 -> acc [B, H, D], m [B, H, 1], l [B, H, 1], all f32.
// K7 replaces _paged_decode_attention_pallas_ragged_stats (body
// _ragged_decode_attn_stats_kernel), with K6's flat page list:
//   q [R, H, D], pages [P], page_starts [R], seq_lens [R] (int32)
//   -> acc [R, H, D], m [R, H, 1], l [R, H, 1], all f32.
// acc is the unnormalised numerator, m the running max of the scaled logits,
// l the softmax denominator relative to m. An empty row gives acc 0, l 0 and
// m -1e30 (the JAX package's _NEG_INF), so its combine weight is zero.
//
// Bound: bytes, as K3/K6: every valid token's K and V read once. On the
// sharded decode path (one request, 32,768 tokens of context, 8 KV heads x
// 128 x bf16) that is 128 MiB, about 40 us at 3.35 TB/s.
//
// Design: the split-KV fold of decode_fold.cuh with the raw-statistics
// epilogue, which runs once per row after the split merge, so a row's
// (acc, m, l) are exactly the state K3/K6 normalise: acc / max(l, 1e-30) of a
// K5 (K7) row is bitwise the K3 (K6) row, which is what makes the one-shard
// combine bitwise the unsharded kernel. It inherits K3's design whole: the
// split over the sequence (the 32,768-token request is 8 KV heads x 128
// splits = 1,024 CTAs, where it was 8), 16-byte cp.async loads through the
// ring, and the in-order merge of the splits. The cross-shard combine (one
// max and two sums, on torch.distributed) runs outside the kernel.
// A row of more than 16 splits (the 32,768-token request) merges in
// finish_split's two-level tree: the last CTA of each group of 16 splits
// merges its group while other groups still fold, and the last group merges
// the 8 groups, where one CTA a KV head used to read all 128 partials.
// Left on the table: the fold itself (cuda/decode_probe.py k5 times it
// without the merge); each CTA reads one KV head's 256 B of every 2 KiB token
// row, and with its pages in L2 the fold took a quarter less (PERF.md).

#include "decode_fold.cuh"

extern "C" int its_paged_decode_attention_stats(
    const void* q, const void* k_cache, const void* v_cache, const int32_t* tables,
    const int32_t* seq_lens, float* acc, float* m, float* l, float* scratch, int* tickets,
    int dtype, int B, int H, int KVH, int D, int bt, int num_blocks, int max_blocks, int splits,
    void* stream) {
  const Shape s{B, H, KVH, bt, num_blocks, max_blocks, 0, splits,
                static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, s, [&](auto c) {
    using T = typename decltype(c)::T;
    return launch<T, decltype(c)::D, decltype(c)::G, false>(
        static_cast<const T*>(q),
        FloatKV<T>{static_cast<const T*>(k_cache), static_cast<const T*>(v_cache)}, tables,
        nullptr, seq_lens, RawStats{acc, m, l}, scratch, tickets, s);
  });
}
