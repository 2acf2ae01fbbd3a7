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
// Design: the fold of decode_fold.cuh (one CTA per (KV head, row), 8 warps
// over the row's pages, a shared-memory merge) with the float loader and the
// normalising epilogue. K3 and K6 run the same fold, so a K6 row is bitwise
// the K3 row over the same pages, and a row never depends on the other rows
// of its wave: the TPU kernel's sequential grid, which resets scratch on a
// row change, has no counterpart here because every row is its own CTA.
// Left on the table: B x KVH CTAs (32 on the decode path) occupy a quarter
// of the 132 SMs; splitting the sequence across CTAs with a second combine
// pass (flash-decoding), and cp.async/TMA prefetch of the next block, are the
// obvious next steps.

#include "decode_fold.cuh"

extern "C" int its_paged_decode_attention(const void* q, const void* k_cache,
                                          const void* v_cache, const int32_t* tables,
                                          const int32_t* seq_lens, void* out, int dtype,
                                          int B, int H, int KVH, int D, int bt,
                                          int num_blocks, int max_blocks, void* stream) {
  const Shape s{B, H, KVH, bt, num_blocks, max_blocks, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, s, [&](auto c) {
    using T = typename decltype(c)::T;
    return launch<T, decltype(c)::D, decltype(c)::G, false>(
        static_cast<const T*>(q),
        FloatKV<T>{static_cast<const T*>(k_cache), static_cast<const T*>(v_cache)}, tables,
        nullptr, seq_lens, Normalize<T>{static_cast<T*>(out)}, s);
  });
}

extern "C" int its_paged_decode_attention_ragged(const void* q, const void* k_cache,
                                                 const void* v_cache, const int32_t* pages,
                                                 const int32_t* page_starts,
                                                 const int32_t* seq_lens, void* out, int dtype,
                                                 int R, int H, int KVH, int D, int bt,
                                                 int num_blocks, int P, void* stream) {
  const Shape s{R, H, KVH, bt, num_blocks, P, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, s, [&](auto c) {
    using T = typename decltype(c)::T;
    return launch<T, decltype(c)::D, decltype(c)::G, true>(
        static_cast<const T*>(q),
        FloatKV<T>{static_cast<const T*>(k_cache), static_cast<const T*>(v_cache)}, pages,
        page_starts, seq_lens, Normalize<T>{static_cast<T*>(out)}, s);
  });
}
