// K3: batched paged decode attention, and K6: its ragged form (K6's entry
// is in paged_attention_ragged.cu).
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
//   flat list (up to the next row's start, or P for the last row) and to the
//   wave's table width.
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
// Design: the split-KV fold of decode_fold.cuh with the float loader and the
// normalising epilogue; its head note says what it does about each limit of
// the fold it replaced. Against those limits at this kernel's shapes:
//   1. CTAs: the round trip's decode step (4 rows of 2,048 tokens, 8 KV
//      heads) is 4 x 8 x 8 = 256 CTAs of 16 pages each, where it was 32 CTAs
//      of 128 pages; the kernel phase's skewed wave folds its 1,152-token
//      row in 8 CTAs of 9 pages a KV head, where one CTA walked 72.
//   2. Loads and sums: one 16-byte cp.async per lane and copy in bf16 (a
//      warp moves 512 bytes, where it moved 64); a token group's 8 scores of
//      a stage (2 tokens x 4 heads) are summed by a transposed butterfly in
//      8 shuffles, where a 5-level warp sum took 5 a score, and each lane
//      runs the softmax of the score it holds instead of all of them.
//   3. Prefetch: a 5-stage ring of 16-token stages (8 KiB of K and V in bf16
//      at D = 128) keeps four stages in flight while one folds.
//   4. Shared memory: dynamic; the in-CTA merge reuses the drained ring.
// K3 and K6 run the same fold, and a row's splits depend only on its own
// seq_len, so a K6 row is bitwise the K3 row over the same pages and never
// depends on the other rows of its wave. Both take the wrapper's f32 split
// scratch and its per-stream ticket counters (`scratch`, `tickets`, `splits`,
// see decode_fold.cuh: launch).
// Left on the table: the rows of a verification chunk (K6) or of
// prefill_continue (K3) share their pages, but each row reads them through
// L2 and folds them on its own, with f32 FMAs on the CUDA cores, a
// fifteenth of the tensor cores' bf16 rate: the explicit-fmaf contract that
// keeps K8 bitwise K3 costs that rate at those shapes.

#include "decode_fold.cuh"

// The grid's split dimension for a table `width` pages wide: the wrappers
// size the split scratch of every decode kernel by it.
extern "C" int its_decode_splits(int width) { return grid_splits(width); }

extern "C" int its_paged_decode_attention(const void* q, const void* k_cache,
                                          const void* v_cache, const int32_t* tables,
                                          const int32_t* seq_lens, void* out, float* scratch,
                                          int* tickets, int dtype, int B, int H, int KVH,
                                          int D, int bt, int num_blocks, int max_blocks,
                                          int splits, void* stream) {
  const Shape s{B, H, KVH, bt, num_blocks, max_blocks, 0, splits,
                static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, s, [&](auto c) {
    using T = typename decltype(c)::T;
    return launch<T, decltype(c)::D, decltype(c)::G, false>(
        static_cast<const T*>(q),
        FloatKV<T>{static_cast<const T*>(k_cache), static_cast<const T*>(v_cache)}, tables,
        nullptr, seq_lens, Normalize<T>{static_cast<T*>(out)}, scratch, tickets, s);
  });
}
