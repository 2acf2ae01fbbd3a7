// K8: batched paged decode attention over an int8 KV cache.
//
// Replaces infinistore_tpu/tpu/kv_quant.py:_quant_decode_pallas (body
// _quant_decode_kernel, through _attn_block_update):
//   q [B, H, D] f32 or bf16, k/v data [N, bt, KVH, D] int8, k/v scales
//   [N, bt, KVH] f32 (one per (token, KV head), from quantize_kv),
//   tables [B, max_blocks] int32, seq_lens [B] int32 -> out [B, H, D] in
//   q's dtype.
// Each value is dequantised on load as data * scale in one f32 multiply,
// exactly dequantize_kv's data.float() * scales[..., None], and then folded
// as K3 folds a float cache: K8 is bitwise K3 run on q.float() over the
// f32-dequantised caches, cast to q's dtype.
//
// Bound: bytes. The function reads one int8 byte per K and V element plus one
// f32 scale per (token, KV head): at B=4, 2048 tokens, 8 KV heads x 128 that
// is 16 MiB of data and 0.5 MiB of scales per layer per step, about 5.2 us at
// 3.35 TB/s, half of K3's bf16 read.
//
// Design: the fold of decode_fold.cuh (grid (KVH, B), as K3) with the int8
// loader: each lane reads its bytes of a (token, head) row, lane + 32 e as K3
// reads its elements, and the row's one scale once (the same address across
// the warp, a broadcast), and widens in registers. Left on the table: a byte
// load moves 32 bytes a warp; wider loads would give each lane other
// elements, so the warp sums would add in another order and K8 would no
// longer be bitwise K3 unless K3 changed with it. That, and the K3 work (a
// split over the sequence, prefetch of the next page), are the next steps.

#include "decode_fold.cuh"

extern "C" int its_paged_decode_attention_quantized(
    const void* q, const int8_t* k_data, const float* k_scales, const int8_t* v_data,
    const float* v_scales, const int32_t* tables, const int32_t* seq_lens, void* out,
    int dtype, int B, int H, int KVH, int D, int bt, int num_blocks, int max_blocks,
    void* stream) {
  const Shape s{B, H, KVH, bt, num_blocks, max_blocks, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, s, [&](auto c) {
    using T = typename decltype(c)::T;
    return launch<T, decltype(c)::D, decltype(c)::G, false>(
        static_cast<const T*>(q), Int8KV{k_data, k_scales, v_data, v_scales}, tables, nullptr,
        seq_lens, Normalize<T>{static_cast<T*>(out)}, s);
  });
}
