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
// Design: the split-KV fold of decode_fold.cuh with the int8 loader. It
// inherits K3's design whole: the split over the sequence, the cp.async ring
// (a stage's int8 rows in 16-byte copies, its rows' f32 scales in 4-byte
// ones), and the in-order merge of the splits. Each lane widens the same 8
// elements K3's lane reads (one 8-byte read from the ring), in the same
// order, so the products and sums are K3's over the dequantised values.
// Left on the table: a stage holds as many tokens as K3's (the mapping must
// match K3's for the bitwise contract), so it moves half K3's bytes per
// stage; deeper stages for int8 alone would change the fold's order.

#include "decode_fold.cuh"

extern "C" int its_paged_decode_attention_quantized(
    const void* q, const int8_t* k_data, const float* k_scales, const int8_t* v_data,
    const float* v_scales, const int32_t* tables, const int32_t* seq_lens, void* out,
    float* scratch, int* tickets, int dtype, int B, int H, int KVH, int D, int bt,
    int num_blocks, int max_blocks, int splits, void* stream) {
  const Shape s{B, H, KVH, bt, num_blocks, max_blocks, 0, splits,
                static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, s, [&](auto c) {
    using T = typename decltype(c)::T;
    return launch<T, decltype(c)::D, decltype(c)::G, false>(
        static_cast<const T*>(q), Int8KV{k_data, k_scales, v_data, v_scales}, tables, nullptr,
        seq_lens, Normalize<T>{static_cast<T*>(out)}, scratch, tickets, s);
  });
}
