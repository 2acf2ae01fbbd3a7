// K6's entry: the ragged paged decode attention of paged_attention.cu's head
// note (what it replaces, its bound and its design are there). Its own
// translation unit, so that its instantiations (every dtype, head_dim and
// group) compile beside K3's, in parallel.

#include "decode_fold.cuh"

extern "C" int its_paged_decode_attention_ragged(
    const void* q, const void* k_cache, const void* v_cache, const int32_t* pages,
    const int32_t* page_starts, const int32_t* seq_lens, void* out, float* scratch,
    int* tickets, int dtype, int R, int H, int KVH, int D, int bt, int num_blocks, int P,
    int width, int splits, int window, void* stream) {
  if (P <= 0 || width > P || window < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{R, H, KVH, bt, num_blocks, width, P, splits,
                static_cast<cudaStream_t>(stream), window};
  return dispatch(dtype, D, s, [&](auto c) {
    using T = typename decltype(c)::T;
    return launch<T, decltype(c)::D, decltype(c)::G, true>(
        static_cast<const T*>(q),
        FloatKV<T>{static_cast<const T*>(k_cache), static_cast<const T*>(v_cache)}, pages,
        page_starts, seq_lens, Normalize<T>{static_cast<T*>(out)}, scratch, tickets, s);
  });
}
