// K1 and K2: paged KV block gather and scatter.
//
// Replaces infinistore_tpu/tpu/paged.py:_gather_blocks_pallas (body
// _copy_kernel) and :_scatter_blocks_pallas (body _scatter_kernel):
//   gather   out[i] = cache[ids[i]]
//   scatter  cache[ids[i]] = blocks[i], in place; blocks not named keep
//            their bytes.
// Both are byte copies, so one kernel serves every dtype.
//
// Bound: bytes. Each call reads n blocks and writes n blocks. On the main
// path (Llama-3-8B widths: 16 tokens x 8 KV heads x 128 x bf16 = 32 KiB a
// block, 128 blocks a request) that is 4 MiB read + 4 MiB written, about
// 2.5 us at 3.35 TB/s.
//
// Design: grid (n, splits). Each CTA copies a strided share of one block with
// 16-byte vector loads (byte loads when a pointer or the block size is not
// 16-byte aligned). Ids are read from device memory by the CTA itself (the
// TPU kernel's scalar prefetch). An id outside [0, num_blocks) is skipped:
// its output block is left unwritten. Duplicate scatter ids race: which
// block wins is undefined (the path never passes duplicates).
// Left on the table: a 4 MiB copy is ~100 CTAs of work, so launch latency
// (~3-5 us) rivals the copy itself; fusing K and V (and all layers) into one
// launch is the next step.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads)
copy_blocks(const char* __restrict__ src, char* __restrict__ dst,
            const int32_t* __restrict__ ids, int64_t num_blocks,
            int64_t block_bytes, bool gather) {
  const int64_t i = blockIdx.x;
  const int64_t id = ids[i];
  if (id < 0 || id >= num_blocks) return;
  const int64_t src_block = gather ? id : i;
  const int64_t dst_block = gather ? i : id;
  const V* s = reinterpret_cast<const V*>(src + src_block * block_bytes);
  V* d = reinterpret_cast<V*>(dst + dst_block * block_bytes);
  const int64_t nvec = block_bytes / static_cast<int64_t>(sizeof(V));
  for (int64_t j = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x; j < nvec;
       j += static_cast<int64_t>(gridDim.y) * kThreads) {
    d[j] = s[j];
  }
}

int launch(const void* src, void* dst, const int32_t* ids, int64_t n,
           int64_t num_blocks, int64_t block_bytes, bool gather,
           cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n > 2147483647LL || block_bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec16 = (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(dst) % 16 == 0) &&
                     (block_bytes % 16 == 0);
  const int64_t nvec = vec16 ? block_bytes / 16 : block_bytes;
  // About four vectors per thread; at least one CTA per block.
  int64_t splits = (nvec + 4 * kThreads - 1) / (4 * kThreads);
  if (splits < 1) splits = 1;
  if (splits > 65535) splits = 65535;
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(splits));
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  if (vec16) {
    copy_blocks<uint4><<<grid, kThreads, 0, stream>>>(s, d, ids, num_blocks, block_bytes, gather);
  } else {
    copy_blocks<uint8_t><<<grid, kThreads, 0, stream>>>(s, d, ids, num_blocks, block_bytes, gather);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int its_gather_blocks(const void* cache, const int32_t* ids, void* out,
                                 int64_t n, int64_t num_blocks, int64_t block_bytes,
                                 void* stream) {
  return launch(cache, out, ids, n, num_blocks, block_bytes, /*gather=*/true,
                static_cast<cudaStream_t>(stream));
}

extern "C" int its_scatter_blocks(void* cache, const int32_t* ids, const void* blocks,
                                  int64_t n, int64_t num_blocks, int64_t block_bytes,
                                  void* stream) {
  return launch(blocks, cache, ids, n, num_blocks, block_bytes, /*gather=*/false,
                static_cast<cudaStream_t>(stream));
}
