// K1 and K2: paged KV block gather and scatter, over one cache or many.
//
// Replaces infinistore_tpu/tpu/paged.py:_gather_blocks_pallas (body
// _copy_kernel) and :_scatter_blocks_pallas (body _scatter_kernel), and the
// concatenate their callers put around them (tpu/layerwise.py, which XLA
// fuses into one program):
//   gather   flat[c][i] = cache[c][ids[i]]
//   scatter  cache[c][ids[i]] = flat[c][i], in place; blocks not named keep
//            their bytes.
// for every cache c of the launch (up to kMaxCaches, one layer's K and V or
// all layers of a model). Both are byte copies, so one kernel serves every
// dtype. An id outside [0, num_blocks) leaves its item unwritten. Duplicate
// scatter ids race: which block wins is undefined (no path passes them).
//
// Bound: bytes. Each launch reads C * n blocks and writes C * n blocks. At
// Llama-3-8B widths (16 tokens x 8 KV heads x 128 x bf16 = 32 KiB a block)
// one request's 128 blocks of one cache move 8 MiB, 2.5 us at 3.35 TB/s;
// the writer's layer (K and V) 16 MiB, 5.0 us; the engine's snapshot (64
// caches x 64 blocks) 256 MiB, 80 us.
//
// Design (the bulk route). The pointer tables travel by value in the
// kernel's parameters (no host-to-device copy, so a CUDA graph can capture
// the launch). A work item is (cache, block, chunk of kChunkBytes, with a
// shorter tail chunk). A persistent grid of min(items, SMs x resident CTAs)
// one-warp CTAs walks the items in a strided loop. One thread of each CTA
// reads the item's id itself (the TPU kernel's scalar prefetch) and moves
// the bytes with the Tensor Memory Accelerator through a kStages ring in
// shared memory: a bulk load (cp.async.bulk global -> shared, completing on
// the stage's mbarrier), then a bulk store (shared -> global, in a bulk
// group), with kStages - 1 loads in flight behind each store; a stage is
// refilled once the store that read it has read it (wait_group.read), and
// the CTA retires only after every store is done (wait_group 0). No
// register or thread moves a byte, and a CTA keeps (kStages - 1) x
// kChunkBytes of loads in flight: 80 KiB, 160 KiB an SM at 2 CTAs, where
// keeping 3.35 TB/s busy over about 1 us of DRAM latency takes some 25 KiB
// an SM. 16 KiB x 6 stages was chosen on the H100 with cuda/copy_probe.py
// tune: 4 to 32 KiB chunks and 2 to 8 stages lie within 1-3 % of each
// other except at 8 KiB of ring (PERF.md).
//
// What bounds it (copy_probe.py device, PERF.md): a launch under the
// timing of chip_smoke.py costs about 5 us before it moves a byte (an empty
// kernel reads 0.0051 ms), and beyond that both this ring and the vector
// kernel copy at 2.9 TB/s, the card's own contiguous copy rate. The gap to
// the bound is per launch: one request's 8 MiB of one cache takes 0.0095
// ms either way, so the lever is fewer, larger launches: one launch for a
// layer's K and V (0.0216 -> 0.0128 ms), for the engine's snapshot of 64
// caches (0.330 -> 0.099 ms, 0.81 of its bound) and for the install span
// (0.307 -> 0.077 ms). The ring's own fixed cost is about 0.6 us above the
// vector kernel's; the exit wait, the proxy fence, the barrier fence and
// the ring's size do not account for it (the tune variants).
//
// The bulk route needs every pointer and the block size 16-byte aligned;
// anything else takes the second route (the wrapper chooses, by alignment,
// never by a failure): grid (block, split, cache) CTAs of 256 threads, each
// copying a strided share of one block with 16-byte vector loads (bytes
// when a pointer or the block size is not 16-byte aligned). The bulk entry
// refuses a misaligned call with an error; it never falls back.

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kMaxCaches = 64;  // cuda/paged.py: MAX_CACHES
constexpr int64_t kChunkBytes = 16 << 10;
constexpr int kStages = 6;
constexpr int kRingBytes = static_cast<int>(kChunkBytes) * kStages;
constexpr int kBulkThreads = 32;  // one warp; its first thread moves the bytes
constexpr int kVecThreads = 256;
constexpr int kMaxDevices = 64;

static_assert(kStages >= 2, "a store and a load in flight");
static_assert(kChunkBytes % 128 == 0, "stages stay 128-byte aligned");
static_assert(kChunkBytes < (1 << 20), "an mbarrier phase counts under 2^20 bytes");

// The caches of one launch and the contiguous side: flat[c] holds cache c's
// n blocks back to back.
struct Table {
  char* cache[kMaxCaches];
  char* flat[kMaxCaches];
};

struct Work {
  const int32_t* ids;
  int64_t n;           // blocks of each cache
  int64_t num_blocks;  // blocks a cache holds
  int64_t block_bytes;
  int64_t chunks;      // chunks a block
  int64_t items;       // caches x n x chunks
  int gather;
};

// ---------------------------------------------------------------------------
// Bulk route
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// A wait of over 2^32 cycles (about 2 s) can only be a broken ring: trap, so
// the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const char* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(char* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Source, destination and length of work item `item`; false when its id is
// out of range (the item is skipped).
__device__ __forceinline__ bool locate(const Table& t, const Work& w, int64_t item,
                                       const char** src, char** dst, uint32_t* bytes) {
  const int64_t per_cache = w.n * w.chunks;
  const int64_t c = item / per_cache;
  const int64_t r = item - c * per_cache;
  const int64_t i = r / w.chunks;
  const int64_t off = (r - i * w.chunks) * kChunkBytes;
  const int64_t id = w.ids[i];
  if (id < 0 || id >= w.num_blocks) return false;
  char* cached = t.cache[c] + id * w.block_bytes + off;
  char* flat = t.flat[c] + i * w.block_bytes + off;
  *src = w.gather ? cached : flat;
  *dst = w.gather ? flat : cached;
  const int64_t left = w.block_bytes - off;
  *bytes = static_cast<uint32_t>(left < kChunkBytes ? left : kChunkBytes);
  return true;
}

__global__ void __launch_bounds__(kBulkThreads) bulk_copy(const __grid_constant__ Table t,
                                                          const Work w) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  if (threadIdx.x != 0) return;

  for (int s = 0; s < kStages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(&full[s])), "r"(1)
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  char* dst_of[kStages];
  uint32_t bytes_of[kStages];
  int64_t cursor = blockIdx.x;
  // Load the next in-range item of this CTA into stage `s`; false when none is left.
  auto load_next = [&](int s) -> bool {
    const char* src;
    while (cursor < w.items) {
      const int64_t item = cursor;
      cursor += gridDim.x;
      if (locate(t, w, item, &src, &dst_of[s], &bytes_of[s])) {
        bulk_load(smem_u32(ring + s * kChunkBytes), src, bytes_of[s], smem_u32(&full[s]));
        return true;
      }
    }
    return false;
  };

  int64_t loaded = 0;
  while (loaded < kStages - 1 && load_next(static_cast<int>(loaded))) ++loaded;
  for (int64_t k = 0; k < loaded; ++k) {
    const int s = static_cast<int>(k % kStages);
    mbar_wait(smem_u32(&full[s]), static_cast<uint32_t>((k / kStages) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_store(dst_of[s], smem_u32(ring + s * kChunkBytes), bytes_of[s]);
    // Refill the stage of item k - 1 (item k + kStages - 1 goes there) once
    // that item's store, the one before the newest, has read it.
    if (cursor < w.items) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      if (load_next(static_cast<int>(loaded % kStages))) ++loaded;
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// SMs x resident CTAs of the bulk kernel on the current device, asked once
// per device (the shared-memory limit is raised in the same call; two
// threads asking at once both get the same answer); minus a cudaError_t
// when that failed.
int bulk_grid_cap() {
  static std::atomic<int> caps[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return -static_cast<int>(cudaErrorInvalidDevice);
  int cap = caps[dev].load(std::memory_order_acquire);
  if (cap != 0) return cap;
  int sms = 0, per_sm = 0;
  err = cudaFuncSetAttribute(bulk_copy, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bulk_copy, kBulkThreads,
                                                        kRingBytes);
  }
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  cap = err == cudaSuccess ? sms * per_sm : -static_cast<int>(err);
  caps[dev].store(cap, std::memory_order_release);
  return cap;
}

// ---------------------------------------------------------------------------
// Vector route
// ---------------------------------------------------------------------------

template <typename V>
__global__ void __launch_bounds__(kVecThreads)
vector_copy(const __grid_constant__ Table t, const Work w) {
  const int64_t i = blockIdx.x;
  const int64_t id = w.ids[i];
  if (id < 0 || id >= w.num_blocks) return;
  char* cached = t.cache[blockIdx.z] + id * w.block_bytes;
  char* flat = t.flat[blockIdx.z] + i * w.block_bytes;
  const V* s = reinterpret_cast<const V*>(w.gather ? cached : flat);
  V* d = reinterpret_cast<V*>(w.gather ? flat : cached);
  const int64_t nvec = w.block_bytes / static_cast<int64_t>(sizeof(V));
  for (int64_t j = static_cast<int64_t>(blockIdx.y) * kVecThreads + threadIdx.x; j < nvec;
       j += static_cast<int64_t>(gridDim.y) * kVecThreads) {
    d[j] = s[j];
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Fills the table and the work of a launch; 0, or the error to return.
int prepare(void* const* caches, void* const* flats, const int32_t* ids, int64_t C, int64_t n,
            int64_t num_blocks, int64_t block_bytes, bool gather, Table* t, Work* w) {
  if (C > kMaxCaches || n > 2147483647LL || block_bytes <= 0 || num_blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int64_t c = 0; c < C; ++c) {
    t->cache[c] = static_cast<char*>(caches[c]);
    t->flat[c] = static_cast<char*>(flats[c]);
  }
  *w = Work{ids, n, num_blocks, block_bytes, 0, 0, gather ? 1 : 0};
  return 0;
}

int launch_bulk(void* const* caches, void* const* flats, const int32_t* ids, int64_t C,
                int64_t n, int64_t num_blocks, int64_t block_bytes, bool gather,
                cudaStream_t stream) {
  if (C <= 0 || n <= 0) return 0;
  Table t;
  Work w;
  int code = prepare(caches, flats, ids, C, n, num_blocks, block_bytes, gather, &t, &w);
  if (code != 0) return code;
  uintptr_t ptrs = static_cast<uintptr_t>(block_bytes);
  for (int64_t c = 0; c < C; ++c) {
    ptrs |= reinterpret_cast<uintptr_t>(t.cache[c]) | reinterpret_cast<uintptr_t>(t.flat[c]);
  }
  if (ptrs % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const int cap = bulk_grid_cap();
  if (cap < 0) return -cap;
  w.chunks = (block_bytes + kChunkBytes - 1) / kChunkBytes;
  w.items = C * n * w.chunks;
  const int64_t grid = w.items < cap ? w.items : cap;
  bulk_copy<<<static_cast<unsigned>(grid), kBulkThreads, kRingBytes, stream>>>(t, w);
  return static_cast<int>(cudaGetLastError());
}

int launch_vector(void* const* caches, void* const* flats, const int32_t* ids, int64_t C,
                  int64_t n, int64_t num_blocks, int64_t block_bytes, bool gather,
                  cudaStream_t stream) {
  if (C <= 0 || n <= 0) return 0;
  Table t;
  Work w;
  int code = prepare(caches, flats, ids, C, n, num_blocks, block_bytes, gather, &t, &w);
  if (code != 0) return code;
  uintptr_t ptrs = static_cast<uintptr_t>(block_bytes);
  for (int64_t c = 0; c < C; ++c) {
    ptrs |= reinterpret_cast<uintptr_t>(t.cache[c]) | reinterpret_cast<uintptr_t>(t.flat[c]);
  }
  const bool vec16 = ptrs % 16 == 0;
  const int64_t nvec = vec16 ? block_bytes / 16 : block_bytes;
  // About four vectors a thread; at least one CTA a block.
  int64_t splits = (nvec + 4 * kVecThreads - 1) / (4 * kVecThreads);
  if (splits > 65535) splits = 65535;
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(splits),
                  static_cast<unsigned>(C));
  if (vec16) {
    vector_copy<uint4><<<grid, kVecThreads, 0, stream>>>(t, w);
  } else {
    vector_copy<uint8_t><<<grid, kVecThreads, 0, stream>>>(t, w);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// caches, flats: C pointers each (C <= 64); flats[c] holds cache c's n
// blocks back to back. ids: n int32 on the card. Returns 0 or a cudaError_t.
extern "C" int its_gather_blocks_many(void* const* caches, void* const* flats,
                                      const int32_t* ids, int64_t C, int64_t n,
                                      int64_t num_blocks, int64_t block_bytes, void* stream) {
  return launch_bulk(caches, flats, ids, C, n, num_blocks, block_bytes, /*gather=*/true,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int its_scatter_blocks_many(void* const* caches, void* const* flats,
                                       const int32_t* ids, int64_t C, int64_t n,
                                       int64_t num_blocks, int64_t block_bytes, void* stream) {
  return launch_bulk(caches, flats, ids, C, n, num_blocks, block_bytes, /*gather=*/false,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int its_gather_blocks_many_vec(void* const* caches, void* const* flats,
                                          const int32_t* ids, int64_t C, int64_t n,
                                          int64_t num_blocks, int64_t block_bytes,
                                          void* stream) {
  return launch_vector(caches, flats, ids, C, n, num_blocks, block_bytes, /*gather=*/true,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int its_scatter_blocks_many_vec(void* const* caches, void* const* flats,
                                           const int32_t* ids, int64_t C, int64_t n,
                                           int64_t num_blocks, int64_t block_bytes,
                                           void* stream) {
  return launch_vector(caches, flats, ids, C, n, num_blocks, block_bytes, /*gather=*/false,
                       static_cast<cudaStream_t>(stream));
}
