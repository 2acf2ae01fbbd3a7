// K4, bf16 path: flash prefill attention on Hopper's tensor cores.
//
// Replaces infinistore_tpu/tpu/flash_prefill.py:_flash_prefill_pallas (bodies
// _flash_kernel and _flash_update) for bf16 inputs:
//   q [B, S, H, D], k/v [B, T, KVH, D] (KVH divides H, D 64 or 128)
//   -> out [B, S, H, D] in bf16.
// Q.K^T in bf16 with f32 accumulation; logits scaled by 1/sqrt(D) in f32;
// f32 online-softmax statistics with m starting at -1e30; the probabilities
// are rounded to bf16 for the PV product while the row sum l takes them
// unrounded; out = acc / max(l, 1e-30). Causal masking is by global position
// (S == T, the wrapper checks); keys at or past T are masked; key tiles
// above the diagonal are never loaded. No atomics, no split across CTAs: the
// result does not depend on scheduling. The f32 path stays on the CUDA cores
// (flash_prefill.cu): wgmma has no full-precision f32 x f32 form.
//
// Bound: operations. Causal attention does two dots of 2*D flops over about
// S^2 / 2 (query, key) pairs per head: 34.4 GFLOP per layer at S = 2048,
// H = 32, D = 128, 0.0348 ms at the 989 TFLOP/s bf16 tensor-core peak
// (bytes: q, k, v and out once, 42 MB, 12.5 us).
//
// Design, for that bound: a persistent kernel, one CTA per SM, each walking
// its share of the work items (query tile of 128 rows, batch x head): the
// items go out heavy (late query tiles) first, back and forth over the CTAs
// so each CTA's work adds up to about the same. A CTA has two consumer
// warpgroups, each owning 64 query rows, and a producer warpgroup that
// hands most of its registers to them (setmaxnreg: 232 each, 40 for the
// producer). One producer thread issues every TMA load: Q once per item, as
// soon as both warpgroups are done with the previous item's Q (so it loads
// under that item's last PV and epilogue), and the K and V tiles of 128
// keys through a 3-stage ring in shared memory under full/empty mbarriers,
// the CTA's items making one stream of tiles (the next item's first tiles
// load under this one's last). S = Q.K^T is wgmma m64n128k16 with both
// operands in shared memory; the online softmax runs on the accumulator in
// registers (a row's values sit in the 4 lanes of a quad, reduced with two
// shuffles); P is packed to bf16 straight from the accumulator, whose
// layout is wgmma's register-A layout, and O += P.V is wgmma with A from
// registers and V (stored [keys, D], D contiguous: MN-major) through the
// transpose-B form. Two overlaps keep the tensor cores fed: each turn
// issues QK of tile kt + 1 together with PV of tile kt and runs tile
// kt + 1's softmax while PV runs, and the two warpgroups take turns (named
// barriers 1 and 2) so one's softmax runs under the other's products. O is
// rescaled only when a row's max moved (alpha is exactly 1 otherwise). The
// exponent is exp2(s * scale * log2 e - m * scale * log2 e) with m the
// running max of the raw dots (scale > 0): the same function as
// exp(s * scale - m * scale) up to f32 rounding. With 224 KiB of shared
// memory at D = 128 one CTA fits an SM.
// Left on the table (it runs at about 0.44 of the bound at S = 2048,
// PERF.md): each work item reads its K/V tiles from L2 on its own (64 KiB
// per 128 x 128 block of work, some 7 TB/s across the card at the
// tensor-core rate), and the diagonal tile computes its masked half.
//
// Layout: every tile is 128-byte swizzled (TMA's CU_TENSOR_MAP_SWIZZLE_128B,
// wgmma's layout type 1). A 128-byte span holds 64 bf16, so a D = 128 row is
// two 64-column boxes, each a [rows, 128 B] block, and the descriptors step
// across them. The tensor maps are 4-D over [B, S, H, D] and [B, T, KVH, D],
// so TMA fills rows past S or T with zeros inside each batch instead of
// reading the next batch's rows. Within a query tile, consecutive items are
// adjacent heads, so the query heads of one KV head read its tiles from L2.
//
// Tensor maps are encoded on the host at every launch (three
// cuTensorMapEncodeTiled calls, reached through the runtime's driver entry
// point, so the library needs no -lcuda) and passed as __grid_constant__
// parameters.

#include <cuda.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 128;        // query rows per work item: two warpgroups of 64
constexpr int kBK = 128;        // keys per tile
constexpr int kStages = 3;      // K/V ring depth
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
// Registers per thread after setmaxnreg: each quarter of the register file
// holds one warp of every warpgroup, 16,384 registers: 232 + 232 + 40 fill
// it (at launch all three have 168).
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kSpan = 128;      // bytes of one swizzled row: 64 bf16
constexpr int kSwizzleAtom = 8 * kSpan;  // 8 rows: the swizzle pattern's period

template <int D>
struct Smem {
  static constexpr int kBoxes = D / 64;          // 64-column boxes per row
  static constexpr int kQBox = kBQ * kSpan;      // one box of the Q tile
  static constexpr int kKVBox = kBK * kSpan;     // one box of a K or V tile
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;
  static constexpr int kK = kQBytes;                      // K stage s at kK + s * kKVBytes
  static constexpr int kV = kK + kStages * kKVBytes;      // V stage s at kV + s * kKVBytes
  // Barriers: q_full, q_empty, k_full[], v_full[], empty[].
  static constexpr int kBars = kV + kStages * kKVBytes;
  static constexpr int kBytes = kBars + 8 * (2 + 3 * kStages) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// Wait until the phase of parity `parity` has completed. A wait of over 2^32
// cycles (about 2 s) can only be a broken pipeline: trap, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence / wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x on the special-function unit; results below 2^-126 flush to zero.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// S[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// O[64 x N] += P[64 x 16] (registers) . V[16 x N], V MN-major (transpose-B).
__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Named barriers 1 and 2: a warpgroup's turn to issue its products.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// S = Q . K^T over D in steps of 16: 32 bytes within a 128-byte box, box kk / 4.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * Smem<D>::kQBox + (kk % 4) * 32;
    const uint32_t koff = (kk / 4) * Smem<D>::kKVBox + (kk % 4) * 32;
    wgmma_ss_m64n128(sc, sw128_desc(q_rows + off, 16, kSwizzleAtom),
                     sw128_desc(k_tile + koff, 16, kSwizzleAtom), kk > 0);
  }
}

// O += P . V over the tile's keys in steps of 16 (16 rows of V each); for
// D = 128 the descriptor's leading offset steps to V's second 64-column box.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[32],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    const uint64_t desc = sw128_desc(v_tile + kk * 16 * kSpan, Smem<D>::kKVBox, kSwizzleAtom);
    if constexpr (D == 128) {
      wgmma_rs_m64n128_tb(o, a, desc);
    } else {
      wgmma_rs_m64n64_tb(o, a, desc);
    }
  }
}

// Online softmax of one S tile on the two rows this thread holds (row0 and
// row0 + 8; its columns start at col0): replaces S by the tile's
// probabilities (f32) and updates m, l and the factors alpha that rescale O.
// A masked entry (key at or past T, or above the diagonal) counts as -inf in
// the max and as 0 in P; the accumulator is only read, so a product still in
// flight on other registers goes on.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2, int row0,
                                             int col0, int T, bool causal) {
  // Entry i of row j is valid when its column offset within the thread's
  // columns is below lim[j]; a masked entry becomes -inf, so its p is
  // exp2(-inf) = 0.
  int lim[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) lim[j] = (causal ? min(T, row0 + 8 * j + 1) : T) - col0;
  // Row max as a tree over 8 partials per row (a chain of 32 dependent
  // max instructions would leave the issue slots idle).
  float part[2][8];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int j = (i / 2) % 2, u = (i / 4) % 4 * 2 + i % 2;
    if (kMask && 8 * (i / 4) + (i % 2) >= lim[j]) sc[i] = -INFINITY;
    part[j][u] = i < 16 ? sc[i] : fmaxf(part[j][u], sc[i]);  // i < 16: first of each
  }
  float mx[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int w = 4; w > 0; w /= 2)
#pragma unroll
      for (int u = 0; u < w; ++u) part[j][u] = fmaxf(part[j][u], part[j][u + w]);
    mx[j] = fmaxf(m[j], part[j][0]);
  }
  float neg[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
    alpha[j] = exp2_ftz((m[j] - mx[j]) * scale_log2);
    m[j] = mx[j];
    neg[j] = -mx[j] * scale_log2;
  }
  float rs[2][4];  // row sums, 4 partials per row; they take p unrounded
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int j = (i / 2) % 2, u = (i / 4) % 4;
    const float p0 = exp2_ftz(fmaf(sc[i], scale_log2, neg[j]));
    const float p1 = exp2_ftz(fmaf(sc[i + 1], scale_log2, neg[j]));
    rs[j][u] = i < 16 ? p0 + p1 : rs[j][u] + (p0 + p1);
    sc[i] = p0;
    sc[i + 1] = p1;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    l[j] = alpha[j] * l[j] + ((rs[j][0] + rs[j][1]) + (rs[j][2] + rs[j][3]));
}

__device__ __forceinline__ void softmax(float (&sc)[64], float (&m)[2], float (&l)[2],
                                        float (&alpha)[2], float scale_log2, bool mask,
                                        int row0, int col0, int T, bool causal) {
  if (mask) {
    softmax_tile<true>(sc, m, l, alpha, scale_log2, row0, col0, T, causal);
  } else {
    softmax_tile<false>(sc, m, l, alpha, scale_log2, row0, col0, T, causal);
  }
}

// O *= alpha per row; skipped when no row of the warp changed its max
// (alpha is exactly 1 then).
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i / 2) % 2];
}

// P rounded to bf16, in wgmma's register-A layout: consecutive accumulator
// pairs of the m64nN layout.
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&p)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// Work item i of n (heavy, late query tiles first; within a tile, adjacent
// heads next to each other) as the query tile and batch x head it covers.
struct Item {
  int b, h, q0, n_kt;
};

__device__ __forceinline__ Item item_at(int i, int S, int T, int H, int BH, int causal) {
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - i / BH;
  const int bh = i % BH;
  Item it{bh / H, bh % H, qt * kBQ, (T + kBK - 1) / kBK};
  if (causal) it.n_kt = min(it.n_kt, (min(it.q0 + kBQ, S) - 1) / kBK + 1);
  return it;
}

// The item a CTA takes in its round r, or n when it has no more: rounds go
// back and forth over the CTAs (0..G-1, then G-1..0), so each CTA's items
// add up to about the same work although the items get lighter.
__device__ __forceinline__ int round_item(int r, int n) {
  const int G = static_cast<int>(gridDim.x), c = static_cast<int>(blockIdx.x);
  const int i = r * G + ((r & 1) ? G - 1 - c : c);
  return i < n ? i : n;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_wgmma(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                    int S, int T, int H, int KVH, int BH, int causal, float scale_log2) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzled tiles: 1 KiB aligned
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_q_empty = bar_q + 8;
  const uint32_t bar_k = bar_q_empty + 8;           // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_empty = bar_v + 8 * kStages;
  const int n_items = (S + kBQ - 1) / kBQ * BH;
  const int group = H / KVH;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_q_empty, 2);  // both warpgroups
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    // The producer warpgroup: one thread issues every load of this CTA's
    // items, Q once per item (when both warpgroups are done with the last
    // one's) and each K/V tile (tile g of the CTA's stream into stage
    // g % kStages) as soon as its stage is free.
    if (threadIdx.x == kConsumers) {
      int g = 0;
      for (int r = 0, i; (i = round_item(r, n_items)) < n_items; ++r) {
        const Item it = item_at(i, S, T, H, BH, causal);
        const int kvh = it.h / group;
        if (r > 0) mbar_wait(bar_q_empty, (r - 1) & 1);
        mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(base + x * L::kQBox, &q_map, bar_q, 64 * x, it.h, it.q0, it.b);
        for (int kt = 0; kt < it.n_kt; ++kt, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(bar_empty + 8 * s, (g / kStages - 1) & 1);
          const uint32_t k_dst = base + L::kK + s * L::kKVBytes;
          const uint32_t v_dst = base + L::kV + s * L::kKVBytes;
          mbar_expect_tx(bar_k + 8 * s, L::kKVBytes);
#pragma unroll
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load_4d(k_dst + x * L::kKVBox, &k_map, bar_k + 8 * s, 64 * x, kvh, kt * kBK, it.b);
          mbar_expect_tx(bar_v + 8 * s, L::kKVBytes);
#pragma unroll
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load_4d(v_dst + x * L::kKVBox, &v_map, bar_v + 8 * s, 64 * x, kvh, kt * kBK, it.b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int cw = threadIdx.x / 128;  // warpgroup: query rows 64 * cw ...
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  // Accumulator layout (m64nN, f32): register i of this thread holds row
  // r0 + 8 * ((i / 2) % 2), column c0 + 8 * (i / 4) + i % 2.
  const int r0 = 64 * cw + 16 * (tid / 32) + lane / 4;  // row within the query tile
  const int c0 = 2 * (lane % 4);
  const uint32_t q_rows = base + cw * 64 * kSpan;
  const int my_turn = 1 + cw, other_turn = 2 - cw;
  constexpr int kOut = D / 2;  // O registers per thread
  float o[kOut];
  float sc[64];
  uint32_t p[32];
  float m[2], l[2], alpha[2];

  int g0 = 0;  // the CTA's K/V tile stream: tile kt of this item is g0 + kt
  for (int r = 0, i; (i = round_item(r, n_items)) < n_items; ++r) {
    const Item it = item_at(i, S, T, H, BH, causal);
    const int n_kt = it.n_kt, q0 = it.q0, row0 = q0 + r0;
    auto k_tile = [&](int kt) { return base + L::kK + ((g0 + kt) % kStages) * L::kKVBytes; };
    auto v_tile = [&](int kt) { return base + L::kV + ((g0 + kt) % kStages) * L::kKVBytes; };
    auto wait_k = [&](int kt) {
      mbar_wait(bar_k + 8 * ((g0 + kt) % kStages), ((g0 + kt) / kStages) & 1);
      __syncwarp();
    };
    auto wait_v = [&](int kt) {
      mbar_wait(bar_v + 8 * ((g0 + kt) % kStages), ((g0 + kt) / kStages) & 1);
      __syncwarp();
    };
    // This warpgroup is done with tile kt; once both are, the producer
    // refills its stage.
    auto release = [&](int kt) {
      if (tid == 0) mbar_arrive(bar_empty + 8 * ((g0 + kt) % kStages));
    };
    // Mask only tiles that reach past T or cross this warpgroup's diagonal.
    auto masked = [&](int kt) {
      return kt * kBK + kBK > T || (causal && kt * kBK + kBK - 1 > q0 + 64 * cw);
    };

#pragma unroll
    for (int x = 0; x < kOut; ++x) o[x] = 0.f;
    m[0] = m[1] = its::kNegInf;  // running max of the raw dots
    l[0] = l[1] = 0.f;           // this thread's share of the row sums
    mbar_wait(bar_q, r & 1);
    __syncwarp();
    // Each turn issues QK of tile kt + 1 and PV of tile kt (the first QK and
    // the last PV on their own); the warpgroups take turns, warpgroup 0
    // first.
    if (cw == 1) turn_pass(other_turn);
    turn_wait(my_turn);
    wait_k(0);
    fence_regs(sc);
    wgmma_fence();
    issue_qk<D>(sc, q_rows, k_tile(0));
    wgmma_commit();
    turn_pass(other_turn);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(sc, m, l, alpha, scale_log2, masked(0), row0, c0, T, causal);
    pack_p(sc, p);
    for (int kt = 0; kt + 1 < n_kt; ++kt) {
      turn_wait(my_turn);
      wait_k(kt + 1);
      fence_regs(sc);
      wgmma_fence();
      issue_qk<D>(sc, q_rows, k_tile(kt + 1));
      wgmma_commit();
      wait_v(kt);
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      issue_pv<D>(o, p, v_tile(kt));
      wgmma_commit();
      turn_pass(other_turn);
      // The softmax of tile kt + 1 runs while PV of tile kt does; it keeps
      // its probabilities in f32 in S's registers and packs them into P
      // only once that product is done with P.
      wgmma_wait<1>();
      fence_regs(sc);
      softmax(sc, m, l, alpha, scale_log2, masked(kt + 1), row0, (kt + 1) * kBK + c0, T,
              causal);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      release(kt);
      pack_p(sc, p);
      rescale(o, alpha);
    }
    // Every product that reads Q is done: the producer may load the next
    // item's Q while this one's last PV and epilogue run.
    if (tid == 0) mbar_arrive(bar_q_empty);
    {
      const int kt = n_kt - 1;
      turn_wait(my_turn);
      wait_v(kt);
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      issue_pv<D>(o, p, v_tile(kt));
      wgmma_commit();
      if (cw == 0) turn_pass(other_turn);  // every wait on a turn meets one pass
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      release(kt);
    }
    g0 += n_kt;

    // Epilogue: the quad's row sums, normalise, round to bf16, store rows < S.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
      l[j] = 1.f / fmaxf(l[j], 1e-30f);  // one division per row, then products
    }
    const int64_t row_stride = static_cast<int64_t>(H) * D;
    __nv_bfloat16* ob =
        out + static_cast<int64_t>(it.b) * S * row_stride + static_cast<int64_t>(it.h) * D;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = row0 + 8 * j;
      if (row < S) {
        __nv_bfloat16* orow = ob + row * row_stride;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + c0) =
              __floats2bfloat162_rn(o[4 * c + 2 * j] * l[j], o[4 * c + 2 * j + 1] * l[j]);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, fetched once through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a contiguous bf16 [batch, rows, heads, D] tensor; one box is
// 64 columns of one head over `box_rows` rows, 128-byte swizzled. Rows past
// `rows` read as zeros. Returns 0 or the driver's CUresult.
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int batch, int rows, int heads, int D,
           int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * D * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2, row, row * rows};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return static_cast<int>(fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int T, int H,
           int KVH, bool causal, cudaStream_t stream) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap q_map, k_map, v_map;
  int res = encode(fn, &q_map, q, B, S, H, D, kBQ);
  if (res == 0) res = encode(fn, &k_map, k, B, T, KVH, D, kBK);
  if (res == 0) res = encode(fn, &v_map, v, B, T, KVH, D, kBK);
  if (res != 0) return -res;  // a failed encode: minus the driver's CUresult
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_wgmma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<D>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 =
      static_cast<float>(1.0 / sqrt(static_cast<double>(D)) * 1.4426950408889634);
  // One CTA per SM (at most), each walking its share of the work items.
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_items = (S + kBQ - 1) / kBQ * B * H;
  flash_prefill_wgmma<D><<<min(n_items, sms), kThreads, Smem<D>::kBytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), S, T, H, KVH, B * H,
      causal ? 1 : 0, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 tensors only (f32 goes to its_flash_prefill). Returns 0, a
// cudaError_t, or minus the CUresult of a failed tensor-map encode. Base
// addresses must be 16-byte aligned (TMA).
extern "C" int its_flash_prefill_wgmma(const void* q, const void* k, const void* v, void* out,
                                       int B, int S, int T_len, int H, int KVH, int D,
                                       int causal, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || T_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (ptrs & 15) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>((S + kBQ - 1) / kBQ) * B * H > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, out, B, S, T_len, H, KVH, causal != 0, s);
    case 128: return launch<128>(q, k, v, out, B, S, T_len, H, KVH, causal != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
