// K4, bf16 path: flash prefill attention on Hopper's tensor cores.
//
// Replaces infinistore_tpu/tpu/flash_prefill.py:_flash_prefill_pallas (bodies
// _flash_kernel and _flash_update) for bf16 inputs:
//   q [B, S, H, D], k/v [B, T, KVH, D] (KVH divides H; D 8, 16, 32, 64, 80,
//   96, 128 or 256)
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
// Layout: every tile is swizzled at its row's span, the largest of 128, 64
// and 32 bytes that divides the row's 2 D bytes: D = 64, 128 and 256 at 128
// B (TMA's CU_TENSOR_MAP_SWIZZLE_128B, wgmma's layout type 1), D = 32 and 96
// at 64 B (SWIZZLE_64B, type 2), D = 16 and 80 at 32 B (SWIZZLE_32B, type
// 3). A row is D / (span / 2) boxes, each a [rows, span] block (D = 256:
// four of 64 columns, D = 96: three of 32, D = 80: five of 16), and the
// descriptors step across them. QK takes D / 16 k-steps of 32 bytes, and PV
// is m64nDk16 (n16 to n256) with V MN-major through the transpose-B form,
// each k-step 16 rows of V; O takes D / 2 registers a thread. D = 8, below
// wgmma's k16, runs as D = 16 with columns 8-15 of every tile zero: each
// box is 16 columns wide over an 8-column tensor, so TMA fills them with
// zeros (its out-of-bounds fill, which costs no bytes read), they add
// exact zeros to S, PV writes zeros into O's columns 8-15, and the
// epilogue stores columns 0-7; the scale is 1/sqrt(8). That doubles the
// tensor-core work of a head_dim whose prefill is launch-bound anyway
// (PERF.md), where a CUDA-core instantiation would be a second kernel.
// D = 256: O takes 128 registers a thread, so the key tile is 80 keys (S
// and P 40 and 20 registers beside O's 128, under kConsumerRegs; wgmma
// m64n80 for QK, five k-steps of PV) and the ring 2 stages deep: Q 64 KiB +
// 2 x 2 x 40 KiB of K and V = 224 KiB. A few query heads over one prompt
// (Gemma-2B: 8 heads, 16 query tiles at 2,048 tokens) give about one item
// an SM, and the last query tile, which reads every key, would set the time
// alone; so where a launch's heads have fewer than kSplitBelow query tiles,
// the work is split over keys (Plan). A query tile that needs more than C =
// ceil(n_max / 2) + 1 key tiles (n_max: the last tile's) is two items, keys
// [0, C) and [C, n), and the items are dealt heaviest first. Each
// warpgroup of the first of the two to finish writes its unnormalised O, m
// and l (f32) to a scratch slot and publishes it on a ticket; the other
// reads it and merges the two in the fixed order (keys [0, C) first)
// before the epilogue, so the result does not depend on which finished
// first. The plan depends on S, T, H and the causal flag alone, never on B
// or the SM count: a prompt's output is the same in any batch, and two
// launches are bitwise equal.
// The tensor maps are 4-D over [B, S, H, D] and [B, T, KVH, D],
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

#include <algorithm>

#include "common.cuh"

// Probe builds only (cuda/prefill_probe.py --variant): D = 256 without its
// key split (ITS_K4_D256_NO_SPLIT), or with a split tile's two items each
// storing its own part as if it were the whole tile, with no merge
// (ITS_K4_NO_MERGE: wrong output; what the merge costs).
#ifdef ITS_K4_D256_NO_SPLIT
constexpr bool kSplit = false;
#else
constexpr bool kSplit = true;
#endif
#ifdef ITS_K4_NO_MERGE
constexpr bool kMerge = false;
#else
constexpr bool kMerge = true;
#endif

namespace {

constexpr int kBQ = 128;        // query rows per work item: two warpgroups of 64
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
// Registers per thread after setmaxnreg: each quarter of the register file
// holds one warp of every warpgroup, 16,384 registers: 232 + 232 + 40 fill
// it (at launch all three have 168).
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;

template <int D>
struct Smem {
  static_assert(D == 8 || D == 16 || D == 32 || D == 64 || D == 80 || D == 96 || D == 128 ||
                    D == 256,
                "head_dim 8, 16, 32, 64, 80, 96, 128 or 256");
  static constexpr int kDP = D < 16 ? 16 : D;  // columns of a tile (D = 8: 8 zero columns)
  static constexpr int kBK = D == 256 ? 80 : 128;    // keys per tile
  static constexpr int kStages = D == 256 ? 2 : 3;  // K/V ring depth
  static constexpr int kN = kBK / 2;                // S registers a thread
  // Bytes of one swizzled box row: the largest of 128, 64, 32 dividing a row.
  static constexpr int kSpan = 2 * kDP % 128 == 0 ? 128 : 2 * kDP % 64 == 0 ? 64 : 32;
  static constexpr int kBoxCols = kSpan / 2;           // bf16 columns of a box
  static constexpr int kSwizzleAtom = 8 * kSpan;       // 8 rows: the swizzle pattern's period
  // wgmma's descriptor layout type for the span: 128 B -> 1, 64 B -> 2, 32 B -> 3.
  static constexpr uint64_t kLayout = kSpan == 128 ? 1 : kSpan == 64 ? 2 : 3;
  static constexpr int kBoxes = kDP / kBoxCols;    // boxes per row
  static constexpr int kQBox = kBQ * kSpan;      // one box of the Q tile
  static constexpr int kKVBox = kBK * kSpan;     // one box of a K or V tile
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;
  static constexpr int kK = kQBytes;                      // K stage s at kK + s * kKVBytes
  static constexpr int kV = kK + kStages * kKVBytes;      // V stage s at kV + s * kKVBytes
  // Barriers: q_full, q_empty, k_full[], v_full[], empty[]; then each
  // warpgroup's ticket word (D = 256's merge).
  static constexpr int kBars = kV + kStages * kKVBytes;
  static constexpr int kFlags = kBars + 8 * (2 + 3 * kStages);
  static constexpr int kBytes = kFlags + 8 + 1024;  // + alignment slack
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

// wgmma shared-memory descriptor of a swizzled tile (layout type 1, 2 or 3:
// 128-, 64- or 32-byte swizzle): start address, leading and stride byte
// offsets, all in 16-byte units.
template <uint64_t kLayout>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (kLayout << 62);
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

// S[64 x 80] (+)= A[64 x 16] . B[80 x 16]^T: the 80-key tile of D = 256.
__device__ __forceinline__ void wgmma_ss_m64n80(float (&d)[40], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// O[64 x N] += P[64 x 16] (registers) . V[16 x N], V MN-major (transpose-B).
__device__ __forceinline__ void wgmma_rs_m64n256_tb(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

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

__device__ __forceinline__ void wgmma_rs_m64n96_tb(float (&d)[48], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n80_tb(float (&d)[40], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
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

__device__ __forceinline__ void wgmma_rs_m64n32_tb(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n16_tb(float (&d)[8], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Named barriers 1 and 2: a warpgroup's turn to issue its products.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// S = Q . K^T over the tile's columns in steps of 16: 32 bytes within a
// box's span, box kk / (span / 32).
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[Smem<D>::kN], uint32_t q_rows,
                                         uint32_t k_tile) {
  using L = Smem<D>;
  constexpr int kSteps = L::kSpan / 32;  // k-steps a box
#pragma unroll
  for (int kk = 0; kk < L::kDP / 16; ++kk) {
    const uint32_t off = (kk / kSteps) * L::kQBox + (kk % kSteps) * 32;
    const uint32_t koff = (kk / kSteps) * L::kKVBox + (kk % kSteps) * 32;
    const uint64_t da = sw_desc<L::kLayout>(q_rows + off, 16, L::kSwizzleAtom);
    const uint64_t db = sw_desc<L::kLayout>(k_tile + koff, 16, L::kSwizzleAtom);
    if constexpr (L::kBK == 128) {
      wgmma_ss_m64n128(sc, da, db, kk > 0);
    } else {
      wgmma_ss_m64n80(sc, da, db, kk > 0);
    }
  }
}

// O += P . V over the tile's keys in steps of 16 (16 rows of V each); where a
// row is several boxes, the descriptor's leading offset steps across V's
// boxes.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[Smem<D>::kDP / 2],
                                         const uint32_t (&p)[Smem<D>::kBK / 4],
                                         uint32_t v_tile) {
  using L = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < L::kBK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    const uint64_t desc =
        sw_desc<L::kLayout>(v_tile + kk * 16 * L::kSpan, L::kKVBox, L::kSwizzleAtom);
    if constexpr (L::kDP == 256) {
      wgmma_rs_m64n256_tb(o, a, desc);
    } else if constexpr (L::kDP == 128) {
      wgmma_rs_m64n128_tb(o, a, desc);
    } else if constexpr (L::kDP == 96) {
      wgmma_rs_m64n96_tb(o, a, desc);
    } else if constexpr (L::kDP == 80) {
      wgmma_rs_m64n80_tb(o, a, desc);
    } else if constexpr (L::kDP == 64) {
      wgmma_rs_m64n64_tb(o, a, desc);
    } else if constexpr (L::kDP == 32) {
      wgmma_rs_m64n32_tb(o, a, desc);
    } else {
      wgmma_rs_m64n16_tb(o, a, desc);
    }
  }
}

// Online softmax of one S tile (kN registers: 128 keys, or 64 at D = 256)
// on the two rows this thread holds (row0 and row0 + 8; its columns start at
// col0): replaces S by the tile's probabilities (f32) and updates m, l and
// the factors alpha that rescale O. A masked entry (key at or past T, or
// above the diagonal) counts as -inf in the max and as 0 in P; the
// accumulator is only read, so a product still in flight on other registers
// goes on.
template <bool kMask, int kN>
__device__ __forceinline__ void softmax_tile(float (&sc)[kN], float (&m)[2], float (&l)[2],
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
  for (int i = 0; i < kN; ++i) {
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
  for (int i = 0; i < kN; i += 2) {
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

template <int kN>
__device__ __forceinline__ void softmax(float (&sc)[kN], float (&m)[2], float (&l)[2],
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
template <int kN>
__device__ __forceinline__ void pack_p(const float (&sc)[kN], uint32_t (&p)[kN / 2]) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// Work item i of n (heavy, late query tiles first; within a tile, adjacent
// heads next to each other) as the query tile and batch x head it covers
// and its key tiles [kt0, kt1). At D = 256 an item may be one of a split
// query tile's two (chunk 0: keys [0, C), chunk 1: [C, n)); slot >= 0 then
// names the merge's scratch slot and ticket.
struct Item {
  int b, h, q0, kt0, kt1, slot, chunk;
};

template <int kBK>
__device__ __forceinline__ Item item_at(int i, int S, int T, int H, int BH, int causal) {
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - i / BH;
  const int bh = i % BH;
  Item it{bh / H, bh % H, qt * kBQ, 0, (T + kBK - 1) / kBK, -1, 0};
  if (causal) it.kt1 = min(it.kt1, (min(it.q0 + kBQ, S) - 1) / kBK + 1);
  return it;
}

// D = 256's key split, from S, T, H and the causal flag alone (the
// wrapper's flash_prefill.wgmma_split mirrors it to size the scratch).
// n_max: key tiles of the last query tile; a tile that needs more than C =
// ceil(n_max / 2) + 1 is split, which holds for the tiles from q_s on (a
// tile needs as many keys as the one before it, or more). Only a prompt of
// few query tiles needs it: no split when its heads have kSplitBelow query
// tiles or more, or when n_max < 2 * kMinChunk.
constexpr int kMinChunk = 4;
constexpr int kSplitBelow = 256;

struct Plan {
  int n_qt, C, q_s;
};

__device__ __forceinline__ int key_tiles(int qt, int S, int T, int causal, int kBK) {
  const int all = (T + kBK - 1) / kBK;
  return causal ? min(all, (min((qt + 1) * kBQ, S) - 1) / kBK + 1) : all;
}

__host__ __device__ __forceinline__ Plan make_plan(int S, int T, int causal, int H, int kBK) {
  Plan p;
  p.n_qt = (S + kBQ - 1) / kBQ;
  const int all = (T + kBK - 1) / kBK;
  const int n_max = causal ? (all < (S - 1) / kBK + 1 ? all : (S - 1) / kBK + 1) : all;
  const bool split = kSplit && n_max >= 2 * kMinChunk && p.n_qt * H < kSplitBelow;
  p.C = split ? (n_max + 1) / 2 + 1 : n_max;
  const int q_s = p.C * kBK / kBQ;
  p.q_s = !split ? p.n_qt : !causal ? 0 : q_s < p.n_qt ? q_s : p.n_qt;
  return p;
}

// Items a batch x head: every query tile, and the split ones twice.
__host__ __device__ __forceinline__ int plan_items(const Plan& p) { return 2 * p.n_qt - p.q_s; }

// Item i under the split, heaviest first, as the back-and-forth rounds
// want: per batch x head, the split tiles' first chunks (C key tiles each,
// the heaviest) from the last query tile back; then the split tiles' second
// chunks (A, n - C tiles from the last tile back) and the whole tiles (B,
// from tile q_s - 1 back), two lists that each get lighter, merged by key
// tiles (A first on a tie) with a merge-path binary search.
__device__ __forceinline__ Item split_item_at(int i, const Plan& p, int S, int T, int H, int BH,
                                              int causal, int kBK) {
  const int v = i / BH, bh = i % BH;
  const int n_split = p.n_qt - p.q_s;
  int qt, chunk;  // chunk -1: a whole tile
  if (v < n_split) {
    qt = p.n_qt - 1 - v;
    chunk = 0;
  } else {
    const int k = v - n_split;  // the merge's element k: a of A and k - a of B come before it
    auto a_at = [&](int j) { return key_tiles(p.n_qt - 1 - j, S, T, causal, kBK) - p.C; };
    auto b_at = [&](int j) { return key_tiles(p.q_s - 1 - j, S, T, causal, kBK); };
    int lo = max(0, k - p.q_s), hi = min(k, n_split);
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (a_at(mid) >= b_at(k - mid - 1)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo < n_split && (k - lo >= p.q_s || a_at(lo) >= b_at(k - lo))) {
      qt = p.n_qt - 1 - lo;
      chunk = 1;
    } else {
      qt = p.q_s - 1 - (k - lo);
      chunk = -1;
    }
  }
  Item it{bh / H, bh % H, qt * kBQ, 0, (T + kBK - 1) / kBK, -1, 0};
  if (causal) it.kt1 = min(it.kt1, (min(it.q0 + kBQ, S) - 1) / kBK + 1);
  if (chunk >= 0) {
    it.slot = (qt - p.q_s) * BH + bh;
    it.chunk = chunk;
    if (chunk == 0) {
      it.kt1 = p.C;
    } else {
      it.kt0 = p.C;
    }
  }
  return it;
}

// Floats a consumer thread writes to a merge slot: O, then m and l (float x
// of thread t at x * 128 + t).
constexpr int kPart = 128 + 4;

// A warpgroup's own barrier (ids 3 and 4; 1 and 2 are the turns).
__device__ __forceinline__ void wg_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + cw) : "memory");
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
                    float* __restrict__ scratch, int* __restrict__ tickets, int S, int T, int H,
                    int KVH, int BH, int causal, float scale_log2) {
  using L = Smem<D>;
  constexpr int kBK = L::kBK;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzled tiles: 1 KiB aligned
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_q_empty = bar_q + 8;
  const uint32_t bar_k = bar_q_empty + 8;           // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_empty = bar_v + 8 * kStages;
  const Plan plan = make_plan(S, T, causal, H, kBK);
  const int n_items = D == 256 ? plan_items(plan) * BH : (S + kBQ - 1) / kBQ * BH;
  const int group = H / KVH;
  auto item_of = [&](int i) {
    if constexpr (D == 256) {
      return split_item_at(i, plan, S, T, H, BH, causal, kBK);
    } else {
      return item_at<kBK>(i, S, T, H, BH, causal);
    }
  };

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
        const Item it = item_of(i);
        const int kvh = it.h / group;
        if (r > 0) mbar_wait(bar_q_empty, (r - 1) & 1);
        mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(base + x * L::kQBox, &q_map, bar_q, L::kBoxCols * x, it.h, it.q0, it.b);
        for (int kt = it.kt0; kt < it.kt1; ++kt, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(bar_empty + 8 * s, (g / kStages - 1) & 1);
          const uint32_t k_dst = base + L::kK + s * L::kKVBytes;
          const uint32_t v_dst = base + L::kV + s * L::kKVBytes;
          mbar_expect_tx(bar_k + 8 * s, L::kKVBytes);
#pragma unroll
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load_4d(k_dst + x * L::kKVBox, &k_map, bar_k + 8 * s, L::kBoxCols * x, kvh,
                        kt * kBK, it.b);
          mbar_expect_tx(bar_v + 8 * s, L::kKVBytes);
#pragma unroll
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load_4d(v_dst + x * L::kKVBox, &v_map, bar_v + 8 * s, L::kBoxCols * x, kvh,
                        kt * kBK, it.b);
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
  const uint32_t q_rows = base + cw * 64 * L::kSpan;
  const int my_turn = 1 + cw, other_turn = 2 - cw;
  constexpr int kOut = L::kDP / 2;  // O registers per thread
  float o[kOut];
  float sc[L::kN];
  uint32_t p[L::kN / 2];
  float m[2], l[2], alpha[2];

  int g0 = 0;  // the CTA's K/V tile stream: tile kt of this item is g0 + kt
  for (int r = 0, i; (i = round_item(r, n_items)) < n_items; ++r) {
    const Item it = item_of(i);
    // Tile kt of this item is key tile kt0 + kt.
    const int n_kt = it.kt1 - it.kt0, kt0 = it.kt0, q0 = it.q0, row0 = q0 + r0;
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
      const int k = (kt0 + kt) * kBK;
      return k + kBK > T || (causal && k + kBK - 1 > q0 + 64 * cw);
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
    softmax(sc, m, l, alpha, scale_log2, masked(0), row0, kt0 * kBK + c0, T, causal);
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
      softmax(sc, m, l, alpha, scale_log2, masked(kt + 1), row0, (kt0 + kt + 1) * kBK + c0, T,
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

    if constexpr (D == 256 && kMerge) {
      if (it.slot >= 0) {
        // One of a split tile's two items. The warpgroup's ticket counts
        // arrivals (+1 each) and the first one's publication (+2): the first
        // writes its O, m and l to the slot, the second waits for them and
        // merges the two in chunk order, then stores as a whole tile does.
        float* part = scratch + static_cast<int64_t>(it.slot * 2 + cw) * kPart * 128 + tid;
        int* ticket = tickets + it.slot * 2 + cw;
        volatile int* flag =
            reinterpret_cast<volatile int*>(smem_raw + (base - smem_u32(smem_raw)) + L::kFlags) + cw;
        if (tid == 0) *flag = atomicAdd(ticket, 1);
        wg_sync(cw);
        if (*flag == 0) {
#pragma unroll
          for (int x = 0; x < kOut; ++x) __stcg(part + x * 128, o[x]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            __stcg(part + (kOut + j) * 128, m[j]);
            __stcg(part + (kOut + 2 + j) * 128, l[j]);
          }
          __threadfence();
          wg_sync(cw);
          if (tid == 0) atomicAdd(ticket, 2);
          continue;
        }
        if (tid == 0) {
          const long long start = clock64();
          while (atomicAdd(ticket, 0) < 3) {
            if (clock64() - start > (1ll << 32)) __trap();
          }
          __threadfence();
          atomicExch(ticket, 0);  // the first never reads it again: zero for the next launch
        }
        wg_sync(cw);
        const bool own0 = it.chunk == 0;  // this warpgroup holds keys [0, C)
        float mt[2], lt[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mt[j] = __ldcg(part + (kOut + j) * 128);
          lt[j] = __ldcg(part + (kOut + 2 + j) * 128);
        }
        float a0[2], a1[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float m0 = own0 ? m[j] : mt[j], m1 = own0 ? mt[j] : m[j];
          const float l0 = own0 ? l[j] : lt[j], l1 = own0 ? lt[j] : l[j];
          const float mx = fmaxf(m0, m1);
          a0[j] = exp2_ftz((m0 - mx) * scale_log2);
          a1[j] = exp2_ftz((m1 - mx) * scale_log2);
          l[j] = l0 * a0[j] + l1 * a1[j];
        }
        // In quarters of 32 loads, each quarter's all in flight at once.
#pragma unroll
        for (int quarter = 0; quarter < 4; ++quarter) {
          float ot[kOut / 4];
#pragma unroll
          for (int x = 0; x < kOut / 4; ++x) ot[x] = __ldcg(part + (quarter * kOut / 4 + x) * 128);
#pragma unroll
          for (int x = 0; x < kOut / 4; ++x) {
            const int r = quarter * kOut / 4 + x;  // register r: row (r / 2) % 2
            const float o0 = own0 ? o[r] : ot[x], o1 = own0 ? ot[x] : o[r];
            o[r] = o0 * a0[(r / 2) % 2] + o1 * a1[(r / 2) % 2];
          }
        }
      }
    }

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

// D = 256: the plan's items a batch x head, on the host.
int split_items_per_head(int S, int T, bool causal, int H) {
  return plan_items(make_plan(S, T, causal ? 1 : 0, H, Smem<256>::kBK));
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
// Smem<D>::kBoxCols columns of one head over `box_rows` rows, swizzled at
// its span (128, 64 or 32 bytes). Rows past `rows`, and at D = 8 the box's
// columns 8-15, read as zeros. Returns 0
// or the CUresult of cuTensorMapEncodeTiled.
template <int D>
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int batch, int rows, int heads,
           int box_rows) {
  using L = Smem<D>;
  constexpr CUtensorMapSwizzle swizzle = L::kSpan == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : L::kSpan == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * D * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2, row, row * rows};
  const cuuint32_t box[4] = {L::kBoxCols, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return static_cast<int>(fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* scratch, void* tickets,
           int B, int S, int T, int H, int KVH, bool causal, cudaStream_t stream) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap q_map, k_map, v_map;
  int res = encode<D>(fn, &q_map, q, B, S, H, kBQ);
  if (res == 0) res = encode<D>(fn, &k_map, k, B, T, KVH, Smem<D>::kBK);
  if (res == 0) res = encode<D>(fn, &v_map, v, B, T, KVH, Smem<D>::kBK);
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
  const int n_items = (D == 256 ? split_items_per_head(S, T, causal, H) : (S + kBQ - 1) / kBQ) *
                      B * H;
  flash_prefill_wgmma<D><<<min(n_items, sms), kThreads, Smem<D>::kBytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), static_cast<float*>(scratch),
      static_cast<int*>(tickets), S, T, H, KVH, B * H, causal ? 1 : 0, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 tensors only (f32 goes to its_flash_prefill). Returns 0, a
// cudaError_t, or minus the CUresult of a failed tensor-map encode. Base
// addresses must be 16-byte aligned (TMA). At D = 256, `scratch` holds
// `slots` merge slots (2 * kPart * 128 f32 each) and `tickets` 2 * slots
// int32 zeros, left zero; a launch needs its split tiles' count times B * H
// (flash_prefill.wgmma_split), and a smaller `slots` is refused.
extern "C" int its_flash_prefill_wgmma(const void* q, const void* k, const void* v, void* out,
                                       void* scratch, void* tickets, int B, int S, int T_len,
                                       int H, int KVH, int D, int causal, int slots,
                                       void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || T_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 256) {
    const int64_t need = static_cast<int64_t>(split_items_per_head(S, T_len, causal != 0, H) -
                                              (S + kBQ - 1) / kBQ) * B * H;
    if (need > slots || (need > 0 && (scratch == nullptr || tickets == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (ptrs & 15) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>((S + kBQ - 1) / kBQ) * B * H * 2 > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch<8>(q, k, v, out, scratch, tickets, B, S, T_len, H, KVH, causal != 0, s);
    case 16: return launch<16>(q, k, v, out, scratch, tickets, B, S, T_len, H, KVH, causal != 0, s);
    case 32: return launch<32>(q, k, v, out, scratch, tickets, B, S, T_len, H, KVH, causal != 0, s);
    case 64: return launch<64>(q, k, v, out, scratch, tickets, B, S, T_len, H, KVH, causal != 0, s);
    case 80: return launch<80>(q, k, v, out, scratch, tickets, B, S, T_len, H, KVH, causal != 0, s);
    case 96: return launch<96>(q, k, v, out, scratch, tickets, B, S, T_len, H, KVH, causal != 0, s);
    case 128: return launch<128>(q, k, v, out, scratch, tickets, B, S, T_len, H, KVH, causal != 0, s);
    case 256: return launch<256>(q, k, v, out, scratch, tickets, B, S, T_len, H, KVH, causal != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
