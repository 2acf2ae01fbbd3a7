#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``infinistore_tpu_torch``) on one
NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and ``g++``, and builds everything it runs
from the checkout: the store's native library (``g++``) and the Hopper
kernels (``nvcc``, one process per source), in parallel. Then:

1. Kernel phase. Each kernel (K1 gather, K2 scatter, K3 paged decode
   attention, K4 flash prefill, K5 paged decode statistics, K6 ragged paged
   decode attention, K7 ragged statistics, K8 int8 paged decode) runs
   against its plain PyTorch version on the card, on its path's shapes at
   Llama-3-8B widths, in bf16 and in f32: K1/K2 must be bitwise equal,
   K3/K4/K6/K8 within 1e-5 (f32) and 2e-2 (bf16; K4 rounds probabilities to
   bf16 before PV, the plain version does not). K6 runs a skewed ragged
   wave (1 to 1,152 tokens, a 4-row verification chunk sharing its pages, a
   zero-length row, power-of-two pad pages) and must also be bitwise equal
   to K3 on each row's rebuilt table, and each row bitwise equal to a solo
   launch of that row. K8 (its own int8 fold) is held to the JAX package's
   contract, the same tolerances against its plain version, and against K3
   run on q.float() over the f32-dequantised cache to 1e-5 plus, with bf16
   q, the two results' rounding to bf16 (2^-7 of the value); two launches
   bitwise equal, each row bitwise its solo launch, a zero-length row
   zeros. K5 (at K3's wave) and K7 (at K6's wave) are held against their
   plain statistics; their one-shard combine must be bitwise K3/K6, and the
   combine of 4 disjoint slices of each row's pages within 1e-5 of K3/K6 in
   f32. K4 takes bf16 on its tensor-core kernel (at the main path's 2,048
   tokens and the engine's 1,024) and f32 on its CUDA-core kernel, and each
   launch must have moved its kernel's counter. Each kernel is timed with
   CUDA events (the median of 11 launches, each behind an L2 flush and a
   device-side spin that keeps the wrapper's host work out of the
   interval) beside its plain version, one PyTorch library call where one
   computes the same function, and its bound (bytes over 3.35 TB/s or
   operations over the card's peak rate for the inputs' type, from this
   run's inputs), at the shapes of the path that runs it (K5 at the sharded
   decode's 32,768-token request, also timed without its cross-split merge,
   ``fold_ms``: its source built with ``-DITS_DECODE_NOMERGE`` into
   ``_build/probe`` as ``cuda/decode_probe.py`` builds it, whose ``k5`` mode
   also gives the CTAs, the CTAs an SM holds and the waves; K7 at the skewed
   wave also through that build, ``fold_ms``, and at the wave's first
   quarter-shard, ``quarter_shard_ms``, which ``decode_probe.py k7`` breaks
   down into launch, prologue, stages and merge). K3 is also
   held (f32 1e-5, bf16 2e-2) and timed at the engine's ``prefill_continue``
   shape (256 rows at contexts 769-1,024 sharing one table), K6 at the
   engine's own wave (4 x 8-token verification chunks at 1,024 tokens, each
   chunk's rows sharing their pages; bitwise K3 per row; its bound counts the distinct pages);
   two launches of K3 and K6 on the same inputs must be bitwise equal.
   K3's, K4's and K6's wrapper host time per call is logged. K1/K2 are
   also held bitwise (bf16 and f32, every launch on the TMA bulk ring) and
   timed through their batched entries at the paths' shapes: the writer's
   and the reader's layer ([K, V] x 128 blocks), the engine's save snapshot
   (64 caches x 64 blocks), the install span (64 caches x 48 blocks) and the
   int8 round trip's 16 KiB data and 512 B scale blocks, beside their bound
   and the unfused sequence the paths ran before (one launch a cache, plus
   the writer's ``torch.cat``), with K1/K2's wrapper host time.
2. Main path at Llama-3-8B width (random weights from seed 0): engine A
   prefills 4 prompts of 2048 tokens and saves them through
   ``KVConnector.save`` to an in-process store; engine B looks each prompt up
   (all 128 blocks must hit), loads it into different block ids, must hold
   the same bytes, and both engines decode 16 steps as one wave of 4 with
   bitwise-equal logits. Launch counts are zeroed just before this phase
   and every kernel must have launched in it; here and in both engine
   phases every K4 launch must have taken the bf16 tensor-core kernel, and
   here, in the int8 round trip and in both engine phases every K1/K2
   launch the TMA bulk ring.
3. A small f32 model through the same round trip twice, on the card (the
   kernels) and on the CPU (the plain versions): logits agree to 2e-4.
4. int8 round trip at Llama-3-8B width: engine A's 4 x 2,048-token bf16
   prefixes are quantised (``quantize_kv``) and saved through
   ``QuantizedKVConnector`` to a fresh store (2 GiB in 16 KiB units, see
   ``INT8_STORE_UNIT``); engine B looks them up (all 128 blocks hit) and
   loads them into its own int8 caches at other block ids; data and scales
   must be byte-equal. K8 then decodes a seeded bf16 query wave [4, 32,
   128] over the 2,048-token contexts for all 32 layers, held to K8's
   contract as in phase 1 (within 2e-2 of its plain version, within one
   bf16 rounding of K3 over the dequantised cache, two launches and solo
   rows bitwise); its largest difference from K3 over the
   original bf16 cache (the int8 scheme's error, at most 2e-2), save/load
   GB/s and the store's bytes per key are logged beside the bf16 main
   path's.
5. Engine phase at Llama-3-8B width (bf16, the main path's weights; a fresh
   store with a 2 GiB pool): one ``ContinuousBatchingHarness`` (1,024
   blocks = 2 GiB of KV, 72 blocks per request, n-gram drafts of up to 7)
   serves two rounds of 4 concurrent requests. Round 1: 1,024-token prompts
   (a shared 512-token prefix, a tail in which a 64-token span occurs
   twice), 64 generated tokens each: misses, prefilled (K4, K2) and saved
   (K1). Round 2: each round-1 prompt's first 768 tokens plus 256 new ones:
   48-block prefix hits fetched and installed (K2), the suffix resumed with
   ``prefill_continue`` (K3). Every generation wave is one
   ``verify_step_ragged`` (K6). Every request's prompt blocks must match the
   model's own prefill within the bf16 tolerance ``ENGINE_VERIFY_TOL``, and
   K1, K2, K3, K4 and K6 must each have launched in the phase.
6. int8 engine phase: the same two rounds through ``QuantizingKVAdapter``
   (the engine keeps its bf16 cache, the store holds int8 + scales) on a
   fresh 2 GiB store with the same 32 KiB unit; round 2's requests are
   verified within a tolerance derived from the int8 scheme
   (``_int8_verify_tol``). TTFT, prefix-ready, tokens/s and the store's
   bytes are logged beside the bf16 engine phase's.
7. The engine's two rounds scaled down on a small f32 model (head_dim 64)
   on the card and on the CPU, through the plain adapter and through the
   quantizing one: every request verified on both devices; the plain
   adapter's tokens must be identical on the card and the CPU, and so must
   the int8 adapter's first round (its second reads int8 prefixes
   quantised from values that may differ in the last place between the two
   devices; the share of identical tokens is logged).
8. Sharded decode on a process group of world size 1 (NCCL, FileStore):
   ``paged_decode_attention_sharded`` over a 32,768-token bf16 context of
   one layer (128 MiB of K+V) and ``paged_decode_attention_ragged_sharded``
   over the kernel phase's skewed wave; both must be bitwise K3/K6 (the
   one-shard combine) and K5/K7 must have launched. One card has no second
   rank: the multi-rank combine is held on the CPU (4 gloo ranks,
   ``tests/test_torch_sharded_decode.py``) and, over 4 slices stacked in
   one process, by the kernel phase.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, on any failure or when no CUDA device is present.
"""

import asyncio
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))


# Main-path geometry: Meta-Llama-3-8B's published config.json widths.
LLAMA3_8B = dict(
    vocab=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    ffn_dim=14336, block_tokens=16, rope_theta=500000.0,
)
PROMPTS = 4
PROMPT_TOKENS = 2048
DECODE_STEPS = 16

# Engine phase: round 1 prompts of SHARED + TAIL tokens (a SPAN-token stretch
# of the tail occurs twice, so the n-gram drafter proposes), round 2 keeps
# KEEP tokens of each and appends NEW; GEN tokens generated per request.
ENGINE = dict(shared=512, tail=512, span=64, keep=768, new=256, gen=64)
ENGINE_BLOCKS = 1024  # 2 GiB of bf16 KV at Llama-3-8B width
ENGINE_REQ_BLOCKS = 72
# bf16 prompt blocks against the model's own one-shot prefill: a prefix hit
# resumes its suffix through K3 (f32 softmax, output rounded to bf16) where
# the oracle runs K4 (p rounded to bf16 before PV), so values differ by a few
# bf16 ulps, compounded over 32 layers; a wrong or stale block differs by
# O(1). allclose(rtol=atol=0.1).
ENGINE_VERIFY_TOL = 0.1
SMALL_ENGINE = dict(shared=32, tail=32, span=8, keep=48, new=16, gen=16)
# The int8 round trip's store unit: the smallest ServerConfig allows. An int8
# data block (16 tokens x 8 KV heads x 128) is 16 KiB and a scale block 512
# B, and the store allocates whole units, so each takes one: 65,536 keys x
# 16 KiB = 1 GiB for the 4 x 2,048-token prefixes, half of a 2 GiB pool (at
# the main path's 32 KiB unit they would take the whole pool).
INT8_STORE_UNIT = 16 << 10
SHARDED_CONTEXT = 32768  # tokens of the sharded decode's one request

# What each kernel's design is now (the ``kernels`` line's ``design``).
DESIGNS = {
    "gather_blocks": "TMA bulk-copy ring over up to 64 caches a launch",
    "scatter_blocks": "TMA bulk-copy ring over up to 64 caches a launch",
    "paged_decode_attention": "split-KV fold, cp.async ring, in-order split merge",
    "flash_prefill": "bf16: wgmma fed by a TMA/mbarrier ring; f32: CUDA cores",
    "paged_decode_attention_ragged": "K3's split-KV fold over a flat page list",
    "paged_decode_attention_stats": "K3's split-KV fold; rows of more than 16 splits merge "
                                    "in a two-level tree across the card",
    "paged_decode_attention_ragged_stats": "K6's fold, raw statistics; its splits merged by "
                                           "the last CTA (a thread-block cluster merge "
                                           "measured slower)",
    "paged_decode_attention_quantized": "int8-native split-KV fold: 16-byte lanes, exact "
                                        "byte-permute widening, scales once per token",
}
TPU_KERNELS = {
    "gather_blocks": ("infinistore_tpu/tpu/paged.py:115", "paged_copy.cu"),
    "scatter_blocks": ("infinistore_tpu/tpu/paged.py:135", "paged_copy.cu"),
    "paged_decode_attention": ("infinistore_tpu/tpu/paged_attention.py:209", "paged_attention.cu"),
    # bf16 on the tensor cores (timed below), f32 on the CUDA cores.
    "flash_prefill": ("infinistore_tpu/tpu/flash_prefill.py:152", "flash_prefill_wgmma.cu",
                      "flash_prefill.cu"),
    "paged_decode_attention_ragged": ("infinistore_tpu/tpu/paged_attention.py:555",
                                      "paged_attention.cu"),
    "paged_decode_attention_stats": ("infinistore_tpu/tpu/paged_attention.py:250",
                                     "paged_attention_stats.cu"),
    "paged_decode_attention_ragged_stats": ("infinistore_tpu/tpu/paged_attention.py:575",
                                            "paged_attention_stats.cu"),
    "paged_decode_attention_quantized": ("infinistore_tpu/tpu/kv_quant.py:107", "kv_quant.cu"),
}
ENGINE_KERNELS = ("gather_blocks", "scatter_blocks", "paged_decode_attention", "flash_prefill",
                  "paged_decode_attention_ragged")
# The kernels each path must run (its launch counts are zeroed just before it).
PATH_KERNELS = {
    "prefill_store_decode": ("gather_blocks", "scatter_blocks", "paged_decode_attention",
                             "flash_prefill"),
    "int8_round_trip": ("gather_blocks", "scatter_blocks", "paged_decode_attention_quantized"),
    "engine": ENGINE_KERNELS,
    "int8_engine": ENGINE_KERNELS,
    "sharded_decode": ("paged_decode_attention_stats", "paged_decode_attention_ragged_stats"),
}
# Paths whose every K4 launch is bf16, so must take the tensor-core kernel.
BF16_K4_PATHS = ("prefill_store_decode", "engine", "int8_engine")
# Paths whose every K1/K2 launch moves 16-byte aligned blocks, so must take
# the TMA bulk ring.
BULK_COPY_PATHS = ("prefill_store_decode", "int8_round_trip", "engine", "int8_engine")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def _timing():
    """The package's timing helpers (``cuda/timing.py``), imported at first
    use: a probe may load this file for its shapes beside another tree's
    package."""
    from infinistore_tpu_torch.cuda import timing

    return timing


def host_us(torch, fn, calls: int = 50) -> float:
    return _timing().host_us(torch, fn, calls)


def bound_ms(nbytes: float, flops: float, dtype_name: str):
    return _timing().bound_ms(nbytes, flops, dtype_name)


def max_err(a, b) -> float:
    return _timing().max_err(a, b)


def peak_dtype(t) -> str:
    """The key of ``PEAK_FLOPS`` for work on ``t``'s dtype: the card's peak
    rate for that input type (bf16 products are exact in f32, so a bf16
    kernel that accumulates in f32 is held to the bf16 rate)."""
    return str(t.dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# Phase 1: every kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------


def kernel_phase(torch, timer, nomerge):
    import torch.nn.functional as F

    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import flash_prefill as fp
    from infinistore_tpu_torch.cuda import paged
    from infinistore_tpu_torch.cuda import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(1234)
    cfg = LLAMA3_8B
    bt, kvh, d, h = cfg["block_tokens"], cfg["n_kv_heads"], cfg["dim"] // cfg["n_heads"], cfg["n_heads"]
    nb = PROMPT_TOKENS // bt  # blocks per request
    results = {}

    def randn(shape, dtype):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)

    # K1 / K2: one request's blocks out of (into) a 1024-block layer cache.
    num_blocks = 1024
    ids = torch.randperm(num_blocks, generator=g, device="cuda")[:nb].to(torch.int32)
    ids_long = ids.long()
    for dtype in (torch.float32, torch.bfloat16):
        cache = randn((num_blocks, bt, kvh, d), dtype)
        got = paged.gather_blocks(cache, ids)
        torch.cuda.synchronize()
        if not torch.equal(got, paged.gather_blocks_plain(cache, ids)):
            raise AssertionError(f"gather_blocks != index_select ({dtype})")
        blocks = randn((nb, bt, kvh, d), dtype)
        got = paged.scatter_blocks(cache.clone(), ids, blocks)
        torch.cuda.synchronize()
        if not torch.equal(got, paged.scatter_blocks_plain(cache.clone(), ids, blocks)):
            raise AssertionError(f"scatter_blocks != index_copy_ ({dtype})")
        log(f"K1/K2 {dtype}: bitwise equal to the plain versions")
        if dtype is torch.bfloat16:
            nbytes = 2 * nb * blocks[0].numel() * blocks.element_size() + ids.numel() * 4
            bms, by = bound_ms(nbytes, 0.0, "bfloat16")
            results["gather_blocks"] = dict(
                max_abs_err=0.0,
                ms=timer.ms(lambda: paged.gather_blocks(cache, ids)),
                plain_ms=timer.ms(lambda: paged.gather_blocks_plain(cache, ids)),
                bound_ms=bms, bound_by=by,
                library_ms=timer.ms(lambda: cache.index_select(0, ids_long)),
            )
            results["scatter_blocks"] = dict(
                max_abs_err=0.0,
                ms=timer.ms(lambda: paged.scatter_blocks(cache, ids, blocks)),
                plain_ms=timer.ms(lambda: paged.scatter_blocks_plain(cache, ids, blocks)),
                bound_ms=bms, bound_by=by,
                library_ms=timer.ms(lambda: cache.index_copy_(0, ids_long, blocks)),
            )
            results["gather_blocks"]["host_us"] = host_us(
                torch, lambda: paged.gather_blocks(cache, ids))
            results["scatter_blocks"]["host_us"] = host_us(
                torch, lambda: paged.scatter_blocks(cache, ids, blocks))
    for name, shapes in _copy_kernel_check(torch, timer, g, paged, _ext).items():
        results[name]["shapes"] = shapes

    # K3: a wave of 4 requests at 2048 tokens of context.
    bsz = PROMPTS
    n_cache = bsz * nb + 16
    tables = torch.randperm(n_cache, generator=g, device="cuda")[: bsz * nb].to(torch.int32).reshape(bsz, nb)
    full = torch.full((bsz,), PROMPT_TOKENS, dtype=torch.int32, device="cuda")
    ragged = torch.tensor([PROMPT_TOKENS, PROMPT_TOKENS - 1, 1000, 0], dtype=torch.int32, device="cuda")
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q = randn((bsz, h, d), dtype)
        kc = randn((n_cache, bt, kvh, d), dtype)
        vc = randn((n_cache, bt, kvh, d), dtype)
        err = 0.0
        for lens in (full, ragged):
            got = pa.paged_decode_attention_batched(q, kc, vc, tables, lens)
            again = pa.paged_decode_attention_batched(q, kc, vc, tables, lens)
            want = pa.paged_decode_attention_plain_batched(q, kc, vc, tables, lens)
            torch.cuda.synchronize()
            err = max(err, max_err(got, want))
            if not torch.equal(got, again):
                raise AssertionError(f"paged_decode_attention {dtype}: two launches differ")
        if not err <= tol:
            raise AssertionError(f"paged_decode_attention {dtype}: max abs err {err} > {tol}")
        if float(got[3].float().abs().max()) != 0.0:
            raise AssertionError("paged_decode_attention: seq_len 0 must give zeros")
        log(f"K3 {dtype}: max abs err {err:.3e} (tol {tol}); two launches bitwise equal")
        if dtype is torch.bfloat16:
            tokens = int(full.sum())
            nbytes = (2 * tokens * kvh * d + 2 * bsz * h * d) * kc.element_size() + tables.numel() * 4 + bsz * 4
            bms, by = bound_ms(nbytes, 4.0 * h * d * tokens, peak_dtype(q))
            results["paged_decode_attention"] = dict(
                max_abs_err=err,
                ms=timer.ms(lambda: pa.paged_decode_attention_batched(q, kc, vc, tables, full)),
                plain_ms=timer.ms(lambda: pa.paged_decode_attention_plain_batched(q, kc, vc, tables, full)),
                bound_ms=bms, bound_by=by, library_ms=None,
                host_us=host_us(torch, lambda: pa.paged_decode_attention_batched(
                    q, kc, vc, tables, full)),
            )
            log(f"K3 bf16: {bms / results['paged_decode_attention']['ms']:.3f} of its bound; "
                f"wrapper host time {results['paged_decode_attention']['host_us']:.1f} us "
                "per call")

    # K4: one 2048-token prompt, all 32 heads (one layer of prefill); in bf16
    # also the engine's 1,024-token prompts. bf16 runs on the tensor cores,
    # f32 on the CUDA cores; each launch must take its dtype's kernel.
    for dtype, tol, s in ((torch.float32, 1e-5, PROMPT_TOKENS),
                          (torch.bfloat16, 2e-2, ENGINE["shared"] + ENGINE["tail"]),
                          (torch.bfloat16, 2e-2, PROMPT_TOKENS)):
        q = randn((1, s, h, d), dtype)
        k = randn((1, s, kvh, d), dtype)
        v = randn((1, s, kvh, d), dtype)
        before = dict(_ext.LAUNCHES)
        got = fp.flash_prefill_attention(q, k, v, causal=True)
        wgmma = _ext.LAUNCHES["flash_prefill_wgmma"] - before["flash_prefill_wgmma"]
        if _ext.LAUNCHES["flash_prefill"] - before["flash_prefill"] != 1 or \
                wgmma != int(dtype is torch.bfloat16):
            raise AssertionError(f"flash_prefill {dtype}: took the wrong kernel")
        want = fp.flash_prefill_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if not err <= tol:
            raise AssertionError(f"flash_prefill {dtype} S={s}: max abs err {err} > {tol}")
        log(f"K4 {dtype} S={s}: max abs err {err:.3e} (tol {tol})")
        if dtype is torch.bfloat16:
            pairs = s * (s + 1) // 2  # causal (query, key) pairs per head
            flops = 4.0 * d * h * pairs
            nbytes = (2 * s * h * d + 2 * s * kvh * d) * q.element_size()
            bms, by = bound_ms(nbytes, flops, "bfloat16")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row = dict(
                max_abs_err=err,
                ms=timer.ms(lambda: fp.flash_prefill_attention(q, k, v, causal=True)),
                plain_ms=timer.ms(lambda: fp.flash_prefill_plain(q, k, v, causal=True)),
                bound_ms=bms, bound_by=by,
                library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)),
            )
            log(f"K4 bf16 S={s}: {json.dumps(row)}; {bms / row['ms']:.3f} of its bound")
            if s == PROMPT_TOKENS:
                results["flash_prefill"] = row
                us = host_us(torch, lambda: fp.flash_prefill_attention(q, k, v, causal=True))
                log(f"K4 bf16 S={s}: wrapper host time {us:.1f} us per call")

    results["paged_decode_attention"]["prefill_continue"] = _prefill_continue_check(
        torch, timer, g, pa)
    (results["paged_decode_attention_ragged"],
     results["paged_decode_attention_ragged_stats"]) = _ragged_kernel_check(torch, timer, g, pa,
                                                                            nomerge)
    results["paged_decode_attention_ragged"]["engine_wave"] = _engine_wave_check(
        torch, timer, g, pa)
    # K8 and K5 at K3's wave (drawn last, so the earlier kernels keep their inputs).
    results["paged_decode_attention_quantized"] = _quant_kernel_check(
        torch, timer, g, tables, (full, ragged), n_cache)
    results["paged_decode_attention_stats"] = _stats_kernel_check(
        torch, timer, g, tables, (full, ragged), n_cache, nomerge)
    return results


# K1/K2 at the shapes of the paths' batched calls: the writer's and the
# reader's layer ([K, V] x 128 blocks), the engine's save snapshot (every
# layer's K and V, 64 caches x 64 blocks), the install span's scatter (64
# caches x the engine's 48-block hit) and the int8 round trip's layer (16 KiB
# int8 data blocks, 512 B f32 scale blocks).
COPY_NUM_BLOCKS = 1024
COPY_SHAPES = {
    "gather_blocks": {"a_writer_layer": (2, 128), "b_engine_snapshot": (64, 64)},
    "scatter_blocks": {"a_reader_layer": (2, 128), "c_install_span": (64, 48)},
}


def copy_inputs(torch, g, dtype, block_shape, caches, device="cuda"):
    """``caches`` caches of ``COPY_NUM_BLOCKS`` blocks, random ids for every
    block count of ``COPY_SHAPES`` (and the table's 128) and a pool of
    source blocks, all drawn from ``g`` on ``device``."""
    def draw(shape):
        if dtype is torch.int8:
            return torch.randint(-127, 128, shape, generator=g, device=device, dtype=dtype)
        return torch.randn(shape, generator=g, device=device).to(dtype)

    return dict(
        caches=[draw((COPY_NUM_BLOCKS, *block_shape)) for _ in range(caches)],
        ids={n: torch.randperm(COPY_NUM_BLOCKS, generator=g, device=device)[:n].to(torch.int32)
             for n in (128, 64, 48)},
        src=draw((max(c * n for shapes in COPY_SHAPES.values() for c, n in shapes.values()),
                  *block_shape)),
    )


def copy_calls(inp, gather, scatter, gather_many=None, scatter_many=None):
    """(kernel, shape) -> a call at that shape: through ``gather_many`` /
    ``scatter_many`` when given (one call for every cache), else the
    sequence the paths ran before the batched entries existed (one
    ``gather`` / ``scatter`` a cache, and the ``torch.cat`` the writer put
    around its layer's two gathers; the snapshot and the install span kept
    their per-cache results as they were). The table's single-cache shape
    always takes ``gather`` / ``scatter``."""
    import torch

    cs, ids, src = inp["caches"], inp["ids"], inp["src"]
    calls = {
        ("gather_blocks", "table"): lambda: gather(cs[0], ids[128]),
        ("scatter_blocks", "table"): lambda: scatter(cs[0], ids[128], src[:128]),
    }
    for kind, shapes in COPY_SHAPES.items():
        for name, (count, n) in shapes.items():
            if count > len(cs):
                continue
            sub, b = cs[:count], ids[n]
            if kind == "gather_blocks":
                if gather_many is not None:
                    fn = (lambda sub=sub, b=b: gather_many(sub, b))
                elif name == "a_writer_layer":
                    fn = (lambda sub=sub, b=b: torch.cat([gather(c, b) for c in sub]))
                else:
                    fn = (lambda sub=sub, b=b: [gather(c, b) for c in sub])
            else:
                packed = src[: count * n]
                if scatter_many is not None:
                    fn = (lambda sub=sub, b=b, p=packed: scatter_many(sub, b, p))
                else:
                    fn = (lambda sub=sub, b=b, p=packed, n=n:
                          [scatter(c, b, p[i * n:(i + 1) * n]) for i, c in enumerate(sub)])
            calls[(kind, name)] = fn
    return calls


def copy_matches(torch, inp, key, mine, theirs) -> bool:
    """Whether ``copy_calls(inp, *mine)[key]`` gives bitwise what
    ``copy_calls(inp, *theirs)[key]`` gives: the gathered blocks, or every
    cache after the scatter (each side scatters into its own clones)."""
    if key[0] == "gather_blocks":
        got = copy_calls(inp, *mine)[key]()
        return torch.equal(got, copy_calls(inp, *theirs)[key]())
    sides = []
    for calls in (mine, theirs):
        cloned = dict(inp, caches=[c.clone() for c in inp["caches"]])
        copy_calls(cloned, *calls)[key]()
        sides.append(cloned["caches"])
    return all(torch.equal(a, b) for a, b in zip(*sides))


def _copy_kernel_check(torch, timer, g, paged, _ext):
    """K1/K2 at ``COPY_SHAPES`` in bf16 and f32 and at the int8 round trip's
    data and scale blocks: bitwise the plain versions, every launch on the
    bulk route; timed (bf16, int8) beside their bound and, at the bf16
    shapes, the unfused sequence (``copy_calls`` without the batched
    entries). Returns kernel -> shape -> numbers."""
    bt, kvh = LLAMA3_8B["block_tokens"], LLAMA3_8B["n_kv_heads"]
    d = LLAMA3_8B["dim"] // LLAMA3_8B["n_heads"]
    singles = (paged.gather_blocks, paged.scatter_blocks)
    fused = (*singles, paged.gather_blocks_many, paged.scatter_blocks_many)
    plain = (paged.gather_blocks_plain, paged.scatter_blocks_plain,
             paged.gather_blocks_many_plain, paged.scatter_blocks_many_plain)
    cases = (("bf16", torch.bfloat16, (bt, kvh, d), 64),
             ("f32", torch.float32, (bt, kvh, d), 64),
             ("d_int8_data", torch.int8, (bt, kvh, d), 2),
             ("d_int8_scales", torch.float32, (bt, kvh, 1), 2))
    out = {"gather_blocks": {}, "scatter_blocks": {}}
    for label, dtype, block_shape, count in cases:
        inp = copy_inputs(torch, g, dtype, block_shape, count)
        calls = copy_calls(inp, *fused)
        for (kind, shape), fn in calls.items():
            before = dict(_ext.LAUNCHES)
            equal = copy_matches(torch, inp, (kind, shape), fused, plain)
            torch.cuda.synchronize()
            moved = _ext.LAUNCHES[kind] - before[kind]
            if moved < 1 or _ext.LAUNCHES[f"{kind}_bulk"] - before[f"{kind}_bulk"] != moved:
                raise AssertionError(
                    f"{kind} {shape} {label}: not every launch took the bulk route")
            if not equal:
                raise AssertionError(f"{kind} {shape} {label}: differs from the plain version")
            # Timed: bf16 at the batched shapes (the table's row is timed
            # above), int8 data and scales at the layer's.
            if not (shape != "table" and label == "bf16" or shape.startswith("a_")
                    and label.startswith("d_")):
                continue
            count_, n = COPY_SHAPES[kind][shape]
            block = inp["caches"][0][0]
            nbytes = 2 * count_ * n * block.numel() * block.element_size() + 4 * n
            bms, by = bound_ms(nbytes, 0.0, "bfloat16")
            ms = timer.ms(fn)
            row = dict(ms=ms, bound_ms=bms, bound_by=by, share_of_bound=bms / ms,
                       caches=count_, blocks=n, block_bytes=block.numel() * block.element_size())
            if label == "bf16":
                unfused = copy_calls(inp, *singles)[(kind, shape)]
                row["unfused_ms"] = timer.ms(unfused, spin=count_)
            name = shape if label == "bf16" else f"{label}_{shape[2:]}"
            out[kind][name] = row
            log(f"{kind} {name}: {json.dumps(row)}")
        log(f"K1/K2 {label}: bitwise equal to the plain versions at every shape, "
            "every launch on the bulk route")
        del inp, calls
        torch.cuda.empty_cache()
    return out


def _slices(n_parts, width):
    """``n_parts`` disjoint, contiguous slices of ``width`` table entries."""
    part = width // n_parts
    return [slice(s * part, (s + 1) * part) for s in range(n_parts)]


def _slice_lens(lens, sl, bt):
    """The tokens of each row that fall in table slice ``sl``."""
    return [min(max(n - sl.start * bt, 0), (sl.stop - sl.start) * bt) for n in lens]


def _decode_bound(torch, q, distinct_pages, lens, bt, kvh, meta_bytes):
    """K3/K6's bound over the distinct pages its rows read (each read once),
    q and the output, and the page metadata; its operations at the card's
    peak for q's dtype."""
    d = q.shape[-1]
    nbytes = 2 * distinct_pages * bt * kvh * d * q.element_size() + \
        2 * q.numel() * q.element_size() + meta_bytes
    return bound_ms(nbytes, 4.0 * q.shape[1] * d * sum(lens), peak_dtype(q))


def _prefill_continue_check(torch, timer, g, pa):
    """K3 at the engine's prefill_continue shape: one request's 256-token
    suffix resumed over its 768-token prefix (``verify_step_batched``'s
    rows: 256 rows at contexts 769-1,024, all over one 72-block table, so
    the rows share their pages). Against its plain version in f32 (1e-5) and
    bf16 (2e-2), two launches bitwise equal; in bf16 timed, with its bound
    over the 64 distinct pages."""
    cfg = LLAMA3_8B
    bt, kvh, h = cfg["block_tokens"], cfg["n_kv_heads"], cfg["n_heads"]
    d = cfg["dim"] // h
    width, rows = ENGINE_REQ_BLOCKS, ENGINE["new"]
    n_cache = width + 16
    table = torch.randperm(n_cache, generator=g, device="cuda")[:width].to(torch.int32)
    tables = table[None].expand(rows, width).contiguous()
    lens_list = list(range(ENGINE["keep"] + 1, ENGINE["keep"] + rows + 1))
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q = torch.randn((rows, h, d), generator=g, device="cuda").to(dtype)
        kc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(dtype)
        vc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(dtype)
        args = (q, kc, vc, tables, lens)
        got = pa.paged_decode_attention_batched(*args)
        again = pa.paged_decode_attention_batched(*args)
        err = max_err(got, pa.paged_decode_attention_plain_batched(*args))
        torch.cuda.synchronize()
        if not err <= tol or not torch.equal(got, again):
            raise AssertionError(f"K3 {dtype} at prefill_continue's shape: max abs err {err} "
                                 f"(tol {tol}), two launches equal {torch.equal(got, again)}")
        log(f"K3 {dtype} at prefill_continue's shape: max abs err {err:.3e} (tol {tol}); two "
            "launches bitwise equal")
    bms, by = _decode_bound(torch, q, -(-lens_list[-1] // bt), lens_list, bt, kvh,
                            tables.numel() * 4 + rows * 4)
    row = dict(max_abs_err=err, ms=timer.ms(lambda: pa.paged_decode_attention_batched(*args)),
               plain_ms=timer.ms(lambda: pa.paged_decode_attention_plain_batched(*args),
                                 iters=3),
               bound_ms=bms, bound_by=by)
    log(f"K3 bf16 at prefill_continue's shape ({rows} rows sharing one {width}-block table, "
        f"contexts {lens_list[0]}-{lens_list[-1]}): {json.dumps(row)}; "
        f"{bms / row['ms']:.3f} of its bound")
    return row


def _engine_wave_check(torch, timer, g, pa):
    """K6 at the engine's own wave (the one ``_profile_wave`` profiles): 4
    requests, each an 8-token verification chunk at 1,024 tokens of
    context, the rows of a chunk sharing their pages. Against its plain
    version in f32 (1e-5) and bf16 (2e-2), bitwise K3 per row, two launches
    bitwise equal; in bf16 timed, with its wrapper host time and its bound
    over the distinct pages."""
    import numpy as np

    cfg = LLAMA3_8B
    bt, kvh, h = cfg["block_tokens"], cfg["n_kv_heads"], cfg["n_heads"]
    d = cfg["dim"] // h
    width = ENGINE_REQ_BLOCKS
    n_cache = 4 * width + 16
    req_tables = np.random.default_rng(6).permutation(n_cache)[: 4 * width].astype(
        np.int32).reshape(4, width)
    ctx = ENGINE["shared"] + ENGINE["tail"]
    lens = [ctx + j for _ in range(4) for j in range(8)]
    row_tables = [req_tables[r // 8] for r in range(len(lens))]
    m = pa.build_ragged_wave(row_tables, lens, bt, pad_to_pow2=True)
    meta = [torch.from_numpy(x).cuda() for x in (m.pages, m.page_rows, m.page_starts,
                                                   m.seq_lens)]
    rows_k3 = pa._ragged_row_tables(meta[0], meta[2], width).contiguous()
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q = torch.randn((len(lens), h, d), generator=g, device="cuda").to(dtype)
        kc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(dtype)
        vc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(dtype)

        def run():
            return pa.paged_decode_attention_ragged(q, kc, vc, *meta, table_width=width)

        def plain():
            return pa.paged_decode_attention_ragged_plain(q, kc, vc, meta[0], meta[2],
                                                          meta[3], width)

        got, again = run(), run()
        k3 = pa.paged_decode_attention_batched(q, kc, vc, rows_k3, meta[3])
        err = max_err(got, plain())
        torch.cuda.synchronize()
        if not err <= tol or not torch.equal(got, again) or not torch.equal(got, k3):
            raise AssertionError(f"K6 {dtype} at the engine's wave: max abs err {err} (tol "
                                 f"{tol}), two launches equal {torch.equal(got, again)}, "
                                 f"bitwise K3 {torch.equal(got, k3)}")
        log(f"K6 {dtype} at the engine's wave: max abs err {err:.3e} (tol {tol}); bitwise K3 "
            "per row, two launches bitwise equal")
    distinct = len({int(m.pages[m.page_starts[r] + j]) for r, n in enumerate(lens)
                    for j in range(-(-n // bt))})
    bms, by = _decode_bound(torch, q, distinct, lens, bt, kvh,
                            (m.num_pages + 3 * len(lens) + 1) * 4)
    row = dict(max_abs_err=err, ms=timer.ms(run), plain_ms=timer.ms(plain), bound_ms=bms,
               bound_by=by, host_us=host_us(torch, run))
    log(f"K6 bf16 at the engine's wave (4 x 8-token chunks at {ctx} tokens, {distinct} "
        f"distinct pages): {json.dumps(row)}; {bms / row['ms']:.3f} of its bound")
    return row


# K8's tolerances by q's dtype: against its plain version, the JAX package's
# contract (its kernel against the dequantise-then-decode reference); against
# K3 on q.float() over the f32-dequantised cache, 1e-5 plus, with bf16 q, the
# rounding of each f32 result to bf16 (2^-7 of the value).
K8_PLAIN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
K8_K3_RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}


def _k8_contract(torch, kq, pa, q, kd, ks, vd, vs, tables, lens, got, what):
    """K8's contract on its output ``got``: within ``K8_PLAIN_TOL`` of its
    plain version, within 1e-5 + ``K8_K3_RTOL`` x |K3| of K3 run on q.float()
    over the f32-dequantised cache, a second launch bitwise equal, each row
    bitwise its solo launch. Returns (the largest difference from the plain
    version, from K3)."""
    args = (q, kd, ks, vd, vs, tables, lens)
    plain = kq._quant_decode_plain(*args)
    k3 = pa.paged_decode_attention_batched(
        q.float(), kq.dequantize_kv(kd, ks), kq.dequantize_kv(vd, vs), tables, lens).to(q.dtype)
    again = kq.paged_decode_attention_quantized(*args)
    solo = [kq.paged_decode_attention_quantized(q[r:r + 1], kd, ks, vd, vs, tables[r:r + 1],
                                                lens[r:r + 1]) for r in range(q.shape[0])]
    _sync(torch, q.device)
    name = peak_dtype(q)
    err = max_err(got, plain)
    if not err <= K8_PLAIN_TOL[name]:
        raise AssertionError(f"{what}: K8 is {err} from its plain version "
                             f"(tol {K8_PLAIN_TOL[name]})")
    diff = (got.float() - k3.float()).abs()
    if not bool((diff <= 1e-5 + K8_K3_RTOL[name] * k3.float().abs()).all()):
        raise AssertionError(f"{what}: K8 is up to {float(diff.max())} from K3 over the "
                             f"dequantised cache (tol 1e-5 + {K8_K3_RTOL[name]} x |K3|)")
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two K8 launches differ")
    for r, one in enumerate(solo):
        if not torch.equal(one[0], got[r]):
            raise AssertionError(f"{what}: K8 row {r} differs from its solo launch")
    return err, float(diff.max())


def _quant_kernel_check(torch, timer, g, tables, waves, n_cache):
    """K8 at the int8 round trip's wave (4 requests at 2,048 tokens), each
    wave in f32 and bf16 q, held to ``_k8_contract``; a zero-length row
    gives zeros."""
    from infinistore_tpu_torch.cuda import kv_quant as kq
    from infinistore_tpu_torch.cuda import paged_attention as pa

    cfg = LLAMA3_8B
    bt, kvh, h = cfg["block_tokens"], cfg["n_kv_heads"], cfg["n_heads"]
    d = cfg["dim"] // h
    bsz = tables.shape[0]
    kd, ks = kq.quantize_kv(torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda"))
    vd, vs = kq.quantize_kv(torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda"))
    full = waves[0]
    out = None
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((bsz, h, d), generator=g, device="cuda").to(dtype)
        err = err3 = 0.0
        for lens in waves:
            got = kq.paged_decode_attention_quantized(q, kd, ks, vd, vs, tables, lens)
            e, e3 = _k8_contract(torch, kq, pa, q, kd, ks, vd, vs, tables, lens, got,
                                 f"quantized decode {dtype}")
            err, err3 = max(err, e), max(err3, e3)
        if float(got[-1].float().abs().max()) != 0.0:
            raise AssertionError("quantized decode: seq_len 0 must give zeros")
        name = peak_dtype(q)
        log(f"K8 {dtype}: max abs err {err:.3e} from its plain version (tol "
            f"{K8_PLAIN_TOL[name]}), {err3:.3e} from K3 over the dequantised cache (tol 1e-5 + "
            f"{K8_K3_RTOL[name]} x |K3|); two launches and solo rows bitwise equal")
        if dtype is torch.bfloat16:
            tokens = int(full.sum())
            nbytes = 2 * tokens * kvh * (d + 4) + 2 * q.numel() * q.element_size() + \
                tables.numel() * 4 + bsz * 4  # int8 data + f32 scales, q and out
            bms, by = bound_ms(nbytes, 4.0 * h * d * tokens, peak_dtype(q))
            args = (q, kd, ks, vd, vs, tables, full)
            out = dict(max_abs_err=err,
                       ms=timer.ms(lambda: kq.paged_decode_attention_quantized(*args)),
                       plain_ms=timer.ms(lambda: kq._quant_decode_plain(*args)),
                       bound_ms=bms, bound_by=by, library_ms=None)
    return out


def _stats_kernel_check(torch, timer, g, tables, waves, n_cache, nomerge):
    """K5 at K3's wave: against its plain statistics, its one-shard combine
    bitwise K3, the combine of 4 disjoint slices of each row's pages within
    1e-5 of K3 (f32). Timed at the sharded decode's one request of
    ``SHARDED_CONTEXT`` tokens (one-shard combine bitwise K3 there too), and
    there also through ``nomerge`` (K5's entry built with its cross-split
    merge compiled out, swapped in under the wrapper): the fold's time,
    ``fold_ms``."""
    from infinistore_tpu_torch.cuda import decode_probe
    from infinistore_tpu_torch.cuda import paged_attention as pa

    cfg = LLAMA3_8B
    bt, kvh, h = cfg["block_tokens"], cfg["n_kv_heads"], cfg["n_heads"]
    d = cfg["dim"] // h
    bsz = tables.shape[0]
    ident = lambda t: t  # noqa: E731
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q = torch.randn((bsz, h, d), generator=g, device="cuda").to(dtype)
        kc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(dtype)
        vc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(dtype)
        err = err4 = 0.0
        for lens in waves:
            stats = pa._decode_attention_stats(q, kc, vc, tables, lens)
            err = max(err, _stats_err(torch, stats, pa.decode_attention_stats_plain(
                q, kc, vc, tables, lens)))
            k3 = pa.paged_decode_attention_batched(q, kc, vc, tables, lens)
            if not torch.equal(pa.combine_stats(*stats, dtype, ident, ident), k3):
                raise AssertionError(f"decode stats {dtype}: one-shard combine is not K3")
            if dtype is torch.float32:
                parts = [pa._decode_attention_stats(
                    q, kc, vc, tables[:, sl].contiguous(),
                    torch.tensor(_slice_lens(lens.tolist(), sl, bt), dtype=torch.int32,
                                 device="cuda"))
                    for sl in _slices(4, tables.shape[1])]
                acc4, m4, l4 = (torch.stack(x) for x in zip(*parts))
                combined = pa.combine_stats(acc4, m4, l4, dtype, lambda t: t.amax(0),
                                            lambda t: t.sum(0))
                err4 = max(err4, max_err(combined, k3))
            torch.cuda.synchronize()
        if not err <= tol or not err4 <= 1e-5:
            raise AssertionError(f"decode stats {dtype}: err {err} (tol {tol}), 4-slice "
                                 f"combine err {err4} (tol 1e-5)")
        log(f"K5 {dtype}: normalised max abs err {err:.3e} (tol {tol}); one-shard combine "
            f"bitwise K3" + (f"; 4-slice combine {err4:.3e} from K3" if dtype is torch.float32 else ""))

    # Timing at the sharded decode's shape: one request, SHARDED_CONTEXT tokens.
    tokens = SHARDED_CONTEXT
    q = torch.randn((1, h, d), generator=g, device="cuda").to(torch.bfloat16)
    kc = torch.randn((tokens // bt, bt, kvh, d), generator=g, device="cuda").to(torch.bfloat16)
    vc = torch.randn((tokens // bt, bt, kvh, d), generator=g, device="cuda").to(torch.bfloat16)
    table = torch.randperm(tokens // bt, generator=g, device="cuda").to(torch.int32)[None]
    lens = torch.tensor([tokens], dtype=torch.int32, device="cuda")
    args = (q, kc, vc, table, lens)
    stats = pa._decode_attention_stats(*args)
    err = _stats_err(torch, stats, pa.decode_attention_stats_plain(*args))
    if not err <= 2e-2:
        raise AssertionError(f"decode stats at {tokens} tokens: max abs err {err}")
    if not torch.equal(pa.combine_stats(*stats, q.dtype, ident, ident),
                       pa.paged_decode_attention_batched(*args)):
        raise AssertionError(f"decode stats at {tokens} tokens: one-shard combine is not K3")
    nbytes = 2 * tokens * kvh * d * 2 + q.numel() * 2 + (h * d + 2 * h) * 4 + table.numel() * 4 + 4
    bms, by = bound_ms(nbytes, 4.0 * h * d * tokens, peak_dtype(q))
    row = dict(max_abs_err=err, ms=timer.ms(lambda: pa._decode_attention_stats(*args)),
               plain_ms=timer.ms(lambda: pa.decode_attention_stats_plain(*args), iters=3),
               bound_ms=bms, bound_by=by, library_ms=None)
    with decode_probe.using(nomerge):
        row["fold_ms"] = timer.ms(lambda: pa._decode_attention_stats(*args))
    log(f"K5 bf16 at {tokens} tokens: {row['ms']:.5f} ms; the fold alone (its merge compiled "
        f"out) {row['fold_ms']:.5f} ms, so about {row['ms'] - row['fold_ms']:.5f} ms (the "
        "difference) is the merge; one-shard combine bitwise K3")
    return row


def _stats_err(torch, stats, plain):
    """Largest difference of two sets of raw statistics, normalised (acc /
    l, the function they compute); m and l themselves must agree to 1e-5
    relative (f32 sums in another order)."""
    (acc, m, l), (acc_p, m_p, l_p) = stats, plain
    for a, b in ((m, m_p), (l, l_p)):
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"decode stats: m or l differ by {max_err(a, b)}")
    return max_err(acc / torch.clamp(l, min=1e-30), acc_p / torch.clamp(l_p, min=1e-30))


def _skewed_wave():
    """The kernel phase's skewed ragged wave at the engine's widths
    (``decode_probe.skewed_wave``): (per-row lens, per-row tables, table
    width, cache blocks)."""
    from infinistore_tpu_torch.cuda import decode_probe

    return decode_probe.skewed_wave(ENGINE_REQ_BLOCKS)


def _ragged_kernel_check(torch, timer, g, pa, nomerge):
    """K6 on a skewed wave at the engine phase's widths: against its plain
    version, bitwise against K3 per row, bitwise against solo launches. K7
    on the same wave: against its plain statistics, its one-shard combine
    bitwise K6, the combine of 4 disjoint slices of each row's pages within
    1e-5 of K6 (f32); in bf16 timed as it is, through ``nomerge`` (its
    entry built without the cross-split merge, swapped in under the
    wrapper: ``fold_ms``) and at the wave's first quarter-shard (each row's
    first 18 table entries, what one of 4 ranks folds: ``quarter_shard_ms``,
    held against its plain statistics, beside its own bound). Returns the two
    kernels' results."""
    from infinistore_tpu_torch.cuda import decode_probe

    cfg = LLAMA3_8B
    bt, kvh, h = cfg["block_tokens"], cfg["n_kv_heads"], cfg["n_heads"]
    d = cfg["dim"] // h
    lens, row_tables, width, n_cache = _skewed_wave()
    m = pa.build_ragged_wave(row_tables, lens, bt, pad_to_pow2=True)
    pages, page_rows, page_starts, seq = (
        torch.from_numpy(x).cuda() for x in (m.pages, m.page_rows, m.page_starts, m.seq_lens))
    rows_k3 = pa._ragged_row_tables(pages, page_starts, width).contiguous()
    read = {int(m.pages[m.page_starts[r] + j]) for r, n in enumerate(lens)
            for j in range(-(-n // bt))}
    out = out7 = None
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q = torch.randn((len(lens), h, d), generator=g, device="cuda").to(dtype)
        kc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(dtype)
        vc = torch.randn((n_cache, bt, kvh, d), generator=g, device="cuda").to(dtype)

        def run():
            return pa.paged_decode_attention_ragged(q, kc, vc, pages, page_rows, page_starts,
                                                    seq, table_width=width)

        def plain():
            return pa.paged_decode_attention_ragged_plain(q, kc, vc, pages, page_starts, seq,
                                                          width)

        got, want, again = run(), plain(), run()
        k3 = pa.paged_decode_attention_batched(q, kc, vc, rows_k3, seq)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if not err <= tol:
            raise AssertionError(f"ragged decode {dtype}: max abs err {err} > {tol}")
        if not torch.equal(got, again):
            raise AssertionError(f"ragged decode {dtype}: two launches differ")
        if float(got[2].float().abs().max()) != 0.0:
            raise AssertionError("ragged decode: seq_len 0 must give zeros")
        if not torch.equal(got, k3):
            raise AssertionError(f"ragged decode {dtype}: rows differ from K3 on their tables")
        for r in range(len(lens)):
            solo = pa.build_ragged_wave([row_tables[r]], [lens[r]], bt)
            one = pa.paged_decode_attention_ragged(
                q[r : r + 1].contiguous(), kc, vc, *(torch.from_numpy(x).cuda() for x in (
                    solo.pages, solo.page_rows, solo.page_starts, solo.seq_lens)),
                table_width=width)
            torch.cuda.synchronize()
            if not torch.equal(one[0], got[r]):
                raise AssertionError(f"ragged decode {dtype}: row {r} differs from its solo launch")
        log(f"K6 {dtype}: max abs err {err:.3e} (tol {tol}); bitwise K3 per row and solo per "
            "row, two launches bitwise equal; "
            f"{m.num_pages} pages ({m.pad_pages} pad), {len(read)} distinct read")
        err7 = _ragged_stats_check(torch, pa, q, kc, vc, (pages, page_rows, page_starts, seq),
                                   got, lens, row_tables, width, tol)
        if dtype is torch.bfloat16:
            meta_bytes = (m.num_pages + 3 * len(lens) + 1) * 4
            kv_bytes = 2 * len(read) * bt * kvh * d * q.element_size()
            flops = 4.0 * h * d * sum(lens)
            bms, by = bound_ms(kv_bytes + 2 * q.numel() * q.element_size() + meta_bytes, flops,
                               peak_dtype(q))
            out = dict(max_abs_err=err, ms=timer.ms(run), plain_ms=timer.ms(plain),
                       bound_ms=bms, bound_by=by, library_ms=None,
                       host_us=host_us(torch, run))
            log(f"K6 bf16 on the skewed wave: {bms / out['ms']:.3f} of its bound; wrapper host "
                f"time {out['host_us']:.1f} us per call")
            stats_args = (q, kc, vc, pages, page_rows, page_starts, seq, width)
            # K7 writes f32 acc [R, H, D] and m, l [R, H] where K6 writes q's dtype.
            out_bytes = q.numel() * 4 + 2 * len(lens) * h * 4
            bms, by = bound_ms(kv_bytes + q.numel() * q.element_size() + out_bytes + meta_bytes,
                               flops, peak_dtype(q))
            out7 = dict(max_abs_err=err7,
                        ms=timer.ms(lambda: pa._decode_attention_stats_ragged(*stats_args)),
                        plain_ms=timer.ms(lambda: pa.decode_attention_stats_ragged_plain(
                            q, kc, vc, pages, page_starts, seq, width)),
                        bound_ms=bms, bound_by=by, library_ms=None)
            with decode_probe.using(nomerge):
                out7["fold_ms"] = timer.ms(
                    lambda: pa._decode_attention_stats_ragged(*stats_args))
            sl = _slices(4, width)[0]
            qlens = _slice_lens(lens, sl, bt)
            qp, qr, qs, ql, qw = pa.build_ragged_wave_sharded(
                [[t[sl] for t in row_tables]], [qlens], bt)
            quarter = (q, kc, vc, *(torch.from_numpy(x[0]).cuda() for x in (qp, qr, qs, ql)),
                       qw)
            errq = _stats_err(torch, pa._decode_attention_stats_ragged(*quarter),
                              pa.decode_attention_stats_ragged_plain(*quarter[:4],
                                                                     *quarter[5:]))
            if not errq <= tol:
                raise AssertionError(f"K7 bf16 at the first quarter-shard: err {errq} "
                                     f"(tol {tol})")
            qread = {int(qp[0][qs[0][r] + j]) for r, n in enumerate(qlens)
                     for j in range(-(-n // bt))}
            qbms, _ = bound_ms(2 * len(qread) * bt * kvh * d * q.element_size() +
                               q.numel() * q.element_size() + out_bytes +
                               (qp[0].shape[0] + 3 * len(lens) + 1) * 4,
                               4.0 * h * d * sum(qlens), peak_dtype(q))
            out7.update(quarter_shard_ms=timer.ms(
                lambda: pa._decode_attention_stats_ragged(*quarter)),
                quarter_shard_max_abs_err=errq, quarter_shard_bound_ms=qbms)
            log(f"K7 bf16 on the skewed wave: {out7['ms']:.5f} ms; the fold alone (its merge "
                f"compiled out) {out7['fold_ms']:.5f} ms, so about "
                f"{out7['ms'] - out7['fold_ms']:.5f} ms (the difference) is the split merge; "
                f"{out7['quarter_shard_ms']:.5f} ms at its first quarter-shard ({qw}-page "
                f"tables; normalised max abs err {errq:.3e}, tol {tol}; bound {qbms:.5f} ms)")
    return out, out7


def _ragged_stats_check(torch, pa, q, kc, vc, meta, k6, lens, row_tables, width, tol):
    """K7 on one wave: against its plain statistics, its one-shard combine
    bitwise K6 (``k6``), and in f32 the combine of 4 disjoint slices of each
    row's pages (one ragged wave per slice) within 1e-5 of K6. Returns the
    normalised error against the plain statistics."""
    bt = kc.shape[1]
    dtype = q.dtype
    pages, page_rows, page_starts, seq = meta
    ident = lambda t: t  # noqa: E731
    stats = pa._decode_attention_stats_ragged(q, kc, vc, pages, page_rows, page_starts, seq,
                                              width)
    err = _stats_err(torch, stats, pa.decode_attention_stats_ragged_plain(
        q, kc, vc, pages, page_starts, seq, width))
    if not torch.equal(pa.combine_stats(*stats, dtype, ident, ident), k6):
        raise AssertionError(f"ragged stats {dtype}: one-shard combine is not K6")
    err4 = 0.0
    if dtype is torch.float32:
        cuts = _slices(4, width)
        sp, srows, sstarts, slens, swidth = pa.build_ragged_wave_sharded(
            [[t[sl] for t in row_tables] for sl in cuts],
            [_slice_lens(lens, sl, bt) for sl in cuts], bt)
        parts = [pa._decode_attention_stats_ragged(q, kc, vc, sp[s], srows[s], sstarts[s],
                                                   slens[s], swidth) for s in range(4)]
        acc4, m4, l4 = (torch.stack(x) for x in zip(*parts))
        err4 = max_err(pa.combine_stats(acc4, m4, l4, dtype, lambda t: t.amax(0),
                                        lambda t: t.sum(0)), k6)
    torch.cuda.synchronize()
    if not err <= tol or not err4 <= 1e-5:
        raise AssertionError(f"ragged stats {dtype}: err {err} (tol {tol}), 4-slice combine "
                             f"err {err4} (tol 1e-5)")
    log(f"K7 {dtype}: normalised max abs err {err:.3e} (tol {tol}); one-shard combine bitwise "
        f"K6" + (f"; 4-slice combine {err4:.3e} from K6" if dtype is torch.float32 else ""))
    return err


# ---------------------------------------------------------------------------
# Phase 2: prefill -> store -> decode at Llama-3-8B width
# ---------------------------------------------------------------------------


def _client(lib_mod, config_mod, port):
    conn = lib_mod.InfinityConnection(config_mod.ClientConfig(
        host_addr="127.0.0.1", service_port=port, log_level="error",
    ))
    conn.connect()
    return conn


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _decode_wave(torch, llama, params, cfg, caches, tables, first_tokens, max_blocks,
                 prompt_tokens):
    """DECODE_STEPS greedy steps for the wave; returns per-step logits."""
    tokens = first_tokens.clone()
    out = []
    for step in range(DECODE_STEPS):
        positions = torch.full((tokens.shape[0],), prompt_tokens + step,
                               dtype=torch.int32, device=tokens.device)
        logits, caches = llama.decode_step_batched(
            params, tokens, positions, caches, tables, cfg, max_blocks)
        out.append(logits)
        tokens = logits.argmax(dim=-1)
    return out


def main_path(torch, server_port, device="cuda", geometry=LLAMA3_8B,
              prompt_tokens=PROMPT_TOKENS):
    """The main path on ``device`` (a CPU rehearsal passes a small
    ``geometry`` and ``device="cpu"``)."""
    import numpy as np

    from infinistore_tpu_torch import config as config_mod
    from infinistore_tpu_torch import lib as lib_mod
    from infinistore_tpu_torch.connector import KVConnector
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **geometry)
    bt = cfg.block_tokens
    nb = prompt_tokens // bt
    max_blocks = -(-(prompt_tokens + DECODE_STEPS) // bt)
    num_blocks = PROMPTS * max_blocks + 8
    spec = cfg.kv_spec(num_blocks)

    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    _sync(torch, device)
    n_params = sum(p.numel() for p in params.values())
    log(f"init_params: {n_params / 1e9:.3f} B parameters in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, prompt_tokens).tolist() for _ in range(PROMPTS)]
    tables_a = torch.arange(PROMPTS * max_blocks, dtype=torch.int32, device=device).reshape(PROMPTS, max_blocks)
    perm = torch.from_numpy(rng.permutation(num_blocks)[: PROMPTS * max_blocks].astype(np.int32))
    tables_b = perm.to(device).reshape(PROMPTS, max_blocks)

    conn_a = _client(lib_mod, config_mod, server_port)
    conn_b = _client(lib_mod, config_mod, server_port)
    kv_a = KVConnector(conn_a, spec, "llama-3-8b", max_blocks=nb, device=device)
    kv_b = KVConnector(conn_b, spec, "llama-3-8b", max_blocks=nb, device=device)
    try:
        caches_a = spec.make_caches(device)
        caches_b = spec.make_caches(device)

        # Engine A: prefill each prompt into its own blocks.
        first = []
        t0 = time.perf_counter()
        for p in range(PROMPTS):
            logits, caches_a = llama.prefill(params, prompts[p], caches_a, tables_a[p, :nb], cfg)
            first.append(logits.argmax())
        _sync(torch, device)
        prefill_ms = (time.perf_counter() - t0) * 1e3 / PROMPTS
        if not bool(torch.isfinite(logits.float()).all()) or logits.shape != (cfg.vocab,):
            raise AssertionError(f"prefill logits bad: shape {tuple(logits.shape)}")
        first_tokens = torch.stack(first)

        kv_bytes = PROMPTS * nb * spec.block_nbytes * 2 * cfg.n_layers
        t0 = time.perf_counter()
        for p in range(PROMPTS):
            written = asyncio.run(kv_a.save(prompts[p], caches_a, tables_a[p, :nb].cpu().numpy()))
            if written != 2 * nb * cfg.n_layers:
                raise AssertionError(f"save wrote {written} blocks")
        save_s = time.perf_counter() - t0
        store = conn_a.get_stats()
        store_bytes_per_key = store["used_bytes"] / store["kvmap_len"]

        # Engine B: look up and load into different block ids.
        for p in range(PROMPTS):
            hit = kv_b.lookup(prompts[p])
            if hit != nb:
                raise AssertionError(f"lookup of prompt {p} found {hit} blocks, expected {nb}")
        t0 = time.perf_counter()
        for p in range(PROMPTS):
            caches_b, n = asyncio.run(kv_b.load(prompts[p], caches_b, tables_b[p, :nb].cpu().numpy()))
            if n != nb:
                raise AssertionError(f"load of prompt {p} brought {n} blocks")
        _sync(torch, device)
        load_s = time.perf_counter() - t0

        for layer in range(cfg.n_layers):
            for kind in (0, 1):
                for p in range(PROMPTS):
                    a = caches_a[layer][kind][tables_a[p, :nb].long()]
                    b = caches_b[layer][kind][tables_b[p, :nb].long()]
                    if not torch.equal(a, b):
                        raise AssertionError(f"layer {layer} kind {kind} prompt {p}: loaded bytes differ")
        log("engine B holds engine A's blocks byte for byte")

        t0 = time.perf_counter()
        logits_b = _decode_wave(torch, llama, params, cfg, caches_b, tables_b, first_tokens,
                                max_blocks, prompt_tokens)
        _sync(torch, device)
        decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
        logits_a = _decode_wave(torch, llama, params, cfg, caches_a, tables_a, first_tokens,
                                max_blocks, prompt_tokens)
        _sync(torch, device)
        for step, (la, lb) in enumerate(zip(logits_a, logits_b)):
            if la.shape != (PROMPTS, cfg.vocab) or not bool(torch.isfinite(la.float()).all()):
                raise AssertionError(f"decode step {step}: bad logits {tuple(la.shape)}")
            if not torch.equal(la, lb):
                raise AssertionError(f"decode step {step}: engine B's logits differ from A's")
        log(f"decode: engines A and B agree bitwise over {DECODE_STEPS} steps")
        launches = dict(_ext.LAUNCHES)  # the main path's own launches, read here

        if torch.device(device).type == "cuda":
            profiles = {
                "prefill": _profile(torch, lambda: llama.prefill(
                    params, prompts[0], caches_a, tables_a[0, :nb], cfg)),
                "decode_step": _profile(torch, lambda: llama.decode_step_batched(
                    params, first_tokens, torch.full((PROMPTS,), prompt_tokens, dtype=torch.int32,
                                                     device=device),
                    caches_a, tables_a, cfg, max_blocks)),
            }
            for name, prof in profiles.items():
                log(f"profile {name}: {json.dumps(prof)}")
    finally:
        kv_a.close()
        kv_b.close()
        conn_a.close()
        conn_b.close()
    metrics = {
        "prefill_ms_per_prompt": prefill_ms,
        "save_GBps": kv_bytes / save_s / 1e9,
        "load_GBps": kv_bytes / load_s / 1e9,
        "decode_ms_per_step": decode_ms,
        "kv_bytes_moved": kv_bytes,
        "store_bytes_per_key": store_bytes_per_key,
    }
    # What the int8 round trip takes over: engine A's caches and tables.
    state = dict(cfg=cfg, spec=spec, prompts=prompts, nb=nb, caches_a=caches_a,
                 tables_a=tables_a, tables_b=tables_b, device=device, save_s=save_s,
                 load_s=load_s)
    return metrics, launches, params, state


# Device kernels by kind, matched on their names in this order: the port's
# own kernels, cuBLAS's GEMMs, copies (dtype casts, contiguous), reductions,
# and PyTorch's other elementwise kernels (norms, RoPE, activations, adds).
PROFILE_KINDS = (
    ("port_kernels", ("flash_prefill", "paged_decode", "bulk_copy", "vector_copy")),
    ("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
    ("copy", ("copy",)),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


def _profile(torch, fn):
    """One call of ``fn`` under torch.profiler: wall time, the device's busy
    time (the kernels' self time) and idle share, and the kernels that took
    the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels, copies): the host ops that launched
    # them carry the same time again.
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms in rows)
    rows.sort(key=lambda r: -r[1])
    by_kind = {}
    for name, ms in rows:
        kind = next((k for k, marks in PROFILE_KINDS if any(m in name for m in marks)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "busy_by_kind_ms": by_kind,
        "top_kernels_ms": {name[:80]: ms for name, ms in rows[:12]},
    }


# ---------------------------------------------------------------------------
# Phase 3: a small f32 model, kernels (card) against plain versions (CPU)
# ---------------------------------------------------------------------------


def small_model_phase(torch, server_port):
    import numpy as np

    from infinistore_tpu_torch import config as config_mod
    from infinistore_tpu_torch import lib as lib_mod
    from infinistore_tpu_torch.connector import KVConnector
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab=128, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=256, block_tokens=8, dtype=torch.float32)
    params_cpu = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, 32).tolist()
    nb, max_blocks = 4, 6
    spec = cfg.kv_spec(16)
    out = {}
    for device in ("cuda", "cpu"):
        params = {k: v.to(device) for k, v in params_cpu.items()}
        conn = _client(lib_mod, config_mod, server_port)
        kv = KVConnector(conn, spec, f"small-{device}", max_blocks=nb, device=device)
        try:
            table_a = torch.arange(max_blocks, dtype=torch.int32)
            table_b = torch.tensor([9, 3, 12, 5, 7, 1], dtype=torch.int32)
            logits, caches_a = llama.prefill(params, prompt, spec.make_caches(device), table_a[:nb], cfg)
            asyncio.run(kv.save(prompt, caches_a, table_a[:nb].numpy()))
            caches_b, n = asyncio.run(kv.load(prompt, spec.make_caches(device), table_b[:nb].numpy()))
            if n != nb:
                raise AssertionError(f"small model ({device}): loaded {n} blocks")
            steps = []
            token = int(logits.argmax())
            for i in range(4):
                step_logits, caches_b = llama.decode_step(
                    params, token, 32 + i, caches_b, table_b.to(device), cfg, max_blocks)
                steps.append(step_logits.cpu())
                token = int(step_logits.argmax())
            out[device] = torch.stack(steps)
        finally:
            kv.close()
            conn.close()
    err = max_err(out["cuda"], out["cpu"])
    if not err <= 2e-4:
        raise AssertionError(f"small f32 model: card vs CPU logits differ by {err} > 2e-4")
    log(f"small f32 model: card (kernels) vs CPU (plain) max abs err {err:.3e}")
    return err


# ---------------------------------------------------------------------------
# Phase 4: the int8 round trip at Llama-3-8B width
# ---------------------------------------------------------------------------


def int8_round_trip(torch, server_port, state, bf16_metrics):
    """Engine A's prefixes (``main_path``'s ``state``) quantised, saved
    through ``QuantizedKVConnector``, looked up and loaded into engine B's
    int8 caches, then decoded by K8 for every layer. Returns (metrics,
    launches); the launches are read before the comparisons run."""
    from infinistore_tpu_torch import config as config_mod
    from infinistore_tpu_torch import lib as lib_mod
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import kv_quant as kq
    from infinistore_tpu_torch.cuda import paged_attention as pa

    cfg, spec, prompts, nb = state["cfg"], state["spec"], state["prompts"], state["nb"]
    caches_a, tables_a, tables_b = state["caches_a"], state["tables_a"], state["tables_b"]
    device = state["device"]
    n_req = len(prompts)
    prompt_tokens = nb * cfg.block_tokens
    head_dim = cfg.dim // cfg.n_heads
    conn_a = _client(lib_mod, config_mod, server_port)
    conn_b = _client(lib_mod, config_mod, server_port)
    qa = kq.QuantizedKVConnector(conn_a, spec, "llama-3-8b", max_blocks=nb, device=device)
    qb = kq.QuantizedKVConnector(conn_b, spec, "llama-3-8b", max_blocks=nb, device=device)
    try:
        _ext.reset_launches()
        quant_a = [(kq.quantize_kv(k), kq.quantize_kv(v)) for k, v in caches_a]
        t0 = time.perf_counter()
        for p in range(n_req):
            written = asyncio.run(qa.save(prompts[p], quant_a, tables_a[p, :nb].cpu().numpy()))
            if written != 2 * nb * cfg.n_layers:
                raise AssertionError(f"int8 save wrote {written} data blocks")
        save_s = time.perf_counter() - t0
        store = conn_a.get_stats()
        for p in range(n_req):
            hit = qb.lookup(prompts[p])
            if hit != nb:
                raise AssertionError(f"int8 lookup of prompt {p} found {hit} blocks, expected {nb}")
        quant_b = [
            tuple((torch.zeros(spec.cache_shape, dtype=torch.int8, device=device),
                   torch.zeros(spec.cache_shape[:-1], dtype=torch.float32, device=device))
                  for _ in range(2))
            for _ in range(cfg.n_layers)
        ]
        t0 = time.perf_counter()
        for p in range(n_req):
            quant_b, n = asyncio.run(qb.load(prompts[p], quant_b, tables_b[p, :nb].cpu().numpy()))
            if n != nb:
                raise AssertionError(f"int8 load of prompt {p} brought {n} blocks")
        _sync(torch, device)
        load_s = time.perf_counter() - t0

        # K8 over engine B's int8 caches, one seeded bf16 query wave a layer.
        g = torch.Generator(device=device).manual_seed(7)
        lens = torch.full((n_req,), prompt_tokens, dtype=torch.int32, device=device)
        qs = [torch.randn((n_req, cfg.n_heads, head_dim), generator=g, device=device)
              .to(torch.bfloat16) for _ in range(cfg.n_layers)]
        outs = [kq.paged_decode_attention_quantized(qs[layer], *quant_b[layer][0],
                                                    *quant_b[layer][1], tables_b, lens)
                for layer in range(cfg.n_layers)]
        _sync(torch, device)
        launches = dict(_ext.LAUNCHES)  # the path's own launches, read here
    finally:
        qa.close()
        qb.close()
        conn_a.close()
        conn_b.close()

    for layer in range(cfg.n_layers):
        for side in (0, 1):
            for part in (0, 1):
                for p in range(n_req):
                    a = quant_a[layer][side][part][tables_a[p, :nb].long()]
                    b = quant_b[layer][side][part][tables_b[p, :nb].long()]
                    if not torch.equal(a, b):
                        raise AssertionError(f"int8 layer {layer} side {side} part {part} prompt "
                                             f"{p}: loaded bytes differ")
    log("int8: engine B holds engine A's int8 data and scales byte for byte")
    scheme_err = plain_err = k3_err = 0.0
    for layer in range(cfg.n_layers):
        (kd, ks), (vd, vs) = quant_b[layer]
        out = outs[layer]
        if out.shape != (n_req, cfg.n_heads, head_dim) or not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"int8 decode layer {layer}: bad output {tuple(out.shape)}")
        e, e3 = _k8_contract(torch, kq, pa, qs[layer], kd, ks, vd, vs, tables_b, lens, out,
                             f"int8 decode layer {layer}")
        plain_err, k3_err = max(plain_err, e), max(k3_err, e3)
        ref = pa.paged_decode_attention_batched(qs[layer], *caches_a[layer], tables_a, lens)
        scheme_err = max(scheme_err, max_err(out, ref))
    if not scheme_err <= 2e-2:
        raise AssertionError(f"int8 decode: {scheme_err} from K3 over the bf16 cache (tol 2e-2)")
    log(f"int8 decode: K8 within {plain_err:.3e} of its plain version and {k3_err:.3e} of K3 "
        f"over the dequantised cache in all {cfg.n_layers} layers, two launches and solo rows "
        f"bitwise equal; largest difference from K3 over the bf16 cache {scheme_err:.3e}")
    data_bytes = n_req * nb * cfg.n_layers * 2 * (qa.data.spec.block_nbytes
                                                 + qa.scales.spec.block_nbytes)
    metrics = {
        "save_GBps": data_bytes / save_s / 1e9,
        "load_GBps": data_bytes / load_s / 1e9,
        "kv_bytes_moved": data_bytes,
        "store_keys": store["kvmap_len"],
        "store_used_bytes": store["used_bytes"],
        "store_bytes_per_key": store["used_bytes"] / store["kvmap_len"],
        "store_bytes_per_block_and_side": store["used_bytes"] / (store["kvmap_len"] // 2),
        "bf16_store_bytes_per_block_and_side": bf16_metrics["store_bytes_per_key"],
        "bf16_save_GBps": bf16_metrics["save_GBps"],
        "bf16_load_GBps": bf16_metrics["load_GBps"],
        "max_abs_err_vs_bf16_cache": scheme_err,
        "max_abs_err_vs_plain": plain_err,
        "max_abs_err_vs_k3_dequantised": k3_err,
    }
    return metrics, launches


# ---------------------------------------------------------------------------
# Phases 5 to 7: the continuous-batching engine
# ---------------------------------------------------------------------------


def _engine_rounds(rng, vocab, traffic):
    """Two rounds of 4 prompts (see the module docstring)."""
    shared, tail, span = traffic["shared"], traffic["tail"], traffic["span"]
    keep, new = traffic["keep"], traffic["new"]
    prefix = rng.integers(0, vocab, shared).tolist()
    round1 = []
    for _ in range(4):
        t = rng.integers(0, vocab, tail).tolist()
        rep = t[:span]
        t[tail - span:] = rep  # the span occurs twice; the prompt ends on it
        round1.append(prefix + t)
    round2 = [p[:keep] + rng.integers(0, vocab, new).tolist() for p in round1]
    return round1, round2


async def _serve(h, prompts, gen):
    """Concurrency 4; the requests' stats in prompt order, the wall time."""
    sem = asyncio.Semaphore(4)

    async def one(p):
        async with sem:
            return await h.run_request(p, gen_tokens=gen)

    t0 = time.perf_counter()
    stats = await asyncio.gather(*(one(p) for p in prompts))
    return stats, time.perf_counter() - t0


def _run_engine(torch, server_port, params, cfg, device, model_id, traffic, num_blocks,
                req_blocks, verify_tol, quantized=False):
    """Both rounds on one harness, from one event loop; returns per-round
    (metrics, stats, wall seconds, waves in the round), the harness (its wave
    and speculation counters span both rounds), and the store's occupancy
    after both rounds. ``quantized``: the harness runs over
    ``QuantizingKVAdapter`` (int8 + scales in the store) and its second
    round is verified within ``_int8_verify_tol``."""
    import numpy as np

    from infinistore_tpu_torch import config as config_mod
    from infinistore_tpu_torch import lib as lib_mod
    from infinistore_tpu_torch.connector import KVConnector
    from infinistore_tpu_torch.cuda.kv_quant import QuantizedKVConnector, QuantizingKVAdapter
    from infinistore_tpu_torch.engine import (
        ContinuousBatchingHarness, EngineKVAdapter, NGramDrafter,
    )

    rounds = _engine_rounds(np.random.default_rng(3), cfg.vocab, traffic)
    conn = _client(lib_mod, config_mod, server_port)
    if quantized:
        # The adapter's staging rows: one request's blocks.
        kv = QuantizedKVConnector(conn, cfg.kv_spec(req_blocks), model_id,
                                  max_blocks=req_blocks, device=device)
        adapter = QuantizingKVAdapter(kv)
    else:
        kv = KVConnector(conn, cfg.kv_spec(num_blocks), model_id, max_blocks=req_blocks,
                         device=device)
        adapter = EngineKVAdapter(kv)
    try:
        h = ContinuousBatchingHarness(
            adapter, params, cfg, num_blocks, req_blocks, verify=True,
            verify_tol=verify_tol, drafter=NGramDrafter(max_draft=7), device=device,
        )

        async def drive():
            out = []
            for i, prompts in enumerate(rounds):
                if quantized and i == 1:
                    h.verify_tol = _int8_verify_tol(torch, h.caches, verify_tol)
                h.stats.clear()
                waves0 = h.wave.waves
                stats, wall = await _serve(h, prompts, traffic["gen"])
                _sync(torch, device)
                out.append((h.metrics(), stats, wall, h.wave.waves - waves0))
            return out

        results = asyncio.run(drive())
        store = conn.get_stats()
        return results, h, {"used_bytes": store["used_bytes"], "keys": store["kvmap_len"]}
    finally:
        kv.close()
        conn.close()


def _int8_verify_tol(torch, caches, base_tol):
    """The verification tolerance of requests whose prefix came back from
    int8: ``base_tol`` (the float path's own) plus two quantization steps of
    the largest vector in the cache. quantize_kv's per-element error is at
    most half a step, absmax / 254 (tests/test_kv_quant.py:36-38), and no
    vector's absmax exceeds the largest value in the cache, read here from
    the blocks the first round computed exactly: that bounds a hit's loaded
    blocks. The suffix resumed over them carries the error through the
    attention, which the scheme does not bound: on the repo's small f32
    models on the CPU (2 and 8 layers, tests/test_torch_kv_quant.py) it
    reached 1.1 steps in the first layer above the prefix and fell off
    deeper. Two steps cover both with room; a wrong or stale block differs
    by O(1). Used as both rtol and atol, as ``base_tol`` is."""
    absmax = max(float(c.abs().max()) for pair in caches for c in pair)
    return base_tol + 2.0 * absmax / 127.0


def _check_rounds(results, traffic, bt, what):
    hit_blocks = traffic["keep"] // bt
    for i, (m, stats, _, _) in enumerate(results):
        if not m["all_verified"]:
            raise AssertionError(f"{what} round {i + 1}: a request's blocks failed verification")
        if any(len(s.generated) != traffic["gen"] for s in stats):
            raise AssertionError(f"{what} round {i + 1}: not {traffic['gen']} tokens per request")
    if results[1][0]["loaded_blocks"] != 4 * hit_blocks:
        raise AssertionError(f"{what} round 2 loaded {results[1][0]['loaded_blocks']} blocks, "
                             f"expected {4 * hit_blocks}")
    last = results[-1][0]
    if last["max_wave_size"] < 2 or last["spec_drafted_tokens"] <= 0:
        raise AssertionError(f"{what}: waves never mixed requests or the drafter never proposed "
                             f"(max_wave_size {last['max_wave_size']}, drafted "
                             f"{last['spec_drafted_tokens']})")


def _engine_summary(results, h, store, smi):
    summary = {"card": smi}
    for i, (m, stats, wall, waves) in enumerate(results):
        summary[f"round{i + 1}"] = {
            "p50_ttft_us": m["p50_ttft_us"],
            "p99_ttft_us": m["p99_ttft_us"],
            "p50_prefix_ready_hit_us": m["p50_prefix_ready_hit_us"],
            "p50_prefix_ready_miss_us": m["p50_prefix_ready_miss_us"],
            "decode_waves": waves,
            "generated_tokens_per_s": m["generated_tokens"] / wall,
            "wall_s": wall,
            "loaded_blocks": m["loaded_blocks"],
            "computed_blocks": m["computed_blocks"],
            "max_wave_size": m["max_wave_size"],
        }
    # Wave and speculation counters over both rounds.
    last = results[-1][0]
    summary["wave_pad_fraction"] = last["wave_pad_fraction"]
    summary["spec_tokens_per_step"] = sum(m["generated_tokens"] for m, *_ in results) / h.spec_rounds
    summary["spec_drafted_tokens"] = last["spec_drafted_tokens"]
    summary["spec_accepted_tokens"] = last["spec_accepted_tokens"]
    summary["wave_buckets"] = len(last["wave_buckets"])
    summary["store_used_bytes"] = store["used_bytes"]
    summary["store_keys"] = store["keys"]
    return summary


def engine_phase(torch, server_port, params, smi):
    """Phase 5: Llama-3-8B width, bf16, on the card. Returns (launches,
    summary)."""
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **LLAMA3_8B)
    _ext.reset_launches()
    results, h, store = _run_engine(torch, server_port, params, cfg, "cuda", "llama-3-8b-engine",
                                    ENGINE, ENGINE_BLOCKS, ENGINE_REQ_BLOCKS, ENGINE_VERIFY_TOL)
    launches = dict(_ext.LAUNCHES)
    _check_rounds(results, ENGINE, cfg.block_tokens, "engine phase")
    log(f"engine phase all_verified (bf16 verify_tol {ENGINE_VERIFY_TOL}, rtol = atol) "
        f"in both rounds; round 2 loaded {results[1][0]['loaded_blocks']} blocks")
    summary = _engine_summary(results, h, store, smi)
    log(f"engine phase: {json.dumps(summary)}")
    log(f"profile engine wave: {json.dumps(_profile_wave(torch, h, cfg))}")
    log(f"engine phase launches: {json.dumps(launches)}")
    return launches, summary


def _profile_wave(torch, h, cfg):
    """One mixed wave like round 1's first (4 requests at 1,024 tokens of
    context, each an 8-token verification chunk) under torch.profiler, on
    the harness's own cache once the rounds are done (the blocks it writes
    are free)."""
    from infinistore_tpu_torch.cuda.paged_attention import build_ragged_wave
    from infinistore_tpu_torch.models import llama

    import numpy as np

    mrb = ENGINE_REQ_BLOCKS
    tables = np.arange(4 * mrb, dtype=np.int32).reshape(4, mrb)
    ctx = ENGINE["shared"] + ENGINE["tail"]
    pos = [ctx - 1 + j for _ in range(4) for j in range(8)]
    row_of = [r for r in range(4) for _ in range(8)]
    meta = build_ragged_wave([tables[r] for r in row_of], [p + 1 for p in pos],
                             cfg.block_tokens, pad_to_pow2=True)
    toks = [7] * len(pos)
    return _profile(torch, lambda: llama.verify_step_ragged(
        h.params, toks, pos, row_of, meta.pages, meta.page_rows, meta.page_starts, h.caches,
        tables, cfg, mrb))


def int8_engine_phase(torch, server_port, params, smi, bf16_summary):
    """Phase 6: the engine phase's rounds through QuantizingKVAdapter."""
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **LLAMA3_8B)
    _ext.reset_launches()
    results, h, store = _run_engine(torch, server_port, params, cfg, "cuda",
                                    "llama-3-8b-int8-engine", ENGINE, ENGINE_BLOCKS,
                                    ENGINE_REQ_BLOCKS, ENGINE_VERIFY_TOL, quantized=True)
    launches = dict(_ext.LAUNCHES)
    _check_rounds(results, ENGINE, cfg.block_tokens, "int8 engine phase")
    summary = _engine_summary(results, h, store, smi)
    summary["round2_verify_tol"] = h.verify_tol
    log(f"int8 engine phase all_verified (round 1 tol {ENGINE_VERIFY_TOL}, round 2 tol "
        f"{h.verify_tol:.4f}, rtol = atol); round 2 loaded {results[1][0]['loaded_blocks']} "
        "blocks")
    log(f"int8 engine phase: {json.dumps(summary)}")
    side = {}
    for key in ("p50_ttft_us", "p50_prefix_ready_hit_us", "p50_prefix_ready_miss_us",
                "generated_tokens_per_s"):
        for rnd in ("round1", "round2"):
            side[f"{rnd}.{key}"] = {"bf16": bf16_summary[rnd][key], "int8": summary[rnd][key]}
    side["store_used_bytes"] = {"bf16": bf16_summary["store_used_bytes"],
                                "int8": summary["store_used_bytes"]}
    log(f"engine bf16 vs int8 store: {json.dumps(side)}")
    log(f"int8 engine phase launches: {json.dumps(launches)}")
    return launches


def small_engine_phase(torch, server_port):
    """Phase 7: the same traffic scaled down, f32, card against CPU, through
    the plain adapter and through the quantizing one."""
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab=128, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=256, block_tokens=8, dtype=torch.float32)
    params_cpu = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for quantized in (False, True):
        what = "small int8 engine" if quantized else "small engine"
        tokens = {}
        for device in ("cuda", "cpu"):
            params = {k: v.to(device) for k, v in params_cpu.items()}
            results, _, _ = _run_engine(
                torch, server_port, params, cfg, device,
                f"small-engine-{'q8-' if quantized else ''}{device}", SMALL_ENGINE, 64, 12, 2e-4,
                quantized=quantized)
            _check_rounds(results, SMALL_ENGINE, cfg.block_tokens, f"{what} ({device})")
            tokens[device] = [[s.generated for s in stats] for _, stats, _, _ in results]
        if not quantized and tokens["cuda"] != tokens["cpu"]:
            raise AssertionError(f"{what}: the card's generated tokens differ from the CPU's")
        if quantized and tokens["cuda"][0] != tokens["cpu"][0]:
            raise AssertionError(f"{what}: the card's round-1 tokens differ from the CPU's")
        pairs = [(a, b) for rc, rp in zip(tokens["cuda"][1], tokens["cpu"][1])
                 for a, b in zip(rc, rp)]
        same = sum(a == b for a, b in pairs) / len(pairs)
        log(f"{what}: card (kernels) and CPU (plain) all verified; round 1 tokens identical, "
            f"round 2 {same:.3f} of tokens identical")


# ---------------------------------------------------------------------------
# Phase 8: sharded decode on a process group of one rank
# ---------------------------------------------------------------------------


def sharded_decode_phase(torch, device="cuda", backend="nccl", geometry=LLAMA3_8B,
                         tokens=SHARDED_CONTEXT):
    """Both sharded entry points on a process group of world size 1 (the
    card's only rank), initialised from a FileStore: one request over
    ``SHARDED_CONTEXT`` tokens of one layer, and the kernel phase's skewed
    wave. Returns the path's launches, read before the comparisons (K3 and
    K6 over the same caches, which the one-shard combine must equal
    bitwise). A CPU rehearsal passes device="cpu", backend="gloo" and a small
    ``geometry`` and ``tokens``."""
    import datetime
    import tempfile

    import torch.distributed as dist

    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.cuda import paged_attention as pa

    bt, kvh, h = geometry["block_tokens"], geometry["n_kv_heads"], geometry["n_heads"]
    d = geometry["dim"] // h
    g = torch.Generator(device=device).manual_seed(99)

    def randn(shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    q = randn((h, d))
    kc, vc = randn((tokens // bt, bt, kvh, d)), randn((tokens // bt, bt, kvh, d))
    table = torch.randperm(tokens // bt, generator=g, device=device).to(torch.int32)
    lens, row_tables, width, n_cache = _skewed_wave()
    rq = randn((len(lens), h, d))
    rkc, rvc = randn((n_cache, bt, kvh, d)), randn((n_cache, bt, kvh, d))
    pages, rows, starts, slens, swidth = pa.build_ragged_wave_sharded([row_tables], [lens], bt)
    if backend == "nccl":
        # Loopback for NCCL's bootstrap; a caller's own setting wins.
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/filestore", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            _ext.reset_launches()
            one = pa.paged_decode_attention_sharded(q, kc, vc, table, tokens)
            wave = pa.paged_decode_attention_ragged_sharded(
                rq, rkc, rvc, pages[0], rows[0], starts[0], slens[0], table_width=swidth)
            _sync(torch, device)
            launches = dict(_ext.LAUNCHES)  # the path's own launches, read here
        finally:
            dist.destroy_process_group()
    k3 = pa.paged_decode_attention_batched(
        q[None], kc, vc, table[None],
        torch.tensor([tokens], dtype=torch.int32, device=device))[0]
    meta = [torch.from_numpy(x).to(device) for x in (pages[0], rows[0], starts[0], slens[0])]
    k6 = pa.paged_decode_attention_ragged(rq, rkc, rvc, *meta, table_width=swidth)
    _sync(torch, device)
    for what, got, want in (("sharded decode", one, k3), ("ragged sharded decode", wave, k6)):
        if got.shape != want.shape or not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"{what}: bad output {tuple(got.shape)}")
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: the one-rank combine is not bitwise the unsharded "
                                 f"kernel (max abs diff {max_err(got, want)})")
    log(f"sharded decode ({backend}, world size 1): {tokens}-token request and the "
        f"{len(lens)}-row skewed wave bitwise K3 / K6; the multi-rank combine is held only "
        "on the CPU (4 gloo ranks, tests/test_torch_sharded_decode.py) and over 4 slices in "
        "the kernel phase, since one card has no second rank")
    return launches


# ---------------------------------------------------------------------------


def _build_all(torch):
    """Compile the kernels (nvcc) while the native store library builds
    (g++, at its first import), and K5's and K7's source with the split
    merge compiled out (``-DITS_DECODE_NOMERGE``, as ``cuda/decode_probe.py``
    builds it, for the fold's time); all must succeed. Returns the latter
    library."""
    from infinistore_tpu_torch.cuda import _ext, decode_probe

    errors = []

    def build_kernels():
        try:
            _ext.kernels()
        except BaseException as exc:  # re-raised on the main thread below
            errors.append(exc)

    t0 = time.perf_counter()
    nomerge = decode_probe.build("nomerge", ("paged_attention.cu", "paged_attention_stats.cu"),
                                 defines=(decode_probe.NOMERGE,))
    worker = threading.Thread(target=build_kernels)
    worker.start()
    from infinistore_tpu_torch import lib  # noqa: F401  (builds the native core)

    worker.join()
    if errors:
        raise errors[0]
    nomerge = decode_probe.load(nomerge)
    log(f"built the store library and the kernels in {time.perf_counter() - t0:.1f} s")
    return nomerge


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "infinistore_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    nomerge = _build_all(torch)
    from infinistore_tpu_torch import lib
    from infinistore_tpu_torch.cuda import _ext

    timer = _timing().Timer(torch)
    kernels = kernel_phase(torch, timer, nomerge)
    del timer
    torch.cuda.empty_cache()

    paths = {}
    server = lib.start_local_server(prealloc_bytes=2 << 30, block_bytes=32 << 10,
                                    pin_memory=False)
    try:
        _ext.reset_launches()
        metrics, paths["prefill_store_decode"], params, state = main_path(torch, server.port)
        log(f"main path: {json.dumps(metrics)}")
        log(f"main path launches: {json.dumps(paths['prefill_store_decode'])}")
        torch.cuda.empty_cache()
        small_model_phase(torch, server.port)
    finally:
        server.stop()

    # The int8 round trip takes over engine A's caches, with a store of its own.
    server = lib.start_local_server(prealloc_bytes=2 << 30, block_bytes=INT8_STORE_UNIT,
                                    pin_memory=False)
    try:
        int8_metrics, paths["int8_round_trip"] = int8_round_trip(torch, server.port, state,
                                                                 metrics)
        log(f"int8 round trip: {json.dumps(int8_metrics)}")
        log(f"int8 round trip launches: {json.dumps(paths['int8_round_trip'])}")
    finally:
        server.stop()
    del state

    # Each engine phase gets a fresh store; the main path's caches are gone,
    # its weights are reused.
    torch.cuda.empty_cache()
    server = lib.start_local_server(prealloc_bytes=2 << 30, block_bytes=32 << 10,
                                    pin_memory=False)
    try:
        paths["engine"], engine_summary = engine_phase(torch, server.port, params, smi)
    finally:
        server.stop()
    torch.cuda.empty_cache()
    server = lib.start_local_server(prealloc_bytes=2 << 30, block_bytes=32 << 10,
                                    pin_memory=False)
    try:
        paths["int8_engine"] = int8_engine_phase(torch, server.port, params, smi,
                                                 engine_summary)
        del params
        torch.cuda.empty_cache()
        small_engine_phase(torch, server.port)
    finally:
        server.stop()

    paths["sharded_decode"] = sharded_decode_phase(torch)
    log(f"sharded decode launches: {json.dumps(paths['sharded_decode'])}")

    for path, names in PATH_KERNELS.items():
        idle = [name for name in names if paths[path][name] == 0]
        if idle:
            raise AssertionError(f"kernels never launched on the {path} path: {idle}")
    # These paths are bf16 end to end: every K4 launch must be a tensor-core one.
    for path in BF16_K4_PATHS:
        k4, wgmma = paths[path]["flash_prefill"], paths[path]["flash_prefill_wgmma"]
        if wgmma == 0 or wgmma != k4:
            raise AssertionError(f"{path}: {k4} K4 launches but {wgmma} on the tensor cores")
    for path in BULK_COPY_PATHS:
        for name in ("gather_blocks", "scatter_blocks"):
            every, bulk = paths[path][name], paths[path][f"{name}_bulk"]
            if bulk != every:
                raise AssertionError(f"{path}: {every} {name} launches but {bulk} on the bulk ring")

    rows = []
    for name, (replaces, *sources) in TPU_KERNELS.items():
        row = {
            "name": name,
            "route": "cuda",
            "source": f"infinistore_tpu_torch/cuda/csrc/{sources[0]}",
            "replaces": replaces,
            # Every launch on the paths this script drives; per path below.
            "launches": sum(counts[name] for counts in paths.values()),
            "launches_by_path": {path: counts[name] for path, counts in paths.items()},
            "design": DESIGNS[name],
            **kernels[name],
        }
        if len(sources) > 1:
            row["sources"] = [f"infinistore_tpu_torch/cuda/csrc/{src}" for src in sources]
        if name == "flash_prefill":
            row["tensor_core_launches"] = sum(c["flash_prefill_wgmma"] for c in paths.values())
        if name in ("gather_blocks", "scatter_blocks"):
            row["bulk_launches"] = sum(c[f"{name}_bulk"] for c in paths.values())
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
