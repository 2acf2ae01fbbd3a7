#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``infinistore_tpu_torch``) on one
NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and ``g++``, and builds everything it runs
from the checkout: the store's native library (``g++``) and the Hopper
kernels (``nvcc``, one process per source), in parallel. Then:

1. Kernel phase. Each kernel (K1 gather, K2 scatter, K3 paged decode
   attention, K4 flash prefill, K6 ragged paged decode attention) runs
   against its plain PyTorch version on the card, on its path's shapes at
   Llama-3-8B widths, in bf16 and in f32: K1/K2 must be bitwise equal,
   K3/K4/K6 within 1e-5 (f32) and 2e-2 (bf16; K4 rounds probabilities to
   bf16 before PV, the plain version does not). K6 runs a skewed ragged
   wave (1 to 1,152 tokens, a 4-row verification chunk sharing its pages, a
   zero-length row, power-of-two pad pages) and must also be bitwise equal
   to K3 on each row's rebuilt table, and each row bitwise equal to a solo
   launch of that row. Each kernel is timed with CUDA events (L2 flushed
   before every launch) beside its plain version, one PyTorch library call
   where one computes the same function, and its bound (bytes over 3.35
   TB/s or operations over the peak rate of their type, from this run's
   inputs).
2. Main path at Llama-3-8B width (random weights from seed 0): engine A
   prefills 4 prompts of 2048 tokens and saves them through
   ``KVConnector.save`` to an in-process store; engine B looks each prompt up
   (all 128 blocks must hit), loads it into different block ids, must hold
   the same bytes, and both engines decode 16 steps as one wave of 4 with
   bitwise-equal logits. Launch counts are zeroed just before this phase
   and every kernel must have launched in it.
3. A small f32 model through the same round trip twice, on the card (the
   kernels) and on the CPU (the plain versions): logits agree to 2e-4.
4. Engine phase at Llama-3-8B width (bf16, the main path's weights; a fresh
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
5. The same two rounds scaled down on a small f32 model (head_dim 64) on the
   card and on the CPU: identical generated tokens, every request verified
   within 2e-4 on both.

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

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; f32 CUDA cores

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

TPU_KERNELS = {
    "gather_blocks": ("infinistore_tpu/tpu/paged.py:115", "paged_copy.cu"),
    "scatter_blocks": ("infinistore_tpu/tpu/paged.py:135", "paged_copy.cu"),
    "paged_decode_attention": ("infinistore_tpu/tpu/paged_attention.py:209", "paged_attention.cu"),
    "flash_prefill": ("infinistore_tpu/tpu/flash_prefill.py:152", "flash_prefill.cu"),
    "paged_decode_attention_ragged": ("infinistore_tpu/tpu/paged_attention.py:555",
                                      "paged_attention.cu"),
}
# The kernels each path must run (its launch counts are zeroed just before it).
PATH_KERNELS = {
    "prefill_store_decode": ("gather_blocks", "scatter_blocks", "paged_decode_attention",
                             "flash_prefill"),
    "engine": tuple(TPU_KERNELS),
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


class Timer:
    """Per-launch CUDA-event timing with the L2 cache flushed before each
    launch (the main path finds its KV cold). The flush (1 GiB, ~0.3 ms on
    the card) also outlasts the wrapper's host work, so the kernel is queued
    before the card reaches the start event and host time stays out of the
    measurement."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def bound_ms(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# Phase 1: every kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------


def kernel_phase(torch, timer):
    import torch.nn.functional as F

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
            want = pa.paged_decode_attention_plain_batched(q, kc, vc, tables, lens)
            torch.cuda.synchronize()
            err = max(err, max_err(got, want))
        if not err <= tol:
            raise AssertionError(f"paged_decode_attention {dtype}: max abs err {err} > {tol}")
        if float(got[3].float().abs().max()) != 0.0:
            raise AssertionError("paged_decode_attention: seq_len 0 must give zeros")
        log(f"K3 {dtype}: max abs err {err:.3e} (tol {tol})")
        if dtype is torch.bfloat16:
            tokens = int(full.sum())
            nbytes = (2 * tokens * kvh * d + 2 * bsz * h * d) * kc.element_size() + tables.numel() * 4 + bsz * 4
            bms, by = bound_ms(nbytes, 4.0 * h * d * tokens, "float32")
            results["paged_decode_attention"] = dict(
                max_abs_err=err,
                ms=timer.ms(lambda: pa.paged_decode_attention_batched(q, kc, vc, tables, full)),
                plain_ms=timer.ms(lambda: pa.paged_decode_attention_plain_batched(q, kc, vc, tables, full)),
                bound_ms=bms, bound_by=by, library_ms=None,
            )

    # K4: one 2048-token prompt, all 32 heads (one layer of prefill).
    s = PROMPT_TOKENS
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q = randn((1, s, h, d), dtype)
        k = randn((1, s, kvh, d), dtype)
        v = randn((1, s, kvh, d), dtype)
        got = fp.flash_prefill_attention(q, k, v, causal=True)
        want = fp.flash_prefill_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if not err <= tol:
            raise AssertionError(f"flash_prefill {dtype}: max abs err {err} > {tol}")
        log(f"K4 {dtype}: max abs err {err:.3e} (tol {tol})")
        if dtype is torch.bfloat16:
            pairs = s * (s + 1) // 2  # causal (query, key) pairs per head
            flops = 4.0 * d * h * pairs
            nbytes = (2 * s * h * d + 2 * s * kvh * d) * q.element_size()
            bms, by = bound_ms(nbytes, flops, "bfloat16")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            results["flash_prefill"] = dict(
                max_abs_err=err,
                ms=timer.ms(lambda: fp.flash_prefill_attention(q, k, v, causal=True), iters=5),
                plain_ms=timer.ms(lambda: fp.flash_prefill_plain(q, k, v, causal=True), iters=5),
                bound_ms=bms, bound_by=by,
                library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), iters=5),
            )

    results["paged_decode_attention_ragged"] = _ragged_kernel_check(torch, timer, g, pa)
    return results


def _ragged_kernel_check(torch, timer, g, pa):
    """K6 on a skewed wave at the engine phase's widths: against its plain
    version, bitwise against K3 per row, bitwise against solo launches."""
    import numpy as np

    cfg = LLAMA3_8B
    bt, kvh, h = cfg["block_tokens"], cfg["n_kv_heads"], cfg["n_heads"]
    d = cfg["dim"] // h
    width = ENGINE_REQ_BLOCKS
    # Rows 3-6 are one request's 4-token verification chunk (shared pages).
    lens = [1, 1152, 0, 300, 301, 302, 303, 700, 64, 17, 1000]
    req_of = [0, 1, 2, 3, 3, 3, 3, 4, 5, 6, 7]
    n_cache = 8 * width + 16
    rng = np.random.default_rng(5)
    req_tables = rng.permutation(n_cache)[: 8 * width].astype(np.int32).reshape(8, width)
    row_tables = [req_tables[i] for i in req_of]
    m = pa.build_ragged_wave(row_tables, lens, bt, pad_to_pow2=True)
    pages, page_rows, page_starts, seq = (
        torch.from_numpy(x).cuda() for x in (m.pages, m.page_rows, m.page_starts, m.seq_lens))
    rows_k3 = pa._ragged_row_tables(pages, page_starts, width).contiguous()
    read = {int(m.pages[m.page_starts[r] + j]) for r, n in enumerate(lens)
            for j in range(-(-n // bt))}
    out = None
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

        got, want = run(), plain()
        k3 = pa.paged_decode_attention_batched(q, kc, vc, rows_k3, seq)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if not err <= tol:
            raise AssertionError(f"ragged decode {dtype}: max abs err {err} > {tol}")
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
        log(f"K6 {dtype}: max abs err {err:.3e} (tol {tol}); bitwise K3 per row and solo per row; "
            f"{m.num_pages} pages ({m.pad_pages} pad), {len(read)} distinct read")
        if dtype is torch.bfloat16:
            nbytes = (2 * len(read) * bt * kvh * d + 2 * q.numel()) * q.element_size() + \
                (m.num_pages + 3 * len(lens) + 1) * 4
            bms, by = bound_ms(nbytes, 4.0 * h * d * sum(lens), "float32")
            out = dict(max_abs_err=err, ms=timer.ms(run), plain_ms=timer.ms(plain),
                       bound_ms=bms, bound_by=by, library_ms=None)
    return out


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
    }
    return metrics, launches, params


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
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "top_kernels_ms": {name[:80]: ms for name, ms in rows[:8]},
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
# Phases 4 and 5: the continuous-batching engine
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
                req_blocks, verify_tol):
    """Both rounds on one harness, from one event loop; returns per-round
    (metrics, stats, wall seconds, waves in the round), and the harness (its
    wave and speculation counters span both rounds)."""
    import numpy as np

    from infinistore_tpu_torch import config as config_mod
    from infinistore_tpu_torch import lib as lib_mod
    from infinistore_tpu_torch.connector import KVConnector
    from infinistore_tpu_torch.engine import (
        ContinuousBatchingHarness, EngineKVAdapter, NGramDrafter,
    )

    rounds = _engine_rounds(np.random.default_rng(3), cfg.vocab, traffic)
    conn = _client(lib_mod, config_mod, server_port)
    kv = KVConnector(conn, cfg.kv_spec(num_blocks), model_id, max_blocks=req_blocks,
                     device=device)
    try:
        h = ContinuousBatchingHarness(
            EngineKVAdapter(kv), params, cfg, num_blocks, req_blocks, verify=True,
            verify_tol=verify_tol, drafter=NGramDrafter(max_draft=7), device=device,
        )

        async def drive():
            out = []
            for prompts in rounds:
                h.stats.clear()
                waves0 = h.wave.waves
                stats, wall = await _serve(h, prompts, traffic["gen"])
                _sync(torch, device)
                out.append((h.metrics(), stats, wall, h.wave.waves - waves0))
            return out

        return asyncio.run(drive()), h
    finally:
        kv.close()
        conn.close()


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


def engine_phase(torch, server_port, params, smi):
    """Phase 4: Llama-3-8B width, bf16, on the card."""
    from infinistore_tpu_torch.cuda import _ext
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(dtype=torch.bfloat16, **LLAMA3_8B)
    _ext.reset_launches()
    results, h = _run_engine(torch, server_port, params, cfg, "cuda", "llama-3-8b-engine",
                             ENGINE, ENGINE_BLOCKS, ENGINE_REQ_BLOCKS, ENGINE_VERIFY_TOL)
    launches = dict(_ext.LAUNCHES)
    _check_rounds(results, ENGINE, cfg.block_tokens, "engine phase")
    log(f"engine phase all_verified (bf16 verify_tol {ENGINE_VERIFY_TOL}, rtol = atol) "
        f"in both rounds; round 2 loaded {results[1][0]['loaded_blocks']} blocks")
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
    log(f"engine phase: {json.dumps(summary)}")
    log(f"profile engine wave: {json.dumps(_profile_wave(torch, h, cfg))}")
    log(f"engine phase launches: {json.dumps(launches)}")
    return launches


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


def small_engine_phase(torch, server_port):
    """Phase 5: the same traffic scaled down, f32, card against CPU."""
    from infinistore_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab=128, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=256, block_tokens=8, dtype=torch.float32)
    params_cpu = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = {}
    for device in ("cuda", "cpu"):
        params = {k: v.to(device) for k, v in params_cpu.items()}
        results, _ = _run_engine(torch, server_port, params, cfg, device,
                                 f"small-engine-{device}", SMALL_ENGINE, 64, 12, 2e-4)
        _check_rounds(results, SMALL_ENGINE, cfg.block_tokens, f"small engine ({device})")
        tokens[device] = [s.generated for _, stats, _, _ in results for s in stats]
    if tokens["cuda"] != tokens["cpu"]:
        raise AssertionError("small engine: the card's generated tokens differ from the CPU's")
    log("small f32 engine: card (kernels) and CPU (plain) generate the same tokens; "
        "all verified within 2e-4 on both")


# ---------------------------------------------------------------------------


def _build_all(torch):
    """Compile the kernels (nvcc) while the native store library builds
    (g++, at its first import); both must succeed."""
    from infinistore_tpu_torch.cuda import _ext

    errors = []

    def build_kernels():
        try:
            _ext.kernels()
        except BaseException as exc:  # re-raised on the main thread below
            errors.append(exc)

    t0 = time.perf_counter()
    worker = threading.Thread(target=build_kernels)
    worker.start()
    from infinistore_tpu_torch import lib  # noqa: F401  (builds the native core)

    worker.join()
    if errors:
        raise errors[0]
    log(f"built the store library and the kernels in {time.perf_counter() - t0:.1f} s")


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

    _build_all(torch)
    from infinistore_tpu_torch import lib
    from infinistore_tpu_torch.cuda import _ext

    timer = Timer(torch)
    kernels = kernel_phase(torch, timer)
    del timer
    torch.cuda.empty_cache()

    paths = {}
    server = lib.start_local_server(prealloc_bytes=2 << 30, block_bytes=32 << 10,
                                    pin_memory=False)
    try:
        _ext.reset_launches()
        metrics, paths["prefill_store_decode"], params = main_path(torch, server.port)
        log(f"main path: {json.dumps(metrics)}")
        log(f"main path launches: {json.dumps(paths['prefill_store_decode'])}")
        torch.cuda.empty_cache()
        small_model_phase(torch, server.port)
    finally:
        server.stop()

    # The engine gets a fresh store; the main path's caches are gone, its
    # weights are reused.
    torch.cuda.empty_cache()
    server = lib.start_local_server(prealloc_bytes=2 << 30, block_bytes=32 << 10,
                                    pin_memory=False)
    try:
        paths["engine"] = engine_phase(torch, server.port, params, smi)
        del params
        torch.cuda.empty_cache()
        small_engine_phase(torch, server.port)
    finally:
        server.stop()

    for path, names in PATH_KERNELS.items():
        idle = [name for name in names if paths[path][name] == 0]
        if idle:
            raise AssertionError(f"kernels never launched on the {path} path: {idle}")

    rows = []
    for name, (replaces, source) in TPU_KERNELS.items():
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"infinistore_tpu_torch/cuda/csrc/{source}",
            "replaces": replaces,
            # Every launch on the paths this script drives; per path below.
            "launches": sum(counts[name] for counts in paths.values()),
            "launches_by_path": {path: counts[name] for path, counts in paths.items()},
            **kernels[name],
        })
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
