"""Benchmark CLI (port of ``infinistore_tpu/benchmark.py``; reference
infinistore/benchmark.py surface: N blocks x block-size KB simulating
--steps layers, RDMA-style async batched or TCP single-key transfers,
write/read MB/s report + data verification, benchmark.py:53-271).

The store legs stage in numpy host buffers and are the JAX package's code.
The decode-wave leg (``--wave``) runs K6 against K3 from
``cuda/paged_attention.py`` and the trace leg (``--trace``) the port's
continuous-batching engine, both on ``--device`` (default ``cuda``; without
a card the CLI raises before it connects, ``--device cpu`` runs the plain
PyTorch versions). The JSON keys are the JAX package's.

Run: python -m infinistore_tpu_torch.benchmark --service-port 22345 --json
"""

import argparse
import asyncio
import json
import time
import uuid

import numpy as np
import torch

from .config import TYPE_RDMA, TYPE_TCP, ClientConfig
from .cuda import _ext
from .lib import InfinityConnection, StripedConnection


# The trace leg's engine model. It departs from the JAX package's (dim 64, 4
# heads: head_dim 16), a shape the decode and prefill kernels refuse (they
# take head_dim 64 or 128 and 1, 2, 4 or 8 query heads per KV head): dim 256,
# 4 heads over 2 KV heads (head_dim 64), ffn 512, the same 2 layers, block 8,
# vocab 128 and f32, the smallest the kernels take. The CPU runs it too, so
# both devices replay one model.
TRACE_MODEL = dict(
    vocab=128, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
    ffn_dim=512, block_tokens=8, dtype=torch.float32,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="infinistore-tpu-torch-benchmark")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--service-port", type=int, default=22345)
    p.add_argument("--size", type=int, default=128, help="total MB to transfer")
    p.add_argument("--block-size", type=int, default=32, help="block size in KB")
    p.add_argument(
        "--steps", type=int, default=32,
        help="simulate N layers: the batch is split into N sequential batched ops",
    )
    p.add_argument("--type", choices=["rdma", "tcp"], default="rdma",
                   help="rdma = batched zero-copy data plane; tcp = single-key ops")
    p.add_argument("--iteration", type=int, default=1)
    p.add_argument("--verify", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--json", action="store_true", help="emit one JSON line")
    p.add_argument(
        "--latency", action="store_true",
        help="also measure single-block fetch latency p50/p99 at 4KB and 64KB "
             "(the BASELINE.md 'p50 block-fetch latency' configs)",
    )
    p.add_argument(
        "--streams", type=int, default=1,
        help="connection stripes for batched ops (cross-host DCN scaling; "
             "see docs/multistream.md)",
    )
    p.add_argument(
        "--adaptive", action=argparse.BooleanOptionalAction, default=True,
        help="striped fan-out mode: adaptive work-stealing chunk scheduler "
             "(default) vs the legacy static 1/N split (--no-adaptive, for "
             "A/B comparison of the two data planes)",
    )
    p.add_argument(
        "--wave", type=int, default=0,
        help="also measure admission-wave read coalescing (N concurrent "
             "requests' reads issued as N separate calls vs merged into one "
             "— the FetchCoalescer mechanism; connector.py) AND the "
             "decode-wave cost: one ragged attention launch for an N-request "
             "length-skewed wave vs the padded-dense rectangle "
             "(cuda/paged_attention.py: K6 against K3; same estimator as "
             "bench.py's decode leg)",
    )
    p.add_argument(
        "--trace", default=None, metavar="FILE|PRESET",
        help="replay a loadgen trace (JSON file or preset name: skewed, "
             "uniform, outlier_flood) through the continuous-batching "
             "engine harness against the server — the same traces "
             "bench.py's serving leg grades (docs/serving_load.md)",
    )
    p.add_argument(
        "--trace-seed", type=int, default=0,
        help="generator seed when --trace names a preset",
    )
    p.add_argument(
        "--trace-duration", type=float, default=0.4,
        help="trace duration in seconds when --trace names a preset",
    )
    p.add_argument(
        "--skew-policy", action=argparse.BooleanOptionalAction, default=True,
        help="replay with the skew-aware wave flush policy "
             "(wave_skew_policy; docs/serving_load.md) on or off",
    )
    p.add_argument(
        "--pacing-mbps", type=int, default=0,
        help="cap each connection's egress in MB/s (SO_MAX_PACING_RATE); "
             "implies the socket path (shm off — a same-host memcpy would "
             "bypass the cap). Emulates a bandwidth-limited cross-host "
             "stream; see tools/striping_emulation.py",
    )
    p.add_argument(
        "--device", default="cuda",
        help="where the decode-wave and trace legs run: cuda (the kernels; "
             "raises without a card) or cpu (the plain PyTorch versions)",
    )
    return p.parse_args(argv)


def _measure_latency(conn, samples: int = 200) -> dict:
    """p50/p99 single-block fetch latency at 4KB and 64KB.

    Sync (read_cache, the low-latency API: the calling thread blocks on the
    native completion) and async samples are taken in short INTERLEAVED
    chunks — hosts swing between seconds, and the async-minus-sync delta
    (``async_overhead_us``) only means 'bridge cost' when both paths saw
    the same weather (same discipline as bench.py's _fetch_latency_us)."""
    out = {}
    chunk = 50
    for size in (4 << 10, 64 << 10):
        buf = np.random.randint(0, 256, size=size, dtype=np.uint8)
        dst = np.zeros_like(buf)
        conn.register_mr(buf)
        conn.register_mr(dst)
        key = f"lat-{uuid.uuid4().hex[:8]}"

        async def async_chunk(k):
            lats = []
            for _ in range(k):
                t0 = time.perf_counter()
                await conn.read_cache_async([(key, 0)], size, dst.ctypes.data)
                lats.append((time.perf_counter() - t0) * 1e6)
            return lats

        async def seed():
            await conn.write_cache_async([(key, 0)], size, buf.ctypes.data)
            await conn.read_cache_async([(key, 0)], size, dst.ctypes.data)

        asyncio.run(seed())  # write + warm the async path
        conn.read_cache([(key, 0)], size, dst.ctypes.data)  # warm sync
        lats = []
        sync_lats = []
        for _ in range(max(1, samples // chunk)):
            for _ in range(chunk):
                t0 = time.perf_counter()
                conn.read_cache([(key, 0)], size, dst.ctypes.data)
                sync_lats.append((time.perf_counter() - t0) * 1e6)
            lats += asyncio.run(async_chunk(chunk))
        lats.sort()
        sync_lats.sort()
        p50 = lats[len(lats) // 2]
        sync_p50 = sync_lats[len(sync_lats) // 2]
        out[f"fetch_{size >> 10}kb"] = {
            "p50_us": round(p50, 1),
            "p99_us": round(lats[int(len(lats) * 0.99)], 1),
            "sync_p50_us": round(sync_p50, 1),
            "sync_p99_us": round(sync_lats[int(len(sync_lats) * 0.99)], 1),
            # The asyncio bridge's whole per-op tax in one number; its floor
            # is the eventfd loop wake (bench.py asyncio_efd_floor_us).
            "async_overhead_us": round(p50 - sync_p50, 1),
        }
        conn.delete_keys([key])
    return out


def _measure_wave_coalescing(conn, keys, offsets, block_size, dst, wave: int) -> dict:
    """N concurrent 'admissions' reading disjoint spans: N separate
    read_cache_async calls racing on the connection vs the SAME blocks
    merged into one call (what connector.FetchCoalescer does for a wave of
    engine admissions). The gain is per-call overhead amortization — the
    number striped deployments multiply, since one merged call splits
    across all stripes."""
    n = len(keys)
    # Exactly `wave` near-equal spans (never more, never fewer — except
    # when there are fewer keys than requests), so the reported
    # wave_requests is the concurrency actually raced.
    wave = min(wave, n)
    bounds = [round(j * n / wave) for j in range(wave + 1)]
    spans = [
        list(zip(keys[a:b], offsets[a:b]))
        for a, b in zip(bounds, bounds[1:])
        if b > a
    ]

    async def split():
        await asyncio.gather(*(
            conn.read_cache_async(span, block_size, dst.ctypes.data)
            for span in spans
        ))

    async def merged():
        await conn.read_cache_async(
            [b for span in spans for b in span], block_size, dst.ctypes.data
        )

    asyncio.run(split())  # warm
    best_split = best_merged = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        asyncio.run(split())
        best_split = min(best_split, time.perf_counter() - t0)
        t0 = time.perf_counter()
        asyncio.run(merged())
        best_merged = min(best_merged, time.perf_counter() - t0)
    moved_mb = n * block_size / (1 << 20)
    return {
        "wave_requests": len(spans),
        "wave_split_mb_s": round(moved_mb / best_split, 2),
        "wave_merged_mb_s": round(moved_mb / best_merged, 2),
        "wave_coalescing_gain": round(best_split / best_merged, 3),
    }


def _sync(device) -> None:
    """Wait for the device's queued work (a CPU op has finished on return)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


WAVE_REPS = 8  # the decode-wave leg's chained calls a sample


def decode_wave_inputs(wave: int, device):
    """The decode-wave leg's inputs on ``device``, drawn from a numpy
    generator seeded 0: f32 caches and queries, a ``wave``-row 8:1
    length-skewed wave (one row over its whole table, the rest over an
    eighth) over random tables, and its ragged metadata padded to a power of
    two (``build_ragged_wave(..., pad_to_pow2=True)``), with the reference's
    shapes. Returns ``(ragged, padded, inputs)``: the K6 and K3 calls on
    these inputs, each taking the query, and a namespace of the inputs."""
    import types

    from .cuda.paged_attention import (
        build_ragged_wave,
        paged_decode_attention_batched,
        paged_decode_attention_ragged,
    )

    n, bt, kvh, d, h, ntbl = 256, 16, 2, 64, 8, 16
    wave = max(2, wave)
    rng = np.random.default_rng(0)

    def on_device(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    x = types.SimpleNamespace(table_width=ntbl)
    x.k_cache = on_device(rng.standard_normal((n, bt, kvh, d)))
    x.v_cache = on_device(rng.standard_normal((n, bt, kvh, d)))
    x.q = on_device(rng.standard_normal((wave, h, d)))
    x.lens = [ntbl * bt] + [ntbl * bt // 8] * (wave - 1)
    tables = [np.asarray(rng.permutation(n)[:ntbl]) for _ in range(wave)]
    x.meta = build_ragged_wave(tables, x.lens, bt, pad_to_pow2=True)
    x.tables = on_device(np.stack(tables), torch.int32)
    x.seq_lens = on_device(x.meta.seq_lens, torch.int32)
    x.pages = on_device(x.meta.pages, torch.int32)
    x.page_rows = on_device(x.meta.page_rows, torch.int32)
    x.page_starts = on_device(x.meta.page_starts, torch.int32)

    def ragged(qc):
        return paged_decode_attention_ragged(
            qc, x.k_cache, x.v_cache, x.pages, x.page_rows, x.page_starts, x.seq_lens,
            table_width=ntbl,
        )

    def padded(qc):
        return paged_decode_attention_batched(qc, x.k_cache, x.v_cache, x.tables, x.seq_lens)

    return ragged, padded, x


def _measure_decode_wave(wave: int, device) -> dict:
    """Decode-wave cost on the CONSUME side of the store: one ragged
    attention launch (K6 on CUDA) for a ``wave``-request, 8:1
    length-skewed wave vs the padded-dense rectangle (K3 on CUDA) the
    engine's WaveDecoder used to assemble (every row padded to the wave
    max), on ``decode_wave_inputs``. Uses the same order-alternating paired
    interleaved sampling with the min(median-of-ratios, ratio-of-sums)
    estimator as ``bench.py``'s decode-attention leg, so this CLI harness
    and the bench agree on what a wave costs. Each sample is host wall over
    ``WAVE_REPS`` chained calls. On the CPU both are the plain versions (the
    ragged one rebuilds rectangular tables), so the gain there is not a
    kernel's."""
    ragged, padded, x = decode_wave_inputs(wave, device)
    q, lens, wave = x.q, x.lens, x.q.shape[0]

    reps = WAVE_REPS
    ragged(q)  # build + warm
    padded(q)
    _sync(device)

    def sample(op) -> float:
        qc = q
        t0 = time.perf_counter()
        for _ in range(reps):
            qc = op(qc)
        _sync(device)
        return time.perf_counter() - t0

    sums = {"ragged": 0.0, "padded": 0.0}
    ratios = []
    for i in range(6):
        order = (
            ("ragged", "padded") if i % 2 else ("padded", "ragged")
        )
        s = {}
        for side in order:
            s[side] = sample(ragged if side == "ragged" else padded)
        for side in s:
            sums[side] += s[side]
        ratios.append(s["padded"] / s["ragged"])
    med = sorted(ratios)[len(ratios) // 2]
    gain = min(med, sums["padded"] / sums["ragged"])
    pairs = len(ratios)
    return {
        "wave_decode_requests": wave,
        "wave_decode_skew_factor": round(
            wave * max(lens) / sum(lens), 2
        ),
        "wave_decode_ragged_us": round(sums["ragged"] / (pairs * reps) * 1e6, 1),
        "wave_decode_padded_us": round(sums["padded"] / (pairs * reps) * 1e6, 1),
        "wave_decode_ragged_gain": round(gain, 3),
    }


def _run_trace(args, device) -> dict:
    """``--trace`` mode: replay a loadgen trace (file or preset) through
    the continuous-batching engine harness against the server — the same
    workload definition ``bench.py``'s ``_serving_trace_metrics`` leg
    grades, through the CLI entry point (docs/serving_load.md). Reports
    the harness's serving metrics (TTFT percentiles, wave pad fraction,
    the wave-policy ledger) plus the trace's own shape.

    The model is ``TRACE_MODEL``; its weights come from a CPU generator
    seeded 0."""
    import os

    from . import loadgen
    from .connector import KVConnector
    from .engine import (
        ContinuousBatchingHarness,
        EngineKVAdapter,
        NGramDrafter,
    )
    from .models import LlamaConfig, init_params

    if os.path.exists(args.trace):
        trace = loadgen.Trace.load(args.trace)
    else:
        trace = loadgen.preset(
            args.trace, seed=args.trace_seed,
            duration_s=args.trace_duration,
        )

    cfg = LlamaConfig(**TRACE_MODEL)
    num_blocks, max_blocks = 96, 8
    conn = InfinityConnection(ClientConfig(
        host_addr=args.host, service_port=args.service_port,
        log_level="warning",
    ))
    conn.connect()
    kvc = None
    try:
        kvc = KVConnector(
            conn, cfg.kv_spec(num_blocks),
            f"trace-{uuid.uuid4().hex[:8]}", max_blocks=max_blocks,
            device=device,
        )
        h = ContinuousBatchingHarness(
            EngineKVAdapter(kvc),
            init_params(cfg, torch.Generator().manual_seed(0), device=device),
            cfg, num_blocks, max_blocks, verify=args.verify,
            wave_skew_policy=args.skew_policy, device=device,
        )
        h.drafter = NGramDrafter(max_draft=4)
        t0 = time.perf_counter()
        stats = asyncio.run(loadgen.replay(trace, h, concurrency=8))
        wall = time.perf_counter() - t0
        errs = [s for s in stats if isinstance(s, Exception)]
        if errs:
            raise SystemExit(f"trace replay failed: {errs[:3]}")
        m = h.metrics()
        return {
            "trace": args.trace,
            "trace_seed": trace.seed,
            "trace_requests": len(trace.requests),
            "trace_prefill_only": sum(
                1 for r in trace.requests if r.gen_tokens == 0
            ),
            "trace_background": sum(
                1 for r in trace.requests if r.priority != 0
            ),
            "skew_policy": bool(args.skew_policy),
            "replay_wall_s": round(wall, 3),
            "requests_per_s": round(len(trace.requests) / wall, 1),
            "verified": bool(m["all_verified"]) if args.verify else None,
            "hit_rate": round(m["hit_rate"], 3),
            "p50_ttft_us": m["p50_ttft_us"],
            "p99_ttft_us": m["p99_ttft_us"],
            "p99_ttft_fg_us": m["p99_ttft_fg_us"],
            "wave_pad_fraction": round(m["wave_pad_fraction"], 4),
            "decode_waves": m["decode_waves"],
            "wave_deferrals": m["wave_deferrals"],
            "wave_aging_escapes": m["wave_aging_escapes"],
            "wave_held_flushes": m["wave_held_flushes"],
            "wave_defer_age_us_p99": m["wave_defer_age_us_p99"],
        }
    finally:
        if kvc is not None:
            kvc.close()
        conn.close()


async def _run_batched(conn, keys, offsets, block_size, src, dst, steps):
    """Layer-wise streaming shape (reference benchmark.py:188-256): the block
    list is split into `steps` chunks issued as pipelined batched ops."""
    n = len(keys)
    per = max(1, n // steps)
    t0 = time.perf_counter()
    writes = []
    for s in range(0, n, per):
        blocks = list(zip(keys[s : s + per], offsets[s : s + per]))
        writes.append(conn.write_cache_async(blocks, block_size, src.ctypes.data))
    await asyncio.gather(*writes)
    t1 = time.perf_counter()
    reads = []
    for s in range(0, n, per):
        blocks = list(zip(keys[s : s + per], offsets[s : s + per]))
        reads.append(conn.read_cache_async(blocks, block_size, dst.ctypes.data))
    await asyncio.gather(*reads)
    t2 = time.perf_counter()
    return t1 - t0, t2 - t1


def run(args, device) -> dict:
    cfg = ClientConfig(
        host_addr=args.host,
        service_port=args.service_port,
        connection_type=TYPE_RDMA if args.type == "rdma" else TYPE_TCP,
        log_level="warning",
        pacing_rate_mbps=args.pacing_mbps,
        # Pacing shapes SOCKET egress; the same-host shm fast path moves
        # payloads by memcpy and would silently bypass the cap.
        enable_shm=args.pacing_mbps == 0,
    )
    if args.streams > 1:
        conn = StripedConnection(cfg, streams=args.streams, adaptive=args.adaptive)
    else:
        conn = InfinityConnection(cfg)
    conn.connect()

    total_bytes = args.size << 20
    block_size = args.block_size << 10
    nblocks = max(1, total_bytes // block_size)
    total_bytes = nblocks * block_size

    src = np.random.randint(0, 256, size=total_bytes, dtype=np.uint8)
    dst = np.zeros_like(src)
    run_id = uuid.uuid4().hex[:8]
    keys = [f"bench-{run_id}-{i}" for i in range(nblocks)]
    offsets = [i * block_size for i in range(nblocks)]

    write_s = read_s = 0.0
    try:
        if args.type == "rdma":
            conn.register_mr(src)
            conn.register_mr(dst)
            for _ in range(args.iteration):
                w, r = asyncio.run(
                    _run_batched(conn, keys, offsets, block_size, src, dst, args.steps)
                )
                write_s += w
                read_s += r
        else:
            for _ in range(args.iteration):
                t0 = time.perf_counter()
                for i, key in enumerate(keys):
                    conn.tcp_write_cache(
                        key, src.ctypes.data + offsets[i], block_size
                    )
                t1 = time.perf_counter()
                for i, key in enumerate(keys):
                    out = conn.tcp_read_cache(key)
                    dst[offsets[i] : offsets[i] + block_size] = out
                t2 = time.perf_counter()
                write_s += t1 - t0
                read_s += t2 - t1

        ok = bool(np.array_equal(src, dst)) if args.verify else None
        moved = total_bytes * args.iteration
        result = {
            "type": args.type,
            "blocks": nblocks,
            "block_size_kb": args.block_size,
            "total_mb": moved >> 20,
            "write_mb_s": round(moved / write_s / (1 << 20), 2),
            "read_mb_s": round(moved / read_s / (1 << 20), 2),
            "verified": ok,
        }
        if args.latency and args.type == "rdma":
            result["latency"] = _measure_latency(conn)
        if args.wave > 1 and args.type == "rdma":
            result["coalescing"] = _measure_wave_coalescing(
                conn, keys, offsets, block_size, dst, args.wave
            )
        if args.wave > 1:
            # The consume-side half of the wave story: what the DECODE
            # launch for this wave costs through the ragged path vs the
            # padded rectangle (same estimator as bench.py's decode leg).
            result["decode_wave"] = _measure_decode_wave(args.wave, device)
        if args.type == "rdma":
            # Wakeup coalescing over the whole run (native ring pushes vs
            # eventfd signals; >1 means pipelined ops shared loop wakes).
            result["completion_batch_size"] = round(
                conn.completion_stats()["completion_batch_size"], 2
            )
        if args.streams > 1:
            # Adaptive scheduler receipt: per-stripe chunk/block counts,
            # steals, EWMA rates, and same-host collapse count.
            result["striping"] = conn.data_plane_stats()
        conn.delete_keys(keys)
        return result
    finally:
        conn.close()


def main(argv=None) -> int:
    args = parse_args(argv)
    device = _ext.resolve_device(args.device)
    if args.trace:
        result = _run_trace(args, device)
        if args.json:
            print(json.dumps(result))
        else:
            print(
                f"replayed {result['trace_requests']} requests "
                f"({result['trace']}) in {result['replay_wall_s']}s "
                f"(skew_policy={'on' if result['skew_policy'] else 'off'})"
            )
            print(
                f"p99 TTFT: {result['p99_ttft_us']}us (fg "
                f"{result['p99_ttft_fg_us']}us), pad fraction "
                f"{result['wave_pad_fraction']}, deferrals "
                f"{result['wave_deferrals']}"
            )
            if result["verified"] is not None:
                print(f"data verified: {result['verified']}")
        return 0 if result.get("verified") in (True, None) else 1
    result = run(args, device)
    if args.json:
        print(json.dumps(result))
    else:
        print(f"write throughput: {result['write_mb_s']} MB/s")
        print(f"read throughput: {result['read_mb_s']} MB/s")
        if result["verified"] is not None:
            print(f"data verified: {result['verified']}")
    return 0 if result.get("verified") in (True, None) else 1


if __name__ == "__main__":
    raise SystemExit(main())
