"""The port's copy of the trace-driven load generator
(``infinistore_tpu_torch.loadgen``), held to ``tests/test_loadgen.py``'s
proofs: the trace is deterministic per seed, its marginals have the
advertised shape (Zipf head mass, heavy length tail, diurnal/burst rate
envelope), it round-trips through JSON, the port's ``DisaggHarness``
materialises its prompts, and it replays through the port's engine harness
on the CPU with every request verified against the prefill oracle. Also:
the port's copy and the JAX package's give the same trace JSON and prompts
for the same seed and preset."""

import asyncio
import collections
import json

import pytest
import torch

from infinistore_tpu import loadgen as jax_loadgen
from infinistore_tpu_torch import loadgen
from infinistore_tpu_torch.loadgen import Trace, generate, preset
from infinistore_tpu_torch.wire import PRIORITY_BACKGROUND, PRIORITY_FOREGROUND


# ---------------------------------------------------------------------------
# Determinism + schema
# ---------------------------------------------------------------------------

def test_same_seed_identical_trace():
    """The reproducibility contract: same seed + knobs => byte-identical
    JSON, including arrival times, lengths, priorities and bursts."""
    a = preset("skewed", seed=7, duration_s=1.0)
    b = preset("skewed", seed=7, duration_s=1.0)
    assert a.to_json() == b.to_json()
    assert len(a.requests) > 50


def test_different_seed_different_trace():
    a = preset("skewed", seed=1, duration_s=1.0)
    b = preset("skewed", seed=2, duration_s=1.0)
    assert a.to_json() != b.to_json()


def test_json_round_trip(tmp_path):
    tr = preset("skewed", seed=3, duration_s=0.5)
    path = str(tmp_path / "trace.json")
    tr.save(path)
    back = Trace.load(path)
    assert back.to_json() == tr.to_json()
    assert back.requests == tr.requests
    assert back.knobs == tr.knobs


def test_version_check_rejects_future_trace():
    tr = preset("uniform", seed=0, duration_s=0.2)
    doc = json.loads(tr.to_json())
    doc["version"] = 99
    with pytest.raises(ValueError, match="version"):
        Trace.from_json(json.dumps(doc))


def test_unknown_preset_raises():
    with pytest.raises(ValueError, match="unknown preset"):
        preset("nope")


def test_prompt_materialization_deterministic_and_prefix_shared():
    """prompts() is derived from the trace seed alone: two calls agree,
    and requests of the same family share the family prefix bytes —
    the prefix-cache hit surface replay depends on."""
    tr = preset("skewed", seed=5, duration_s=0.5)
    bt = 8
    p1 = tr.prompts(bt, vocab=128)
    p2 = tr.prompts(bt, vocab=128)
    assert p1 == p2
    by_family = collections.defaultdict(list)
    for req, toks in zip(tr.requests, p1):
        assert len(toks) == req.prompt_blocks * bt
        by_family[req.prefix_id].append((req, toks))
    shared = 0
    for fam, members in by_family.items():
        if len(members) < 2:
            continue
        (r0, t0), (r1, t1) = members[0], members[1]
        pre = min(r0.prefix_blocks, r1.prefix_blocks) * bt
        assert t0[:pre] == t1[:pre]
        shared += 1
    assert shared > 0, "no family had two requests — no prefix reuse to test"


def test_prompts_max_blocks_clamps():
    tr = preset("skewed", seed=5, duration_s=0.5)
    bt = 8
    for toks in tr.prompts(bt, vocab=128, max_blocks=4):
        assert 0 < len(toks) <= 4 * bt


# ---------------------------------------------------------------------------
# Distribution properties
# ---------------------------------------------------------------------------

def test_zipf_head_mass():
    """With zipf_s=1.2 over 64 families, the top-4 families must carry
    far more than their uniform share (4/64 ≈ 6%) of arrivals."""
    tr = preset("skewed", seed=11, duration_s=2.0, burst_prob_per_s=0.0)
    counts = collections.Counter(r.prefix_id for r in tr.requests)
    top4 = sum(c for _, c in counts.most_common(4))
    frac = top4 / len(tr.requests)
    assert frac > 0.35, f"top-4 family mass {frac:.2f} — Zipf head missing"


def test_uniform_preset_has_no_head():
    tr = preset("uniform", seed=11, duration_s=2.0)
    counts = collections.Counter(r.prefix_id for r in tr.requests)
    top4 = sum(c for _, c in counts.most_common(4))
    assert top4 / len(tr.requests) < 0.25


def test_length_heavy_tail_and_bg_tagging():
    """The outlier mechanism: the skewed preset's p99 prompt length well
    above its median, and exactly the >= bg_outlier_blocks requests ride
    BACKGROUND."""
    tr = preset("skewed", seed=13, duration_s=2.0)
    blocks = sorted(r.prompt_blocks for r in tr.requests)
    p50 = blocks[len(blocks) // 2]
    p99 = blocks[int(len(blocks) * 0.99)]
    assert p99 >= 2 * p50, f"p99 {p99} vs p50 {p50}: no heavy tail"
    bg = [r for r in tr.requests if r.priority == PRIORITY_BACKGROUND]
    bgk = tr.knobs["bg_outlier_blocks"]
    assert bg, "no BACKGROUND outliers in the skewed preset"
    assert all(r.prompt_blocks >= bgk for r in bg)
    assert all(
        r.prompt_blocks < bgk
        for r in tr.requests if r.priority == PRIORITY_FOREGROUND
    )
    assert len(bg) / len(tr.requests) < 0.5, "BACKGROUND must be the tail"


def test_burst_envelope():
    """Forcing a storm window every second: arrivals flagged burst=True
    exist, and the arrival rate inside storm windows beats the outside
    rate (the burst_mult mechanism)."""
    tr = preset(
        "skewed", seed=17, duration_s=2.0,
        burst_prob_per_s=1.0, burst_len_s=0.2, burst_mult=4.0,
        diurnal_amplitude=0.0,
    )
    inside = [r for r in tr.requests if r.burst]
    outside = [r for r in tr.requests if not r.burst]
    assert inside and outside
    # Every second opens one 0.2 s window => 0.4 s in-storm, 1.6 s out.
    rate_in = len(inside) / 0.4
    rate_out = len(outside) / 1.6
    assert rate_in > 2.0 * rate_out, (rate_in, rate_out)


def test_diurnal_envelope():
    """With amplitude 1.0 and a 1 s period over a 1 s trace, the rising
    half-period (sin > 0) must receive most arrivals."""
    tr = generate(
        seed=19, duration_s=1.0, base_rate_rps=400.0,
        diurnal_amplitude=1.0, diurnal_period_s=1.0,
        burst_prob_per_s=0.0, outlier_frac=0.0,
    )
    first_half = sum(1 for r in tr.requests if r.t_s < 0.5)
    second_half = len(tr.requests) - first_half
    assert first_half > 1.5 * second_half, (first_half, second_half)


def test_arrivals_sorted_and_capped():
    tr = generate(seed=23, duration_s=5.0, base_rate_rps=10_000.0,
                  max_requests=500)
    ts = [r.t_s for r in tr.requests]
    assert ts == sorted(ts)
    assert len(tr.requests) == 500  # the runaway-allocation cap


def test_prefill_only_fraction():
    tr = preset("skewed", seed=29, duration_s=2.0)
    frac = sum(1 for r in tr.requests if r.gen_tokens == 0) / len(tr.requests)
    assert 0.15 < frac < 0.45, frac  # knob is 0.3


# ---------------------------------------------------------------------------
# DisaggHarness consumption (docs/serving_load.md, docs/disaggregation.md)
# ---------------------------------------------------------------------------

def test_disagg_harness_trace_prompts():
    """The port's DisaggHarness.trace_prompts clamps the trace's
    materialized prompts to the harness's own req_blocks limit and honors
    count — the one-workload-definition contract. Only config/req_blocks
    are touched, so a bare skeleton suffices (no store, no params)."""
    from infinistore_tpu_torch import disagg

    tr = preset("skewed", seed=37, duration_s=0.5)
    h = disagg.DisaggHarness.__new__(disagg.DisaggHarness)
    h.config = disagg.demo_config(n_layers=2)
    h.req_blocks = 3
    prompts = h.trace_prompts(tr)
    assert len(prompts) == len(tr.requests)
    bt = h.config.block_tokens
    for toks in prompts:
        assert 0 < len(toks) <= h.req_blocks * bt
        assert all(0 <= t < h.config.vocab for t in toks)
    # The clamp is the harness's, not the trace's.
    assert any(r.prompt_blocks > h.req_blocks for r in tr.requests)
    assert h.trace_prompts(tr, count=5) == prompts[:5]


# ---------------------------------------------------------------------------
# Replay through the real engine harness
# ---------------------------------------------------------------------------

def test_replay_through_engine_harness():
    """A short skewed trace replays through the port's continuous-batching
    harness on the CPU with the oracle verifier on — every request
    completes, none raises, all verify, and the harness metrics carry the
    trace's mixed prefill/decode shape."""
    from infinistore_tpu_torch import lib
    from infinistore_tpu_torch.config import ClientConfig
    from infinistore_tpu_torch.connector import KVConnector
    from infinistore_tpu_torch.engine import (
        ContinuousBatchingHarness, EngineKVAdapter, RequestStats,
    )
    from infinistore_tpu_torch.models import LlamaConfig, init_params

    cfg = LlamaConfig(
        vocab=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
        block_tokens=8, dtype=torch.float32,
    )
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tr = preset("skewed", seed=31, duration_s=0.12, base_rate_rps=250.0)
    assert len(tr.requests) >= 8
    srv = lib.start_local_server(
        prealloc_bytes=64 << 20, block_bytes=64 << 10, enable_shm=True
    )
    try:
        conn = lib.InfinityConnection(ClientConfig(
            host_addr="127.0.0.1", service_port=srv.port, log_level="error"
        ))
        conn.connect()
        try:
            kvc = KVConnector(conn, cfg.kv_spec(64), "loadgen-replay",
                              max_blocks=8, device="cpu")
            h = ContinuousBatchingHarness(
                EngineKVAdapter(kvc), params, cfg, 64, 8, verify=True, device="cpu",
            )
            stats = asyncio.run(loadgen.replay(tr, h, concurrency=4))
            kvc.close()
        finally:
            conn.close()
    finally:
        srv.stop()
    assert len(stats) == len(tr.requests)
    errs = [s for s in stats if isinstance(s, Exception)]
    assert errs == [], f"replay surfaced failures: {errs[:3]}"
    assert all(isinstance(s, RequestStats) for s in stats)
    m = h.metrics()
    assert m["all_verified"], "a replayed request diverged from the oracle"
    assert m["requests"] == len(tr.requests)
    decoded = [s for r, s in zip(tr.requests, stats) if r.gen_tokens > 0]
    assert decoded and any(s.ttft_us > 0 for s in decoded)


# ---------------------------------------------------------------------------
# The copy against the JAX package's module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,seed", [("skewed", 0), ("skewed", 7), ("uniform", 3),
                                       ("outlier_flood", 11)])
def test_same_trace_and_prompts_as_the_jax_package(name, seed):
    """Same seed and preset: byte-identical trace JSON and identical
    materialized prompts in both packages, and each package reads the
    other's JSON back to the same document."""
    ours = preset(name, seed=seed, duration_s=0.5)
    theirs = jax_loadgen.preset(name, seed=seed, duration_s=0.5)
    assert ours.to_json() == theirs.to_json()
    for bt, max_blocks in ((8, None), (16, 4)):
        assert ours.prompts(bt, vocab=128, max_blocks=max_blocks) == \
            theirs.prompts(bt, vocab=128, max_blocks=max_blocks)
    assert Trace.from_json(theirs.to_json()).to_json() == theirs.to_json()
    assert jax_loadgen.Trace.from_json(ours.to_json()).to_json() == ours.to_json()
    assert loadgen.PRESETS == jax_loadgen.PRESETS
    assert loadgen.TRACE_VERSION == jax_loadgen.TRACE_VERSION
