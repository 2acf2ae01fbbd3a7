"""The port's phase spans (infinistore_tpu_torch/tracing.py, module
docstring; docs/observability.md, "The port's phase spans"): the engine's
gate, fetch, install, model calls, waves and saves, the KV writer's and the
engine's blocking waits on the event loop, and one span per store wire op,
on a CPU harness of a tiny Llama over the port's loopback store. Also: with
tracing off no span is made and the wire bytes carry no trace context, and a
span's stamps land on a profiler event's clock through the documented
mapping."""

import asyncio

import numpy as np
import pytest
import torch

from infinistore_tpu_torch import config as tconfig
from infinistore_tpu_torch import lib as tlib
from infinistore_tpu_torch import tracing, wire
from infinistore_tpu_torch.connector import KVConnector
from infinistore_tpu_torch.engine import ContinuousBatchingHarness, EngineKVAdapter
from infinistore_tpu_torch.models import llama as tl

CFG = tl.LlamaConfig(vocab=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
                     block_tokens=8, dtype=torch.float32)
NUM_BLOCKS = 32
MAX_REQ_BLOCKS = 4
GEN = 8  # with a 3-block prompt, the answer fills the fourth block


@pytest.fixture(scope="module")
def params():
    return tl.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture()
def conn():
    srv = tlib.start_local_server(prealloc_bytes=64 << 20, block_bytes=64 << 10)
    c = tlib.InfinityConnection(tconfig.ClientConfig(
        host_addr="127.0.0.1", service_port=srv.port, log_level="error"))
    c.connect()
    yield c
    c.close()
    srv.stop()


@pytest.fixture()
def traced():
    rec = tracing.configure(enabled=True, capacity=1 << 14, slow_op_us=0)
    rec.clear()
    yield rec
    tracing.configure(enabled=False)


def _harness(conn, params, model_id):
    kv = KVConnector(conn, CFG.kv_spec(NUM_BLOCKS), model_id, max_blocks=MAX_REQ_BLOCKS,
                     device="cpu")
    return ContinuousBatchingHarness(EngineKVAdapter(kv), params, CFG, NUM_BLOCKS,
                                     MAX_REQ_BLOCKS, device="cpu")


def _prompts():
    """A first prompt of three blocks, then two that share its first two."""
    rng = np.random.default_rng(7)
    bt = CFG.block_tokens
    shared = rng.integers(0, CFG.vocab, size=2 * bt).tolist()
    return [shared + rng.integers(0, CFG.vocab, size=bt).tolist() for _ in range(3)]


def _serve(conn, params, model_id):
    """The first prompt alone (a miss: prefill), then the other two
    overlapping (hits: fetch, install, resume, shared waves)."""
    h = _harness(conn, params, model_id)
    first, *rest = _prompts()

    async def go():
        a = await h.run_request(first, gen_tokens=GEN)
        b, c = await asyncio.gather(*(h.run_request(p, gen_tokens=GEN) for p in rest))
        return [a, b, c]

    return asyncio.run(go())


def _stamps(span, name):
    return [t for s, t in span["stages"] if s == name]


def test_phase_spans_stages_and_parents(conn, params, traced):
    stats = _serve(conn, params, "trace-phases")
    spans = traced.snapshot()
    assert traced.dropped == 0
    by_id = {s["span_id"]: s for s in spans}
    names = {s["name"] for s in spans}
    assert names == set(tracing.SPAN_NAMES), names ^ set(tracing.SPAN_NAMES)
    assert all(s["status"] == "ok" for s in spans), [s for s in spans if s["status"] != "ok"]
    requests = [s for s in spans if s["name"] == "engine_request"]
    assert len(requests) == 3

    def parent(s):
        return by_id.get(s["parent_id"])

    for s in spans:
        n = s["name"]
        if n in ("engine_request", "model.wave"):
            assert s["parent_id"] == 0, s  # roots
            continue
        p = parent(s)
        assert p is not None and p["trace_id"] == s["trace_id"], s
        if n in ("engine.fetch", "engine.install", "engine.save", "model.prefill",
                 "model.resume"):
            assert p["name"] == "engine_request", (s, p)
        elif n == "engine.gate":
            kind = s["attrs"]["kind"]
            want = {"snapshot": "engine.save", "wave": "model.wave"}.get(kind, "engine_request")
            assert p["name"] == want, (s, p)
            assert len(_stamps(s, "acquire")) == 1 and s["start_us"] <= _stamps(
                s, "acquire")[0] <= s["end_us"]
        elif n == "loop.block":
            what = s["attrs"]["what"]
            assert what in ("d2h", "h2d", "token"), s
            want = {"d2h": {"engine.save"}, "token": {"engine_request"},
                    "h2d": {"model.wave", "engine.save", "engine_request"}}[what]
            assert p["name"] in want, (s, p)
        elif n.startswith("store."):
            assert p["name"] in ("engine.save", "engine.fetch"), (s, p)
            # One wire op: one submit, one completion, in order.
            sub, done = _stamps(s, "submit"), _stamps(s, "completion_ring")
            assert len(sub) == 1 and len(done) == 1, s
            assert s["start_us"] <= sub[0] <= done[0] <= s["end_us"]
    kinds = {s["attrs"]["kind"] for s in spans if s["name"] == "engine.gate"}
    assert kinds == {"prefill", "install", "resume", "wave", "snapshot"}, kinds
    # The miss prefilled, the two hits fetched, installed and resumed.
    assert sum(s["name"] == "model.prefill" for s in spans) == 1
    assert sum(s["name"] == "model.resume" for s in spans) == 2
    assert sum(s["name"] == "engine.fetch" for s in spans) == 3  # the miss's is empty
    installs = [s for s in spans if s["name"] == "engine.install"]
    assert len(installs) == 2
    for s in installs:
        (staged,) = _stamps(s, "staged")
        assert s["start_us"] <= staged <= s["end_us"]
    fetch_ids = {s["span_id"] for s in spans if s["name"] == "engine.fetch"}
    assert any(s["name"] == "store.read_cache" and s["parent_id"] in fetch_ids for s in spans)
    # Saves: each request saves its prompt's suffix before the first token
    # and its answer's block after it, each through the writer.
    saves = [s for s in spans if s["name"] == "engine.save"]
    assert sorted(s["attrs"]["path"] for s in saves) == ["response"] * 3 + ["ttft"] * 3
    block_bytes = 2 * CFG.n_layers * CFG.block_tokens * CFG.n_kv_heads * CFG.head_dim * 4
    for s in saves:
        assert s["attrs"]["bytes"] == s["attrs"]["blocks"] * block_bytes
        kids = [k for k in spans if k["parent_id"] == s["span_id"]]
        assert {k["name"] for k in kids} >= {"engine.gate", "store.write_cache", "loop.block"}
        assert sum(k["name"] == "loop.block" and k["attrs"]["what"] == "d2h"
                   for k in kids) == CFG.n_layers
    # Waves: roots that name their rows' requests, stamped in order.
    waves = [s for s in spans if s["name"] == "model.wave"]
    assert sum(w["attrs"]["tokens"] for w in waves) == sum(
        GEN + ((3 * CFG.block_tokens + GEN) % CFG.block_tokens == 0) for _ in stats)
    assert max(w["attrs"]["rows"] for w in waves) == 2
    for w in waves:
        take, acq, launched = (_stamps(w, x) for x in ("take", "acquire", "launched"))
        assert len(take) == len(acq) == len(launched) == 1
        assert w["start_us"] <= take[0] <= acq[0] <= launched[0] <= w["end_us"]
        a = w["attrs"]
        assert a["graph"] == "eager"  # a CPU harness has no CUDA graphs
        assert len(a["requests"]) == len(a["enqueued_us"]) == a["rows"]
        assert a["t_bucket"] >= a["tokens"] >= a["rows"] and a["pages"] >= a["rows"]
        assert set(a["requests"]) <= {s["trace_id"] for s in requests}
        assert all(e <= take[0] for e in a["enqueued_us"])
    # Requests: enqueue, prefix_ready, one token stamp per generated token,
    # and ttft_us is the first token stamp less the enqueue stamp.
    for st, req in zip(stats, sorted(requests, key=lambda s: s["start_us"])):
        (enq,) = _stamps(req, "enqueue")
        (ready,) = _stamps(req, "prefix_ready")
        toks = _stamps(req, "token")
        assert len(toks) == len(st.generated) == GEN
        assert enq <= ready <= toks[0] and toks == sorted(toks)
        assert st.ttft_us == pytest.approx(toks[0] - enq, abs=1.0)
        assert st.prefix_ready_us == pytest.approx(ready - enq, abs=1.0)
        assert sum(1 for s in spans if s["name"] == "loop.block"
                   and s["attrs"]["what"] == "token" and s["parent_id"] == req["span_id"]) \
            == GEN  # one device-to-host copy a round, one token a round


def test_tracing_off_makes_no_span_and_leaves_wire_bytes(conn, params, monkeypatch):
    tracing.configure(enabled=False)

    def refuse(*a, **kw):
        raise AssertionError("a Span was made with tracing off")

    monkeypatch.setattr(tracing.Span, "__init__", refuse)
    seen = []
    for name in ("its_conn_put_batch", "its_conn_get_batch"):
        real = getattr(tlib.lib, name)

        def spy(*args, _real=real):
            seen.append(args[-2:])  # (trace id, span id) as passed to the wire
            return _real(*args)

        monkeypatch.setattr(tlib.lib, name, spy)
    stats = _serve(conn, params, "trace-off")
    assert [len(s.generated) for s in stats] == [GEN] * 3
    assert seen and all(ids == (0, 0) for ids in seen), set(seen)
    plain = wire.BatchMeta(block_size=4096, keys=["k0", "k1"])
    for trace_id, span_id in set(seen):
        tagged = wire.BatchMeta(block_size=4096, keys=["k0", "k1"], trace_id=trace_id,
                                trace_parent=span_id)
        assert tagged.encode() == plain.encode()


def test_traced_wire_op_carries_its_own_span_id(conn, traced, monkeypatch):
    seen = []
    real = tlib.lib.its_conn_put_batch

    def spy(*args):
        seen.append(args[-2:])
        return real(*args)

    monkeypatch.setattr(tlib.lib, "its_conn_put_batch", spy)
    buf = np.arange(4 * 4096, dtype=np.uint8)
    conn.register_mr(buf.ctypes.data, buf.nbytes)

    async def go():
        with tracing.trace_op("caller") as sp:
            await conn.write_cache_async([("a", 0), ("b", 4096)], 4096, buf.ctypes.data)
            await conn.write_cache_async([("c", 8192)], 4096, buf.ctypes.data,
                                         priority=wire.PRIORITY_BACKGROUND)
        return sp

    sp = asyncio.run(go())
    ops = [s for s in traced.snapshot() if s["name"] == "store.write_cache"]
    assert len(ops) == 2 and all(s["parent_id"] == sp.span_id for s in ops)
    assert seen == [(sp.trace_id, s["span_id"]) for s in ops]
    assert _stamps(sp.as_dict(), "submit") == []  # the caller's span is not stamped
    assert "bg_gate_us" in ops[1]["attrs"] and ops[1]["attrs"]["priority"] == 1


def test_span_contains_profiled_op_on_the_mapped_clock(traced):
    from h100bench.trace import DeviceTrace  # the benchmark's profiler anchor

    a, b = torch.randn(384, 384), torch.randn(384, 384)
    dtrace = DeviceTrace(torch)
    dtrace.start()
    span = tracing.start_span("probe")
    for _ in range(4):
        torch.mm(a, b)
    span.finish()
    dtrace.stop()
    off = tracing.perf_counter_offset_s()
    s0, s1 = span.t0_us / 1e6 + off, span.t1_us / 1e6 + off
    mms = [e for e in dtrace.events() if e.name == "aten::mm"]
    assert len(mms) == 4
    for e in mms:
        assert s0 - 100e-6 <= e.start and e.start + e.dur <= s1 + 100e-6, (s0, s1, e)


def test_perf_counter_mapping_round_trips():
    off = tracing.perf_counter_offset_s()
    import time

    t = time.perf_counter()
    assert abs(tracing.us_of_perf(t) / 1e6 + off - t) < 2e-6
    assert abs(tracing.now_us() / 1e6 + off - time.perf_counter()) < 1e-3
