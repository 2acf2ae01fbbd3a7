"""The port's overlapped layerwise prefill→decode handoff
(``infinistore_tpu_torch.disagg``) on the CPU, through the kernels' plain
versions, on the port's own loopback store.

- The port's versions of the 9 tests of ``tests/test_disagg_overlap.py``:
  the watermark (install before compute per layer, the blocking degenerate
  case, the clamp), byte identity (overlapped and blocking bitwise the local
  oracle, over 4 greedy tokens too), the fallback (counted, journaled with
  the failed layer, still bitwise the oracle), the manage plane through the
  port's ``ManageServer`` (``/metrics`` and ``GET /disagg``), and a kill -9 of
  the port's own prefill process mid-handoff (chaos).
- The five layer entry points against the JAX package's on the same numpy
  inputs (2e-4 in f32), and ``prefill`` / ``verify_step_batched`` bitwise
  the chain of those functions.
- The port's ``DisaggHarness`` first logits (local and overlapped) within
  2e-4 of the JAX ``DisaggHarness.run_local`` for the same weights, and
  handoffs across the packages both ways: a JAX prefill process ships and
  the port's ``overlapped_decode`` takes it, and the port's prefill process
  ships and the JAX harness takes it, with no fallback.
- ``LayerwisePrefetch.install_layer`` / ``layer_ready``: out-of-order layers
  raise, a layer missing past its deadline returns ``ok=False`` and gives
  the staging back, the re-probe counts ``retry_stalls``, the fetch gate
  holds a layer's read.
- The server copy exports the port's counters (it must observe
  ``infinistore_tpu_torch.disagg``, not the JAX package's module).
"""

import asyncio
import json
import os
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import infinistore_tpu as its
from infinistore_tpu import disagg as jdisagg
from infinistore_tpu.models import llama as jl
from infinistore_tpu_torch import config as tconfig
from infinistore_tpu_torch import disagg, telemetry
from infinistore_tpu_torch import lib as tlib
from infinistore_tpu_torch.connector import KVConnector
from infinistore_tpu_torch.cuda.layerwise import PrefetchDiscarded
from infinistore_tpu_torch.models import llama as tl
from tools import fleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = disagg.demo_config(n_layers=4)
JCFG = jdisagg.demo_config(n_layers=4)
REQ_BLOCKS = 2
NUM_BLOCKS = 16
TOL = 2e-4


@pytest.fixture(autouse=True)
def _fresh_counters():
    telemetry.reset()
    ds = disagg.reset_counters()
    yield ds
    telemetry.reset()


@pytest.fixture(scope="module")
def store():
    srv = tlib.start_local_server(
        prealloc_bytes=64 << 20,
        block_bytes=max(64 << 10, CFG.kv_spec(1).block_nbytes),
    )
    yield srv
    srv.stop()


def _conn_factory(store, conns):
    def make_conn():
        c = tlib.InfinityConnection(tconfig.ClientConfig(
            host_addr="127.0.0.1", service_port=store.port, log_level="error",
        ))
        c.connect()
        conns.append(c)
        return c

    return make_conn


def _jax_conn_factory(store, conns):
    def make_conn():
        c = its.InfinityConnection(its.ClientConfig(
            host_addr="127.0.0.1", service_port=store.port, log_level="error",
        ))
        c.connect()
        conns.append(c)
        return c

    return make_conn


@pytest.fixture()
def harness(store):
    conns = []
    h = disagg.DisaggHarness(
        _conn_factory(store, conns), CFG, num_blocks=NUM_BLOCKS, req_blocks=REQ_BLOCKS,
        device="cpu",
    )
    yield h
    h.close()
    for c in conns:
        c.close()


@pytest.fixture(scope="module")
def weights():
    """The JAX demo weights (seed 0) and the same values in the port."""
    jparams = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tparams = tl.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, CFG,
                                   device="cpu")
    return jparams, tparams


def _event_index(events, kind, layer):
    return events.index((kind, layer))


def _subprocess_env():
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


def _spawn(argv):
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, text=True, cwd=REPO,
                            env=_subprocess_env())
    return {"proc": proc, "argv": argv}


def _run_to_done(member, timeout_s=180.0):
    try:
        fleet.read_until_markers(member, ["prefill done"], timeout_s=timeout_s)
        assert member["proc"].wait(timeout=30) == 0
    finally:
        if member["proc"].poll() is None:
            member["proc"].kill()
            member["proc"].wait()


# -- (a) the oracle's 9 tests ------------------------------------------------


class TestWatermark:
    def test_install_precedes_compute_per_layer(self, harness):
        ev = []
        res = asyncio.run(harness.run_overlapped(
            harness.prompt(seed=1), watermark=1, trace_events=ev,
        ))["result"]
        assert not res.fallback
        for layer in range(CFG.n_layers):
            assert (
                _event_index(ev, "install", layer) < _event_index(ev, "compute", layer)
            ), f"layer {layer} computed before its install: {ev}"
        # The first compute did not wait for the deepest layer's install.
        assert _event_index(ev, "compute", 0) < _event_index(ev, "install", CFG.n_layers - 1)

    def test_watermark_full_degenerates_to_blocking(self, harness):
        ev = []
        res = asyncio.run(harness.run_overlapped(
            harness.prompt(seed=2), watermark=CFG.n_layers, trace_events=ev,
        ))["result"]
        assert not res.fallback
        last_install = max(i for i, (kind, _) in enumerate(ev) if kind == "install")
        first_compute = min(i for i, (kind, _) in enumerate(ev) if kind == "compute")
        assert last_install < first_compute
        assert res.overlap_layers == 0

    def test_watermark_clamped(self, harness):
        for wm in (0, CFG.n_layers + 7):
            res = asyncio.run(harness.run_overlapped(
                harness.prompt(seed=3), watermark=wm,
            ))["result"]
            assert not res.fallback


class TestByteIdentity:
    def test_overlapped_and_blocking_match_oracle(self, harness, _fresh_counters):
        prompt = harness.prompt(seed=4)
        oracle = asyncio.run(harness.run_local(prompt))["result"]
        over = asyncio.run(harness.run_overlapped(prompt, watermark=1))["result"]
        harness.drop(prompt)
        blocking = asyncio.run(harness.run_blocking(prompt))["result"]
        assert harness.check_bytes(over, oracle)
        assert harness.check_bytes(blocking, oracle)
        assert not over.fallback and not blocking.fallback
        assert _fresh_counters.status()["disagg_wrong_bytes"] == 0

    def test_multi_token_decode_matches(self, harness):
        prompt = harness.prompt(seed=5)
        oracle = asyncio.run(harness.run_local(prompt, gen_tokens=4))["result"]
        over = asyncio.run(
            harness.run_overlapped(prompt, watermark=1, gen_tokens=4)
        )["result"]
        assert over.tokens == oracle.tokens
        assert harness.check_bytes(over, oracle)


class TestFallback:
    def test_missing_layers_fall_back_and_stay_correct(self, harness, _fresh_counters):
        prompt = harness.prompt(seed=6)
        res = asyncio.run(harness.run_overlapped(
            prompt, watermark=1, prefill=False, retry_missing_s=0.05,
        ))["result"]
        assert res.fallback
        oracle = asyncio.run(harness.run_local(prompt))["result"]
        assert harness.check_bytes(res, oracle)
        st = _fresh_counters.status()
        assert st["disagg_fallback_recomputes"] == 1
        assert st["disagg_wrong_bytes"] == 0
        kinds = [e["kind"] for e in telemetry.get_journal().snapshot()]
        assert "disagg_fallback" in kinds

    def test_fallback_journal_names_the_failed_layer(self, harness):
        asyncio.run(harness.run_overlapped(
            harness.prompt(seed=7), watermark=1, prefill=False, retry_missing_s=0.05,
        ))
        ev = [e for e in telemetry.get_journal().snapshot() if e["kind"] == "disagg_fallback"]
        assert ev and ev[0]["attrs"]["failed_layer"] == 0
        assert ev[0]["attrs"]["prefix_blocks"] == REQ_BLOCKS


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.read().decode()


def _manage_plane(store):
    """``/metrics`` and ``GET /disagg`` of the port's ``ManageServer``,
    served in this process."""
    from infinistore_tpu_torch.server import ManageServer

    cfg = tconfig.ServerConfig(
        host="127.0.0.1", service_port=0, manage_port=1, prealloc_size=1,
        minimal_allocate_size=16, pin_memory=False, log_level="error",
    )

    async def run():
        manage = ManageServer(cfg)
        manage._server = await asyncio.start_server(manage._handle, host="127.0.0.1", port=0)
        port = manage._server.sockets[0].getsockname()[1]
        try:
            metrics = await asyncio.to_thread(_get, port, "/metrics")
            doc = json.loads(await asyncio.to_thread(_get, port, "/disagg"))
        finally:
            manage._server.close()
            await manage._server.wait_closed()
        return metrics, doc

    old = tlib._server_handle
    tlib._server_handle = store.handle
    try:
        return asyncio.run(run())
    finally:
        tlib._server_handle = old


class TestManagePlane:
    def test_metrics_and_disagg_route_export_counters(self, harness, store):
        asyncio.run(harness.run_overlapped(harness.prompt(seed=8)))
        metrics, doc = _manage_plane(store)
        st = disagg.counters().status()
        assert st["disagg_handoffs"] >= 1
        assert doc["enabled"] is True
        for key, val in st.items():
            assert doc[key] == val
            assert f"infinistore_{key} {val}" in metrics


@pytest.mark.chaos
class TestChaos:
    def test_prefill_killed_mid_stream_degrades_to_fallback(
        self, harness, store, _fresh_counters
    ):
        """kill -9 the port's prefill process mid-handoff (layers 0..1
        durable, deeper layers never arrive): the decode side's retry
        deadline expires and the leg recomputes, never wrong bytes."""
        member = _spawn(disagg.prefill_argv(
            store.port, blocks=REQ_BLOCKS, n_layers=CFG.n_layers, prompt_seed=9,
            stall_after_layer=1, stall_s=60.0, device="cpu",
        ))
        try:
            fleet.read_until_markers(
                member, ["shipped layer 0", "shipped layer 1"], timeout_s=180.0,
            )
            assert fleet.kill_member(member) == -9
        finally:
            if member["proc"].poll() is None:
                member["proc"].kill()
                member["proc"].wait()
        prompt = harness.prompt(seed=9)
        res = asyncio.run(harness.run_overlapped(
            prompt, watermark=1, prefill=False, retry_missing_s=0.5,
        ))["result"]
        assert res.fallback
        oracle = asyncio.run(harness.run_local(prompt))["result"]
        assert harness.check_bytes(res, oracle)
        st = _fresh_counters.status()
        assert st["disagg_fallback_recomputes"] == 1
        assert st["disagg_wrong_bytes"] == 0
        ev = [e for e in telemetry.get_journal().snapshot() if e["kind"] == "disagg_fallback"]
        assert ev and ev[0]["attrs"]["failed_layer"] >= 2


# -- (b) the layer entry points against the JAX package's ---------------------

S = 2 * CFG.block_tokens  # a two-block prompt
MAX_BLOCKS = 4


def _layer_inputs():
    rng = np.random.default_rng(7)
    spec = CFG.kv_spec(NUM_BLOCKS)
    return {
        "tokens": rng.integers(0, CFG.vocab, S).astype(np.int32),
        "x": rng.standard_normal((1, S, CFG.dim)).astype(np.float32),
        "k": rng.standard_normal(spec.cache_shape).astype(np.float32),
        "v": rng.standard_normal(spec.cache_shape).astype(np.float32),
        "table": np.array([5, 11], np.int32),
        "wave_tokens": rng.integers(0, CFG.vocab, (2, 3)).astype(np.int32),
        "wave_x": rng.standard_normal((2, 3, CFG.dim)).astype(np.float32),
        "positions": np.array([[17, 18, 19], [9, 10, 11]], np.int32),
        "tables": np.array([[5, 11, 12, 0], [3, 4, 0, 0]], np.int32),
    }


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("fn", ["embed_prompt", "prefill_layer", "lm_logits", "embed_wave",
                                "decode_wave_layer"])
def test_layer_function_matches_jax(weights, fn):
    jparams, tparams = weights
    inp = _layer_inputs()
    layer = 2
    if fn == "embed_prompt":
        _close(tl.embed_prompt(tparams, _t(inp["tokens"])),
               jl.embed_prompt(jparams, jnp.asarray(inp["tokens"])))
    elif fn == "embed_wave":
        _close(tl.embed_wave(tparams, _t(inp["wave_tokens"])),
               jl.embed_wave(jparams, jnp.asarray(inp["wave_tokens"])))
    elif fn == "lm_logits":
        _close(tl.lm_logits(tparams, _t(inp["x"])), jl.lm_logits(jparams, jnp.asarray(inp["x"])))
    elif fn == "prefill_layer":
        got = tl.prefill_layer(tparams, _t(inp["x"]), _t(inp["k"]), _t(inp["v"]),
                               _t(inp["table"]), CFG, layer)
        want = jl.prefill_layer(jparams, jnp.asarray(inp["x"]), jnp.asarray(inp["k"]),
                                jnp.asarray(inp["v"]), jnp.asarray(inp["table"]), JCFG, layer)
        for g, w in zip(got, want):
            _close(g, w)
    else:
        got = tl.decode_wave_layer(tparams, _t(inp["wave_x"]), _t(inp["positions"]),
                                   _t(inp["k"]), _t(inp["v"]), _t(inp["tables"]), CFG, layer,
                                   MAX_BLOCKS)
        want = jl.decode_wave_layer(jparams, jnp.asarray(inp["wave_x"]),
                                    jnp.asarray(inp["positions"]), jnp.asarray(inp["k"]),
                                    jnp.asarray(inp["v"]), jnp.asarray(inp["tables"]), JCFG,
                                    layer, MAX_BLOCKS)
        for g, w in zip(got, want):
            _close(g, w)


# -- (c) prefill and verify_step_batched are the chains -----------------------


def test_prefill_is_bitwise_the_layer_chain(weights):
    _, tparams = weights
    inp = _layer_inputs()
    caches = [(_t(inp["k"]), _t(inp["v"])) for _ in range(CFG.n_layers)]
    chain_caches = [(k.clone(), v.clone()) for k, v in caches]
    logits, caches = tl.prefill(tparams, _t(inp["tokens"]), caches, _t(inp["table"]), CFG)
    x = tl.embed_prompt(tparams, _t(inp["tokens"]))
    for layer in range(CFG.n_layers):
        x, k, v = tl.prefill_layer(tparams, x, *chain_caches[layer], _t(inp["table"]), CFG,
                                   layer)
        chain_caches[layer] = (k, v)
    want = tl.lm_logits(tparams, x[:, -1:])[0, -1]
    assert torch.equal(logits, want)
    for (k, v), (ck, cv) in zip(caches, chain_caches):
        assert torch.equal(k, ck) and torch.equal(v, cv)


def test_verify_step_batched_is_bitwise_the_layer_chain(weights):
    _, tparams = weights
    inp = _layer_inputs()
    caches = [(_t(inp["k"]), _t(inp["v"])) for _ in range(CFG.n_layers)]
    chain_caches = [(k.clone(), v.clone()) for k, v in caches]
    logits, caches = tl.verify_step_batched(
        tparams, _t(inp["wave_tokens"]), _t(inp["positions"]), caches, _t(inp["tables"]), CFG,
        MAX_BLOCKS)
    x = tl.embed_wave(tparams, _t(inp["wave_tokens"]))
    for layer in range(CFG.n_layers):
        x, k, v = tl.decode_wave_layer(tparams, x, _t(inp["positions"]), *chain_caches[layer],
                                       _t(inp["tables"]), CFG, layer, MAX_BLOCKS)
        chain_caches[layer] = (k, v)
    assert torch.equal(logits, tl.lm_logits(tparams, x))
    for (k, v), (ck, cv) in zip(caches, chain_caches):
        assert torch.equal(k, ck) and torch.equal(v, cv)


# -- (d) the harness against the JAX harness ---------------------------------


@pytest.fixture()
def jax_harness(store, weights):
    conns = []
    h = jdisagg.DisaggHarness(
        _jax_conn_factory(store, conns), JCFG, num_blocks=NUM_BLOCKS, req_blocks=REQ_BLOCKS,
    )
    h.params = weights[0]  # what its constructor drew from seed 0, stated
    yield h
    for c in conns:
        c.close()


@pytest.fixture()
def port_harness_jax_weights(store, weights):
    conns = []
    h = disagg.DisaggHarness(
        _conn_factory(store, conns), CFG, num_blocks=NUM_BLOCKS, req_blocks=REQ_BLOCKS,
        params=weights[1], device="cpu",
    )
    yield h
    h.close()
    for c in conns:
        c.close()


def test_harness_first_logits_match_the_jax_harness(port_harness_jax_weights, jax_harness):
    h = port_harness_jax_weights
    prompt = h.prompt(seed=11)
    assert prompt == jax_harness.prompt(seed=11)
    oracle = asyncio.run(jax_harness.run_local(prompt, gen_tokens=3))["result"]
    local = asyncio.run(h.run_local(prompt, gen_tokens=3))["result"]
    over = asyncio.run(h.run_overlapped(prompt, watermark=1, gen_tokens=3))["result"]
    assert not over.fallback
    np.testing.assert_allclose(local.first_logits, oracle.first_logits, rtol=0, atol=TOL)
    np.testing.assert_allclose(over.first_logits, oracle.first_logits, rtol=0, atol=TOL)
    assert h.check_bytes(over, local)


# -- (e) handoffs across the packages ----------------------------------------


def test_jax_prefill_process_hands_off_to_the_port(store, port_harness_jax_weights,
                                                    jax_harness):
    """``python -m infinistore_tpu.disagg`` ships a prompt into the store; the
    port's ``overlapped_decode`` takes it with no fallback, within 2e-4 of
    the JAX oracle."""
    h = port_harness_jax_weights
    seed = 12
    _run_to_done(_spawn(jdisagg.prefill_argv(
        store.port, blocks=REQ_BLOCKS, n_layers=CFG.n_layers, prompt_seed=seed)))
    prompt = h.prompt(seed=seed)
    over = asyncio.run(h.run_overlapped(prompt, watermark=1, prefill=False,
                                        retry_missing_s=10.0))["result"]
    assert not over.fallback
    oracle = asyncio.run(jax_harness.run_local(prompt))["result"]
    np.testing.assert_allclose(over.first_logits, oracle.first_logits, rtol=0, atol=TOL)
    h.drop(prompt)


def test_port_prefill_process_hands_off_to_jax(store, jax_harness, harness):
    """``python -m infinistore_tpu_torch.disagg --device cpu`` ships a prompt
    (its demo weights, seed 0); the JAX harness, holding the same weights,
    takes it with no fallback, within 2e-4 of the port's local oracle."""
    seed = 13
    jax_harness.params = {k: jnp.asarray(v.numpy()) for k, v in harness.params.items()}
    _run_to_done(_spawn(disagg.prefill_argv(
        store.port, blocks=REQ_BLOCKS, n_layers=CFG.n_layers, prompt_seed=seed,
        device="cpu")))
    prompt = harness.prompt(seed=seed)
    got = asyncio.run(jax_harness.run_overlapped(prompt, watermark=1, prefill=False,
                                                 retry_missing_s=10.0))["result"]
    assert not got.fallback
    oracle = asyncio.run(harness.run_local(prompt))["result"]
    np.testing.assert_allclose(np.asarray(got.first_logits), oracle.first_logits, rtol=0,
                               atol=TOL)
    harness.drop(prompt)


def test_prefill_process_rounds_drive_overlapped_and_cold_handoffs(store, harness):
    """The port's prefill role in ``--serve`` mode (``PrefillProcess``, its
    line protocol) against ``DisaggHarness.run_proc``: an announce-gated
    overlapped round and a cold round, both bitwise the local oracle."""

    async def run():
        proc = await disagg.PrefillProcess.spawn(
            store.port, blocks=REQ_BLOCKS, n_layers=CFG.n_layers, device="cpu")
        try:
            over = await harness.run_proc(proc, 15, watermark=1, gen_tokens=2)
            harness.drop(harness.prompt(seed=15))
            cold = await harness.run_proc(proc, 15, cold=True, gen_tokens=2)
            harness.drop(harness.prompt(seed=15))
        finally:
            await proc.close()
        oracle = (await harness.run_local(harness.prompt(seed=15), gen_tokens=2))["result"]
        return over, cold, oracle

    over, cold, oracle = asyncio.run(run())
    for leg in (over, cold):
        assert leg["written"] == 2 * REQ_BLOCKS * CFG.n_layers
        assert not leg["result"].fallback
        assert harness.check_bytes(leg["result"], oracle)
        assert leg["result"].tokens == oracle.tokens


# -- (f) install_layer / layer_ready ------------------------------------------


@pytest.fixture()
def kv(store):
    c = tlib.InfinityConnection(tconfig.ClientConfig(
        host_addr="127.0.0.1", service_port=store.port, log_level="error"))
    c.connect()
    kvc = KVConnector(c, CFG.kv_spec(NUM_BLOCKS), "install-layer", max_blocks=REQ_BLOCKS,
                      device="cpu")
    yield kvc
    kvc.close()
    c.close()


def _rand_caches(seed):
    rng = np.random.default_rng(seed)
    spec = CFG.kv_spec(NUM_BLOCKS)
    return [tuple(torch.from_numpy(rng.standard_normal(spec.cache_shape).astype(np.float32))
                  for _ in range(2)) for _ in range(CFG.n_layers)]


async def _drain_pool(pool, timeout_s=3.0):
    for _ in range(int(timeout_s / 0.02)):
        if pool.slots_in_use == 0:
            return
        await asyncio.sleep(0.02)
    raise AssertionError(f"staging slots leaked: {pool.slots_in_use} in use")


SRC = np.array([3, 9], np.int32)
DST = np.array([12, 1], np.int32)


def _assert_layer(out, src_caches, layer):
    for side in (0, 1):
        assert torch.equal(out[layer][side][DST.tolist()], src_caches[layer][side][SRC.tolist()])


def test_install_layer_in_order_lands_bitwise_and_refuses_out_of_order(kv):
    toks = list(range(REQ_BLOCKS * CFG.block_tokens))
    src = _rand_caches(1)

    async def run():
        await kv.save(toks, src, SRC)
        h = kv.start_fetch(toks)
        out = CFG.kv_spec(NUM_BLOCKS).make_caches("cpu")
        out, ok = await h.install_layer(out, DST, 1)
        assert ok and h.layer_ready(1)
        _assert_layer(out, src, 1)
        with pytest.raises(ValueError, match="strictly increasing"):
            await h.install_layer(out, DST, 0)
        with pytest.raises(ValueError, match="already installed"):
            await h.install_layer(out, DST, 1)
        for layer in (2, 3):
            out, ok = await h.install_layer(out, DST, layer)
            assert ok
            _assert_layer(out, src, layer)
        assert all(h.layer_ready(layer) for layer in range(CFG.n_layers))
        await h.discard()
        with pytest.raises(PrefetchDiscarded):
            await h.install_layer(out, DST, 3)
        await _drain_pool(kv._prefetch_pool)

    asyncio.run(run())


def test_install_layer_missing_past_deadline_is_not_ok_and_frees_the_pool(kv):
    toks = [5] * (REQ_BLOCKS * CFG.block_tokens)

    async def run():
        h = kv.start_fetch(toks, known_hit=REQ_BLOCKS, retry_missing_s=0.05,
                           retry_interval_s=0.005)
        out = CFG.kv_spec(NUM_BLOCKS).make_caches("cpu")
        before = [t.clone() for pair in out for t in pair]
        out, ok = await h.install_layer(out, DST, 0)
        assert not ok
        assert not h.layer_ready(0)
        assert h.retry_stalls > 0
        assert all(torch.equal(a, b) for a, b in zip(before, (t for p in out for t in p)))
        await _drain_pool(kv._prefetch_pool)

    asyncio.run(run())


def test_install_layer_reprobe_rides_a_late_save(kv):
    """Read racing write: the keys appear after the fetch started; the
    re-probes count ``retry_stalls`` and every layer installs bitwise."""
    toks = list(range(100, 100 + REQ_BLOCKS * CFG.block_tokens))
    src = _rand_caches(2)

    async def run():
        h = kv.start_fetch(toks, known_hit=REQ_BLOCKS, retry_missing_s=10.0,
                           retry_interval_s=0.002)
        await asyncio.sleep(0.05)
        await kv.save(toks, src, SRC)
        out = CFG.kv_spec(NUM_BLOCKS).make_caches("cpu")
        for layer in range(CFG.n_layers):
            out, ok = await h.install_layer(out, DST, layer)
            assert ok
            _assert_layer(out, src, layer)
        assert h.retry_stalls > 0
        await _drain_pool(kv._prefetch_pool)

    asyncio.run(run())


def test_fetch_gate_holds_the_layers_read(kv):
    toks = list(range(200, 200 + REQ_BLOCKS * CFG.block_tokens))
    src = _rand_caches(3)

    async def run():
        await kv.save(toks, src, SRC)
        opened = [asyncio.Event() for _ in range(CFG.n_layers)]

        async def gate(layer):
            await opened[layer].wait()

        h = kv.start_fetch(toks, known_hit=REQ_BLOCKS, fetch_gate=gate)
        await asyncio.sleep(0.05)
        assert not any(h.layer_ready(layer) for layer in range(CFG.n_layers))
        out = CFG.kv_spec(NUM_BLOCKS).make_caches("cpu")
        for layer in range(CFG.n_layers):
            opened[layer].set()
            out, ok = await h.install_layer(out, DST, layer)
            assert ok
            _assert_layer(out, src, layer)
        assert h.wait_stalls == CFG.n_layers
        await _drain_pool(kv._prefetch_pool)

    asyncio.run(run())


def test_handoff_moves_blocks_through_the_store(kv):
    """``KVConnector.handoff``'s store path: the blocks at ``src`` ids land
    bitwise at ``dst`` ids; a cache with an extra leading axis is refused."""
    toks = list(range(300, 300 + REQ_BLOCKS * CFG.block_tokens))
    caches = _rand_caches(4)
    src_caches = [(k.clone(), v.clone()) for k, v in caches]
    out, n = asyncio.run(kv.handoff(toks, caches, SRC, DST))
    assert n == REQ_BLOCKS
    for layer in range(CFG.n_layers):
        _assert_layer(out, src_caches, layer)
    stacked = [(k[None], v[None]) for k, v in caches]
    with pytest.raises(ValueError, match="per-layer caches of shape"):
        asyncio.run(kv.handoff(toks, stacked, SRC, DST))
    kv.drop(toks)


# -- (h) the server copy exports the port's counters --------------------------


def test_server_copy_exports_the_ports_counters_not_the_jax_packages(store, harness):
    from infinistore_tpu_torch import server

    jdisagg.reset_counters()  # the JAX package's ledger: all zeros
    asyncio.run(harness.run_overlapped(harness.prompt(seed=14)))
    disagg.counters().bump("disagg_overlap_layers", 5)
    assert server._disagg_status() == disagg.counters().status()
    import infinistore_tpu_torch.engine as tengine

    assert server._engine_wave_status() == tengine.wave_counters().status()
    metrics, doc = _manage_plane(store)
    want = disagg.counters().status()["disagg_overlap_layers"]
    assert want >= 5
    assert f"infinistore_disagg_overlap_layers {want}" in metrics
    assert doc["disagg_overlap_layers"] == want


def test_server_module_starts_and_answers_on_its_manage_port():
    """``python -m infinistore_tpu_torch.server`` serves the store and its
    manage plane (no card needed)."""
    service_port, manage_port = fleet.free_port(), fleet.free_port()
    env = _subprocess_env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.Popen([
        sys.executable, "-m", "infinistore_tpu_torch.server", "--host", "127.0.0.1",
        "--service-port", str(service_port), "--manage-port", str(manage_port),
        "--prealloc-size", "1", "--minimal-allocate-size", "16", "--no-pin-memory",
        "--log-level", "error",
    ], cwd=REPO, env=env)
    try:
        deadline = time.time() + 60
        while True:
            try:
                doc = json.loads(_get(manage_port, "/kvmap_len"))
                break
            except OSError:
                if time.time() > deadline or proc.poll() is not None:
                    raise
                time.sleep(0.1)
        assert "len" in doc
        selftest = json.loads(_get(manage_port, "/selftest"))
        assert selftest["status"] == "ok"
    finally:
        proc.send_signal(2)
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def test_chip_smoke_disagg_phase_rehearsal_on_cpu(store):
    """``chip_smoke.py``'s disagg path (its five legs, the round trip's
    oracle and every check) run here on the CPU at a tiny width with the
    path's block size and token counts, so its control flow is exercised by
    every test run."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = tl.LlamaConfig(vocab=1000, dim=64, n_layers=3, n_heads=4, n_kv_heads=2, ffn_dim=128,
                         block_tokens=16, dtype=torch.float32)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    summary, launches = chip_smoke._run_disagg(torch, store.port, params, cfg, "cpu",
                                               prompt_tokens=64)
    assert len(summary["rounds"]) == chip_smoke.DISAGG_ROUNDS
    for rnd in summary["rounds"]:
        legs = rnd["legs"]
        assert list(legs) == ["local", "overlapped", "blocking", "cold", "fallback"]
        assert legs["fallback"]["fallback"] and not legs["overlapped"]["fallback"]
        assert rnd["handoff_bytes"] == 2 * 4 * cfg.n_layers * cfg.kv_spec(1).block_nbytes
        assert rnd["counters"]["disagg_fallback_recomputes"] == 1
        assert rnd["counters"]["disagg_wrong_bytes"] == 0
    assert "profile_overlapped_leg" not in summary  # the profiler runs on the card only
    k3 = summary["k3_at_path_inputs"]  # the plain version against itself here
    assert k3["max_abs_err"] == 0.0 and k3["table_blocks"] == 4 + 1
    assert k3["seq_lens"] == [64 + 1 + step for step in range(chip_smoke.DISAGG_GEN_TOKENS)]
    assert all(launches[name] == 0 for name in chip_smoke.PATH_KERNELS["disagg"])  # no kernels
