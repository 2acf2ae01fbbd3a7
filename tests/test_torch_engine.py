"""The port's continuous-batching engine (infinistore_tpu_torch/engine.py)
under the tests the JAX package's engine passes (tests/test_engine_harness.py,
all 21, and the engine half of tests/test_prefetch.py), on the CPU with the
plain versions of the kernels, over the port's own loopback store. The
weights are the JAX package's ``init_params`` output carried across with
``params_from_numpy``.

Two pins change what they hold, by the port's decision on wave
byte-identity (``engine.WaveDecoder`` docstring): a mixed wave equals
sequential decode within ``WAVE_TOL`` (1e-5 absolute and relative, f32) on
logits and cache values, not bitwise. Their names are the reference's.

Two tests cross the packages: the JAX harness and the port's run the same
prompts on the same weights and must agree on block accounting and
generated tokens, and a prefix the JAX harness saved is a full hit for the
port's harness with byte-identical blocks."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import infinistore_tpu as its
from infinistore_tpu import engine as jengine
from infinistore_tpu.connector import KVConnector as JaxKVConnector
from infinistore_tpu.models import llama as jl
from infinistore_tpu_torch import config as tconfig
from infinistore_tpu_torch import lib as tlib
from infinistore_tpu_torch.connector import KVConnector
from infinistore_tpu_torch.engine import (
    BlockPool,
    ContinuousBatchingHarness,
    DeviceGate,
    EngineKVAdapter,
    NGramDrafter,
    WaveDecoder,
    reset_wave_counters,
    wave_counters,
)
from infinistore_tpu_torch.models import llama as tl

SHAPE = dict(vocab=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
             block_tokens=8)
CFG = tl.LlamaConfig(dtype=torch.float32, **SHAPE)  # float32: oracle comparisons
JCFG = jl.LlamaConfig(dtype=jnp.float32, **SHAPE)
NUM_BLOCKS = 32  # engine-side physical blocks
MAX_REQ_BLOCKS = 4
WAVE_TOL = 1e-5  # wave vs sequential decode, f32 logits and cache values


@pytest.fixture(scope="module")
def jparams():
    return jl.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jparams):
    return tl.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, CFG,
                                device="cpu")


def _prompts(n, shared_blocks, total_blocks, seed=0):
    """n prompts sharing the first shared_blocks blocks, diverging after."""
    bt = CFG.block_tokens
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, CFG.vocab, size=shared_blocks * bt).tolist()
    return [shared + rng.integers(0, CFG.vocab, size=(total_blocks - shared_blocks) * bt).tolist()
            for _ in range(n)]


def _connector(conn, model_id, cfg=CFG, num_blocks=NUM_BLOCKS):
    return KVConnector(conn, cfg.kv_spec(num_blocks), model_id, max_blocks=MAX_REQ_BLOCKS,
                       device="cpu")


def _harness(conn, params, model_id, verify=True, **kw):
    return ContinuousBatchingHarness(
        EngineKVAdapter(_connector(conn, model_id)), params, CFG, NUM_BLOCKS, MAX_REQ_BLOCKS,
        verify=verify, device="cpu", **kw,
    )


def _client(port):
    c = tlib.InfinityConnection(tconfig.ClientConfig(
        host_addr="127.0.0.1", service_port=port, log_level="error"))
    c.connect()
    return c


@pytest.fixture()
def server():
    srv = tlib.start_local_server(prealloc_bytes=64 << 20, block_bytes=64 << 10,
                                  enable_shm=True)
    yield srv
    srv.stop()


@pytest.fixture()
def conn(server):
    c = _client(server.port)
    yield c
    c.close()


def _clone(caches):
    return [(k.clone(), v.clone()) for k, v in caches]


def _assert_close_caches(a, b, what):
    for layer in range(CFG.n_layers):
        for kind in (0, 1):
            np.testing.assert_allclose(a[layer][kind].numpy(), b[layer][kind].numpy(),
                                       rtol=WAVE_TOL, atol=WAVE_TOL,
                                       err_msg=f"{what} (layer {layer} kind {kind})")


def test_concurrent_requests_share_prefix(conn, params):
    h = _harness(conn, params, "engine-a")
    m = asyncio.run(h.run(_prompts(8, shared_blocks=2, total_blocks=4), concurrency=4))
    assert m["requests"] == 8
    assert m["max_live_requests"] >= 2
    assert m["all_verified"]
    assert m["loaded_blocks"] > 0 and m["hit_rate"] > 0
    assert m["max_concurrent_saves"] >= 2
    assert m["recompute_saved_s"] > 0


def test_repeat_prompt_full_hit(conn, params):
    h = _harness(conn, params, "engine-b")
    p = _prompts(1, 1, 4)[0]
    s1 = asyncio.run(h.run_request(p))
    s2 = asyncio.run(h.run_request(p))
    assert s1.loaded_blocks == 0 and s1.computed_blocks == 4
    assert s2.loaded_blocks == 4 and s2.computed_blocks == 0
    assert s2.verified


def test_eviction_churn_correctness(params):
    spec = CFG.kv_spec(NUM_BLOCKS)
    srv = tlib.start_local_server(prealloc_bytes=24 * spec.block_nbytes,
                                  block_bytes=spec.block_nbytes, enable_shm=True,
                                  evict_min=0.5, evict_max=0.8)
    c = _client(srv.port)
    try:
        h = _harness(c, params, "engine-churn")
        fams = _prompts(3, 1, 4, seed=7)
        m = asyncio.run(h.run([fams[i % 3] for i in range(12)], concurrency=3))
        assert m["requests"] == 12
        assert m["all_verified"], "eviction churn delivered wrong bytes"
        assert m["computed_blocks"] > 0
    finally:
        c.close()
        srv.stop()


def test_resume_is_chunked_and_generation_waves_batch(conn, params):
    async def drive():
        h = _harness(conn, params, "engine-waves")
        fams = _prompts(4, shared_blocks=2, total_blocks=3, seed=13)
        await h.run_request(fams[0])
        h.stats.clear()
        return await h.run(fams[1:], concurrency=3, gen_tokens=8)

    m = asyncio.run(drive())
    assert m["all_verified"]
    assert m["loaded_blocks"] >= 3 * 2
    assert m["generated_tokens"] == 3 * 8
    assert 0 < m["decode_waves"] < 24
    assert m["max_wave_size"] >= 2


def test_generation_is_deterministic_under_wave_interleaving(conn, params):
    prompts = _prompts(3, shared_blocks=1, total_blocks=3, seed=17)

    async def concurrent():
        h = _harness(conn, params, "engine-det", verify=False)
        sem = asyncio.Semaphore(3)

        async def one(p):
            async with sem:
                return await h.run_request(p, gen_tokens=8)

        return [tuple(s.generated) for s in await asyncio.gather(*(one(p) for p in prompts))]

    async def solo():
        h = _harness(conn, params, "engine-det", verify=False)
        return [tuple((await h.run_request(p, gen_tokens=8)).generated) for p in prompts]

    assert asyncio.run(concurrent()) == asyncio.run(solo())


def test_multi_turn_conversation_hits_generated_blocks(conn, params):
    async def drive():
        h = _harness(conn, params, "engine-turns")
        bt = CFG.block_tokens
        turn1 = _prompts(1, 1, 2, seed=23)[0]
        s1 = await h.run_request(turn1, gen_tokens=bt)
        assert len(s1.generated) == bt
        return await h.run_request(turn1 + s1.generated)

    s2 = asyncio.run(drive())
    assert s2.hit_blocks == 3
    assert s2.loaded_blocks == 3 and s2.computed_blocks == 0
    assert s2.verified


def test_wave_sizes_bucket_to_powers_of_two(conn, params, monkeypatch):
    import infinistore_tpu_torch.engine as engine_mod

    shapes_seen = set()
    real = engine_mod.verify_step_ragged

    def recording(params_, tokens, positions, row_of, pages, *a, **kw):
        shapes_seen.add((int(a[3].shape[0]), int(tokens.shape[0]), int(pages.shape[0])))
        return real(params_, tokens, positions, row_of, pages, *a, **kw)

    monkeypatch.setattr(engine_mod, "verify_step_ragged", recording)
    h = _harness(conn, params, "engine-buckets")
    m = asyncio.run(h.run(_prompts(5, shared_blocks=1, total_blocks=2, seed=29),
                          concurrency=5, gen_tokens=6))
    assert m["all_verified"]
    assert m["generated_tokens"] == 5 * 6
    assert shapes_seen
    for b, t, p in shapes_seen:
        assert b & (b - 1) == 0 and t & (t - 1) == 0 and p & (p - 1) == 0, (b, t, p)
    assert shapes_seen == set(m["wave_buckets"])
    assert len(shapes_seen) <= 8, sorted(shapes_seen)
    assert 0.0 <= m["wave_pad_fraction"] < 0.5


def test_ngram_drafter_proposes_recurring_continuations():
    d = NGramDrafter(max_draft=3, ngram=2)
    assert d.draft([7, 8, 9, 10, 11, 5, 7, 8]) == [9, 10, 11]
    assert d.draft([4, 9, 1, 2, 9]) == [1, 2, 9]
    assert d.draft([1, 2, 3, 4]) == []
    assert d.draft([8, 2, 5, 8, 6, 8]) == [6, 8]
    assert NGramDrafter(max_draft=1, ngram=2).draft([7, 8, 9, 7, 8]) == [9]
    # Same proposals as the JAX drafter on a random history.
    hist = np.random.default_rng(3).integers(0, 6, 40).tolist()
    for cut in range(2, 40):
        assert d.draft(hist[:cut]) == jengine.NGramDrafter(max_draft=3, ngram=2).draft(hist[:cut])


def test_speculative_generation_matches_greedy_exactly(conn, params):
    bt = CFG.block_tokens
    prompts = [([11, 12, 13] * (2 * bt))[: 2 * bt], ([3, 7] * bt)[: 2 * bt],
               ([9, 9, 4, 2] * bt)[: 2 * bt]]

    async def run_with(drafter):
        h = _harness(conn, params, "engine-spec", verify=False)
        h.drafter = drafter
        stats = [await h.run_request(p, gen_tokens=2 * bt) for p in prompts]
        return h, [tuple(s.generated) for s in stats]

    h_plain, plain = asyncio.run(run_with(None))
    h_spec, spec = asyncio.run(run_with(NGramDrafter(max_draft=4)))
    assert spec == plain, "speculation changed greedy output"
    m = h_spec.metrics()
    assert m["spec_drafted_tokens"] > 0
    assert m["spec_tokens_per_step"] > 1.0
    assert h_spec.spec_rounds < h_plain.spec_rounds


def test_mixed_spec_and_decode_requests_share_waves(conn, params):
    bt = CFG.block_tokens

    async def drive():
        h = _harness(conn, params, "engine-mixed")
        h.drafter = NGramDrafter(max_draft=4)
        rng = np.random.default_rng(31)
        p_rep = ([21, 22] * bt)[: 2 * bt]
        p_rand = [rng.integers(0, CFG.vocab, size=2 * bt).tolist() for _ in range(2)]
        return await h.run([p_rep] + p_rand, concurrency=3, gen_tokens=bt)

    m = asyncio.run(drive())
    assert m["all_verified"]
    assert m["generated_tokens"] == 3 * bt
    assert m["max_wave_size"] >= 2
    assert any(t > b for b, t, _ in m["wave_buckets"]), m["wave_buckets"]


def _bare_wave_harness(params, caches):
    """A harness skeleton for driving a WaveDecoder directly (no store)."""
    h = ContinuousBatchingHarness.__new__(ContinuousBatchingHarness)
    h.params = params
    h.config = CFG
    h.caches = caches
    h.max_req_blocks = MAX_REQ_BLOCKS
    h.gate = DeviceGate()
    return h


def _skew_scenario(params):
    """Two 1-token decode rows + one 3-token chunk whose admission bumps
    the T bucket 2 -> 8 at pad 3/8 > 0.25: the canonical deferral case."""
    rng = np.random.default_rng(61)
    tables = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]], np.int32)
    prompts = [rng.integers(0, CFG.vocab, size=16).tolist() for _ in range(3)]
    base = CFG.kv_spec(NUM_BLOCKS).make_caches(device="cpu")
    for p, tab in zip(prompts, tables):
        _, base = tl.prefill(params, p, base, tab[:2], CFG)
    chunks = [([5], [16]), ([9, 11, 12], [16, 17, 18]), ([13], [16])]
    return tables, chunks, base


async def _sequential(params, base, tables, chunks):
    h = _bare_wave_harness(params, _clone(base))
    outs = []
    for b, (toks, pos) in enumerate(chunks):
        wave = WaveDecoder(h)  # fresh decoder: every wave is solo
        outs.append((await wave.step_chunk(toks, pos, tables[b])).numpy())
    return outs, h.caches


def test_ragged_wave_byte_identical_to_sequential_decode(params):
    """A MIXED wave (two 1-token decode rows beside a 3-token verification
    chunk, concatenated ragged) against advancing each request alone: equal
    within WAVE_TOL on logits and cache values (the port's decision, not
    bitwise; see engine.WaveDecoder)."""
    tables, chunks, base = _skew_scenario(params)

    async def wave_run():
        h = _bare_wave_harness(params, _clone(base))
        wave = WaveDecoder(h)
        outs = await asyncio.gather(*(wave.step_chunk(toks, pos, tables[b])
                                      for b, (toks, pos) in enumerate(chunks)))
        return [o.numpy() for o in outs], h.caches, wave

    wave_outs, wave_caches, wave = asyncio.run(wave_run())
    seq_outs, seq_caches = asyncio.run(_sequential(params, base, tables, chunks))
    assert wave.max_wave == 3, "requests did not coalesce into one wave"
    for b in range(3):
        np.testing.assert_allclose(wave_outs[b], seq_outs[b], rtol=WAVE_TOL, atol=WAVE_TOL,
                                   err_msg=f"request {b} logits diverged in the mixed wave")
    _assert_close_caches(wave_caches, seq_caches, "cache values diverged")
    assert (wave.launched_rows, wave.pad_rows) == (8, 3)


def test_wave_decoder_failure_fails_all_waiters(params):
    h = _bare_wave_harness(params, CFG.kv_spec(NUM_BLOCKS).make_caches(device="cpu"))
    wave = WaveDecoder(h)

    async def run():
        bad = np.zeros(MAX_REQ_BLOCKS, np.int32)
        t1 = asyncio.ensure_future(wave.step(1, 8, bad))
        t2 = asyncio.ensure_future(wave.step(2, 8, bad[:2]))  # wrong-shaped table
        r1, r2 = await asyncio.gather(t1, t2, return_exceptions=True)
        assert isinstance(r1, Exception) and isinstance(r2, Exception)
        logits = await wave.step(3, 8, np.arange(MAX_REQ_BLOCKS, dtype=np.int32))
        assert torch.isfinite(logits).all()
        assert wave.waves >= 1

    asyncio.run(run())


def test_block_pool_backpressure():
    async def run():
        pool = BlockPool(4)
        a = await pool.alloc(3)
        waiter = asyncio.ensure_future(pool.alloc(2))
        await asyncio.sleep(0.01)
        assert not waiter.done(), "alloc should have backpressured"
        await pool.free(a)
        assert len(await asyncio.wait_for(waiter, 1)) == 2

    asyncio.run(run())


def test_device_gate_excludes_mutators():
    async def run():
        gate = DeviceGate()
        order = []

        async def reader(name, hold):
            async with gate.shared():
                order.append(f"{name}+")
                await asyncio.sleep(hold)
                order.append(f"{name}-")

        async def writer():
            async with gate.exclusive():
                order.append("w+")
                order.append("w-")

        r1 = asyncio.ensure_future(reader("a", 0.02))
        r2 = asyncio.ensure_future(reader("b", 0.02))
        await asyncio.sleep(0.005)
        w = asyncio.ensure_future(writer())
        await asyncio.sleep(0.005)
        r3 = asyncio.ensure_future(reader("c", 0.0))
        await asyncio.gather(r1, r2, w, r3)
        assert order.index("b+") < order.index("a-")
        assert order.index("w+") > max(order.index("a-"), order.index("b-"))
        assert order.index("c+") > order.index("w-")

    asyncio.run(run())


def test_device_gate_expedite_jumps_queued_writers():
    async def run():
        gate = DeviceGate()
        order = []

        async def holder():
            async with gate.exclusive():
                order.append("hold")
                await asyncio.sleep(0.03)

        async def normal():
            async with gate.exclusive():
                order.append("prefill")

        async def install():
            async with gate.exclusive(expedite=True):
                order.append("install")

        h = asyncio.ensure_future(holder())
        await asyncio.sleep(0.005)
        n1, n2 = asyncio.ensure_future(normal()), asyncio.ensure_future(normal())
        await asyncio.sleep(0.005)
        i1 = asyncio.ensure_future(install())
        await asyncio.gather(h, n1, n2, i1)
        assert order[:2] == ["hold", "install"], order
        assert sorted(order[2:]) == ["prefill", "prefill"]

    asyncio.run(asyncio.wait_for(run(), 10))


def test_device_gate_cancelled_writer_releases_queued_readers():
    async def run():
        gate = DeviceGate()
        got = []

        async def hold_shared():
            async with gate.shared():
                await asyncio.sleep(0.05)

        async def writer():
            async with gate.exclusive():
                got.append("w")

        async def late_reader():
            async with gate.shared():
                got.append("r2")

        r1 = asyncio.ensure_future(hold_shared())
        await asyncio.sleep(0.01)
        w = asyncio.ensure_future(writer())
        await asyncio.sleep(0.01)
        r2 = asyncio.ensure_future(late_reader())
        await asyncio.sleep(0.01)
        w.cancel()
        await asyncio.gather(r1, r2, w, return_exceptions=True)
        assert got == ["r2"], got
        async with gate.exclusive():
            got.append("w2")
        assert got == ["r2", "w2"]

    asyncio.run(asyncio.wait_for(run(), 10))


# -- skew-aware wave flush policy ---------------------------------------------


def test_skew_policy_off_is_behavior_identical(params):
    tables, chunks, base = _skew_scenario(params)
    reset_wave_counters()

    async def run(**kw):
        h = _bare_wave_harness(params, _clone(base))
        wave = WaveDecoder(h, **kw)
        outs = await asyncio.gather(*(wave.step_chunk(toks, pos, tables[b])
                                      for b, (toks, pos) in enumerate(chunks)))
        return [o.numpy() for o in outs], h.caches, wave

    default_outs, default_caches, default_wave = asyncio.run(run())
    off_outs, off_caches, off_wave = asyncio.run(run(skew_policy=False))
    assert default_wave.skew_policy is False
    for a, b in zip(default_outs, off_outs):
        np.testing.assert_array_equal(a, b)
    for layer in range(CFG.n_layers):
        for kind in (0, 1):
            assert torch.equal(default_caches[layer][kind], off_caches[layer][kind])
    for w in (default_wave, off_wave):
        assert w.max_wave == 3
        assert (w.launched_rows, w.pad_rows) == (8, 3)
        assert w.deferrals == 0 and w.aging_escapes == 0
        assert w.held_flushes == 0 and w.defer_ages_us == []
    assert all(v == 0 for v in wave_counters().status().values())


def test_skew_policy_defers_outlier_and_stays_byte_identical(params):
    """Policy on: the bucket-bumping chunk rides a later wave while logits
    and cache values stay equal to sequential decode within WAVE_TOL (the
    port's decision, not bitwise; see engine.WaveDecoder)."""
    tables, chunks, base = _skew_scenario(params)
    reset_wave_counters()

    async def wave_run():
        h = _bare_wave_harness(params, _clone(base))
        wave = WaveDecoder(h, skew_policy=True, hold_max_s=0.0)
        outs = await asyncio.gather(*(wave.step_chunk(toks, pos, tables[b])
                                      for b, (toks, pos) in enumerate(chunks)))
        return [o.numpy() for o in outs], h.caches, wave

    wave_outs, wave_caches, wave = asyncio.run(wave_run())
    seq_outs, seq_caches = asyncio.run(_sequential(params, base, tables, chunks))
    assert wave.deferrals >= 1
    assert wave.max_wave == 2 and wave.waves == 2
    assert (wave.launched_rows, wave.pad_rows) == (6, 1)
    assert len(wave.defer_ages_us) >= 1
    for b in range(3):
        np.testing.assert_allclose(wave_outs[b], seq_outs[b], rtol=WAVE_TOL, atol=WAVE_TOL,
                                   err_msg=f"request {b} logits diverged under deferral")
    _assert_close_caches(wave_caches, seq_caches, "cache values diverged under deferral")
    st = wave_counters().status()
    assert st["engine_wave_deferrals"] >= 1
    assert st["engine_wave_policy_waves"] == 2
    assert st["engine_wave_defer_age_us_p99"] > 0
    assert 0 < st["engine_wave_bucket_occupancy"] <= 1


def test_skew_policy_aging_escape_under_outlier_flood(params):
    tables, chunks, base = _skew_scenario(params)
    reset_wave_counters()

    async def run():
        h = _bare_wave_harness(params, base)
        wave = WaveDecoder(h, skew_policy=True, defer_max_s=0.02, hold_max_s=0.0)
        toks, pos = chunks[1]
        outlier = asyncio.ensure_future(wave.step_chunk(toks, pos, tables[1]))
        floods = 0
        for _ in range(300):
            if outlier.done():
                break
            await asyncio.gather(wave.step(5, 16, tables[0]), wave.step(13, 16, tables[2]))
            floods += 1
        logits = await asyncio.wait_for(outlier, 30)
        return wave, logits, floods

    wave, logits, floods = asyncio.run(run())
    assert floods >= 1
    assert wave.deferrals >= 1 and wave.aging_escapes >= 1
    assert torch.isfinite(logits).all() and logits.shape[0] == 3
    assert max(wave.defer_ages_us) >= 0.02 * 1e6
    assert not wave._pending


def test_skew_policy_end_to_end_verified(conn, params):
    h = _harness(conn, params, "engine-skew", wave_skew_policy=True, wave_hold_max_s=0.0)
    assert h.wave.skew_policy is True
    m = asyncio.run(h.run(_prompts(6, shared_blocks=1, total_blocks=2, seed=3),
                          concurrency=6, gen_tokens=CFG.block_tokens))
    assert m["all_verified"] and m["requests"] == 6
    for k in ("wave_deferrals", "wave_aging_escapes", "wave_held_flushes",
              "wave_defer_age_us_p99", "p50_ttft_us", "p99_ttft_us", "p99_ttft_fg_us"):
        assert k in m, k
    assert m["p99_ttft_us"] > 0 and m["p99_ttft_fg_us"] > 0


def test_skew_policy_canonical_buckets_and_prewarm(conn, params):
    h = _harness(conn, params, "engine-canon", wave_skew_policy=True, wave_hold_max_s=0.0)

    async def drive():
        ladder = await h.prewarm_wave_buckets(max_rows=16)
        m = await h.run(_prompts(5, shared_blocks=1, total_blocks=2, seed=47),
                        concurrency=5, gen_tokens=6)
        return ladder, m

    ladder, m = asyncio.run(drive())
    mrb = MAX_REQ_BLOCKS
    assert ladder == [(t, t, t * mrb) for t in (1, 2, 4, 8, 16)]
    assert m["wave_prewarmed_buckets"] == ladder
    assert m["all_verified"]
    assert m["wave_buckets"]
    for b, t, p in m["wave_buckets"]:
        assert (b, t, p) == (t, t, t * mrb) and (b, t, p) in set(ladder)
    h_blind = _harness(conn, params, "engine-canon-off", verify=False)
    assert asyncio.run(h_blind.prewarm_wave_buckets()) == []
    assert h_blind.wave.prewarmed == set()


# -- the admission pipeline's payoffs (tests/test_prefetch.py, engine half) ---


async def _drain_pool(pool, timeout_s=3.0):
    for _ in range(int(timeout_s / 0.02)):
        if pool.slots_in_use == 0:
            return
        await asyncio.sleep(0.02)
    raise AssertionError(f"staging slots leaked: {pool.slots_in_use} in use")


def _prompt(seed, blocks=MAX_REQ_BLOCKS, cfg=CFG):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=blocks * cfg.block_tokens).tolist()


def test_engine_prefetch_cancelled_by_alloc_wait_releases_staging(conn, params):
    h = _harness(conn, params, "pf-eng-cancel", verify=False)
    p = _prompt(1)

    async def drive():
        await h.run_request(p)
        h.stats.clear()
        blockers = await h.pool.alloc(NUM_BLOCKS)
        task = asyncio.ensure_future(h.run_request(p))
        await asyncio.sleep(0.1)
        assert not task.done()
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        await h.pool.free(blockers)
        pool = h.adapter.connector._prefetch_pool
        assert pool is not None
        await _drain_pool(pool)
        assert h.metrics()["prefetch_waste"] > 0
        assert (await h.run_request(p)).loaded_blocks == MAX_REQ_BLOCKS

    asyncio.run(asyncio.wait_for(drive(), 30))


def test_engine_raced_eviction_falls_back_to_recompute(conn, params):
    h = _harness(conn, params, "pf-eng-race", verify=True)
    p = _prompt(2)

    async def drive():
        await h.run_request(p)
        h.stats.clear()
        task = asyncio.ensure_future(h.run_request(p))
        await asyncio.sleep(0)
        h.adapter.evict_request(p)
        s = await task
        assert s.verified
        assert s.computed_blocks == MAX_REQ_BLOCKS
        if s.raced_eviction:
            assert s.loaded_blocks == 0
        await _drain_pool(h.adapter.connector._prefetch_pool)

    asyncio.run(asyncio.wait_for(drive(), 30))


def test_engine_hit_admission_not_slower_than_miss(conn):
    """A prefix hit's end-to-end prefix residency must not be slower than a
    miss's full prefill, on a model big enough that recompute costs."""
    shape = dict(vocab=256, dim=256, n_layers=4, n_heads=4, n_kv_heads=2, ffn_dim=512,
                 block_tokens=16)
    big = tl.LlamaConfig(dtype=torch.float32, **shape)
    big_params = tl.init_params(big, torch.Generator().manual_seed(1), device="cpu")
    h = ContinuousBatchingHarness(
        EngineKVAdapter(_connector(conn, "pf-eng-hitmiss", big)), big_params, big,
        NUM_BLOCKS, MAX_REQ_BLOCKS, verify=False, device="cpu",
    )

    async def drive():
        seeds = [_prompt(100 + i, cfg=big) for i in range(6)]
        for p in seeds:
            await h.run_request(p)
        h.stats.clear()
        for i, p in enumerate(seeds):
            await h.run_request(p)  # hit
            await h.run_request(_prompt(200 + i, cfg=big))  # miss
        return h.metrics()

    m = asyncio.run(drive())
    assert m["hit_rate"] > 0
    assert m["p50_prefix_ready_hit_us"] <= m["p50_prefix_ready_miss_us"]


def test_engine_overlap_metrics_are_non_degenerate(conn, params):
    h = _harness(conn, params, "pf-eng-metrics", verify=False)

    async def drive():
        fams = [_prompt(300 + i) for i in range(3)]
        for p in fams:
            await h.run_request(p)
        h.stats.clear()
        sched = []
        for i in range(6):
            sched += [fams[i % 3], _prompt(400 + i)]
        return await h.run(sched, concurrency=4)

    m = asyncio.run(drive())
    for key in ("p50_gate_hold_us", "p99_gate_hold_us", "overlap_fraction", "prefetch_waste",
                "prefetch_fallbacks", "p50_prefix_ready_hit_us", "p50_prefix_ready_miss_us"):
        assert key in m, key
    assert m["p50_gate_hold_us"] > 0
    assert 0.0 < m["overlap_fraction"] <= 1.0
    assert 0.0 <= m["prefetch_waste"] <= 1.0
    misses = [s for s in h.stats if not s.loaded_blocks]
    assert misses and all(s.gate_hold_us == 0.0 and s.fetch_us == 0.0 for s in misses)
    per_req = [s.overlap_fraction for s in h.stats if s.overlap_fraction is not None]
    assert per_req and all(0.0 < f <= 1.0 for f in per_req)


def test_engine_fallback_when_arena_exhausted(conn, params):
    h = _harness(conn, params, "pf-eng-fallback", verify=True)
    p = _prompt(3)

    async def drive():
        await h.run_request(p)
        h.stats.clear()
        arena = h.adapter.connector._ensure_prefetch_pool()
        hog = arena.reserve(arena.num_slots)
        try:
            s = await h.run_request(p)
        finally:
            hog.release()
        assert h.prefetch_fallbacks == 1
        assert s.loaded_blocks == MAX_REQ_BLOCKS and s.verified
        assert h.metrics()["prefetch_fallbacks"] == 1

    asyncio.run(asyncio.wait_for(drive(), 30))


# -- across the packages --------------------------------------------------------


def _jax_harness(jconn, jparams, model_id, **kw):
    kvc = JaxKVConnector(jconn, JCFG.kv_spec(NUM_BLOCKS), model_id, max_blocks=MAX_REQ_BLOCKS)
    return jengine.ContinuousBatchingHarness(
        jengine.EngineKVAdapter(kvc), jparams, JCFG, NUM_BLOCKS, MAX_REQ_BLOCKS, **kw)


def _jax_client(port):
    c = its.InfinityConnection(its.ClientConfig(
        host_addr="127.0.0.1", service_port=port, log_level="error"))
    c.connect()
    return c


def test_jax_and_port_harnesses_agree_on_blocks_and_tokens(server, conn, params, jparams):
    """Concurrency 1, the same prompts (shared prefix, a repeat) and weights:
    the same hit / loaded / computed blocks per request and the same greedy
    tokens, drafts included."""
    prompts = _prompts(3, shared_blocks=2, total_blocks=3, seed=71)
    prompts.append(prompts[0])
    jconn = _jax_client(server.port)
    try:
        jh = _jax_harness(jconn, jparams, "cross-jax", verify=True,
                          drafter=jengine.NGramDrafter(max_draft=4))
        jm = asyncio.run(jh.run(prompts, concurrency=1, gen_tokens=6))
    finally:
        jconn.close()
    th = _harness(conn, params, "cross-port", drafter=NGramDrafter(max_draft=4))
    tm = asyncio.run(th.run(prompts, concurrency=1, gen_tokens=6))
    assert jm["all_verified"] and tm["all_verified"]
    for js, ts in zip(jh.stats, th.stats):
        assert (ts.hit_blocks, ts.loaded_blocks, ts.computed_blocks) == (
            js.hit_blocks, js.loaded_blocks, js.computed_blocks)
        assert ts.generated == js.generated
    for key in ("loaded_blocks", "computed_blocks", "generated_tokens", "spec_drafted_tokens",
                "spec_accepted_tokens"):
        assert tm[key] == jm[key], key


def test_jax_saved_prefix_is_a_full_hit_for_the_port(server, conn, params, jparams):
    """The JAX harness computes and saves a prompt; the port's harness then
    loads every block of it, computes none, and holds the same bytes."""
    p = _prompts(1, 1, MAX_REQ_BLOCKS, seed=73)[0]
    jconn = _jax_client(server.port)
    try:
        jh = _jax_harness(jconn, jparams, "cross-save")
        js = asyncio.run(jh.run_request(p))
    finally:
        jconn.close()
    assert js.computed_blocks == MAX_REQ_BLOCKS
    th = _harness(conn, params, "cross-save")
    ts = asyncio.run(th.run_request(p))
    assert ts.hit_blocks == ts.loaded_blocks == MAX_REQ_BLOCKS
    assert ts.computed_blocks == 0 and ts.verified
    # A fresh BlockPool hands out blocks 0, 1, 2, ... to its first request.
    ids = list(range(MAX_REQ_BLOCKS))
    for layer in range(CFG.n_layers):
        for kind in (0, 1):
            got = th.caches[layer][kind][ids].numpy().tobytes()
            want = np.asarray(jh.caches[layer][kind])[ids].tobytes()
            assert got == want, f"layer {layer} kind {kind}"


def test_chip_smoke_engine_rounds_rehearsal_on_cpu(server):
    """``chip_smoke.py``'s engine phase — two rounds of 4 concurrent
    requests (1,024-token misses, then 48-block prefix hits with a resumed
    suffix), drafts riding mixed waves, every request verified — run here
    on the CPU at a tiny width with the phase's own traffic and block
    geometry, so its control flow and checks are exercised by every test
    run."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = tl.LlamaConfig(vocab=1000, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
                         block_tokens=16, dtype=torch.float32)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    results, h, store = chip_smoke._run_engine(
        torch, server.port, params, cfg, "cpu", "rehearsal", chip_smoke.ENGINE,
        chip_smoke.ENGINE_BLOCKS, chip_smoke.ENGINE_REQ_BLOCKS, 2e-4)
    chip_smoke._check_rounds(results, chip_smoke.ENGINE, cfg.block_tokens, "rehearsal")
    assert results[0][0]["computed_blocks"] == 4 * 64
    assert results[1][0]["loaded_blocks"] == 4 * 48
    assert h.spec_rounds > 0 and h.wave.waves == sum(r[3] for r in results)
    assert store["keys"] > 0 and store["used_bytes"] >= store["keys"] * (64 << 10)
