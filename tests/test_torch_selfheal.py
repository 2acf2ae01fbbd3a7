"""The port's self-healing cluster layer (``infinistore_tpu_torch.cluster``)
on the CPU, over the port's own loopback servers: per-member circuit
breakers, R=2 rendezvous replication with read failover, attributable
per-member health, the stage-time degrade fix (the 13 tests of
``tests/test_selfheal.py``), a member killed and restarted mid-workload
(``tests/test_chaos.py``, strict and degrade), and a breaker's trip and
recovery as the tracer and the event journal see them
(``tests/test_tracing.py``, ``tests/test_telemetry.py``). Caches are bf16
torch tensors on the CPU, made from a numpy seed.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

import infinistore_tpu_torch as itt
from infinistore_tpu_torch import telemetry, tracing
from infinistore_tpu_torch.cluster import (
    CircuitBreaker,
    ClusterKVConnector,
    rendezvous_owner,
    rendezvous_ranked,
)
from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec

SPEC = PagedKVCacheSpec(
    num_layers=2, num_blocks=16, block_tokens=8, num_kv_heads=2, head_dim=32,
    dtype=torch.bfloat16,
)


# ---------------------------------------------------------------------------
# CircuitBreaker state machine (fake clock: every transition is exact).
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _breaker(clock, **kw):
    kw.setdefault("fail_threshold", 3)
    kw.setdefault("probe_backoff_s", 1.0)
    kw.setdefault("max_backoff_s", 4.0)
    kw.setdefault("jitter_frac", 0.0)  # exact windows for the clock tests
    return CircuitBreaker(clock=clock, seed=0, **kw)


def test_breaker_opens_only_on_consecutive_failures():
    clk = _Clock()
    br = _breaker(clk)
    for _ in range(2):
        br.record_failure()
    br.record_success()  # streak broken
    assert br.state == CircuitBreaker.CLOSED
    for _ in range(2):
        br.record_failure()
    assert br.state == CircuitBreaker.CLOSED and br.allow()
    br.record_failure()  # third consecutive
    assert br.state == CircuitBreaker.OPEN
    assert not br.allow()


def test_breaker_half_open_probe_window_and_recovery():
    clk = _Clock()
    br = _breaker(clk)
    for _ in range(3):
        br.record_failure()
    assert not br.allow()  # window not elapsed
    clk.t = 1.0
    assert br.allow()  # THE probe
    assert br.state == CircuitBreaker.HALF_OPEN
    assert not br.allow()  # one probe in flight is enough
    assert br.record_success() is True  # recovery reported
    assert br.state == CircuitBreaker.CLOSED and br.allow()
    assert br.record_success() is False  # steady-state success is not recovery


def test_breaker_failed_probe_doubles_backoff_to_cap():
    clk = _Clock()
    br = _breaker(clk)
    for _ in range(3):
        br.record_failure()
    for expect in (1.0, 2.0, 4.0, 4.0):  # capped at max_backoff_s
        clk.t += expect - 0.01
        assert not br.allow(), expect
        clk.t += 0.01
        assert br.allow()
        br.record_failure()  # probe fails -> reopen, doubled
        assert br.state == CircuitBreaker.OPEN


def test_breaker_jitter_is_seeded_and_bounded():
    clk = _Clock()
    spreads = set()
    for seed in range(4):
        br = CircuitBreaker(
            fail_threshold=1, probe_backoff_s=1.0, max_backoff_s=8.0,
            jitter_frac=0.5, seed=seed, clock=clk,
        )
        br.record_failure()
        spreads.add(br.next_probe_at)
        assert 1.0 <= br.next_probe_at <= 1.5
        # Same seed replays the same schedule.
        br2 = CircuitBreaker(
            fail_threshold=1, probe_backoff_s=1.0, max_backoff_s=8.0,
            jitter_frac=0.5, seed=seed, clock=clk,
        )
        br2.record_failure()
        assert br2.next_probe_at == br.next_probe_at
    assert len(spreads) > 1  # members decorrelate


# ---------------------------------------------------------------------------
# Rendezvous ranking (replica placement).
# ---------------------------------------------------------------------------


def test_rendezvous_ranked_head_is_owner_and_drain_preserves_pairings():
    members = ["a:1", "b:2", "c:3", "d:4"]
    roots = [f"r{i}" for i in range(200)]
    for r in roots:
        ranked = rendezvous_ranked(members, r)
        assert sorted(ranked) == [0, 1, 2, 3]
        assert ranked[0] == rendezvous_owner(members, r)
    # Removing one member must not reshuffle pairs it did not appear in:
    # every (owner, successor) pair not involving the drained member stays.
    survivors = members[:3]  # drain d:4
    for r in roots:
        before = [members[i] for i in rendezvous_ranked(members, r)[:2]]
        after = [survivors[i] for i in rendezvous_ranked(survivors, r)[:2]]
        if "d:4" not in before:
            assert after == before


# ---------------------------------------------------------------------------
# Cluster failover / replication / attributable health over live servers.
# ---------------------------------------------------------------------------


@pytest.fixture()
def trio():
    """Three live loopback servers + reconnect-capable connections."""
    servers, conns = [], []
    try:
        for _ in range(3):
            srv = itt.start_local_server(
                prealloc_bytes=64 << 20, block_bytes=16 << 10
            )
            conn = itt.InfinityConnection(
                itt.ClientConfig(
                    host_addr="127.0.0.1", service_port=srv.port,
                    log_level="error", auto_reconnect=True,
                    connect_timeout_ms=500, op_timeout_ms=2000,
                )
            )
            conn.connect()
            servers.append(srv)
            conns.append(conn)
        yield servers, conns
    finally:
        for c in conns:
            try:
                c.close()
            except Exception:
                pass
        for s in servers:
            s.stop()


def _fast_breakers(i, clock=None):
    kw = {} if clock is None else {"clock": clock}
    return CircuitBreaker(
        fail_threshold=2, probe_backoff_s=0.05, max_backoff_s=0.4, seed=i, **kw
    )


def _cluster(conns, **kw):
    kw.setdefault("breaker_factory", _fast_breakers)
    return ClusterKVConnector(conns, SPEC, "heal", max_blocks=8, device="cpu", **kw)


def _rand_caches(seed):
    """Per-layer (K, V) bf16 caches on the CPU, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [
        tuple(
            torch.from_numpy(rng.standard_normal(SPEC.cache_shape, dtype=np.float32))
            .to(SPEC.dtype)
            for _ in range(2)
        )
        for _ in range(SPEC.num_layers)
    ]


def _blocks(cache, ids):
    """The cache's blocks at ``ids`` as f32 numpy (bf16 widens exactly)."""
    return cache[torch.as_tensor(np.asarray(ids), dtype=torch.long)].float().numpy()


def _prompt_with_chain(cluster, want_chain, vocab=1000, tries=400):
    """A 2-block prompt whose (owner, successor) replica chain matches."""
    rng = np.random.default_rng(sum(want_chain))
    for _ in range(tries):
        p = rng.integers(0, vocab, size=2 * SPEC.block_tokens).tolist()
        if cluster.replica_indices(p) == list(want_chain):
            return p
    raise AssertionError(f"no prompt found with chain {want_chain}")


def _kvmap_lens(servers):
    from infinistore_tpu_torch._native import lib as native

    return [int(native.its_server_kvmap_len(s.handle)) for s in servers]


def test_r2_save_mirrors_to_owner_and_successor_only(trio):
    servers, conns = trio
    cluster = _cluster(conns, replicas=2)
    tokens = _prompt_with_chain(cluster, (1, 0))
    caches = _rand_caches(1)
    src = np.array([3, 9], np.int32)
    written = asyncio.run(cluster.save(tokens, caches, src))
    assert written == 2 * 2 * SPEC.num_layers
    lens = _kvmap_lens(servers)
    assert lens[0] > 0 and lens[1] > 0 and lens[2] == 0
    assert lens[0] == lens[1]  # full mirror, not a partial copy
    # drop removes from BOTH replicas.
    assert cluster.drop(tokens) == 2 * 2 * SPEC.num_layers
    assert _kvmap_lens(servers) == [0, 0, 0]


def test_owner_death_degrades_to_replica_reads_byte_correct(trio):
    servers, conns = trio
    cluster = _cluster(conns, replicas=2, degrade=True)
    tokens = _prompt_with_chain(cluster, (2, 0))
    caches = _rand_caches(2)
    src = np.array([1, 5], np.int32)
    asyncio.run(cluster.save(tokens, caches, src))

    servers[2].stop()  # kill the OWNER; successor (member 0) holds the mirror

    assert cluster.lookup(tokens) == 2  # served by the replica, not a miss
    fresh = SPEC.make_caches("cpu")
    dst = np.array([6, 2], np.int32)
    loaded, n = asyncio.run(cluster.load(tokens, fresh, dst))
    assert n == 2
    for layer in range(SPEC.num_layers):
        for kind in (0, 1):
            got = _blocks(loaded[layer][kind], dst)
            want = _blocks(caches[layer][kind], src)
            np.testing.assert_array_equal(got, want)
    health = cluster.health()
    owner, replica = health["members"][2], health["members"][0]
    assert owner["errors"] >= 1 and owner["last_error"] is not None
    assert replica["replica_serves"] >= 2  # lookup + load
    # Replica reads are SERVED ops, not degraded ones.
    assert health["degraded_ops"] == 0


def test_breaker_fast_fails_then_probe_recovers_after_restart(trio):
    servers, conns = trio
    cluster = _cluster(conns, replicas=1, degrade=True)
    victim = 1
    tokens = _prompt_with_chain(cluster, (victim,))
    port = servers[victim].port
    servers[victim].stop()

    # fail_threshold=2 transport errors open the breaker...
    for _ in range(2):
        assert cluster.lookup(tokens) == 0
    h = cluster.health()["members"][victim]
    assert h["breaker_state"] == "open" and h["errors"] == 2
    # ...after which ops fast-fail locally without touching the member.
    before = h["errors"]
    for _ in range(3):
        assert cluster.lookup(tokens) == 0
    h = cluster.health()["members"][victim]
    assert h["errors"] == before  # no new transport attempts
    assert h["fast_fails"] >= 1
    assert cluster.degraded_ops == 5
    assert cluster.health()["members"][victim]["degraded_ops"] == 5
    # Healthy members carry no blame.
    for i in (0, 2):
        m = cluster.health()["members"][i]
        assert m["errors"] == 0 and m["degraded_ops"] == 0

    # Restart on the same port: the next due probe heals the connection and
    # closes the breaker.
    servers[victim] = _restart_on_port(port)
    h = _wait_breaker_closed(cluster, victim, tokens)
    assert h["probes"] >= 1 and h["recoveries"] >= 1
    # Fully functional again: a save lands on the restarted member.
    asyncio.run(
        cluster.save(tokens, _rand_caches(3), np.array([4, 7], np.int32))
    )
    assert cluster.lookup(tokens) == 2


def test_strict_mode_raises_only_when_no_replica_serves(trio):
    servers, conns = trio
    cluster = _cluster(conns, replicas=2, degrade=False)
    tokens = _prompt_with_chain(cluster, (0, 1))
    asyncio.run(cluster.save(tokens, _rand_caches(4), np.array([1, 2], np.int32)))
    servers[0].stop()
    # Reads fail over: strict mode stays AVAILABLE while a replica serves.
    assert cluster.lookup(tokens) == 2
    # Writes must not silently under-replicate in strict mode.
    with pytest.raises(itt.InfiniStoreException):
        asyncio.run(
            cluster.save(tokens, _rand_caches(4), np.array([1, 2], np.int32))
        )
    servers[1].stop()
    # Exhaust retries until the breaker opens, then the fast-fail path must
    # still raise a TYPED error in strict mode (never return a fake miss).
    for _ in range(4):
        with pytest.raises(itt.InfiniStoreException):
            cluster.lookup(tokens)
    stats = cluster.stats()
    assert stats[0].get("unreachable") is True
    assert stats[0]["breaker_state"] in ("open", "half_open")


def test_stage_layer_save_stage_time_error_obeys_degrade():
    """The satellite fix: an InfiniStoreException raised AT STAGE TIME
    (before ship() exists) used to bypass the failure policy and crash the
    engine even with degrade=True."""

    class BoomMember:
        spec = SPEC

        def stage_layer_save(self, *a, **kw):
            raise itt.InfiniStoreException("stage-time boom")

        def get_stats(self):
            return {}

    class FakeConn:
        class config:
            host_addr = "x"
            service_port = 1

    # Single member so the boom member is unavoidably the owner.
    soft = ClusterKVConnector(
        [FakeConn()], SPEC, "m", max_blocks=8, degrade=True,
        member_factory=lambda c: BoomMember(),
        breaker_factory=_fast_breakers, device="cpu",
    )
    tokens = list(range(2 * SPEC.block_tokens))
    kv = (torch.zeros(SPEC.cache_shape, dtype=SPEC.dtype),
          torch.zeros(SPEC.cache_shape, dtype=SPEC.dtype))
    ship = soft.stage_layer_save(tokens, 0, kv, np.array([0, 1], np.int32))
    assert asyncio.run(ship()) == 0  # noop ship, engine survives
    assert soft.degraded_ops == 1
    assert soft.health()["members"][0]["errors"] == 1

    strict = ClusterKVConnector(
        [FakeConn()], SPEC, "m", max_blocks=8, degrade=False,
        member_factory=lambda c: BoomMember(),
        breaker_factory=_fast_breakers, device="cpu",
    )
    with pytest.raises(itt.InfiniStoreException, match="stage-time boom"):
        strict.stage_layer_save(tokens, 0, kv, np.array([0, 1], np.int32))


def test_per_member_stats_carry_health_and_aggregate_persists(trio):
    _, conns = trio
    cluster = _cluster(conns, replicas=1, degrade=True)
    stats = cluster.stats()
    assert len(stats) == 3
    for s in stats:
        assert s["breaker_state"] == "closed"
        assert s["degraded_ops"] == 0 and s["errors"] == 0
        assert "member_id" in s and s["last_error"] is None
    assert cluster.degraded_ops == 0  # aggregate keeps its name and meaning


def test_non_store_exception_never_wedges_a_half_open_probe():
    """StagingPoolExhausted (backpressure) or any non-store exception
    escaping THE half-open probe must propagate — but still resolve the
    probe, or the breaker would stay HALF_OPEN and fast-fail the member
    forever."""

    class FlakyMember:
        spec = SPEC
        boom: Exception = None

        def lookup(self, token_ids):
            if self.boom is not None:
                raise self.boom
            return 2

    class FakeConn:
        class config:
            host_addr = "x"
            service_port = 1

    clk = _Clock()
    member = FlakyMember()
    cluster = ClusterKVConnector(
        [FakeConn()], SPEC, "m", max_blocks=8, degrade=True,
        member_factory=lambda c: member,
        breaker_factory=lambda i: CircuitBreaker(
            fail_threshold=1, probe_backoff_s=1.0, max_backoff_s=4.0,
            jitter_frac=0.0, seed=i, clock=clk,
        ), device="cpu",
    )
    tokens = list(range(2 * SPEC.block_tokens))
    member.boom = itt.InfiniStoreException("down")
    assert cluster.lookup(tokens) == 0  # opens the breaker (threshold 1)
    assert cluster.health()["members"][0]["breaker_state"] == "open"
    clk.t = 1.0  # probe window elapsed; the next op is THE probe...
    member.boom = RuntimeError("backpressure-ish, not a store failure")
    with pytest.raises(RuntimeError):
        cluster.lookup(tokens)
    # ...and despite escaping, the probe resolved: not wedged HALF_OPEN.
    assert cluster.health()["members"][0]["breaker_state"] == "closed"
    member.boom = None
    assert cluster.lookup(tokens) == 2  # member serves again


def test_striped_sweep_rejoin_restores_shm_segment_aliases():
    """An externally-reconnected stripe lost its alias registrations of
    stripe 0's shm segments; the op-entry sweep's rejoin must restore them
    (and never double-register ones still held), or the stripe would fail
    its first segment-based chunk and flap straight back into quarantine."""
    from infinistore_tpu_torch.faults import kill_transport

    srv = itt.start_local_server(prealloc_bytes=32 << 20, block_bytes=16 << 10)
    sc = itt.StripedConnection(
        itt.ClientConfig(
            host_addr="127.0.0.1", service_port=srv.port, log_level="error"
        ),
        streams=3,
    )
    sc.connect()
    seg = sc.alloc_shm_mr(64 << 10)
    assert seg is not None
    base = (seg.ctypes.data, seg.nbytes)
    assert base in sc.conns[1]._segment_aliases
    # External heal: transport dies, someone calls reconnect() directly —
    # the reconnect drops stripe 1's alias registrations.
    kill_transport(sc.conns[1])
    sc.conns[1].reconnect()
    assert base not in sc.conns[1]._segment_aliases
    sc._quarantined[1] = True  # as a failed batch would have left it
    sc._sweep_quarantine()
    assert not sc._quarantined[1]
    assert base in sc.conns[1]._segment_aliases  # re-aliased, not flapping
    # Stripe 2 never reconnected: its alias survived and was NOT duplicated.
    assert sc.conns[2]._segment_aliases.count(base) == 1
    sc.close()
    srv.stop()


# ---------------------------------------------------------------------------
# Chaos: one member killed and restarted mid-workload (tests/test_chaos.py).
# Every read returns correct bytes or a typed error/miss, never wrong data,
# never a hang; R=2 turns the outage into replica reads.
# ---------------------------------------------------------------------------


def _restart_on_port(port, deadline_s=10.0):
    """The in-process server again on ``port``; fails with a message when
    the port cannot be rebound before the deadline."""
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            return itt.start_local_server(
                host="127.0.0.1", service_port=port,
                prealloc_bytes=64 << 20, block_bytes=16 << 10,
            )
        except itt.InfiniStoreException:
            if time.monotonic() > deadline:
                raise AssertionError(f"could not rebind port {port} in {deadline_s} s")
            time.sleep(0.1)


def _wait_breaker_closed(cluster, member, tokens, deadline_s=10.0):
    """Drive lookups until ``member``'s breaker re-closes (the half-open
    probe heals the connection); its health row, or a failure with it once
    the deadline runs out."""
    deadline = time.monotonic() + deadline_s
    while True:
        cluster.lookup(tokens)
        h = cluster.health()["members"][member]
        if h["breaker_state"] == "closed":
            return h
        if time.monotonic() > deadline:
            raise AssertionError(f"breaker of member {member} still {h} after {deadline_s} s")
        time.sleep(0.02)


@pytest.mark.chaos
@pytest.mark.parametrize("degrade", [False, True], ids=["strict", "degrade"])
def test_cluster_member_kill_restart_mid_workload(trio, degrade):
    servers, conns = trio
    cluster = _cluster(conns, replicas=2, degrade=degrade)
    rng = np.random.default_rng(5)
    prompts = [
        rng.integers(0, 1000, size=2 * SPEC.block_tokens).tolist()
        for _ in range(6)
    ]
    contents = {i: _rand_caches(i) for i in range(len(prompts))}
    src = np.array([3, 9], np.int32)
    for i, p in enumerate(prompts):
        asyncio.run(cluster.save(p, contents[i], src))

    victim = cluster.owner_index(prompts[0])
    port = servers[victim].port
    servers[victim].stop()  # mid-workload node death

    def read_all():
        """One read pass over every prompt, verifying every delivered
        byte; R=2 with one member down must serve every prompt."""
        served = 0
        for i, p in enumerate(prompts):
            dst = np.array([6, 2], np.int32)
            hit = cluster.lookup(p)
            loaded, n = asyncio.run(cluster.load(p, SPEC.make_caches("cpu"), dst))
            assert (hit, n) == (2, 2), "R=2: one node death must not cost a read"
            served += 1
            for layer in range(SPEC.num_layers):
                for kind in (0, 1):
                    np.testing.assert_array_equal(
                        _blocks(loaded[layer][kind], dst),
                        _blocks(contents[i][layer][kind], src),
                    )
        return served

    # Two passes so the opened breaker's fast-fail path serves reads too.
    for _ in range(2):
        assert read_all() == len(prompts)

    # A save during the outage is under-replicated: typed error in strict
    # mode, absorbed and counted in degrade mode, never a crash.
    if degrade:
        before = cluster.degraded_ops
        assert asyncio.run(
            cluster.save(prompts[0], contents[0], src)
        ) == 2 * 2 * SPEC.num_layers  # the surviving replica took it
        assert cluster.degraded_ops == before + 1
    else:
        with pytest.raises(itt.InfiniStoreException):
            asyncio.run(cluster.save(prompts[0], contents[0], src))

    # Restart: the half-open probe re-admits the member.
    servers[victim] = _restart_on_port(port)
    h = _wait_breaker_closed(cluster, victim, prompts[0])
    assert h["probes"] >= 1 and h["recoveries"] >= 1

    # Fully healed: saves mirror again and every read still verifies.
    for i, p in enumerate(prompts):
        asyncio.run(cluster.save(p, contents[i], src))
    assert read_all() == len(prompts)


# ---------------------------------------------------------------------------
# A breaker's trip and recovery as tracing and telemetry see them
# (tests/test_tracing.py, tests/test_telemetry.py).
# ---------------------------------------------------------------------------


@pytest.fixture()
def traced():
    telemetry.reset()
    rec = tracing.configure(enabled=True, capacity=256, slow_op_us=0)
    rec.clear()
    yield rec
    tracing.configure(enabled=False)
    telemetry.reset()


@pytest.fixture()
def port_server():
    srv = itt.start_local_server(prealloc_bytes=64 << 20, block_bytes=16 << 10)
    yield srv
    srv.stop()


def _faulty_cluster(port, **kw):
    """One member whose every prefix probe fails with a transport error."""
    from infinistore_tpu_torch.faults import FaultRule, FaultyConnection

    inner = itt.InfinityConnection(itt.ClientConfig(
        host_addr="127.0.0.1", service_port=port, log_level="error",
    ))
    inner.connect()
    faulty = FaultyConnection(
        inner, [FaultRule(op="get_match_last_index", action="error")]
    )
    return inner, faulty, ClusterKVConnector(
        [faulty], SPEC, "ev", max_blocks=8, degrade=False, device="cpu", **kw
    )


@pytest.mark.chaos
def test_breaker_trip_closes_span_with_error(port_server, traced):
    inner, _, cluster = _faulty_cluster(port_server.port)
    try:
        tokens = list(range(16))
        spans = []
        # Strict mode: every routed lookup raises; after fail_threshold
        # consecutive transport errors the member's breaker OPENs.
        for _ in range(4):
            with pytest.raises(itt.InfiniStoreException):
                with tracing.trace_op("cluster_lookup", stage="enqueue") as sp:
                    cluster.lookup(tokens)
            spans.append(sp)
        assert all(s.status.startswith("error:") for s in spans)
        assert all(s.t1_us >= s.t0_us for s in spans)
        assert cluster.health()["members"][0]["breaker_state"] == "open"
        # The errored spans are in the recorder: the failure is traceable.
        recorded = [
            s for s in tracing.recorder().snapshot()
            if s["name"] == "cluster_lookup"
        ]
        assert len(recorded) == 4
        assert all(s["status"].startswith("error:") for s in recorded)
    finally:
        cluster.close()
        inner.close()


@pytest.mark.chaos
def test_trip_and_recovery_events_link_to_trace(port_server, traced):
    clk = _Clock()
    inner, faulty, cluster = _faulty_cluster(
        port_server.port,
        breaker_factory=lambda i: CircuitBreaker(
            fail_threshold=2, probe_backoff_s=0.05, max_backoff_s=0.2,
            seed=i, clock=clk,
        ),
    )
    try:
        member = cluster.member_ids[0]
        tokens = list(range(16))
        spans = []
        for _ in range(2):
            with pytest.raises(itt.InfiniStoreException):
                with tracing.trace_op("trip_lookup", stage="enqueue") as sp:
                    cluster.lookup(tokens)
            spans.append(sp)
        assert cluster.health()["members"][0]["breaker_state"] == "open"

        events = telemetry.get_journal().snapshot()
        opens = [e for e in events if e["kind"] == "breaker_open"]
        assert len(opens) == 1
        assert opens[0]["member"] == member
        assert opens[0]["epoch"] >= 1
        # The causal link: the trip event carries the trace id of the op
        # that tripped it, and that span is in the flight recorder.
        assert opens[0]["trace_id"] == spans[-1].trace_id
        recorded = {s["trace_id"] for s in tracing.recorder().snapshot()}
        assert opens[0]["trace_id"] in recorded

        # Heal the fault; past the probe window (the injected clock) the
        # next traced lookup is the half-open probe, and it recovers.
        faulty.rules.clear()
        clk.t += 1.0
        with tracing.trace_op("heal_lookup", stage="enqueue"):
            cluster.lookup(tokens)
        assert cluster.health()["members"][0]["breaker_state"] == "closed"
        kinds = [e["kind"] for e in telemetry.get_journal().snapshot()]
        assert "breaker_half_open" in kinds
        assert "breaker_closed" in kinds
        closed = [
            e for e in telemetry.get_journal().snapshot()
            if e["kind"] == "breaker_closed"
        ]
        assert closed[-1]["member"] == member
        assert closed[-1]["trace_id"] != 0  # recovery rode a traced lookup
    finally:
        cluster.close()
        inner.close()
