"""The port's cluster-wide tiered capacity plane on the CPU, over the port's
own loopback servers: the cluster-plane tests of ``tests/test_spill_tier.py``
(from ``test_cold_but_alive_counts_demotion_hit_not_miss`` on). The typed
"cold but alive" 512 counts a demotion hit, not a miss; demotion and
promotion-on-hit keep bytes identical; a one-touch scan stays cold; a
faulted cold member routes through its breaker and never wedges; a Zipf
working set converges to hot-in-RAM; ``GET /tiers`` and the ``/metrics``
families of the port's ``ManageServer``; and (chaos) the cold member's
transport killed mid-demotion. Caches are bf16 torch tensors on the CPU,
made from a numpy seed. The cold breaker of the chaos test runs on an
injected clock, so its probe window opens when the test says so.
"""

import asyncio
import json
import time

import numpy as np
import pytest
import torch

import infinistore_tpu_torch as itt
from infinistore_tpu_torch import ClusterKVConnector, telemetry
from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec

SPEC = PagedKVCacheSpec(
    num_layers=2, num_blocks=16, block_tokens=8, num_kv_heads=2,
    head_dim=32, dtype=torch.bfloat16,
)


def _connect(srv):
    c = itt.InfinityConnection(
        itt.ClientConfig(host_addr="127.0.0.1", service_port=srv.port, log_level="error")
    )
    c.connect()
    return c


def _tier_caches(seed):
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


def test_cold_but_alive_counts_demotion_hit_not_miss():
    """The connector's degrade path must count the typed 512 as a tier
    DEMOTION HIT (data alive one tier down), never a miss."""
    from infinistore_tpu_torch import tiering
    from infinistore_tpu_torch.connector import KVConnector
    from infinistore_tpu_torch.cuda.layerwise import PartialReadError

    spec = PagedKVCacheSpec(
        num_layers=1, num_blocks=8, block_tokens=8, num_kv_heads=2,
        head_dim=32, dtype=torch.bfloat16,
    )
    srv = itt.start_local_server(prealloc_bytes=4 << 20, block_bytes=16 << 10)
    c = _connect(srv)
    try:
        kv = KVConnector(c, spec, "demo", max_blocks=8, device="cpu")
        caches = spec.make_caches("cpu")

        class _ColdReader:
            async def read(self, caches, block_ids, keys, on_layer=None):
                raise PartialReadError(
                    list(caches), itt.InfiniStoreColdTier("cold but alive")
                )

        kv._reader = _ColdReader()
        kv._lookup_chains = lambda chains: len(chains)
        tiering.reset_demotion_hits()
        out, n = asyncio.run(
            kv.load(list(range(16)), caches, np.array([0, 1]))
        )
        assert n == 0  # degrades like a miss for the ENGINE (recompute)...
        assert tiering.demotion_hits() == 1  # ...but the tier ledger knows
        assert out[0][0] is caches[0][0]  # the list handed back holds the caller's tensors
    finally:
        tiering.reset_demotion_hits()
        c.close()
        srv.stop()


# -- cluster-plane fixtures --------------------------------------------------


class _TierPool:
    """2 serving + 1 cold loopback servers under one port ClusterKVConnector
    with a manually-paced TierManager (tiering_interval_s=0)."""

    def __init__(self, policy=None, wrap_cold=None, cold_breaker=None):
        self.spec = SPEC
        self.servers, self.conns = [], []
        for _ in range(3):
            srv = itt.start_local_server(
                prealloc_bytes=64 << 20, block_bytes=16 << 10
            )
            self.servers.append(srv)
            self.conns.append(_connect(srv))
        self.cold_conn = (
            wrap_cold(self.conns[2]) if wrap_cold else self.conns[2]
        )
        kw = {}
        if cold_breaker is not None:
            def breakers(i):
                # The cold plane's breakers are built as 1000 + j.
                return cold_breaker(i) if i >= 1000 else itt.CircuitBreaker(seed=i)

            kw["breaker_factory"] = breakers
        self.cluster = ClusterKVConnector(
            self.conns[:2], self.spec, "demo", max_blocks=8,
            cold_members=[self.cold_conn],
            cold_member_ids=[f"127.0.0.1:{self.servers[2].port}"],
            tier_policy=policy, tiering_interval_s=0, device="cpu", **kw,
        )
        self.saved = {}  # root key -> (tokens, caches, block_ids)

    def save_root(self, seed):
        tokens = [1000 + seed] + list(range(1, 2 * self.spec.block_tokens))
        caches = _tier_caches(seed)
        ids = np.array([3, 9], dtype=np.int32)
        written = asyncio.run(self.cluster.save(tokens, caches, ids))
        assert written == 2 * 2 * self.spec.num_layers
        self.saved[seed] = (tokens, caches, ids)
        return tokens

    def load_and_verify(self, seed):
        tokens, caches, ids = self.saved[seed]
        fresh = _tier_caches(9000 + seed)
        dst = np.array([5, 12], dtype=np.int32)
        out, n = asyncio.run(self.cluster.load(tokens, fresh, dst))
        if n == 0:
            return 0
        for layer in range(self.spec.num_layers):
            for kind in (0, 1):
                got = _blocks(out[layer][kind], dst)
                want = _blocks(caches[layer][kind], ids)
                assert np.array_equal(got, want), (seed, layer, kind)
        return n

    def close(self):
        self.cluster.close()
        for c in self.conns:
            try:
                c.close()
            except Exception:
                pass
        for s in self.servers:
            s.stop()


def test_tier_demote_promote_roundtrip_byte_identical():
    """The core transition property: demote ships the root cold and frees
    the serving copies; the read falls through to cold BYTE-IDENTICAL;
    promotion-on-hit brings it back serving-side, still byte-identical."""
    from infinistore_tpu_torch.tiering import TierPolicy, TierPolicyConfig

    pool = _TierPool(policy=TierPolicy(
        TierPolicyConfig(demote_idle_s=0.0, admit_min_streak=2)
    ))
    try:
        tokens = pool.save_root(1)
        assert pool.cluster.tier_location(tokens) == "hot"
        res = pool.cluster.tiering.run_pass()
        assert res["demoted"] == 1
        assert pool.cluster.tier_location(tokens) == "cold"
        # The serving copies are really gone (capacity reclaimed): the
        # serving members answer 0 and the fall-through serves from cold.
        st = pool.cluster.tiering.status()
        assert st["tier_demotions"] == 1 and st["tier_demoted_keys"] > 0
        assert pool.cluster.lookup(tokens) == 2  # cold fall-through
        assert pool.load_and_verify(1) == 2  # byte-identical from cold
        st = pool.cluster.tiering.status()
        assert st["tier_cold_hits"] >= 2 and st["tier_cold_reads"] >= 1
        assert st["tier_promote_backlog"] >= 1  # admitted (streak >= 2)
        res = pool.cluster.tiering.run_pass()
        assert res["promoted"] == 1
        assert pool.cluster.tier_location(tokens) == "hot"
        assert pool.load_and_verify(1) == 2  # byte-identical, serving-side
        st = pool.cluster.tiering.status()
        assert st["tier_promotions"] == 1
        assert st["tier_wrong_reads"] == 0
        # Cold-read latency reached the SLO engine's cold_latency objective.
        assert telemetry.slo_engine().status()["slo_cold_p99_us"] > 0
    finally:
        pool.close()


def test_one_touch_scan_stays_cold():
    """Admission: a single cold touch (no provable reuse) must NOT promote
    — scans stay cold (tier_admit_rejects counts them)."""
    from infinistore_tpu_torch.tiering import TierPolicy, TierPolicyConfig

    t = [0.0]
    pool = _TierPool(policy=TierPolicy(
        TierPolicyConfig(demote_idle_s=5.0, admit_min_streak=2,
                         reuse_window_s=10.0),
        clock=lambda: t[0],
    ))
    try:
        tokens = pool.save_root(1)
        t[0] += 6.0  # idle past demote_idle_s
        assert pool.cluster.tiering.run_pass()["demoted"] == 1
        t[0] += 100.0  # far past the reuse window: the next touch is a scan
        assert pool.cluster.lookup(tokens) == 2  # served from cold...
        st = pool.cluster.tiering.status()
        assert st["tier_admit_rejects"] >= 1  # ...but NOT admitted back
        assert st["tier_promote_backlog"] == 0
        assert pool.cluster.tiering.run_pass()["promoted"] == 0
        assert pool.cluster.tier_location(tokens) == "cold"
        # A second touch inside the window proves reuse: now it promotes.
        t[0] += 1.0
        assert pool.cluster.lookup(tokens) == 2
        assert pool.cluster.tiering.status()["tier_promote_backlog"] == 1
        assert pool.cluster.tiering.run_pass()["promoted"] == 1
        assert pool.cluster.tier_location(tokens) == "hot"
    finally:
        pool.close()


def test_demotion_faulted_cold_member_routes_breakers_never_wedges():
    """A cold member erroring every write: demotion FAILS FAST through the
    breaker (counted, bounded time), data keeps serving from the serving
    members, and nothing wedges."""
    from infinistore_tpu_torch.faults import FaultRule, FaultyConnection
    from infinistore_tpu_torch.tiering import TierPolicy, TierPolicyConfig

    pool = _TierPool(
        policy=TierPolicy(TierPolicyConfig(demote_idle_s=0.0)),
        wrap_cold=lambda c: FaultyConnection(
            c, [FaultRule(op=("write_cache", "tcp_write_cache"),
                          action="error")],
        ),
    )
    try:
        tokens = pool.save_root(1)
        t0 = time.monotonic()
        for _ in range(4):  # enough passes to trip the breaker (threshold 3)
            res = pool.cluster.tiering.run_pass()
            assert res["demoted"] == 0
        assert time.monotonic() - t0 < 30.0, "faulted demotion wedged"
        st = pool.cluster.tiering.status()
        assert st["tier_demote_failures"] >= 3
        assert st["tier_demotions"] == 0
        # The breaker is OPEN: later passes fast-fail locally.
        h = pool.cluster._cold_health[0]
        assert h.breaker.state == "open"
        assert h.errors >= 3
        # The root never left the serving tier; reads stay byte-identical.
        assert pool.cluster.tier_location(tokens) == "hot"
        assert pool.load_and_verify(1) == 2
        assert pool.cluster.tiering.status()["tier_wrong_reads"] == 0
    finally:
        pool.close()


def test_zipf_workload_converges_hot_set_in_ram():
    """Under a Zipf access pattern the hot head stays (or returns)
    serving-side while the long tail demotes to the cold pool — the
    working set converges to RAM, capacity to cold."""
    from infinistore_tpu_torch.tiering import TierPolicy, TierPolicyConfig

    t = [0.0]
    pool = _TierPool(policy=TierPolicy(
        TierPolicyConfig(demote_idle_s=5.0, admit_min_streak=2,
                         reuse_window_s=50.0, sketch_capacity=256),
        clock=lambda: t[0],
    ))
    try:
        n = 12
        tokens_of = {s: pool.save_root(s) for s in range(n)}
        hot = [0, 1, 2]
        rng = np.random.default_rng(7)
        # Zipf-ish rounds: the head is touched every round, the tail never.
        for _ in range(6):
            t[0] += 1.0
            for s in hot:
                assert pool.cluster.lookup(tokens_of[s]) == 2
            # one random mid-tail scan (one-touch; must not pin it hot)
            pool.cluster.lookup(tokens_of[int(rng.integers(3, n))])
        t[0] += 6.0  # now the tail (and the scans) are idle past threshold
        for s in hot:
            assert pool.cluster.lookup(tokens_of[s]) == 2  # head stays touched
        for _ in range(4):
            pool.cluster.tiering.run_pass()
        locs = {s: pool.cluster.tier_location(tokens_of[s]) for s in range(n)}
        assert all(locs[s] == "hot" for s in hot), locs
        tail_cold = sum(1 for s in range(3, n) if locs[s] == "cold")
        assert tail_cold >= (n - 3) - 2, locs  # the tail demoted
        # Every root still answers, byte-identical, wherever it lives.
        for s in range(n):
            assert pool.load_and_verify(s) == 2
        st = pool.cluster.tiering.status()
        assert st["tier_demotions"] >= tail_cold
        assert st["tier_wrong_reads"] == 0
    finally:
        pool.close()


def test_tiers_endpoint_and_metrics_families():
    """GET /tiers serves the TierManager status and /metrics carries the
    infinistore_tier_* families (the ITS-C007 lockstep surface)."""
    from infinistore_tpu_torch.config import ServerConfig
    from infinistore_tpu_torch.server import ManageServer
    from infinistore_tpu_torch.tiering import TierPolicy, TierPolicyConfig

    pool = _TierPool(policy=TierPolicy(
        TierPolicyConfig(demote_idle_s=0.0)
    ))
    try:
        pool.save_root(1)
        pool.cluster.tiering.run_pass()

        async def drive():
            manage = ManageServer(
                ServerConfig(service_port=pool.servers[0].port, manage_port=0),
                cluster=pool.cluster,
            )
            server = await asyncio.start_server(
                manage._handle, host="127.0.0.1", port=0
            )
            port = server.sockets[0].getsockname()[1]

            async def req(method, path):
                reader, writer = await asyncio.open_connection("127.0.0.1", port)
                writer.write(
                    f"{method} {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode()
                )
                await writer.drain()
                raw = await reader.read()
                writer.close()
                head, _, body = raw.partition(b"\r\n\r\n")
                return int(head.split()[1]), body

            status, body = await req("GET", "/tiers")
            doc = json.loads(body)
            assert status == 200 and doc["enabled"]
            assert doc["tier_demotions"] >= 1
            assert doc["tier_cold_members"] == 1
            assert doc["cold_members"][0]["breaker_state"] == "closed"

            status, body = await req("GET", "/metrics")
            assert status == 200
            assert b"infinistore_tier_demotions 1" in body
            assert b'infinistore_tier_hits{tier="ram"}' in body
            assert b"infinistore_tier_demote_backlog" in body
            assert b"infinistore_slo_cold_p99_us" in body

            status, _ = await req("DELETE", "/tiers")
            assert status == 405
            server.close()
            await server.wait_closed()

        asyncio.run(drive())
    finally:
        pool.close()


@pytest.mark.chaos
def test_kill_cold_member_mid_demotion_chaos():
    """Kill the cold member's transport outright: in-flight demotions fail
    typed and fast (breaker opens), serving data keeps serving, already-
    demoted roots degrade to a MISS (recompute: never wrong bytes, never
    a hang), and the half-open probe heals the transport so cold reads
    resume. The cold breaker's clock is the test's: the probe window opens
    only when the test advances it, so the miss is observed before any
    heal can race it."""
    from infinistore_tpu_torch.cluster import CircuitBreaker
    from infinistore_tpu_torch.faults import kill_transport
    from infinistore_tpu_torch.tiering import TierPolicy, TierPolicyConfig

    clk = [0.0]
    pool = _TierPool(
        policy=TierPolicy(TierPolicyConfig(demote_idle_s=0.0, admit_min_streak=2)),
        cold_breaker=lambda i: CircuitBreaker(
            fail_threshold=2, probe_backoff_s=0.05, max_backoff_s=0.2,
            jitter_frac=0.0, seed=i, clock=lambda: clk[0],
        ),
    )
    try:
        t_a = pool.save_root(1)
        assert pool.cluster.tiering.run_pass()["demoted"] == 1  # a is cold
        pool.save_root(2)  # still serving-side

        kill_transport(pool.conns[2])

        # Demotion of b fails typed and fast; b keeps serving.
        t0 = time.monotonic()
        for _ in range(3):
            assert pool.cluster.tiering.run_pass()["demoted"] == 0
        assert time.monotonic() - t0 < 30.0
        assert pool.cluster.tiering.status()["tier_demote_failures"] >= 1
        assert pool.load_and_verify(2) == 2
        # The demoted root degrades to a miss (its only copy is behind the
        # dead transport): 0 blocks, never wrong bytes, never a hang.
        assert pool.load_and_verify(1) == 0
        assert pool.cluster._cold_health[0].breaker.state == "open"

        # Recovery: past the probe window the next cold op is the half-open
        # probe; it heals the connection and cold reads resume. A probe that
        # fails doubles the window, so each try moves the clock past it.
        deadline = time.monotonic() + 20.0
        while pool.cluster.lookup(t_a) != 2:
            assert time.monotonic() < deadline, "cold member never healed through the probe"
            clk[0] += 1.0
            time.sleep(0.05)
        assert pool.load_and_verify(1) == 2  # byte-identical after the heal
        assert pool.cluster.tiering.status()["tier_wrong_reads"] == 0
        assert pool.load_and_verify(2) == 2
    finally:
        pool.close()
