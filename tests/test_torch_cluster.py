"""The port's multi-server KV pool (``infinistore_tpu_torch.cluster``) on the
CPU, over the port's own loopback servers, and held against the JAX
package's ``ClusterKVConnector``.

- The 6 tests of ``tests/test_cluster.py``: rendezvous stability, prefix
  colocation, a round trip that lands on the owner only, strict and degrade
  policies for a down member, int8 members (``QuantizedKVConnector``; K8's
  plain version decodes the loaded cache bitwise as the saved one) and the
  continuous-batching engine over a cluster pool (K6's plain version runs
  its waves).
- The cluster-scope trace join of ``tests/test_telemetry.py``: one traced
  mirrored save fans out to two port server processes, and the fleet
  scraper joins their spans on one timeline.
- Against the JAX package, on the same inputs: rendezvous owner and ranking
  (hypothesis over member-id lists and chain roots) and ``reshard_plan`` for
  the same view and catalog; a catalog journal written by either package
  replays in the other; a cluster of either package bootstraps from the
  other's ``GET /bootstrap``; prefixes saved by either cluster (R=2) load
  byte for byte in the other, also after their owner's server stops.
- ``_is_transport`` over the port's error classes: a ``PartialReadError``
  with a key-not-found cause leaves a member's breaker closed, a transport
  cause trips it.

Caches are bf16 tensors on the CPU (and the same bits as jax arrays), made
from a numpy seed.
"""

import asyncio
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import infinistore_tpu as its
import infinistore_tpu_torch as itt
from infinistore_tpu import cluster as jcluster
from infinistore_tpu.tpu.paged import PagedKVCacheSpec as JaxSpec
from infinistore_tpu_torch import ClusterKVConnector, rendezvous_owner, telemetry, tracing
from infinistore_tpu_torch import cluster as tcluster
from infinistore_tpu_torch.cuda.layerwise import PartialReadError
from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

GEOM = (2, 16, 8, 2, 32)  # layers, blocks, block_tokens, kv_heads, head_dim
SPEC = PagedKVCacheSpec(*GEOM, torch.bfloat16)
JSPEC = JaxSpec(*GEOM, jnp.bfloat16)


def _rand_caches(seed):
    """Per-layer (K, V) bf16 caches on the CPU, from a numpy seed."""
    return _both_caches(seed)[1]


def _both_caches(seed):
    """The same per-layer (K, V) bf16 bits as a jax list and a torch list."""
    rng = np.random.default_rng(seed)
    jax_caches, torch_caches = [], []
    for _ in range(SPEC.num_layers):
        pair_j, pair_t = [], []
        for _ in range(2):
            base = rng.standard_normal(SPEC.cache_shape, dtype=np.float32)
            pair_j.append(jnp.asarray(base).astype(jnp.bfloat16))
            pair_t.append(torch.from_numpy(base).to(torch.bfloat16))
        jax_caches.append(tuple(pair_j))
        torch_caches.append(tuple(pair_t))
    return jax_caches, torch_caches


def _block_bytes(cache, ids) -> bytes:
    """The cache's blocks at ``ids`` as raw bytes (torch or jax)."""
    if isinstance(cache, torch.Tensor):
        return cache[list(ids)].view(torch.uint8).numpy().tobytes()
    return np.asarray(cache)[list(ids)].tobytes()


def _connect(port, lib=itt, **overrides):
    cfg = dict(host_addr="127.0.0.1", service_port=port, log_level="error")
    cfg.update(overrides)
    conn = lib.InfinityConnection(lib.ClientConfig(**cfg))
    conn.connect()
    return conn


@pytest.fixture()
def cluster3():
    """Three live port loopback servers + connections, torn down in order."""
    servers, conns = [], []
    try:
        for _ in range(3):
            srv = itt.start_local_server(prealloc_bytes=64 << 20, block_bytes=16 << 10)
            servers.append(srv)
            conns.append(_connect(srv.port))
        yield servers, conns
    finally:
        for c in conns:
            try:
                c.close()
            except Exception:
                pass
        for s in servers:
            s.stop()


def _prompt_owned_by(cluster, want_idx, vocab=1000, tries=200):
    """A 2-block prompt whose chain root rendezvous-hashes to member want_idx."""
    rng = np.random.default_rng(want_idx)
    for _ in range(tries):
        p = rng.integers(0, vocab, size=2 * SPEC.block_tokens).tolist()
        if cluster.owner_index(p) == want_idx:
            return p
    raise AssertionError(f"no prompt found for member {want_idx}")


def _kvmap_lens(servers):
    from infinistore_tpu_torch._native import lib as native

    return [int(native.its_server_kvmap_len(s.handle)) for s in servers]


# ---------------------------------------------------------------------------
# tests/test_cluster.py on the port
# ---------------------------------------------------------------------------


def test_rendezvous_membership_change_only_remaps_removed_owner():
    """Removing one member remaps ONLY the roots it owned."""
    members = ["a:1", "b:2", "c:3"]
    roots = [f"root-{i}" for i in range(300)]
    before = {r: rendezvous_owner(members, r) for r in roots}
    survivors = ["a:1", "c:3"]  # drain b:2
    moved = stayed = 0
    for r in roots:
        after = survivors[rendezvous_owner(survivors, r)]
        if members[before[r]] == "b:2":
            moved += 1
            assert after in survivors
        else:
            stayed += 1
            assert after == members[before[r]]
    assert moved > 50 and stayed > 100


def test_prefix_tree_colocates_and_prompts_distribute(cluster3):
    _, conns = cluster3
    cluster = ClusterKVConnector(conns, SPEC, "demo", max_blocks=8, device="cpu")
    base = list(range(SPEC.block_tokens))
    a = base + [11] * SPEC.block_tokens
    b = base + [22] * SPEC.block_tokens
    assert cluster.owner_index(a) == cluster.owner_index(b)
    owners = {cluster.owner_index([seed] + base[1:]) for seed in range(300)}
    assert owners == {0, 1, 2}
    assert cluster.owner_index(base[:4]) is None
    assert cluster.lookup(base[:4]) == 0


def test_cluster_roundtrip_lands_on_owner_only(cluster3):
    servers, conns = cluster3
    cluster = ClusterKVConnector(conns, SPEC, "demo", max_blocks=8, device="cpu")
    tokens = _prompt_owned_by(cluster, 1)
    caches = _rand_caches(1)
    src_ids = np.array([3, 9], dtype=np.int32)
    written = asyncio.run(cluster.save(tokens, caches, src_ids))
    assert written == 2 * 2 * SPEC.num_layers
    lens = _kvmap_lens(servers)
    assert lens[1] > 0 and lens[0] == 0 and lens[2] == 0

    assert cluster.lookup(tokens) == 2
    dst_ids = np.array([5, 0], dtype=np.int32)
    loaded, n = asyncio.run(cluster.load(tokens, SPEC.make_caches("cpu"), dst_ids))
    assert n == 2
    for layer in range(SPEC.num_layers):
        for kind in (0, 1):
            assert torch.equal(loaded[layer][kind][dst_ids], caches[layer][kind][src_ids])

    assert cluster.drop(tokens) == 2 * 2 * SPEC.num_layers
    assert cluster.lookup(tokens) == 0
    cluster.close()


def test_down_member_strict_raises_degrade_misses(cluster3):
    servers, conns = cluster3
    strict = ClusterKVConnector(conns, SPEC, "demo", max_blocks=8, device="cpu")
    soft = ClusterKVConnector(conns, SPEC, "demo", max_blocks=8, degrade=True, device="cpu")
    victim_tokens = _prompt_owned_by(strict, 2)
    healthy_tokens = _prompt_owned_by(strict, 0)
    asyncio.run(soft.save(healthy_tokens, _rand_caches(2), np.array([1, 2], np.int32)))

    servers[2].stop()  # the outage

    with pytest.raises(itt.InfiniStoreException):
        strict.lookup(victim_tokens)
    assert soft.lookup(victim_tokens) == 0
    assert asyncio.run(
        soft.save(victim_tokens, _rand_caches(3), np.array([4, 5], np.int32))
    ) == 0
    _, n = asyncio.run(
        soft.load(victim_tokens, SPEC.make_caches("cpu"), np.array([6, 7], np.int32)))
    assert n == 0
    assert soft.degraded_ops == 3
    assert soft.lookup(healthy_tokens) == 2
    stats = soft.stats()
    assert stats[2].get("unreachable") is True
    assert "member_id" in stats[0]


def test_quantized_members_compose_with_routing(cluster3):
    """member_factory swaps each member for the port's QuantizedKVConnector:
    the pool stores int8 + scales per member while routing and the degrade
    policy stay the cluster's; K8's plain version over the loaded int8 cache
    is bitwise its output over the saved one."""
    from infinistore_tpu_torch.cuda.kv_quant import (
        QuantizedKVConnector, dequantize_kv, paged_decode_attention_quantized, quantize_kv,
    )

    _, conns = cluster3
    cluster = ClusterKVConnector(
        conns, SPEC, "demo-q8", max_blocks=8, device="cpu",
        member_factory=lambda c: QuantizedKVConnector(c, SPEC, "demo-q8", 8, device="cpu"),
    )
    tokens = _prompt_owned_by(cluster, 0)
    rng = np.random.default_rng(8)
    float_caches = [
        tuple(torch.from_numpy(rng.standard_normal(SPEC.cache_shape, dtype=np.float32))
              for _ in range(2))
        for _ in range(SPEC.num_layers)
    ]
    quant = [(quantize_kv(k), quantize_kv(v)) for k, v in float_caches]
    src = np.array([1, 2], np.int32)
    assert asyncio.run(cluster.save(tokens, quant, src)) == 2 * 2 * SPEC.num_layers
    assert cluster.lookup(tokens) == 2

    def fresh():
        shape = SPEC.cache_shape
        return [
            tuple((torch.zeros(shape, dtype=torch.int8), torch.zeros(shape[:-1]))
                  for _ in range(2))
            for _ in range(SPEC.num_layers)
        ]

    dst = np.array([4, 6], np.int32)
    loaded, n = asyncio.run(cluster.load(tokens, fresh(), dst))
    assert n == 2
    for layer in range(SPEC.num_layers):
        for kind in (0, 1):
            got = dequantize_kv(*loaded[layer][kind])[dst]
            want = dequantize_kv(*quant[layer][kind])[src]
            assert torch.equal(got, want)
    # K8's plain version over each table reads the same bytes.
    q = torch.from_numpy(rng.standard_normal((1, 4, SPEC.head_dim), dtype=np.float32))
    lens = torch.tensor([2 * SPEC.block_tokens - 3], dtype=torch.int32)
    for layer in range(SPEC.num_layers):
        (kd, ks), (vd, vs) = quant[layer]
        (lkd, lks), (lvd, lvs) = loaded[layer]
        want = paged_decode_attention_quantized(
            q, kd, ks, vd, vs, torch.from_numpy(src).reshape(1, 2), lens)
        got = paged_decode_attention_quantized(
            q, lkd, lks, lvd, lvs, torch.from_numpy(dst).reshape(1, 2), lens)
        assert torch.isfinite(got).all()
        assert torch.equal(got, want)
    assert "member_id" in cluster.stats()[0]
    cluster.close()


def test_engine_harness_runs_over_cluster(cluster3):
    """The port's continuous-batching harness over a 2-member cluster pool:
    concurrent requests, full verification against the model's prefill
    oracle, prefix hits on the second wave (its decode waves run K6's plain
    version)."""
    from infinistore_tpu_torch.engine import ContinuousBatchingHarness, EngineKVAdapter
    from infinistore_tpu_torch.models import llama

    _, conns = cluster3
    cfg = llama.LlamaConfig(
        vocab=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
        block_tokens=8, dtype=torch.float32,
    )
    cluster = ClusterKVConnector(conns[:2], cfg.kv_spec(1), "engine-demo", max_blocks=4,
                                 device="cpu")
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    h = ContinuousBatchingHarness(
        EngineKVAdapter(cluster), params, cfg, num_blocks=16, max_req_blocks=4,
        verify=True, device="cpu",
    )
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, size=4 * cfg.block_tokens).tolist() for _ in range(3)]

    # ONE event loop for both waves: the harness's asyncio primitives bind
    # to the loop that first awaits them.
    async def drive():
        m1 = await h.run(prompts, concurrency=3)
        h.stats.clear()
        m2 = await h.run(prompts, concurrency=3)
        return m1, m2

    m1, m2 = asyncio.run(asyncio.wait_for(drive(), 120))
    assert m1["all_verified"]
    assert m2["all_verified"]
    assert m2["hit_rate"] == 1.0  # the second wave is served from the pool
    owners = {cluster.owner_index(p) for p in prompts}
    assert owners <= {0, 1} and len(owners) >= 1
    cluster.close()


# ---------------------------------------------------------------------------
# tests/test_telemetry.py's cluster-scope trace join, over port processes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_fleet():
    """Two port server processes (``python -m infinistore_tpu_torch.server``),
    each with its own manage plane, ready to serve."""
    from tools.fleet import _wait_server_ready, free_port

    members = []
    try:
        for _ in range(2):
            service_port, manage_port = free_port(), free_port()
            argv = [
                sys.executable, "-m", "infinistore_tpu_torch.server",
                "--host", "127.0.0.1", "--service-port", str(service_port),
                "--manage-port", str(manage_port), "--prealloc-size", "1",
                "--minimal-allocate-size", "16", "--no-pin-memory", "--log-level", "error",
            ]
            members.append({
                "service_port": service_port, "manage_port": manage_port,
                "proc": subprocess.Popen(argv, cwd=REPO),
            })
        for m in members:
            _wait_server_ready(m, 60.0)
        yield members
    finally:
        for m in members:
            m["proc"].send_signal(2)
        for m in members:
            try:
                m["proc"].wait(timeout=10)
            except subprocess.TimeoutExpired:
                m["proc"].kill()


async def _http_get(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return json.loads(raw.split(b"\r\n\r\n", 1)[1])


def test_cluster_scope_merges_two_processes(port_fleet):
    from infinistore_tpu_torch.server import ManageServer

    telemetry.reset()
    tracing.configure(enabled=True, capacity=256, slow_op_us=0).clear()
    conns = [_connect(m["service_port"]) for m in port_fleet]
    cluster = ClusterKVConnector(conns, SPEC, "fleet-test", max_blocks=8, replicas=2,
                                 device="cpu")
    try:
        member_ids = list(cluster.member_ids)
        caches = _rand_caches(0)
        tokens = list(range(2 * SPEC.block_tokens))

        async def go():
            # replicas=2 over 2 members: ONE traced save fans out to BOTH
            # server processes with the same trace context on the wire.
            with tracing.trace_op("fanout_save", stage="enqueue") as sp:
                n = await cluster.save(tokens, caches, np.array([1, 4], np.int32))
            assert n > 0
            return sp

        sp = asyncio.run(go())

        async def fetch():
            scraper = telemetry.FleetScraper(
                targets=[(member_ids[i], "127.0.0.1", port_fleet[i]["manage_port"])
                         for i in range(2)],
                timeout_s=2.0,
            )
            manage = ManageServer(itt.ServerConfig(host="127.0.0.1", manage_port=0),
                                  scraper=scraper)
            manage._server = await asyncio.start_server(manage._handle, host="127.0.0.1",
                                                        port=0)
            port = manage._server.sockets[0].getsockname()[1]
            try:
                return (await _http_get(port, "/trace?scope=cluster"),
                        await _http_get(port, "/trace?scope=cluster&fmt=chrome"))
            finally:
                manage._server.close()
                await manage._server.wait_closed()

        doc, chrome = asyncio.run(fetch())
    finally:
        cluster.close()
        for c in conns:
            c.close()
        tracing.configure(enabled=False)
        telemetry.reset()

    assert doc["scope"] == "cluster"
    assert set(member_ids) <= set(doc["members"])
    ours = [s for s in doc["spans"] if s["trace_id"] == sp.trace_id]
    served = {s["attrs"]["member"] for s in ours if s["attrs"].get("side") == "server"}
    # One traced fan-out op's spans, joined by trace id, from 2 processes.
    assert len(served) >= 2, (served, ours)
    client = [s for s in ours if s["attrs"]["member"] == "local"]
    servers = [s for s in ours if s["attrs"].get("side") == "server"]
    assert client and servers
    t0 = min(s["start_us"] for s in client)
    assert all(s["start_us"] >= t0 for s in servers)
    events = chrome["traceEvents"]
    lanes = {e["args"]["name"]: e["pid"] for e in events if e["ph"] == "M"}
    assert {f"member:{m}" for m in member_ids} <= set(lanes)
    assert len({e["pid"] for e in events if e["ph"] == "X"}) >= 3  # local + 2 members


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

_MEMBER = st.builds(
    lambda host, port: f"{host}:{port}",
    st.sampled_from(["127.0.0.1", "10.0.0.7", "node-a", "kv-3.pool"]),
    st.integers(1, 65535),
)


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(
    members=st.lists(_MEMBER, min_size=1, max_size=9, unique=True),
    roots=st.lists(st.text(min_size=0, max_size=24), min_size=1, max_size=8),
)
def test_rendezvous_equals_the_jax_package(members, roots):
    for root in roots:
        owner = tcluster.rendezvous_owner(members, root)
        assert owner == jcluster.rendezvous_owner(members, root)
        ranked = tcluster.rendezvous_ranked(members, root)
        assert ranked == jcluster.rendezvous_ranked(members, root)


@settings(max_examples=50, deadline=None, derandomize=True, database=None)
@given(data=st.data())
def test_rendezvous_on_chain_roots_equals_the_jax_package(data):
    """Real chain roots (the ports' ``token_chain_hashes`` of a prompt's
    first block) over member-id lists."""
    from infinistore_tpu.connector import token_chain_hashes as jhashes
    from infinistore_tpu_torch.connector import token_chain_hashes as thashes

    members = data.draw(st.lists(_MEMBER, min_size=2, max_size=6, unique=True))
    tokens = data.draw(st.lists(st.integers(0, 128255), min_size=8, max_size=24))
    root = thashes(tokens, 8)[0]
    assert root == jhashes(tokens, 8)[0]
    ranked = tcluster.rendezvous_ranked(members, root)
    assert ranked == jcluster.rendezvous_ranked(members, root)


class _Fake:
    """A member connection stand-in for the packages' planning code."""

    def __init__(self, member_id):
        host, _, port = member_id.rpartition(":")
        self.config = type("cfg", (), {"host_addr": host, "service_port": int(port)})()
        self.is_connected = True

    def drop(self, token_ids):
        return 0

    def close(self):
        pass


def _planning_pair(ids, replicas=2, **kw):
    """A JAX and a port cluster over the same fake members (no servers)."""
    fakes = [_Fake(m) for m in ids]
    common = dict(member_ids=ids, member_factory=lambda c: c, replicas=replicas,
                  dial_factory=lambda mid, connect=True: _Fake(mid), **kw)
    return (jcluster.ClusterKVConnector(fakes, JSPEC, "plan", max_blocks=8, **common),
            tcluster.ClusterKVConnector(fakes, SPEC, "plan", max_blocks=8, device="cpu",
                                        **common))


def _catalog_records(ids, n_roots, seed):
    """Catalog records over ``ids``: some complete, some short or holey."""
    from infinistore_tpu_torch.connector import token_chain_hashes

    rng = np.random.default_rng(seed)
    records = []
    for _ in range(n_roots):
        tokens = rng.integers(0, 1000, size=3 * SPEC.block_tokens).tolist()
        holders = {m: int(rng.integers(0, 4)) for m in rng.choice(ids, size=2, replace=False)}
        records.append({"root": token_chain_hashes(tokens, SPEC.block_tokens)[0],
                        "tokens": tokens, "blocks": 3, "holders": holders})
    return records


def _tasks(cluster):
    return sorted(
        (t.root, list(np.asarray(t.tokens)), t.blocks, t.sources, t.targets, t.prune)
        for t in cluster.reshard_plan()
    )


@pytest.mark.parametrize("transition", ["join", "leave", "dead", "join_then_dead"])
def test_reshard_plan_equals_the_jax_package(transition):
    ids = ["127.0.0.1:7001", "127.0.0.1:7002", "127.0.0.1:7003", "10.0.0.4:7004"]
    j, t = _planning_pair(ids)
    try:
        records = _catalog_records(ids, 40, seed=3)
        j.catalog_restore(records)
        t.catalog_restore(records)
        for c in (j, t):
            # The membership transition alone (no resharder kick): the plan
            # is a pure function of the view and the catalog.
            if transition in ("join", "join_then_dead"):
                c.membership.add_member("10.0.0.9:7009")
            if transition == "leave":
                c.membership.remove_member(ids[1])
            if transition in ("dead", "join_then_dead"):
                c.membership.mark_dead(ids[0])
        assert t.membership.view().as_dict() == j.membership.view().as_dict()
        plan = _tasks(t)
        assert plan == _tasks(j)
        assert plan  # the transition left work to plan
    finally:
        j.close()
        t.close()


def _journal_ops(c, ids, records):
    """Journal traffic through the cluster's own paths: catalog upserts, a
    holder added, demoted and removed, a drop tombstone, a reshard plan,
    and membership transitions (view records)."""
    c.catalog_restore(records, journal=True)
    c.catalog_add_holder(records[0]["root"], ids[2], 3)
    c.catalog_demote_holder(records[1]["root"], ids[0])
    c.catalog_remove_holder(records[2]["root"], ids[1])
    c.drop(records[3]["tokens"])
    c.membership.add_member("10.0.0.9:7009")
    c.journal_reshard_event("plan", c.membership.view().epoch, 5)
    c.membership.mark_dead(ids[1])


def _catalog_state(c):
    with c._cat_lock:
        return {root: (np.asarray(rec.tokens).tolist(), rec.blocks, dict(rec.holders))
                for root, rec in c._catalog.items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_replays_in_the_other_package(tmp_path, writer):
    ids = ["127.0.0.1:7101", "127.0.0.1:7102", "127.0.0.1:7103"]
    path = str(tmp_path / "catalog.journal")
    records = _catalog_records(ids, 12, seed=7)
    fakes = [_Fake(m) for m in ids]
    common = dict(member_ids=ids, member_factory=lambda c: c, replicas=2,
                  dial_factory=lambda mid, connect=True: _Fake(mid))
    make = {
        "jax": lambda: jcluster.ClusterKVConnector(fakes, JSPEC, "journal", max_blocks=8,
                                                   journal_path=path, **common),
        "port": lambda: tcluster.ClusterKVConnector(fakes, SPEC, "journal", max_blocks=8,
                                                    journal_path=path, device="cpu", **common),
    }
    reader = "port" if writer == "jax" else "jax"
    w = make[writer]()
    _journal_ops(w, ids, records)
    # One plan, as the resharder's first pass would make it: it scrubs the
    # dead member from the holder sets (journaled), so the reader's own
    # passes (kicked by the resume, its copies failing on the fake members)
    # leave the replayed catalog as it is.
    assert w.reshard_plan()
    want_catalog, want_view = _catalog_state(w), w.membership.view()
    assert all(ids[1] not in holders for _, _, holders in want_catalog.values())
    w.resharder.stop()  # the crash: no finalize, the plan left open
    w._journal_log.close()

    r = make[reader]()
    try:
        assert r.recovered is not None
        assert r.recovered["roots"] == len(want_catalog) == len(records) - 1
        assert r.recovered["resume_reshard"]
        assert r.recovered["replay_torn"] == 0 and r.recovered["replay_bad_checksum"] == 0
        assert _catalog_state(r) == want_catalog
        view = r.membership.view()
        assert (view.epoch, view.member_ids, view.states) == (
            want_view.epoch, want_view.member_ids, want_view.states)
        assert r.member_ids == list(want_view.member_ids)
    finally:
        r.resharder.stop()
        r._journal_log.close()
    # The reader's compaction rewrote the file in its own format: the
    # writer's package replays that too.
    again = make[writer]()
    try:
        assert _catalog_state(again) == want_catalog
    finally:
        again.resharder.stop()
        again._journal_log.close()


@pytest.fixture()
def trio():
    """Three live port servers, one JAX and one port connection to each."""
    servers, jconns, tconns = [], [], []
    try:
        for _ in range(3):
            srv = itt.start_local_server(prealloc_bytes=64 << 20, block_bytes=16 << 10)
            servers.append(srv)
            kw = dict(auto_reconnect=True, connect_timeout_ms=500, op_timeout_ms=2000)
            jconns.append(_connect(srv.port, lib=its, **kw))
            tconns.append(_connect(srv.port, **kw))
        yield servers, jconns, tconns
    finally:
        for c in jconns + tconns:
            try:
                c.close()
            except Exception:
                pass
        for s in servers:
            s.stop()


def _breakers(module):
    return lambda i: module.CircuitBreaker(fail_threshold=1, probe_backoff_s=30.0,
                                           max_backoff_s=60.0, seed=i)


def _pair(servers, jconns, tconns, **kw):
    """A JAX and a port cluster (R=2) with the same member ids."""
    ids = [f"127.0.0.1:{s.port}" for s in servers]
    j = jcluster.ClusterKVConnector(jconns, JSPEC, "interop", max_blocks=8, replicas=2,
                                    member_ids=ids, breaker_factory=_breakers(jcluster), **kw)
    t = tcluster.ClusterKVConnector(tconns, SPEC, "interop", max_blocks=8, replicas=2,
                                    member_ids=ids, breaker_factory=_breakers(tcluster),
                                    device="cpu", **kw)
    return j, t


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1000, size=2 * SPEC.block_tokens).tolist() for _ in range(n)]


def _load_bytes(cluster, prompt, dst, jax_side):
    fresh = JSPEC.make_caches() if jax_side else SPEC.make_caches("cpu")
    loaded, n = asyncio.run(cluster.load(prompt, fresh, dst))
    return n, [[_block_bytes(loaded[layer][kind], dst) for kind in (0, 1)]
               for layer in range(SPEC.num_layers)]


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_prefixes_cross_the_packages_through_the_pool(trio, saver):
    """Either package's cluster (R=2) saves; the other, with the same member
    ids, loads byte for byte; then the owner of one prompt stops and the
    other package fails over to its replica, bytes unchanged."""
    servers, jconns, tconns = trio
    j, t = _pair(servers, jconns, tconns)
    save_c, load_c = (j, t) if saver == "jax" else (t, j)
    prompts = _prompts(6, seed=11)
    src = np.array([3, 9], np.int32)
    dst = np.array([6, 2], np.int32)
    want = {}
    try:
        for i, p in enumerate(prompts):
            jax_caches, torch_caches = _both_caches(100 + i)
            caches = jax_caches if saver == "jax" else torch_caches
            assert asyncio.run(save_c.save(p, caches, src)) == 2 * 2 * SPEC.num_layers
            want[i] = [[_block_bytes(torch_caches[layer][kind], src) for kind in (0, 1)]
                       for layer in range(SPEC.num_layers)]
        assert save_c.health()["qos"]["mirror_writes"] == len(prompts)
        for p in prompts:
            assert load_c.owner_index(p) == save_c.owner_index(p)
            assert load_c.replica_indices(p) == save_c.replica_indices(p)
        for i, p in enumerate(prompts):
            assert load_c.lookup(p) == 2
            n, got = _load_bytes(load_c, p, dst, jax_side=saver == "port")
            assert n == 2 and got == want[i]

        victim = load_c.owner_index(prompts[0])
        servers[victim].stop()
        for i, p in enumerate(prompts):
            n, got = _load_bytes(load_c, p, dst, jax_side=saver == "port")
            assert n == 2 and got == want[i]
        health = load_c.health()["members"]
        assert health[victim]["breaker_state"] == "open"
        owned = sum(load_c.owner_index(p) == victim for p in prompts)
        replicas = [load_c.replica_indices(p)[1] for p in prompts
                    if load_c.owner_index(p) == victim]
        assert sum(health[i]["replica_serves"] for i in set(replicas)) >= owned
        assert load_c.health()["degraded_ops"] == 0
    finally:
        j.close()
        t.close()


async def _bootstrap_doc(manage_cls, config_cls, cluster):
    """``GET /bootstrap`` from a manage plane with ``cluster`` attached."""
    manage = manage_cls(config_cls(manage_port=0), cluster=cluster)
    http = await asyncio.start_server(manage._handle, host="127.0.0.1", port=0)
    port = http.sockets[0].getsockname()[1]
    try:
        return await _http_get(port, "/bootstrap")
    finally:
        http.close()
        await http.wait_closed()


@pytest.mark.parametrize("source", ["jax", "port"])
def test_bootstrap_across_the_packages(trio, source):
    """A cold cluster of one package bootstraps from the other's ``GET
    /bootstrap`` (JSON over HTTP): the same view and catalog, and it serves
    the other's prefixes byte for byte."""
    from infinistore_tpu import config as jconfig
    from infinistore_tpu import server as jserver
    from infinistore_tpu_torch import config as tconfig
    from infinistore_tpu_torch import server as tserver

    servers, jconns, tconns = trio
    j, t = _pair(servers, jconns, tconns)
    src_c = j if source == "jax" else t
    prompts = _prompts(4, seed=21)
    src = np.array([1, 5], np.int32)
    dst = np.array([7, 0], np.int32)
    want = {}
    cold = None
    try:
        for i, p in enumerate(prompts):
            jax_caches, torch_caches = _both_caches(200 + i)
            asyncio.run(src_c.save(p, jax_caches if source == "jax" else torch_caches, src))
            want[i] = [[_block_bytes(torch_caches[layer][kind], src) for kind in (0, 1)]
                       for layer in range(SPEC.num_layers)]
        if source == "jax":
            doc = asyncio.run(_bootstrap_doc(jserver.ManageServer, jconfig.ServerConfig, j))
            cold = tcluster.ClusterKVConnector.bootstrap(
                doc, SPEC, "interop", max_blocks=8, replicas=2, device="cpu")
        else:
            doc = asyncio.run(_bootstrap_doc(tserver.ManageServer, tconfig.ServerConfig, t))
            cold = jcluster.ClusterKVConnector.bootstrap(
                doc, JSPEC, "interop", max_blocks=8, replicas=2)
        assert doc["enabled"] and doc["catalog_total"] == len(prompts)
        assert cold.membership.view().epoch == src_c.membership.view().epoch
        assert sorted(cold.member_ids) == sorted(src_c.member_ids)
        assert _catalog_state(cold) == _catalog_state(src_c)
        for i, p in enumerate(prompts):
            assert cold.lookup(p) == 2
            n, got = _load_bytes(cold, p, dst, jax_side=source == "port")
            assert n == 2 and got == want[i]
    finally:
        if cold is not None:
            cold.close()
        j.close()
        t.close()


# ---------------------------------------------------------------------------
# _is_transport over the port's error classes
# ---------------------------------------------------------------------------


class _PartialMember:
    """A member whose load fails mid-read with the port's PartialReadError."""

    QOS_AWARE = True
    cause = None

    def lookup(self, token_ids):
        return 2

    async def load(self, token_ids, caches, block_ids, first_block=0, on_layer=None):
        raise PartialReadError(list(caches), self.cause)


def _partial_cluster(member, degrade):
    return ClusterKVConnector(
        [_Fake("127.0.0.1:7201")], SPEC, "partial", max_blocks=8, degrade=degrade,
        member_factory=lambda c: member, device="cpu",
        breaker_factory=lambda i: tcluster.CircuitBreaker(fail_threshold=1, seed=i),
    )


@pytest.mark.parametrize("degrade", [False, True], ids=["strict", "degrade"])
def test_semantic_partial_read_keeps_the_breaker_closed(degrade):
    member = _PartialMember()
    member.cause = itt.InfiniStoreKeyNotFound("raced away mid-read")
    cluster = _partial_cluster(member, degrade)
    caches = SPEC.make_caches("cpu")
    tokens = list(range(2 * SPEC.block_tokens))
    if degrade:
        out, n = asyncio.run(cluster.load(tokens, caches, np.array([0, 1], np.int32)))
        assert n == 0
        assert [pair[0] is caches[k][0] for k, pair in enumerate(out)] == [True, True]
    else:
        with pytest.raises(PartialReadError):
            asyncio.run(cluster.load(tokens, caches, np.array([0, 1], np.int32)))
    h = cluster.health()["members"][0]
    assert h["breaker_state"] == "closed" and h["errors"] == 0
    assert not tcluster._is_transport(PartialReadError([], itt.InfiniStoreKeyNotFound("x")))
    pressure = itt.InfiniStoreResourcePressure("x")
    assert not tcluster._is_transport(PartialReadError([], pressure))


@pytest.mark.parametrize("cause", ["transport", "none"])
def test_transport_partial_read_trips_the_breaker(cause):
    member = _PartialMember()
    if cause == "transport":
        member.cause = itt.InfiniStoreException("connection reset")
    cluster = _partial_cluster(member, degrade=True)
    tokens = list(range(2 * SPEC.block_tokens))
    _, n = asyncio.run(
        cluster.load(tokens, SPEC.make_caches("cpu"), np.array([0, 1], np.int32)))
    assert n == 0 and cluster.degraded_ops == 1
    h = cluster.health()["members"][0]
    assert h["breaker_state"] == "open" and h["errors"] == 1
    assert tcluster._is_transport(PartialReadError([], member.cause))
    assert not tcluster._is_transport(itt.InfiniStoreNoMatch("x"))
    # The classes it tests are the ones the port's connectors raise.
    from infinistore_tpu_torch import connector, lib
    from infinistore_tpu_torch.cuda import layerwise

    assert tcluster.PartialReadError is layerwise.PartialReadError is PartialReadError
    for name in ("InfiniStoreException", "InfiniStoreKeyNotFound", "InfiniStoreNoMatch",
                 "InfiniStoreResourcePressure"):
        assert getattr(tcluster, name) is getattr(lib, name)
    assert connector.InfiniStoreKeyNotFound is lib.InfiniStoreKeyNotFound
    assert layerwise.InfiniStoreKeyNotFound is lib.InfiniStoreKeyNotFound


# ---------------------------------------------------------------------------
# chip_smoke.py's cluster path, rehearsed at a tiny width
# ---------------------------------------------------------------------------


def test_chip_smoke_cluster_phase_rehearsal_on_cpu():
    """``chip_smoke.py``'s cluster path (its five legs and every check) run
    here on the CPU at a tiny width, with the path's block size, prompt
    count and R=2, so its control flow is exercised by every test run."""
    import importlib.util

    from infinistore_tpu_torch.models import llama

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = llama.LlamaConfig(vocab=1000, dim=64, n_layers=3, n_heads=4, n_kv_heads=2,
                            ffn_dim=128, block_tokens=16, dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    summary, launches = chip_smoke._run_cluster(
        torch, params, cfg, "cpu", prompt_tokens=64, store_bytes=64 << 20,
        block_bytes=cfg.kv_spec(1).block_nbytes)
    prompts = chip_smoke.PROMPTS
    assert sorted(set(summary["owners"])) == list(range(chip_smoke.CLUSTER_MEMBERS))
    assert summary["save"]["mirror_writes"] == prompts - 1
    assert [len(h) for h in summary["save"]["holders"]] == [2] * (prompts - 1) + [1]
    assert list(summary["loads"]) == ["routed", "after_join", "failover", "after_rereplication"]
    assert all(len(h) >= 2 for h in summary["join"]["holders"])
    assert summary["join"]["reshard_moved_roots"] >= 1
    assert summary["join"]["reshard_moved_bytes"] > 0
    death = summary["death"]
    assert death["roots"] >= 2  # prompt 0's owner took a second root with it
    assert death["replica_serves"] >= death["roots"]
    assert death["breaker"] != "closed"
    assert death["reshard_moved_roots"] >= death["roots"]
    assert all(len(h) >= 2 for h in death["holders"])
    assert death["member"] not in death["members"]
    assert summary["breaker_trips"] >= 1
    assert all(launches[name] == 0 for name in chip_smoke.PATH_KERNELS["cluster"])  # no kernels
