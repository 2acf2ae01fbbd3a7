"""The port's crash-safe fleet coordination on the CPU, over the port's own
loopback servers: ``tests/test_recovery.py`` but for its subprocess fleet
client (``TestKillRestartSubprocess``, which waits for a port of
``fleet_client``). The ``DurableLog`` record format (torn tail discarded,
checksum-bad skipped and counted, compaction preserving holder levels and
tombstones), the tombstone-aware gossip merge lattice, journal replay and
restart resume on a real port cluster, the ``POST /gossip`` and ``GET
/bootstrap`` routes of the port's ``ManageServer`` with structured error
bodies, ``ClusterKVConnector.bootstrap``, and the ``crash`` fault action in
a subprocess. Caches are bf16 torch tensors on the CPU, made from a numpy
seed; every wait has its own deadline.
"""

import asyncio
import json
import os
import struct
import subprocess
import sys
import threading

import numpy as np
import torch

import infinistore_tpu_torch as itt
from infinistore_tpu_torch import telemetry
from infinistore_tpu_torch.cluster import CircuitBreaker, ClusterKVConnector
from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec
from infinistore_tpu_torch.membership import DurableLog, MemberState, Membership

SPEC = PagedKVCacheSpec(
    num_layers=2, num_blocks=16, block_tokens=8, num_kv_heads=2,
    head_dim=32, dtype=torch.bfloat16,
)


def _start_server():
    return itt.start_local_server(prealloc_bytes=64 << 20, block_bytes=16 << 10)


def _connect(port, **overrides):
    cfg = dict(
        host_addr="127.0.0.1", service_port=port, log_level="error",
        auto_reconnect=True, connect_timeout_ms=500, op_timeout_ms=2000,
    )
    cfg.update(overrides)
    conn = itt.InfinityConnection(itt.ClientConfig(**cfg))
    conn.connect()
    return conn


def _fast_breakers(i):
    return CircuitBreaker(
        fail_threshold=2, probe_backoff_s=0.05, max_backoff_s=0.4, seed=i
    )


def _mk_caches(seed):
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


# ---------------------------------------------------------------------------
# DurableLog: the record format's crash-robustness properties.
# ---------------------------------------------------------------------------


class TestDurableLog:
    def test_append_replay_roundtrip(self, tmp_path):
        p = str(tmp_path / "log")
        log = DurableLog(p)
        recs = [
            {"k": "root", "root": "r1", "tokens": [1, 2], "blocks": 2,
             "holders": {"a:1": 2}},
            {"k": "hadd", "root": "r1", "m": "b:2", "lv": 2},
            {"k": "drop", "root": "r1"},
        ]
        for r in recs:
            log.append(r)
        log.close()
        log2 = DurableLog(p)
        assert log2.replay() == recs
        assert log2.replay_torn == 0 and log2.replay_bad_checksum == 0
        st = log2.status()
        assert st["journal_replay_records"] == 3
        log2.close()

    def test_torn_tail_discarded_cleanly(self, tmp_path):
        """The record being written at the kill -9: truncated payload AND
        truncated header are both discarded, never parsed, and counted —
        earlier records replay whole."""
        p = str(tmp_path / "log")
        log = DurableLog(p)
        log.append({"k": "root", "root": "keep", "tokens": [1], "blocks": 1,
                    "holders": {}})
        log.append({"k": "root", "root": "keep2", "tokens": [2], "blocks": 1,
                    "holders": {}})
        log.close()
        whole = open(p, "rb").read()
        for cut in (whole[:-3], whole[:-(len(whole) // 3)], whole + b"\x20\x00"):
            with open(p, "wb") as f:
                f.write(cut)
            log2 = DurableLog(p)
            out = log2.replay()
            assert [r["root"] for r in out] in (["keep"], ["keep", "keep2"])
            if len(cut) != len(whole):
                assert log2.replay_torn == 1
            log2.close()

    def test_checksum_mismatch_skipped_and_counted(self, tmp_path):
        """A bit flipped inside one record's payload: that record is
        skipped (counted), the frames after it still replay — corruption
        never crashes recovery."""
        p = str(tmp_path / "log")
        log = DurableLog(p)
        for i in range(3):
            log.append({"k": "root", "root": f"r{i}", "tokens": [i],
                        "blocks": 1, "holders": {}})
        log.close()
        data = bytearray(open(p, "rb").read())
        # Flip a byte inside the SECOND record's payload (skip its header).
        hdr = struct.Struct("<II")
        ln0, _ = hdr.unpack_from(data, 0)
        second_payload_at = hdr.size + ln0 + hdr.size + 4
        data[second_payload_at] ^= 0xFF
        with open(p, "wb") as f:
            f.write(bytes(data))
        log2 = DurableLog(p)
        out = log2.replay()
        assert [r["root"] for r in out] == ["r0", "r2"]
        assert log2.replay_bad_checksum == 1
        assert log2.replay_torn == 0
        log2.close()

    def test_compact_rewrites_atomically(self, tmp_path):
        p = str(tmp_path / "log")
        log = DurableLog(p)
        for i in range(50):
            log.append({"k": "hadd", "root": "r", "m": f"m{i}", "lv": i})
        before = log.size_bytes()
        snap = [{"k": "root", "root": "r", "tokens": [1], "blocks": 1,
                 "holders": {"m49": 49}}]
        log.compact(snap)
        assert log.size_bytes() < before
        assert log.compactions == 1
        # Appends continue on the compacted file.
        log.append({"k": "drop", "root": "r"})
        log.close()
        log2 = DurableLog(p)
        assert log2.replay() == snap + [{"k": "drop", "root": "r"}]
        log2.close()


# ---------------------------------------------------------------------------
# The gossip merge lattice (pure Membership, no I/O).
# ---------------------------------------------------------------------------


class TestMergeLattice:
    def test_adopts_newer_epoch_and_entries(self):
        a = Membership(["m1", "m2"])
        a.add_member("m3")
        b = Membership(["m1", "m2"])
        payload = a.view().as_dict()
        changed, view = b.merge_apply(payload["members"], payload["epoch"])
        assert changed and view.epoch == a.view().epoch
        assert view.state_of("m3") == MemberState.JOINING
        assert b.view().since == a.view().since
        # A merge never takes transition ownership: the originator
        # finalizes, the adopter settles when that gossips back.
        assert a.owns_transition and not b.owns_transition

    def test_idempotent_and_commutative(self):
        a = Membership(["m1", "m2"])
        a.add_member("m3")
        a.mark_dead("m2")
        b = Membership(["m1", "m2"])
        b.remove_member("m1")
        pa, pb = a.view().as_dict(), b.view().as_dict()
        a.merge_apply(pb["members"], pb["epoch"])
        b.merge_apply(pa["members"], pa["epoch"])
        va, vb = a.view(), b.view()
        assert va.epoch == vb.epoch
        for mid in ("m1", "m2", "m3"):
            assert va.state_of(mid) == vb.state_of(mid)
        # Re-merging the same payloads changes nothing.
        assert a.merge_apply(pb["members"], pb["epoch"])[0] is False

    def test_tombstone_dominates_stale_liveness(self):
        a = Membership(["m1", "m2"])
        stale = a.view().as_dict()  # m2 alive at epoch 1
        a.mark_dead("m2")
        changed, _ = a.merge_apply(stale["members"], stale["epoch"])
        assert not changed
        assert a.view().state_of("m2") == MemberState.DEAD

    def test_readd_after_dead_wins_via_incarnation(self):
        a = Membership(["m1", "m2"])
        a.mark_dead("m2")
        a.add_member("m2")  # rejoin: NEW entry, higher since_epoch
        b = Membership(["m1", "m2"])
        b.mark_dead("m2")
        payload = a.view().as_dict()
        changed, view = b.merge_apply(payload["members"], payload["epoch"])
        assert changed
        assert view.state_of("m2") == MemberState.JOINING  # latest entry wins
        # The dead incarnation's tombstone entry is still present (index
        # stability): two entries for m2.
        assert list(view.member_ids).count("m2") == 2

    def test_unsettled_merge_installs_fallback_placement(self):
        a = Membership(["m1", "m2"])
        a.add_member("m3")
        payload = a.view().as_dict()
        b = Membership(["m1", "m2"])
        b.merge_apply(
            payload["members"], payload["epoch"],
            prev_placement=list(a.prev_placement),
        )
        assert not b.settled
        assert b.prev_placement == ("m1", "m2")
        # Finalized view gossips back: B settles and drops the fallback.
        a.finalize_transitions()
        payload = a.view().as_dict()
        b.merge_apply(payload["members"], payload["epoch"])
        assert b.settled and b.prev_placement is None


# ---------------------------------------------------------------------------
# Journal replay + restart resume on a real cluster (loopback servers).
# ---------------------------------------------------------------------------


class _Pool:
    def __init__(self, n, journal_path=None, **cluster_kw):
        self.servers = [_start_server() for _ in range(n)]
        self.conns = [_connect(s.port) for s in self.servers]
        kw = dict(
            degrade=True, replicas=2, breaker_factory=_fast_breakers,
            member_ids=[f"127.0.0.1:{s.port}" for s in self.servers],
            journal_path=journal_path,
        )
        kw.update(cluster_kw)
        self.cluster = ClusterKVConnector(
            self.conns, SPEC, "recovery-test", max_blocks=8, device="cpu", **kw
        )
        self.contents = {}
        self.prompts = []
        self.src = np.array([3, 9], np.int32)

    def seed_roots(self, n_roots, rng_seed=5, prompts=None):
        rng = np.random.default_rng(rng_seed)
        self.prompts = prompts or [
            rng.integers(0, 1000, size=2 * SPEC.block_tokens).tolist()
            for _ in range(n_roots)
        ]
        for i, p in enumerate(self.prompts):
            self.contents[i] = _mk_caches(i)
            asyncio.run(self.cluster.save(p, self.contents[i], self.src))

    def sweep(self):
        reads = misses = wrong = 0
        dst = np.array([6, 2], np.int32)
        for i, p in enumerate(self.prompts):
            reads += 1
            loaded, n = asyncio.run(self.cluster.load(p, SPEC.make_caches("cpu"), dst))
            if n == 0:
                misses += 1
                continue
            wrong += any(
                not np.array_equal(
                    _blocks(loaded[layer][kind], dst),
                    _blocks(self.contents[i][layer][kind], self.src),
                )
                for layer in range(SPEC.num_layers)
                for kind in (0, 1)
            )
        return reads, misses, wrong

    def rebuild(self, journal_path):
        """Simulated restart: new connections + a new cluster over the
        SAME journal (the old cluster object is abandoned un-closed,
        like a crash — only its resharder/journal are stopped so the
        test process doesn't leak threads)."""
        self.cluster.resharder.stop()
        if self.cluster._journal_log is not None:
            self.cluster._journal_log.close()
        for c in self.conns:
            try:
                c.close()
            except Exception:
                pass
        self.conns = [_connect(s.port) for s in self.servers]
        self.cluster = ClusterKVConnector(
            self.conns, SPEC, "recovery-test", max_blocks=8,
            degrade=True, replicas=2, breaker_factory=_fast_breakers,
            member_ids=[f"127.0.0.1:{s.port}" for s in self.servers],
            journal_path=journal_path, device="cpu",
        )
        return self.cluster

    def close(self):
        self.cluster.close()
        for c in self.conns:
            try:
                c.close()
            except Exception:
                pass
        for s in self.servers:
            s.stop()


class TestJournalRecovery:
    def test_restart_recovers_catalog_and_reads(self, tmp_path):
        jp = str(tmp_path / "a.journal")
        pool = _Pool(2, journal_path=jp)
        try:
            pool.seed_roots(6)
            assert pool.cluster.membership_status()["reshard_catalog_roots"] == 6
            pool.rebuild(jp)
            rec = pool.cluster.recovered
            assert rec is not None and rec["roots"] == 6
            assert rec["replay_torn"] == 0 and rec["replay_bad_checksum"] == 0
            assert pool.cluster.membership_status()["reshard_catalog_roots"] == 6
            reads, misses, wrong = pool.sweep()
            assert (misses, wrong) == (0, 0)
            # The replay emitted the causal client_restart event.
            kinds = [e["kind"] for e in telemetry.get_journal().snapshot()]
            assert "client_restart" in kinds
        finally:
            pool.close()

    def test_drop_tombstone_never_resurrects(self, tmp_path):
        jp = str(tmp_path / "a.journal")
        pool = _Pool(2, journal_path=jp)
        try:
            pool.seed_roots(4)
            dropped = pool.prompts[0]
            pool.cluster.drop(dropped)
            pool.rebuild(jp)
            assert pool.cluster.recovered["roots"] == 3
            root = pool.cluster._root_of(dropped)
            with pool.cluster._cat_lock:
                assert root not in pool.cluster._catalog
        finally:
            pool.close()

    def test_corrupt_tail_and_checksum_never_crash_recovery(self, tmp_path):
        jp = str(tmp_path / "a.journal")
        pool = _Pool(2, journal_path=jp)
        try:
            pool.seed_roots(4)
            pool.cluster.resharder.stop()
            pool.cluster._journal_log.close()
            # Tear the tail AND flip a byte mid-file: recovery must come
            # up clean, count both, and keep every intact root.
            data = bytearray(open(jp, "rb").read())
            data[len(data) // 2] ^= 0xFF
            data += b"\x99\x00\x00\x00\x01"  # torn trailing frame
            with open(jp, "wb") as f:
                f.write(bytes(data))
            pool.rebuild(jp)
            rec = pool.cluster.recovered
            assert rec is not None
            assert rec["replay_torn"] >= 1 or rec["replay_bad_checksum"] >= 1
            # Whatever survived reads correctly (subset of the 4 roots).
            reads, misses, wrong = pool.sweep()
            assert wrong == 0
        finally:
            pool.close()

    def test_compaction_preserves_levels_and_tombstones(self, tmp_path):
        """Finalize compacts the journal to a snapshot; a restart from the
        COMPACTED file must reproduce holder block-levels and the DEAD
        tombstone entry (index stability across restarts)."""
        jp = str(tmp_path / "a.journal")
        pool = _Pool(3, journal_path=jp)
        extra_srv = extra_conn = None
        try:
            pool.seed_roots(6)
            extra_srv = _start_server()
            pool.servers.append(extra_srv)
            extra_conn = _connect(extra_srv.port)
            pool.conns.append(extra_conn)
            pool.cluster.add_member(
                extra_conn, member_id=f"127.0.0.1:{extra_srv.port}", wait=True
            )
            victim = pool.cluster.member_ids[0]
            pool.cluster.mark_dead(victim, wait=True)
            assert pool.cluster.membership.settled
            status = pool.cluster.membership_status()
            assert status["journal_compactions"] >= 1
            with pool.cluster._cat_lock:
                levels_before = {
                    root: dict(rec.holders)
                    for root, rec in pool.cluster._catalog.items()
                }
            view_before = pool.cluster.membership.view()
            pool.rebuild(jp)
            view = pool.cluster.membership.view()
            assert view.epoch == view_before.epoch
            assert view.member_ids == view_before.member_ids
            assert view.states == view_before.states
            assert view.state_of(victim) == MemberState.DEAD
            with pool.cluster._cat_lock:
                levels_after = {
                    root: dict(rec.holders)
                    for root, rec in pool.cluster._catalog.items()
                }
            assert levels_after == levels_before
            reads, misses, wrong = pool.sweep()
            assert (misses, wrong) == (0, 0)
        finally:
            pool.close()

    def test_interrupted_reshard_resumes_from_journaled_debt(self, tmp_path):
        """Stop the reshard at a DETERMINISTIC point (after exactly 2 roots
        copied to the joiner the worker wedges: the in-process analogue of
        the fleet client's kill -9 hook) and rebuild: the recovered cluster
        must flag the resume, kick the reconciler on construction, and
        settle with zero debt, moving only the remainder. The crash point
        counts the joiner's copies (not every holder update), and the
        result is held as the final placement: every root on its two
        rendezvous owners, the joiner on exactly its delta."""
        from infinistore_tpu_torch.cluster import rendezvous_ranked

        jp = str(tmp_path / "a.journal")
        pool = _Pool(3, journal_path=jp)
        try:
            extra_srv = _start_server()
            pool.servers.append(extra_srv)
            extra_conn = _connect(extra_srv.port)
            pool.conns.append(extra_conn)
            joiner_id = f"127.0.0.1:{extra_srv.port}"
            # Member ids carry ephemeral ports, so placement differs run to
            # run: pick the 10 prompts so that exactly 5 roots move to the
            # joiner (the crash point needs a third).
            grown = pool.cluster.member_ids + [joiner_id]
            rng = np.random.default_rng(5)
            moving, staying = [], []
            while len(moving) < 5 or len(staying) < 5:
                p = rng.integers(0, 1000, size=2 * SPEC.block_tokens).tolist()
                top2 = rendezvous_ranked(grown, pool.cluster._root_of(p))[:2]
                (moving if len(grown) - 1 in top2 else staying).append(p)
            pool.seed_roots(10, prompts=moving[:5] + staying[:5])
            cluster = pool.cluster
            orig_add = cluster.catalog_add_holder
            state = {"n": 0}
            crashed = threading.Event()

            def crash_point(root, member_id, blocks=0):
                if member_id == joiner_id and state["n"] >= 2:
                    # From here the incarnation does no further work on
                    # the joiner: the journal keeps its open plan and
                    # exactly 2 progress records for it.
                    crashed.set()
                    raise RuntimeError("injected crash point")
                ok = orig_add(root, member_id, blocks)
                if ok and member_id == joiner_id:
                    state["n"] += 1
                return ok

            cluster.catalog_add_holder = crash_point
            cluster.add_member(extra_conn, member_id=joiner_id)
            assert crashed.wait(timeout=30.0), "the reshard never reached its crash point"
            assert cluster.resharder.progress()["reshard_moved_roots"] >= 2
            pool.rebuild(jp)  # the "restart": un-finalized journal replay
            rec = pool.cluster.recovered
            assert rec is not None and rec["resume_reshard"]
            assert rec["roots"] == 10
            assert pool.cluster.resharder.wait_idle(timeout=60.0)
            assert pool.cluster.membership.settled
            assert pool.cluster.resharder.progress()["reshard_debt_roots"] == 0
            view = pool.cluster.membership.view()
            place = view.placement_ids()
            with pool.cluster._cat_lock:
                catalog = {r: dict(rec.holders) for r, rec in pool.cluster._catalog.items()}
            delta = 0
            for root, holders in catalog.items():
                want = {place[k] for k in rendezvous_ranked(place, root)[:2]}
                assert {m for m, lv in holders.items() if lv > 0} == want, (root, holders)
                delta += joiner_id in want
            # Resume, not re-copy: the journaled progress kept the two roots
            # the first incarnation gave the joiner out of the new plan.
            resumed = pool.cluster.resharder.progress()["reshard_moved_roots"]
            assert delta == 5
            assert resumed == 3
            joiner_holds = sum(1 for h in catalog.values() if h.get(joiner_id, 0) > 0)
            assert joiner_holds == delta
            reads, misses, wrong = pool.sweep()
            assert (misses, wrong) == (0, 0)
        finally:
            pool.close()


# ---------------------------------------------------------------------------
# Gossip + bootstrap over real HTTP (two clusters, one process).
# ---------------------------------------------------------------------------


class TestGossipAndBootstrap:
    def _two_clusters(self):
        servers = [_start_server() for _ in range(3)]
        ids = [f"127.0.0.1:{s.port}" for s in servers]

        def build():
            conns = [_connect(s.port) for s in servers]
            return conns, ClusterKVConnector(
                conns, SPEC, "gossip-test", max_blocks=8, degrade=True,
                replicas=2, breaker_factory=_fast_breakers, member_ids=ids, device="cpu",
            )

        conns_a, a = build()
        conns_b, b = build()
        return servers, conns_a + conns_b, a, b

    def test_epoch_propagates_via_gossip_alone(self):
        servers, conns, a, b = self._two_clusters()
        extra_srv = None
        try:
            from infinistore_tpu_torch.config import ServerConfig
            from infinistore_tpu_torch.server import ManageServer

            extra_srv = _start_server()
            servers.append(extra_srv)
            journal = telemetry.get_journal()
            seq0 = journal.emitted

            async def drive():
                manage_b = ManageServer(
                    ServerConfig(manage_port=0), cluster=b
                )
                http_b = await asyncio.start_server(
                    manage_b._handle, host="127.0.0.1", port=0
                )
                port_b = http_b.sockets[0].getsockname()[1]
                agent = telemetry.GossipAgent(
                    a, peers=[(f"b:{port_b}", "127.0.0.1", port_b)],
                    interval_s=0.05,
                )
                # Transition on A ONLY (no POST to B, no agent on B).
                extra_conn = _connect(extra_srv.port)
                a.add_member(
                    extra_conn, member_id=f"127.0.0.1:{extra_srv.port}"
                )
                epoch_a = a.membership.view().epoch
                # Drive rounds deterministically (no thread timing).
                res = await asyncio.to_thread(agent.exchange_once)
                assert res["ok"] == 1
                assert b.membership.view().epoch >= epoch_a
                assert (
                    b.membership.view().state_of(
                        f"127.0.0.1:{extra_srv.port}"
                    ) is not None
                )
                # B dialed the gossiped member and can route reads to it.
                assert len(b.member_ids) == 4
                # A's reshard drains; the finalized epoch reaches B on the
                # next exchange — B settles with NO manage-plane help.
                assert a.resharder.wait_idle(timeout=30.0)
                await asyncio.to_thread(agent.exchange_once)
                assert b.membership.settled
                assert b.membership.view().epoch == a.membership.view().epoch
                st = agent.status()
                assert st["gossip_rounds"] == 2
                assert st["gossip_exchanges"] == 2
                assert st["gossip_merges_out"] >= 1
                http_b.close()
                await http_b.wait_closed()
                return extra_conn

            extra_conn = asyncio.run(drive())
            conns.append(extra_conn)
            kinds = [
                e["kind"] for e in journal.snapshot(since_seq=seq0)
            ]
            assert "gossip_round" in kinds
        finally:
            a.close()
            b.close()
            for c in conns:
                try:
                    c.close()
                except Exception:
                    pass
            for s in servers:
                s.stop()

    def test_gossip_bootstrap_routes_and_structured_errors(self):
        servers, conns, a, b = self._two_clusters()
        try:
            from infinistore_tpu_torch.config import ServerConfig
            from infinistore_tpu_torch.server import ManageServer

            rng = np.random.default_rng(5)
            prompts = [
                rng.integers(0, 1000, size=2 * SPEC.block_tokens).tolist()
                for _ in range(5)
            ]
            for i, p in enumerate(prompts):
                asyncio.run(a.save(p, _mk_caches(i), np.array([3, 9], np.int32)))

            async def drive():
                manage = ManageServer(ServerConfig(manage_port=0), cluster=a)
                http = await asyncio.start_server(
                    manage._handle, host="127.0.0.1", port=0
                )
                port = http.sockets[0].getsockname()[1]

                async def req(method, path, body=None, raw=None):
                    reader, writer = await asyncio.open_connection(
                        "127.0.0.1", port
                    )
                    payload = (
                        raw if raw is not None
                        else json.dumps(body).encode() if body is not None
                        else b""
                    )
                    writer.write(
                        f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                        f"Content-Length: {len(payload)}\r\n\r\n".encode()
                        + payload
                    )
                    await writer.drain()
                    raw_resp = await reader.read()
                    writer.close()
                    head, _, body_bytes = raw_resp.partition(b"\r\n\r\n")
                    return int(head.split()[1]), json.loads(body_bytes)

                # A valid push-pull exchange: B's payload merges into A,
                # the response carries A's post-merge view.
                status, doc = await req("POST", "/gossip", b.gossip_payload())
                assert status == 200 and doc["status"] == "ok"
                assert doc["epoch"] == a.membership.view().epoch
                assert {m["member_id"] for m in doc["members"]} == set(
                    a.member_ids
                )

                # Structured errors: reason + CURRENT epoch, never a bare
                # 400 — a stale peer self-corrects from the body.
                status, doc = await req("POST", "/gossip", raw=b"{nope")
                assert status == 400 and doc["reason"] == "bad_json"
                assert doc["epoch"] == a.membership.view().epoch
                status, doc = await req("POST", "/gossip", {"members": []})
                assert status == 400 and doc["reason"] == "bad_payload"
                status, doc = await req(
                    "POST", "/membership", {"action": "nope"}
                )
                assert status == 400 and doc["reason"] == "unknown_action"
                assert doc["epoch"] == a.membership.view().epoch
                status, doc = await req(
                    "POST", "/membership",
                    {"action": "remove", "member_id": "ghost"},
                )
                assert status == 400 and doc["reason"] == "invalid_transition"
                status, doc = await req("POST", "/membership", raw=b"}{")
                assert status == 400 and doc["reason"] == "bad_json"

                # The cold-client snapshot.
                status, boot = await req("GET", "/bootstrap")
                assert status == 200 and boot["enabled"]
                assert boot["catalog_total"] == 5
                assert len(boot["catalog"]) == 5
                status, doc = await req("GET", "/bootstrap?limit=2")
                assert status == 200 and len(doc["catalog"]) == 2
                assert doc["catalog_total"] == 5

                http.close()
                await http.wait_closed()
                return boot

            boot = asyncio.run(drive())

            # A cold client reconstructs view + catalog from the snapshot
            # and serves lookups immediately.
            cold = ClusterKVConnector.bootstrap(
                boot, SPEC, "gossip-test", max_blocks=8, degrade=True,
                replicas=2, breaker_factory=_fast_breakers, device="cpu",
            )
            try:
                assert cold.membership.view().epoch == a.membership.view().epoch
                assert set(cold.member_ids) == set(a.member_ids)
                assert cold.membership_status()["reshard_catalog_roots"] == 5
                assert cold.lookup(prompts[0]) == 2
            finally:
                cold.close()
        finally:
            a.close()
            b.close()
            for c in conns:
                try:
                    c.close()
                except Exception:
                    pass
            for s in servers:
                s.stop()

    def test_no_cluster_routes_answer_structured(self):
        from infinistore_tpu_torch.config import ServerConfig
        from infinistore_tpu_torch.server import ManageServer

        async def drive():
            manage = ManageServer(ServerConfig(manage_port=0))
            http = await asyncio.start_server(
                manage._handle, host="127.0.0.1", port=0
            )
            port = http.sockets[0].getsockname()[1]
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"GET /bootstrap HTTP/1.1\r\n\r\n")
            await writer.drain()
            raw = await reader.read()
            writer.close()
            head, _, body = raw.partition(b"\r\n\r\n")
            assert int(head.split()[1]) == 400
            doc = json.loads(body)
            assert doc["reason"] == "no_cluster" and doc["epoch"] == 0
            http.close()
            await http.wait_closed()

        asyncio.run(drive())


# ---------------------------------------------------------------------------
# The faults "crash" capability (process-level kill -9).
# ---------------------------------------------------------------------------


class TestCrashCapability:
    def test_crash_action_sigkills_the_process(self):
        """FaultRule(action="crash") hard-kills the process at the
        scripted op — proven in a SUBPROCESS (rc == -SIGKILL); nothing
        after the faulted op runs (no marker file)."""
        script = (
            "import sys\n"
            "from infinistore_tpu_torch.faults import FaultRule, FaultyConnection\n"
            "class Dummy:\n"
            "    def check_exist(self, key):\n"
            "        return True\n"
            "fc = FaultyConnection(Dummy(), [FaultRule(op='check_exist',"
            " after=1, action='crash')])\n"
            "fc.check_exist('a')\n"
            "print('before', flush=True)\n"
            "fc.check_exist('b')\n"
            "print('after', flush=True)\n"
        )
        proc = subprocess.run(
            [sys.executable, "-c", script], capture_output=True, timeout=120,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        assert proc.returncode == -9
        assert b"before" in proc.stdout
        assert b"after" not in proc.stdout


