"""The port's elastic membership (``infinistore_tpu_torch.membership`` and
the elastic surface of its ``ClusterKVConnector``) on the CPU, over the
port's own loopback servers: the 22 tests of ``tests/test_membership.py``
(epoch-stamped views, the JOINING/ACTIVE/LEAVING/DEAD state machine,
rendezvous-delta properties, live resharding with epoch-aware read
failover, the ``/membership`` routes of the port's ``ManageServer``, and,
under the ``chaos`` marker, a member killed during an in-flight reshard and
a join while another member's breaker is open), and the lock tracer of
``tests/test_interleave.py`` over the port's cluster and ``DurableLog``.
Caches are bf16 torch tensors on the CPU, made from a numpy seed.
"""

import asyncio
import json
import os
import sys

import numpy as np
import pytest
import torch

import infinistore_tpu_torch as itt
from infinistore_tpu_torch import ClusterKVConnector, rendezvous_ranked
from infinistore_tpu_torch.cluster import CircuitBreaker
from infinistore_tpu_torch.membership import Membership, MemberState
from infinistore_tpu_torch.cuda.paged import PagedKVCacheSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SPEC = PagedKVCacheSpec(
    num_layers=2, num_blocks=16, block_tokens=8, num_kv_heads=2, head_dim=32,
    dtype=torch.bfloat16,
)


# ---------------------------------------------------------------------------
# rendezvous_ranked delta properties (pure; the math elasticity rests on)
# ---------------------------------------------------------------------------

ROOTS = [f"root-{i}" for i in range(2000)]


def _owner(ids, root):
    return ids[rendezvous_ranked(ids, root)[0]]


class TestRendezvousDelta:
    def test_join_moves_at_most_its_fair_share(self):
        """Adding one member to N moves ownership of ~1/(N+1) of roots
        (binomial slack), and every moved root moves TO the joiner."""
        members = [f"m{i}:0" for i in range(4)]
        grown = members + ["joiner:9"]
        moved = 0
        for r in ROOTS:
            before, after = _owner(members, r), _owner(grown, r)
            if before != after:
                moved += 1
                assert after == "joiner:9"  # delta moves toward the joiner only
        expect = len(ROOTS) / len(grown)
        assert moved <= expect + 4 * (expect * (1 - 1 / len(grown))) ** 0.5
        assert moved > 0.5 * expect  # and the joiner really takes a share

    def test_removal_moves_only_owned_roots(self):
        members = [f"m{i}:0" for i in range(5)]
        survivors = [m for m in members if m != "m2:0"]
        for r in ROOTS:
            before = _owner(members, r)
            after = _owner(survivors, r)
            if before == "m2:0":
                assert after in survivors
            else:
                assert after == before  # unowned roots never move

    def test_removal_preserves_surviving_rank_order(self):
        """Owner->successor promotion: removing a member promotes the ranks
        below it and NEVER reorders the survivors — so R=2 replica sets
        survive drains with only the promoted successor changing."""
        members = [f"m{i}:0" for i in range(5)]
        survivors = [m for m in members if m != "m2:0"]
        for r in ROOTS[:500]:
            full = [members[i] for i in rendezvous_ranked(members, r)]
            pruned = [m for m in full if m != "m2:0"]
            got = [survivors[i] for i in rendezvous_ranked(survivors, r)]
            assert got == pruned


# ---------------------------------------------------------------------------
# Membership state machine (pure)
# ---------------------------------------------------------------------------

class TestMembershipStateMachine:
    def test_transitions_bump_epochs_and_settle(self):
        m = Membership(["a:1", "b:2"])
        assert m.view().epoch == 1 and m.settled
        v = m.add_member("c:3")
        assert v.epoch == 2 and v.state_of("c:3") == MemberState.JOINING
        assert not m.settled and m.prev_placement == ("a:1", "b:2")
        assert set(v.placement_ids()) == {"a:1", "b:2", "c:3"}
        v = m.finalize_transitions()
        assert v.epoch == 3 and v.state_of("c:3") == MemberState.ACTIVE
        assert m.settled and m.prev_placement is None

    def test_leave_stays_readable_until_finalized(self):
        m = Membership(["a:1", "b:2", "c:3"])
        v = m.remove_member("b:2")
        assert v.state_of("b:2") == MemberState.LEAVING
        assert "b:2" not in v.placement_ids()  # no new writes
        assert "b:2" in v.readable_ids()  # still serves reads
        v = m.finalize_transitions()
        assert v.state_of("b:2") == MemberState.REMOVED
        assert "b:2" not in v.readable_ids()

    def test_dead_is_unreadable_immediately(self):
        m = Membership(["a:1", "b:2", "c:3"])
        v = m.mark_dead("b:2")
        assert v.state_of("b:2") == MemberState.DEAD
        assert "b:2" not in v.readable_ids()

    def test_invalid_transitions_raise(self):
        m = Membership(["a:1", "b:2"])
        with pytest.raises(ValueError):
            m.add_member("a:1")  # live id collision
        m.mark_dead("b:2")
        with pytest.raises(ValueError):
            m.remove_member("b:2")  # DEAD is terminal
        with pytest.raises(ValueError):
            m.mark_dead("b:2")
        with pytest.raises(ValueError):
            Membership([])
        with pytest.raises(ValueError):
            Membership(["x", "x"])

    def test_dead_id_may_rejoin_as_new_entry(self):
        m = Membership(["a:1", "b:2"])
        m.mark_dead("b:2")
        v = m.add_member("b:2")  # a restarted node rejoins under its old id
        assert v.state_of("b:2") == MemberState.JOINING  # latest entry wins
        assert len(v.member_ids) == 3  # tombstone retained: indices stable
        assert m.index_of("b:2") == 2

    def test_finalize_without_pending_is_a_noop(self):
        m = Membership(["a:1"])
        assert m.finalize_transitions() is None
        assert m.view().epoch == 1

    def test_last_placement_member_cannot_be_removed(self):
        """A graceful drain promises the data survives — with nowhere to
        re-mirror it, the transition must be refused (mark_dead remains
        for recording a real crash)."""
        m = Membership(["a:1", "b:2"])
        m.remove_member("a:1")
        with pytest.raises(ValueError):
            m.remove_member("b:2")
        m.mark_dead("b:2")  # recording a crash is still allowed

    def test_finalize_refuses_a_stale_epoch(self):
        """The resharder finalizes with the epoch it PLANNED at: a
        transition landing in between must be re-planned, never
        rubber-stamped to REMOVED with zero migration done."""
        m = Membership(["a:1", "b:2", "c:3"])
        m.add_member("d:4")
        planned = m.view().epoch
        m.remove_member("b:2")  # lands between plan and finalize
        assert m.finalize_transitions(expected_epoch=planned) is None
        assert m.view().state_of("b:2") == MemberState.LEAVING  # untouched
        v = m.finalize_transitions(expected_epoch=m.view().epoch)
        assert v.state_of("b:2") == MemberState.REMOVED

    def test_status_counters(self):
        m = Membership(["a:1", "b:2", "c:3"])
        m.add_member("d:4")
        m.mark_dead("a:1")
        s = m.status()
        assert s["membership_epoch"] == 3
        assert s["membership_members"] == 3  # b, c + joining d
        assert s["membership_joining"] == 1 and s["membership_dead"] == 1
        assert s["membership_settled"] == 0


# ---------------------------------------------------------------------------
# live clusters
# ---------------------------------------------------------------------------

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


class _Pool:
    """N live loopback servers + a replicated elastic cluster over them,
    with saved roots and a correctness sweep."""

    def __init__(self, n, conn_wrap=None, **cluster_kw):
        self.servers = [_start_server() for _ in range(n)]
        self.conns = [_connect(s.port) for s in self.servers]
        wrapped = [
            conn_wrap(i, c) if conn_wrap is not None else c
            for i, c in enumerate(self.conns)
        ]
        kw = dict(
            degrade=True, replicas=2, breaker_factory=_fast_breakers,
            member_ids=[f"127.0.0.1:{s.port}" for s in self.servers],
        )
        kw.update(cluster_kw)
        self.cluster = ClusterKVConnector(wrapped, SPEC, "member-test",
                                          max_blocks=8, device="cpu", **kw)
        self.contents = {}
        self.prompts = []
        self.src = np.array([3, 9], np.int32)

    def seed_roots(self, n_roots, rng_seed=5):
        rng = np.random.default_rng(rng_seed)
        self.prompts = [
            rng.integers(0, 1000, size=2 * SPEC.block_tokens).tolist()
            for _ in range(n_roots)
        ]
        for i, p in enumerate(self.prompts):
            self.contents[i] = _mk_caches(i)
            asyncio.run(self.cluster.save(p, self.contents[i], self.src))

    def sweep(self):
        """(reads, misses, wrong) over every saved root."""
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

    def join(self):
        srv = _start_server()
        self.servers.append(srv)
        conn = _connect(srv.port)
        self.conns.append(conn)
        return srv, conn, self.cluster.add_member(conn)

    def close(self):
        self.cluster.close()
        for c in self.conns:
            try:
                c.close()
            except Exception:
                pass
        for s in self.servers:
            s.stop()


@pytest.fixture()
def pool3():
    p = _Pool(3)
    try:
        yield p
    finally:
        p.close()


def _kvmap_len(server) -> int:
    from infinistore_tpu_torch._native import lib as native

    return int(native.its_server_kvmap_len(server.handle))


class TestLiveResharding:
    def test_join_migrates_only_the_delta_and_reads_stay_correct(self, pool3):
        pool3.seed_roots(16)
        place_before = list(pool3.cluster.membership.view().placement_ids())
        srv4, _, view = pool3.join()
        assert view.epoch == 2
        reads, misses, wrong = pool3.sweep()  # mid-reshard (maybe): failover
        assert (misses, wrong) == (0, 0)
        assert pool3.cluster.resharder.wait_idle(timeout=30.0)
        # Finalized: joiner ACTIVE, single placement again.
        view = pool3.cluster.membership.view()
        joiner_id = f"127.0.0.1:{srv4.port}"
        assert view.state_of(joiner_id) == MemberState.ACTIVE
        # Only the rendezvous delta moved: the joiner holds exactly the
        # roots whose new top-R set contains it.
        new_place = place_before + [joiner_id]
        delta = sum(
            joiner_id in [
                new_place[k]
                for k in rendezvous_ranked(new_place, pool3.cluster._root_of(p))[:2]
            ]
            for p in pool3.prompts
        )
        progress = pool3.cluster.resharder.progress()
        assert progress["reshard_moved_roots"] == delta
        assert progress["reshard_debt_roots"] == 0
        assert _kvmap_len(srv4) > 0
        reads, misses, wrong = pool3.sweep()
        assert (misses, wrong) == (0, 0)
        # Migration traffic was BACKGROUND-tagged on the wire (ITS-P003's
        # runtime half): the joiner's connection only ever saw bg batches.
        assert pool3.conns[-1].qos_stats()["bg_ops"] > 0

    def test_graceful_leave_re_mirrors_before_the_node_goes_away(self, pool3):
        pool3.seed_roots(12)
        leaver = pool3.cluster.member_ids[0]
        view = pool3.cluster.remove_member(leaver)
        assert view.state_of(leaver) == MemberState.LEAVING
        assert pool3.cluster.resharder.wait_idle(timeout=30.0)
        assert (
            pool3.cluster.membership.view().state_of(leaver)
            == MemberState.REMOVED
        )
        # NOW the operator may stop the node: every root has R copies on
        # the survivors, so reads never miss or touch the leaver.
        pool3.servers[0].stop()
        reads, misses, wrong = pool3.sweep()
        assert (misses, wrong) == (0, 0)
        assert pool3.cluster.resharder.progress()["reshard_debt_roots"] == 0

    def test_mark_dead_re_replicates_from_surviving_replica(self, pool3):
        pool3.seed_roots(12)
        victim = pool3.cluster.member_ids[1]
        pool3.servers[1].stop()  # crash, copies lost
        pool3.cluster.mark_dead(victim)
        assert pool3.cluster.resharder.wait_idle(timeout=30.0)
        reads, misses, wrong = pool3.sweep()
        assert (misses, wrong) == (0, 0)
        # R=2 restored: every root is on both survivors.
        with pool3.cluster._cat_lock:
            holders = [sorted(r.holders) for r in pool3.cluster._catalog.values()]
        survivors = sorted(
            m for m in pool3.cluster.member_ids if m != victim
        )
        assert all(h == survivors for h in holders)

    def test_save_during_join_lands_on_new_placement_without_debt(self, pool3):
        pool3.seed_roots(6)
        pool3.join()
        # New data saved mid-reshard routes by the NEW placement: it never
        # becomes migration debt.
        rng = np.random.default_rng(99)
        extra = rng.integers(0, 1000, size=2 * SPEC.block_tokens).tolist()
        idx = len(pool3.prompts)
        pool3.prompts.append(extra)
        pool3.contents[idx] = _mk_caches(idx)
        asyncio.run(pool3.cluster.save(extra, pool3.contents[idx], pool3.src))
        assert pool3.cluster.resharder.wait_idle(timeout=30.0)
        reads, misses, wrong = pool3.sweep()
        assert (misses, wrong) == (0, 0)
        assert pool3.cluster.resharder.progress()["reshard_debt_roots"] == 0

    def test_partial_save_never_overclaims_a_holder(self, pool3):
        """A first_block>0 extension landing on a member WITHOUT the base
        must not make it look like a complete holder — that mistake would
        let the resharder prune the only copy of the base blocks."""
        pool3.seed_roots(1)
        p = pool3.prompts[0]
        root = pool3.cluster._root_of(p)
        long_p = p + p[:SPEC.block_tokens]  # one more complete block
        with pool3.cluster._cat_lock:
            holders0 = set(pool3.cluster._catalog[root].holders)
        # The one member R=2 did NOT place this root on.
        newcomer = next(
            m for m in pool3.cluster.member_ids if m not in holders0
        )
        # Tail-only save attributed to a member that never took the base.
        pool3.cluster._catalog_record(long_p, 3, [newcomer], first_block=2)
        with pool3.cluster._cat_lock:
            rec = pool3.cluster._catalog[root]
            assert rec.holders.get(newcomer, 0) == 0  # no overclaim
            full = [m for m, lv in rec.holders.items() if lv == rec.blocks]
        # Contiguous extension on an existing holder DOES raise its level.
        pool3.cluster._catalog_record(long_p, 3, [full[0]], first_block=2)
        with pool3.cluster._cat_lock:
            rec = pool3.cluster._catalog[root]
            assert rec.holders[full[0]] == 3 and rec.blocks == 3
        # The plan never uses a level-0 holder as a source, and never
        # prunes while a wanted member lacks the full level.
        for task in pool3.cluster.reshard_plan():
            if task.root == root:
                assert newcomer not in task.sources

    def test_copy_of_a_dropped_root_is_undone(self, pool3):
        """The drop-vs-copy race, pinned deterministically: a copy whose
        root vanished from the catalog mid-flight (dropped) must be undone
        on the destination — otherwise the new owner would serve a dropped
        prompt forever (no later plan can prune an uncataloged root)."""
        from infinistore_tpu_torch.membership import _RootTask

        pool3.seed_roots(1)
        root = pool3.cluster._root_of(pool3.prompts[0])
        with pool3.cluster._cat_lock:
            rec = pool3.cluster._catalog.pop(root)  # the concurrent drop
        # Destination: a fresh member with nothing on it.
        srv4, _, _ = pool3.join()
        assert pool3.cluster.resharder.wait_idle(timeout=30.0)
        before = _kvmap_len(srv4)
        task = _RootTask(
            root=root, tokens=rec.tokens, blocks=rec.blocks,
            sources=sorted(rec.holders),
            targets=[f"127.0.0.1:{srv4.port}"],
        )
        assert pool3.cluster.resharder._copy_root(task, task.targets[0])
        # The copy landed and was immediately undone: nothing stray stays.
        assert _kvmap_len(srv4) == before
        moved = pool3.cluster.resharder.progress()["reshard_moved_keys"]
        assert moved > 0  # the copy really ran before the undo

    def test_drop_mid_reshard_deletes_every_copy(self, pool3):
        pool3.seed_roots(8)
        pool3.join()
        victim_prompt = pool3.prompts[0]
        assert pool3.cluster.drop(victim_prompt) > 0
        assert pool3.cluster.resharder.wait_idle(timeout=30.0)
        assert pool3.cluster.lookup(victim_prompt) == 0
        # The dropped root is gone from the catalog too: nothing re-mirrors
        # it back.
        with pool3.cluster._cat_lock:
            assert pool3.cluster._root_of(victim_prompt) not in pool3.cluster._catalog


class TestManagePlane:
    def test_membership_get_post_and_metrics(self, pool3):
        from infinistore_tpu_torch.config import ServerConfig
        from infinistore_tpu_torch.server import ManageServer

        pool3.seed_roots(6)
        extra_srv = _start_server()
        pool3.servers.append(extra_srv)

        async def drive():
            manage = ManageServer(
                ServerConfig(service_port=pool3.servers[0].port, manage_port=0),
                cluster=pool3.cluster,
            )
            server = await asyncio.start_server(
                manage._handle, host="127.0.0.1", port=0
            )
            port = server.sockets[0].getsockname()[1]

            async def req(method, path, body=None):
                reader, writer = await asyncio.open_connection("127.0.0.1", port)
                payload = json.dumps(body).encode() if body is not None else b""
                writer.write(
                    f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                    f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload
                )
                await writer.drain()
                raw = await reader.read()
                writer.close()
                head, _, body_bytes = raw.partition(b"\r\n\r\n")
                return int(head.split()[1]), body_bytes

            status, body = await req("GET", "/membership")
            doc = json.loads(body)
            assert status == 200 and doc["enabled"] and doc["epoch"] == 1
            assert doc["membership_settled"] == 1
            assert {m["state"] for m in doc["members"]} == {"active"}

            status, body = await req("POST", "/membership", {
                "action": "add", "host": "127.0.0.1",
                "service_port": extra_srv.port,
            })
            assert status == 200 and json.loads(body)["epoch"] == 2

            status, body = await req("POST", "/membership", {
                "action": "remove", "member_id": pool3.cluster.member_ids[0],
            })
            assert status == 200

            status, _ = await req("POST", "/membership", {"action": "nope"})
            assert status == 400
            status, _ = await req(
                "POST", "/membership", {"action": "remove", "member_id": "ghost"}
            )
            assert status == 400
            status, _ = await req("DELETE", "/membership")
            assert status == 405

            status, body = await req("GET", "/metrics")
            assert status == 200
            assert b"infinistore_membership_epoch" in body
            assert b"infinistore_reshard_debt_roots" in body

            server.close()
            await server.wait_closed()

        asyncio.run(drive())
        # The POSTed transitions really drove the cluster: joiner admitted,
        # leaver drained, reads stay whole.
        assert pool3.cluster.resharder.wait_idle(timeout=30.0)
        reads, misses, wrong = pool3.sweep()
        assert (misses, wrong) == (0, 0)
        extra_conn = pool3.cluster.members[-1].conn
        try:
            reads2 = _kvmap_len(extra_srv)
            assert reads2 >= 0  # joiner server alive and queried
        finally:
            extra_conn.close()


# ---------------------------------------------------------------------------
# chaos: churn under failure (CI chaos job, hard timeout)
# ---------------------------------------------------------------------------

@pytest.mark.chaos
class TestChurnChaos:
    def test_member_killed_during_inflight_reshard_replans(self):
        """A source member dies mid-migration: the pass aborts, the next
        epoch's replan re-sources every remaining root from the surviving
        replica, and the pool converges with 0 debt and 0 wrong reads."""
        from infinistore_tpu_torch.faults import FaultRule, FaultyConnection

        # Slow every migration read (sync read_cache) down so the reshard
        # is reliably in flight when the kill lands; foreground loads ride
        # read_cache_async and stay fast.
        def wrap(i, conn):
            return FaultyConnection(conn, [
                FaultRule(op="read_cache", action="delay", delay_s=0.05)
            ], seed=i)

        pool = _Pool(3, conn_wrap=wrap)
        try:
            pool.seed_roots(12)
            pool.join()  # reshard starts, throttled by the delays
            victim = next(
                mid for mid in pool.cluster.member_ids[:3]
                if pool.cluster.membership.view().state_of(mid) == "active"
            )
            vi = pool.cluster.member_index(victim)
            pool.servers[vi].stop()  # the kill, mid-reshard
            pool.cluster.mark_dead(victim)  # epoch change -> replan
            assert pool.cluster.resharder.wait_idle(timeout=60.0)
            progress = pool.cluster.resharder.progress()
            assert progress["reshard_debt_roots"] == 0
            reads, misses, wrong = pool.sweep()
            assert (misses, wrong) == (0, 0)
        finally:
            pool.close()

    def test_join_while_another_members_breaker_is_open(self):
        """A join must complete while one member is dark behind an OPEN
        breaker: the resharder sources every root from the surviving
        holder instead of burning timeouts on the open one."""
        pool = _Pool(3)
        try:
            # 24 roots: the dark member owns (rank-0) ~1/3 of them, and
            # only rank-0 lookups reach it (rank-1 is never probed when
            # the owner serves) — with 24 the odds it owns none are
            # negligible, and repeated sweeps accumulate the consecutive
            # errors the fail_threshold=2 breaker needs.
            pool.seed_roots(24)
            dark = pool.cluster.member_ids[2]
            di = pool.cluster.member_index(dark)
            pool.servers[2].stop()
            # Trip the breaker with doomed reads: sweep until it opens.
            for _ in range(4):
                for p in pool.prompts:
                    pool.cluster.lookup(p)
                    if (
                        pool.cluster._health[di].breaker.state
                        == CircuitBreaker.OPEN
                    ):
                        break
                if pool.cluster._health[di].breaker.state != CircuitBreaker.CLOSED:
                    break
            assert pool.cluster._health[di].breaker.state != CircuitBreaker.CLOSED
            pool.join()
            assert pool.cluster.resharder.wait_idle(timeout=60.0)
            assert pool.cluster.resharder.progress()["reshard_debt_roots"] == 0
            reads, misses, wrong = pool.sweep()
            assert (misses, wrong) == (0, 0)
            # The dark member never served as a migration source: its only
            # traffic was the doomed lookups and (maybe) half-open probes.
            assert _kvmap_len(pool.servers[-1]) > 0
        finally:
            pool.close()


# ---------------------------------------------------------------------------
# The lock tracer over the port's cluster and DurableLog
# (tests/test_interleave.py::TestLockTracer).
# ---------------------------------------------------------------------------


class TestLockTracer:
    def _cluster(self, tmp_path):
        """A real port ClusterKVConnector (fake member, durable journal)
        built under the tracer: no servers, no tensors."""

        class _FakeConn:
            pass

        return ClusterKVConnector(
            [_FakeConn()], spec=None, model_id="trace-test", max_blocks=8,
            member_ids=["m0:1"], member_factory=lambda c: c,
            journal_path=str(tmp_path / "journal.bin"), device="cpu",
        )

    def _traced(self, tmp_path):
        from tools.analysis.interleave import trace_locks

        with trace_locks() as tracer:
            cluster = self._cluster(tmp_path)
            tracer.adopt(cluster, "ClusterKVConnector")
            tracer.adopt(cluster._journal_log, "DurableLog")
            tracer.adopt(cluster.membership, "Membership")
        return tracer, cluster

    def test_shim_observes_known_nested_acquisition(self, tmp_path):
        """The journal compaction's snapshot callable takes the catalog
        lock UNDER the log lock, in the port as in the reference."""
        tracer, cluster = self._traced(tmp_path)
        try:
            cluster.catalog_restore([{
                "root": "r0", "tokens": [1, 2, 3, 4], "blocks": 1,
                "holders": {"m0:1": 1},
            }])
            cluster.compact_journal()
        finally:
            cluster.close()
        edges = tracer.edge_set()
        assert ("DurableLog._lock", "ClusterKVConnector._cat_lock") in edges
        # And the catalog lock is never taken the other way around.
        assert ("ClusterKVConnector._cat_lock", "DurableLog._lock") not in edges

    def test_observed_union_static_graph_is_acyclic(self, tmp_path):
        """The port's real acquisition orders (its close() included, which
        also closes members) embed into the reference's static lock-order
        graph without a cycle: the copies keep the reference's locks."""
        from tools.analysis import races
        from tools.analysis.core import Context
        from tools.analysis.interleave import find_cycle

        tracer, cluster = self._traced(tmp_path)
        try:
            cluster.catalog_restore([{
                "root": "r0", "tokens": [1, 2, 3, 4], "blocks": 1,
                "holders": {"m0:1": 1},
            }])
            cluster.compact_journal()
            cluster.membership.mark_dead("m0:1")
        finally:
            cluster.close()
        static_edges = set(races.lock_order_edges(races.PackageIndex(Context(str(REPO)))))
        combined = static_edges | tracer.edge_set()
        cycle = find_cycle(sorted(combined))
        assert cycle is None, f"lock-order cycle: {' -> '.join(cycle)}"

    def test_tracer_counts_acquisitions(self, tmp_path):
        from tools.analysis.interleave import trace_locks

        with trace_locks() as tracer:
            cluster = self._cluster(tmp_path)
            tracer.adopt(cluster, "ClusterKVConnector")
        try:
            # catalog_get takes the catalog lock once per call.
            before = tracer.acquisitions.get("ClusterKVConnector._cat_lock", 0)
            cluster.catalog_get("nope")
            cluster.catalog_get("nope")
            after = tracer.acquisitions.get("ClusterKVConnector._cat_lock", 0)
        finally:
            cluster.close()
        assert after - before == 2
