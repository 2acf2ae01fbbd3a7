"""Multi-server KV pool: route requests across independent store servers.

The reference serves its "extra-large KV-cache pool + cross-node reuse"
scenario (reference README.md:13-16) with ONE server process; pooling across
several nodes is left to the layer above (LMCache routing). This module is
that layer: a cluster of independent servers presented as
one ``KVConnector``-shaped surface, so an engine (or the continuous-batching
harness) scales its cache pool horizontally without any change at the call
sites.

Routing is **prefix-affine**: a request's owner is chosen by rendezvous
(HRW) hashing of its chain ROOT — the hash of the first token block
(connector.py token_chain_hashes). Every prompt sharing a first block maps
to the same server, so an entire prefix tree colocates and the store's
binary-search longest-prefix match keeps working per-server with no
cross-server merge. Rendezvous hashing makes membership changes cheap:
removing a server remaps only the keys it owned; every other root keeps its
owner (tested), which is what lets an operator drain one cache node without
invalidating the rest of the pool.

The cluster is **self-healing** (docs/robustness.md):

- Every member sits behind a :class:`CircuitBreaker`: consecutive transport
  errors OPEN it, after which ops against that member fast-fail locally (no
  per-op timeout burn) except one half-open probe per exponential-backoff
  window. A successful probe closes the breaker — a restarted node rejoins
  within one probe window, and the probe itself heals a dead connection
  (``reconnect``) so the async data plane recovers too, not just the
  auto-reconnecting sync ops.
- With ``replicas=2`` (rendezvous R=2: the HRW owner plus the runner-up),
  saves mirror to both members and lookups/loads FAIL OVER to the replica
  when the owner is open or erroring: one node death degrades to replica
  reads instead of recompute. ``replicas=1`` (default) keeps the
  single-owner behavior exactly.

Failure policy is explicit: ``degrade=False`` (default) propagates member
errors once no replica could serve — the engine must see "store
unreachable" (the lookup() contract, connector.py). ``degrade=True``
converts an unserved op into a cache miss (lookup 0 / load 0 / save
skipped), counted in the aggregate ``degraded_ops`` AND per-member in
``stats()``/``health()`` so an operator can tell WHICH node is sick: on an
engine, a dead cache node should cost recompute, not availability.

Membership is **elastic** (docs/membership.md): the member list is a
versioned :class:`~.membership.Membership` view, and
:meth:`ClusterKVConnector.add_member` / :meth:`remove_member` /
:meth:`mark_dead` change it at runtime. Every op routes through the
CURRENT view; while a transition's background reshard
(:class:`~.membership.Resharder`) is still moving the rendezvous-delta
keys, reads are **epoch-aware**: they try the new owner first and fall
back to the old owner / surviving replica on a miss, so availability
stays 1.0 mid-reshard. The cluster keeps a root **catalog** (which
members hold which root's keys) that the resharder reconciles against the
view's rendezvous placement.

The PyTorch port of ``infinistore_tpu/cluster.py``, over the port's member
connectors (``connector.KVConnector``, ``cuda.kv_quant.QuantizedKVConnector``)
and its copies of ``membership``, ``tiering``, ``telemetry``, ``tracing``,
``wire`` and ``lib``; keep the two in step. The cluster touches no device
memory itself: it routes, counts and passes ``caches`` and ``block_ids``
through to its members. Where it differs from the reference:

- ``device`` (default ``"cuda"``) is what the default member factory builds
  its ``KVConnector`` on; a ``member_factory`` chooses for itself.
- ``close()`` also closes the member connectors the cluster built (their
  staging pools are page-locked on a CUDA device, and must be released
  before the connections close).
- The caches a partial read hands back: a member's K2 scatters into the
  caller's tensors in place, so the layers before a failure are updated and
  the rest untouched. The reference's contract stays: the returned list (and
  ``PartialReadError.caches``) is the one to use.
- Error classification (``_is_transport``) is against the port's
  ``PartialReadError`` and ``lib`` exception classes, which are what the
  port's connectors raise. Routing, breakers, the catalog and its journal
  format, gossip, bootstrap and tiering are the reference's code: a journal
  or a bootstrap payload written by either package is read by the other.
"""

import asyncio
import hashlib
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import telemetry, tracing, wire
from .connector import KVConnector, token_chain_hashes
from .lib import (
    InfiniStoreException,
    InfiniStoreKeyNotFound,
    InfiniStoreNoMatch,
    InfiniStoreResourcePressure,
    Logger,
)
from .membership import DurableLog, MemberState, Membership, Resharder, _RootTask
from .cuda.layerwise import PartialReadError
from .cuda.paged import PagedKVCacheSpec


def _score(member_id: str, root: str) -> bytes:
    return hashlib.sha256(f"{member_id}|{root}".encode()).digest()


def rendezvous_owner(member_ids: Sequence[str], root: str) -> int:
    """Index of the HRW winner for ``root``: argmax of
    sha256(member_id | root). Stable under membership change — removing one
    member only remaps the roots it owned."""
    if not member_ids:
        raise ValueError("rendezvous_owner needs at least one member")
    best, best_score = 0, b""
    for i, mid in enumerate(member_ids):
        score = _score(mid, root)
        if score > best_score:
            best, best_score = i, score
    return best


def rendezvous_ranked(member_ids: Sequence[str], root: str) -> List[int]:
    """ALL member indices for ``root``, by descending HRW score: index 0 is
    the owner (== :func:`rendezvous_owner`), index 1 the replication
    successor, and so on. The same stability property holds rank-wise:
    removing one member only promotes the members ranked below it for the
    roots where it appeared — every other (root, rank) pairing is
    untouched, so R=2 replica placement survives drains as cheaply as
    ownership does."""
    if not member_ids:
        raise ValueError("rendezvous_ranked needs at least one member")
    return sorted(
        range(len(member_ids)),
        key=lambda i: _score(member_ids[i], root),
        reverse=True,
    )


def _is_transport(exc: BaseException) -> bool:
    """Transport/availability errors trip breakers; SEMANTIC errors (miss,
    no-match, resource pressure) prove the member answered and must not —
    a store shedding load under memory pressure is sick, not dead, and
    opening its breaker would turn pressure into an outage."""
    if isinstance(exc, PartialReadError):
        return exc.cause is None or _is_transport(exc.cause)
    return isinstance(exc, InfiniStoreException) and not isinstance(
        exc,
        (InfiniStoreKeyNotFound, InfiniStoreNoMatch, InfiniStoreResourcePressure),
    )


class CircuitBreaker:
    """Per-member availability gate: CLOSED -> OPEN after ``fail_threshold``
    consecutive transport errors; while OPEN every op fast-fails locally
    except one half-open probe per backoff window (exponential with
    deterministic seeded jitter, so a fleet of breakers does not probe in
    lockstep); a probe success re-CLOSES, a probe failure re-OPENs with
    doubled backoff up to ``max_backoff_s``.

    The point is cost: without a breaker, every op routed to a dead member
    burns a full transport timeout; with one, a dead member costs one
    fast-failed op per probe window. ``clock`` is injectable (tests drive
    the state machine with a fake clock; defaults to ``time.monotonic``).
    Not thread-safe by itself — callers serialize (the cluster guards every
    breaker touch with its ``_breaker_lock``, since the resharder's worker
    thread feeds the same breakers as the caller's loop).
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(
        self,
        fail_threshold: int = 3,
        probe_backoff_s: float = 0.25,
        max_backoff_s: float = 8.0,
        jitter_frac: float = 0.2,
        seed: int = 0,
        clock=time.monotonic,
    ):
        if fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        if probe_backoff_s <= 0 or max_backoff_s < probe_backoff_s:
            raise ValueError("need 0 < probe_backoff_s <= max_backoff_s")
        self.fail_threshold = fail_threshold
        self.probe_backoff_s = probe_backoff_s
        self.max_backoff_s = max_backoff_s
        self.jitter_frac = jitter_frac
        self._rng = random.Random(seed)
        self._clock = clock
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        self.next_probe_at: Optional[float] = None
        self._backoff = probe_backoff_s

    def _schedule_probe(self):
        jitter = 1.0 + self.jitter_frac * self._rng.random()
        self.next_probe_at = self._clock() + self._backoff * jitter

    def allow(self) -> bool:
        """May an op proceed against this member right now? CLOSED: always.
        OPEN: only once the probe window elapsed — that call becomes THE
        half-open probe (subsequent calls fast-fail until its outcome is
        recorded). HALF_OPEN: no — one probe in flight is enough."""
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN and self._clock() >= (self.next_probe_at or 0.0):
            self.state = self.HALF_OPEN
            return True
        return False

    def record_success(self) -> bool:
        """An op (or the half-open probe) succeeded. Returns True when this
        success RECOVERED the member (breaker was not closed)."""
        recovered = self.state != self.CLOSED
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.opened_at = None
        self.next_probe_at = None
        self._backoff = self.probe_backoff_s
        return recovered

    def record_failure(self):
        """An op against this member failed with a transport error."""
        self.consecutive_failures += 1
        if self.state == self.HALF_OPEN:
            # The probe failed: still down — back off harder.
            self.state = self.OPEN
            self._backoff = min(self._backoff * 2.0, self.max_backoff_s)
            self._schedule_probe()
        elif self.state == self.CLOSED and (
            self.consecutive_failures >= self.fail_threshold
        ):
            self.state = self.OPEN
            self.opened_at = self._clock()
            self._backoff = self.probe_backoff_s
            self._schedule_probe()
        # state OPEN: a straggler op that was in flight when we opened —
        # counted, but the probe schedule stands.

    def snapshot(self) -> dict:
        """Observability dict (stats()/health() building block)."""
        now = self._clock()
        return {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "open_for_s": (
                round(now - self.opened_at, 3) if self.opened_at is not None else 0.0
            ),
            "next_probe_in_s": (
                round(max(0.0, self.next_probe_at - now), 3)
                if self.next_probe_at is not None and self.state != self.CLOSED
                else 0.0
            ),
        }


@dataclass
class _MemberHealth:
    """Per-member failure-domain bookkeeping (the attributable counters the
    old single global ``degraded_ops`` could not provide)."""

    breaker: CircuitBreaker
    errors: int = 0  # transport errors observed
    fast_fails: int = 0  # ops denied locally while the breaker was open
    probes: int = 0  # half-open probes attempted
    recoveries: int = 0  # probe successes that re-closed the breaker
    degraded_ops: int = 0  # ops degraded to a miss while this member OWNED them
    replica_serves: int = 0  # ops this member served as a non-owner replica
    last_error: Optional[str] = None

    def as_dict(self) -> dict:
        d = self.breaker.snapshot()
        return {
            "breaker_state": d["state"],
            "breaker_consecutive_failures": d["consecutive_failures"],
            "breaker_open_for_s": d["open_for_s"],
            "breaker_next_probe_in_s": d["next_probe_in_s"],
            "errors": self.errors,
            "fast_fails": self.fast_fails,
            "probes": self.probes,
            "recoveries": self.recoveries,
            "degraded_ops": self.degraded_ops,
            "replica_serves": self.replica_serves,
            "last_error": self.last_error,
        }


@dataclass
class _RootRecord:
    """Catalog entry for one prefix tree (chain root): what was saved and
    which members are believed to hold it — the client-side metadata the
    resharder reconciles against the view's rendezvous placement.

    ``holders`` maps member id -> contiguous complete blocks held FROM
    BLOCK 0 (the level). Levels matter: a ``first_block>0`` extension save
    only raises the level of members that already held the base (a member
    receiving just the tail has a hole and keeps its old level), so the
    resharder can never mistake a partial copy for a complete one and
    prune the only member holding the base blocks."""

    tokens: np.ndarray  # full-block token ids (int64; longest prefix seen)
    blocks: int  # highest holder level (complete blocks saved under root)
    holders: Dict[str, int] = field(default_factory=dict)


class _DeadConn:
    """Inert connection placeholder for a member whose id the dial
    factory cannot resolve (or that appeared between a gossip merge's
    plan and apply, where dialing is not allowed): every touch raises the
    typed transport error, so ops feed the breaker and the member reads
    as down — the state it is in."""

    is_connected = False

    def __init__(self, member_id: str):
        self.member_id = member_id

    def reconnect(self):
        raise InfiniStoreException(
            f"member {self.member_id}: no dialable connection"
        )

    def close(self):
        pass


class _LazyMember:
    """Member connector built on FIRST USE over a connection the cluster
    dialed itself (journal-replay restore, gossip merge, cold bootstrap).

    A restored/gossiped member's store may be down at dial time; eagerly
    running ``member_factory`` would fail the whole recovery on the one
    member the breaker machinery exists to tolerate. Instead the wrapper
    holds (conn, factory) and materializes lazily: an op against a
    still-unconnected member raises a typed transport error — which feeds
    that member's breaker exactly like a dead node — and the breaker's
    half-open probe heals the connection (``_probe_heal``), after which
    the next op materializes the real connector. Terminal (DEAD/REMOVED)
    tombstone entries never route ops, so their wrapper never
    materializes at all."""

    def __init__(self, member_id: str, conn, factory):
        self.member_id = member_id
        self.conn = conn
        self._factory = factory
        self._m = None

    @property
    def QOS_AWARE(self):
        """Answer from the REAL member once built; before that, False —
        the router then drops the priority tag for that one op instead of
        guessing True and TypeError-ing a pre-QoS member factory's
        connector (the gate's contract: 'drops the tag, never
        TypeErrors'). This check must never raise or block."""
        m = self._m
        return getattr(m, "QOS_AWARE", False) if m is not None else False

    def _materialize(self):
        m = self._m
        if m is None:
            if not getattr(self.conn, "is_connected", True):
                # Typed transport error, no blocking reconnect here — the
                # breaker's probe path owns the (blocking, off-loop) heal.
                raise InfiniStoreException(
                    f"member {self.member_id} not connected yet (lazy)"
                )
            m = self._m = self._factory(self.conn)
        return m

    def __getattr__(self, name):
        return getattr(self._materialize(), name)


def _close_member(member) -> None:
    """Close a member connector (its staging pools' page locks). A factory
    that passes the bare connection through (no ``conn`` of its own) leaves
    it the caller's to close, and a lazy member never built has nothing to
    release."""
    if isinstance(member, _LazyMember):
        member = member._m  # never materialize one just to close it
    if member is None or getattr(member, "conn", None) is None:
        return
    closer = getattr(member, "close", None)
    if closer is not None:
        closer()


class ClusterKVConnector:
    """``KVConnector`` surface over N servers with prefix-affine routing,
    per-member circuit breakers, optional R-way rendezvous replication,
    and ELASTIC membership (live add/remove with online resharding —
    docs/membership.md).

    Duck-type compatible with what ``EngineKVAdapter`` needs (``spec``,
    ``lookup``/``load``/``save``/``drop``), so the continuous-batching
    harness runs unmodified over a cluster pool. Each member builds its own
    ``KVConnector`` (staging pool registered on that member's connection);
    ``handoff`` stays a per-member concern — it is mesh topology, not key
    routing.

    Membership surface: :meth:`add_member` / :meth:`remove_member` /
    :meth:`mark_dead` mutate the versioned view (``self.membership``);
    ``self.resharder`` migrates the rendezvous-delta keys in the
    background; :meth:`membership_status` is the flat counter snapshot the
    manage plane serves. Member entry indices are stable forever
    (tombstones), so ``members`` / ``member_ids`` / per-member health stay
    index-aligned across churn.
    """

    # Accepts the two-class priority kwarg on start_fetch (adapters gate
    # forwarding on this attribute — docs/qos.md).
    QOS_AWARE = True

    # Root-catalog bound: the oldest record is dropped past this (a record
    # is failover/migration *knowledge*, not data — an evicted record's
    # root still reads fine via placement ranking; the resharder just
    # cannot re-mirror it, same as a root another client wrote). Keeps a
    # long-lived engine's client memory and reconcile-pass cost bounded.
    CATALOG_MAX_ROOTS = 65536

    def __init__(
        self,
        conns: Sequence,
        spec: PagedKVCacheSpec,
        model_id: str,
        max_blocks: int,
        member_ids: Optional[Sequence[str]] = None,
        degrade: bool = False,
        member_factory=None,
        replicas: int = 1,
        breaker_factory=None,
        journal_path: Optional[str] = None,
        dial_factory=None,
        fsync_interval_s: float = 0.05,
        cold_members: Optional[Sequence] = None,
        cold_member_ids: Optional[Sequence[str]] = None,
        tier_policy=None,
        tiering_interval_s: float = 1.0,
        device="cuda",
    ):
        """``member_factory(conn) -> KVConnector-shaped``: what each member
        runs over its connection — defaults to a plain ``KVConnector`` on
        ``device`` (default ``"cuda"``, which raises without a card); pass
        e.g. ``lambda c: QuantizedKVConnector(c, spec, model_id, max_blocks)``
        for an int8 pool (routing composes with any member that has
        lookup/load/save/drop).

        ``replicas``: rendezvous replication factor. 1 (default) = the HRW
        owner alone, today's behavior. 2 = saves mirror to owner + HRW
        runner-up and reads fail over to the replica when the owner's
        breaker is open or its op errors (docs/robustness.md).

        ``breaker_factory(member_index) -> CircuitBreaker``: per-member
        breaker construction (tunables, injected clocks in tests). The
        default seeds each member's jitter differently so probes
        decorrelate.

        ``journal_path``: enable the CRASH-SAFE durable catalog + reshard
        journal (docs/membership.md, durability section). The root
        catalog, membership view and reshard plan/progress are journaled
        to a write-ahead ``DurableLog`` at this path; on construction an
        existing journal is REPLAYED — the restarted client recovers its
        catalog (holder block-levels intact), the epoch-stamped view
        (tombstones intact), and any in-flight reshard, which it resumes
        from the journaled debt instead of replanning from zero. Members
        recorded in the journal but absent from ``conns`` are re-dialed
        via ``dial_factory``.

        ``dial_factory(member_id, connect=True) -> connection``: how the
        cluster dials a member it learned about from the journal, a
        gossip merge, or a bootstrap snapshot. The default parses
        ``host:port`` from the member id and builds an auto-reconnecting
        ``InfinityConnection`` (connect is best-effort — a down member
        materializes later through its breaker's probe heal).

        ``fsync_interval_s``: the journal's bounded-fsync interval.

        ``cold_members``: connections to capacity-only POOL members (the
        tiered capacity plane, docs/tiering.md). Cold members are a ROLE,
        not different software: they never join rendezvous placement,
        never take foreground writes and never count toward ``replicas``
        — they hold demoted copies shipped by the background
        :class:`~.tiering.TierManager` (``self.tiering``), and reads fall
        through to them when every serving tier misses. Each sits behind
        its own circuit breaker. ``cold_member_ids`` names them
        (``host:port`` default); ``tier_policy`` injects a custom
        :class:`~.tiering.TierPolicy`; ``tiering_interval_s`` paces the
        reconciler."""
        if not conns:
            raise ValueError("cluster needs at least one connection")
        if member_ids is None:
            # host:port is stable across restarts and list reordering; an
            # operator can pass explicit ids when addresses are ephemeral.
            member_ids = [
                f"{c.config.host_addr}:{c.config.service_port}" for c in conns
            ]
        if len(member_ids) != len(conns):
            raise ValueError(
                f"{len(member_ids)} member_ids for {len(conns)} connections"
            )
        if len(set(member_ids)) != len(member_ids):
            raise ValueError(f"member_ids must be unique, got {member_ids}")
        if not 1 <= replicas <= len(conns):
            raise ValueError(
                f"replicas={replicas} outside 1..{len(conns)} members"
            )
        self.member_ids = list(member_ids)
        if member_factory is None:
            member_factory = lambda c: KVConnector(
                c, spec, model_id, max_blocks, device=device
            )
        if breaker_factory is None:
            breaker_factory = lambda i: CircuitBreaker(seed=i)
        self.members = [member_factory(c) for c in conns]
        self.spec = spec
        self.model_id = model_id
        self.max_blocks = max_blocks
        self.degrade = degrade
        self.replicas = replicas
        self.degraded_ops = 0  # aggregate (back-compat; per-member in stats())
        self._health = [
            _MemberHealth(breaker=breaker_factory(i)) for i in range(len(conns))
        ]
        # Cluster-level QoS ledger (docs/qos.md): reads / fetches are
        # FOREGROUND, saves (and their replica mirrors) and drops are
        # BACKGROUND by construction. Surfaced in health().
        self._qos = {"fg_ops": 0, "bg_ops": 0, "mirror_writes": 0}
        # Elastic membership (docs/membership.md): the versioned view every
        # op routes through, the background delta-resharder, and the root
        # catalog it reconciles (root -> tokens/blocks/holders).
        self._member_factory = member_factory
        self._breaker_factory = breaker_factory
        self.membership = Membership(self.member_ids)
        self.resharder = Resharder(self)
        # its: guard[_catalog: _cat_lock]
        self._catalog: Dict[str, _RootRecord] = {}
        self._cat_lock = threading.Lock()
        # Serializes membership transitions (add/remove/mark_dead): the
        # member-array append + view publish must be atomic against OTHER
        # transitions (a rejected add's rollback must never delete a
        # concurrently admitted member's entries). Ops never take this.
        # The member arrays follow the published-snapshot discipline: every
        # writer holds the admin lock (construction-time restores aside);
        # readers resolve indices through the immutable view, lock-free.
        # its: guard[members, member_ids, _health: _admin_lock!w]
        self._admin_lock = threading.Lock()
        # Serializes breaker admission/outcome across threads: CircuitBreaker
        # itself is not thread-safe, and with the resharder worker feeding
        # the same breakers as the caller's loop, an unserialized allow()
        # race could admit TWO half-open probes (two concurrent reconnects
        # on one native connection). Held only for the O(1) state update —
        # never across a heal/reconnect.
        self._breaker_lock = threading.Lock()
        # Crash-safe coordination plane (docs/membership.md): the durable
        # catalog + reshard journal, connections this cluster dialed itself
        # (journal restore / gossip merge / bootstrap — closed with us),
        # and the replay summary (None when no journal or a fresh one).
        self._dial_factory = dial_factory or self._default_dial
        # its: guard[_owned_dials: _admin_lock]
        self._owned_dials: List = []
        self._journal_log: Optional[DurableLog] = None
        self.recovered: Optional[dict] = None
        self.membership.on_change = self._on_view_change
        if journal_path:
            self._journal_log = DurableLog(
                journal_path, fsync_interval_s=fsync_interval_s
            )
            self._replay_journal()
        # Tiered capacity plane (docs/tiering.md): capacity-only cold
        # members OUTSIDE placement, with their own breaker/health arrays
        # (indices never mix with the membership-aligned serving arrays),
        # plus the temperature-driven TierManager reconciler.
        if cold_members is None:
            cold_members = []
        if cold_member_ids is None:
            cold_member_ids = [
                f"{c.config.host_addr}:{c.config.service_port}"
                for c in cold_members
            ]
        if len(cold_member_ids) != len(cold_members):
            raise ValueError(
                f"{len(cold_member_ids)} cold_member_ids for "
                f"{len(cold_members)} cold connections"
            )
        overlap = set(cold_member_ids) & set(self.member_ids)
        if overlap or len(set(cold_member_ids)) != len(cold_member_ids):
            raise ValueError(
                f"cold_member_ids must be unique and disjoint from serving "
                f"members (overlap: {sorted(overlap)})"
            )
        self.cold_ids: List[str] = list(cold_member_ids)
        self.cold_members = [member_factory(c) for c in cold_members]
        self.cold_index: Dict[str, int] = {
            mid: j for j, mid in enumerate(self.cold_ids)
        }
        self._cold_health = [
            _MemberHealth(breaker=breaker_factory(1000 + j))
            for j in range(len(self.cold_ids))
        ]
        self.tiering = None
        if self.cold_ids:
            from .tiering import TierManager

            self.tiering = TierManager(
                self, policy=tier_policy,
                interval_s=tiering_interval_s or 1.0,
            )
            if tiering_interval_s > 0:
                # Production default: the periodic demotion/promotion
                # worker runs from construction. tiering_interval_s=0
                # keeps it manual — tests/bench drive run_pass()
                # deterministically.
                self.tiering.start()

    # -- routing -------------------------------------------------------------

    def _root_of(self, token_ids) -> Optional[str]:
        """This prompt's chain root (None when it has no complete block)."""
        chains = token_chain_hashes(token_ids, self.spec.block_tokens)
        return chains[0] if chains else None

    def _ranked_ids(self, ids: Sequence[str], root: str) -> List[str]:
        """``ids`` in HRW rank order for ``root`` (empty for empty ids)."""
        if not ids:
            return []
        return [ids[i] for i in rendezvous_ranked(ids, root)]

    def member_index(self, member_id: str) -> int:
        """Stable entry index of ``member_id`` (KeyError when unknown)."""
        return self.membership.index_of(member_id)

    def owner_index(self, token_ids: Sequence[int]) -> Optional[int]:
        """Which member owns this prompt's prefix tree under the CURRENT
        view's placement (None when the prompt has no complete block)."""
        root = self._root_of(token_ids)
        if root is None:
            return None
        place = self.membership.view().placement_ids()
        ranked = self._ranked_ids(place, root)
        return self.member_index(ranked[0]) if ranked else None

    def write_indices(self, token_ids) -> List[int]:
        """The ``replicas`` member indices NEW writes target, HRW rank
        order over the current view's placement (JOINING + ACTIVE) —
        ``[owner, successor, ...]``; empty when the prompt has no complete
        block."""
        root = self._root_of(token_ids)
        if root is None:
            return []
        place = self.membership.view().placement_ids()
        return [
            self.member_index(m)
            for m in self._ranked_ids(place, root)[: self.replicas]
        ]

    def replica_indices(self, token_ids) -> List[int]:
        """The member indices a READ may be served from, in try order:
        the current placement's ``[owner, successor, ...]`` first, then —
        while a reshard is in flight — the epoch-aware fallbacks (the
        root's known holders, or the previous placement's owners), so a
        read mid-migration finds the copy wherever it still lives
        (docs/membership.md). With settled membership this is exactly the
        placement ranking (the pre-elastic behavior)."""
        root = self._root_of(token_ids)
        if root is None:
            return []
        return self._read_candidates(root)[0]

    def _read_candidates(self, root: str):
        """(candidate indices, failover_active) for one root. Failover is
        active while the membership view has a pending transition or the
        resharder still carries debt; then reads fall THROUGH misses to
        the old owner / surviving holders instead of stopping at the new
        owner's (not-yet-migrated) miss."""
        view = self.membership.view()
        place = view.placement_ids()
        ids = self._ranked_ids(place, root)[: self.replicas]
        failover = (not self.membership.settled) or self.resharder.active
        if failover:
            # Audited: O(1) dict read under a lock whose other holders
            # (catalog record / resharder callbacks) are O(1) too — the
            # only O(n_roots) holder is reshard_plan, on the worker thread.
            with self._cat_lock:  # its: allow[ITS-L003]
                rec = self._catalog.get(root)
                holders = set(rec.holders) if rec is not None else None
            if holders is not None:
                # Exact knowledge: the catalog says who holds a copy.
                readable = view.readable_ids()
                extras = [
                    m for m in self._ranked_ids(readable, root)
                    if m in holders and m not in ids
                ]
            else:
                # Root unknown to the catalog (another client's write):
                # fall back to the previous placement's owners.
                prev = self.membership.prev_placement or ()
                readable = set(view.readable_ids())
                extras = [
                    m for m in self._ranked_ids(list(prev), root)[: self.replicas]
                    if m in readable and m not in ids
                ]
            ids = ids + extras
        return [self.member_index(m) for m in ids], failover

    # -- tiered capacity plane (docs/tiering.md) -------------------------------

    def cold_owner(self, root: str) -> Optional[str]:
        """The rendezvous-chosen cold member for ``root`` (None without a
        cold pool). Cold placement is independent of serving placement —
        the same HRW stability argument applies: draining one cold member
        remaps only the cold copies it held."""
        if not self.cold_ids:
            return None
        return self.cold_ids[rendezvous_owner(self.cold_ids, root)]

    def placement_for_root(self, root: str) -> List[str]:
        """The ``replicas`` serving member ids for ``root`` under the
        CURRENT view (HRW rank order) — the promotion targets."""
        place = self.membership.view().placement_ids()
        return self._ranked_ids(place, root)[: self.replicas]

    def catalog_get(self, root: str) -> Optional[_RootRecord]:
        """Snapshot one catalog record (tokens/blocks/holders copied)."""
        # Audited: O(1) dict read + one record's holder-dict copy — the
        # same lock discipline as _read_candidates (no O(n_roots) holder
        # ever runs on an event loop).
        with self._cat_lock:  # its: allow[ITS-L003]
            rec = self._catalog.get(root)
            if rec is None:
                return None
            return _RootRecord(
                tokens=rec.tokens, blocks=rec.blocks, holders=dict(rec.holders)
            )

    def tier_member(self, member_id: str, cold: bool = False):
        """Resolve a member connector by id on either plane (None when
        unknown)."""
        if cold:
            j = self.cold_index.get(member_id)
            return self.cold_members[j] if j is not None else None
        try:
            return self.members[self.member_index(member_id)]
        except KeyError:
            return None

    def tier_begin(self, member_id: str, cold: bool = False) -> bool:
        """Breaker admission by member id for the tier manager's copies:
        True when the op may proceed. Serving-plane ids route through the
        ordinary :meth:`_begin`; cold-plane ids through the cold health
        array (same breaker discipline, same lock)."""
        if not cold:
            try:
                i = self.member_index(member_id)
            except KeyError:
                return False
            return self._begin(i) is not None
        j = self.cold_index.get(member_id)
        if j is None:
            return False
        return self._cold_begin(j) is not None

    def tier_done(self, member_id: str, exc: Optional[BaseException],
                  cold: bool = False):
        """Record a tier-copy outcome against the right plane's breaker."""
        if not cold:
            try:
                i = self.member_index(member_id)
            except KeyError:
                return
            self._done(i, exc)
            return
        j = self.cold_index.get(member_id)
        if j is not None:
            self._cold_done(j, exc)

    def _cold_begin(self, j: int) -> Optional[bool]:
        """:meth:`_begin` for the cold plane: same breaker/lock
        discipline, but a denied cold op does NOT feed the availability
        SLI — the cold pool is capacity, not the serving path (a down
        cold member delays demotion, it does not fail a user read; cold
        READ health is covered by the ``cold_latency`` objective and the
        tier counters)."""
        h = self._cold_health[j]
        # Audited: O(1) breaker state update (see _breaker_lock).
        with self._breaker_lock:  # its: allow[ITS-L003]
            if not h.breaker.allow():
                h.fast_fails += 1
                return None
            probe = h.breaker.state == CircuitBreaker.HALF_OPEN
            if probe:
                h.probes += 1
        if probe:
            telemetry.emit(
                "breaker_half_open", member=self.cold_ids[j],
                epoch=self.membership.view().epoch,
            )
            conn = getattr(self.cold_members[j], "conn", None)
            try:
                if conn is not None and not getattr(conn, "is_connected", True):
                    # Worker-thread / sync-read-path callers only; the
                    # reconnect is the probe's heal, as in _probe_heal.
                    conn.reconnect()  # its: allow[ITS-L001]
            # Audited: a failed heal just lets the probe op fail and feed
            # this member's breaker via _cold_done.
            except (InfiniStoreException, AttributeError):  # its: allow[ITS-P001]
                pass
        return probe

    def _cold_done(self, j: int, exc: Optional[BaseException]):
        h = self._cold_health[j]
        opened = recovered = False
        # Audited: O(1) breaker state update (see _breaker_lock).
        with self._breaker_lock:  # its: allow[ITS-L003]
            transport = exc is not None and _is_transport(exc)
            fails = 0
            if transport:
                h.errors += 1
                h.last_error = repr(exc)
                prev = h.breaker.state
                h.breaker.record_failure()
                fails = h.breaker.consecutive_failures
                opened = (
                    prev != CircuitBreaker.OPEN
                    and h.breaker.state == CircuitBreaker.OPEN
                )
            else:
                if h.breaker.record_success():
                    h.recoveries += 1
                    recovered = True
        if opened:
            telemetry.emit(
                "breaker_open", member=self.cold_ids[j],
                epoch=self.membership.view().epoch,
                error=repr(exc)[:200], consecutive_failures=fails,
            )
        elif recovered:
            telemetry.emit(
                "breaker_closed", member=self.cold_ids[j],
                epoch=self.membership.view().epoch,
            )

    def _cold_candidates(self, root: str) -> List[str]:
        """Cold member ids provably holding ``root`` (catalog levels > 0),
        HRW rank order."""
        if not self.cold_ids:
            return []
        rec = self.catalog_get(root)
        if rec is None:
            return []
        holders = [
            m for m, lv in rec.holders.items()
            if lv > 0 and m in self.cold_index
        ]
        return self._ranked_ids(holders, root)

    def tier_location(self, token_ids) -> Optional[str]:
        """Which tier serves this prompt's root right now: ``"hot"`` when
        a readable SERVING member provably holds it (or the root is
        unknown — optimism keeps the staged path the default),
        ``"cold"`` when only the capacity pool does, ``None`` when the
        catalog knows the root but no readable copy exists anywhere. The
        engine's admission path consults this to pick staged vs direct
        reads (docs/tiering.md): a cold-only root skips the speculative
        staged prefetch — reserving staging for a slow cold read would
        hold the arena hostage — and rides the one-phase direct load."""
        root = self._root_of(token_ids)
        if root is None:
            return None
        return self._tier_location_root(root)

    def _tier_location_root(self, root: str) -> Optional[str]:
        """:meth:`tier_location` for callers that already hashed the
        chain (start_fetch computes the root once for routing anyway)."""
        rec = self.catalog_get(root)
        if rec is None:
            return "hot"
        readable = set(self.membership.view().readable_ids())
        if any(m in readable and lv > 0 for m, lv in rec.holders.items()):
            return "hot"
        if any(m in self.cold_index and lv > 0
               for m, lv in rec.holders.items()):
            return "cold"
        return None

    def _cold_lookup(self, root: str, token_ids) -> int:
        """Fall-through prefix probe against the cold pool (the serving
        tiers all missed). Returns the best cold hit (0 when none)."""
        for mid in self._cold_candidates(root):
            j = self.cold_index[mid]
            if self._cold_begin(j) is None:
                continue
            try:
                hit = self.cold_members[j].lookup(token_ids)
            except InfiniStoreException as e:
                self._cold_done(j, e)
                continue
            except BaseException:
                self._cold_done(j, None)  # never wedge a probe
                raise
            self._cold_done(j, None)
            if hit > 0:
                if self.tiering is not None:
                    self.tiering.note_cold_hit(root)
                return hit
        return 0

    async def _cold_load(self, root: str, token_ids, caches, block_ids,
                         first_block: int, on_layer):
        """Fall-through DIRECT read from the cold pool: no staged
        prefetch, no placement hop — the cold member's own load streams
        straight into the engine's cache (DAK's direct-access read,
        docs/tiering.md). Measures the cold-read latency into the
        ``cold_latency`` SLO objective and queues promotion-on-hit."""
        for mid in self._cold_candidates(root):
            j = self.cold_index[mid]
            # The probe's connection heal blocks up to the connect
            # timeout: keep it off this event loop (the _begin_async
            # discipline).
            if await asyncio.to_thread(self._cold_begin, j) is None:
                continue
            t0 = time.perf_counter()
            try:
                res = await self.cold_members[j].load(
                    token_ids, caches, block_ids, first_block=first_block,
                    on_layer=on_layer,
                )
            except PartialReadError as e:
                # Same contract as the serving path: the caches list in
                # the error is the one to use, its leading layers already
                # scattered — no retry over a half-written cache.
                self._cold_done(j, e)
                self._degrade([], e)
                return e.caches, 0
            except InfiniStoreException as e:
                self._cold_done(j, e)
                continue
            except BaseException:
                self._cold_done(j, None)  # never wedge a probe
                raise
            self._cold_done(j, None)
            if res[1] > 0:
                if self.tiering is not None:
                    self.tiering.note_cold_hit(
                        root, read_us=(time.perf_counter() - t0) * 1e6
                    )
                telemetry.slo_engine().record("miss_rate", good=1)
                return res
            caches = res[0]
        return None

    # -- elastic membership ----------------------------------------------------

    def add_member(
        self, conn, member_id: Optional[str] = None, wait: bool = False,
        timeout: float = 30.0,
    ):
        """Admit a new member at runtime: it JOINs the placement (new
        writes rendezvous over it immediately) and the resharder copies
        its ~1/(N+1) rendezvous share of existing roots in the background,
        after which it finalizes to ACTIVE. ``conn`` is a connected
        ``InfinityConnection``-shaped object; the member's connector comes
        from the cluster's ``member_factory``. Returns the new
        epoch-stamped view. ``wait=True`` blocks until the reshard drains
        (tests/operators; production callers watch ``/membership``)."""
        if member_id is None:
            member_id = f"{conn.config.host_addr}:{conn.config.service_port}"
        connector = self._member_factory(conn)
        with self._admin_lock:
            # A tombstoned id being REUSED must first be scrubbed from
            # every holder set: the catalog's lazy scrub keys on state,
            # and the fresh entry's JOINING state would otherwise make the
            # dead incarnation's stale holder knowledge look live again,
            # suppressing the re-replication its roots need. Runs off any
            # event loop (operator thread / manage-plane to_thread).
            reused = (
                self.membership.view().state_of(member_id)
                in MemberState.TERMINAL
            )
            if reused:
                with self._cat_lock:
                    for rec in self._catalog.values():
                        rec.holders.pop(member_id, None)
            # Entry arrays first, then the view transition: a concurrent
            # reader resolves indices through the view, which appears
            # last. A rejected transition (duplicate live id) rolls the
            # arrays back — safe under the admin lock, which keeps any
            # other transition from appending between the two steps.
            idx = len(self.members)
            self.members.append(connector)
            self.member_ids.append(member_id)
            self._health.append(
                _MemberHealth(breaker=self._breaker_factory(idx))
            )
            try:
                view = self.membership.add_member(member_id)
            except BaseException:
                del self.members[idx:]
                del self.member_ids[idx:]
                del self._health[idx:]
                raise
        self.resharder.kick()
        if wait:
            self.resharder.wait_idle(timeout)
        return view

    def remove_member(
        self, member_id: str, wait: bool = False, timeout: float = 30.0
    ):
        """Gracefully drain a member: it leaves placement (no new writes),
        stays readable while the resharder re-mirrors its roots from the
        surviving copies to their promoted successors, then finalizes to
        REMOVED. The caller still owns (and eventually closes) the
        member's connection. Returns the new view."""
        with self._admin_lock:
            view = self.membership.remove_member(member_id)
        self.resharder.kick()
        if wait:
            self.resharder.wait_idle(timeout)
        return view

    def mark_dead(
        self, member_id: str, wait: bool = False, timeout: float = 30.0
    ):
        """Write a crashed member off: out of placement AND unreadable —
        its copies are lost, and the resharder re-replicates every root it
        held from the surviving replica to the promoted successor (the
        dead id is scrubbed from catalog holders lazily, on the
        resharder's worker thread — this call stays O(1) so the manage
        plane may run it on its event loop). Returns the new view."""
        with self._admin_lock:
            view = self.membership.mark_dead(member_id)
        self.resharder.kick()
        if wait:
            self.resharder.wait_idle(timeout)
        return view

    def close(self):
        """Stop the background resharder, close the durable journal, close
        the member connectors the cluster built (their staging pools'
        page locks go before any connection closes), and close the
        connections this cluster dialed ITSELF (journal restore / gossip
        merge / bootstrap); caller-provided connections stay the caller's
        to close, after this call."""
        if self.tiering is not None:
            self.tiering.stop()
        self.resharder.stop()
        if self._journal_log is not None:
            self._journal_log.close()
        with self._admin_lock:
            members = list(self.members) + list(self.cold_members)
        for member in members:
            _close_member(member)
        # Under the admin lock: a gossip merge dialing new members must
        # never append into a list this teardown is clearing (ITS-R001
        # guard discipline on _owned_dials).
        with self._admin_lock:
            dials, self._owned_dials = self._owned_dials, []
        for conn in dials:
            try:
                conn.close()
            except Exception:
                pass

    # -- durable journal (crash-safe catalog + reshard state) ------------------

    @staticmethod
    def _default_dial(member_id: str, connect: bool = True):
        """Dial a member by its ``host:port`` id (the id convention the
        constructor defaults to). Connect is best-effort: a member that is
        down right now still gets a connection OBJECT — its breaker opens
        on first use and the half-open probe's ``reconnect()`` heals it
        when the store returns."""
        from .config import ClientConfig
        from .lib import InfinityConnection

        host, _, port = member_id.rpartition(":")
        conn = InfinityConnection(ClientConfig(
            host_addr=host or "127.0.0.1", service_port=int(port),
            log_level="error", auto_reconnect=True,
            connect_timeout_ms=1000, op_timeout_ms=5000,
        ))
        if connect:
            try:
                conn.connect()
            # Audited: best-effort dial of a journaled/gossiped member —
            # the member enters service behind its OPEN breaker and the
            # probe heal (_probe_heal -> reconnect) owns recovery; nothing
            # is swallowed policy-wise (every op outcome still routes
            # through _done).
            except InfiniStoreException:  # its: allow[ITS-P001]
                pass
        return conn

    def _dial_member(self, member_id: str, state: str):  # its: construction
        """A ``_LazyMember`` over a self-dialed connection (readable states
        get a connect attempt; tombstones just get the object).
        Construction-time only (journal restore), before any thread."""
        conn = self._dial_factory(member_id, state in MemberState.READABLE)
        self._owned_dials.append(conn)
        return _LazyMember(member_id, conn, self._member_factory)

    def _journal_append(self, record: dict, fsync: bool = False):
        log = self._journal_log
        if log is not None:
            log.append(record, fsync=fsync)

    def _on_view_change(self, view):
        """Membership ``on_change`` hook: journal every epoch change (the
        view record carries states, since-epochs, the fallback placement
        and transition ownership — everything ``restore`` needs). Replay
        keeps the record with the HIGHEST epoch, so two transitions
        journaling out of order can never roll the view back."""
        m = self.membership
        self._journal_append({
            "k": "view",
            "epoch": view.epoch,
            "members": [
                [mid, st, int(se)] for mid, st, se in zip(
                    view.member_ids, view.states,
                    view.since or (0,) * len(view.member_ids),
                )
            ],
            "prev": list(m.prev_placement) if m.prev_placement else None,
            "owner": m.owns_transition,
        }, fsync=True)

    def journal_reshard_event(self, kind: str, epoch: int, n_roots: int):
        """Resharder hook: journal a reshard ``plan`` (pass start; an open
        plan with no matching ``fin`` means a reshard was in flight at the
        crash) or ``fin`` (this process's copy debt drained)."""
        self._journal_append(
            {"k": kind, "epoch": int(epoch), "n": int(n_roots)}, fsync=True
        )

    def _journal_root(self, root: str, rec: "_RootRecord"):
        """Journal one catalog record (full upsert — replay is last-wins,
        so holder/level churn folds to the final state)."""
        if self._journal_log is None:
            return  # keep the journal-off save path free of the tolist()
        self._journal_append({
            "k": "root", "root": root, "tokens": rec.tokens.tolist(),
            "blocks": int(rec.blocks), "holders": dict(rec.holders),
        })

    def _snapshot_records(self) -> List[dict]:
        """The compaction snapshot: the current view + every catalog root
        (holder block-levels and membership tombstones intact)."""
        view = self.membership.view()
        out: List[dict] = []
        m = self.membership
        out.append({
            "k": "view", "epoch": view.epoch,
            "members": [
                [mid, st, int(se)] for mid, st, se in zip(
                    view.member_ids, view.states,
                    view.since or (0,) * len(view.member_ids),
                )
            ],
            "prev": list(m.prev_placement) if m.prev_placement else None,
            "owner": m.owns_transition,
        })
        with self._cat_lock:
            items = [
                (root, rec.tokens.tolist(), int(rec.blocks), dict(rec.holders))
                for root, rec in self._catalog.items()
            ]
        for root, tokens, blocks, holders in items:
            out.append({
                "k": "root", "root": root, "tokens": tokens,
                "blocks": blocks, "holders": holders,
            })
        return out

    def compact_journal(self):
        """Rewrite the journal as a snapshot (resharder finalize path and
        replay hygiene); errors are logged, never raised — a full disk
        must not wedge the reconciler."""
        log = self._journal_log
        if log is None:
            return
        try:
            # The snapshot runs under the LOG lock (callable form): an
            # append racing the compaction either lands before the
            # snapshot (and is reflected in it) or after the replace (and
            # survives in the new file) — never in a destroyed window.
            log.compact(self._snapshot_records)
        except OSError as e:
            Logger.error(f"journal compaction failed: {e!r}")

    def catalog_restore(self, records: Sequence[dict], journal: bool = False):
        """Install catalog root records (journal replay / bootstrap):
        each is ``{"root", "tokens", "blocks", "holders"}``. Holder levels
        install verbatim; the normal CATALOG_MAX_ROOTS bound applies.
        ``journal=True`` re-journals them (the bootstrap path — a cold
        client's journal must cover the snapshot it started from)."""
        for r in records:
            root = r["root"]
            tokens = np.asarray(r.get("tokens", ()), dtype=np.int64)
            blocks = int(r.get("blocks", 0))
            holders = {
                str(m): int(lv) for m, lv in (r.get("holders") or {}).items()
            }
            if not root or blocks <= 0:
                continue
            with self._cat_lock:
                while len(self._catalog) >= self.CATALOG_MAX_ROOTS:
                    self._catalog.pop(next(iter(self._catalog)))
                rec = self._catalog[root] = _RootRecord(
                    tokens=tokens, blocks=blocks, holders=holders
                )
            if journal:
                self._journal_root(root, rec)

    def _replay_journal(self):  # its: construction
        """Construction-time crash recovery: fold the journal's records
        (last-wins per key; ``drop`` tombstones keep dropped roots
        dropped), rebuild the member arrays in the journaled entry order
        (re-dialing members the constructor did not pass), install the
        view + catalog, rewrite the log compacted, and — when the crash
        interrupted a reshard (open plan record or unsettled view) — kick
        the resharder so migration RESUMES from the journaled debt."""
        log = self._journal_log
        records = log.replay()
        if not records:
            # Fresh journal: seed it with the initial view so even a
            # client that crashes before its first transition replays a
            # well-formed state.
            self._on_view_change(self.membership.view())
            return
        view_rec: Optional[dict] = None
        catalog: Dict[str, dict] = {}
        open_plan: Optional[dict] = None
        for r in records:
            k = r.get("k")
            if k == "view":
                if view_rec is None or r.get("epoch", 0) >= view_rec.get("epoch", 0):
                    view_rec = r
            elif k == "root":
                catalog[r["root"]] = r
            elif k == "hadd":
                rec = catalog.get(r.get("root"))
                if rec is not None:
                    h = rec.setdefault("holders", {})
                    h[r["m"]] = max(int(h.get(r["m"], 0)), int(r.get("lv", 0)))
            elif k == "hdem":
                rec = catalog.get(r.get("root"))
                if rec is not None and r.get("m") in rec.get("holders", {}):
                    rec["holders"][r["m"]] = 0
            elif k == "hdel":
                rec = catalog.get(r.get("root"))
                if rec is not None:
                    rec.get("holders", {}).pop(r.get("m"), None)
            elif k == "drop":
                catalog.pop(r.get("root"), None)
            elif k == "plan":
                open_plan = {"epoch": int(r.get("epoch", 0)),
                             "roots": int(r.get("n", 0))}
            elif k == "fin":
                if open_plan is not None and int(r.get("epoch", 0)) >= open_plan["epoch"]:
                    open_plan = None
        if view_rec is not None:
            self._restore_view(view_rec)
        self.catalog_restore(list(catalog.values()))
        # Hygiene: restart from a compacted file (also folds away any torn
        # tail / bad-checksum frames the replay skipped).
        self.compact_journal()
        view = self.membership.view()
        resume = (not self.membership.settled) or open_plan is not None
        self.recovered = {
            "epoch": view.epoch,
            "roots": len(catalog),
            "resume_reshard": bool(resume),
            "replay_records": log.replay_records,
            "replay_torn": log.replay_torn,
            "replay_bad_checksum": log.replay_bad_checksum,
        }
        telemetry.emit(
            "client_restart", epoch=view.epoch,
            recovered_roots=len(catalog), resume_reshard=bool(resume),
            replay_torn=log.replay_torn,
            replay_bad_checksum=log.replay_bad_checksum,
        )
        if resume:
            self.resharder.kick()

    def _restore_view(self, view_rec: dict):  # its: construction
        """Rebuild the member arrays in the JOURNALED entry order (indices
        are the identity the health/breaker arrays key on): constructor-
        provided connections slot in at their id's latest incarnation,
        journal-only members are re-dialed lazily, tombstones get inert
        placeholders, and constructor members unknown to the journal are
        appended ACTIVE (an operator growing the seed list across a
        restart)."""
        entries = [
            (str(mid), str(st), int(se))
            for mid, st, se in view_rec.get("members", [])
        ]
        if not entries:
            return
        given = {}  # member_id -> already-built member connector
        for mid, member in zip(self.member_ids, self.members):
            given[mid] = member
        latest = {}
        for j, (mid, _, _) in enumerate(entries):
            latest[mid] = j
        members, ids, health = [], [], []
        for j, (mid, state, since) in enumerate(entries):
            if mid in given and latest[mid] == j:
                member = given.pop(mid)
            else:
                member = self._dial_member(mid, state)
            members.append(member)
            ids.append(mid)
            health.append(_MemberHealth(breaker=self._breaker_factory(len(ids) - 1)))
        for mid, member in given.items():
            # Constructor conns the journal never saw: admit as ACTIVE.
            entries.append((mid, MemberState.ACTIVE, int(view_rec.get("epoch", 1))))
            members.append(member)
            ids.append(mid)
            health.append(_MemberHealth(breaker=self._breaker_factory(len(ids) - 1)))
        self.members = members
        self.member_ids = ids
        self._health = health
        self.membership.restore(
            entries, int(view_rec.get("epoch", 1)),
            prev_placement=view_rec.get("prev"),
            owner=bool(view_rec.get("owner", False)),
        )

    # -- gossip exchange (docs/membership.md, gossip section) ------------------

    def gossip_payload(self) -> dict:
        """The anti-entropy exchange body: the epoch-stamped view (every
        entry with its ``since_epoch`` incarnation stamp) plus the
        fallback placement, so a peer adopting an in-flight transition
        can serve epoch-aware read failover for roots it never saw."""
        view = self.membership.view()
        prev = self.membership.prev_placement
        return {
            "epoch": view.epoch,
            "members": view.as_dict()["members"],
            "prev_placement": list(prev) if prev else None,
            "settled": self.membership.settled,
        }

    def merge_remote_view(self, payload: dict) -> bool:
        """Merge a peer's gossiped view into ours (the tombstone-aware
        lattice — ``Membership.merge_apply``): per member id the newest
        incarnation wins, within one incarnation the more advanced state
        wins, and the epoch becomes ``max(local, remote)``. Member ids we
        have never seen are DIALED (``dial_factory``) and appended —
        array-aligned with their new entries — before the merged view
        publishes, so a read can route to a gossip-learned member the
        moment the epoch lands. Returns True when anything changed
        (journaled + resharder kicked). Runs off any event loop (the
        manage plane calls it via ``to_thread``) and serializes with
        every other membership transition under the admin lock."""
        remote_members = payload.get("members") or []
        remote_epoch = int(payload.get("epoch", 0))
        if not remote_members:
            raise ValueError("gossip payload has no members")
        for m in remote_members:
            if "member_id" not in m or "state" not in m:
                raise ValueError("malformed gossip member entry")
        with self._admin_lock:
            # Phase 1 (dry run, blocking I/O allowed): learn which ids are
            # brand new and dial them. Phase 2 appends the member/health
            # array slots INSIDE merge_apply's on_new callback, under the
            # membership lock — so even if a concurrent finalize (the
            # resharder thread takes no admin lock) changes the delta
            # between the two phases, entries and arrays stay aligned:
            # an entry that became new late gets an undialed placeholder
            # (healed later by its breaker probe), and a dialed conn whose
            # entry became in-place just stays in _owned_dials unused.
            planned = self.membership.merge_plan(remote_members)
            dialed = {}
            for mid, state, _since in planned:
                if mid not in dialed:
                    conn = self._dial_factory(
                        mid, state in MemberState.READABLE
                    )
                    self._owned_dials.append(conn)
                    dialed[mid] = conn

            def on_new(mid, state, _since):  # its: requires[ClusterKVConnector._admin_lock]
                conn = dialed.pop(mid, None)
                if conn is None:
                    # Construction only (connect=False): no I/O under the
                    # membership lock; the breaker's probe heal performs
                    # the real reconnect later.
                    try:
                        conn = self._dial_factory(mid, False)
                    except Exception:
                        conn = _DeadConn(mid)
                    self._owned_dials.append(conn)
                self.members.append(
                    _LazyMember(mid, conn, self._member_factory)
                )
                self.member_ids.append(mid)
                self._health.append(_MemberHealth(
                    breaker=self._breaker_factory(len(self.member_ids) - 1)
                ))

            changed, _view = self.membership.merge_apply(
                remote_members, remote_epoch,
                prev_placement=payload.get("prev_placement"),
                on_new=on_new,
            )
        if changed:
            self.resharder.kick()
        return changed

    # -- cold bootstrap (docs/membership.md, bootstrap section) ----------------

    def bootstrap_payload(self, limit: int = 4096) -> dict:
        """What a cold client needs from any live member: the gossip view
        payload plus a bounded catalog snapshot (root records with holder
        block-levels). Runs off-loop (the /bootstrap route wraps it in
        ``to_thread`` — the catalog walk is O(n_roots))."""
        with self._cat_lock:
            items = list(self._catalog.items())
        catalog = [
            {
                "root": root, "tokens": rec.tokens.tolist(),
                "blocks": int(rec.blocks), "holders": dict(rec.holders),
            }
            for root, rec in items[:max(0, limit)]
        ]
        return {
            **self.gossip_payload(),
            "catalog": catalog,
            "catalog_total": len(items),
        }

    @classmethod
    def bootstrap(
        cls, payload: dict, spec: PagedKVCacheSpec, model_id: str,
        max_blocks: int, dial_factory=None, **cluster_kw,
    ) -> "ClusterKVConnector":
        """Reconstruct a cluster client from a ``bootstrap_payload``
        snapshot (a fresh process with only a seed list: fetch
        ``GET /bootstrap`` from any live peer's manage plane — e.g. via
        ``tools.fleet.manage_json`` — and hand the body here). Dials every
        READABLE member of the snapshot view, installs the epoch-stamped
        view (tombstones intact) through the same merge lattice gossip
        uses, and imports the catalog so reads fail over and reshards
        plan exactly as they would have in the process that wrote it.
        Raises ``InfiniStoreException`` when no member of the snapshot
        can be dialed."""
        members = payload.get("members") or []
        if not members:
            raise ValueError("bootstrap payload has no members")
        dial = dial_factory or cls._default_dial
        conns, ids = [], []
        for m in members:
            if m.get("state") not in MemberState.READABLE:
                continue
            mid = m["member_id"]
            if mid in ids:
                continue
            conn = dial(mid, True)
            if getattr(conn, "is_connected", True):
                conns.append(conn)
                ids.append(mid)
            else:
                try:
                    conn.close()
                except Exception:
                    pass
        if not conns:
            raise InfiniStoreException(
                "bootstrap: no readable member of the snapshot is reachable"
            )
        cluster = cls(
            conns, spec, model_id, max_blocks, member_ids=ids,
            dial_factory=dial_factory, **cluster_kw,
        )
        cluster._owned_dials.extend(conns)
        cluster.merge_remote_view(payload)
        cluster.catalog_restore(
            payload.get("catalog") or [],
            journal=cluster._journal_log is not None,
        )
        if not cluster.membership.settled:
            cluster.resharder.kick()
        return cluster

    # -- catalog (the resharder's metadata plane) ------------------------------

    def _catalog_record(
        self, token_ids, blocks: int, served_ids: List[str],
        root: Optional[str] = None, first_block: int = 0,
    ):
        """Record a successful save: ``served_ids`` took blocks
        ``[first_block, blocks)`` of this prompt's root (``root`` may be
        passed by callers that already hashed the chain). A member's
        holder LEVEL only rises when the write is contiguous with what it
        already held — a tail landing on a member without the base leaves
        its level (and a root unknown to the catalog is not recorded from
        a tail-only save at all). Bounded: past ``CATALOG_MAX_ROOTS`` the
        oldest record is dropped (insertion order) — losing
        failover/migration KNOWLEDGE for a cold root, not data (its keys
        still read via placement ranking, like any root another client
        wrote)."""
        if blocks <= first_block or not served_ids:
            return
        if root is None:
            root = self._root_of(token_ids)
        if root is None:
            return
        chains_tokens = np.asarray(
            token_ids[: blocks * self.spec.block_tokens], dtype=np.int64
        )
        # Audited: O(1) dict upsert (the eviction loop pops at most a few
        # oldest entries); see _read_candidates on this lock's holder
        # discipline (no O(n) section ever runs on the event loop).
        with self._cat_lock:  # its: allow[ITS-L003]
            rec = self._catalog.get(root)
            if rec is None:
                if first_block > 0:
                    return  # tail with no recorded base: nothing provable
                while len(self._catalog) >= self.CATALOG_MAX_ROOTS:
                    self._catalog.pop(next(iter(self._catalog)))
                rec = self._catalog[root] = _RootRecord(
                    tokens=chains_tokens, blocks=blocks
                )
            for mid in served_ids:
                level = rec.holders.get(mid, 0)
                if level >= first_block:
                    rec.holders[mid] = max(level, blocks)
            top = max(rec.holders.values(), default=0)
            if top > rec.blocks:
                rec.tokens = chains_tokens
                rec.blocks = top
            snap = _RootRecord(
                tokens=rec.tokens, blocks=rec.blocks, holders=dict(rec.holders)
            )
        # Journal the upserted record OUTSIDE the catalog lock (bounded
        # buffered append; fsync stays interval-bounded off this path).
        self._journal_root(root, snap)

    def catalog_add_holder(
        self, root: str, member_id: str, blocks: int = 0
    ) -> bool:
        """Resharder callback: ``member_id`` now holds ``blocks`` complete
        blocks of ``root``. Returns False when the record is GONE — the
        root was dropped (or catalog-evicted) while the copy was in
        flight; the resharder then undoes the copy, so a concurrent
        ``drop`` can never resurrect a prompt on the new owner."""
        with self._cat_lock:
            rec = self._catalog.get(root)
            if rec is None:
                return False
            rec.holders[member_id] = max(rec.holders.get(member_id, 0), blocks)
        # Holder records double as journaled reshard PROGRESS: a replayed
        # plan only re-copies the roots whose targets still lack a copy.
        self._journal_append(
            {"k": "hadd", "root": root, "m": member_id, "lv": int(blocks)}
        )
        return True

    def catalog_remove_holder(self, root: str, member_id: str):
        """Resharder callback: ``member_id``'s copy of ``root`` was pruned."""
        with self._cat_lock:
            rec = self._catalog.get(root)
            if rec is not None:
                rec.holders.pop(member_id, None)
        self._journal_append({"k": "hdel", "root": root, "m": member_id})

    def catalog_demote_holder(self, root: str, member_id: str):
        """Resharder callback: ``member_id``'s copy of ``root`` proved
        incomplete (keys evicted under a migration read) — drop its level
        to 0. It stays a read-failover candidate (shorter prefixes still
        serve) but can no longer act as a migration source or justify a
        prune; if no complete holder remains the root simply stops being
        planned, which is the truth."""
        with self._cat_lock:
            rec = self._catalog.get(root)
            if rec is not None and member_id in rec.holders:
                rec.holders[member_id] = 0
        self._journal_append({"k": "hdem", "root": root, "m": member_id})

    def reshard_plan(self) -> List[_RootTask]:
        """The rendezvous delta at the CURRENT epoch: one task per catalog
        root whose placement copies are incomplete (a joiner missing its
        share, or a leaver/dead member's roots awaiting their promoted
        successor) OR whose prune debt is outstanding (a copy rendezvous
        no longer places, e.g. left over from a pass that aborted between
        copy and prune — retried until it drains, so a moved root never
        silently accretes copies). Roots with no readable holder left are
        written off — reads degrade to a miss (recompute), never wrong
        bytes. Runs on the resharder's worker thread; terminal members'
        ids are scrubbed from holder sets here, lazily, so no O(n_roots)
        sweep ever runs on an event loop."""
        view = self.membership.view()
        place = view.placement_ids()
        if not place:
            return []
        readable = view.readable_ids()
        readable_set = set(readable)
        tasks: List[_RootTask] = []
        with self._cat_lock:
            items = list(self._catalog.items())
        lost = []
        for root, rec in items:
            levels = dict(rec.holders)
            stale = {
                m for m in levels
                if m not in self.cold_index  # cold holders are not view state
                and (
                    view.state_of(m) in (MemberState.DEAD, MemberState.REMOVED)
                    or view.state_of(m) is None
                )
            }
            if stale:
                # Lazy scrub (mark_dead stays O(1)): a terminal member's
                # copies are gone with it. Journaled (hdel) so a replay
                # reproduces the scrubbed holder sets instead of
                # resurrecting dead members' entries.
                with self._cat_lock:
                    for m in stale:
                        rec.holders.pop(m, None)
                for m in stale:
                    levels.pop(m, None)
                    self._journal_append({"k": "hdel", "root": root, "m": m})
            live = {m: lv for m, lv in levels.items() if m in readable_set}
            if not live:
                if any(m in self.cold_index and lv > 0
                       for m, lv in levels.items()):
                    # Cold-only root (demoted — docs/tiering.md): not
                    # lost, just one tier down; the TierManager owns its
                    # movement, the resharder has nothing to replicate.
                    continue
                lost.append(root)
                continue
            lvl = max(live.values())
            if lvl <= 0:
                continue  # only holey/unknown copies left: nothing provable
            want = self._ranked_ids(place, root)[: self.replicas]
            missing = [m for m in want if levels.get(m, 0) < lvl]
            # Prune is safe only when every wanted member provably holds at
            # least as much as the copy being deleted; with copy targets in
            # this task, the resharder enforces that at runtime (prunes run
            # only after skip-free copies to level ``lvl``).
            want_floor = min((levels.get(w, 0) for w in want), default=0)
            prune = [
                m for m in sorted(set(levels) - set(want))
                if view.state_of(m) == MemberState.ACTIVE
                and (missing or want_floor >= levels[m])
            ]
            if not missing and not prune:
                continue
            sources = [
                m for m in self._ranked_ids(readable, root)
                if live.get(m, 0) >= lvl
            ]
            tasks.append(_RootTask(
                root=root, tokens=rec.tokens, blocks=lvl,
                sources=sources, targets=missing, prune=prune,
            ))
        if lost:
            discarded = 0
            with self._cat_lock:
                for root in lost:
                    rec = self._catalog.pop(root, None)
                    if rec is not None and set(rec.holders) & readable_set:
                        # Raced a concurrent holder update: keep it.
                        self._catalog[root] = rec
                    elif rec is not None:
                        discarded += 1
            self.resharder._c["reshard_lost_roots"] += discarded
        return tasks

    def membership_status(self) -> dict:
        """Flat membership + reshard + journal counter snapshot (the
        ``/membership`` manage endpoint and ``/metrics`` membership gauges
        serve this — keys enumerated in ``Membership.status``,
        ``Resharder.progress`` and ``DurableLog.status``; the journal_*
        keys read 0 when no durable journal is configured)."""
        log = self._journal_log
        journal = log.status() if log is not None else {
            "journal_records": 0, "journal_bytes": 0, "journal_fsyncs": 0,
            "journal_compactions": 0, "journal_replay_records": 0,
            "journal_replay_torn": 0, "journal_replay_bad_checksum": 0,
        }
        return {
            **self.membership.status(), **self.resharder.progress(), **journal,
        }

    # -- failure-domain plumbing ---------------------------------------------

    def _event_member(self, i: int) -> str:
        """Member id for journal events (index fallback when a stats index
        outruns the id list mid-transition)."""
        return (
            self.member_ids[i] if 0 <= i < len(self.member_ids) else str(i)
        )

    def _begin(self, i: int, heal: bool = True) -> Optional[bool]:
        """Admission through member ``i``'s breaker: None = denied (the op
        fast-fails locally without touching the member), else whether this
        call is the half-open probe. A probe first heals a dead connection
        (``reconnect``) so recovery covers the async data plane, whose ops
        have no auto-reconnect decorator. Async callers pass ``heal=False``
        and run :meth:`_probe_heal` in an executor themselves — the native
        reconnect blocks up to the connect timeout, and paying that ON the
        event loop would stall every other request exactly the way the
        breaker exists to prevent."""
        h = self._health[i]
        # Audited: O(1) breaker state update; the blocking heal runs
        # OUTSIDE the lock (see _breaker_lock).
        with self._breaker_lock:  # its: allow[ITS-L003]
            if not h.breaker.allow():
                h.fast_fails += 1
                denied = True
            else:
                denied = False
                probe = h.breaker.state == CircuitBreaker.HALF_OPEN
                if probe:
                    h.probes += 1
        if denied:
            # A fast-fail IS an availability event: the member could not
            # serve the op (the replica may still rescue the READ, but the
            # per-member SLI must see sustained unavailability — without
            # this, an OPEN breaker silences the burn-rate alert exactly
            # while the outage is ongoing).
            telemetry.slo_engine().record("availability", bad=1)
            return None
        if probe:
            # allow() is the only OPEN->HALF_OPEN transition and this call
            # won it under the lock: journal the probe admission.
            telemetry.emit(
                "breaker_half_open", member=self._event_member(i),
                epoch=self.membership.view().epoch,
            )
        if probe and heal:
            self._probe_heal(i)
        return probe

    async def _begin_async(self, i: int) -> Optional[bool]:
        """``_begin`` for coroutine paths: the probe's connection heal runs
        in an executor so the event loop keeps serving other requests."""
        probe = self._begin(i, heal=False)
        if probe:
            await asyncio.get_running_loop().run_in_executor(
                None, self._probe_heal, i
            )
        return probe

    def _probe_heal(self, i: int):
        """Best-effort reconnect of a dead member connection before its
        probe op runs; a failed reconnect just lets the probe op fail and
        re-open the breaker with doubled backoff."""
        conn = getattr(self.members[i], "conn", None)
        if conn is None:
            return
        try:
            if not getattr(conn, "is_connected", True):
                # Audited: the only async caller (_begin_async) runs this
                # whole method in an executor; sync callers may block.
                conn.reconnect()  # its: allow[ITS-L001]
        # Audited: a failed heal is not swallowed policy-wise — the probe
        # op that follows fails and feeds this member's breaker (_done).
        except (InfiniStoreException, AttributeError):  # its: allow[ITS-P001]
            pass

    def _done(self, i: int, exc: Optional[BaseException]):
        """Record an op outcome against member ``i``'s breaker/counters.
        Semantic errors (miss / pressure) count as SUCCESS for liveness —
        the member answered."""
        h = self._health[i]
        opened = recovered = False
        # Audited: O(1) breaker state update (see _breaker_lock).
        with self._breaker_lock:  # its: allow[ITS-L003]
            transport = exc is not None and _is_transport(exc)
            fails = 0
            if transport:
                h.errors += 1
                h.last_error = repr(exc)
                prev = h.breaker.state
                h.breaker.record_failure()
                fails = h.breaker.consecutive_failures
                opened = (
                    prev != CircuitBreaker.OPEN
                    and h.breaker.state == CircuitBreaker.OPEN
                )
            else:
                if h.breaker.record_success():
                    h.recoveries += 1
                    recovered = True
        # Fleet telemetry (docs/observability.md): every op outcome feeds
        # the availability SLI, and breaker EDGES land in the event journal
        # (emitted outside the breaker lock; the journal has its own) with
        # the active trace id, so "why was this op slow/failed" joins the
        # op's span tree to the member transition that caused it.
        telemetry.slo_engine().record(
            "availability", good=0 if transport else 1,
            bad=1 if transport else 0,
        )
        if opened:
            telemetry.emit(
                "breaker_open", member=self._event_member(i),
                epoch=self.membership.view().epoch,
                error=repr(exc)[:200], consecutive_failures=fails,
            )
        elif recovered:
            telemetry.emit(
                "breaker_closed", member=self._event_member(i),
                epoch=self.membership.view().epoch,
            )

    def _degrade(self, candidates: Sequence[int], exc: Optional[BaseException]):
        """The failure policy, in one place, applied when NO replica served
        an op: strict mode re-raises (or synthesizes a typed error when
        every breaker fast-failed); degrade mode counts it — aggregate and
        against the OWNER (the attributable counter) — and the caller
        returns its miss value."""
        if not self.degrade:
            if exc is not None:
                raise exc
            open_ids = [
                self.member_ids[i]
                for i in candidates
                if self._health[i].breaker.state != CircuitBreaker.CLOSED
            ]
            raise InfiniStoreException(
                f"no replica available (circuit open for {open_ids or candidates})"
            )
        self.degraded_ops += 1
        telemetry.slo_engine().record("miss_rate", bad=1)
        if candidates:
            self._health[candidates[0]].degraded_ops += 1

    def _read_failover(
        self, candidates: Sequence[int], call, miss_value, is_miss=None,
        record_miss: bool = True,
    ):
        """Sync read path: try each replica in HRW order under its breaker;
        first success wins. Only when EVERY candidate is open or errors does
        the failure policy apply.

        ``is_miss`` (epoch-aware failover, docs/membership.md): when given,
        a result it classifies as a MISS counts as liveness for the member
        but the read CONTINUES to the next candidate — mid-reshard the new
        owner legitimately misses keys that have not migrated yet, and the
        old owner / surviving holder behind it still serves them. A miss on
        every candidate returns ``miss_value`` (no degrade: every member
        answered)."""
        last: Optional[InfiniStoreException] = None
        answered = False
        # Trace: record the routing outcome (which replica rank actually
        # served) on the active span, so a cross-member failover is visible
        # in the op's trace instead of only in aggregate health counters.
        tspan = tracing.active_span()
        for rank, i in enumerate(candidates):
            if self._begin(i) is None:
                continue
            try:
                res = call(self.members[i])
            except InfiniStoreException as e:
                self._done(i, e)
                last = e
                continue
            except BaseException:
                # Non-store failures (StagingPoolExhausted backpressure,
                # cancellation, caller bugs) propagate — but the breaker
                # must still see an outcome, or a half-open probe escaping
                # this way would wedge the breaker HALF_OPEN and fast-fail
                # the member forever. They are not transport evidence, so
                # they count as liveness.
                self._done(i, None)
                raise
            self._done(i, None)
            if is_miss is not None and is_miss(res):
                answered = True
                continue
            if rank:
                self._health[i].replica_serves += 1
            if tspan is not None:
                tspan.annotate(cluster_member=i, cluster_rank=rank)
            telemetry.slo_engine().record("miss_rate", good=1)
            return res
        if answered:
            # Every reachable candidate answered "miss": a legal cache
            # miss under the contract, not an availability failure (but it
            # is a miss for the miss-rate SLI — unless the caller defers
            # the verdict to a tier fall-through, record_miss=False).
            if record_miss:
                telemetry.slo_engine().record("miss_rate", bad=1)
            return miss_value
        self._degrade(candidates, last)
        return miss_value

    # -- engine surface (KVConnector-shaped) ---------------------------------

    def lookup(self, token_ids: Sequence[int]) -> int:
        root = self._root_of(token_ids)
        if root is None:
            return 0
        candidates, failover = self._read_candidates(root)
        has_cold = bool(self._cold_candidates(root))
        hit = 0
        if candidates:
            self._qos["fg_ops"] += 1
            hit = self._read_failover(
                candidates, lambda m: m.lookup(token_ids), 0,
                # Mid-reshard, a 0-hit answer from the new owner falls
                # through to the old owner / surviving holder.
                is_miss=(lambda r: r == 0) if failover else None,
                # With a cold copy on record the miss verdict belongs to
                # the fall-through's outcome, not the serving tiers'.
                record_miss=not has_cold,
            )
        if hit > 0:
            if self.tiering is not None:
                self.tiering.note_ram_hit(root)
            return hit
        if not has_cold:
            if self.tiering is not None:
                self.tiering.note_miss(root)
            return 0
        # Tier fall-through (docs/tiering.md): the serving tiers missed —
        # a demoted root still answers from the cold pool.
        cold_hit = self._cold_lookup(root, token_ids)
        telemetry.slo_engine().record(
            "miss_rate", good=1 if cold_hit else 0, bad=0 if cold_hit else 1
        )
        if cold_hit == 0 and self.tiering is not None:
            self.tiering.note_miss(root)
        return cold_hit

    def start_fetch(
        self, token_ids, first_block: int = 0, limit_blocks=None, priority: int = 0
    ):
        """Two-phase admission over the pool: route the gate-free fetch to
        the prefix owner (same rendezvous as load), failing over to the
        replica when the owner is open/erroring — and, mid-reshard, falling
        through a 0-hit handle to the old owner / surviving holder (the
        skipped handle is discarded, staging accounting intact). Returns
        the serving member's prefetch handle, or None when nothing is
        fetchable / no replica is up under the degrade policy — callers
        then use the one-phase ``load``. StagingPoolExhausted propagates
        (backpressure, not failure).

        Tier consult (docs/tiering.md): a COLD-ONLY root returns None
        without probing — reserving a staged pipeline for a slow cold
        read would hold the arena hostage; the caller's one-phase
        ``load`` then serves the root DIRECTLY from the cold pool
        (counted in ``tier_direct_reads``)."""
        root = self._root_of(token_ids)
        if root is None:
            return None
        if (
            self.tiering is not None
            and self._tier_location_root(root) == "cold"
        ):
            self.tiering.note_direct_read()
            return None
        candidates, failover = self._read_candidates(root)
        if not candidates:
            return None
        self._qos["bg_ops" if priority else "fg_ops"] += 1

        def is_miss(handle) -> bool:
            if handle is None:
                return True
            if getattr(handle, "hit_blocks", 1) > 0:
                return False
            discard = getattr(handle, "discard", None)
            if discard is not None:
                d = discard()
                if asyncio.iscoroutine(d):
                    # LayerwisePrefetch.discard is async; start_fetch runs
                    # on a live event loop (its documented contract), so
                    # schedule the cancellation rather than dropping an
                    # un-awaited coroutine on the floor.
                    try:
                        asyncio.get_running_loop().create_task(d)
                    except RuntimeError:
                        d.close()  # no loop: nothing was reserved to free
            return True

        return self._read_failover(
            candidates,
            # Forward the tag only to members that advertise the kwarg
            # (wire.qos_kwargs convention: a pre-QoS member drops the tag,
            # never TypeErrors).
            lambda m: m.start_fetch(
                token_ids, first_block=first_block, limit_blocks=limit_blocks,
                **(
                    {"priority": priority}
                    if priority and getattr(m, "QOS_AWARE", False)
                    else {}
                ),
            ),
            None,
            is_miss=is_miss if failover else None,
        )

    async def load(
        self, token_ids, caches, block_ids: np.ndarray, first_block: int = 0,
        on_layer=None,
    ):
        """Routed load with tier fall-through (docs/tiering.md): the
        serving replicas first (epoch-aware, as ever); a clean 0-block
        answer from every serving tier then tries the cold pool DIRECTLY
        (no staging hop) before reporting the miss. The returned caches
        must always be used: a member's partial read hands back the list
        it scattered into (see ``_load_serving``)."""
        root = self._root_of(token_ids)
        if on_layer is not None:
            # Layer-progress dedupe across the serving and cold legs: a
            # serving read that partially scattered layers 0..k before a
            # semantic failure (swallowed inside KVConnector.load) already
            # fired on_layer for them; the cold retry re-scatters those
            # layers and must NOT fire their progress hook again — a
            # double fire double-decrements the vllm worker's per-layer
            # remaining counters and releases wait_for_layer_load early.
            fired: set = set()
            inner = on_layer

            def on_layer(layer, kv, _inner=inner, _fired=fired):
                if layer in _fired:
                    return
                _fired.add(layer)
                _inner(layer, kv)

        # Cold knowledge decided up front: when the pool can serve this
        # root, the serving legs defer the miss-rate verdict to the final
        # outcome (a cold-served read is a HIT for the SLI — recording the
        # serving tiers' intermediate miss would page on a 50% "miss rate"
        # for a workload served entirely from cold).
        has_cold = root is not None and bool(self._cold_candidates(root))
        caches, n = await self._load_serving(
            token_ids, caches, block_ids, first_block, on_layer,
            record_miss=not has_cold,
        )
        if n > 0:
            if self.tiering is not None and root is not None:
                self.tiering.note_ram_hit(root)
            return caches, n
        if has_cold:
            cold = await self._cold_load(
                root, token_ids, caches, block_ids, first_block, on_layer
            )
            if cold is not None:
                return cold
            telemetry.slo_engine().record("miss_rate", bad=1)
        if self.tiering is not None and root is not None:
            self.tiering.note_miss(root)
        return caches, 0

    async def _load_serving(
        self, token_ids, caches, block_ids: np.ndarray, first_block: int = 0,
        on_layer=None, record_miss: bool = True,
    ):
        root = self._root_of(token_ids)
        if root is None:
            return list(caches), 0
        candidates, failover = self._read_candidates(root)
        if not candidates:
            return list(caches), 0
        self._qos["fg_ops"] += 1
        last: Optional[InfiniStoreException] = None
        answered = False
        for rank, i in enumerate(candidates):
            if await self._begin_async(i) is None:
                continue
            try:
                res = await self.members[i].load(
                    token_ids, caches, block_ids, first_block=first_block,
                    on_layer=on_layer,
                )
            except PartialReadError as e:
                # The member died mid-read AFTER some layers' scatters
                # landed: K2 scatters in place, so e.caches holds the
                # caller's tensors with the layers before the failure
                # updated and the rest untouched. No replica retry over a
                # half-written cache; the list in the error is the one to
                # hand back. Policy applies directly.
                self._done(i, e)
                self._degrade(candidates, e)
                return e.caches, 0
            except InfiniStoreException as e:
                # Failed before any scatter (probe/fetch): caches are
                # intact — the replica may still serve the read whole.
                self._done(i, e)
                last = e
                continue
            except BaseException:
                self._done(i, None)  # see _read_failover: never wedge a probe
                raise
            self._done(i, None)
            tspan = tracing.active_span()
            if tspan is not None:
                tspan.annotate(cluster_member=i, cluster_rank=rank)
            if failover and res[1] == 0:
                # Epoch-aware failover: the old owner behind this
                # candidate may still hold the unmigrated copy. Rebind the
                # caches to the RETURNED list before retrying: a member
                # that swallowed a partial read internally (semantic error
                # mid-scatter) hands back the list it scattered into (the
                # same tensors, updated in place up to the failed layer),
                # and the list a member returns is the one to use.
                caches = res[0]
                answered = True
                continue
            if rank:
                self._health[i].replica_serves += 1
            if res[1] or record_miss:
                telemetry.slo_engine().record(
                    "miss_rate", good=1 if res[1] else 0,
                    bad=0 if res[1] else 1,
                )
            return res
        if answered:
            if record_miss:
                telemetry.slo_engine().record("miss_rate", bad=1)
            return list(caches), 0
        self._degrade(candidates, last)
        return list(caches), 0

    async def save(
        self, token_ids, caches, block_ids: np.ndarray, first_block: int = 0
    ) -> int:
        """Save to EVERY responsible replica (R=2: owner + successor), so a
        later owner death degrades to replica reads instead of recompute.
        Returns the blocks written to the fullest successful copy. Strict
        mode treats under-replication (any replica skipped or failed) as an
        error AFTER attempting the rest — a mirror outage is visible, not
        silent; degrade mode counts it and keeps the surviving copy.

        Writes target the CURRENT view's placement (a JOINING member takes
        its rendezvous share immediately — no migration debt accrues for
        new data), and each successful copy is recorded in the root
        catalog the resharder reconciles (docs/membership.md)."""
        chains = token_chain_hashes(token_ids, self.spec.block_tokens)
        if not chains:
            return 0
        root = chains[0]
        if self.tiering is not None:
            # A save is a temperature touch: freshly written roots are hot
            # by definition and must not demote on the next idle scan.
            self.tiering.policy.on_access(root)
        place = self.membership.view().placement_ids()
        candidates = [
            self.member_index(m)
            for m in self._ranked_ids(place, root)[: self.replicas]
        ]
        if not candidates:
            return 0
        self._qos["bg_ops"] += 1
        tspan = tracing.active_span()
        if tspan is not None:
            tspan.annotate(cluster_replicas=list(candidates))
        written = 0
        served = 0
        served_ids: List[str] = []
        last: Optional[InfiniStoreException] = None
        for i in candidates:
            if await self._begin_async(i) is None:
                continue
            try:
                n = await self.members[i].save(
                    token_ids, caches, block_ids, first_block=first_block
                )
            except InfiniStoreException as e:
                self._done(i, e)
                last = e
                continue
            except BaseException:
                self._done(i, None)  # see _read_failover: never wedge a probe
                raise
            self._done(i, None)
            served += 1
            served_ids.append(self.member_ids[i])
            if served > 1:
                # A non-first successful copy is the replication mirror —
                # BACKGROUND traffic by construction (each member's
                # KVConnector.save already tags its puts).
                self._qos["mirror_writes"] += 1
            written = max(written, n)
        self._catalog_record(
            token_ids,
            min(len(chains), first_block + len(block_ids)),
            served_ids,
            root=root,
            first_block=first_block,
        )
        if served < len(candidates):
            if last is None and served:
                # Every failure was a local fast-fail, yet a copy WAS
                # written: strict mode still raises (under-replication must
                # be visible), but the error must say so — not claim the
                # save found no replica at all.
                last = InfiniStoreException(
                    f"under-replicated save: {served}/{len(candidates)} "
                    "replicas took the write (remaining members' circuits "
                    "open)"
                )
            self._degrade(candidates, last)
        return written

    def stage_layer_save(
        self, token_ids, layer: int, kv_pair, block_ids: np.ndarray,
        first_block: int = 0, priority: int = wire.PRIORITY_BACKGROUND,
    ):
        """Layer-granular save, routed: the whole request's blocks share a
        chain root, so every layer's put lands on the SAME serving member —
        routing composes with layer-by-layer streaming for free.

        Staging (device gather + D2H) happens ONCE, on the first healthy
        replica in HRW order — the layer-streaming path is latency-critical
        and does not mirror (each additional replica would pay a full
        device gather; use ``save`` for mirrored whole-request writes). The
        failure policy covers BOTH phases: a stage-time member error obeys
        degrade (returning the noop ship) instead of bypassing ``_absorb``
        and crashing the engine, and the returned ``ship`` applies the same
        policy to the network puts. The final layer's successful ship
        records the serving member in the root catalog, so a later reshard
        knows where the layer-streamed copy lives (and, with replicas=2,
        the resharder mirrors it to the successor in the background once a
        membership transition kicks a reconcile pass)."""
        candidates = self.write_indices(token_ids)
        if not candidates:
            return self._noop_ship()
        last: Optional[InfiniStoreException] = None
        for rank, i in enumerate(candidates):
            if self._begin(i) is None:
                continue
            try:
                ship = self.members[i].stage_layer_save(
                    token_ids, layer, kv_pair, block_ids,
                    first_block=first_block, priority=priority,
                )
            except InfiniStoreException as e:
                # The stage-time failure path (pool/register/gather against
                # a dead member) used to escape the failure policy entirely.
                self._done(i, e)
                last = e
                continue
            except BaseException:
                self._done(i, None)  # see _read_failover: never wedge a probe
                raise
            self._done(i, None)
            if rank:
                self._health[i].replica_serves += 1
            member_idx = i

            async def routed() -> int:
                try:
                    n = await ship()
                except InfiniStoreException as e:
                    self._done(member_idx, e)
                    self._degrade(candidates, e)
                    return 0
                self._done(member_idx, None)
                if n and layer == self.spec.num_layers - 1:
                    n_chains = len(
                        token_chain_hashes(token_ids, self.spec.block_tokens)
                    )
                    self._catalog_record(
                        token_ids,
                        min(n_chains, first_block + len(block_ids)),
                        [self.member_ids[member_idx]],
                        first_block=first_block,
                    )
                return n

            return routed
        self._degrade(candidates, last)
        return self._noop_ship()

    @staticmethod
    def _noop_ship():
        async def noop() -> int:
            return 0

        return noop

    def drop(self, token_ids) -> int:
        """Remove this prompt's blocks from every responsible replica —
        including, mid-reshard, every catalog holder (the old owner's
        not-yet-pruned copy must not resurrect a dropped prompt via read
        failover); returns the largest per-member deletion count (replicas
        hold the same keys). The catalog record is removed up front so the
        resharder can never re-mirror a dropped root; a copy behind an
        unreachable member (OPEN breaker) survives there until that node
        purges — the existing partial-drop policy surfaces it (strict mode
        raises, degrade counts), same as a down member pre-elasticity."""
        root = self._root_of(token_ids)
        if root is None:
            return 0
        place = self.membership.view().placement_ids()
        candidates = [
            self.member_index(m)
            for m in self._ranked_ids(place, root)[: self.replicas]
        ]
        read_cands, _ = self._read_candidates(root)
        candidates += [i for i in read_cands if i not in candidates]
        with self._cat_lock:
            rec = self._catalog.pop(root, None)
        if rec is not None:
            # The durable tombstone: replay must keep a dropped root
            # dropped (resurrecting it would serve a deleted prompt).
            self._journal_append({"k": "drop", "root": root}, fsync=True)
            view = self.membership.view()
            for mid in sorted(rec.holders):
                if view.state_of(mid) not in MemberState.READABLE:
                    continue
                try:
                    i = self.member_index(mid)
                except KeyError:
                    continue
                if i not in candidates:
                    candidates.append(i)
        if not candidates:
            return 0
        best = 0
        served = 0
        last: Optional[InfiniStoreException] = None
        for i in candidates:
            if self._begin(i) is None:
                continue
            try:
                n = self.members[i].drop(token_ids)
            except InfiniStoreException as e:
                self._done(i, e)
                last = e
                continue
            except BaseException:
                self._done(i, None)  # see _read_failover: never wedge a probe
                raise
            self._done(i, None)
            served += 1
            best = max(best, n)
        # Cold-plane sweep (docs/tiering.md): a demoted copy on a pool
        # member must not resurrect a dropped prompt through the tier
        # fall-through. A cold failure is a partial drop too — strict mode
        # raises, degrade mode counts — but it is attributed to the COLD
        # member's health row, never to a serving owner that succeeded
        # (and it feeds neither the serving availability SLI nor the
        # miss-rate SLI: capacity is not the serving path).
        cold_last: Optional[InfiniStoreException] = None
        if rec is not None:
            for mid in sorted(rec.holders):
                j = self.cold_index.get(mid)
                if j is None:
                    continue
                if self._cold_begin(j) is None:
                    cold_last = cold_last or InfiniStoreException(
                        f"cold member {mid} unreachable for drop"
                    )
                    self._cold_health[j].degraded_ops += 1
                    continue
                try:
                    best = max(best, self.cold_members[j].drop(token_ids))
                except InfiniStoreException as e:
                    self._cold_done(j, e)
                    cold_last = e
                    self._cold_health[j].degraded_ops += 1
                    continue
                except BaseException:
                    self._cold_done(j, None)  # never wedge a probe
                    raise
                self._cold_done(j, None)
        if served < len(candidates):
            self._degrade(candidates, last)
        elif cold_last is not None:
            if not self.degrade:
                raise cold_last
            self.degraded_ops += 1
        return best

    # -- observability -------------------------------------------------------

    def health(self) -> dict:
        """Cheap, network-free failure-domain snapshot: the aggregate
        degrade counter plus every member's breaker state and attributable
        counters. Each ``members`` entry carries ``member_id``,
        ``breaker_state`` / ``breaker_consecutive_failures`` /
        ``breaker_open_for_s`` / ``breaker_next_probe_in_s``, and the
        counters errors / fast_fails / probes / recoveries / degraded_ops
        / replica_serves / last_error — plus each member's membership
        ``state``, the epoch-stamped ``membership`` view, and the
        resharder's ``reshard`` progress counters (docs/membership.md).
        The engine harness surfaces this as ``store_health`` in its
        metrics."""
        view = self.membership.view()
        return {
            "degraded_ops": self.degraded_ops,
            "replicas": self.replicas,
            "degrade": self.degrade,
            "qos": dict(self._qos),
            "membership": view.as_dict(),
            "reshard": self.resharder.progress(),
            "members": [
                {"member_id": mid, "state": state, **h.as_dict()}
                for mid, state, h in zip(
                    self.member_ids, view.states, self._health
                )
            ],
            # Tiered capacity plane (docs/tiering.md): the tier_* counter
            # snapshot plus each cold member's breaker/health row ("cold"
            # is their fixed role, not a membership state).
            "tiering": (
                self.tiering.status() if self.tiering is not None else None
            ),
            "cold_members": [
                {"member_id": mid, "state": "cold", **h.as_dict()}
                for mid, h in zip(self.cold_ids, self._cold_health)
            ],
        }

    def stats(self) -> List[dict]:
        """Per-member connection stats with the member id and failure-domain
        health attached. A member with an OPEN breaker is reported
        ``{"unreachable": True}`` WITHOUT touching it (the breaker exists so
        a dead node costs no timeouts — including here); a closed member
        that fails the stat query is likewise reported unreachable (and the
        failure feeds its breaker). DEAD/REMOVED members are reported by
        ``state`` alone, never touched."""
        out = []
        view = self.membership.view()
        # zip truncates to the view: a member being added concurrently
        # (arrays grow before the view publishes) is skipped this call and
        # appears on the next — never an index off the end of the view.
        for i, (mid, m, state) in enumerate(
            zip(self.member_ids, self.members, view.states)
        ):
            h = self._health[i]
            if state not in MemberState.READABLE:
                s = {"unreachable": True}
            elif h.breaker.state == CircuitBreaker.OPEN:
                s = {"unreachable": True}
            else:
                # Members expose get_stats() themselves (KVConnector and the
                # quantized connector both do) — the cluster stays blind to
                # member internals; a member without it just reports its id.
                # The attribute fetch sits INSIDE the try: a _LazyMember
                # over a still-unconnected dial raises the typed transport
                # error from __getattr__ itself.
                try:
                    getter = getattr(m, "get_stats", None)
                    s = dict(getter()) if getter is not None else {}
                    self._done(i, None)
                except InfiniStoreException as e:
                    self._done(i, e)
                    s = {"unreachable": True}
            s["member_id"] = mid
            s["state"] = state
            s.update(h.as_dict())
            out.append(s)
        return out
