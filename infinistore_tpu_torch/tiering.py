"""Cluster-wide tiered capacity plane: HBM staging -> host RAM -> local

Copy of ``infinistore_tpu/tiering.py`` for the PyTorch port, which imports
nothing of ``infinistore_tpu``; keep the two in step.

spill -> pooled cold members (docs/tiering.md).

The store already has three IMPLICIT tiers: batched reads stage through
host RAM into HBM, the server's RAM pool holds the working set, and
eviction demotes LRU blocks into the mmap'd spill file (native
kvstore.cpp). What production serving needs — the source paper's scenario
(b), "extra-large KV-cache pool beyond HBM + local CPU cache" — is a
FOURTH tier and an explicit policy driving movement between all of them:
a KV working set for millions of users does not fit any one host's RAM +
spill, but a pool of capacity-only members (Beluga's CXL-pooled cold
tier, PAPERS.md) holds it at a latency an engine can still beat recompute
with, provided one-touch scans never pollute the hot tiers and reuse
promotes data back up the stack.

This module is that policy plane, client-side (the same altitude as the
resharder — the native server keeps owning RAM<->spill movement, which is
already LRU + pressure driven):

- :class:`TemperatureSketch` — a bounded open-addressed ghost-list sketch
  of per-root recency/reuse (no per-access allocation: fixed preallocated
  slot arrays, evict-coldest on probe-window overflow). Being evicted
  from the sketch is itself evidence of coldness — exactly the classic
  ghost-list argument.
- :class:`TierPolicy` — admission ("don't promote a one-touch scan"),
  demotion ("idle past ``demote_idle_s`` moves to the cold pool"), and
  promotion-on-hit decisions, all O(1) per access.
- :class:`TierManager` — the background reconciler: demotes idle roots
  from their serving members to a rendezvous-chosen COLD member (copies
  ride ``PRIORITY_BACKGROUND`` batched ops through the same breaker
  machinery the resharder uses), frees the serving copy once the cold
  copy is durable in the catalog, and promotes a policy-approved cold
  hit back to the current placement owner. Per-tier counters flow
  ``status()`` -> ``/metrics`` (``infinistore_tier_*``; ITS-C007 holds
  the vocabulary in lockstep) and cold-read latency feeds the SLO
  engine's ``cold_latency`` objective.

The cold members themselves are ordinary store servers; what makes them
"cold" is role, not software: :class:`~.cluster.ClusterKVConnector` keeps
them OUT of rendezvous placement (``cold_members=``), so they never take
foreground writes and never count toward replication — they are capacity,
reached only by demotion copies and the read fall-through when the
serving tiers miss. Cold reads are DIRECT: the engine's
``start_fetch_async`` path consults :meth:`ClusterKVConnector.tier_location`
and skips the staged prefetch for a cold-only root (DAK's direct-access
argument, PAPERS.md) — the one-phase load serves straight from the cold
member without reserving staging it would only hold hostage for a slow
read.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import telemetry
from .lib import (
    InfiniStoreException,
    InfiniStoreKeyNotFound,
    InfiniStoreResourcePressure,
    Logger,
)
from .wire import PRIORITY_BACKGROUND

# The tier vocabulary, top (fastest) to bottom (largest). "hbm" is the
# engine's paged cache + staging pipeline, "ram" the serving members' pools,
# "spill" their local mmap'd files, "cold" the pooled capacity-only members.
TIERS = ("hbm", "ram", "spill", "cold")

# Process-wide demotion-hit ledger: a present-but-unpromotable spilled key
# (the typed InfiniStoreColdTier, wire status 512) is a DEMOTION HIT — the
# data is alive one tier down, not missing and not out of memory. Counted
# here (module level, like telemetry's journal) because the signal
# originates in per-member connectors that may not belong to any cluster.
_demotion_hits_lock = threading.Lock()
_demotion_hits = 0


def note_demotion_hit(n: int = 1) -> None:
    """Count a read that found its key alive but demoted (spilled beyond
    the server's promotion budget — the 512 status): a tier event, not a
    miss. ``TierManager.status`` folds this into ``tier_demotion_hits``."""
    global _demotion_hits
    with _demotion_hits_lock:
        _demotion_hits += n


def demotion_hits() -> int:
    with _demotion_hits_lock:
        return _demotion_hits


def reset_demotion_hits() -> None:
    """Test/bench hook."""
    global _demotion_hits
    with _demotion_hits_lock:
        _demotion_hits = 0


def note_cold_read_us(us: float) -> None:
    """Feed one pooled-cold read latency to the SLO engine's
    ``cold_latency`` objective (docs/observability.md): bucketed to the
    next power-of-two microsecond bound (the /metrics histogram
    convention), CLAMPED to the objective's threshold for compliant
    reads — unlike the native-histogram feeds, the exact latency is in
    hand here, and letting a compliant 300ms read round up past the
    500ms threshold would burn error budget it never spent."""
    eng = telemetry.slo_engine()
    obj = eng.objectives.get("cold_latency")
    threshold = obj.latency_threshold_us if obj is not None else 0.0
    le = 1.0
    while le < us:
        le *= 2.0
    if threshold and us <= threshold < le:
        le = threshold
    eng.record_latency_bucket("cold_latency", le, 1)


class TemperatureSketch:
    """Bounded per-root recency/reuse sketch — the ghost list.

    Fixed arrays of ``capacity`` slots (rounded up to a power of two),
    open-addressed with a short linear probe window; a full window evicts
    its coldest slot (oldest last-touch). Touch and peek are O(window)
    with ZERO allocation — the arrays are preallocated and updates are
    item assignments, so a million-access workload costs no GC pressure.

    A slot records (signature, last-touch stamp, touch streak). The
    streak counts touches whose inter-arrival stayed under
    ``reuse_window_s`` — a bounded reuse-distance proxy: streak 1 means
    "first touch or returning after a long gap" (a scan), streak >= 2
    means provable short-distance reuse (a working-set member).
    """

    PROBE_WINDOW = 8

    def __init__(self, capacity: int = 4096, reuse_window_s: float = 30.0,
                 clock=time.monotonic):
        if capacity < self.PROBE_WINDOW:
            raise ValueError(f"capacity must be >= {self.PROBE_WINDOW}")
        cap = 1
        while cap < capacity:
            cap <<= 1
        self.capacity = cap
        self.reuse_window_s = reuse_window_s
        self._clock = clock
        self._mask = cap - 1
        # its: guard[_sig, _last, _streak: _lock]
        self._sig = [0] * cap    # 0 = empty
        self._last = [0.0] * cap
        self._streak = [0] * cap
        self._lock = threading.Lock()
        # its: guard[tracked, evictions: _lock!w]
        self.tracked = 0
        self.evictions = 0

    @staticmethod
    def _signature(root: str) -> int:
        # Stable within the process, never 0 (0 marks an empty slot).
        return (hash(root) & 0x7FFFFFFFFFFFFFFF) | 1

    def touch(self, root: str) -> Tuple[int, float]:
        """Record one access; returns ``(streak, age_s)`` where ``age_s``
        is the time since the PREVIOUS touch (``inf`` on a first touch or
        after a ghost eviction)."""
        sig = self._signature(root)
        now = self._clock()
        base = sig & self._mask
        with self._lock:
            victim = -1
            victim_last = float("inf")
            for d in range(self.PROBE_WINDOW):
                i = (base + d) & self._mask
                s = self._sig[i]
                if s == sig:
                    age = now - self._last[i]
                    if age <= self.reuse_window_s:
                        self._streak[i] += 1
                    else:
                        self._streak[i] = 1
                    self._last[i] = now
                    return self._streak[i], age
                if s == 0:
                    victim = i
                    victim_last = -1.0
                    break
                if self._last[i] < victim_last:
                    victim, victim_last = i, self._last[i]
            # New root: take the empty slot, or ghost-evict the window's
            # coldest occupant (counted — eviction pressure is a sizing
            # signal dashboards should see).
            if self._sig[victim] == 0:
                self.tracked += 1
            else:
                self.evictions += 1
            self._sig[victim] = sig
            self._last[victim] = now
            self._streak[victim] = 1
            return 1, float("inf")

    def peek(self, root: str) -> Optional[Tuple[int, float]]:
        """``(streak, idle_s since last touch)`` without mutating, or
        ``None`` when the root is not in the sketch (never touched, or
        ghost-evicted — either way: cold)."""
        sig = self._signature(root)
        now = self._clock()
        base = sig & self._mask
        with self._lock:
            for d in range(self.PROBE_WINDOW):
                i = (base + d) & self._mask
                if self._sig[i] == sig:
                    return self._streak[i], now - self._last[i]
                if self._sig[i] == 0:
                    return None
        return None


@dataclass
class TierPolicyConfig:
    """Tunables for :class:`TierPolicy` (docs/tiering.md, policy table)."""

    sketch_capacity: int = 4096    # temperature-sketch slots (bounded memory)
    reuse_window_s: float = 30.0   # touches within this count as reuse
    admit_min_streak: int = 2      # touches needed before a promote (anti-scan)
    demote_idle_s: float = 30.0    # roots idle this long demote to cold


class TierPolicy:
    """Admission / demotion / promotion decisions over the temperature
    sketch. Stateless beyond the sketch; every method is O(1).

    - :meth:`on_access` feeds the sketch (lookups, loads AND saves are
      touches — a freshly saved root is hot by definition).
    - :meth:`should_promote`: a COLD HIT is promoted back up only when its
      touch streak proves short-distance reuse — a one-touch scan reads
      from cold and stays cold (the Beluga admission argument: scans must
      not evict the working set).
    - :meth:`should_demote`: a root idle past ``demote_idle_s`` (or one
      the sketch ghost-evicted — older than everything still tracked) is
      a demotion candidate.
    """

    def __init__(self, config: Optional[TierPolicyConfig] = None,
                 clock=time.monotonic):
        self.config = config or TierPolicyConfig()
        self.sketch = TemperatureSketch(
            capacity=self.config.sketch_capacity,
            reuse_window_s=self.config.reuse_window_s,
            clock=clock,
        )

    def on_access(self, root: str) -> Tuple[int, float]:
        return self.sketch.touch(root)

    def should_promote(self, root: str) -> bool:
        got = self.sketch.peek(root)
        return got is not None and got[0] >= self.config.admit_min_streak

    def should_demote(self, root: str) -> bool:
        got = self.sketch.peek(root)
        if got is None:
            return True  # ghost-evicted or never touched: provably colder
        _, idle = got
        return idle >= self.config.demote_idle_s


class TierManager:
    """Background tier reconciler over a :class:`~.cluster.ClusterKVConnector`
    with cold members attached (docs/tiering.md).

    One worker thread (the resharder's shape): wakes on :meth:`kick` or
    every ``interval_s``, scans the cluster's root catalog for

    - DEMOTIONS: roots whose policy says idle, still held by serving
      members — copy to the rendezvous-chosen cold member (BACKGROUND
      batched ops through both sides' breakers), record the cold holder
      in the catalog, then delete the serving copies (that is what frees
      RAM — the cold holder record lands durably first, so a read racing
      the delete falls through to the cold copy, never to a miss);
    - PROMOTIONS: cold roots whose recent hit passed admission — copy
      back to the current placement owner(s); the cold copy stays (free
      re-demotion later; cold capacity is the cheap resource).

    Every pass is bounded (``max_moves_per_pass``) so one enormous cold
    sweep cannot monopolize the background class. Counters are the
    ``tier_*`` vocabulary :meth:`status` documents — exported as
    ``infinistore_tier_*`` by the manage plane and held in lockstep by
    ITS-C007 (tools/analysis/counters.py).
    """

    def __init__(self, cluster, policy: Optional[TierPolicy] = None,
                 interval_s: float = 1.0, max_batch_bytes: int = 2 << 20,
                 max_moves_per_pass: int = 64, clock=time.monotonic):
        self.cluster = cluster
        self.policy = policy or TierPolicy(clock=clock)
        self.interval_s = interval_s
        self.max_batch_bytes = max_batch_bytes
        self.max_moves_per_pass = max_moves_per_pass
        self._clock = clock
        self._cv = threading.Condition()
        self._dirty = False   # its: guard[_dirty: _cv]
        self._stop = False    # its: guard[_stop: _cv!w]
        self._thread: Optional[threading.Thread] = None
        # Promotion requests from the read path (root ids), deduped.
        # its: guard[_promote_queue, _promote_set: _cv]
        self._promote_queue: List[str] = []
        self._promote_set: set = set()
        # Counter/latency ledger lock (ITS-R001 confirmed race): the
        # tier_* counters are bumped from the reconciler thread AND the
        # read-path hooks (asyncio loop via _cold_load, scheduler threads
        # via lookup) — unguarded `_c[k] += 1` loses updates under the
        # forced interleaving in tests/test_interleave.py. Held for O(1)
        # item updates and the status() snapshot only.
        self._stats_lock = threading.Lock()
        # Bounded recent cold-read latencies for the p99 status gauge (the
        # authoritative windowed view lives in the SLO engine).
        # its: guard[_cold_lat_us: _stats_lock]
        self._cold_lat_us: List[float] = []
        # its: guard[_c: _stats_lock]
        self._c = {
            "tier_ram_hits": 0,
            "tier_cold_hits": 0,
            "tier_misses": 0,
            "tier_cold_reads": 0,
            "tier_demotions": 0,
            "tier_demoted_keys": 0,
            "tier_demoted_bytes": 0,
            "tier_demote_failures": 0,
            "tier_promotions": 0,
            "tier_promoted_keys": 0,
            "tier_promoted_bytes": 0,
            "tier_promote_failures": 0,
            "tier_admit_rejects": 0,
            "tier_direct_reads": 0,
            "tier_wrong_reads": 0,
            "tier_last_pass_ms": 0.0,
        }

    def _bump(self, key: str, n=1):
        """Serialized counter update: every ``tier_*`` mutation routes
        through the stats lock (reconciler thread and read-path hooks
        write concurrently; see ``_stats_lock``)."""
        with self._stats_lock:
            self._c[key] += n

    def _set_stat(self, key: str, value):
        with self._stats_lock:
            self._c[key] = value

    # -- lifecycle -----------------------------------------------------------

    def kick(self):
        """Wake the reconciler (read paths kick on cold hits; the periodic
        timer drives demotion scans). Starts the worker lazily."""
        with self._cv:
            self._dirty = True
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="its-tiering", daemon=True
                )
                self._thread.start()
            self._cv.notify_all()

    def start(self):
        """Start the periodic worker without waiting for a kick."""
        self.kick()

    def stop(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    def _run(self):
        while True:
            with self._cv:
                # Predicate-looped wait (ITS-R004): a spurious wake must
                # re-check dirty/stop, not charge into a pass; only a real
                # TIMEOUT (wait() returns False) breaks out for the
                # periodic demotion scan.
                while not self._dirty and not self._stop:
                    if not self._cv.wait(timeout=self.interval_s):
                        break
                if self._stop:
                    return
                self._dirty = False
            try:
                self.run_pass()
            except Exception as e:  # the reconciler thread must never die
                Logger.error(f"tiering pass failed: {e!r}")

    # -- read-path hooks (called by the cluster) -------------------------------

    def note_ram_hit(self, root: str):
        self._bump("tier_ram_hits")
        self.policy.on_access(root)

    def note_miss(self, root: Optional[str]):
        self._bump("tier_misses")
        if root is not None:
            self.policy.on_access(root)

    def note_direct_read(self):
        """The engine's admission path skipped the staged prefetch for a
        cold-only root and took the direct one-phase load
        (docs/tiering.md, the DAK argument)."""
        self._bump("tier_direct_reads")

    def note_cold_hit(self, root: str, read_us: Optional[float] = None):
        """A read was served from the cold pool: count it, feed the SLO
        engine's ``cold_latency`` objective, and — when the policy's
        admission test passes — queue a promotion back to the serving
        tier. One-touch scans are REJECTED (counted) and stay cold."""
        self._bump("tier_cold_hits")
        self.policy.on_access(root)
        if read_us is not None:
            note_cold_read_us(read_us)
            with self._stats_lock:
                self._c["tier_cold_reads"] += 1
                lat = self._cold_lat_us
                lat.append(float(read_us))
                if len(lat) > 512:
                    del lat[: len(lat) - 512]
        if self.policy.should_promote(root):
            # Queue + notify only: the worker runs when the owner started
            # it (ClusterKVConnector does by default; tests/bench pass
            # tiering_interval_s=0 and drive run_pass() deterministically).
            with self._cv:
                if root not in self._promote_set:
                    self._promote_set.add(root)
                    self._promote_queue.append(root)
                self._dirty = True
                self._cv.notify_all()
        else:
            self._bump("tier_admit_rejects")

    # -- one reconcile pass ----------------------------------------------------

    def run_pass(self) -> dict:
        """One bounded reconcile pass (the worker's body; tests call it
        directly for determinism). Promotions first — a waiting hot reader
        beats background space reclamation — then the demotion scan."""
        t0 = self._clock()
        promoted = demoted = 0
        with self._cv:
            batch = self._promote_queue[: self.max_moves_per_pass]
            self._promote_queue = self._promote_queue[len(batch):]
            for r in batch:
                self._promote_set.discard(r)
        for root in batch:
            if self._stop:
                break
            if self._promote_root(root):
                promoted += 1
        budget = self.max_moves_per_pass - len(batch)
        if budget > 0:
            # Roots promoted THIS pass are exempt from this pass's idle
            # scan — even a pathologically low demote_idle_s must not
            # undo a promotion in the same breath.
            demoted = self._demote_scan(budget, exempt=set(batch))
        self._set_stat("tier_last_pass_ms", round((self._clock() - t0) * 1e3, 3))
        return {"promoted": promoted, "demoted": demoted}

    def _catalog_items(self):
        """(root, tokens, blocks, holders-COPY) snapshots taken under the
        catalog lock: the live ``_RootRecord.holders`` dicts mutate under
        concurrent saves/reshards, and iterating them unlocked would die
        with 'dictionary changed size during iteration' mid-pass."""
        cluster = self.cluster
        with cluster._cat_lock:
            return [
                (root, rec.tokens, int(rec.blocks), dict(rec.holders))
                for root, rec in cluster._catalog.items()
            ]

    def _demote_scan(self, budget: int, exempt=()) -> int:
        """Find idle roots still resident on serving members and demote up
        to ``budget`` of them."""
        cluster = self.cluster
        if not cluster.cold_ids:
            return 0
        view = cluster.membership.view()
        readable = set(view.readable_ids())
        done = 0
        for root, tokens, _blocks, holders in self._catalog_items():
            if done >= budget or self._stop:
                break
            if root in exempt:
                continue
            serving = {
                m: lv for m, lv in holders.items()
                if m in readable and lv > 0
            }
            if not serving:
                continue  # already cold-only (or nothing provable)
            if not self.policy.should_demote(root):
                continue
            if self._demote_root(root, tokens, max(serving.values()),
                                 sorted(serving)):
                done += 1
        return done

    def _demote_root(self, root: str, tokens: np.ndarray, blocks: int,
                     serving_ids: List[str]) -> bool:
        """Ship one root serving -> cold, then free the serving copies.
        The cold holder record is journaled (via the catalog hooks) BEFORE
        any serving delete, so a crash or racing read always finds a
        provable copy."""
        cluster = self.cluster
        cold_id = cluster.cold_owner(root)
        if cold_id is None:
            return False
        src_id = None
        copied = None
        for mid in serving_ids:
            copied = self._copy_root(root, tokens, blocks, mid, cold_id,
                                     src_cold=False)
            if copied is not None:
                src_id = mid
                break
        if copied is None:
            self._bump("tier_demote_failures")
            return False
        keys_moved, bytes_moved, skipped = copied
        if skipped:
            # A holey cold copy must never justify deleting the complete
            # serving one (the resharder's prune-safety rule).
            cluster.catalog_add_holder(root, cold_id, 0)
            self._bump("tier_demote_failures")
            return False
        if not cluster.catalog_add_holder(root, cold_id, blocks):
            # The root was dropped while the copy was in flight: the cold
            # copy is the only stray — undo it, or the tier fall-through
            # would resurrect a dropped prompt (the resharder's rule).
            self._undo_copy(root, tokens, blocks, cold_id, cold=True)
            return False
        self._bump("tier_demotions")
        self._bump("tier_demoted_keys", keys_moved)
        self._bump("tier_demoted_bytes", bytes_moved)
        telemetry.emit(
            "tier_demotion", member=cold_id,
            epoch=cluster.membership.view().epoch,
            root=root[:16], keys=keys_moved, source=src_id,
        )
        # Free every serving copy (this is the capacity the tier exists to
        # reclaim). A failed delete stays a holder — space, not correctness.
        for mid in serving_ids:
            self._free_serving_copy(root, tokens, blocks, mid)
        return True

    def _undo_copy(self, root: str, tokens, blocks: int, mid: str,
                   cold: bool):
        """Best-effort delete of a copy that landed after its root was
        dropped (the catalog refused the holder record)."""
        cluster = self.cluster
        m = cluster.tier_member(mid, cold=cold)
        if m is None or not cluster.tier_begin(mid, cold=cold):
            return
        try:
            for _, keys in m.manifest(tokens, blocks):
                m.conn.delete_keys(keys)
        except InfiniStoreException as e:
            cluster.tier_done(mid, e, cold=cold)
            return
        except BaseException:
            cluster.tier_done(mid, None, cold=cold)
            raise
        cluster.tier_done(mid, None, cold=cold)

    def _free_serving_copy(self, root: str, tokens, blocks: int, mid: str):
        cluster = self.cluster
        try:
            i = cluster.member_index(mid)
        except KeyError:
            return
        if cluster._begin(i) is None:
            return
        try:
            groups = cluster.members[i].manifest(tokens, blocks)
            for _, keys in groups:
                cluster.members[i].conn.delete_keys(keys)
        except InfiniStoreException as e:
            cluster._done(i, e)
            return
        except BaseException:
            cluster._done(i, None)  # never wedge a probe
            raise
        cluster._done(i, None)
        cluster.catalog_remove_holder(root, mid)

    def _promote_root(self, root: str) -> bool:
        """Copy a cold root back to the current placement owner (the
        promotion-on-hit leg). The cold copy is kept — capacity is the
        cheap resource, and a later demotion of this root becomes a pure
        catalog update."""
        cluster = self.cluster
        rec = cluster.catalog_get(root)
        if rec is None:
            return False
        cold_holders = [
            (m, lv) for m, lv in rec.holders.items()
            if m in cluster.cold_index and lv > 0
        ]
        if not cold_holders:
            return False
        blocks = max(lv for _, lv in cold_holders)
        owner_ids = cluster.placement_for_root(root)
        view = cluster.membership.view()
        readable = set(view.readable_ids())
        targets = [
            m for m in owner_ids
            if m in readable and rec.holders.get(m, 0) < blocks
        ]
        if not targets:
            return False  # already resident: nothing to promote
        ok_any = False
        for dst in targets[:1]:  # the owner; mirrors re-replicate via reshard
            for cold_id, lv in sorted(cold_holders, key=lambda p: -p[1]):
                copied = self._copy_root(root, rec.tokens, lv, cold_id, dst,
                                         src_cold=True)
                if copied is None:
                    continue
                keys_moved, bytes_moved, skipped = copied
                if skipped:
                    # The cold source proved holey at its claimed level
                    # (keys raced eviction under the read): the landed
                    # partial copy is recorded level 0 (knowledge — it can
                    # never justify a prune) but the PROMOTION did not
                    # happen; same verdict as the demotion leg. Try the
                    # next cold holder.
                    cluster.catalog_add_holder(root, dst, 0)
                    continue
                if not cluster.catalog_add_holder(root, dst, lv):
                    # Dropped mid-promotion: undo the stray serving copy.
                    self._undo_copy(root, rec.tokens, lv, dst, cold=False)
                    return False
                self._bump("tier_promotions")
                self._bump("tier_promoted_keys", keys_moved)
                self._bump("tier_promoted_bytes", bytes_moved)
                # A promotion IS a temperature touch: the freshly promoted
                # root must not bounce straight back to cold on the next
                # idle scan (promote/demote ping-pong).
                self.policy.on_access(root)
                telemetry.emit(
                    "tier_promotion", member=dst,
                    epoch=cluster.membership.view().epoch,
                    root=root[:16], keys=keys_moved, source=cold_id,
                )
                ok_any = True
                break
        if not ok_any:
            self._bump("tier_promote_failures")
        return ok_any

    # -- the copy engine (the resharder's discipline) --------------------------

    def _copy_root(self, root: str, tokens, blocks: int, src_id: str,
                   dst_id: str, src_cold: bool) -> Optional[Tuple[int, int, int]]:
        """Copy one root's keys between a serving member and a cold member
        (either direction), BACKGROUND-tagged, each side's transport
        errors feeding ITS OWN breaker. Returns (keys, bytes, skipped) or
        None on failure."""
        cluster = self.cluster
        src = cluster.tier_member(src_id, cold=src_cold)
        dst = cluster.tier_member(dst_id, cold=not src_cold)
        if src is None or dst is None:
            return None
        if not cluster.tier_begin(src_id, cold=src_cold):
            return None
        try:
            groups = src.manifest(tokens, blocks)
        except InfiniStoreException as e:
            cluster.tier_done(src_id, e, cold=src_cold)
            return None
        except BaseException:
            cluster.tier_done(src_id, None, cold=src_cold)
            raise
        if not cluster.tier_begin(dst_id, cold=not src_cold):
            cluster.tier_done(src_id, None, cold=src_cold)
            return None
        moved = nbytes = skipped = 0
        try:
            for size, keys in groups:
                per = max(1, self.max_batch_bytes // max(1, size))
                for s in range(0, len(keys), per):
                    m, b, sk = self._copy_chunk(
                        src.conn, dst.conn, keys[s : s + per], size
                    )
                    moved += m
                    nbytes += b
                    skipped += sk
        except _TierCopyError as e:
            if e.side == "src":
                cluster.tier_done(src_id, e.cause, cold=src_cold)
                cluster.tier_done(dst_id, None, cold=not src_cold)
            else:
                cluster.tier_done(src_id, None, cold=src_cold)
                cluster.tier_done(dst_id, e.cause, cold=not src_cold)
            return None
        except BaseException:
            cluster.tier_done(src_id, None, cold=src_cold)
            cluster.tier_done(dst_id, None, cold=not src_cold)
            raise
        cluster.tier_done(src_id, None, cold=src_cold)
        cluster.tier_done(dst_id, None, cold=not src_cold)
        return moved, nbytes, skipped

    def _copy_chunk(self, src_conn, dst_conn, keys: List[str],
                    size: int) -> Tuple[int, int, int]:
        buf = np.empty(len(keys) * size, dtype=np.uint8)
        blocks = [(k, i * size) for i, k in enumerate(keys)]
        try:
            src_conn.register_mr(buf)
            try:
                # Tier movement is BACKGROUND by contract: demotion and
                # promotion copies must never delay a decode-blocking read
                # in any queue they cross (docs/qos.md).
                src_conn.read_cache(
                    blocks, size, buf.ctypes.data,
                    priority=PRIORITY_BACKGROUND,
                )
            finally:
                self._unregister(src_conn, buf)
        except (InfiniStoreKeyNotFound, InfiniStoreResourcePressure):
            # A key raced eviction (or sits pressured): per-key fallback,
            # skipping the unreadable ones — a shorter copy is legal,
            # fabricated bytes are not (the resharder's rule).
            return self._copy_chunk_slow(src_conn, dst_conn, keys)
        except InfiniStoreException as e:
            raise _TierCopyError("src", e)
        try:
            dst_conn.register_mr(buf)
            try:
                dst_conn.write_cache(
                    blocks, size, buf.ctypes.data,
                    priority=PRIORITY_BACKGROUND,
                )
            finally:
                self._unregister(dst_conn, buf)
        except InfiniStoreException as e:
            raise _TierCopyError("dst", e)
        return len(keys), len(keys) * size, 0

    def _copy_chunk_slow(self, src_conn, dst_conn,
                         keys: List[str]) -> Tuple[int, int, int]:
        moved = nbytes = skipped = 0
        for key in keys:
            try:
                data = src_conn.tcp_read_cache(key, priority=PRIORITY_BACKGROUND)
            except (InfiniStoreKeyNotFound, InfiniStoreResourcePressure):
                skipped += 1
                continue
            except InfiniStoreException as e:
                raise _TierCopyError("src", e)
            arr = np.ascontiguousarray(data)
            try:
                dst_conn.register_mr(arr)
                try:
                    dst_conn.write_cache(
                        [(key, 0)], arr.nbytes, arr.ctypes.data,
                        priority=PRIORITY_BACKGROUND,
                    )
                finally:
                    self._unregister(dst_conn, arr)
            except InfiniStoreException as e:
                raise _TierCopyError("dst", e)
            moved += 1
            nbytes += arr.nbytes
        return moved, nbytes, skipped

    @staticmethod
    def _unregister(conn, buf):
        try:
            conn.unregister_mr(buf)
        # Audited: transfer-scoped MR teardown on a possibly-severed
        # transport; the data-plane error already routed through tier_done.
        except InfiniStoreException:  # its: allow[ITS-P001]
            pass

    # -- observability ---------------------------------------------------------

    def status(self) -> dict:
        """Flat ``tier_*`` counter snapshot — the vocabulary the
        ``/tiers`` manage route serves and ``server._tier_prometheus_lines``
        exports as ``infinistore_tier_*`` (held in lockstep by ITS-C007;
        documented in docs/tiering.md).

        Keys: ``tier_cold_members`` (capacity-pool size),
        ``tier_cold_roots`` (catalog roots with a provable cold copy),
        ``tier_tracked_roots`` / ``tier_sketch_evictions`` (temperature-
        sketch occupancy and ghost-eviction pressure); per-tier read
        outcomes ``tier_ram_hits`` / ``tier_cold_hits`` /
        ``tier_demotion_hits`` (present-but-unpromotable spilled keys —
        alive one tier down, the 512 status) / ``tier_misses``;
        ``tier_cold_reads`` and ``tier_cold_read_p99_us`` (cold-path
        latency — the windowed authority is the SLO engine's
        ``cold_latency`` objective); movement ledgers ``tier_demotions``
        / ``tier_demoted_keys`` / ``tier_demoted_bytes`` /
        ``tier_demote_failures`` and ``tier_promotions`` /
        ``tier_promoted_keys`` / ``tier_promoted_bytes`` /
        ``tier_promote_failures``; ``tier_admit_rejects`` (cold hits the
        anti-scan admission kept cold); ``tier_direct_reads`` (staged
        prefetches skipped for cold-only roots — the engine's direct
        path); ``tier_promote_backlog`` (queued promotion roots);
        ``tier_demote_backlog`` (catalog roots currently eligible for
        demotion — idle past the policy threshold, not yet cold);
        ``tier_wrong_reads`` (must stay 0); ``tier_last_pass_ms``."""
        cluster = self.cluster
        cold_index = cluster.cold_index
        readable = set(cluster.membership.view().readable_ids())
        cold_roots = 0
        demote_backlog = 0
        for root, _tokens, _blocks, holders in self._catalog_items():
            if any(m in cold_index and lv > 0 for m, lv in holders.items()):
                cold_roots += 1
            elif any(m in readable and lv > 0 for m, lv in holders.items()):
                if cold_index and self.policy.should_demote(root):
                    demote_backlog += 1
        with self._stats_lock:
            counters = dict(self._c)
            lat = sorted(self._cold_lat_us)
        p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))] if lat else 0.0
        with self._cv:
            backlog = len(self._promote_queue)
        return {
            **counters,
            "tier_cold_members": len(cold_index),
            "tier_cold_roots": cold_roots,
            "tier_tracked_roots": self.policy.sketch.tracked,
            "tier_sketch_evictions": self.policy.sketch.evictions,
            "tier_demotion_hits": demotion_hits(),
            "tier_promote_backlog": backlog,
            "tier_demote_backlog": demote_backlog,
            "tier_cold_read_p99_us": round(p99, 1),
        }


class _TierCopyError(Exception):
    """A tier copy failed, remembering WHICH side's transport did (the
    resharder's ``_CopyError`` discipline: a flaky source must never open
    a healthy destination's circuit)."""

    def __init__(self, side: str, cause: InfiniStoreException):
        super().__init__(f"{side}: {cause}")
        self.side = side
        self.cause = cause
