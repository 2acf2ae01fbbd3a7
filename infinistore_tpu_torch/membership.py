"""Elastic cluster membership: live add/remove of members with online
rendezvous-delta resharding.

Copy of ``infinistore_tpu/membership.py`` for the PyTorch port, which imports
nothing of ``infinistore_tpu``; keep the two in step.

``ClusterKVConnector`` (cluster.py) fixed its member list at construction —
scaling the pool meant draining it. This module is the step from "a
cluster" to "a fleet": a **versioned membership view** that changes at
runtime while reads stay available, and a **resharder** that moves only the
keys whose rendezvous placement actually changed (Beluga's pooled, scalable
KVCache shape, PAPERS.md; Mooncake-style background movement).

Three pieces:

- :class:`MembershipView` — an immutable, **epoch-stamped** snapshot of the
  member list and per-member state. Every mutation produces a new view with
  a higher epoch; readers hold a view and can never observe a half-applied
  transition.
- :class:`Membership` — the state machine. Members move through
  ``JOINING -> ACTIVE -> LEAVING -> REMOVED`` (graceful) or ``-> DEAD``
  (crash). Placement (where NEW writes go) covers JOINING+ACTIVE members;
  reads may also fall back to LEAVING members until their migration drains.
  Entry indices are **stable forever** (tombstones, never deletion), so the
  cluster's per-member breaker/health arrays stay index-aligned across any
  amount of churn.
- :class:`Resharder` — a background reconciler. It owns no policy of its
  own: the target placement of every root is ``rendezvous_ranked`` over the
  current view's placement ids (cluster.py), so the **delta between epochs
  is computed, not configured** — a join moves only the ~1/(N+1) of roots
  whose owner/replica set gained the joiner; a leave/death re-mirrors only
  the leaver's roots from their surviving replica to the promoted
  successor. Migration traffic is tagged ``PRIORITY_BACKGROUND`` end to end
  (docs/qos.md) so a reshard cannot move the foreground p99, and every
  transport error routes through the cluster's degrade machinery
  (``_begin``/``_done`` — the same breakers ordinary ops feed;
  docs/robustness.md). An epoch change mid-pass triggers a **replan**, so a
  member dying during a reshard is re-planned against the new view instead
  of wedging the old plan.

Availability during a reshard is the cluster's job (epoch-aware read
failover: try the new owner, fall back to the old owner/replica —
cluster.py ``_read_candidates``); this module's job is that the fallback
window closes: when the reconciler drains, it **finalizes** the pending
transitions (JOINING becomes ACTIVE, LEAVING becomes REMOVED) and the view
collapses back to a single placement.

See docs/membership.md for the protocol walk-through.
"""

import json
import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .lib import (
    InfiniStoreException,
    InfiniStoreKeyNotFound,
    InfiniStoreResourcePressure,
    Logger,
)
from . import telemetry
from .wire import PRIORITY_BACKGROUND

__all__ = [
    "MemberState", "MembershipView", "Membership", "Resharder", "DurableLog",
]


# ---------------------------------------------------------------------------
# Durable write-ahead log (crash-safe catalog + reshard journal).
# ---------------------------------------------------------------------------

# On-disk record framing: little-endian u32 payload length + u32 CRC32 of
# the payload, then the JSON payload bytes. The header carries no magic —
# the file IS the stream, and replay validates every record by checksum.
_REC_HDR = struct.Struct("<II")


class DurableLog:
    """Append-only, length-prefixed, checksummed, fsync-bounded record log
    — the durability substrate for the cluster's root catalog and reshard
    journal (docs/membership.md, durability section).

    Write path: each :meth:`append` frames one JSON record as
    ``[u32 length][u32 crc32(payload)][payload]``, writes it through the
    buffered file and flushes to the OS (a ``kill -9`` therefore loses
    nothing already appended); ``fsync`` is **bounded**, not per-record —
    at most one fsync per ``fsync_interval_s`` unless the caller forces it
    (membership transitions and reshard plan records do; per-save catalog
    records do not), so journaling stays off the save path's latency.

    Replay policy (:meth:`replay`):

    - a **torn tail** (truncated header or payload — the record being
      written when the process died) is discarded cleanly and counted
      (``journal_replay_torn``), never parsed;
    - a record whose **checksum mismatches** is skipped and counted
      (``journal_replay_bad_checksum``); replay continues at the next
      frame (the length prefix still delimits it). A corrupted *length*
      field cannot be resynced past — the remainder is treated as a torn
      tail;
    - everything else replays in append order (last record wins per key,
      so a ``drop`` tombstone after a ``root`` record keeps the root
      dropped — replay can never resurrect it).

    :meth:`compact` atomically rewrites the log as a snapshot (tmp file +
    fsync + ``os.replace``), preserving holder block-levels and membership
    tombstones while discarding the superseded incremental records — run
    on reshard finalize and at replay time.

    Thread-safe: one internal lock serializes appends/compaction (event
    loop, resharder worker and operator threads all write).

    ``status()`` keys (exported as ``infinistore_journal_*`` on /metrics,
    ITS-C005): ``journal_records``, ``journal_bytes``, ``journal_fsyncs``,
    ``journal_compactions``, ``journal_replay_records``,
    ``journal_replay_torn``, ``journal_replay_bad_checksum``.
    """

    MAX_RECORD = 16 << 20  # length-field plausibility bound for replay

    def __init__(self, path: str, fsync_interval_s: float = 0.05,
                 clock=time.monotonic):
        # its: cross-thread  (event loop, resharder worker and operator
        # threads all append; compaction runs from the worker)
        self.path = path
        self.fsync_interval_s = fsync_interval_s
        self._clock = clock
        self._lock = threading.Lock()
        # its: guard[_f, _last_fsync: _lock]
        self._f = open(path, "ab")
        self._last_fsync = clock()
        # its: guard[records, fsyncs, compactions: _lock!w]
        self.records = 0
        self.fsyncs = 0
        self.compactions = 0
        self.replay_records = 0
        self.replay_torn = 0
        self.replay_bad_checksum = 0

    @staticmethod
    def _frame(record: dict) -> bytes:
        payload = json.dumps(record, separators=(",", ":")).encode()
        return _REC_HDR.pack(len(payload), zlib.crc32(payload)) + payload

    def append(self, record: dict, fsync: bool = False):
        """Append one record (write + flush to the OS always; fsync when
        forced or the bounded interval elapsed). No-op after close()."""
        buf = self._frame(record)
        with self._lock:
            if self._f is None:
                return
            self._f.write(buf)
            # Audited: a bounded buffered write + flush to the page cache
            # (microseconds; the journal lives on tmpfs in every harness).
            # The fsync below is interval-bounded and forced only from
            # non-loop paths (transitions, reshard plans).
            self._f.flush()
            self.records += 1
            now = self._clock()
            if fsync or now - self._last_fsync >= self.fsync_interval_s:
                os.fsync(self._f.fileno())
                self._last_fsync = now
                self.fsyncs += 1

    def replay(self) -> List[dict]:
        """Parse every intact record from disk, applying the torn-tail /
        bad-checksum policy above; updates the replay counters."""
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except OSError:
            return []
        out: List[dict] = []
        torn = bad = 0
        i = 0
        n = len(data)
        while i < n:
            if i + _REC_HDR.size > n:
                torn += 1  # partial header: the frame being written
                break
            ln, crc = _REC_HDR.unpack_from(data, i)
            if ln <= 0 or ln > self.MAX_RECORD:
                # Implausible length = corrupt frame boundary; nothing
                # after it can be delimited — discard as a torn tail.
                torn += 1
                break
            if i + _REC_HDR.size + ln > n:
                torn += 1  # partial payload
                break
            payload = data[i + _REC_HDR.size: i + _REC_HDR.size + ln]
            i += _REC_HDR.size + ln
            if zlib.crc32(payload) != crc:
                bad += 1  # skipped, counted; next frame still delimited
                continue
            try:
                out.append(json.loads(payload))
            except ValueError:
                bad += 1
        self.replay_records = len(out)
        self.replay_torn = torn
        self.replay_bad_checksum = bad
        return out

    def compact(self, records):
        """Atomically replace the log's contents with ``records`` — either
        a sequence of record dicts or a CALLABLE returning one: tmp file,
        fsync, ``os.replace``, append order preserved.

        Pass a callable when the snapshot derives from live state the
        appenders also mutate (the cluster's catalog): it runs UNDER the
        log lock, so no append can land between the snapshot read and the
        file replace — otherwise a record written in that window (e.g. a
        ``drop`` tombstone racing a finalize-time compaction) would be
        silently destroyed with the old file, and a later replay would
        resurrect state the appender had already retired. Appenders must
        therefore never call :meth:`append` while holding a lock the
        snapshot function takes (the cluster appends outside its catalog
        lock, always)."""
        with self._lock:
            if self._f is None:
                return
            if callable(records):
                # The cluster's snapshot callable takes the catalog lock
                # HERE, under the log lock — the one blessed direction of
                # that pair. Summarized for the static lock-order graph
                # (the callback indirection hides it from inference):
                # its: acquires[ClusterKVConnector._cat_lock]
                records = records()
            tmp = self.path + ".compact.tmp"
            with open(tmp, "wb") as f:
                for r in records:
                    f.write(self._frame(r))
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            self._f = open(self.path, "ab")
            self._last_fsync = self._clock()
            self.compactions += 1
            self.fsyncs += 1

    def size_bytes(self) -> int:
        try:
            return os.stat(self.path).st_size
        except OSError:
            return 0

    def status(self) -> dict:
        """Flat ``journal_*`` counter snapshot for /membership + /metrics.

        Keys: ``journal_records`` (appends, lifetime), ``journal_bytes``
        (current log size), ``journal_fsyncs``, ``journal_compactions``,
        ``journal_replay_records`` / ``journal_replay_torn`` /
        ``journal_replay_bad_checksum`` (what the startup replay saw)."""
        return {
            "journal_records": self.records,
            "journal_bytes": self.size_bytes(),
            "journal_fsyncs": self.fsyncs,
            "journal_compactions": self.compactions,
            "journal_replay_records": self.replay_records,
            "journal_replay_torn": self.replay_torn,
            "journal_replay_bad_checksum": self.replay_bad_checksum,
        }

    def close(self):
        with self._lock:
            if self._f is None:
                return
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except OSError:
                pass
            self._f.close()
            self._f = None


class MemberState:
    """Member lifecycle states (docs/membership.md):

    - ``JOINING``: in placement (new writes target it; the resharder is
      copying its share of existing roots); readable.
    - ``ACTIVE``: steady state — in placement, readable.
    - ``LEAVING``: graceful drain — OUT of placement (no new writes), still
      readable while the resharder re-mirrors its roots to their promoted
      successors.
    - ``DEAD``: crash — out of placement, NOT readable; its copies are
      written off and re-replicated from surviving replicas.
    - ``REMOVED``: terminal tombstone after a LEAVING member's drain
      completes. Kept so entry indices stay stable forever.
    """

    JOINING = "joining"
    ACTIVE = "active"
    LEAVING = "leaving"
    DEAD = "dead"
    REMOVED = "removed"

    # States that take NEW writes (rendezvous placement targets).
    PLACEMENT = (JOINING, ACTIVE)
    # States reads may still be served from.
    READABLE = (JOINING, ACTIVE, LEAVING)
    # Terminal states (no further transitions).
    TERMINAL = (DEAD, REMOVED)


@dataclass(frozen=True)
class MembershipView:
    """Immutable epoch-stamped membership snapshot.

    ``member_ids``/``states`` are index-aligned with the owning cluster's
    member arrays — indices are stable across churn (tombstoned, never
    reused), so a view captured before a transition still resolves
    correctly after it.
    """

    epoch: int
    member_ids: Tuple[str, ...]
    states: Tuple[str, ...]
    # Per-entry incarnation stamp: the epoch at which the entry reached its
    # current state. Gossip merges compare (since_epoch, state rank) so a
    # DEAD tombstone at epoch 5 beats stale ACTIVE knowledge from epoch 3
    # while a legitimate re-add at epoch 7 beats the tombstone
    # (docs/membership.md, gossip section). Empty for views built by old
    # callers; zip() below tolerates it.
    since: Tuple[int, ...] = ()

    def placement_ids(self) -> List[str]:
        """Member ids new writes rendezvous over (JOINING + ACTIVE)."""
        return [
            m for m, s in zip(self.member_ids, self.states)
            if s in MemberState.PLACEMENT
        ]

    def readable_ids(self) -> List[str]:
        """Member ids reads may be served from (placement + LEAVING)."""
        return [
            m for m, s in zip(self.member_ids, self.states)
            if s in MemberState.READABLE
        ]

    def state_of(self, member_id: str) -> Optional[str]:
        """Current state of ``member_id`` (None when unknown). When an id
        was re-added after death, the LATEST entry wins."""
        for m, s in zip(reversed(self.member_ids), reversed(self.states)):
            if m == member_id:
                return s
        return None

    def as_dict(self) -> dict:
        """JSON-shaped view for health()/the manage plane (and the gossip
        exchange payload — ``since_epoch`` is what makes the merge
        tombstone-aware)."""
        since = self.since or (0,) * len(self.member_ids)
        return {
            "epoch": self.epoch,
            "members": [
                {"member_id": m, "state": s, "since_epoch": int(se)}
                for m, s, se in zip(self.member_ids, self.states, since)
            ],
        }


@dataclass
class _Entry:
    member_id: str
    state: str
    since_epoch: int


class Membership:
    """The versioned membership state machine.

    Thread-safe: every transition happens under one lock and bumps
    ``epoch``; readers take :meth:`view` (immutable). The previous
    placement id set is retained from the moment the view diverges until
    :meth:`finalize_transitions` collapses it — that window is what the
    cluster's epoch-aware read failover spans (reads try the new owner,
    then the old owner/replica), so availability stays 1.0 mid-reshard.

    Transitions (anything else raises ``ValueError``):

    - ``add_member(id)``: new entry JOINING (id must not collide with a
      live entry; DEAD/REMOVED tombstone ids may rejoin as a new entry).
    - ``remove_member(id)``: JOINING/ACTIVE -> LEAVING.
    - ``mark_dead(id)``: JOINING/ACTIVE/LEAVING -> DEAD.
    - ``finalize_transitions()``: JOINING -> ACTIVE, LEAVING -> REMOVED —
      called by the :class:`Resharder` once migration for the current
      epoch drained.
    """

    def __init__(self, member_ids: Sequence[str], clock=time.monotonic):
        if not member_ids:
            raise ValueError("membership needs at least one member")
        if len(set(member_ids)) != len(member_ids):
            raise ValueError(f"member_ids must be unique, got {list(member_ids)}")
        self._lock = threading.Lock()
        self._clock = clock
        # The published-snapshot discipline (ITS-R001): every mutation
        # happens under _lock and republishes _view; readers take the
        # immutable view (or a single-reference read) lock-free.
        # its: guard[epoch, epoch_changes, _entries: _lock!w]
        self.epoch = 1
        self._entries: List[_Entry] = [
            _Entry(mid, MemberState.ACTIVE, 1) for mid in member_ids
        ]
        self.epoch_changes = 0  # transitions applied (counter, not gauge)
        # Placement ids as of the last SETTLED view; the read-failover
        # fallback set while a transition is in flight. None when settled.
        # its: guard[_prev_placement, _owner, _view: _lock!w]
        self._prev_placement: Optional[Tuple[str, ...]] = None
        # True while THIS process originated the pending transition: only
        # the originator finalizes (a gossip adopter with an empty catalog
        # must not rubber-stamp a transition whose migration it cannot
        # see — it settles when the originator's finalized view arrives).
        self._owner = False
        # Post-publish hook (cluster journaling): called with the new view
        # after every epoch change, OUTSIDE the membership lock.
        self.on_change: Optional[Callable[[MembershipView], None]] = None
        self._view = self._snapshot()

    # -- snapshots -----------------------------------------------------------

    def _snapshot(self) -> MembershipView:
        return MembershipView(
            epoch=self.epoch,
            member_ids=tuple(e.member_id for e in self._entries),
            states=tuple(e.state for e in self._entries),
            since=tuple(e.since_epoch for e in self._entries),
        )

    def _notify(self, view: MembershipView):
        cb = self.on_change
        if cb is not None:
            try:
                cb(view)
            except Exception as e:  # journaling must never fail a transition
                Logger.error(f"membership on_change hook failed: {e!r}")

    def view(self) -> MembershipView:
        """The current immutable view (cheap: prebuilt per transition)."""
        return self._view

    @property
    def settled(self) -> bool:
        """True when no transition is pending (no JOINING/LEAVING entry)."""
        v = self._view
        return not any(
            s in (MemberState.JOINING, MemberState.LEAVING) for s in v.states
        )

    @property
    def prev_placement(self) -> Optional[Tuple[str, ...]]:
        """Placement ids of the last settled view while a transition is in
        flight (the old owners reads fall back to), else None."""
        return self._prev_placement

    def index_of(self, member_id: str) -> int:
        """Stable entry index of ``member_id`` (latest entry when a
        tombstoned id rejoined). Raises KeyError when unknown."""
        for i in range(len(self._entries) - 1, -1, -1):
            if self._entries[i].member_id == member_id:
                return i
        raise KeyError(member_id)

    # -- transitions ---------------------------------------------------------

    def _entry(self, member_id: str) -> _Entry:
        return self._entries[self.index_of(member_id)]

    def _mutate(self, fn, action: str = "", member_id: str = "") -> MembershipView:
        with self._lock:
            if self._prev_placement is None:
                self._prev_placement = tuple(self._view.placement_ids())
            fn()
            self.epoch += 1
            self.epoch_changes += 1
            self._owner = True  # this process originated the transition
            self._view = view = self._snapshot()
        # Journal the epoch bump OUTSIDE the membership lock (the journal
        # has its own): which transition, on whom, to which epoch — the
        # causal anchor reshard/failover traces hang from
        # (docs/observability.md).
        telemetry.emit(
            "membership_epoch", member=member_id, epoch=view.epoch,
            action=action,
        )
        self._notify(view)
        return view

    def add_member(self, member_id: str) -> MembershipView:
        """Admit ``member_id`` as JOINING (it immediately takes new writes;
        the resharder copies its rendezvous share of existing roots)."""
        def apply():  # its: requires[_lock]
            try:
                live = self._entry(member_id).state
            except KeyError:
                live = None
            if live is not None and live not in MemberState.TERMINAL:
                raise ValueError(
                    f"member {member_id!r} already present ({live})"
                )
            self._entries.append(
                _Entry(member_id, MemberState.JOINING, self.epoch + 1)
            )
        return self._mutate(apply, action="add", member_id=member_id)

    def remove_member(self, member_id: str) -> MembershipView:
        """Begin a graceful drain: ``member_id`` leaves placement (no new
        writes) but stays readable until its roots are re-mirrored.
        Refused for the LAST placement member — a graceful drain promises
        the data survives, and there would be nowhere to re-mirror it
        (``mark_dead`` remains available to record a real crash)."""
        def apply():  # its: requires[_lock]
            e = self._entry(member_id)
            if e.state not in (MemberState.JOINING, MemberState.ACTIVE):
                raise ValueError(
                    f"cannot remove member {member_id!r} in state {e.state}"
                )
            survivors = [
                o for o in self._entries
                if o is not e and o.state in MemberState.PLACEMENT
            ]
            if not survivors:
                raise ValueError(
                    f"cannot remove {member_id!r}: it is the last placement "
                    "member — nowhere to re-mirror its roots (add a member "
                    "first, or mark_dead to record a crash)"
                )
            e.state = MemberState.LEAVING
            e.since_epoch = self.epoch + 1
        return self._mutate(apply, action="remove", member_id=member_id)

    def mark_dead(self, member_id: str) -> MembershipView:
        """Write a member off: out of placement AND unreadable. Its copies
        are lost; the resharder re-replicates from surviving replicas."""
        def apply():  # its: requires[_lock]
            e = self._entry(member_id)
            if e.state in MemberState.TERMINAL:
                raise ValueError(
                    f"member {member_id!r} already terminal ({e.state})"
                )
            e.state = MemberState.DEAD
            e.since_epoch = self.epoch + 1
        return self._mutate(apply, action="mark_dead", member_id=member_id)

    def finalize_transitions(
        self, expected_epoch: Optional[int] = None
    ) -> Optional[MembershipView]:
        """Collapse pending transitions once migration drained: JOINING ->
        ACTIVE, LEAVING -> REMOVED, and drop the fallback placement set.
        Returns the new view, or None when nothing was pending (no epoch
        bump). ``expected_epoch``: refuse (return None, no change) unless
        the epoch still equals it — the resharder passes the epoch it
        PLANNED at, so a transition landing between plan and finalize can
        never be finalized with zero migration done (the next pass replans
        it instead). Resharder-internal in normal operation."""
        with self._lock:
            if expected_epoch is not None and self.epoch != expected_epoch:
                return None
            changed = False
            for e in self._entries:
                moved = e.state in (MemberState.JOINING, MemberState.LEAVING)
                if e.state == MemberState.JOINING:
                    e.state = MemberState.ACTIVE
                elif e.state == MemberState.LEAVING:
                    e.state = MemberState.REMOVED
                if moved:
                    changed = True
                    e.since_epoch = self.epoch + 1
            self._prev_placement = None
            if not changed:
                self._owner = False
                return None
            self.epoch += 1
            self.epoch_changes += 1
            self._owner = False
            self._view = view = self._snapshot()
        telemetry.emit(
            "membership_epoch", epoch=view.epoch, action="finalize",
        )
        self._notify(view)
        return view

    # -- gossip merge + restore (docs/membership.md) -------------------------

    # Per-entry precedence within one incarnation (equal since_epoch): a
    # more advanced state wins, and terminal states dominate liveness — a
    # lattice join, so concurrent merges commute and every process
    # converges on identical states without coordination.
    _STATE_RANK = {
        MemberState.JOINING: 1,
        MemberState.ACTIVE: 2,
        MemberState.LEAVING: 3,
        MemberState.DEAD: 4,
        MemberState.REMOVED: 5,
    }

    @property
    def owns_transition(self) -> bool:
        """True while the pending transition was originated by THIS process
        (only the originator's resharder finalizes it; gossip adopters
        settle when the finalized view arrives)."""
        return self._owner

    @classmethod
    def _beats(cls, a_state: str, a_since: int, b_state: str,
               b_since: int) -> bool:
        """Does (b_state @ b_since) supersede (a_state @ a_since)? Newer
        incarnation wins outright (a re-add after DEAD is legitimate);
        within one incarnation the state lattice decides (tombstones
        dominate — stale liveness never resurrects a written-off member)."""
        if b_since != a_since:
            return b_since > a_since
        return cls._STATE_RANK.get(b_state, 0) > cls._STATE_RANK.get(a_state, 0)

    @staticmethod
    def _latest_remote(remote_members: Sequence[dict]) -> Dict[str, Tuple[str, int]]:
        latest: Dict[str, Tuple[str, int]] = {}
        for m in remote_members:
            mid = m["member_id"]
            state = m["state"]
            since = int(m.get("since_epoch", 0))
            cur = latest.get(mid)
            if cur is None or Membership._beats(cur[0], cur[1], state, since):
                latest[mid] = (state, since)
        return latest

    def _merge_delta(self, remote_members: Sequence[dict]):
        """(in-place state changes, brand-new entries) the lattice join of
        the current entries with a remote view would apply. Caller holds
        ``self._lock``. New entries come back in a deterministic order
        (sorted by (since_epoch, member_id)) so the cluster can append its
        member arrays in the same order it later re-derives here."""
        local_latest: Dict[str, int] = {}  # mid -> latest entry index
        for i, e in enumerate(self._entries):
            local_latest[e.member_id] = i
        changes: List[Tuple[int, str, int]] = []  # (entry idx, state, since)
        new: List[Tuple[str, str, int]] = []  # (mid, state, since)
        for mid, (rstate, rsince) in self._latest_remote(remote_members).items():
            idx = local_latest.get(mid)
            if idx is None:
                new.append((mid, rstate, rsince))
                continue
            e = self._entries[idx]
            if not self._beats(e.state, e.since_epoch, rstate, rsince):
                continue
            if e.state in MemberState.TERMINAL and rsince > e.since_epoch:
                # A newer incarnation of a tombstoned id: a NEW entry (the
                # dead incarnation's index stays stable forever).
                new.append((mid, rstate, rsince))
            else:
                changes.append((idx, rstate, rsince))
        new.sort(key=lambda t: (t[2], t[0]))
        return changes, new

    def merge_plan(self, remote_members: Sequence[dict]) -> List[Tuple[str, str, int]]:
        """Dry run of a gossip merge: the brand-new entries (in apply
        order) a :meth:`merge_apply` of this payload would append — the
        cluster dials connections for the readable ones first, then
        applies (docs/membership.md, gossip section)."""
        with self._lock:
            _, new = self._merge_delta(remote_members)
        return new

    def merge_apply(
        self, remote_members: Sequence[dict], remote_epoch: int,
        prev_placement: Optional[Sequence[str]] = None,
        on_new=None,
    ) -> Tuple[bool, MembershipView]:
        """Apply the tombstone-aware lattice merge of a remote view
        (docs/membership.md: per member id, the newest incarnation wins;
        within one incarnation the more advanced state wins, so terminal
        knowledge dominates). The epoch becomes ``max(local, remote)`` —
        the merge itself is commutative and idempotent, so two processes
        exchanging in either order converge on identical (epoch, states).
        Returns ``(changed, view)``. Does NOT take transition ownership:
        an adopted transition is finalized by its originator, and this
        process settles when the finalized view gossips back.

        ``on_new(member_id, state, since)``: called UNDER the membership
        lock immediately before each brand-new entry appends — the
        cluster appends its member/health array slots there, so entry
        indices and member arrays cannot diverge even when a concurrent
        finalize (the resharder thread holds no admin lock) changed the
        delta between the caller's ``merge_plan`` and this apply. Must be
        O(1) and non-blocking (no I/O, no other locks)."""
        with self._lock:
            changes, new = self._merge_delta(remote_members)
            epoch_moved = int(remote_epoch) > self.epoch
            if not changes and not new and not epoch_moved:
                return False, self._view
            was_placement = tuple(self._view.placement_ids())
            for idx, state, since in changes:
                self._entries[idx].state = state
                self._entries[idx].since_epoch = since
            for mid, state, since in new:
                if on_new is not None:
                    on_new(mid, state, since)
                self._entries.append(_Entry(mid, state, since))
            self.epoch = max(self.epoch, int(remote_epoch))
            self.epoch_changes += 1
            self._view = view = self._snapshot()
            settled = not any(
                s in (MemberState.JOINING, MemberState.LEAVING)
                for s in view.states
            )
            if settled:
                self._prev_placement = None
            elif self._prev_placement is None:
                # The fallback set reads span mid-transition: the sender's
                # pre-transition placement when it shared one, else our own
                # placement as of just before this merge.
                self._prev_placement = (
                    tuple(prev_placement) if prev_placement else was_placement
                )
        telemetry.emit(
            "membership_epoch", epoch=view.epoch, action="gossip_merge",
        )
        self._notify(view)
        return True, view

    def restore(
        self, entries: Sequence[Tuple[str, str, int]], epoch: int,
        prev_placement: Optional[Sequence[str]] = None, owner: bool = False,
    ) -> MembershipView:
        """Install a journaled view wholesale (crash-recovery replay;
        construction-time only — no epoch bump, no events, no hooks). The
        caller has already rebuilt its member arrays in ``entries``
        order."""
        with self._lock:
            self._entries = [
                _Entry(mid, state, int(since)) for mid, state, since in entries
            ]
            self.epoch = int(epoch)
            self._prev_placement = (
                tuple(prev_placement) if prev_placement else None
            )
            self._owner = bool(owner)
            self._view = view = self._snapshot()
        return view

    # -- observability -------------------------------------------------------

    def status(self) -> dict:
        """Flat counter snapshot for /membership, /metrics and health().

        Keys: ``membership_epoch`` (current view epoch),
        ``membership_epoch_changes`` (transitions applied),
        ``membership_members`` (live entries: placement + LEAVING),
        ``membership_joining`` / ``membership_active`` /
        ``membership_leaving`` / ``membership_dead`` /
        ``membership_removed`` (entries per state), and
        ``membership_settled`` (1 when no transition is pending)."""
        v = self._view
        by_state = {s: 0 for s in (
            MemberState.JOINING, MemberState.ACTIVE, MemberState.LEAVING,
            MemberState.DEAD, MemberState.REMOVED,
        )}
        for s in v.states:
            by_state[s] += 1
        return {
            "membership_epoch": v.epoch,
            "membership_epoch_changes": self.epoch_changes,
            "membership_members": len(v.readable_ids()),
            "membership_joining": by_state[MemberState.JOINING],
            "membership_active": by_state[MemberState.ACTIVE],
            "membership_leaving": by_state[MemberState.LEAVING],
            "membership_dead": by_state[MemberState.DEAD],
            "membership_removed": by_state[MemberState.REMOVED],
            "membership_settled": 1 if self.settled else 0,
        }


# ---------------------------------------------------------------------------
# Resharder
# ---------------------------------------------------------------------------


@dataclass
class _RootTask:
    """One root's migration work for the current epoch: copy its keys to
    the placement members that lack them, from any readable holder, then
    prune the copies rendezvous no longer wants."""

    root: str
    tokens: np.ndarray
    blocks: int
    sources: List[str]  # holder ids, rendezvous-rank order, readable only
    targets: List[str]  # placement ids missing the copy (want - holders)
    prune: List[str] = field(default_factory=list)  # holders no longer wanted


class _CopyError(Exception):
    """A migration copy failed, remembering WHICH side's transport did —
    the error must feed the failing member's breaker, not its innocent
    counterpart (a flaky source must never open a healthy destination's
    circuit)."""

    def __init__(self, side: str, cause: InfiniStoreException):
        super().__init__(f"{side}: {cause}")
        self.side = side  # "src" | "dst"
        self.cause = cause


class Resharder:
    """Background reconciler: drive the cluster's key placement to match the
    current membership view, one rendezvous delta at a time.

    The worker thread wakes on :meth:`kick` (every membership transition),
    plans the delta for the CURRENT epoch from the cluster's root catalog
    (cluster.py ``reshard_plan``), and executes it root by root:

    - read the root's keys from a readable holder (surviving replica /
      leaver / old owner) through that member's circuit breaker,
    - write them to each missing placement member (the joiner, or the
      promoted successor),
    - prune the copies rendezvous no longer wants (a moved root's old
      owner), so a join *moves* ~1/N of keys rather than accreting copies.

    All data-plane ops are **sync batched ops off any event loop**, tagged
    ``PRIORITY_BACKGROUND`` (ITS-P003 enforces the tag): the server's
    two-class scheduler and the client's process-wide foreground gate keep
    a reshard out of the foreground p99 (docs/qos.md). Transport errors
    feed the owning member's breaker via the cluster's ``_done`` — the
    degrade machinery sees migration traffic exactly like foreground
    traffic (ITS-P001). If the epoch changes mid-pass (a member died
    during the reshard), the pass aborts and **replans** against the new
    view; roots whose every holder is gone are written off (reads degrade
    to a miss — recompute, never wrong bytes).

    When a pass drains with zero debt, pending transitions finalize
    (``Membership.finalize_transitions``) and the worker idles.
    """

    def __init__(self, cluster, max_batch_bytes: int = 2 << 20,
                 retry_backoff_s: float = 0.05, clock=time.monotonic):
        self.cluster = cluster
        self.max_batch_bytes = max_batch_bytes
        self.retry_backoff_s = retry_backoff_s
        self._clock = clock
        self._cv = threading.Condition()
        # its: guard[_dirty: _cv]
        self._dirty = False
        # its: guard[_stop, _active: _cv!w]
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._active = False  # worker mid-pass or debt outstanding
        # Counters (reshard_* vocabulary — docs/membership.md). Written
        # only on the reconciler thread (cluster.reshard_plan's
        # lost-roots bump runs there too); progress() snapshots them.
        # its: guard[_c: single_writer]
        self._c = {
            "reshard_passes": 0,
            "reshard_replans": 0,
            "reshard_planned_roots": 0,
            "reshard_moved_roots": 0,
            "reshard_moved_keys": 0,
            "reshard_moved_bytes": 0,
            "reshard_pruned_keys": 0,
            "reshard_skipped_keys": 0,
            "reshard_failed_roots": 0,
            "reshard_lost_roots": 0,
            "reshard_debt_roots": 0,
            "reshard_prune_debt": 0,
            "reshard_last_pass_ms": 0.0,
        }

    # -- lifecycle -----------------------------------------------------------

    def kick(self):
        """Wake the reconciler (the cluster calls this on every membership
        transition; saves do NOT kick — an under-replicated save is
        reconciled on the next transition's pass, matching the pre-elastic
        replication contract). Starts the worker thread lazily on first
        use."""
        with self._cv:
            self._dirty = True
            self._active = True
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="its-resharder", daemon=True
                )
                self._thread.start()
            self._cv.notify_all()

    def stop(self):
        """Stop the worker (the cluster's close path); idempotent."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)

    @property
    def active(self) -> bool:
        """True while migration work is planned, running, or pending."""
        return self._active

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until the reconciler drained (no debt, membership settled)
        or ``timeout`` elapsed; returns True when idle."""
        deadline = self._clock() + timeout
        with self._cv:
            while self._active or self._dirty:
                left = deadline - self._clock()
                if left <= 0:
                    return False
                self._cv.wait(timeout=min(left, 0.1))
        return True

    # -- observability -------------------------------------------------------

    def progress(self) -> dict:
        """Flat migration counters for /membership, /metrics and health().

        Keys: ``reshard_active`` (1 while migrating), ``reshard_passes``
        (reconcile sweeps), ``reshard_replans`` (passes aborted by an epoch
        change), ``reshard_planned_roots`` (delta tasks planned, lifetime),
        ``reshard_moved_roots`` / ``reshard_moved_keys`` /
        ``reshard_moved_bytes`` (migration volume),
        ``reshard_pruned_keys`` (copies deleted where rendezvous no longer
        places the root), ``reshard_skipped_keys`` (keys evicted under the
        copy — skipped, never fabricated), ``reshard_failed_roots`` (tasks
        that failed a pass and stayed as debt), ``reshard_lost_roots``
        (roots written off: every holder dead), ``reshard_debt_roots``
        (remaining COPY delta after the last pass — the bounded migration
        debt the bench gates at 0), ``reshard_prune_debt`` (stale copies
        whose delete could not land yet — space, not correctness; retried
        on later passes without blocking convergence),
        ``reshard_last_pass_ms``, and ``reshard_catalog_roots`` (live root
        records in the cluster's catalog — the knowledge a crash-restart
        recovers from the durable journal, docs/membership.md)."""
        out = dict(self._c)
        out["reshard_active"] = 1 if self._active else 0
        out["reshard_catalog_roots"] = len(getattr(self.cluster, "_catalog", ()))
        return out

    # -- worker --------------------------------------------------------------

    def _run(self):
        backoff = self.retry_backoff_s
        while True:
            with self._cv:
                while not self._dirty and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                self._dirty = False
            try:
                debt = self._reconcile()
            except Exception as e:  # never let the reconciler thread die
                Logger.error(f"resharder pass failed: {e!r}")
                debt = 1
            with self._cv:
                if debt and not self._stop:
                    # Failed roots stay as debt: retry with a light backoff
                    # (a kicked epoch change interrupts the sleep). A timed
                    # backoff, not a predicate wait: a spurious wake only
                    # retries the pass sooner, and the loop-top while
                    # re-checks _dirty/_stop before the next sleep.
                    self._dirty = True
                    self._cv.wait(timeout=backoff)  # its: allow[ITS-R004]
                    backoff = min(backoff * 2.0, 1.0)
                else:
                    backoff = self.retry_backoff_s
                    if not self._dirty:
                        self._active = False
                self._cv.notify_all()

    def _reconcile(self) -> int:
        """One reconcile sweep: plan the delta at the current epoch and
        execute it; returns the remaining debt (0 = drained). An epoch
        change mid-pass aborts and reports the rest as debt (the next pass
        replans against the new view)."""
        membership: Membership = self.cluster.membership
        t0 = self._clock()
        epoch = membership.view().epoch
        tasks = self.cluster.reshard_plan()
        self._c["reshard_passes"] += 1
        self._c["reshard_planned_roots"] += len(tasks)
        self._c["reshard_debt_roots"] = len(tasks)
        # Journal the pass (docs/membership.md, durability): a restarted
        # client sees an OPEN plan record (no matching "fin") and resumes
        # the migration from the journaled catalog instead of waiting for
        # the next transition. Holder updates per copied root double as
        # the progress records — a replayed plan only contains the roots
        # still missing copies.
        journal = getattr(self.cluster, "journal_reshard_event", None)
        if tasks and journal is not None:
            journal("plan", epoch, len(tasks))
        debt = 0
        prune_debt = 0
        for k, task in enumerate(tasks):
            if self._stop:
                return len(tasks) - k
            if membership.view().epoch != epoch:
                # The view moved under us (e.g. a member died mid-reshard):
                # this plan is stale — abort and replan at the new epoch.
                self._c["reshard_replans"] += 1
                self._c["reshard_debt_roots"] = len(tasks) - k
                self._c["reshard_prune_debt"] = prune_debt
                return len(tasks) - k
            ok, prune_failed = self._migrate_root(task)
            prune_debt += prune_failed
            if ok:
                if task.targets:
                    # Prune-only retries (copy landed in an earlier pass)
                    # are not a second "move" — the bench's moved-fraction
                    # gate counts roots, not passes.
                    self._c["reshard_moved_roots"] += 1
            else:
                self._c["reshard_failed_roots"] += 1
                debt += 1
            self._c["reshard_debt_roots"] = debt + (len(tasks) - 1 - k)
        self._c["reshard_debt_roots"] = debt
        self._c["reshard_prune_debt"] = prune_debt
        if debt == 0:
            if tasks and journal is not None:
                # Close the journaled plan: this pass's copy debt drained
                # (fin is about THIS process's migration work — the view
                # may still be pending another process's finalize).
                journal("fin", epoch, 0)
            # Only the process that ORIGINATED the pending transition
            # finalizes it: a gossip adopter's empty/partial catalog
            # draining proves nothing about the originator's migration,
            # and its view settles when the finalized epoch gossips back
            # (docs/membership.md, gossip section).
            if not membership.owns_transition and not membership.settled:
                return debt
            # Guarded: only the epoch this pass PLANNED at may finalize —
            # a transition that landed after the plan (even against an
            # empty task list) must be re-planned, never rubber-stamped.
            if membership.finalize_transitions(expected_epoch=epoch) is None:
                if membership.view().epoch != epoch:
                    self._c["reshard_replans"] += 1
                    with self._cv:
                        self._dirty = True
                    return debt
            # A drained pass supersedes its incremental records whether or
            # not a finalize was pending (a mark_dead re-replication drains
            # with the view ALREADY settled): compact so restarts replay a
            # bounded snapshot with the final holder sets.
            if tasks:
                compact = getattr(self.cluster, "compact_journal", None)
                if compact is not None:
                    compact()
            # Finalizing bumps the epoch but creates no new delta (JOINING
            # and ACTIVE place identically; LEAVING was already out) — the
            # catalog may still have grown, so one more plan() confirms.
            # Only COPY work re-arms the pass: prune debt (a stale copy
            # behind an OPEN breaker) is retried on later kicks instead of
            # hot-looping against a member that fast-fails every delete.
            if any(t.targets for t in self.cluster.reshard_plan()):
                with self._cv:
                    self._dirty = True
        self._c["reshard_last_pass_ms"] = round(
            (self._clock() - t0) * 1e3, 3
        )
        return debt

    # -- one root ------------------------------------------------------------

    def _migrate_root(self, task: _RootTask) -> Tuple[bool, int]:
        """Copy ``task.root``'s keys to every missing placement member,
        then prune the copies rendezvous no longer wants. Returns
        ``(copies_ok, prune_failures)``: copy failures are hard debt (the
        pass retries until every target holds a copy); failed prunes stay
        in the catalog so later plans retry them (a moved root never
        silently accretes copies) WITHOUT blocking convergence — a stale
        copy is pool space, not a correctness or availability hole.

        Prune safety: prunes run only when every copy landed skip-free
        ("gone" — the root was dropped mid-copy — and skipped-key copies
        both suppress them), so a complete old copy is never deleted in
        favor of one with eviction holes; the plan's ``want_floor`` check
        provides the same guarantee for prune-only retries."""
        ok = True
        gone = False
        skipped_before = self._c["reshard_skipped_keys"]
        for dst in task.targets:
            status = self._copy_root(task, dst)
            if status == "gone":
                gone = True
            elif status != "ok":
                ok = False
        prune_failures = 0
        if ok and not gone and self._c["reshard_skipped_keys"] == skipped_before:
            for mid in task.prune:
                if not self._prune_copy(task, mid):
                    prune_failures += 1
        return ok, prune_failures

    def _copy_root(self, task: _RootTask, dst_id: str) -> str:
        """Copy one root from the first serving holder to ``dst_id``,
        BACKGROUND-tagged, through both members' breakers. Transport
        errors feed the breaker of the SIDE that failed (``_CopyError``):
        a dying source must not open a healthy destination's circuit.

        Returns ``"ok"`` (copied; a skip-free copy recorded ``dst_id`` as
        a level-``task.blocks`` holder; one with eviction holes recorded
        level 0 so it can never justify a prune or serve as a source),
        ``"gone"`` (the root's record vanished mid-copy — dropped — and
        the stray copy was undone), or ``"failed"`` (debt; retried)."""
        cluster = self.cluster
        try:
            di = cluster.member_index(dst_id)
        except KeyError:
            return "failed"
        for src_id in task.sources:
            try:
                si = cluster.member_index(src_id)
            except KeyError:
                continue
            if cluster._begin(si) is None:
                continue  # breaker OPEN: fast-fail this source locally
            try:
                groups = cluster.members[si].manifest(task.tokens, task.blocks)
            except InfiniStoreException as e:
                cluster._done(si, e)
                continue
            except BaseException:
                # Non-store failure (e.g. a duck-typed member without
                # manifest): the breaker must still see an outcome or a
                # half-open probe wedges HALF_OPEN forever (same
                # discipline as the cluster's read paths).
                cluster._done(si, None)
                raise
            if cluster._begin(di) is None:
                cluster._done(si, None)
                return "failed"  # destination breaker OPEN: leave as debt
            try:
                moved_keys, moved_bytes, skipped = self._copy_groups(
                    cluster.members[si], cluster.members[di], groups
                )
            except _CopyError as e:
                if e.side == "src":
                    # The source's transport failed mid-read: feed ITS
                    # breaker, settle the destination as answered, and try
                    # the next holder.
                    cluster._done(si, e.cause)
                    cluster._done(di, None)
                    continue
                # The destination failed the write: feed its breaker; the
                # source answered fine.
                cluster._done(si, None)
                cluster._done(di, e.cause)
                return "failed"
            except BaseException:
                # Non-store failure: both breakers must still see an
                # outcome or a half-open probe wedges HALF_OPEN forever.
                cluster._done(si, None)
                cluster._done(di, None)
                raise
            cluster._done(si, None)
            cluster._done(di, None)
            self._c["reshard_moved_keys"] += moved_keys
            self._c["reshard_moved_bytes"] += moved_bytes
            self._c["reshard_skipped_keys"] += skipped
            level = task.blocks if skipped == 0 else 0
            if skipped:
                # The source's copy proved incomplete at its claimed level
                # (keys evicted under the read): demote it so the next
                # pass re-sources from a complete holder — or, if none is
                # left, stops planning this root instead of retrying the
                # same holes forever.
                cluster.catalog_demote_holder(task.root, src_id)
            if not cluster.catalog_add_holder(task.root, dst_id, level):
                # The root was dropped while this copy was in flight: the
                # delete already swept every cataloged holder, so the copy
                # that just landed is the ONLY stray — undo it, or the new
                # owner would serve a dropped prompt forever (no later
                # plan can prune a root the catalog no longer knows).
                try:
                    for _, keys in groups:
                        cluster.members[di].conn.delete_keys(keys)
                except InfiniStoreException as e:
                    cluster._done(di, e)
                return "gone"
            return "ok"
        return "failed"

    def _copy_groups(self, src, dst, groups) -> Tuple[int, int, int]:
        """Move every (block_size, keys) manifest group src -> dst in
        bounded BACKGROUND batches through a transfer-scoped registered
        staging buffer. Returns (keys moved, bytes moved, keys skipped —
        evicted under the copy)."""
        moved = nbytes = skipped = 0
        for size, keys in groups:
            per = max(1, self.max_batch_bytes // max(1, size))
            for s in range(0, len(keys), per):
                chunk = keys[s : s + per]
                m, b, sk = self._copy_chunk(src.conn, dst.conn, chunk, size)
                moved += m
                nbytes += b
                skipped += sk
        return moved, nbytes, skipped

    def _copy_chunk(self, src_conn, dst_conn, keys: List[str],
                    size: int) -> Tuple[int, int, int]:
        buf = np.empty(len(keys) * size, dtype=np.uint8)
        blocks = [(k, i * size) for i, k in enumerate(keys)]
        try:
            src_conn.register_mr(buf)
            try:
                # Migration reads are BACKGROUND by contract (ITS-P003):
                # they must never delay a decode-blocking foreground read.
                src_conn.read_cache(
                    blocks, size, buf.ctypes.data,
                    priority=PRIORITY_BACKGROUND,
                )
            finally:
                self._unregister(src_conn, buf)
        except (InfiniStoreKeyNotFound, InfiniStoreResourcePressure):
            # Some key raced eviction (or sits spilled behind a pressured
            # pool) between plan and copy: the batch is all-or-nothing, so
            # fall back per key and skip the unreadable ones — a shorter
            # prefix on the destination is legal (prefix match just hits
            # less); fabricating bytes would not be. Treating pressure as
            # debt instead would wedge the reshard for as long as the
            # source stays full.
            return self._copy_chunk_slow(src_conn, dst_conn, keys)
        except InfiniStoreException as e:
            raise _CopyError("src", e)  # the caller feeds the src breaker
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
            raise _CopyError("dst", e)  # the caller feeds the dst breaker
        return len(keys), len(keys) * size, 0

    def _copy_chunk_slow(self, src_conn, dst_conn,
                         keys: List[str]) -> Tuple[int, int, int]:
        """Per-key fallback when a batched copy hit an evicted or
        pressured key. Reads ride the single-key TCP path (the one op that
        can answer per-key instead of all-or-nothing; its priority tag is
        a client-side no-op — acceptable for this rare eviction-race
        path); the WRITES, where migration load would contend with the
        destination's foreground service, go through a single-key batched
        op so the BACKGROUND tag is real on the wire (ITS-P003,
        docs/qos.md)."""
        moved = nbytes = skipped = 0
        for key in keys:
            try:
                data = src_conn.tcp_read_cache(
                    key, priority=PRIORITY_BACKGROUND
                )
            except (InfiniStoreKeyNotFound, InfiniStoreResourcePressure):
                skipped += 1  # evicted/pressured away: skip, never fabricate
                continue
            except InfiniStoreException as e:
                raise _CopyError("src", e)
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
                raise _CopyError("dst", e)
            moved += 1
            nbytes += arr.nbytes
        return moved, nbytes, skipped

    def _prune_copy(self, task: _RootTask, member_id: str) -> bool:
        """Delete a copy rendezvous no longer places on ``member_id`` (the
        *move* half of a join's delta transfer). A failed prune costs pool
        bytes, not correctness — errors feed the breaker and the task
        stays in the plan (prune debt is retried until it drains or the
        member stops being ACTIVE). Returns True when the prune landed."""
        cluster = self.cluster
        try:
            i = cluster.member_index(member_id)
        except KeyError:
            return True  # entry gone: nothing left to prune
        if cluster._begin(i) is None:
            return False
        try:
            groups = cluster.members[i].manifest(task.tokens, task.blocks)
            n = 0
            for _, keys in groups:
                n += cluster.members[i].conn.delete_keys(keys)
            self._c["reshard_pruned_keys"] += n
        except InfiniStoreException as e:
            cluster._done(i, e)
            return False
        except BaseException:
            cluster._done(i, None)  # never wedge a probe
            raise
        cluster._done(i, None)
        cluster.catalog_remove_holder(task.root, member_id)
        return True

    @staticmethod
    def _unregister(conn, buf):
        try:
            conn.unregister_mr(buf)
        # Audited: transfer-scoped MR teardown on a possibly-severed
        # transport — the data-plane error (if any) already routed through
        # _done in the caller; a failed unregister leaves nothing live.
        except InfiniStoreException:  # its: allow[ITS-P001]
            pass
