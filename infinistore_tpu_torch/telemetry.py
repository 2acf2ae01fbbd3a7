"""Fleet telemetry plane: cluster-joined traces, SLO burn rates, event journal.

Copy of ``infinistore_tpu/telemetry.py`` for the PyTorch port, which imports
nothing of ``infinistore_tpu``; keep the two in step.

Per-process tracing made one process legible — per-op spans, a flight recorder, ``GET
/trace``, latency histograms — but the system the ROADMAP steers toward
(elastic multi-member clusters) fails at the *fleet* level: a breaker trips
on member 2, a reshard epoch bumps, foreground p99 drifts, and each of
those is visible only as a disconnected counter on one process's manage
plane. This module joins them (docs/observability.md, fleet section):

- :class:`EventJournal` — a bounded structured ring of **cluster events**
  (the :data:`EVENT_KINDS` vocabulary: breaker transitions, membership
  epoch changes, stripe quarantine/revive, watchdog slow ops, QoS aging
  storms, SLO alert edges), each stamped with member id, epoch, and the
  ACTIVE TRACE ID where one exists — so "why was this op slow" joins the
  op's span tree to the cluster state change that slowed it. Served at
  ``GET /events`` and cross-linked from ``GET /trace``.
- :class:`SloEngine` — rolling multi-window SLIs (availability, fg p99
  from the ``infinistore_op_duration_us`` histograms, miss rate, reshard
  debt drain) with **multi-window burn-rate alerting** (short AND long
  window over threshold fires; hysteresis clears). Exported as
  ``infinistore_slo_*`` gauges and the ``GET /slo`` verdict consumed by
  ``/health``. Clock-injectable: the window math is tested with a fake
  clock, no sleeps.
- :class:`FleetScraper` — an off-loop, breaker-aware, bounded scraper that
  pulls each member's ``/trace`` (native tick ring + flight-recorder
  spans) and ``/stats`` (op counters + histograms) over the manage plane,
  feeds the SLO engine with the deltas, and keeps the last per-member
  span set for the **cluster trace join**: ``GET /trace?scope=cluster``
  merges every member's spans with the local client recorder by trace id
  onto one monotonic timeline (same-host CLOCK_MONOTONIC; one Perfetto
  track lane per member in ``?fmt=chrome``).

The ITS-C006 checker (tools/analysis/counters.py) holds the telemetry
vocabulary in lockstep: every :data:`EVENT_KINDS` entry must have a
producer and a docs row, every ``slo_*`` status key must reach the
``/metrics`` exporter, and the manage plane must keep serving ``/slo`` and
``/events``.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import tracing

# ---------------------------------------------------------------------------
# Event journal.
# ---------------------------------------------------------------------------

# Canonical cluster-event vocabulary. The ITS-C006 checker fails the build
# when a producer emits a kind outside this tuple, when a kind has no
# producer left (dead vocabulary), or when a kind is undocumented in
# docs/observability.md.
EVENT_KINDS = (
    "breaker_open",       # member breaker tripped (CLOSED/HALF_OPEN -> OPEN)
    "breaker_half_open",  # probe window elapsed; one probe admitted
    "breaker_closed",     # probe success re-closed the breaker (recovery)
    "membership_epoch",   # membership transition bumped the epoch
    "stripe_quarantine",  # striped data plane quarantined a dead stripe
    "stripe_revive",      # quarantined stripe reconnected and rejoined
    "slow_op",            # watchdog captured an over-threshold span tree
    "qos_aging_storm",    # bg aging escapes crossed the storm threshold
    "slo_alert",          # burn-rate alert fired or cleared (edge)
    "gossip_round",       # one anti-entropy peer-exchange round completed
    "client_restart",     # a crashed client replayed its durable journal
    "tier_demotion",      # an idle root's copy shipped to the pooled cold tier
    "tier_promotion",     # a reused cold root copied back to its serving owner
    "metric_anomaly",     # metrics-history change-point detector fired
    "disagg_fallback",    # handoff layer late/failed -> local recompute leg
)

_DEFAULT_JOURNAL_CAPACITY = 512


class EventJournal:
    """Bounded structured ring of cluster events (causal journal).

    Always on and cheap: events are rare (state transitions, not ops), one
    lock-guarded append each. Every event records ``seq`` (monotone),
    ``t_us`` (CLOCK_MONOTONIC microseconds — the same clock trace spans
    stamp, so events sort onto the trace timeline), wall-clock seconds,
    the event ``kind``, the ``member`` id and membership ``epoch`` where
    known, and the active ``trace_id`` when the emitting code ran inside
    a traced op — that link is what makes the journal *causal* rather
    than a log.
    """

    def __init__(self, capacity: int = _DEFAULT_JOURNAL_CAPACITY):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        # its: guard[_events, _seq, emitted, _counts: _lock]
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.emitted = 0
        self._counts: Dict[str, int] = {}

    def emit(self, kind: str, member: str = "", epoch: int = 0,
             trace_id: Optional[int] = None, **attrs) -> dict:
        """Record one event. ``trace_id=None`` stamps the active span's
        trace id (0 when untraced); pass an explicit id when emitting on
        behalf of another context (the slow-op hook)."""
        if trace_id is None:
            span = tracing.active_span()
            trace_id = span.trace_id if span is not None else 0
        event = {
            "kind": kind,
            "member": member,
            "epoch": int(epoch),
            "trace_id": int(trace_id),
            "t_us": tracing._now_us(),
            "wall_s": round(time.time(), 3),
            "attrs": attrs,
        }
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._events.append(event)
            self.emitted += 1
            self._counts[kind] = self._counts.get(kind, 0) + 1
        return event

    def snapshot(self, since_seq: int = 0,
                 limit: Optional[int] = None) -> List[dict]:
        """Events with ``seq > since_seq``, oldest first (ring-bounded)."""
        with self._lock:
            out = [dict(e) for e in self._events if e["seq"] > since_seq]
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def for_trace(self, trace_ids) -> List[dict]:
        """Events carrying one of ``trace_ids`` — the /trace cross-link."""
        wanted = set(trace_ids)
        with self._lock:
            return [dict(e) for e in self._events if e["trace_id"] in wanted]

    def counts(self) -> Dict[str, int]:
        """Per-kind emit totals (``infinistore_events_total`` on /metrics;
        counts survive ring eviction)."""
        with self._lock:
            return dict(self._counts)

    def clear(self):
        with self._lock:
            self._events.clear()
            self._seq = 0
            self.emitted = 0
            self._counts = {}


class _StormDetector:
    """Edge-triggered rate detector for QoS aging escapes: emits one
    ``qos_aging_storm`` event when ``threshold`` escapes land within
    ``window_s``, then re-arms only after a full quiet window (hysteresis
    — a sustained storm is one event, not a flood of them)."""

    def __init__(self, threshold: int = 64, window_s: float = 1.0,
                 clock=time.monotonic):
        self.threshold = threshold
        self.window_s = window_s
        self._clock = clock
        self._stamps: deque = deque()
        self._armed = True
        self._lock = threading.Lock()

    def note(self, n: int = 1) -> int:
        """Record ``n`` aging escapes; returns the in-window count when a
        storm edge fired, else 0."""
        now = self._clock()
        with self._lock:
            horizon = now - self.window_s
            while self._stamps and self._stamps[0] < horizon:
                self._stamps.popleft()
            # Re-arm BEFORE recording this note's escapes: an empty window
            # here means a full quiet window elapsed since the last storm
            # — checking after the append could never see zero from the
            # production callers (which always note >= 1).
            if not self._armed and not self._stamps:
                self._armed = True
            for _ in range(n):
                self._stamps.append(now)
            count = len(self._stamps)
            if self._armed and count >= self.threshold:
                self._armed = False
                return count
            return 0


# ---------------------------------------------------------------------------
# SLO engine: rolling multi-window SLIs + burn-rate alerting.
# ---------------------------------------------------------------------------

class SloObjective:
    """One SLO: a good/bad ratio target (``kind="ratio"``) or a latency
    objective (``kind="latency"``: a sample is *bad* when it lands in a
    histogram bucket above ``latency_threshold_us``; the windowed p99 is
    kept alongside for display). ``target`` is the success-ratio
    objective (e.g. 0.999); the error budget is ``1 - target``."""

    def __init__(self, name: str, target: float, kind: str = "ratio",
                 latency_threshold_us: float = 0.0):
        if not 0.0 < target < 1.0:
            raise ValueError("target must be in (0, 1)")
        if kind not in ("ratio", "latency"):
            raise ValueError(f"unknown objective kind {kind!r}")
        self.name = name
        self.target = target
        self.kind = kind
        self.latency_threshold_us = latency_threshold_us


def default_objectives() -> List[SloObjective]:
    """The fleet's standing SLO set (docs/observability.md):
    availability of data-plane ops, foreground p99 (from the per-op
    duration histograms), cache miss rate through the degrade machinery,
    and reshard debt drain (a reshard whose debt stops draining is an
    incident even though every individual op succeeds)."""
    return [
        SloObjective("availability", target=0.999),
        SloObjective("fg_latency", target=0.99, kind="latency",
                     latency_threshold_us=50_000.0),
        SloObjective("miss_rate", target=0.90),
        SloObjective("reshard_drain", target=0.90),
        # Pooled-cold-tier read latency (docs/tiering.md): cold reads are
        # allowed to be slow — they exist to beat recompute, not RAM — but
        # a cold read slower than ~0.5s has likely stopped doing that.
        # Fed by the cluster's cold-load fall-through
        # (tiering.note_cold_read_us).
        SloObjective("cold_latency", target=0.95, kind="latency",
                     latency_threshold_us=500_000.0),
    ]


# Multi-window burn-rate rules (SRE-workbook shape): (short_s, long_s,
# burn_threshold). An alert FIRES when the burn rate exceeds the threshold
# over BOTH windows — the long window proves the budget spend is real, the
# short window proves it is still happening — and stays firing until the
# short-window burn drops below ``clear_ratio * threshold`` (hysteresis).
DEFAULT_BURN_WINDOWS: Tuple[Tuple[float, float, float], ...] = (
    (300.0, 3600.0, 14.4),   # fast burn: 2% of a 30d budget in 1h
    (1800.0, 21600.0, 6.0),  # slow burn: 5% of a 30d budget in 6h
)


class SloEngine:
    """Rolling multi-window SLI store + burn-rate alert evaluator.

    Samples land in coarse time buckets (``bucket_s``) per objective; a
    window SLI is the good/bad ratio over the buckets it covers, so
    memory is O(windows/bucket_s) per objective regardless of traffic.
    The clock is injectable and nothing sleeps — the window math
    (roll-off, burn monotonicity, hysteresis) is property-tested with a
    fake clock (tests/test_telemetry.py).

    Key vocabulary: :meth:`status` returns the flat ``slo_*`` snapshot the
    ``/slo`` endpoint serves and ``server._slo_prometheus_lines`` exports
    — held in lockstep by ITS-C006.
    """

    def __init__(self, objectives: Optional[Sequence[SloObjective]] = None,
                 windows: Sequence[Tuple[float, float, float]] = DEFAULT_BURN_WINDOWS,
                 clear_ratio: float = 0.5,
                 bucket_s: float = 5.0,
                 clock=time.monotonic,
                 journal: Optional[EventJournal] = None):
        self.objectives: Dict[str, SloObjective] = {
            o.name: o for o in (objectives if objectives is not None
                                else default_objectives())
        }
        self.windows = tuple(windows)
        self.clear_ratio = clear_ratio
        self.bucket_s = bucket_s
        self._clock = clock
        self._journal = journal
        self._max_window = max((w[1] for w in self.windows), default=3600.0)
        self._lock = threading.Lock()
        # name -> deque[[bucket_start_s, good, bad]]
        # its: guard[_buckets, _lat, _firing: _lock]
        self._buckets: Dict[str, deque] = {}
        # latency objectives: name -> deque[[bucket_start_s, {le_us: count}]]
        self._lat: Dict[str, deque] = {}
        # (objective, long_s) -> firing bool; plus the fire-edge counter.
        self._firing: Dict[Tuple[str, float], bool] = {}
        # its: guard[alerts_total: _lock!w]
        self.alerts_total = 0

    # -- feeding -------------------------------------------------------------

    def _bucket(self, store: Dict[str, deque], name: str, now: float,
                empty) -> list:  # its: requires[_lock]
        dq = store.setdefault(name, deque())
        start = now - (now % self.bucket_s)
        if not dq or dq[-1][0] != start:
            dq.append([start, *empty()])
        horizon = now - self._max_window - self.bucket_s
        while dq and dq[0][0] < horizon:
            dq.popleft()
        return dq[-1]

    def record(self, name: str, good: int = 0, bad: int = 0,
               t: Optional[float] = None):
        """Feed good/bad samples to a ratio objective (unknown names are
        accepted — the objective may be configured later; they simply
        don't alert until it is)."""
        now = self._clock() if t is None else t
        with self._lock:
            b = self._bucket(self._buckets, name, now, lambda: (0, 0))
            b[1] += good
            b[2] += bad

    def record_latency_bucket(self, name: str, le_us: float, count: int = 1,
                              t: Optional[float] = None):
        """Feed ``count`` latency samples whose upper bucket bound is
        ``le_us`` (the scraper feeds histogram DELTAS between scrapes).
        Samples above the objective's threshold count against the budget;
        the windowed p99 is derived from the same buckets."""
        if count <= 0:
            return
        now = self._clock() if t is None else t
        obj = self.objectives.get(name)
        threshold = obj.latency_threshold_us if obj is not None else 0.0
        with self._lock:
            lb = self._bucket(self._lat, name, now, lambda: ({},))
            hist = lb[1]
            hist[float(le_us)] = hist.get(float(le_us), 0) + count
            b = self._bucket(self._buckets, name, now, lambda: (0, 0))
            if threshold and le_us > threshold:
                b[2] += count
            else:
                b[1] += count

    # -- window math ---------------------------------------------------------

    def _window_counts(self, name: str, window_s: float,
                       now: float) -> Tuple[int, int]:  # its: requires[_lock]
        dq = self._buckets.get(name)
        if not dq:
            return 0, 0
        horizon = now - window_s
        good = bad = 0
        for start, g, b in dq:
            if start + self.bucket_s > horizon:
                good += g
                bad += b
        return good, bad

    def sli(self, name: str, window_s: Optional[float] = None,
            now: Optional[float] = None) -> float:
        """Success ratio over the window (1.0 with no samples — an idle
        SLI is a met SLI, not a firing one)."""
        now = self._clock() if now is None else now
        window_s = self._max_window if window_s is None else window_s
        with self._lock:
            good, bad = self._window_counts(name, window_s, now)
        total = good + bad
        return 1.0 if total == 0 else good / total

    def burn_rate(self, name: str, window_s: float,
                  now: Optional[float] = None) -> float:
        """Error-budget burn multiple over the window: observed bad
        fraction / allowed bad fraction (1.0 = spending exactly on
        budget; 14.4 = a 30d budget gone in 50h)."""
        obj = self.objectives.get(name)
        if obj is None:
            return 0.0
        now = self._clock() if now is None else now
        with self._lock:
            good, bad = self._window_counts(name, window_s, now)
        total = good + bad
        if total == 0:
            return 0.0
        budget = 1.0 - obj.target
        return (bad / total) / budget if budget > 0 else 0.0

    def p99_us(self, name: str, window_s: Optional[float] = None,
               now: Optional[float] = None) -> float:
        """Windowed p99 for a latency objective, from its bucket counts
        (upper bucket bound, the same convention the /metrics histogram
        export uses). 0.0 with no samples."""
        now = self._clock() if now is None else now
        window_s = self._max_window if window_s is None else window_s
        with self._lock:
            dq = self._lat.get(name)
            if not dq:
                return 0.0
            horizon = now - window_s
            merged: Dict[float, int] = {}
            for start, hist in dq:
                if start + self.bucket_s > horizon:
                    for le, cnt in hist.items():
                        merged[le] = merged.get(le, 0) + cnt
        total = sum(merged.values())
        if total == 0:
            return 0.0
        goal = 0.99 * total
        cum = 0
        for le in sorted(merged):
            cum += merged[le]
            if cum >= goal:
                return le
        return max(merged)

    # -- alerting ------------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """Evaluate every (objective, rule) pair; returns the FIRING alert
        list and emits ``slo_alert`` journal events on fire/clear edges.
        Hysteresis: a firing alert needs the short-window burn to drop
        below ``clear_ratio * threshold`` to clear — not merely below the
        threshold — so an alert flapping on the fire line stays up."""
        now = self._clock() if now is None else now
        firing: List[dict] = []
        for name in self.objectives:
            for short_s, long_s, threshold in self.windows:
                short = self.burn_rate(name, short_s, now)
                long = self.burn_rate(name, long_s, now)
                key = (name, long_s)
                # The fire/clear edge is check-then-act shared between the
                # scraper daemon thread and the manage plane's /slo//health
                # handlers: take it under the engine lock so a concurrent
                # evaluate() cannot double-count alerts_total or journal a
                # duplicate edge. The emit itself stays OUTSIDE the lock
                # (the journal has its own), same discipline as the
                # cluster breaker edges.
                with self._lock:
                    was = self._firing.get(key, False)
                    if was:
                        is_firing = short >= self.clear_ratio * threshold
                    else:
                        is_firing = short >= threshold and long >= threshold
                    edge = is_firing != was
                    if edge:
                        self._firing[key] = is_firing
                        if is_firing:
                            self.alerts_total += 1
                if edge and self._journal is not None:
                    self._journal.emit(
                        "slo_alert", objective=name,
                        window_s=long_s, state=(
                            "firing" if is_firing else "cleared"
                        ),
                        burn_short=round(short, 3),
                        burn_long=round(long, 3),
                    )
                if is_firing:
                    firing.append({
                        "objective": name,
                        "short_window_s": short_s,
                        "long_window_s": long_s,
                        "threshold": threshold,
                        "burn_short": round(short, 4),
                        "burn_long": round(long, 4),
                    })
        return firing

    def status(self, now: Optional[float] = None) -> dict:
        """The ``/slo`` verdict payload. Flat ``slo_*`` keys are the gauge
        vocabulary ``_slo_prometheus_lines`` exports (ITS-C006);
        ``objectives``/``alerts`` carry the per-objective detail."""
        now = self._clock() if now is None else now
        alerts = self.evaluate(now)
        detail = {}
        burn_max = 0.0
        for name, obj in self.objectives.items():
            burns = {}
            for short_s, long_s, threshold in self.windows:
                burns[f"{int(short_s)}s"] = round(
                    self.burn_rate(name, short_s, now), 4
                )
                burns[f"{int(long_s)}s"] = round(
                    self.burn_rate(name, long_s, now), 4
                )
                # Max over BOTH windows: a burst that ended minutes ago has
                # a zero short-window burn while the long window still
                # shows the budget spent — the max gauge must not go clean
                # before the labeled long-window gauge does.
                burn_max = max(
                    burn_max,
                    burns[f"{int(short_s)}s"],
                    burns[f"{int(long_s)}s"],
                )
            detail[name] = {
                "kind": obj.kind,
                "target": obj.target,
                "sli": round(self.sli(name, now=now), 6),
                "burn_rates": burns,
            }
            if obj.kind == "latency":
                detail[name]["p99_us"] = self.p99_us(name, now=now)
        return {
            "slo_availability": round(self.sli("availability", now=now), 6),
            "slo_fg_p99_us": round(self.p99_us("fg_latency", now=now), 1),
            "slo_cold_p99_us": round(self.p99_us("cold_latency", now=now), 1),
            "slo_miss_rate": round(1.0 - self.sli("miss_rate", now=now), 6),
            "slo_reshard_drain": round(self.sli("reshard_drain", now=now), 6),
            "slo_burn_rate_max": round(burn_max, 4),
            "slo_alerts_firing": len(alerts),
            "slo_alerts_total": self.alerts_total,
            "verdict": "burning" if alerts else "ok",
            "objectives": detail,
            "alerts": alerts,
        }


# ---------------------------------------------------------------------------
# Fleet scraper: off-loop, breaker-aware, bounded.
# ---------------------------------------------------------------------------

class _TargetState:
    """Per-target scrape bookkeeping + a minimal availability breaker:
    after ``fail_threshold`` consecutive scrape failures the target is
    skipped until ``backoff_s`` elapses (one probe per window — a dead
    member must cost the scraper one timeout per window, not one per
    scrape)."""

    def __init__(self, member_id: str, host: str, manage_port: int):
        self.member_id = member_id
        self.host = host
        self.manage_port = manage_port
        self.consecutive_failures = 0
        self.skip_until = 0.0
        self.last_ok_at = 0.0
        self.scrapes = 0
        self.failures = 0
        self.last_error = ""
        # Cumulative op counters at the last scrape (delta source).
        self.prev_ops: Dict[str, dict] = {}
        self.prev_suspended = 0
        self.ops_per_s = 0.0
        self.queue_depth = 0
        self.spans: List[dict] = []


class FleetScraper:
    """Pulls each member's manage plane (``/trace`` + ``/stats``), feeds
    the SLO engine with counter/histogram deltas, and keeps the last
    per-member span set for the cluster trace join.

    Off-loop by construction: :meth:`scrape_once` does blocking HTTP and
    is called either from the background thread (:meth:`start`) or via
    ``asyncio.to_thread`` (the manage plane's ``scope=cluster`` handler).
    Bounded: per-member spans are capped at ``max_spans_per_member`` and
    response bodies at ``max_body_bytes``. Breaker-aware: a target that
    keeps failing is skipped until its backoff elapses (see
    :class:`_TargetState`).
    """

    def __init__(self, targets: Sequence[Tuple[str, str, int]] = (),
                 slo: Optional[SloEngine] = None,
                 journal: Optional[EventJournal] = None,
                 cluster=None,
                 interval_s: float = 5.0,
                 timeout_s: float = 2.0,
                 max_spans_per_member: int = 512,
                 max_body_bytes: int = 4 << 20,
                 fail_threshold: int = 3,
                 backoff_s: float = 10.0,
                 clock=time.monotonic):
        self.slo = slo if slo is not None else slo_engine()
        self.journal = journal if journal is not None else get_journal()
        self.cluster = cluster
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.max_spans_per_member = max_spans_per_member
        self.max_body_bytes = max_body_bytes
        self.fail_threshold = fail_threshold
        self.backoff_s = backoff_s
        self._clock = clock
        # its: guard[_targets: _lock]
        self._targets: List[_TargetState] = []
        self._lock = threading.Lock()
        # Serializes whole scrape passes: the background thread and an
        # on-demand ?scope=cluster refresh (asyncio.to_thread) must never
        # delta the same prev_ops concurrently — that would feed the same
        # op counters to the SLO engine twice.
        self._pass_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # its: guard[scrapes_total, scrape_failures_total: _pass_lock!w]
        self.scrapes_total = 0
        self.scrape_failures_total = 0
        # its: guard[_prev_debt: _pass_lock]
        self._prev_debt: Optional[int] = None
        for t in targets:
            self.add_target(*t)

    def add_target(self, member_id: str, host: str, manage_port: int):
        with self._lock:
            self._targets.append(_TargetState(member_id, host, manage_port))

    # -- one scrape pass -----------------------------------------------------

    def _get_json(self, st: _TargetState, path: str) -> dict:
        url = f"http://{st.host}:{st.manage_port}{path}"
        with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
            body = resp.read(self.max_body_bytes)
        return json.loads(body)

    def _feed_stats(self, st: _TargetState, stats: dict, now: float):
        """Delta the member's cumulative op counters/histograms into the
        SLO engine: ok/error deltas feed availability, histogram bucket
        deltas feed the fg-latency objective.

        With a cluster attached, the availability feed is SKIPPED: the
        cluster already records every op outcome client-side (including
        the fast-fails a dead member's scrape can never show), and
        double-feeding the served ops from server counters would dilute
        the bad fraction ~2x — a burn-rate alert firing at half strength
        during an outage. Scrape-fed availability is the standalone
        deployment's source (no cluster object in-process)."""
        ops = stats.get("ops", {}) or {}
        total_delta = 0
        for op, s in ops.items():
            prev = st.prev_ops.get(op, {})
            d_count = s.get("count", 0) - prev.get("count", 0)
            d_err = s.get("errors", 0) - prev.get("errors", 0)
            if d_count < 0:  # member restarted: counters reset
                prev, d_count, d_err = {}, s.get("count", 0), s.get("errors", 0)
            if d_count > 0:
                total_delta += d_count
                if self.cluster is None:
                    self.slo.record(
                        "availability",
                        good=max(0, d_count - d_err), bad=max(0, d_err),
                    )
            prev_hist = dict(prev.get("hist", []))
            for le, cnt in s.get("hist_us", []):
                d = cnt - prev_hist.get(le, 0)
                if d > 0:
                    self.slo.record_latency_bucket("fg_latency", le, d)
            st.prev_ops[op] = {
                "count": s.get("count", 0),
                "errors": s.get("errors", 0),
                "hist": [(le, cnt) for le, cnt in s.get("hist_us", [])],
            }
        if st.last_ok_at:
            dt = max(1e-6, now - st.last_ok_at)
            st.ops_per_s = total_delta / dt
        st.queue_depth = stats.get("suspended_ops", 0)

    def _feed_cluster(self):  # its: requires[_pass_lock]
        """Reshard-drain SLI from the attached cluster: a scrape tick is
        GOOD when the migration debt is zero or shrinking, BAD when debt
        exists and did not drain since the last look."""
        if self.cluster is None:
            return
        try:
            debt = int(
                self.cluster.membership_status().get("reshard_debt_roots", 0)
            )
        except Exception:
            return
        prev = self._prev_debt
        self._prev_debt = debt
        if debt == 0:
            self.slo.record("reshard_drain", good=1)
        elif prev is not None and debt < prev:
            self.slo.record("reshard_drain", good=1)
        elif prev is not None:
            self.slo.record("reshard_drain", bad=1)

    def scrape_once(self, spans: bool = True) -> dict:
        """One blocking pass over every admitted target (callers keep this
        OFF the event loop; concurrent passes serialize — the second runs
        after the first and sees zero deltas). Returns a scrape summary.

        ``spans=False`` pulls only ``/stats`` (the SLO feed) and keeps each
        target's previously-held spans: the span dump is by far the
        expensive half of a pass, and its only consumer —
        ``GET /trace?scope=cluster`` — forces a fresh full pass anyway, so
        the background loop never pays for it."""
        with self._pass_lock:
            return self._scrape_pass(spans)

    def _scrape_pass(self, want_spans: bool = True) -> dict:  # its: requires[_pass_lock]
        now = self._clock()
        ok = skipped = failed = 0
        with self._lock:
            targets = list(self._targets)
        for st in targets:
            if (
                st.consecutive_failures >= self.fail_threshold
                and now < st.skip_until
            ):
                skipped += 1
                continue
            try:
                stats = self._get_json(st, "/stats")
                spans = None
                if want_spans:
                    trace = self._get_json(st, "/trace")
                    spans = list(trace.get("spans", [])) + list(
                        trace.get("server_spans", [])
                    )
                    for s in spans:
                        s.setdefault("attrs", {})["member"] = st.member_id
                self._feed_stats(st, stats, now)
                with self._lock:
                    if spans is not None:
                        st.spans = spans[-self.max_spans_per_member:]
                    st.consecutive_failures = 0
                    st.last_ok_at = now
                    st.scrapes += 1
                ok += 1
                self.scrapes_total += 1
            # Broad by design: an unexpected-SHAPE payload (version skew, a
            # proxy answering the manage port) raises TypeError/KeyError in
            # the feed path, and it must count against THIS target's
            # breaker instead of aborting the rest of the pass.
            except Exception as e:
                failed += 1
                self.scrape_failures_total += 1
                with self._lock:
                    st.failures += 1
                    st.consecutive_failures += 1
                    st.last_error = repr(e)
                    if st.consecutive_failures >= self.fail_threshold:
                        st.skip_until = self._clock() + self.backoff_s
        self._feed_cluster()
        self.slo.evaluate()
        return {"ok": ok, "failed": failed, "skipped": skipped}

    # -- background loop -----------------------------------------------------

    def start(self):
        """Run :meth:`scrape_once` every ``interval_s`` on a daemon
        thread (the off-loop half of the manage plane's fleet view)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="its-fleet-scraper", daemon=True
        )
        self._thread.start()

    def _loop(self):
        # Scrape immediately on entry — waiting a full interval first would
        # leave /slo serving empty member rows for interval_s after start().
        while True:
            try:
                self.scrape_once(spans=False)
            except Exception:
                # The scraper must never die to one bad payload; per-target
                # failures are already counted in scrape_once. Counter under
                # the pass lock: a concurrent on-demand pass increments the
                # same total (ITS-R001 guard discipline).
                with self._pass_lock:
                    self.scrape_failures_total += 1
            if self._stop.wait(self.interval_s):
                return

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    # -- read side -----------------------------------------------------------

    def member_spans(self) -> Dict[str, List[dict]]:
        """Last-scrape span dicts per member, each tagged
        ``attrs.member`` (the cluster-trace-join input)."""
        with self._lock:
            return {st.member_id: list(st.spans) for st in self._targets}

    def status(self) -> dict:
        """Per-member scrape health for the ``/slo`` payload and
        ``tools.top``."""
        now = self._clock()
        with self._lock:
            members = [
                {
                    "member": st.member_id,
                    "target": f"{st.host}:{st.manage_port}",
                    "ok": st.consecutive_failures < self.fail_threshold,
                    "last_scrape_age_s": (
                        round(now - st.last_ok_at, 3) if st.last_ok_at else -1.0
                    ),
                    "scrapes": st.scrapes,
                    "failures": st.failures,
                    "consecutive_failures": st.consecutive_failures,
                    "ops_per_s": round(st.ops_per_s, 1),
                    "queue_depth": st.queue_depth,
                    "last_error": st.last_error,
                    "spans_held": len(st.spans),
                }
                for st in self._targets
            ]
        return {
            "interval_s": self.interval_s,
            "scrapes_total": self.scrapes_total,
            "scrape_failures_total": self.scrape_failures_total,
            "members": members,
        }


# ---------------------------------------------------------------------------
# Gossip agent: anti-entropy membership exchange over the manage plane.
# ---------------------------------------------------------------------------

class GossipAgent:
    """Anti-entropy membership exchange between cluster-client processes
    (docs/membership.md, gossip section).

    Each client process that owns a ``ClusterKVConnector`` runs one agent.
    A round POSTs the cluster's ``gossip_payload()`` (epoch-stamped view
    with per-entry incarnation stamps) to each admitted peer's manage
    plane (``POST /gossip``); the peer merges it through the tombstone-
    aware lattice and answers with ITS post-merge view, which this agent
    merges back — one exchange is **push-pull**, so an epoch bump on
    either side converges in a single round in either direction, with no
    operator POSTing ``/membership`` to every process.

    Peer discipline is the :class:`FleetScraper`'s, reusing
    :class:`_TargetState`: a peer that keeps failing is skipped until its
    backoff elapses (one probe per window — a dead peer costs one timeout
    per window, not one per round). Rounds are journaled as
    ``gossip_round`` events (with the active trace id where one exists)
    and counted in the ``gossip_*`` vocabulary :meth:`status` returns —
    exported as ``infinistore_gossip_*`` on /metrics and held in lockstep
    by ITS-C006.
    """

    def __init__(self, cluster, peers: Sequence[Tuple[str, str, int]] = (),
                 interval_s: float = 1.0, timeout_s: float = 2.0,
                 fail_threshold: int = 3, backoff_s: float = 10.0,
                 journal: Optional[EventJournal] = None,
                 clock=time.monotonic):
        """``peers``: ``(peer_id, host, manage_port)`` triples — the seed
        list of OTHER client processes' manage planes (not store service
        ports)."""
        self.cluster = cluster
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.fail_threshold = fail_threshold
        self.backoff_s = backoff_s
        self.journal = journal if journal is not None else get_journal()
        self._clock = clock
        self._lock = threading.Lock()
        # its: guard[_targets: _lock]
        self._targets: List[_TargetState] = []
        # Serializes whole gossip rounds (ITS-R audit): the
        # background thread and a manual round (tools/fleet, tests) used
        # to interleave freely — double-counting the round ledger and
        # racing two merge_remote_view pulls of the same payload. The
        # FleetScraper grew the same pass lock earlier; this is the
        # gossip agent's missing post-review hardening.
        self._round_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # its: guard[rounds, exchanges, exchange_failures: _round_lock!w]
        self.rounds = 0
        self.exchanges = 0
        self.exchange_failures = 0
        # its: guard[merges_in, merges_out: _round_lock!w]
        self.merges_in = 0   # this process adopted a peer's knowledge
        self.merges_out = 0  # a peer adopted ours (its response said so)
        # its: guard[last_epoch_seen, last_round_ms: _round_lock!w]
        self.last_epoch_seen = 0
        self.last_round_ms = 0.0
        for p in peers:
            self.add_peer(*p)

    def add_peer(self, peer_id: str, host: str, manage_port: int):
        with self._lock:
            self._targets.append(_TargetState(peer_id, host, manage_port))

    def _post_gossip(self, st: _TargetState, payload: dict) -> dict:
        url = f"http://{st.host}:{st.manage_port}/gossip"
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read(4 << 20))

    def exchange_once(self) -> dict:
        """One gossip round over every admitted peer (blocking HTTP —
        callers keep this off the event loop; the background thread and
        tests drive it). Concurrent callers serialize on the round lock —
        the second round runs after the first (same discipline as the
        scraper's pass lock). Returns ``{"ok", "failed", "skipped",
        "adopted"}`` and journals one ``gossip_round`` event (emitted
        OUTSIDE the round lock — the ITS-R003 discipline)."""
        with self._round_lock:
            summary, epoch = self._exchange_round()
        self.journal.emit(
            "gossip_round", epoch=epoch, peers_ok=summary["ok"],
            peers_failed=summary["failed"], peers_skipped=summary["skipped"],
            adopted=summary["adopted"],
        )
        return summary

    def _exchange_round(self):  # its: requires[_round_lock]
        t0 = self._clock()
        payload = self.cluster.gossip_payload()
        ok = failed = skipped = 0
        adopted = 0
        with self._lock:
            targets = list(self._targets)
        for st in targets:
            now = self._clock()
            if (
                st.consecutive_failures >= self.fail_threshold
                and now < st.skip_until
            ):
                skipped += 1
                continue
            try:
                doc = self._post_gossip(st, payload)
                self.exchanges += 1
                if doc.get("merged"):
                    self.merges_out += 1
                self.last_epoch_seen = max(
                    self.last_epoch_seen, int(doc.get("epoch", 0))
                )
                # The pull half: merge the peer's (post-merge) view. A
                # stale view of OURS comes back corrected here — the
                # structured response body is the self-correction channel.
                if doc.get("members") and self.cluster.merge_remote_view(doc):
                    adopted += 1
                    self.merges_in += 1
                    payload = self.cluster.gossip_payload()
                with self._lock:
                    st.consecutive_failures = 0
                    st.last_ok_at = now
                    st.scrapes += 1
                ok += 1
            # Broad like the scraper: a peer answering with an unexpected
            # shape (or a structured 4xx error body) must count against
            # THAT peer's breaker, not abort the round.
            except Exception as e:
                failed += 1
                self.exchange_failures += 1
                with self._lock:
                    st.failures += 1
                    st.consecutive_failures += 1
                    st.last_error = repr(e)
                    if st.consecutive_failures >= self.fail_threshold:
                        st.skip_until = self._clock() + self.backoff_s
        self.rounds += 1
        self.last_round_ms = round((self._clock() - t0) * 1e3, 3)
        epoch = int(self.cluster.membership.view().epoch)
        self.last_epoch_seen = max(self.last_epoch_seen, epoch)
        return {"ok": ok, "failed": failed, "skipped": skipped,
                "adopted": adopted}, epoch

    # -- background loop -----------------------------------------------------

    def start(self):
        """Exchange every ``interval_s`` on a daemon thread, starting
        immediately (a cold process converges on the fleet epoch within
        its first round, not after a full interval)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="its-gossip", daemon=True
        )
        self._thread.start()

    def _loop(self):
        while True:
            try:
                self.exchange_once()
            except Exception:
                # One malformed local payload must not kill anti-entropy;
                # per-peer failures are already counted in the round. The
                # counter takes the round lock — a concurrent manual round
                # increments the same ledger (ITS-R001 guard discipline).
                with self._round_lock:
                    self.exchange_failures += 1
            if self._stop.wait(self.interval_s):
                return

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    # -- read side -----------------------------------------------------------

    def status(self) -> dict:
        """Flat ``gossip_*`` snapshot for /membership-adjacent dashboards
        and the ``infinistore_gossip_*`` /metrics families (ITS-C006).

        Keys: ``gossip_peers`` (admitted targets), ``gossip_rounds``,
        ``gossip_exchanges`` (successful peer POSTs),
        ``gossip_exchange_failures``, ``gossip_merges_in`` (rounds where
        this process adopted peer knowledge), ``gossip_merges_out``
        (peers that adopted ours), ``gossip_last_epoch_seen``,
        ``gossip_last_round_ms``."""
        with self._lock:
            peers = len(self._targets)
        return {
            "gossip_peers": peers,
            "gossip_rounds": self.rounds,
            "gossip_exchanges": self.exchanges,
            "gossip_exchange_failures": self.exchange_failures,
            "gossip_merges_in": self.merges_in,
            "gossip_merges_out": self.merges_out,
            "gossip_last_epoch_seen": self.last_epoch_seen,
            "gossip_last_round_ms": self.last_round_ms,
        }


# ---------------------------------------------------------------------------
# Metrics history: bounded time series + change-point anomaly journal.
# ---------------------------------------------------------------------------

# Families the history samples by default: the small high-signal set the
# dashboards trend (op tails, occupancy, queue depths, SLO burn, tier and
# prof planes). Bounded on purpose — history is a ring per series, and an
# unselected family is one `startswith` miss per pass, not a leak.
DEFAULT_HISTORY_SELECT: Tuple[str, ...] = (
    "infinistore_op_p50_latency_us",
    "infinistore_op_p99_latency_us",
    "infinistore_pool_usage_ratio",
    "infinistore_kvmap_entries",
    "infinistore_qos_queued",
    "infinistore_dataplane_suspended_ops",
    "infinistore_ring_sq_depth",
    "infinistore_slo_",
    "infinistore_tier_cold_read_p99_us",
    "infinistore_prof_",
    "member_",
)


def parse_metrics_text(text: str) -> Dict[str, float]:
    """Flat ``name{labels} -> value`` map from Prometheus exposition text
    (comments/TYPE lines skipped, exemplar suffixes stripped) — the
    history's input shape. ``tools.top`` keeps its own copy of this
    parse (``_metric_families``) by design: tools/ stays stdlib-only
    with no package import; a format change must touch both."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        line = line.split(" # ", 1)[0]
        parts = line.rsplit(" ", 1)
        if len(parts) != 2:
            continue
        try:
            out[parts[0]] = float(parts[1])
        except ValueError:
            continue
    return out


def metrics_http_source(host: str, manage_port: int,
                        timeout_s: float = 2.0) -> Callable[[], Dict[str, float]]:
    """A history source over a manage plane's ``GET /metrics`` (the local
    process's own plane, or any fleet member's)."""
    url = f"http://{host}:{manage_port}/metrics"

    def fetch() -> Dict[str, float]:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return parse_metrics_text(resp.read(4 << 20).decode())

    return fetch


def scraper_source(scraper: "FleetScraper") -> Callable[[], Dict[str, float]]:
    """A history source over the fleet scraper's per-member health rows:
    ``member_ops_per_s{member}`` / ``member_queue_depth{member}`` series,
    so per-member throughput and queue depth trend without a second
    scrape of anyone's manage plane."""

    def fetch() -> Dict[str, float]:
        out: Dict[str, float] = {}
        for m in scraper.status()["members"]:
            out[f'member_ops_per_s{{member="{m["member"]}"}}'] = m["ops_per_s"]
            out[f'member_queue_depth{{member="{m["member"]}"}}'] = float(
                m["queue_depth"]
            )
        return out

    return fetch


class MetricsHistory:
    """Bounded ring of sampled ``/metrics`` families + change-point journal.

    The one-shot ``/metrics`` snapshot answers "what is the p99 NOW"; the
    SLO engine answers "is the budget burning"; neither answers "when did
    it move, and what moved with it". This ring does (docs/observability.md,
    time-series section): every ``interval_s`` it pulls each registered
    source (a callable returning a flat ``name -> value`` map — the local
    manage plane via :func:`metrics_http_source`, the fleet via
    :func:`scraper_source`), keeps the last ``capacity`` points per
    selected series, serves them at ``GET /timeseries``, drives the
    ``tools.top`` sparkline columns, and runs a rolling-window
    change-point detector per series that journals a ``metric_anomaly``
    event on each detected step (edge-triggered with hysteresis — a
    sustained shift is one event, and the journal stamps the active
    trace id like every other kind).

    Detection is deliberately simple and parameter-light: the probe
    window's mean against the preceding baseline window's mean, fired
    when the step exceeds BOTH ``detect_sigma`` baseline standard
    deviations AND ``detect_min_rel`` of the baseline magnitude (the
    relative floor keeps a flat series' zero-sigma from firing on
    float dust, and sigma keeps a noisy series' normal scatter from
    firing on weather). Clock-injectable, nothing sleeps in the math —
    the properties are tested with a fake clock, the bench A/B gates
    exactly-one-on-a-step / zero-on-clean (``timeseries_anomaly``).
    """

    def __init__(self, interval_s: float = 2.0,
                 capacity: int = 256,
                 max_series: int = 128,
                 select: Optional[Tuple[str, ...]] = DEFAULT_HISTORY_SELECT,
                 journal: Optional[EventJournal] = None,
                 clock=time.monotonic,
                 detect_base_n: int = 12,
                 detect_probe_n: int = 4,
                 detect_sigma: float = 4.0,
                 detect_min_rel: float = 0.25):
        if capacity < 2:
            raise ValueError("capacity must be >= 2")
        self.interval_s = interval_s
        self.capacity = capacity
        self.max_series = max_series
        self.select = tuple(select) if select is not None else None
        self.journal = journal if journal is not None else get_journal()
        self._clock = clock
        self.detect_base_n = detect_base_n
        self.detect_probe_n = detect_probe_n
        self.detect_sigma = detect_sigma
        self.detect_min_rel = detect_min_rel
        self._lock = threading.Lock()
        # its: guard[_sources, _series, _armed: _lock]
        self._sources: List[Tuple[str, Callable[[], Dict[str, float]]]] = []
        self._series: Dict[str, deque] = {}  # name -> deque[(t_s, value)]
        self._armed: Dict[str, bool] = {}    # per-series detector edge state
        # its: guard[samples_total, source_failures, dropped_series, anomalies_total, last_pass_ms: _lock]
        self.samples_total = 0
        self.source_failures = 0
        self.dropped_series = 0
        self.anomalies_total = 0
        self.last_pass_ms = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def add_source(self, name: str, fn: Callable[[], Dict[str, float]]):
        """Register a source; ``name`` prefixes its keys (``"name:key"``)
        so two sources exporting the same family cannot collide. The
        empty name is the local process (keys unprefixed)."""
        with self._lock:
            self._sources.append((name, fn))

    def _selected(self, key: str) -> bool:
        if self.select is None:
            return True
        return any(key.startswith(p) for p in self.select)

    # -- one sample pass -----------------------------------------------------

    def _detect_locked(self, name: str, dq: deque) -> Optional[dict]:
        # its: requires[_lock]
        need = self.detect_base_n + self.detect_probe_n
        if len(dq) < need:
            return None
        vals = [v for _, v in list(dq)[-need:]]
        base = vals[: self.detect_base_n]
        probe = vals[self.detect_base_n:]
        base_mean = sum(base) / len(base)
        var = sum((v - base_mean) ** 2 for v in base) / len(base)
        std = var ** 0.5
        probe_mean = sum(probe) / len(probe)
        delta = abs(probe_mean - base_mean)
        threshold = max(
            self.detect_sigma * std,
            self.detect_min_rel * max(abs(base_mean), 1e-9),
        )
        armed = self._armed.get(name, True)
        if armed and delta > threshold:
            self._armed[name] = False
            self.anomalies_total += 1
            return {
                "metric": name,
                "baseline": round(base_mean, 6),
                "current": round(probe_mean, 6),
                "delta": round(probe_mean - base_mean, 6),
                "threshold": round(threshold, 6),
            }
        if not armed and delta < 0.5 * threshold:
            # Hysteresis re-arm: the series settled (at either level) for
            # long enough that the probe/baseline windows agree again.
            self._armed[name] = True
        return None

    def sample_once(self) -> dict:
        """One pass over every source (blocking HTTP for HTTP sources —
        callers keep this off the event loop; the background thread and
        tests drive it). Returns ``{"series", "anomalies"}``; journal
        emits happen OUTSIDE the lock (the ITS-R003 discipline)."""
        t0 = self._clock()
        with self._lock:
            sources = list(self._sources)
        fired: List[dict] = []
        updated = 0
        for name, fn in sources:
            try:
                values = fn()
            except Exception:
                # A dead source costs one failure count per pass, never
                # the pass itself (the scraper discipline).
                with self._lock:
                    self.source_failures += 1
                continue
            now = self._clock()
            with self._lock:
                for key, value in values.items():
                    full = f"{name}:{key}" if name else key
                    if not self._selected(key):
                        continue
                    dq = self._series.get(full)
                    if dq is None:
                        if len(self._series) >= self.max_series:
                            self.dropped_series += 1
                            continue
                        dq = self._series[full] = deque(maxlen=self.capacity)
                    dq.append((now, float(value)))
                    updated += 1
                    anomaly = self._detect_locked(full, dq)
                    if anomaly is not None:
                        fired.append(anomaly)
        for anomaly in fired:
            self.journal.emit("metric_anomaly", **anomaly)
        with self._lock:
            self.samples_total += 1
            self.last_pass_ms = round((self._clock() - t0) * 1e3, 3)
            n_series = len(self._series)
        return {"series": n_series, "updated": updated,
                "anomalies": len(fired)}

    # -- background loop -----------------------------------------------------

    def start(self):
        """Sample every ``interval_s`` on a daemon thread, immediately on
        entry (the scraper discipline: no empty first interval)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="its-metrics-history", daemon=True
        )
        self._thread.start()

    def _loop(self):
        while True:
            try:
                self.sample_once()
            except Exception:
                # Per-source failures are already counted inside the pass;
                # this guards the pass machinery itself.
                with self._lock:
                    self.source_failures += 1
            if self._stop.wait(self.interval_s):
                return

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    # -- read side -----------------------------------------------------------

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def points(self, metric: str,
               window_s: Optional[float] = None) -> List[List[float]]:
        """``[[t_s, value], ...]`` oldest-first for one series, clipped to
        the trailing ``window_s`` (monotonic-clock seconds — deltas are
        meaningful, absolutes are process-relative)."""
        now = self._clock()
        with self._lock:
            dq = self._series.get(metric)
            pts = list(dq) if dq is not None else []
        if window_s is not None:
            horizon = now - window_s
            pts = [p for p in pts if p[0] >= horizon]
        return [[round(t, 3), v] for t, v in pts]

    def status(self) -> dict:
        """Flat ``timeseries_*`` snapshot for ``GET /timeseries`` and the
        ``infinistore_timeseries_*`` /metrics families — held in lockstep
        with ``server._timeseries_prometheus_lines`` and
        docs/observability.md by ITS-C008.

        Keys: ``timeseries_series`` (live series), ``timeseries_points``
        (retained points), ``timeseries_samples`` (passes),
        ``timeseries_sources``, ``timeseries_source_failures``,
        ``timeseries_dropped_series`` (series past the cap),
        ``timeseries_anomalies`` (change-points journaled),
        ``timeseries_interval_s``, ``timeseries_capacity``,
        ``timeseries_last_pass_ms``."""
        with self._lock:
            return {
                "timeseries_series": len(self._series),
                "timeseries_points": sum(
                    len(dq) for dq in self._series.values()
                ),
                "timeseries_samples": self.samples_total,
                "timeseries_sources": len(self._sources),
                "timeseries_source_failures": self.source_failures,
                "timeseries_dropped_series": self.dropped_series,
                "timeseries_anomalies": self.anomalies_total,
                "timeseries_interval_s": self.interval_s,
                "timeseries_capacity": self.capacity,
                "timeseries_last_pass_ms": self.last_pass_ms,
            }


# ---------------------------------------------------------------------------
# Cluster trace join.
# ---------------------------------------------------------------------------

def cluster_spans(local_spans: List[dict],
                  member_spans: Dict[str, List[dict]],
                  max_spans: int = 4096) -> List[dict]:
    """Merge the local client recorder's spans with every scraped
    member's spans onto one timeline (everything is CLOCK_MONOTONIC us;
    same-host processes share the timebase — the loopback/bench case —
    and across hosts per-member deltas remain meaningful). Local spans
    are tagged ``member="local"`` unless a member already claimed them;
    output is start-ordered and bounded."""
    merged: List[dict] = []
    for s in local_spans:
        s = dict(s)
        s["attrs"] = {**s.get("attrs", {})}
        s["attrs"].setdefault("member", "local")
        merged.append(s)
    for member_id, spans in member_spans.items():
        for s in spans:
            s = dict(s)
            s["attrs"] = {**s.get("attrs", {})}
            s["attrs"].setdefault("member", member_id)
            merged.append(s)
    merged.sort(key=lambda s: s.get("start_us", 0))
    return merged[-max_spans:]


def cluster_chrome_events(spans: List[dict]) -> List[dict]:
    """Chrome trace events for a cluster-joined span list with ONE
    Perfetto track lane (pid) per member — ``local`` (the client
    recorder) first, then members in first-seen order — plus process_name
    metadata events so Perfetto labels the lanes."""
    lanes: Dict[str, int] = {}
    events: List[dict] = []
    for s in spans:
        member = str(s.get("attrs", {}).get("member", "local"))
        pid = lanes.setdefault(member, len(lanes))
        for e in tracing.chrome_trace_events([s]):
            e["pid"] = pid
            events.append(e)
    for member, pid in lanes.items():
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "ts": 0, "args": {"name": f"member:{member}"},
        })
    return events


# ---------------------------------------------------------------------------
# Process-wide singletons + transition-site helpers.
# ---------------------------------------------------------------------------

_journal = EventJournal()
_slo: Optional[SloEngine] = None
_qos_storm = _StormDetector()
_lock = threading.Lock()


def get_journal() -> EventJournal:
    """The process-wide event journal (always on; events are rare)."""
    return _journal


def emit(kind: str, member: str = "", epoch: int = 0,
         trace_id: Optional[int] = None, **attrs) -> dict:
    """Emit into the process journal (see :meth:`EventJournal.emit`)."""
    return _journal.emit(
        kind, member=member, epoch=epoch, trace_id=trace_id, **attrs
    )


def slo_engine() -> SloEngine:
    """The process-wide SLO engine (default objectives), built lazily so
    importing the package costs nothing."""
    global _slo
    if _slo is None:
        # Audited: O(1) double-checked singleton init — held only for one
        # constructor call, never across IO.
        with _lock:  # its: allow[ITS-L003]
            if _slo is None:
                _slo = SloEngine(journal=_journal)
    return _slo


def configure_slo(engine: Optional[SloEngine]) -> SloEngine:
    """Install a custom engine (tests, bench legs with short windows);
    ``None`` rebuilds the default lazily."""
    global _slo
    _slo = engine
    return slo_engine() if engine is None else engine


def note_qos_aged(n: int = 1, member: str = ""):
    """Transition-site helper for the QoS aging escape: counts toward the
    storm detector and emits ONE ``qos_aging_storm`` event per storm edge
    (docs/qos.md — aged slices are the starvation-proof pressure valve;
    a storm of them means background is systematically starved)."""
    count = _qos_storm.note(n)
    if count:
        _journal.emit("qos_aging_storm", member=member, aged_in_window=count,
                      window_s=_qos_storm.window_s)


def _on_slow_op(span) -> None:
    """Slow-op watchdog hook (registered with tracing at import): every
    watchdog capture lands in the journal with the span's own trace id,
    joining "this op was slow" to the breaker/membership/QoS events
    around it."""
    _journal.emit(
        "slow_op", trace_id=span.trace_id, span=span.name,
        duration_us=span.duration_us, status=span.status or "open",
    )


tracing.set_slow_op_hook(_on_slow_op)


def reset():
    """Test/bench hook: fresh journal contents, default SLO engine, and a
    re-armed storm detector (singleton identities are preserved — code
    that captured ``get_journal()`` keeps a live object)."""
    global _slo, _qos_storm
    _journal.clear()
    _slo = None
    _qos_storm = _StormDetector()
