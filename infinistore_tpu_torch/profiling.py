"""Continuous wall-clock sampling profiler: frame-level stage attribution.

Copy of ``infinistore_tpu/profiling.py`` for the PyTorch port, which imports
nothing of ``infinistore_tpu``; keep the two in step.

The trace stages say WHICH boundary-to-boundary interval an op's
latency lives in (``trace_frac_*`` — the receipt that scoped the
descriptor ring); they cannot say which FRAMES the time lands in inside
an interval. ROADMAP item 5 needs exactly that: deciding between CQ
busy-poll and eventfd arming requires knowing whether the
``last_slice -> completion_ring`` ~0.10 fraction is spent in the epoll
wait, the eventfd read, the asyncio wakeup machinery, or the Python
drain callback. This module is the always-available production
instrument that answers it (docs/observability.md, profiling section):

- A daemon **sampler thread** captures tracked threads' Python frames via
  ``sys._current_frames()`` at ``hz`` (default 101 — prime, so the rate
  cannot alias against millisecond-periodic work), collapses each stack
  into a bounded folded-stack bucket, and counts.
- **Stage attribution**: a thread -> active-span map is fed from
  ``tracing``'s bind hook (:func:`tracing.set_bind_hook` — one module
  slot, the ``set_slow_op_hook`` pattern), and every sample is tagged
  with the span's trace *stage interval*. Naming is by DESTINATION: a
  sample taken between the ``submit`` and ``completion_ring`` stamps
  tags ``completion_ring`` — it is time spent getting *to* that
  boundary, which is the interval the ROADMAP-5 receipt asks about.
  Samples are resolved retrospectively (a bounded pending queue drains
  once the span finishes or ``resolve_age_s`` passes), so a sample never
  guesses its interval from an incomplete stamp list.
- **Export**: folded-stack text (``stage;frame;...;leaf count`` — any
  flamegraph tool renders per-stage flames because the stage is the root
  frame), Chrome trace-event *sampling track* on the same CLOCK_MONOTONIC
  timeline as ``GET /trace`` (spans and stacks line up in Perfetto), and
  **differential profiles** against named saved snapshots
  (``GET /profile?save=a`` ... ``?diff=a``).

Off (the default) this module costs nothing: no thread, no tracing hook
registered, and every integration point checks one module bool
(``profiling.enabled()`` — the ``tracing.FlightRecorder`` discipline).
Opt-in per process with ``INFINISTORE_TPU_PROFILE=1`` (and
``INFINISTORE_TPU_PROFILE_HZ=<n>``) or ``profiling.configure(enabled=True)``.
The bench gates the enabled cost at <= 3% of batched-get wall time
(``prof_overhead_cost``, order-alternating paired estimator) and pins
stage attribution >= 90% under a traced workload
(``prof_stage_tag_fraction``, tools/bench_check.py).

The approximation to know about: the thread -> span map updates at
*bind* points (``tracing.bind_span`` / ``use_span`` / ``trace_op``), not
at asyncio task switches — an untraced task interleaving with a traced
one on the same loop can inherit the traced op's tag until the next
bind. Under the workloads the receipt runs (back-to-back traced ops)
the error is the inter-op gap, which the untagged counter makes visible.
"""

from __future__ import annotations

import os
import sys
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import tracing

_DEFAULT_HZ = 101.0
_UNTAGGED = "untagged"


class SamplingProfiler:
    """The sampler thread + bounded collapsed-stack aggregation.

    One instance per process (module singleton via :func:`configure`);
    tests build their own and drive :meth:`sample_once` deterministically.
    All shared state — the thread registry the tracing bind hook feeds
    from op threads, the pending/resolved sample stores the sampler
    thread owns, and the read-side snapshots — is guarded by one lock
    (ITS-R001); nothing here is per-op, so the lock is uncontended at
    sampling rates.
    """

    def __init__(self, hz: float = _DEFAULT_HZ,
                 max_buckets: int = 4096,
                 max_depth: int = 48,
                 recent_capacity: int = 2048,
                 pending_capacity: int = 4096,
                 resolve_age_s: float = 1.0,
                 max_snapshots: int = 8):
        if hz <= 0:
            raise ValueError("hz must be > 0")
        self.hz = float(hz)
        self.max_buckets = max_buckets
        self.max_depth = max_depth
        self.pending_capacity = pending_capacity
        self.resolve_age_s = resolve_age_s
        self.max_snapshots = max_snapshots
        self._lock = threading.Lock()
        # its: guard[_threads, _thread_spans: _lock]
        self._threads: Dict[int, str] = {}       # tid -> display name
        self._thread_spans: Dict[int, object] = {}  # tid -> active Span|None
        # its: guard[_buckets, _pending, _recent, _snapshots: _lock]
        self._buckets: Dict[Tuple[str, str], int] = {}  # (stage, stack) -> n
        self._pending: deque = deque()  # (t_us, tid, span, stack)
        self._recent: deque = deque(maxlen=recent_capacity)
        self._snapshots: Dict[str, dict] = {}  # name -> {buckets, samples}
        # its: guard[samples_total, tagged_samples, pending_drops, bucket_drops: _lock]
        self.samples_total = 0
        self.tagged_samples = 0
        self.pending_drops = 0   # samples dropped by a full pending queue
        self.bucket_drops = 0    # samples folded into the ~overflow bucket
        # Self-accounting for the duty-cycle receipt (the bench's direct
        # overhead bound): sampler ticks run and wall microseconds spent
        # inside them.
        # its: guard[ticks_total, tick_us_total: _lock]
        self.ticks_total = 0
        self.tick_us_total = 0
        # Label cache: code object -> "file:qualname". Keyed by the code
        # object itself (not id() — ids get recycled); code objects are
        # module-lifetime constants, so the cache is naturally bounded by
        # the loaded code. Sampler-thread-only after construction.
        self._labels: Dict[object, str] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- thread registry (fed by the tracing bind hook) ----------------------

    def track_thread(self, ident: Optional[int] = None, name: str = ""):
        """Register a thread for sampling (the bind hook auto-registers any
        thread that binds a span; call this for threads worth profiling
        that never trace — e.g. a worker pool)."""
        tid = threading.get_ident() if ident is None else ident
        with self._lock:
            self._threads.setdefault(
                tid, name or threading.current_thread().name
            )

    def _on_bind(self, span) -> None:
        """tracing bind hook: the calling thread's active span changed.
        Runs on op/loop threads — one dict store under the lock."""
        tid = threading.get_ident()
        with self._lock:
            if tid not in self._threads:
                self._threads[tid] = threading.current_thread().name
            self._thread_spans[tid] = span

    # -- sampling ------------------------------------------------------------

    def _label(self, code) -> str:
        lab = self._labels.get(code)
        if lab is None:
            fname = code.co_filename.rsplit("/", 1)[-1]
            lab = f"{fname}:{code.co_name}"
            self._labels[code] = lab
        return lab

    def _collapse(self, frame) -> str:
        """Root-first folded stack ("a;b;leaf"), bounded at max_depth
        (deep recursions keep the LEAF end — the interesting half)."""
        parts: List[str] = []
        while frame is not None and len(parts) < self.max_depth:
            parts.append(self._label(frame.f_code))
            frame = frame.f_back
        parts.reverse()
        return ";".join(parts)

    def sample_once(self) -> int:
        """Capture one sample of every tracked thread; returns how many
        stacks were captured. The sampler thread calls this at ``hz``;
        tests call it directly for determinism."""
        frames = sys._current_frames()
        now_us = tracing._now_us()
        own = threading.get_ident()
        with self._lock:
            tracked = list(self._threads)
            spans = dict(self._thread_spans)
        captured = []
        live = set(frames)
        for tid in tracked:
            if tid == own:
                continue
            frame = frames.get(tid)
            if frame is None:
                continue  # thread exited; registry is lazily scrubbed below
            captured.append((now_us, tid, spans.get(tid),
                             self._collapse(frame)))
        del frames  # drop the frame references before any lock wait
        with self._lock:
            for tid in tracked:
                if tid != own and tid not in live:
                    self._threads.pop(tid, None)
                    self._thread_spans.pop(tid, None)
            for sample in captured:
                if len(self._pending) >= self.pending_capacity:
                    self.pending_drops += 1
                    self._resolve_one_locked(self._pending.popleft(),
                                             force=True)
                self._pending.append(sample)
            self._resolve_locked(now_us)
        return len(captured)

    # -- stage resolution ----------------------------------------------------

    def _stage_of(self, span, t_us: int, force: bool) -> Optional[str]:
        """Destination-named stage interval for a sample at ``t_us``:
        the first stage stamp at-or-after the sample. ``None`` = cannot
        resolve yet (span still open with no later stamp); ``force``
        resolves anyway with the trailing interval."""
        if span is None:
            return _UNTAGGED
        stages = span.stages  # append-only under the GIL; safe to iterate
        for name, ts in list(stages):
            if ts >= t_us:
                return name
        if span.status or force:
            # Past the last stamp: the op's trailing interval (finish
            # bookkeeping) books under the last boundary it crossed.
            return stages[-1][0] if stages else _UNTAGGED
        return None

    def _resolve_one_locked(self, sample, force: bool = False) -> bool:
        # its: requires[_lock]
        t_us, tid, span, stack = sample
        stage = self._stage_of(span, t_us, force)
        if stage is None:
            return False
        self.samples_total += 1
        if stage != _UNTAGGED:
            self.tagged_samples += 1
        key = (stage, stack)
        if key not in self._buckets and len(self._buckets) >= self.max_buckets:
            key = (stage, "~overflow")
            self.bucket_drops += 1
        self._buckets[key] = self._buckets.get(key, 0) + 1
        self._recent.append({
            "t_us": t_us,
            "tid": tid,
            "stage": stage,
            "trace_id": span.trace_id if span is not None else 0,
            "stack": stack,
        })
        return True

    def _resolve_locked(self, now_us: int):  # its: requires[_lock]
        horizon = now_us - int(self.resolve_age_s * 1e6)
        while self._pending:
            sample = self._pending[0]
            if not self._resolve_one_locked(sample,
                                            force=sample[0] <= horizon):
                break
            self._pending.popleft()

    def flush(self):
        """Resolve every pending sample that CAN be resolved — finished
        spans at any age, and samples older than ``resolve_age_s`` (the
        trailing-interval fallback). A young sample of a still-OPEN span
        stays pending: under destination naming its interval is decided
        by a stamp that has not happened yet, and a read-side scrape
        (``GET /profile`` mid-workload) must not guess it one boundary
        early."""
        now_us = tracing._now_us()
        horizon = now_us - int(self.resolve_age_s * 1e6)
        with self._lock:
            keep: deque = deque()
            while self._pending:
                sample = self._pending.popleft()
                if not self._resolve_one_locked(sample,
                                                force=sample[0] <= horizon):
                    keep.append(sample)
            self._pending = keep

    # -- background loop -----------------------------------------------------

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="its-profiler", daemon=True
        )
        self._thread.start()

    def _loop(self):
        period = 1.0 / self.hz
        while not self._stop.wait(period):
            try:
                t0 = tracing._now_us()
                self.sample_once()
                dt = tracing._now_us() - t0
                with self._lock:
                    self.ticks_total += 1
                    self.tick_us_total += dt
            except Exception:
                # One weird frame walk must never kill the sampler; the
                # missing tick is visible as a rate dip, not a crash.
                pass

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    # -- read side -----------------------------------------------------------

    def buckets(self) -> Dict[Tuple[str, str], int]:
        self.flush()
        with self._lock:
            return dict(self._buckets)

    def folded(self) -> str:
        """Folded-stack text: one ``stage;frame;...;leaf count`` line per
        bucket, stage as the root frame — flamegraph.pl / speedscope /
        Perfetto's folded importer render per-stage flames directly."""
        return "\n".join(
            f"{stage};{stack} {count}" if stack else f"{stage} {count}"
            for (stage, stack), count in sorted(self.buckets().items())
        )

    def stage_counts(self) -> Dict[str, int]:
        """Samples per stage interval (the coarse attribution the bench's
        ``prof_stage_tag_fraction`` receipt is computed from)."""
        out: Dict[str, int] = {}
        for (stage, _), count in self.buckets().items():
            out[stage] = out.get(stage, 0) + count
        return out

    def recent_samples(self) -> List[dict]:
        self.flush()
        with self._lock:
            return [dict(s) for s in self._recent]

    def chrome_events(self) -> List[dict]:
        """Chrome trace-event objects for the retained recent samples: one
        instant event per sample on a dedicated sampling track (pid 2 —
        the /trace export uses 0 for client spans, 1 for server ticks),
        stamped on the same CLOCK_MONOTONIC microsecond timeline, so
        loading /profile?fmt=chrome next to /trace?fmt=chrome lines the
        stacks up under the spans."""
        events: List[dict] = [{
            "name": "process_name", "ph": "M", "pid": 2, "tid": 0, "ts": 0,
            "args": {"name": "sampling-profiler"},
        }]
        for s in self.recent_samples():
            leaf = s["stack"].rsplit(";", 1)[-1] if s["stack"] else "?"
            events.append({
                "name": leaf,
                "cat": "sample",
                "ph": "i",
                "s": "t",
                "ts": s["t_us"],
                "pid": 2,
                "tid": s["tid"] % 100000,
                "args": {
                    "stage": s["stage"],
                    "stack": s["stack"],
                    "trace_id": f"{s['trace_id']:#x}",
                },
            })
        return events

    # -- snapshots + differential profiles -----------------------------------

    def snapshot_save(self, name: str) -> dict:
        """Save the current aggregate under ``name`` (bounded: oldest
        evicted past ``max_snapshots``) — the base of a later ``?diff=``."""
        buckets = self.buckets()
        snap = {"buckets": buckets, "samples": sum(buckets.values())}
        with self._lock:
            self._snapshots[name] = snap
            while len(self._snapshots) > self.max_snapshots:
                self._snapshots.pop(next(iter(self._snapshots)))
        return {"name": name, "samples": snap["samples"],
                "buckets": len(buckets)}

    def snapshot_names(self) -> List[str]:
        with self._lock:
            return list(self._snapshots)

    def diff(self, name: str) -> Optional[dict]:
        """Differential profile vs saved snapshot ``name``: per-bucket
        count deltas (zeros omitted; negative = only plausible after a
        clear). None when the snapshot does not exist."""
        with self._lock:
            snap = self._snapshots.get(name)
        if snap is None:
            return None
        cur = self.buckets()
        base = snap["buckets"]
        delta_lines = []
        for key in sorted(set(cur) | set(base)):
            d = cur.get(key, 0) - base.get(key, 0)
            if d == 0:
                continue
            stage, stack = key
            line = f"{stage};{stack}" if stack else stage
            delta_lines.append(f"{line} {d}")
        return {
            "base": name,
            "base_samples": snap["samples"],
            "samples": sum(cur.values()),
            "samples_delta": sum(cur.values()) - snap["samples"],
            "folded_delta": "\n".join(delta_lines),
        }

    def clear(self):
        with self._lock:
            self._buckets = {}
            self._pending.clear()
            self._recent.clear()
            self.samples_total = 0
            self.tagged_samples = 0
            self.pending_drops = 0
            self.bucket_drops = 0
            self.ticks_total = 0
            self.tick_us_total = 0

    def status(self) -> dict:
        """Flat ``prof_*`` snapshot for ``GET /profile`` headers and the
        ``infinistore_prof_*`` /metrics families — held in lockstep with
        ``server._prof_prometheus_lines`` and docs/observability.md by
        ITS-C008 (tools/analysis/counters.py).

        Keys: ``prof_samples`` (resolved samples), ``prof_tagged_samples``
        (carrying a stage interval), ``prof_threads`` (tracked),
        ``prof_buckets`` (distinct collapsed stacks),
        ``prof_bucket_drops`` (folded into the overflow bucket),
        ``prof_pending`` (awaiting stage resolution),
        ``prof_pending_drops`` (force-resolved by a full queue),
        ``prof_snapshots`` (saved diff bases), ``prof_hz``,
        ``prof_ticks`` (sampler passes run) and ``prof_tick_us`` (wall
        microseconds spent inside them — ``prof_tick_us / prof_ticks *
        prof_hz`` is the sampler's duty cycle, the direct overhead
        bound the bench receipt reports)."""
        with self._lock:
            return {
                "prof_samples": self.samples_total,
                "prof_tagged_samples": self.tagged_samples,
                "prof_threads": len(self._threads),
                "prof_buckets": len(self._buckets),
                "prof_bucket_drops": self.bucket_drops,
                "prof_pending": len(self._pending),
                "prof_pending_drops": self.pending_drops,
                "prof_snapshots": len(self._snapshots),
                "prof_hz": self.hz,
                "prof_ticks": self.ticks_total,
                "prof_tick_us": self.tick_us_total,
            }


# ---------------------------------------------------------------------------
# Process-wide singleton + env opt-in (the tracing.configure discipline).
# ---------------------------------------------------------------------------

# The off fast path: one module-global bool at every integration site.
_ENABLED = False
_profiler: Optional[SamplingProfiler] = None


def enabled() -> bool:
    return _ENABLED


def profiler() -> Optional[SamplingProfiler]:
    """The process profiler — kept (with its data) after ``enabled=False``
    so ``GET /profile`` still answers post-mortem, like the flight
    recorder."""
    return _profiler


def configure(enabled: Optional[bool] = None,
              hz: Optional[float] = None) -> Optional[SamplingProfiler]:
    """(Re)configure process-wide profiling; returns the active profiler.

    A fresh :class:`SamplingProfiler` is built when ``hz`` is given or
    when enabling with none yet; toggling ``enabled`` alone keeps the
    existing profiler and its buckets (``enabled=False`` stops the
    sampler thread and unhooks tracing but preserves the data for
    post-mortem reads; a bare ``enabled=True`` resumes into it)."""
    global _ENABLED, _profiler
    if enabled is not None:
        _ENABLED = bool(enabled)
    if hz is not None or (_ENABLED and _profiler is None):
        if _profiler is not None:
            _profiler.stop()
        _profiler = SamplingProfiler(hz=hz if hz is not None else _DEFAULT_HZ)
    if _profiler is not None:
        if _ENABLED:
            tracing.set_bind_hook(_profiler._on_bind)
            _profiler.track_thread()  # the configuring thread is of interest
            _profiler.start()
        else:
            tracing.set_bind_hook(None)
            _profiler.stop()
    return _profiler


if os.environ.get("INFINISTORE_TPU_PROFILE", "") not in ("", "0"):
    configure(
        enabled=True,
        hz=float(os.environ.get("INFINISTORE_TPU_PROFILE_HZ", "0") or 0)
        or None,
    )
