"""End-to-end op tracing: spans, the flight recorder, and trace export.

The PyTorch port's tracing module, which imports nothing of
``infinistore_tpu``. Its vocabulary extends the reference's: besides the
store-op stages below, the engine, the KV writer and the store client open
phase spans (``SPAN_NAMES``), whose stamps follow the store-op stages in
``STAGES``.

One op crosses six subsystems (engine prefetch -> coalescer -> cluster
routing -> striped scheduler -> async bridge -> server reactor), and until
this module the only observability was aggregate counters — the BENCH_r05
loopback gap and the PR-4 450us-e2e-vs-31us-server QoS tail were both
diagnosed with hand-built one-off experiments because nothing attributed
latency to stages. This module makes that attribution first-class:

- A per-op **trace context** (u64 trace id + parent span id) that rides the
  wire as a trailing optional extension after the QoS priority byte
  (``wire.BatchMeta``/``SegBatchMeta`` ``trace_id``/``trace_parent``;
  untagged ops stay byte-identical to the pre-trace format, the same
  scheme the QoS priority byte used).
- **Spans** with stage timestamps: each producer stamps the STAGES vocabulary
  below at the moment the op crosses that boundary. Client stages land
  here; the server reactor stamps ``server_recv``/``first_slice``/
  ``last_slice`` ticks into a parallel native ring exposed through
  ``stats_json()["trace"]`` and joined to client spans by trace id.
- A bounded, lock-cheap **flight recorder** ring per process. With tracing
  off (the default) every hook compiles down to one module-bool check and
  the wire bytes are untouched.
- A **slow-op watchdog**: any span whose wall time exceeds
  ``slow_op_us`` is captured — with its full child-span tree — into a
  separate protected buffer that ring wrap-around cannot evict, and
  counted in ``slow_ops_total`` (exported as
  ``infinistore_trace_slow_ops_total``).
- **Chrome trace-event export** (``chrome_trace_events``): the manage
  plane's ``GET /trace?fmt=chrome`` output loads directly in Perfetto.

The stage vocabulary (the ITS-T checker holds every producer, the /trace
schema and docs/observability.md to this tuple, in lockstep):

- ``enqueue``         request entered the engine (admission t0)
- ``fetch_start``     connector began streaming the hit prefix
- ``coalesce``        submission merged into a batched store call
- ``stripe_claim``    striped scheduler claimed a span for a stripe
- ``submit``          batched op handed to the native client
- ``server_recv``     server reactor finished reading the request [native]
- ``first_slice``     first payload/slice unit of server work     [native]
- ``last_slice``      last payload/slice unit of server work      [native]
- ``completion_ring`` completion drained from the native ring
- ``install``         bytes installed into the engine's paged cache

The phase spans (``SPAN_NAMES``; docs/observability.md, "The port's phase
spans"):

- ``engine_request``  one request, enqueue to return; stamps ``enqueue``,
  ``install``, ``prefix_ready`` (the prompt resident) and one ``token`` per
  generated token, taken once the token is on the host
- ``engine.gate``     a request for the device gate (attr ``kind``), opened
  at the request, ``acquire`` when granted, closed at release
- ``engine.fetch``    the gate-free prefetch: start_fetch to primed()
- ``engine.install``  the install under the gate; ``staged`` when the last
  layer it waited for had landed in host staging
- ``engine.save``     a save of blocks (attr ``path``: ``ttft`` before the
  first token, ``response`` after the answer)
- ``model.prefill``, ``model.resume``  a model call and its sync
- ``model.wave``      one decode wave (a root span; attrs name its rows'
  requests); stamps ``take``, ``acquire``, ``launched``
- ``loop.block``      the event-loop thread blocked on the device (a copy
  or a CUDA call; attr ``what``: ``d2h``, ``h2d``, ``token``)
- ``store.<op>``      one wire op of the store client, opened when it asks
  for its turn on the wire; ``submit`` and ``completion_ring`` once each.
  Its span id rides the wire, so the server's ticks join to it.

Clocks: every stamp (Python and native) is CLOCK_MONOTONIC microseconds
(:func:`now_us`), so same-host client and server ticks share a timebase and
merge into one timeline; across hosts only within-process deltas are
meaningful. :func:`perf_counter_offset_s` maps a stamp onto
``time.perf_counter`` (the clock host-side profilers and benchmarks read):
``perf_counter = t_us / 1e6 + offset``.
"""

import contextlib
import contextvars
import itertools
import os
import threading
import time
from typing import Dict, List, Optional

# Canonical stage vocabulary, in pipeline order. Producers may stamp any
# subset (a sync op has no completion_ring; an uncoalesced op no coalesce);
# consumers order by timestamp. The ITS-T checker (tools/analysis/
# trace_stages.py) fails the build when a producer stamps a name outside
# this tuple or when the tuple drifts from docs/observability.md and the
# /trace schema.
STAGES = (
    "enqueue",
    "fetch_start",
    "coalesce",
    "stripe_claim",
    "submit",
    "server_recv",
    "first_slice",
    "last_slice",
    "completion_ring",
    "install",
) + (
    # The port's phase stamps (SPAN_NAMES' spans), after the store-op stages.
    "take",
    "acquire",
    "launched",
    "staged",
    "prefix_ready",
    "token",
)

# Names of the port's phase spans (module docstring); a store op's span is
# ``store.`` + its op name.
SPAN_NAMES = (
    "engine_request",
    "engine.gate",
    "engine.fetch",
    "engine.install",
    "engine.save",
    "model.prefill",
    "model.resume",
    "model.wave",
    "loop.block",
    "store.write_cache",
    "store.read_cache",
)

# Stages stamped by the NATIVE server reactor: stats_json()["trace"] tick
# field -> stage name. The /trace endpoint uses this to join server ticks
# into the client span timeline; the ITS-T checker pins the values to
# STAGES.
SERVER_TICK_STAGES = {
    "recv_us": "server_recv",
    "first_slice_us": "first_slice",
    "last_slice_us": "last_slice",
}

_DEFAULT_CAPACITY = 512
_DEFAULT_SLOW_CAPACITY = 64

# The off fast path: one module-global bool guard at every hook site. A
# disabled process pays a dict-free, lock-free attribute read per op.
_ENABLED = False

_ids = itertools.count(1)
_seed = None  # os-random high bits mixed into trace ids (collision guard)


def now_us() -> int:
    """CLOCK_MONOTONIC microseconds — the same clock the native reactor
    stamps (server.cpp now_us), so same-host ticks merge directly."""
    return time.monotonic_ns() // 1000


_now_us = now_us


def perf_counter_offset_s(samples: int = 7) -> float:
    """Seconds to add to ``now_us() / 1e6`` to land on ``time.perf_counter``:
    of ``samples`` reads of the monotonic clock, each bracketed by two
    perf_counter reads, the one with the tightest bracket. On Linux both
    read CLOCK_MONOTONIC and the offset is 0 within a microsecond;
    elsewhere it is the distance between the two clocks' origins."""
    best = None
    for _ in range(samples):
        a = time.perf_counter()
        m = time.monotonic_ns()
        b = time.perf_counter()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) / 2 - m / 1e9)
    return best[1]


_perf_offset_s: Optional[float] = None


def us_of_perf(t: float) -> int:
    """A ``time.perf_counter`` reading as a stamp on :func:`now_us`'s
    clock (the offset is measured once per process)."""
    global _perf_offset_s
    if _perf_offset_s is None:
        _perf_offset_s = perf_counter_offset_s()
    return int(round((t - _perf_offset_s) * 1e6))


def _new_id() -> int:
    """Process-unique, never-zero u64 (zero = 'untraced' on the wire):
    os-random high bits + a process-local counter."""
    global _seed
    if _seed is None:
        _seed = int.from_bytes(os.urandom(4), "little") or 1
    return ((_seed << 24) ^ next(_ids)) & 0xFFFFFFFFFFFFFFFF or 1


class Span:
    """One traced operation: a bag of (stage, t_us) stamps plus identity.

    Spans are cheap and lock-free to stamp (list append under the GIL);
    they are published to the flight recorder only at :meth:`finish`.
    ``parent_id`` links child spans (striped chunk ops, coalesced group
    members) into the tree the slow-op watchdog captures whole.
    """

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "t0_us", "t1_us",
        "stages", "status", "attrs",
    )

    def __init__(self, name: str, trace_id: Optional[int] = None,
                 parent_id: int = 0):
        self.name = name
        self.trace_id = trace_id if trace_id else _new_id()
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.t0_us = _now_us()
        self.t1_us = 0
        self.stages: List = []  # [(stage_name, t_us), ...] append-only
        self.status = ""  # "" = open; "ok" / "error:<Type>" once finished
        self.attrs: Dict = {}

    def stage(self, name: str, t_us: Optional[int] = None):
        """Stamp one stage boundary NOW (or at ``t_us``, a stamp on
        :func:`now_us`'s clock taken earlier). Repeats are legal (one
        ``token`` per generated token); :meth:`stage_ts` reads the first."""
        self.stages.append((name, _now_us() if t_us is None else t_us))

    def annotate(self, **attrs):
        """Attach routing/context attributes (member index, stripe, bytes)."""
        self.attrs.update(attrs)

    @property
    def duration_us(self) -> int:
        end = self.t1_us or _now_us()
        return max(0, end - self.t0_us)

    def stage_ts(self, name: str) -> Optional[int]:
        """First timestamp recorded for ``name`` (None when never stamped)."""
        for stage, ts in self.stages:
            if stage == name:
                return ts
        return None

    def finish(self, status: str = "ok"):
        """Close the span and publish it to the flight recorder (idempotent:
        only the first finish records)."""
        if self.status:
            return
        self.status = status
        self.t1_us = _now_us()
        rec = _recorder
        if rec is not None:
            rec.record(self)

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_us": self.t0_us,
            "end_us": self.t1_us,
            "duration_us": self.duration_us,
            "status": self.status or "open",
            "stages": [[s, t] for s, t in self.stages],
            "attrs": dict(self.attrs),
        }


class FlightRecorder:
    """Bounded ring of finished spans + a protected slow-op buffer.

    The hot path (``record``) is one lock-guarded index bump and slot
    store — no allocation, no scan. The slow-op watchdog runs inside the
    same record call: a span slower than ``slow_op_us`` is copied (with
    every already-recorded span of its trace — the full tree) into
    ``slow``, a smaller buffer ring wrap-around cannot touch, and
    ``slow_ops_total`` increments (``infinistore_trace_slow_ops_total``).
    """

    def __init__(self, capacity: int = _DEFAULT_CAPACITY,
                 slow_op_us: int = 0,
                 slow_capacity: int = _DEFAULT_SLOW_CAPACITY):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.slow_op_us = slow_op_us  # 0 = watchdog off
        self.slow_capacity = max(1, slow_capacity)
        # its: cross-thread  (spans finish on loop, engine and worker
        # threads alike; the manage plane snapshots)
        # its: guard[_slots, _next, _slow: _lock]
        self._slots: List[Optional[Span]] = [None] * capacity
        self._next = 0  # monotone: total spans ever recorded
        self._slow: List[dict] = []
        self._lock = threading.Lock()
        # its: guard[recorded, dropped, slow_ops_total: _lock!w]
        self.recorded = 0
        self.dropped = 0  # spans a full ring overwrote
        self.slow_ops_total = 0

    def record(self, span: Span):
        slow = False
        with self._lock:
            idx = self._next % self.capacity
            if self._next >= self.capacity:
                self.dropped += 1
            self._slots[idx] = span
            self._next += 1
            self.recorded += 1
            if self.slow_op_us and span.duration_us >= self.slow_op_us:
                self._capture_slow_locked(span)
                slow = True
        if slow:
            # Outside the (non-reentrant) ring lock: a hook that itself
            # records or finishes a span must not deadlock the recorder.
            hook = _slow_op_hook
            if hook is not None:
                try:
                    hook(span)
                except Exception:
                    # A listener (the telemetry journal) must never be able
                    # to fail the recording hot path.
                    pass

    def _capture_slow_locked(self, span: Span):  # its: requires[_lock]
        self.slow_ops_total += 1
        tree = [s.as_dict() for s in self._slots
                if s is not None and s.trace_id == span.trace_id]
        self._slow.append({
            "trace_id": span.trace_id,
            "root": span.as_dict(),
            "spans": tree,
        })
        if len(self._slow) > self.slow_capacity:
            del self._slow[: len(self._slow) - self.slow_capacity]

    def snapshot(self) -> List[dict]:
        """Recorded spans, oldest first (at most ``capacity``)."""
        with self._lock:
            start = max(0, self._next - self.capacity)
            return [
                self._slots[i % self.capacity].as_dict()
                for i in range(start, self._next)
                if self._slots[i % self.capacity] is not None
            ]

    def slow_snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._slow)

    def clear(self):
        with self._lock:
            self._slots = [None] * self.capacity
            self._next = 0
            self._slow = []


_recorder: Optional[FlightRecorder] = None
_current: contextvars.ContextVar = contextvars.ContextVar(
    "its_trace_span", default=None
)

# Slow-op listener (telemetry.py registers the event journal here at
# import). A plain module slot, not a list: exactly one fleet-telemetry
# plane per process, and tracing must not import telemetry (telemetry
# imports tracing).
_slow_op_hook = None


def set_slow_op_hook(cb) -> None:
    """Register ``cb(span)`` to run on every slow-op watchdog capture
    (``None`` unregisters). Exceptions from the hook are swallowed — it
    observes the recorder, it cannot fail it."""
    global _slow_op_hook
    _slow_op_hook = cb


# Span-bind listener (profiling.py registers the sampling profiler's
# thread->span map feed here). Same single-slot pattern as the slow-op
# hook and for the same reason: profiling imports tracing, not the
# reverse. Called with the NEW active span (or None) after every bind/
# unbind on the calling thread; with no profiler the cost is one None
# check per bind — and binds only happen on traced ops.
_bind_hook = None


def set_bind_hook(cb) -> None:
    """Register ``cb(span_or_none)`` to observe active-span changes on
    whatever thread performs them (``None`` unregisters). Exceptions are
    swallowed — an observer cannot fail the traced op."""
    global _bind_hook
    _bind_hook = cb


def _notify_bind():
    hook = _bind_hook
    if hook is not None:
        try:
            hook(_current.get())
        except Exception:
            pass


def configure(enabled: Optional[bool] = None,
              capacity: Optional[int] = None,
              slow_op_us: Optional[int] = None) -> Optional[FlightRecorder]:
    """(Re)configure process-wide tracing; returns the active recorder.

    A FRESH :class:`FlightRecorder` is built whenever ``capacity`` or
    ``slow_op_us`` is given (even while disabled — the sizing takes
    effect, it just records nothing until enabled), or when tracing is
    enabled with no recorder yet. Toggling ``enabled`` ALONE keeps the
    existing recorder and its contents: ``enabled=False`` preserves it
    for post-mortem reads (``GET /trace`` after the incident), and a
    bare ``enabled=True`` resumes recording into it. ``slow_op_us=0``
    disables the watchdog.
    """
    global _ENABLED, _recorder
    if enabled is not None:
        _ENABLED = bool(enabled)
    if (
        capacity is not None or slow_op_us is not None
        or (_ENABLED and _recorder is None)
    ):
        cap = capacity if capacity is not None else (
            _recorder.capacity if _recorder else _DEFAULT_CAPACITY
        )
        slow = slow_op_us if slow_op_us is not None else (
            _recorder.slow_op_us if _recorder else 0
        )
        _recorder = FlightRecorder(capacity=cap, slow_op_us=slow)
    return _recorder


def enabled() -> bool:
    """The one-instruction guard every hook site checks first."""
    return _ENABLED


# Operator opt-in without code changes (e.g. to light up GET /trace on a
# running server deployment): INFINISTORE_TPU_TRACE=1 enables at import,
# INFINISTORE_TPU_TRACE_SLOW_US arms the watchdog threshold.
if os.environ.get("INFINISTORE_TPU_TRACE", "") not in ("", "0"):
    configure(
        enabled=True,
        slow_op_us=int(os.environ.get("INFINISTORE_TPU_TRACE_SLOW_US", "0") or 0),
    )


def recorder() -> Optional[FlightRecorder]:
    return _recorder


def active_span() -> Optional[Span]:
    """The span bound to the current (task) context, or None. Costs one
    bool check when tracing is off."""
    if not _ENABLED:
        return None
    return _current.get()


def start_span(name: str, parent: Optional[Span] = None,
               root: bool = False) -> Optional[Span]:
    """New span (child of ``parent`` when given, else of the active span;
    a trace of its own with ``root``); None when tracing is off. The caller
    owns finish()."""
    if not _ENABLED:
        return None
    if root:
        return Span(name)
    if parent is None:
        parent = _current.get()
    if parent is not None:
        return Span(name, trace_id=parent.trace_id, parent_id=parent.span_id)
    return Span(name)


@contextlib.contextmanager
def use_span(span: Optional[Span]):
    """Bind ``span`` as the context's active span for the with-body (no-op
    for None, so call sites stay unconditional)."""
    if span is None:
        yield None
        return
    token = _current.set(span)
    _notify_bind()
    try:
        yield span
    finally:
        _current.reset(token)
        _notify_bind()


@contextlib.contextmanager
def override_span(span: Optional[Span]):
    """Like :func:`use_span`, but ``None`` CLEARS any inherited binding for
    the with-body instead of no-op'ing. For code issuing work on behalf of
    several submitters (the fetch coalescer): a task inherits its
    scheduler's contextvars, so an untraced merged op would otherwise ride
    — and stamp — an unrelated submitter's span."""
    if not _ENABLED:
        yield span
        return
    token = _current.set(span)
    _notify_bind()
    try:
        yield span
    finally:
        _current.reset(token)
        _notify_bind()


def bind_span(span: Optional[Span]):
    """Non-contextmanager form of :func:`use_span` for call sites whose
    span outlives one lexical block (e.g. an engine request coroutine):
    returns the reset token to hand back to :func:`unbind_span` (None for
    an untraced op)."""
    if span is None:
        return None
    token = _current.set(span)
    _notify_bind()
    return token


def unbind_span(token):
    if token is not None:
        _current.reset(token)
        _notify_bind()


@contextlib.contextmanager
def trace_op(name: str, stage: Optional[str] = None):
    """Span-per-operation context manager: opens a span (child of any
    active one), binds it, optionally stamps ``stage`` on entry, and
    finishes it with ``ok`` or ``error:<Type>`` — so an op that dies on a
    tripped circuit breaker still closes its span with an error status.
    Yields None (and costs one bool check) when tracing is off."""
    span = start_span(name)
    if span is None:
        yield None
        return
    if stage is not None:
        span.stage(stage)
    token = _current.set(span)
    _notify_bind()
    try:
        yield span
    except BaseException as e:
        span.finish(status=f"error:{type(e).__name__}")
        raise
    finally:
        _current.reset(token)
        _notify_bind()
        span.finish()


def wire_ids(span: Optional[Span]):
    """(trace_id, span_id) to put on the wire for this op — (0, 0) when
    untraced, which encodes as ZERO extra wire bytes."""
    if span is None:
        return 0, 0
    return span.trace_id, span.span_id


# ---------------------------------------------------------------------------
# Export: /trace JSON + Chrome trace-event format (Perfetto-loadable).
# ---------------------------------------------------------------------------

def server_tick_spans(server_trace: dict) -> List[dict]:
    """Convert the native reactor's trace ring (``stats_json()["trace"]``)
    into span dicts on the shared stage vocabulary, joinable to client
    spans by trace id. Every tick field is consumed by name here — the
    counters checker (ITS-C001) holds the native ring's key vocabulary to
    this function, so a tick the exporter cannot see fails the build."""
    out = []
    server_trace = server_trace or {}
    entries = server_trace.get("entries", [])
    for e in entries:
        stages = []
        if e.get("recv_us"):
            stages.append([SERVER_TICK_STAGES["recv_us"], e["recv_us"]])
        if e.get("first_slice_us"):
            stages.append(
                [SERVER_TICK_STAGES["first_slice_us"], e["first_slice_us"]]
            )
        if e.get("last_slice_us"):
            stages.append(
                [SERVER_TICK_STAGES["last_slice_us"], e["last_slice_us"]]
            )
        out.append({
            "name": f"server:{e.get('op', '?')}",
            "trace_id": e.get("trace_id", 0),
            "span_id": 0,
            "parent_id": e.get("parent_id", 0),
            "start_us": e.get("recv_us", 0),
            "end_us": e.get("done_us", 0),
            "duration_us": max(
                0, e.get("done_us", 0) - e.get("recv_us", 0)
            ),
            "status": "ok" if e.get("ok", 1) else "error",
            "stages": stages,
            "attrs": {"bytes": e.get("bytes", 0), "prio": e.get("prio", 0),
                      "side": "server"},
        })
    return out


def chrome_trace_events(spans: List[dict]) -> List[dict]:
    """Chrome trace-event objects (the ``traceEvents`` array) for a list of
    span dicts: one complete ("X") event per span on a per-trace track,
    plus an instant ("i") event per stage stamp. ``chrome://tracing`` and
    Perfetto load ``{"traceEvents": [...], "displayTimeUnit": "ns"}``
    directly."""
    events = []
    for s in spans:
        tid = s.get("trace_id", 0) % 100000
        pid = 1 if s.get("attrs", {}).get("side") == "server" else 0
        end = s.get("end_us") or s.get("start_us", 0)
        events.append({
            "name": s.get("name", "op"),
            "cat": "infinistore",
            "ph": "X",
            "ts": s.get("start_us", 0),
            "dur": max(0, end - s.get("start_us", 0)),
            "pid": pid,
            "tid": tid,
            "args": {
                "trace_id": f"{s.get('trace_id', 0):#x}",
                "span_id": f"{s.get('span_id', 0):#x}",
                "parent_id": f"{s.get('parent_id', 0):#x}",
                "status": s.get("status", ""),
                **{k: v for k, v in s.get("attrs", {}).items()},
            },
        })
        for stage, ts in s.get("stages", []):
            events.append({
                "name": stage,
                "cat": "stage",
                "ph": "i",
                "s": "t",
                "ts": ts,
                "pid": pid,
                "tid": tid,
                "args": {"trace_id": f"{s.get('trace_id', 0):#x}"},
            })
    return events
